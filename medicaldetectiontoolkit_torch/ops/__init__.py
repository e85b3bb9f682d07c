"""Device-side numerics of the port: box geometry and NMS.

Torch counterparts of ``medicaldetectiontoolkit_tpu/ops``. Unlike the JAX
package this ``__init__`` imports nothing, so each op module loads on its own.
"""
