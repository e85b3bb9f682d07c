"""Plain PyTorch reference of the benchmarked detectors. It imports nothing
of ``medicaldetectiontoolkit_torch`` or of the JAX package."""
