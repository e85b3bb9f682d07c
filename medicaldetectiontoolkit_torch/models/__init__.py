"""Model zoo of the port: a registry keyed by ``cf.model``.

Same names as ``medicaldetectiontoolkit_tpu/models/__init__.py:14-78``. The
one-stage detectors (``retina_net``, ``retina_unet``) and the two-stage ones
(``mrcnn``, ``ufrcnn``) infer and train; ``detection_unet`` follows in the
order of ROADMAP.md, Queue 1.
"""

from __future__ import annotations

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def build_model(cf, logger, device=None):
    """Instantiate the detector named by ``cf.model`` on ``device``: the
    CUDA card by default, where the kernels run. Without a visible card this
    raises; pass ``device="cpu"`` to run the plain PyTorch versions."""
    from medicaldetectiontoolkit_torch.models import mrcnn, retina_net  # noqa: F401  (registers)

    if cf.model not in _REGISTRY:
        raise KeyError(f"unknown model '{cf.model}', the PyTorch package has {sorted(_REGISTRY)}")
    return _REGISTRY[cf.model](cf, logger, device=device)
