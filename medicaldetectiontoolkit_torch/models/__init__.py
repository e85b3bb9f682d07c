"""Model zoo of the port: a registry keyed by ``cf.model``.

Same names as ``medicaldetectiontoolkit_tpu/models/__init__.py:14-78``. Only
the one-stage detectors (``retina_net``, ``retina_unet``) are ported so far;
the rest follow in the order of ROADMAP.md, Queue 1.
"""

from __future__ import annotations

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def build_model(cf, logger, device=None):
    """Instantiate the detector named by ``cf.model`` on ``device`` (default:
    the CUDA card when present, else the CPU)."""
    from medicaldetectiontoolkit_torch.models import retina_net  # noqa: F401  (registers)

    if cf.model not in _REGISTRY:
        raise KeyError(f"unknown model '{cf.model}', the PyTorch package has {sorted(_REGISTRY)}")
    return _REGISTRY[cf.model](cf, logger, device=device)
