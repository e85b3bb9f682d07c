"""Model zoo of the port: a registry keyed by ``cf.model``.

Same names as ``medicaldetectiontoolkit_tpu/models/__init__.py:14-78``: the
one-stage detectors (``retina_net``, ``retina_unet``), the two-stage ones
(``mrcnn``, ``ufrcnn``) and ``detection_unet``, which all infer and train.

When ``cf.model_source_path`` names a file (the snapshot of the model's
source that ``utils/exp_utils.py::prep_exp`` writes into the experiment
directory, beside ``cf.backbone_source_path``), ``build_model`` builds the
detector from that snapshot, as JAX's ``_load_snapshot_sources`` does
(``:22-57``), so a run reproduces the frozen sources. A snapshot whose
sources are byte-for-byte those of the installed modules is that code
already: the installed modules are used, and a detector class keeps one
identity in the process.
"""

from __future__ import annotations

import importlib
import importlib.util
import os
import sys

_REGISTRY = {}

_BACKBONE = "medicaldetectiontoolkit_torch.models.backbone"
_SNAPSHOT_MODEL = "medicaldetectiontoolkit_torch.models._snapshot_model"


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def _same_source(path, module_name):
    """Whether the file ``path`` holds the source of the installed module
    ``module_name`` (False where no such module is installed)."""
    try:
        installed = importlib.import_module(module_name).__file__
    except ModuleNotFoundError:
        return False
    with open(path, "rb") as a, open(installed, "rb") as b:
        return a.read() == b.read()


def _snapshot_registry(cf):
    """Execute the exp dir's model snapshot (with its backbone snapshot
    installed under the backbone's canonical module name first, so the
    model's imports resolve to it) and return what it registers. The
    canonical modules and the registry are restored afterwards: later
    builds without a snapshot get the installed code."""
    global _REGISTRY

    def load_registered(name, path):
        # in sys.modules before it executes, as an import would put it
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod

    saved = {n: sys.modules.get(n) for n in (_BACKBONE, _SNAPSHOT_MODEL)}
    installed, _REGISTRY = _REGISTRY, {}
    try:
        bb_src = getattr(cf, "backbone_source_path", None)
        if bb_src and os.path.isfile(bb_src):
            load_registered(_BACKBONE, bb_src)
        load_registered(_SNAPSHOT_MODEL, cf.model_source_path)
        return _REGISTRY
    finally:
        _REGISTRY = installed
        for n, mod in saved.items():
            if mod is not None:
                sys.modules[n] = mod
            else:
                sys.modules.pop(n, None)


def build_model(cf, logger, device=None):
    """Instantiate the detector named by ``cf.model`` on ``device``: the
    CUDA card by default, where the kernels run. Without a visible card this
    raises; pass ``device="cpu"`` to run the plain PyTorch versions. An exp
    dir's snapshot of the sources (``cf.model_source_path``) wins over the
    installed modules."""
    from medicaldetectiontoolkit_torch.models import detection_unet, mrcnn, retina_net  # noqa: F401  (registers)
    from medicaldetectiontoolkit_torch.utils.exp_utils import model_source_file

    registry = _REGISTRY
    src = getattr(cf, "model_source_path", None)
    if src and os.path.isfile(src):
        bb_src = getattr(cf, "backbone_source_path", None)
        model_mod = f"medicaldetectiontoolkit_torch.models.{model_source_file(cf.model)[:-3]}"
        frozen = not (_same_source(src, model_mod) and
                      (not bb_src or not os.path.isfile(bb_src) or _same_source(bb_src, _BACKBONE)))
        if frozen:
            registry = _snapshot_registry(cf)
    if cf.model not in registry:
        raise KeyError(f"unknown model '{cf.model}', the PyTorch package has {sorted(registry)}")
    return registry[cf.model](cf, logger, device=device)
