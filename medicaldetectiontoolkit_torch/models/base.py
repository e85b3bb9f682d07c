"""Shared detector machinery of the port: batch upload, results assembly and
the inference half of the ``Detector`` host API.

Counterpart of ``medicaldetectiontoolkit_tpu/models/base.py``. The outer
contract is the JAX package's (and the reference's): batch dicts are NumPy,
channel-first ``(b, c, y, x, (z))``; ``test_forward`` returns
``{"boxes": [[box dicts]], "seg_preds": (b, 1, *spatial) uint8}``. Device
tensors stay channel-first, as torch convolutions take them.

``test_forward_dispatch`` only enqueues CUDA work and returns un-synchronised
tensors; ``test_forward_convert`` does the device->host copy. That keeps the
Predictor's in-flight window of dispatched chunks (``predictor.py:374-417``)
overlapping host work with device work.

The training half (matching, losses, optimizer, gradient accumulation) is
not ported yet; its entry points raise ``NotImplementedError`` (see
ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NOT_PORTED = "not ported to the PyTorch package yet; see ROADMAP.md, Queue 1"


def default_device() -> torch.device:
    """The CUDA card when one is present, else the CPU (which runs the plain
    PyTorch versions of every kernel)."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """numpy (e.g. a (b, c, *spatial) image batch) -> float32 tensor on
    ``device``, same layout.

    A CUDA upload goes through pinned memory with ``non_blocking=True``: a
    pageable copy would synchronise the stream, so dispatching a batch would
    wait for the previous batch's device work.
    """
    t = torch.from_numpy(np.ascontiguousarray(array, dtype=np.float32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def detections_to_box_results(cf, detections, det_mask, box_results_list=None):
    """Fixed-shape detections -> the reference results 'boxes' lists.

    detections: (b, max_det, 2*dim + 2) = coords (rounded), class_id, score,
    as numpy. Applies the reference's zero-area and min-confidence filters
    (``base.py:56-83``).
    """
    detections = np.asarray(detections)
    det_mask = np.asarray(det_mask)
    bsz = detections.shape[0]
    if box_results_list is None:
        box_results_list = [[] for _ in range(bsz)]
    ncoords = 2 * cf.dim
    for b in range(bsz):
        for i in np.flatnonzero(det_mask[b]):
            coords = detections[b, i, :ncoords].astype(np.int32)
            class_id = int(detections[b, i, ncoords])
            score = float(detections[b, i, ncoords + 1])
            area = (coords[2] - coords[0]) * (coords[3] - coords[1])
            if cf.dim == 3:
                area = area * (coords[5] - coords[4])
            if area <= 0 or score < cf.model_min_confidence:
                continue
            box_results_list[b].append(
                {"box_coords": coords, "box_score": score, "box_type": "det", "box_pred_class_id": class_id}
            )
    return box_results_list


class Detector:
    """Base class: owns (cf, logger, device, module) and the host API.

    Subclasses implement ``build`` (set ``self.module``), ``_predict`` and
    ``_finalize_outputs``.
    """

    def __init__(self, cf, logger, device: Optional[torch.device] = None):
        self.cf = cf
        self.logger = logger
        self.device = torch.device(device) if device is not None else default_device()
        self.module = None
        self.build()

    # ---- subclass API -------------------------------------------------
    def build(self):
        raise NotImplementedError

    def init_params(self, seed: int = 0):
        raise NotImplementedError

    # ---- state handling ------------------------------------------------
    def initialize(self, seed: Optional[int] = None):
        """Draw fresh weights from ``torch.Generator().manual_seed(seed)``."""
        self.init_params(self.cf.seed if seed is None else seed)
        n_params = sum(p.numel() for p in self.module.parameters())
        if self.logger is not None:
            self.logger.info(f"initialized {type(self).__name__} with {n_params/1e6:.2f}M parameters")

    def state_dict(self):
        """The port's own checkpoint: torch parameter tensors on the CPU."""
        return {"params": {k: v.detach().cpu() for k, v in self.module.state_dict().items()}}

    def load_state_dict(self, state):
        self.module.load_state_dict(state["params"])

    def load_params(self, params):
        """Load a JAX param tree (nested dicts of numpy arrays, as
        ``Detector.state_dict()["params"]`` of the JAX package holds it)."""
        from medicaldetectiontoolkit_torch.utils import convert

        self.module.load_state_dict(convert.jax_to_torch(params, self.module))

    # ---- inference -----------------------------------------------------
    def _predict(self, img):
        raise NotImplementedError

    def _finalize_outputs(self, *heads):
        raise NotImplementedError

    def test_forward_dispatch(self, batch, **kwargs):
        """Enqueue forward + detection refinement; return un-synchronised
        device tensors (nothing waits for the device until convert)."""
        with torch.inference_mode():
            img = host_to_device(batch["data"], self.device)
            return self._finalize_outputs(*self._predict(img))

    def test_forward_convert(self, handles, batch, **kwargs):
        det, det_mask, seg_preds = handles
        boxes = detections_to_box_results(self.cf, det.cpu().numpy(), det_mask.cpu().numpy())
        if seg_preds is None:
            data_shape = batch["data"].shape
            seg_preds = np.zeros((data_shape[0], 1) + tuple(data_shape[2:]), dtype=np.float32)
        else:
            seg_preds = seg_preds.cpu().numpy()
        return {"boxes": boxes, "seg_preds": seg_preds}

    def test_forward(self, batch, **kwargs):
        """Inference forward -> {boxes, seg_preds} (reference test_forward contract)."""
        return self.test_forward_convert(self.test_forward_dispatch(batch, **kwargs), batch, **kwargs)

    # ---- not ported yet -------------------------------------------------
    def train_forward_dispatch(self, batch, is_validation: bool = False, do_update: bool = True):
        raise NotImplementedError(f"training is {_NOT_PORTED}")

    def train_forward_convert(self, handles, batch, need_seg_preds: bool = True):
        raise NotImplementedError(f"training is {_NOT_PORTED}")

    def train_forward(self, batch, is_validation: bool = False, do_update: bool = True,
                      need_seg_preds: bool = True):
        raise NotImplementedError(f"training is {_NOT_PORTED}")
