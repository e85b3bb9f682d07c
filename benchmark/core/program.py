"""The system under test, built for a run: the measured program's detector
with the benchmark's weights and draws, or, for the control, the reference
put in its place with the same host API and run one precision lower.

The program is used only through its public host API: ``build_model``,
``test_forward_dispatch`` / ``test_forward_convert``,
``train_forward_dispatch`` / ``train_forward_convert``, its ``module``'s
parameters, its optimizer's state, ``generator`` (the source of a training
step's random draws) and ``current_lr``.
"""

from __future__ import annotations

import numpy as np
import torch


class _Quiet:
    def info(self, *args, **kwargs):
        pass


def build(ctx, weights: dict, draw_seed: int):
    """The detector that the window drives."""
    if ctx.program == "control":
        return Control(ctx, weights, draw_seed)
    from medicaldetectiontoolkit_torch.models import build_model

    net = build_model(ctx.cf, _Quiet(), device=ctx.device)
    net.module.load_state_dict(weights, strict=True)
    net.generator = torch.Generator(device=ctx.device).manual_seed(draw_seed)
    net.current_lr = ctx.cf.learning_rate
    return net


def reference_model(ctx, weights: dict):
    """The reference detector with the benchmark's weights."""
    model = ctx.family.Detector(ctx.ref_cf, ctx.device, remat=bool(ctx.ref_cf.use_remat))
    model.module.load_state_dict(weights, strict=True)
    return model


def boxes_of(cf, det, det_mask):
    """The results' box lists of fixed-shape detections, as the program's
    convert makes them: zero-area and low-confidence detections dropped."""
    out = []
    for b in range(det.shape[0]):
        rows = []
        for i in np.flatnonzero(det_mask[b]):
            coords = det[b, i, :6].astype(np.int32)
            area = (coords[2] - coords[0]) * (coords[3] - coords[1]) * (coords[5] - coords[4])
            if area > 0 and det[b, i, 7] >= cf.model_min_confidence:
                rows.append({"box_coords": coords, "box_score": float(det[b, i, 7]),
                             "box_pred_class_id": int(det[b, i, 6]), "box_type": "det"})
        out.append(rows)
    return out


class Control:
    """The reference in the program's place, with TF32 on for its convs and
    matmuls (the step below the configuration's float32 that would tempt a
    change): the host API of the program's detector, the refinement's NMS
    and merge done as the program does them."""

    def __init__(self, ctx, weights, draw_seed):
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        self.ctx, self.cf = ctx, ctx.ref_cf
        self.ref = reference_model(ctx, weights)
        self.module = self.ref.module
        self.generator = torch.Generator(device=ctx.device).manual_seed(draw_seed)
        self.optimizer = torch.optim.Adam(self.module.parameters(), lr=ctx.ref_cf.learning_rate, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=ctx.ref_cf.weight_decay)
        self.with_masks = ctx.family.WITH_MASKS

    def test_forward_dispatch(self, batch, return_masks=False):
        img = torch.from_numpy(batch["data"]).to(self.ctx.device)
        cand, seg_logits = self.ref.infer(img)
        det, mask = self.ref.refine(cand, img.shape[0])
        seg = None if seg_logits is None else torch.argmax(seg_logits, dim=1, keepdim=True).to(torch.uint8)
        return det, mask, seg

    def test_forward_convert(self, handles, batch):
        det, mask, seg = handles
        seg = (np.zeros((batch["data"].shape[0], 1) + batch["data"].shape[2:], np.float32) if seg is None
               else seg.cpu().numpy())
        return {"boxes": boxes_of(self.cf, det.cpu().numpy(), mask.cpu().numpy()), "seg_preds": seg}

    def train_forward_dispatch(self, batch):
        from benchmark.core.data import device_batch

        inputs = device_batch(batch, self.ctx.device, self.ctx.cell.params["max_lesions"], self.with_masks)
        draws = self.ref.draws(self.generator, inputs[0].shape[0])
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.ref.loss(inputs, draws)
        loss.backward()
        for p in self.module.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self.optimizer.step()
        return loss.detach()

    def train_forward_convert(self, handles, batch, need_seg_preds=False):
        return {"loss": float(handles)}
