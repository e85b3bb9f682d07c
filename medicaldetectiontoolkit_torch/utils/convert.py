"""JAX param tree <-> the port's ``state_dict``, for every detector, and
optax's Adam state <-> torch Adam's.

The JAX tree is what ``Detector.state_dict()["params"]`` of the JAX package
and its ``params.pkl`` hold: nested dicts of numpy arrays keyed by flax's
names. ``RetinaModule`` is a compact module, so its tree is keyed by
auto-names (``FPN_0/ConvND_3/Conv_0/kernel``, ``DenseHead_1/...``), and so
is Detection U-Net's ``SegUNetModule`` (``FPN_0/...``, its seg head
``ConvND_0/Conv_0`` with ``GroupNorm_0`` under a norm);
``MRCNNModule`` is built with ``setup()``, so its tree is keyed by attribute
name (``fpn/...``, ``rpn/ConvND_0..2``, ``classifier/{Conv_0, GroupNorm_0,
ConvND_0, Dense_0, Dense_1}``, ``mask/{ConvND_0..4, ConvTranspose_0}``,
``final_conv/Conv_0``). The conversion is a name map plus layout changes:

  * conv kernels: flax ``(k..., cin, cout)`` <-> torch ``(cout, cin, k...)``;
  * Dense kernels: flax ``(in, out)`` <-> torch ``Linear.weight`` ``(out, in)``;
  * ConvTranspose kernels: flax ``(k..., cin, cout)`` <-> torch
    ``(cin, cout, k...)``, reversed along every spatial axis: flax's
    ``nn.ConvTranspose`` (``transpose_kernel=False``) does not flip its
    kernel, torch's transposed conv does;
  * GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``;
  * identity ResBlocks: under ``stage_mode`` "unroll"/"scan" (the default,
    ``backbone.py:538-546``) they live under ``Scan_RepeatedResBlock_<stage>``
    with a stacked leading axis, which is unstacked into the port's
    ``nn.Sequential``; "loop" trees number every ResBlock in order and are not
    stacked.

optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``; ``mu`` and ``nu``
are trees shaped like the params) maps onto torch Adam's per-parameter
``step``, ``exp_avg`` and ``exp_avg_sq`` through the same name map, so a
JAX run stopped mid-way resumes in the port with its moments.

The flax names inside an FPN follow module creation order in
``FPN.__call__`` (``backbone.py:596-661``): stems, stage ResBlocks, laterals
from the deepest level up, output convs from P2 down, then the
operate_stride1 levels.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK_CONVS = ("conv1", "conv2", "conv3", "downsample")


def _fpn_map(fpn, root: str, stage_mode: str):
    """[(flax path, stack index or None, torch prefix, kind)] of an FPN whose
    flax tree sits under ``root``."""
    n_levels = len(fpn.lateral)
    fpn_convs = (["stem0.0", "stem0.1"] if fpn.operate_stride1 else []) + ["stem1"]
    fpn_convs += [f"lateral.{i}" for i in reversed(range(n_levels))]
    fpn_convs += [f"out.{i}" for i in range(n_levels)]
    if fpn.operate_stride1:
        fpn_convs += ["lateral1", "lateral0", "out0"]
    out = [((root, f"ConvND_{n}"), None, f"fpn.{prefix}", "convnd") for n, prefix in enumerate(fpn_convs)]

    n_res = 0
    for s, stage in enumerate(fpn.stages):
        for b in range(len(stage)):
            convs = _BLOCK_CONVS if b == 0 else _BLOCK_CONVS[:3]
            for j, name in enumerate(convs):
                prefix = f"fpn.stages.{s}.{b}.{name}"
                if stage_mode == "loop":
                    out.append(((root, f"ResBlock_{n_res}", f"ConvND_{j}"), None, prefix, "convnd"))
                elif b == 0:
                    out.append(((root, f"ResBlock_{s}", f"ConvND_{j}"), None, prefix, "convnd"))
                else:
                    path = (root, f"Scan_RepeatedResBlock_{s}", "ResBlock_0", f"ConvND_{j}")
                    out.append((path, b - 1, prefix, "convnd"))
            n_res += 1
    return out


def _conv_map(module, stage_mode: str):
    """[(flax path, stack index or None, torch prefix, kind)] for a
    ``RetinaModule``, a ``SegUNetModule`` or an ``MRCNNModule``; kind is
    "convnd" (a ConvND or a flax Conv_0 + GroupNorm_0 pair), "dense" or
    "deconv"."""
    if hasattr(module, "classifier"):  # MRCNNModule
        out = _fpn_map(module.fpn, "fpn", stage_mode)
        out += [(("rpn", f"ConvND_{j}"), None, f"rpn.{name}", "convnd")
                for j, name in enumerate(("conv", "logits", "deltas"))]
        out += [
            (("classifier",), None, "classifier.conv1", "convnd"),
            (("classifier", "ConvND_0"), None, "classifier.conv2", "convnd"),
            (("classifier", "Dense_0"), None, "classifier.cls", "dense"),
            (("classifier", "Dense_1"), None, "classifier.bbox", "dense"),
        ]
        if module.mask is not None:
            out += [(("mask", f"ConvND_{j}"), None, f"mask.convs.{j}", "convnd") for j in range(4)]
            out += [(("mask", "ConvTranspose_0"), None, "mask.deconv", "deconv"),
                    (("mask", "ConvND_4"), None, "mask.final", "convnd")]
        if module.final_conv is not None:
            out.append((("final_conv",), None, "final_conv", "convnd"))
        return out

    out = _fpn_map(module.fpn, "FPN_0", stage_mode)
    if module.seg_head is not None:
        out.append((("ConvND_0",), None, "seg_head", "convnd"))
    if not hasattr(module, "cls_head"):  # SegUNetModule: FPN + seg head
        return out
    for flax_name, head in (("DenseHead_0", "cls_head"), ("DenseHead_1", "box_head")):
        out += [((flax_name, f"ConvND_{j}"), None, f"{head}.convs.{j}", "convnd") for j in range(4)]
        out.append(((flax_name, "ConvND_4"), None, f"{head}.final", "convnd"))
    return out


def _leaves(prefix, kind, torch_keys):
    """(flax leaf path, torch key, kernel layout or None) of one layer."""
    if kind != "convnd":
        return [(("kernel",), f"{prefix}.weight", kind), (("bias",), f"{prefix}.bias", None)]
    out = [(("Conv_0", "kernel"), f"{prefix}.conv.weight", "conv"), (("Conv_0", "bias"), f"{prefix}.conv.bias", None)]
    if f"{prefix}.norm.weight" in torch_keys:
        out += [(("GroupNorm_0", "scale"), f"{prefix}.norm.weight", None),
                (("GroupNorm_0", "bias"), f"{prefix}.norm.bias", None)]
    return out


def _to_torch_layout(arr, layout):
    if layout == "dense":
        return arr.T
    d = arr.ndim - 2
    if layout == "deconv":  # flip every spatial axis, then (cin, cout, k...)
        return np.transpose(np.flip(arr, tuple(range(d))), (d, d + 1) + tuple(range(d)))
    return np.transpose(arr, (d + 1, d) + tuple(range(d)))  # conv: (cout, cin, k...)


def _to_jax_layout(arr, layout):
    if layout == "dense":
        return arr.T
    d = arr.ndim - 2
    if layout == "deconv":
        return np.flip(np.transpose(arr, tuple(range(2, d + 2)) + (0, 1)), tuple(range(d)))
    return np.transpose(arr, tuple(range(2, d + 2)) + (1, 0))


def _flatten(tree, prefix=()):
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = v
    return flat


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def jax_to_torch(params, module):
    """JAX param tree -> ``state_dict`` for ``module`` (a ``RetinaModule``, a
    ``SegUNetModule`` or an ``MRCNNModule``).

    Accepts "unroll"/"scan" trees (stacked identity blocks) and "loop" trees.
    Raises if a JAX leaf is left unused or a shape does not fit.
    """
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    stage_mode = "unroll" if any(k[1].startswith("Scan_") for k in flat if len(k) > 1) else "loop"
    target = module.state_dict()
    sd, used = {}, set()
    for path, idx, prefix, kind in _conv_map(module, stage_mode):
        for leaf, key, layout in _leaves(prefix, kind, target):
            full = path + leaf
            if full not in flat:
                raise KeyError(f"JAX params lack {'/'.join(full)} (for {key})")
            arr = flat[full] if idx is None else flat[full][idx]
            used.add(full)
            if layout is not None:
                arr = _to_torch_layout(arr, layout)
            t = torch.tensor(np.ascontiguousarray(arr, dtype=np.float32))
            if t.shape != target[key].shape:
                raise ValueError(f"{'/'.join(full)}: shape {tuple(t.shape)} does not fit {key} {tuple(target[key].shape)}")
            sd[key] = t
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise ValueError(f"JAX params not used by the conversion: {unused[:8]}")
    return sd


def torch_to_jax(state_dict, module, stage_mode: str = "unroll"):
    """``state_dict`` of ``module`` -> JAX param tree (nested dicts of numpy
    arrays) in the layout of ``stage_mode`` ("unroll"/"scan" or "loop")."""
    state = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    flat, stacked = {}, {}
    for path, idx, prefix, kind in _conv_map(module, stage_mode):
        for leaf, key, layout in _leaves(prefix, kind, state):
            arr = state[key]
            if layout is not None:
                arr = _to_jax_layout(arr, layout)
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            if idx is None:
                flat[path + leaf] = arr
            else:
                stacked.setdefault(path + leaf, {})[idx] = arr
    for full, per_idx in stacked.items():
        flat[full] = np.stack([per_idx[i] for i in range(len(per_idx))])
    return _unflatten(flat)


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` inside an optax chain's state (a tuple of
    the chained transforms' states), recognised by its fields."""
    for state in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        if all(hasattr(state, f) for f in ("count", "mu", "nu")):
            return state
    raise ValueError("the optimizer state holds no Adam state (count, mu, nu)")


def jax_adam_to_torch(opt_state, module, optimizer):
    """optax Adam state (as ``Detector.state_dict()["opt_state"]`` of the
    JAX package holds it) -> a ``state_dict`` for ``optimizer``, a torch Adam
    over ``module.parameters()``."""
    adam = _adam_state(opt_state)
    mu, nu = jax_to_torch(adam.mu, module), jax_to_torch(adam.nu, module)
    step = float(np.asarray(adam.count))
    sd = optimizer.state_dict()
    sd["state"] = {
        i: {"step": torch.tensor(step), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(module.named_parameters())
    }
    return sd


def torch_adam_to_jax(optimizer_state, module, stage_mode: str = "unroll"):
    """A torch Adam ``state_dict`` over ``module.parameters()`` -> (count,
    mu, nu): optax's ``ScaleByAdamState`` fields, numpy, the trees in the
    layout of ``stage_mode``."""
    state = optimizer_state["state"]
    names = [name for name, _ in module.named_parameters()]
    moments = [torch_to_jax({n: state[i][key] for i, n in enumerate(names)}, module, stage_mode)
               for key in ("exp_avg", "exp_avg_sq")]
    return np.int32(float(state[0]["step"])), moments[0], moments[1]
