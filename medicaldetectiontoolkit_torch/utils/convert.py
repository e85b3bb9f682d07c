"""JAX param tree <-> the port's ``state_dict``, for the one-stage detectors.

The JAX tree is what ``Detector.state_dict()["params"]`` of the JAX package
and its ``params.pkl`` hold: nested dicts of numpy arrays keyed by flax's
auto-names (``FPN_0/ConvND_3/Conv_0/kernel``, ...). The conversion is a
name map plus layout changes:

  * conv kernels: flax ``(k..., cin, cout)`` <-> torch ``(cout, cin, k...)``;
  * GroupNorm ``scale``/``bias`` <-> ``weight``/``bias``;
  * identity ResBlocks: under ``stage_mode`` "unroll"/"scan" (the default,
    ``backbone.py:538-546``) they live under ``Scan_RepeatedResBlock_<stage>``
    with a stacked leading axis, which is unstacked into the port's
    ``nn.Sequential``; "loop" trees number every ResBlock in order and are not
    stacked.

The flax names follow module creation order in ``FPN.__call__``
(``backbone.py:596-661``): stems, stage ResBlocks, laterals from the deepest
level up, output convs from P2 down, then the operate_stride1 levels.
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK_CONVS = ("conv1", "conv2", "conv3", "downsample")


def _conv_map(module, stage_mode: str):
    """[(flax path of a ConvND, stack index or None, torch prefix)] for a
    ``RetinaModule``."""
    fpn = module.fpn
    n_levels = len(fpn.lateral)
    fpn_convs = (["fpn.stem0.0", "fpn.stem0.1"] if fpn.operate_stride1 else []) + ["fpn.stem1"]
    fpn_convs += [f"fpn.lateral.{i}" for i in reversed(range(n_levels))]
    fpn_convs += [f"fpn.out.{i}" for i in range(n_levels)]
    if fpn.operate_stride1:
        fpn_convs += ["fpn.lateral1", "fpn.lateral0", "fpn.out0"]
    out = [(("FPN_0", f"ConvND_{n}"), None, prefix) for n, prefix in enumerate(fpn_convs)]

    n_res = 0
    for s, stage in enumerate(fpn.stages):
        for b in range(len(stage)):
            convs = _BLOCK_CONVS if b == 0 else _BLOCK_CONVS[:3]
            for j, name in enumerate(convs):
                prefix = f"fpn.stages.{s}.{b}.{name}"
                if stage_mode == "loop":
                    out.append((("FPN_0", f"ResBlock_{n_res}", f"ConvND_{j}"), None, prefix))
                elif b == 0:
                    out.append((("FPN_0", f"ResBlock_{s}", f"ConvND_{j}"), None, prefix))
                else:
                    path = ("FPN_0", f"Scan_RepeatedResBlock_{s}", "ResBlock_0", f"ConvND_{j}")
                    out.append((path, b - 1, prefix))
            n_res += 1

    if module.seg_head is not None:
        out.append((("ConvND_0",), None, "seg_head"))
    for flax_name, head in (("DenseHead_0", "cls_head"), ("DenseHead_1", "box_head")):
        out += [((flax_name, f"ConvND_{j}"), None, f"{head}.convs.{j}") for j in range(4)]
        out.append(((flax_name, "ConvND_4"), None, f"{head}.final"))
    return out


def _leaves(prefix, torch_keys):
    """(flax leaf path, torch key, is_kernel) of one ConvND."""
    out = [(("Conv_0", "kernel"), f"{prefix}.conv.weight", True), (("Conv_0", "bias"), f"{prefix}.conv.bias", False)]
    if f"{prefix}.norm.weight" in torch_keys:
        out += [(("GroupNorm_0", "scale"), f"{prefix}.norm.weight", False),
                (("GroupNorm_0", "bias"), f"{prefix}.norm.bias", False)]
    return out


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
    """JAX param tree -> ``state_dict`` for ``module`` (a ``RetinaModule``).

    Accepts "unroll"/"scan" trees (stacked identity blocks) and "loop" trees.
    Raises if a JAX leaf is left unused or a shape does not fit.
    """
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}
    stage_mode = "unroll" if any(k[1].startswith("Scan_") for k in flat if len(k) > 1) else "loop"
    target = module.state_dict()
    sd, used = {}, set()
    for path, idx, prefix in _conv_map(module, stage_mode):
        for leaf, key, is_kernel in _leaves(prefix, target):
            full = path + leaf
            if full not in flat:
                raise KeyError(f"JAX params lack {'/'.join(full)} (for {key})")
            arr = flat[full] if idx is None else flat[full][idx]
            used.add(full)
            if is_kernel:
                d = arr.ndim - 2
                arr = np.transpose(arr, (d + 1, d) + tuple(range(d)))
            t = torch.tensor(np.asarray(arr, dtype=np.float32))
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
    for path, idx, prefix in _conv_map(module, stage_mode):
        for leaf, key, is_kernel in _leaves(prefix, state):
            arr = state[key]
            if is_kernel:
                d = arr.ndim - 2
                arr = np.transpose(arr, tuple(range(2, d + 2)) + (1, 0))
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            if idx is None:
                flat[path + leaf] = arr
            else:
                stacked.setdefault(path + leaf, {})[idx] = arr
    for full, per_idx in stacked.items():
        flat[full] = np.stack([per_idx[i] for i in range(len(per_idx))])
    return _unflatten(flat)
