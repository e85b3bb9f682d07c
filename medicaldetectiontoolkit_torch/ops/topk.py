"""Exact top-k in ``jax.lax.top_k``'s tie order (torch).

Counterpart of ``medicaldetectiontoolkit_tpu/ops/topk.py``. The JAX package
takes ``lax.top_k`` for every deterministic selection and ``approx_max_k``
(``stochastic_top_k``) for the monitoring-only anchor compaction at large
sizes. Torch has no ``approx_max_k``, so every site here takes the exact
selection; below the JAX package's approximation threshold (65,536 values)
both give the same indices.
"""

from __future__ import annotations


def top_k(x, k: int, dim: int = -1):
    """The ``k`` largest values along ``dim`` and their indices, ties toward
    the lower index as ``lax.top_k`` breaks them: a stable descending sort,
    sliced. ``torch.topk`` promises no tie order."""
    vals, idx = x.sort(dim=dim, descending=True, stable=True)
    return vals.narrow(dim, 0, k), idx.narrow(dim, 0, k)
