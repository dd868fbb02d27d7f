"""TopK sparsification (paper Eq. 1-3) and its block-structured variant.

Counterpart of ``repro.sparse.topk``.  ``topk_rows`` is Eq. (2): keep the k
largest-magnitude entries per row.  ``topk_rows_st`` is the same selection
with the paper's Eq. (3) backward pass, ``dL/dx = M_k * g`` (gradients flow
only through the kept entries), as a ``torch.autograd.Function``.
``block_topk_rows`` selects whole blocks of ``block`` contiguous lanes by
energy.

Selection follows ``jax.lax.top_k``: the k largest in descending order,
and among equal values the lower index first.  ``torch.topk`` promises no
order among ties, so the selection is a stable descending sort.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import TopKRows


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row, as ``lax.top_k``."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]


def topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """Binary mask M_k of Eq. (2): True where x is among the row's top-k
    |values|."""
    mask = torch.zeros_like(x, dtype=torch.bool)
    return mask.scatter_(1, _top_k(x.abs(), k), True)


def topk_rows(x: torch.Tensor, k: int) -> TopKRows:
    """Eq. (2) as an explicit sparse container (values may include zeros)."""
    idx = _top_k(x.abs(), k)
    return TopKRows(torch.gather(x, 1, idx), idx.to(torch.int32),
                    tuple(x.shape))


def block_topk_rows(x: torch.Tensor, k_blocks: int,
                    block: int = 128) -> TopKRows:
    """Keep the ``k_blocks`` highest-energy blocks of ``block`` lanes per row.

    ``indices`` are block ids (0..d/block) and ``values`` the kept lanes,
    ``(n, k_blocks*block)``: entry ``(i, t)`` stands for the whole block
    ``indices[i, t]``.  A block's energy is its sum of squares, taken in
    float32 and rounded to ``x``'s dtype, as ``jnp.sum`` does for a 16-bit
    float.
    """
    n, d = x.shape
    if d % block:
        raise ValueError(f"{d} lanes are not a whole number of {block}-lane "
                         f"blocks")
    nb = d // block
    xb = x.reshape(n, nb, block)
    sq = xb * xb
    if x.dtype in (torch.bfloat16, torch.float16):
        energy = sq.float().sum(-1).to(x.dtype)
    else:
        energy = sq.sum(-1)
    bidx = _top_k(energy, k_blocks)  # (n, k_blocks)
    kept = torch.gather(xb, 1, bidx[:, :, None].expand(n, k_blocks, block))
    return TopKRows(kept.reshape(n, k_blocks * block), bidx.to(torch.int32),
                    (n, d))


class _TopKStraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k):
        m = topk_mask(x, k)
        ctx.save_for_backward(m)
        return torch.where(m, x, 0)

    @staticmethod
    def backward(ctx, g):
        (m,) = ctx.saved_tensors
        return torch.where(m, g, 0), None


def topk_rows_st(x: torch.Tensor, k: int) -> torch.Tensor:
    """TopK with the paper's Eq. (3) gradient: ``dL/dx = M_k * upstream``."""
    return _TopKStraightThrough.apply(x, k)
