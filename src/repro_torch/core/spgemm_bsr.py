"""Block-CSR SpGEMM with a dense right-hand side: the reference's XLA path.

``C[i, :] += A[i, k] @ X[k, :]`` over the block-column ids ``k`` of
block-row ``i``, the row-wise Gustavson structure at block granularity.
Counterpart of ``repro.core.spgemm_bsr``; plain PyTorch on every device.
The kernel form (float32 out, ``max_blocks_per_row``) is
``kernels.spgemm_bsr``.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import BSR


def bsr_spgemm_dense_rhs(a: BSR, x: torch.Tensor) -> torch.Tensor:
    """C = A @ X with BSR A and dense X (n_cols, d).

    Every stored block's product is formed at once, in the promoted dtype
    of the blocks and X, and summed per block-row in that dtype, as the
    reference's ``einsum`` and ``.at[].add`` do (bfloat16 blocks give a
    bfloat16 C).  Block-column ids are clipped to X's block rows.
    """
    br, bc = a.block_shape
    nbr = a.n_brows
    d = x.shape[1]
    cap = a.indices.shape[0]
    dtype = torch.promote_types(a.blocks.dtype, x.dtype)
    xb = x.reshape(a.shape[1] // bc, bc, d)
    p = torch.arange(cap, dtype=torch.int32, device=a.device)
    rid = torch.searchsorted(a.indptr, p, right=True, out_int32=True) - 1
    valid = p < a.nnzb
    ids = a.indices.clamp(0, max(xb.shape[0] - 1, 0)).long()
    gathered = xb[ids].to(dtype)  # (cap, bc, d)
    prods = torch.bmm(a.blocks.to(dtype), gathered)  # (cap, br, d)
    prods = torch.where(valid[:, None, None], prods, 0)
    rid = torch.where(valid, rid, nbr)
    out = torch.zeros((nbr + 1, br, d), dtype=dtype, device=a.device)
    out.index_add_(0, rid.long(), prods)
    return out[:nbr].reshape(nbr * br, d)
