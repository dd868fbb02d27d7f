"""TopK-sparse FFN down-projection — the paper's Eq. (1), ``y = TopK(h) @ W2``.

* ``topk_spmm`` (per token): ``y[i] = sum_t vals[i, t] * W2[idx[i, t]]``, a
  ranged indirect read of W2 rows driven by the activation ids (the AIA
  pattern).  Each product is rounded on its own and added in ``t`` order
  from zero, in float32, as in the reference's grid of ``(tokens, k)``
  steps, so the kernel, the plain version and the reference's Pallas kernel
  agree bit for bit, and a repeated id accumulates.
* ``block_topk_spmm`` (per token tile): ``y[tile] = sum_{t < kb}
  h_kept[tile, t] (tile x block) @ W2[bidx[tile, t]*block : +block]``, in
  float32; the kernels and the plain version differ only in the order of
  the sums.  On CUDA the dtype chooses the kernel (``route``): bfloat16
  goes to ``csrc/block_topk_spmm_wgmma.cu`` (block-major: each selected W2
  block read once, ``wgmma`` on the stacked tile rows that picked it, the
  partial products added into y by float32 reductions, so the order of the
  sums over ``t`` varies from run to run); float32 to the CUDA-core kernel
  in ``csrc/topk_spmm.cu`` (tile by tile, deterministic).

Ids outside W2 are clipped to its first or last row (block).  The per-token
kernel is ``csrc/topk_spmm.cu``.  Replace ``repro.kernels.topk_spmm.
topk_spmm`` and ``block_topk_spmm`` (the Pallas ``_token_kernel`` and
``_tile_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants

# the block-form kernel each dtype goes to on CUDA: (C entry point, route)
KERNELS = {torch.bfloat16: ("repro_block_topk_spmm_wgmma", "wgmma"),
           torch.float32: ("repro_block_topk_spmm", "cuda_cores")}
# the CUDA-core kernel stages 8 rows of a block as float32 in 48 KB
F32_MAX_BLOCK = 1536


def route(dtype: torch.dtype) -> str:
    """The kernel a CUDA ``block_topk_spmm`` call with ``dtype`` operands
    launches: ``"wgmma"`` (bfloat16, tensor cores) or ``"cuda_cores"``
    (float32)."""
    return KERNELS[dtype][1]


def _check_topk(vals, idx, w2):
    if vals.dim() != 2 or idx.shape != vals.shape or w2.dim() != 2:
        raise ValueError(f"expected vals and idx (n, k) and w2 (d_ff, d); got "
                         f"{tuple(vals.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(w2.shape)}")
    if w2.shape[0] == 0 and idx.numel():
        raise ValueError("cannot gather rows from an empty w2")


def topk_spmm_plain(vals, idx, w2):
    """The plain PyTorch version: one gathered row product per ``t``, added
    in order (no ``(n, k, d)`` intermediate)."""
    _check_topk(vals, idx, w2)
    n, k = vals.shape
    out = torch.zeros((n, w2.shape[1]), dtype=torch.float32, device=w2.device)
    ids = idx.clamp(0, max(w2.shape[0] - 1, 0)).long()
    v = vals.float()
    for t in range(k):
        out += v[:, t, None] * w2[ids[:, t]].float()
    return out


def _topk_spmm_cuda(vals, idx, w2):
    _check_topk(vals, idx, w2)
    bf16 = ops.expect_float(vals, 2, "vals")
    ops.expect(idx, torch.int32, 2, "idx")
    ops.expect(w2, vals.dtype, 2, "w2")
    ops.same_device(("vals", vals), ("idx", idx), ("w2", w2))
    (n, k), (d_ff, d) = vals.shape, w2.shape
    out = torch.empty((n, d), dtype=torch.float32, device=w2.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    with torch.cuda.device(w2.device):
        rc = library().repro_topk_spmm(
            vals.data_ptr(), idx.data_ptr(), w2.data_ptr(), out.data_ptr(),
            n, k, d, d_ff, bf16, torch.cuda.current_stream().cuda_stream)
    ops.check_launch("topk_spmm", rc)
    return out


def topk_spmm(vals, idx, w2):
    """``sum_t vals[i, t] * w2[idx[i, t]]`` in float32: the plain version on
    the CPU, the kernel on CUDA (vals and w2 float32 or bfloat16 of one
    dtype, idx int32)."""
    return ops.dispatch(topk_spmm_plain, _topk_spmm_cuda, vals, idx, w2)


def _check_tiles(h_kept, bidx, w2, block):
    if h_kept.dim() != 4 or bidx.shape != h_kept.shape[:2] or w2.dim() != 2:
        raise ValueError(f"expected h_kept (n_tiles, kb, tile, block), bidx "
                         f"(n_tiles, kb) and w2 (d_ff, d); got "
                         f"{tuple(h_kept.shape)}, {tuple(bidx.shape)}, "
                         f"{tuple(w2.shape)}")
    if h_kept.shape[3] != block or block < 1 or w2.shape[0] % block:
        raise ValueError(f"h_kept's blocks of {h_kept.shape[3]} lanes and w2's "
                         f"{w2.shape[0]} rows do not match block={block}")
    if w2.shape[0] == 0 and bidx.numel():
        raise ValueError("cannot gather blocks from an empty w2")


def block_topk_spmm_plain(h_kept, bidx, w2, block: int = 128):
    """The plain PyTorch version: one batched (tile x block) @ (block x d)
    float32 product per ``t``, added in order."""
    _check_tiles(h_kept, bidx, w2, block)
    n_tiles, kb, tile, _ = h_kept.shape
    d = w2.shape[1]
    n_blocks = w2.shape[0] // block
    w2b = w2.reshape(n_blocks, block, d)
    ids = bidx.clamp(0, max(n_blocks - 1, 0)).long()
    out = torch.zeros((n_tiles, tile, d), dtype=torch.float32,
                      device=w2.device)
    for t in range(kb):
        out += torch.bmm(h_kept[:, t].float(), w2b[ids[:, t]].float())
    return out.reshape(n_tiles * tile, d)


def _block_topk_spmm_cuda(h_kept, bidx, w2, block: int = 128):
    _check_tiles(h_kept, bidx, w2, block)
    ops.expect_float(h_kept, 4, "h_kept")
    ops.expect(bidx, torch.int32, 2, "bidx")
    ops.expect(w2, h_kept.dtype, 2, "w2")
    ops.same_device(("h_kept", h_kept), ("bidx", bidx), ("w2", w2))
    n_tiles, kb, tile, _ = h_kept.shape
    d = w2.shape[1]
    n_blocks = w2.shape[0] // block
    path = route(h_kept.dtype)
    if path == "wgmma":
        c = source_constants("block_topk_spmm_wgmma.cu")
        if block > c["kMaxBlock"] or n_blocks > c["kMaxInvertBlocks"]:
            raise ValueError(
                f"block={block}, {n_blocks} blocks: the bf16 kernel takes "
                f"block <= {c['kMaxBlock']} (W2's slice and four A slots in "
                f"one block's shared memory) and at most "
                f"{c['kMaxInvertBlocks']} blocks (its counting sort)")
    elif block > F32_MAX_BLOCK:
        raise ValueError(f"block={block}: the float32 kernel stages 8 rows "
                         f"of a block in 48 KB of shared memory (block <= "
                         f"{F32_MAX_BLOCK})")
    if n_tiles * tile * d == 0 or kb == 0:
        return torch.zeros((n_tiles * tile, d), dtype=torch.float32,
                           device=w2.device)
    with torch.cuda.device(w2.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty((n_tiles * tile, d), dtype=torch.float32,
                          device=w2.device)
        if path == "wgmma":  # the kernel's first launch also zeroes out
            pair_ptr = torch.empty(n_blocks + 1, dtype=torch.int32,
                                   device=w2.device)
            pairs = torch.empty(n_tiles * kb, dtype=torch.int32,
                                device=w2.device)
            rc = library().repro_block_topk_spmm_wgmma(
                h_kept.data_ptr(), bidx.data_ptr(), w2.data_ptr(),
                pair_ptr.data_ptr(), pairs.data_ptr(), out.data_ptr(),
                n_tiles, kb, tile, block, d, n_blocks, stream)
        else:
            rc = library().repro_block_topk_spmm(
                h_kept.data_ptr(), bidx.data_ptr(), w2.data_ptr(),
                out.data_ptr(), n_tiles, kb, tile, block, d, n_blocks, stream)
    ops.check_launch("block_topk_spmm", rc, path)
    return out


def block_topk_spmm(h_kept, bidx, w2, block: int = 128):
    """Per-tile block product in float32, ``(n_tiles * tile, d)``: the plain
    version on the CPU, the kernel on CUDA (h_kept and w2 float32 or
    bfloat16 of one dtype, bidx int32)."""
    return ops.dispatch(block_topk_spmm_plain, _block_topk_spmm_cuda, h_kept,
                        bidx, w2, block)
