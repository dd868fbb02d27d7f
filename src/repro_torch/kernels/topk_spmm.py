"""TopK-sparse FFN down-projection — the paper's Eq. (1), ``y = TopK(h) @ W2``.

* ``topk_spmm`` (per token): ``y[i] = sum_t vals[i, t] * W2[idx[i, t]]``, a
  ranged indirect read of W2 rows driven by the activation ids (the AIA
  pattern).  Each product is rounded on its own and added in ``t`` order
  from zero, in float32, as in the reference's grid of ``(tokens, k)``
  steps, so the kernels, the plain version and the reference's Pallas
  kernel agree bit for bit, and a repeated id accumulates.  On CUDA W2's
  rows and dtype choose the kernel (``topk_spmm_route``): float32 or
  bfloat16 where a 16-byte column slice of W2 for all its rows, and the
  pair buffers, fit one block's shared memory (d_ff <= 10,424),
  ``csrc/topk_spmm_smem.cu`` (``"smem"``: each block holds one slice, so
  W2 leaves L2 once, and walks every token's pairs, one thread a token);
  otherwise, and for float16, ``csrc/topk_spmm.cu`` (``"l2"``: a block a
  token, W2's rows read through L2).
* ``block_topk_spmm`` (per token tile): ``y[tile] = sum_{t < kb}
  h_kept[tile, t] (tile x block) @ W2[bidx[tile, t]*block : +block]``, in
  float32; the kernels and the plain version differ only in the order of
  the sums.  On CUDA the dtype and sizes choose the kernel (``route``):
  bfloat16 within the tensor-core kernel's limits (a block up to its
  ``kMaxBlock``, 256 lanes, and up to ``kMaxInvertBlocks`` blocks) goes to
  ``csrc/block_topk_spmm_wgmma.cu`` (block-major: each selected W2 block
  read once, ``wgmma`` on the stacked tile rows that picked it, the partial
  products added into y by float32 reductions, so the order of the sums
  over ``t`` varies from run to run); float32, float16 and the other
  bfloat16 calls to the CUDA-core kernel in ``csrc/topk_spmm.cu`` (tile by
  tile, deterministic; any block, staged in panels of 1,536 lanes).

Ids outside W2 are clipped to its first or last row (block).  Replace
``repro.kernels.topk_spmm.topk_spmm`` and ``block_topk_spmm`` (the Pallas
``_token_kernel`` and ``_tile_kernel``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants

# the block-form kernel's C entry point on each route
KERNELS = {"wgmma": "repro_block_topk_spmm_wgmma",
           "cuda_cores": "repro_block_topk_spmm"}


def route(dtype: torch.dtype, block: int = 128, n_blocks: int = 1) -> str:
    """The kernel a CUDA ``block_topk_spmm`` call with ``dtype`` operands,
    ``block``-lane blocks and ``n_blocks`` W2 blocks launches: ``"wgmma"``
    (bfloat16 with ``block`` up to the source's ``kMaxBlock`` and
    ``n_blocks`` up to ``kMaxInvertBlocks``; tensor cores) or
    ``"cuda_cores"`` (everything else)."""
    c = source_constants("block_topk_spmm_wgmma.cu")
    if dtype == torch.bfloat16 and block <= c["kMaxBlock"] \
            and n_blocks <= c["kMaxInvertBlocks"]:
        return "wgmma"
    return "cuda_cores"


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


def topk_spmm_smem_bytes(d_ff: int) -> int:
    """Shared memory a block of the ``"smem"`` kernel takes for W2 of
    ``d_ff`` rows: a 16-byte column slice of every row, the pair buffers and
    their barriers (``csrc/topk_spmm_smem.cu``'s constants)."""
    c = source_constants("topk_spmm_smem.cu")
    return c["kSliceBytes"] * d_ff + c["kStages"] * c["kStageBytes"] \
        + c["kBarrierBytes"]


def topk_spmm_route(d_ff: int, dtype: torch.dtype = torch.float32) -> str:
    """The kernel a CUDA ``topk_spmm`` call with W2 of ``d_ff`` rows of
    ``dtype`` launches: ``"smem"`` for float32 or bfloat16 where its block
    fits the shared memory a block may use (``kMaxSmem``), else ``"l2"``."""
    c = source_constants("topk_spmm_smem.cu")
    fits = topk_spmm_smem_bytes(d_ff) <= c["kMaxSmem"]
    return "smem" if fits and dtype != torch.float16 else "l2"


def _topk_spmm_cuda(vals, idx, w2):
    _check_topk(vals, idx, w2)
    code = ops.expect_float(vals, 2, "vals")
    ops.expect(idx, torch.int32, 2, "idx")
    ops.expect(w2, vals.dtype, 2, "w2")
    ops.same_device(("vals", vals), ("idx", idx), ("w2", w2))
    (n, k), (d_ff, d) = vals.shape, w2.shape
    out = torch.empty((n, d), dtype=torch.float32, device=w2.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    path = topk_spmm_route(d_ff, vals.dtype)
    if path == "smem":  # (id, value) pairs, t-major in token groups
        group = source_constants("topk_spmm_smem.cu")["kThreads"]
        pair_bytes = 4 if code else 8
        pairs = torch.empty(-(-n // group) * group * k * pair_bytes,
                            dtype=torch.uint8, device=w2.device)
        rc = ops.launch_on(
            w2.device, library().repro_topk_spmm_smem, vals.data_ptr(),
            idx.data_ptr(), w2.data_ptr(), pairs.data_ptr(), out.data_ptr(),
            n, k, d, d_ff, code)
    else:
        rc = ops.launch_on(
            w2.device, library().repro_topk_spmm, vals.data_ptr(),
            idx.data_ptr(), w2.data_ptr(), out.data_ptr(), n, k, d, d_ff,
            code)
    ops.check_launch("topk_spmm", rc, path)
    return out


def topk_spmm(vals, idx, w2):
    """``sum_t vals[i, t] * w2[idx[i, t]]`` in float32: the plain version on
    the CPU, the kernel on CUDA (vals and w2 float32, bfloat16 or float16 of
    one dtype, idx int32)."""
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
    code = ops.expect_float(h_kept, 4, "h_kept")
    ops.expect(bidx, torch.int32, 2, "bidx")
    ops.expect(w2, h_kept.dtype, 2, "w2")
    ops.same_device(("h_kept", h_kept), ("bidx", bidx), ("w2", w2))
    n_tiles, kb, tile, _ = h_kept.shape
    d = w2.shape[1]
    n_blocks = w2.shape[0] // block
    path = route(h_kept.dtype, block, n_blocks)
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
                out.data_ptr(), n_tiles, kb, tile, block, d, n_blocks, code,
                stream)
    ops.check_launch("block_topk_spmm", rc, path)
    return out


def block_topk_spmm(h_kept, bidx, w2, block: int = 128):
    """Per-tile block product in float32, ``(n_tiles * tile, d)``: the plain
    version on the CPU, the kernel on CUDA (h_kept and w2 float32, bfloat16
    or float16 of one dtype, bidx int32; any block)."""
    return ops.dispatch(block_topk_spmm_plain, _block_topk_spmm_cuda, h_kept,
                        bidx, w2, block)
