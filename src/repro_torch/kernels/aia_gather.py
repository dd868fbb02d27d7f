"""The AIA indirect gather — the paper's Fig. 2 primitive.

``gather_rows`` (R = 1): ``out[i] = x[idx[i]]`` for a 2-d ``x`` (B's ELL
index or value plane) and a 1-d int32 stream of row ids (A's column ids,
flattened).  Ids outside ``[0, n)`` are clipped, and the stream may have
any length: the CUDA kernel (``csrc/aia_gather.cu``) takes the reference
wrapper's clipping into the kernel and needs no padding to a block
multiple.  Replaces ``repro.kernels.aia_gather.gather_rows`` (the Pallas
scalar-prefetch DMA kernel) and its wrapper ``gather_rows_any``.

``aia_ranged_gather`` (any R): ``out[i*R:(i+1)*R] = x[idx[i]*R : +R]``,
ranges aligned to multiples of R as the reference's BlockSpec indices are.
The reference's contract is ids in range; here an id outside
``[0, n_blocks)`` is clipped, as in the row gather.  Its entry point
(``repro_aia_ranged_gather``, its own launch count) copies by one of two
routes (``ranged_route``): a range that is a whole number of 16-byte
vectors at a 16-byte aligned ``x`` goes to a 16-byte streaming copy,
chunk by chunk (``"v16"``); any other range to the row gather's word copy
on the ``(n_blocks, R*d)`` view (``"words"``), so a range must be a whole
number of 4-byte words at a 4-byte aligned ``x`` (else ``ValueError``).
Replaces ``repro.kernels.aia_gather.aia_ranged_gather``.

Both are copies, so each kernel and its plain version agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a clipped row take."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def _gather_rows_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x: expected a contiguous 2-d tensor, got shape "
                         f"{tuple(x.shape)}")
    ops.expect(idx, torch.int32, 1, "idx")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")
    n, d = x.shape
    row_bytes = d * x.element_size()
    if row_bytes % 4:
        raise ValueError(f"row of {row_bytes} bytes is not a multiple of 4")
    out = torch.empty((idx.shape[0], d), dtype=x.dtype, device=x.device)
    if idx.shape[0] == 0 or d == 0:
        return out
    if n == 0:
        raise ValueError("cannot gather rows from an empty x")
    with torch.cuda.device(x.device):
        rc = library().repro_gather_rows(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n, row_bytes // 4,
            idx.shape[0], torch.cuda.current_stream().cuda_stream)
    ops.check_launch("gather_rows", rc)
    return out


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx)]``: the plain version on the CPU, the kernel on CUDA."""
    return ops.dispatch(gather_rows_plain, _gather_rows_cuda, x, idx)


def _n_blocks(x: torch.Tensor, idx: torch.Tensor, r: int) -> int:
    if x.dim() != 2 or r < 1 or x.shape[0] % r:
        raise ValueError(f"x of shape {tuple(x.shape)} is not a whole number "
                         f"of {r}-row ranges")
    if x.shape[0] == 0 and idx.numel():
        raise ValueError("cannot gather ranges from an empty x")
    return x.shape[0] // r


def aia_ranged_gather_plain(x: torch.Tensor, idx: torch.Tensor,
                            r: int = 1) -> torch.Tensor:
    """The plain PyTorch version: a clipped take of whole ranges."""
    n_blocks = _n_blocks(x, idx, r)
    d = x.shape[1]
    ids = idx.clamp(0, max(n_blocks - 1, 0)).long()
    return x.reshape(n_blocks, r * d)[ids].reshape(idx.shape[0] * r, d)


def ranged_route(range_bytes: int, x_ptr: int) -> str:
    """The copy a CUDA ranged gather takes: ``"v16"`` (16-byte vectors) for
    a range of whole 16-byte vectors at a 16-byte aligned ``x``, else
    ``"words"`` (4-byte words).  The output, a fresh allocation, is always
    16-byte aligned."""
    return "v16" if range_bytes % 16 == 0 and x_ptr % 16 == 0 else "words"


def _aia_ranged_gather_cuda(x: torch.Tensor, idx: torch.Tensor,
                            r: int = 1) -> torch.Tensor:
    n_blocks = _n_blocks(x, idx, r)
    if not x.is_contiguous():
        raise ValueError("x: expected a contiguous tensor")
    ops.expect(idx, torch.int32, 1, "idx")
    ops.same_device(("x", x), ("idx", idx))
    d = x.shape[1]
    range_bytes = r * d * x.element_size()
    if range_bytes % 4:
        raise ValueError(f"a range of {r} x {d} {x.dtype} is {range_bytes} "
                         f"bytes, not a whole number of the kernel's 4-byte "
                         f"words")
    if x.data_ptr() % 4:
        raise ValueError("x: the word copy needs a 4-byte aligned tensor")
    out = torch.empty((idx.shape[0] * r, d), dtype=x.dtype, device=x.device)
    if idx.shape[0] == 0 or d == 0:
        return out
    path = ranged_route(range_bytes, x.data_ptr())
    with torch.cuda.device(x.device):
        rc = library().repro_aia_ranged_gather(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), n_blocks,
            range_bytes // 4, idx.shape[0], int(path == "v16"),
            torch.cuda.current_stream().cuda_stream)
    ops.check_launch("aia_ranged_gather", rc, path)
    return out


def aia_ranged_gather(x: torch.Tensor, idx: torch.Tensor,
                      r: int = 1) -> torch.Tensor:
    """``x``'s clipped ranges: the plain version on the CPU, the kernel on
    CUDA.  x: (n_blocks*R, d); idx: (N,) int32 on CUDA; out: (N*R, d)."""
    return ops.dispatch(aia_ranged_gather_plain, _aia_ranged_gather_cuda, x,
                        idx, r)


# The reference's name for its clip/pad/trim wrapper; here the kernel itself
# clips and takes any length, so the two are one function.
gather_rows_any = gather_rows
