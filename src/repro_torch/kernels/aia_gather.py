"""The AIA indirect row gather — the paper's Fig. 2 primitive with R = 1.

``out[i] = x[idx[i]]`` for a 2-d ``x`` (B's ELL index or value plane) and
a 1-d int32 stream of row ids (A's column ids, flattened).  Ids outside
``[0, n)`` are clipped, and the stream may have any length: the CUDA
kernel (``csrc/aia_gather.cu``) takes the reference wrapper's clipping into
the kernel and needs no padding to a block multiple.  It is a copy, so the
kernel and the plain version agree bit for bit.

Replaces ``repro.kernels.aia_gather.gather_rows`` (the Pallas
scalar-prefetch DMA kernel) and its wrapper ``gather_rows_any``.
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


# The reference's name for its clip/pad/trim wrapper; here the kernel itself
# clips and takes any length, so the two are one function.
gather_rows_any = gather_rows
