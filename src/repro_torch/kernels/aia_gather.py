"""The AIA indirect gather — the paper's Fig. 2 primitive.

``gather_planes`` (R = 1): ``out_p[i] = x_p[idx[i]]`` for one or two 2-d
planes ``x_p`` of equal row count (B's ELL index and value planes) and one
1-d int32 stream of row ids (A's column ids, flattened).  Ids outside
``[0, n)`` are clipped, and the stream may have any length: the CUDA kernel
(``csrc/aia_gather.cu``) takes the reference wrapper's clipping into the
kernel, needs no padding to a block multiple, and gathers both planes in
one launch.  It copies in the widest unit that divides every plane's row
bytes and every plane's and output's address (``gather_unit``: 16, 8, 4, 2
or 1 bytes), and counts each launch under ``gather_rows/<unit>``.
``gather_rows`` is its one-plane case.  Replaces
``repro.kernels.aia_gather.gather_rows`` (the Pallas scalar-prefetch DMA
kernel) and its wrapper ``gather_rows_any``.

``aia_ranged_gather`` (any R): ``out[i*R:(i+1)*R] = x[idx[i]*R : +R]``,
ranges aligned to multiples of R as the reference's BlockSpec indices are.
The reference's contract is ids in range; here an id outside
``[0, n_blocks)`` is clipped, as in the row gather.  Its entry point
(``repro_aia_ranged_gather``, its own launch count) copies by one of two
routes (``ranged_route``): a range that is a whole number of 16-byte
vectors at a 16-byte aligned ``x`` goes to a 16-byte streaming copy,
chunk by chunk (``"v16"``); any other range to the row gather's 4-byte
copy on the ``(n_blocks, R*d)`` view (``"words"``), so a range must be a
whole number of 4-byte words at a 4-byte aligned ``x`` (else
``ValueError``).  Replaces ``repro.kernels.aia_gather.aia_ranged_gather``.

Both are copies, so each kernel and its plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import library

# the row gather's copy units, widest first: route name -> bytes
UNITS = {"v16": 16, "v8": 8, "words": 4, "u16": 2, "bytes": 1}


def _check_planes(planes, idx) -> int:
    """Validate the planes' shapes against each other and every plane's
    device against ``idx``'s; return their rows."""
    if not 1 <= len(planes) <= 2:
        raise ValueError(f"expected one or two planes, got {len(planes)}")
    ops.same_device(("idx", idx),
                    *((f"plane {j}", x) for j, x in enumerate(planes)))
    n = planes[0].shape[0] if planes[0].dim() == 2 else -1
    for x in planes:
        if x.dim() != 2 or x.shape[0] != n:
            raise ValueError(f"x: expected 2-d planes of equal row count, "
                             f"got shapes {[tuple(p.shape) for p in planes]}")
    if n == 0 and idx.numel():
        raise ValueError("cannot gather rows from an empty x")
    return n


def gather_planes_plain(planes: Sequence[torch.Tensor],
                        idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch version: a clipped row take of each plane."""
    planes = tuple(planes)
    n = _check_planes(planes, idx)
    safe = idx.clamp(0, max(n - 1, 0)).long()
    return tuple(x[safe] for x in planes)


def gather_unit(row_bytes: Sequence[int], ptrs: Sequence[int]) -> str:
    """The copy unit a CUDA row gather takes: the widest of ``"v16"``,
    ``"v8"``, ``"words"`` (4 bytes), ``"u16"`` and ``"bytes"`` that divides
    every plane's row bytes and every address in ``ptrs`` (each plane's and
    each output's)."""
    for name, unit in UNITS.items():
        if all(b % unit == 0 for b in row_bytes) and \
                all(p % unit == 0 for p in ptrs):
            return name
    raise AssertionError("a 1-byte unit divides everything")


def _gather_planes_cuda(planes, idx):
    planes = tuple(planes)
    ops.expect(idx, torch.int32, 1, "idx")
    n = _check_planes(planes, idx)
    if not all(x.is_contiguous() for x in planes):
        raise ValueError("x: expected contiguous planes")
    n_idx = idx.shape[0]
    outs = tuple(torch.empty((n_idx, x.shape[1]), dtype=x.dtype,
                             device=x.device) for x in planes)
    live = [(x, o) for x, o in zip(planes, outs) if x.shape[1]]
    if n_idx == 0 or not live:
        return outs
    row_bytes = [x.shape[1] * x.element_size() for x, _ in live]
    route = gather_unit(row_bytes, [t.data_ptr() for xo in live for t in xo])
    (x0, o0), (x1, o1) = live[0], live[1] if len(live) == 2 else (None, None)
    rc = ops.launch_on(
        idx.device, library().repro_gather_planes, idx.data_ptr(), n_idx, n,
        x0.data_ptr(), o0.data_ptr(), row_bytes[0],
        None if x1 is None else x1.data_ptr(),
        None if o1 is None else o1.data_ptr(),
        row_bytes[1] if x1 is not None else 0, UNITS[route])
    ops.check_launch("gather_rows", rc, route)
    return outs


def gather_planes(planes: Sequence[torch.Tensor],
                  idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``tuple(x[clip(idx)] for x in planes)`` for one or two planes of equal
    row count on ``idx``'s device: the plain version on the CPU, one kernel
    launch on CUDA (chosen by the planes' device, as ``gather_rows`` is)."""
    planes = tuple(planes)
    return ops.dispatch(lambda _, p, i: gather_planes_plain(p, i),
                        lambda _, p, i: _gather_planes_cuda(p, i),
                        planes[0] if planes else idx, planes, idx)


def gather_rows_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a clipped row take."""
    return gather_planes_plain((x,), idx)[0]


def _gather_rows_cuda(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return _gather_planes_cuda((x,), idx)[0]


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
