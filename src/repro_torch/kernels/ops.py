"""Device dispatch, launch counters and the public kernel entry points.

A kernel wrapper runs its plain PyTorch version for a tensor on the CPU and
launches its CUDA kernel for a tensor on a CUDA device; a DTensor and any
other device raise (a meta tensor takes the plain version only inside
``shape_trace``, the dry run's trace of shapes, where nothing runs).  There is no fallback from the card to the plain version.  Each
launch adds one to the kernel's count in ``LAUNCHES``, so a run can show
that its path went through the kernels.  The row gather (by its copy
unit), the ranged gather (by the range's alignment and width), the BSR
product (by dtype), the block TopK product (by dtype and block), the
per-token TopK product (by W2's rows and dtype), the hash accumulate (by
table size), the flash attention and its backward (by dtype, widths and
``p_dtype``) and the flash attention's keyless pass (forward or backward)
also count the CUDA route they took in ``ROUTE_LAUNCHES``, under
``"<kernel>/<route>"``.

The public wrappers ``gather_rows``, ``hash_accumulate``,
``aia_ranged_gather``, ``bsr_spmm``, ``topk_spmm`` and ``block_topk_spmm``
keep the reference's signatures (``repro.kernels.ops``), ``backend=``
included (the reference's ``resolve_backend`` reads an environment
variable, which this policy forbids, so it has no counterpart);
``flash_attention_fused`` takes the signature of the
reference's Pallas ``repro.kernels.flash_attention.flash_attention_fused``
with ``backend=`` in place of ``interpret=``; ``flash_attention_masked`` is
the same kernel under the model attention's masks (window, query offset,
key limit, Sq != Sk), which the reference computes in its chunked loop.  The device policy:

* ``"auto"`` (default): the kernel on CUDA, the plain version on the CPU;
* ``"xla"``: the reference's software-only baseline, asked for by name, in
  plain PyTorch on any device (for ``bsr_spmm`` that is
  ``core.spgemm_bsr.bsr_spgemm_dense_rhs``, as in the reference; for
  ``flash_attention_fused`` the kernel's plain blockwise version);
* ``"pallas"`` and ``"interpret"`` name TPU paths and raise ``ValueError``.

No environment variable and no ``try`` moves a CUDA call off its kernel.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
from torch.distributed.tensor import DTensor

LAUNCHES: Dict[str, int] = {
    "gather_rows": 0, "hash_accumulate": 0, "aia_ranged_gather": 0,
    "bsr_spmm": 0, "topk_spmm": 0, "block_topk_spmm": 0,
    "flash_attention_fused": 0, "flash_attention_bwd": 0,
    "flash_attention_keyless": 0, "segment_sum": 0,
}
ROUTE_LAUNCHES: Dict[str, int] = {}


def reset_launch_counts() -> None:
    """Set every kernel's launch count, and every route's, to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    ROUTE_LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    """A copy of the launch counts, by kernel name."""
    return dict(LAUNCHES)


def route_counts() -> Dict[str, int]:
    """A copy of the launch counts of routed kernels, by
    ``"<kernel>/<route>"``."""
    return dict(ROUTE_LAUNCHES)


_SHAPE_TRACE = [0]


@contextlib.contextmanager
def shape_trace():
    """Inside the block a meta tensor takes a wrapper's plain version: a
    trace of shapes and operation counts (``launch.dryrun``), where
    nothing runs.  Outside it a meta tensor raises, as any device without
    a kernel does."""
    _SHAPE_TRACE[0] += 1
    try:
        yield
    finally:
        _SHAPE_TRACE[0] -= 1


def on_plain_device(*tensors: torch.Tensor) -> bool:
    """True when a wrapper runs its plain version: tensors on the CPU (or
    on meta inside ``shape_trace``); False on CUDA; any other device
    raises.  A DTensor raises: a kernel takes each rank's local tensors,
    through ``local_map`` (``models.attention``), and a wrapper never
    gathers or unwraps one itself."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError("a DTensor reached a kernel wrapper; call the "
                            "kernel on each rank's local tensors "
                            "(torch.distributed.tensor.experimental."
                            "local_map)")
    dev = tensors[0].device
    if dev.type == "cpu" or (dev.type == "meta" and _SHAPE_TRACE[0]):
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"no kernel for tensors on {dev}")


def dispatch(plain: Callable, kernel: Callable, x: torch.Tensor, *args):
    """``plain(x, *args)`` on the CPU, ``kernel(x, *args)`` on CUDA; a
    DTensor among the tensors raises (``on_plain_device``)."""
    if on_plain_device(x, *(a for a in args if isinstance(a, torch.Tensor))):
        return plain(x, *args)
    return kernel(x, *args)


def launch_on(device: torch.device, fn: Callable, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, entering
    ``device`` only when it is not the current one; returns ``fn``'s
    CUDA error code."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def check_launch(name: str, rc: int, route: str | None = None) -> None:
    """Count one launch of ``name`` (and of ``name/route``), or raise on a
    non-zero CUDA error code returned by the launch (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc}")
    LAUNCHES[name] += 1
    if route is not None:
        key = f"{name}/{route}"
        ROUTE_LAUNCHES[key] = ROUTE_LAUNCHES.get(key, 0) + 1


def expect(x: torch.Tensor, dtype: torch.dtype, ndim: int, what: str) -> None:
    """Validate a kernel operand before its pointer is passed on."""
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{what}: expected a contiguous {ndim}-d {dtype} tensor, got "
            f"{x.dtype} of shape {tuple(x.shape)} (contiguous="
            f"{x.is_contiguous()})")


# the C entry points' dtype codes (csrc/dtypes.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
               torch.float64: 3}


def expect_float(x: torch.Tensor, ndim: int, what: str) -> int:
    """Validate a float32, bfloat16 or float16 kernel operand; return the C
    entry points' dtype code (0 float32, 1 bfloat16, 2 float16)."""
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise ValueError(f"{what}: expected float32, bfloat16 or float16, "
                         f"got {x.dtype}")
    expect(x, x.dtype, ndim, what)
    return DTYPE_CODES[x.dtype]


def same_device(*named: tuple) -> None:
    """Raise unless every ``(name, tensor)`` lies on the first one's device."""
    dev = named[0][1].device
    for name, x in named[1:]:
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, {named[0][0]} on {dev}")


def _route(backend: str, auto: Callable, plain: Callable) -> Callable:
    """The function ``backend`` names: ``auto`` dispatches by device."""
    if backend == "auto":
        return auto
    if backend == "xla":
        return plain
    if backend in ("pallas", "interpret"):
        raise ValueError(f"backend={backend!r} names a TPU path; the port "
                         f"takes 'auto' (kernel on CUDA, plain on the CPU) "
                         f"or 'xla' (plain)")
    raise ValueError(f"unknown backend {backend!r}")


def gather_rows(x, idx, rows_per_block: int = 8, backend: str = "auto"):
    """``x[clip(idx)]`` (K1).  ``rows_per_block`` is the reference's Pallas
    tile height; the CUDA kernel sizes its own tiles, so it is accepted
    and unused."""
    from repro_torch.kernels import aia_gather as k
    return _route(backend, k.gather_rows, k.gather_rows_plain)(x, idx)


def hash_accumulate(keys, vals, table_cap: int, backend: str = "auto"):
    """Algorithm-4 accumulation (K2).  ``"auto"`` gives the table in probe
    order (unsorted) with each row's uniqueCount, as the reference's
    kernel does; ``"xla"`` is the reference's fallback, the hash engine's
    column-sorted rows (``core.phases.accumulate_hash``).  Both carry the
    same (column, sum) content and counts."""
    if backend == "xla":
        from repro_torch.core import phases
        return phases.accumulate_hash(keys, vals, table_cap)
    from repro_torch.kernels import hash_accum as k
    return _route(backend, k.hash_accumulate, None)(keys, vals, table_cap)


def aia_ranged_gather(x, idx, r: int = 1, backend: str = "auto"):
    """``out[i*R:(i+1)*R] = x[idx[i]*R : +R]`` (ids clipped)."""
    from repro_torch.kernels import aia_gather as k
    return _route(backend, k.aia_ranged_gather,
                  k.aia_ranged_gather_plain)(x, idx, r)


def bsr_spmm(rowptr, colidx, a_blocks, b, max_blocks_per_row: int,
             backend: str = "auto"):
    """BSR ``(rowptr, colidx, a_blocks)`` @ dense ``b``, float32 out; the
    blocks of a row past ``max_blocks_per_row`` are dropped.

    ``backend="xla"`` runs the reference's XLA path instead,
    ``core.spgemm_bsr.bsr_spgemm_dense_rhs``: it keeps every block and
    returns the blocks' dtype, as ``repro.kernels.ops.bsr_spmm`` does.
    """
    from repro_torch.kernels import spgemm_bsr as k
    return _route(backend, k.bsr_spmm, k.bsr_spmm_xla)(
        rowptr, colidx, a_blocks, b, max_blocks_per_row)


def topk_spmm(vals, idx, w2, backend: str = "auto"):
    """``y[i] = sum_t vals[i, t] * w2[idx[i, t]]`` in float32."""
    from repro_torch.kernels import topk_spmm as k
    return _route(backend, k.topk_spmm, k.topk_spmm_plain)(vals, idx, w2)


def block_topk_spmm(h_kept, bidx, w2, block: int = 128,
                    backend: str = "auto"):
    """``y[tile] = sum_t h_kept[tile, t] @ w2[bidx[tile, t]*block : +block]``
    in float32, shape ``(n_tiles * tile, d)``."""
    from repro_torch.kernels import topk_spmm as k
    return _route(backend, k.block_topk_spmm, k.block_topk_spmm_plain)(
        h_kept, bidx, w2, block)


def flash_attention_fused(q, k, v, causal: bool = True, q_blk: int = 128,
                          k_blk: int = 128, backend: str = "auto"):
    """Online-softmax attention on ``(BH, S, D)`` q and k and a ``(BH, S,
    Dv)`` v (any D and Dv) with KV expanded to the query heads, scale
    ``1/sqrt(D)``, output ``(BH, S, Dv)`` in ``q``'s dtype; ``S`` must be a
    multiple of ``min(q_blk, S)`` and ``min(k_blk, S)``."""
    from repro_torch.kernels import flash_attention as k7
    return _route(backend, k7.flash_attention_fused,
                  k7.flash_attention_fused_plain)(q, k, v, causal, q_blk,
                                                  k_blk)


def flash_attention_masked(q, k, v, causal: bool = True, window: int = 0,
                           q_offset: int = 0, kv_len=None, p_dtype=None,
                           k_chunk: int = 1024, backend: str = "auto"):
    """K7 under the chunked attention's masks, on ``(BH, Sq, D)`` q,
    ``(BH, Sk, D)`` k and ``(BH, Sk, Dv)`` v (any D and Dv), KV expanded to
    the query heads: key j is valid for query i iff ``j < kv_len``, ``j <=
    i + q_offset`` when causal and ``j > i + q_offset - window`` when
    ``window > 0``; ``p_dtype=torch.bfloat16`` rounds P and V before P.V; a
    query without a valid key gets the reference's row for its key chunk
    ``k_chunk``; output ``(BH, Sq, Dv)`` in ``q``'s dtype.  It counts as a
    launch of ``flash_attention_fused`` (and of ``flash_attention_keyless``
    where some query has no key); under autograd its backward kernel counts
    once a backward, as ``flash_attention_bwd``."""
    from repro_torch.kernels import flash_attention as k7
    return _route(backend, k7.flash_attention_masked,
                  k7.flash_attention_masked_plain)(
        q, k, v, causal, window, q_offset, kv_len, p_dtype, k_chunk)
