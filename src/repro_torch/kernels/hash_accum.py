"""Algorithm 4 (InsertIntoTable / AddInTable), one table per output row.

Each row's padded intermediate-product stream ``(keys, vals)`` is inserted
in stream order into its own ``table_cap``-slot linear-probing table
(``EMPTY = -1``; keys < 0 are padding; home slot
``uint32(key) * 2654435761 mod table_cap``; probe bound ``table_cap``).
The table comes back unsorted, in probe order, with the occupied count.
Because every key takes the slot, and every key's sum the terms and order,
of a one-at-a-time insert in stream order, the CUDA kernel
(``csrc/hash_accum.cu``: the windows of 32 slots that hold a product
found in parallel, then a warp per row inserting them a window at a time),
the plain version (``core.hashtable``) and the reference's scan engine and
Pallas kernel give the same table bit for bit.  On CUDA the table's size
chooses where the kernel keeps it (``route``): in shared memory up to
8,192 slots (Table-I groups 0-2, ``"smem"``), else in the output buffers
in global memory (group 3, ``"global"``).  Values may be float32,
bfloat16 or float16: the table's sums keep the values' type, each add
rounded to it, as the plain version's and the reference's adds in that
type are, so a low-precision table is the CPU's bits too.

Replaces ``repro.kernels.hash_accum.hash_accumulate`` (the Pallas
``_hash_kernel``); ``hash_accumulate_sorted`` is the counterpart of the
reference's fused-engine entry, with the column sort in PyTorch as the
reference keeps it in XLA.
"""
from __future__ import annotations

import torch

from repro_torch.core import hashtable
from repro_torch.core.hashtable import EMPTY, MULTIPLIER  # noqa: F401
from repro_torch.kernels import ops
from repro_torch.kernels._build import library, source_constants


def route(table_cap: int) -> str:
    """Where a CUDA call keeps its ``table_cap``-slot tables: ``"smem"``
    (shared memory, 8 bytes a slot up to the source's
    ``kSmemTableBytes``) or ``"global"``."""
    limit = source_constants("hash_accum.cu")["kSmemTableBytes"]
    return "smem" if table_cap * 8 <= limit else "global"


def hash_accumulate_plain(keys: torch.Tensor, vals: torch.Tensor,
                          table_cap: int):
    """The plain PyTorch version: the lockstep stream insert."""
    return hashtable.insert_stream(keys, vals, table_cap)


def _hash_accumulate_cuda(keys: torch.Tensor, vals: torch.Tensor,
                          table_cap: int):
    ops.expect(keys, torch.int32, 2, "keys")
    code = ops.expect_float(vals, 2, "vals")
    if vals.shape != keys.shape or vals.device != keys.device:
        raise ValueError(f"vals {tuple(vals.shape)} on {vals.device} must "
                         f"match keys {tuple(keys.shape)} on {keys.device}")
    if not 0 < table_cap < 2**31:
        raise ValueError(f"table_cap {table_cap} out of range")
    r, ip_cap = keys.shape
    dev = keys.device
    cols = torch.empty((r, table_cap), dtype=torch.int32, device=dev)
    out = torch.empty((r, table_cap), dtype=vals.dtype, device=dev)
    cnt = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return cols, out, cnt
    # a bit for each window of 32 slots that holds a product
    word = source_constants("hash_accum.cu")["kWordSlots"]
    masks = torch.empty((r, -(-ip_cap // word)), dtype=torch.int32,
                        device=dev)
    with torch.cuda.device(dev):
        rc = library().repro_hash_accumulate(
            keys.data_ptr(), vals.data_ptr(), masks.data_ptr(),
            cols.data_ptr(), out.data_ptr(), cnt.data_ptr(), r, ip_cap,
            table_cap, code, torch.cuda.current_stream().cuda_stream)
    ops.check_launch("hash_accumulate", rc, route(table_cap))
    return cols, out, cnt


def hash_accumulate(keys: torch.Tensor, vals: torch.Tensor, table_cap: int):
    """Per-row Algorithm-4 accumulation.

    keys: (R, ip_cap) int32, -1 padded; vals: (R, ip_cap) (float32,
    bfloat16 or float16 on CUDA).
    Returns (cols (R, table_cap) int32 EMPTY-padded, *unsorted*;
    vals (R, table_cap); counts (R,) int32).
    """
    return ops.dispatch(hash_accumulate_plain, _hash_accumulate_cuda,
                        keys, vals, table_cap)


def hash_accumulate_sorted(keys: torch.Tensor, vals: torch.Tensor,
                           table_cap: int, out_cap: int):
    """Accumulate + Algorithm 5 step 3 (column sort) + trim to ``out_cap``.

    Returns (cols (R, out_cap) int32 -1-padded, vals (R, out_cap), counts
    (R,) int32); ``out_cap`` >= uniqueCount must hold.
    """
    tk, tv, cnt = hash_accumulate(keys, vals, table_cap)
    return hashtable.extract_sorted(tk, tv, cnt, out_cap)
