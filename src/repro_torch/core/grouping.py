"""Row-grouping phase (paper §III-B, Table I).

Rows of A are classified into four groups by intermediate-product count
using logarithmic binning, then *logically* reordered through the ``Map``
array (no data moves).  Each group gets its own hash-table capacity:

| Group | IP range   | paper: threads   | table capacity          |
|-------|------------|------------------|-------------------------|
| 0     | 0–31       | PWPR, block 512  | 64                      |
| 1     | 32–511     | TBPR, block 256  | 1024                    |
| 2     | 512–8191   | TBPR, block 1024 | 8192                    |
| 3     | ≥8192      | TBPR, global HT  | next_pow2(max IP)       |
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.ip_count import intermediate_products
from repro_torch.sparse.formats import CSR

# (ip_lo, ip_hi_exclusive, table_capacity); the group-3 capacity is resolved
# at plan time from the actual max IP (the paper's global-memory table).
TABLE_I = (
    (0, 32, 64),
    (32, 512, 1024),
    (512, 8192, 8192),
    (8192, None, None),
)

GROUP_BOUNDARIES = (32, 512, 8192)


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """Host-side schedule produced by the row-grouping phase.

    ``map_rows`` is the paper's ``Map``: ``map_rows[i]`` = original row id of
    the i-th row in group-sorted order.  ``group_offsets`` delimits groups in
    that order; ``group_sizes_padded`` round each group up to a quantum.
    ``row_ip`` keeps the Algorithm-1 IP count per original row: it bounds
    every row's uniqueCount, which the sync-free ``sizing="planned"`` lane
    uses to size outputs without reading counts back from the device.
    ``group_engines`` is a per-bin engine assignment (one registered engine
    name per Table-I group), or ``None`` for uniform dispatch under the
    caller's ``engine=``.  ``group_rows`` leaves it ``None``; callers force
    a mixed assignment with ``dataclasses.replace(plan,
    group_engines=(...))``, which wins over the call's ``engine=``.
    """

    map_rows: np.ndarray  # (n_rows,) int32
    group_id: np.ndarray  # (n_rows,) int32 per original row
    group_offsets: np.ndarray  # (5,) int32 cumulative
    group_sizes: Tuple[int, int, int, int]
    group_sizes_padded: Tuple[int, int, int, int]
    table_capacities: Tuple[int, int, int, int]
    max_ip: int
    total_ip: int
    row_ip: np.ndarray  # (n_rows,) int64 Alg. 1 IP per original row
    group_engines: Tuple[str, str, str, str] = None  # per-bin engine names

    def rows_of_group(self, g: int) -> np.ndarray:
        return self.map_rows[self.group_offsets[g]: self.group_offsets[g + 1]]


def assign_groups(ip: np.ndarray) -> np.ndarray:
    """Group id per row (0..3) from IP, log-binned per Table I."""
    return np.searchsorted(np.asarray(GROUP_BOUNDARIES), np.asarray(ip),
                           side="right").astype(np.int32)


def build_map(ip) -> np.ndarray:
    """The paper's Map: the rows' stable argsort by group id (int32).
    ``ip`` is a host array or a tensor on any device."""
    ip = ip.cpu().numpy() if hasattr(ip, "cpu") else ip
    return np.argsort(assign_groups(ip), kind="stable").astype(np.int32)


def _pad_size(n: int, quantum: int = 64) -> int:
    if n == 0:
        return 0
    return int(np.ceil(n / quantum) * quantum)


def group_rows(a: CSR, b: CSR, pad_quantum: int = 64) -> GroupPlan:
    """Run the row-grouping phase and return the host-side schedule.

    Reading the IP counts back to the host is the one intentional device
    to host transfer of planning, as in the paper (group sizes configure
    the launches).
    """
    ip = intermediate_products(a, b).cpu().numpy()
    gid = assign_groups(ip)
    map_rows = np.argsort(gid, kind="stable").astype(np.int32)
    sizes = tuple(int((gid == g).sum()) for g in range(4))
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    max_ip = int(ip.max(initial=0))
    caps = []
    for _, _, cap in TABLE_I:
        if cap is None:
            # group 3: global-memory table sized to the next pow2 >= max IP
            cap = 1 << int(np.ceil(np.log2(max(max_ip, 2))))
        caps.append(int(cap))
    return GroupPlan(
        map_rows=map_rows,
        group_id=gid,
        group_offsets=offsets,
        group_sizes=sizes,
        group_sizes_padded=tuple(_pad_size(s, pad_quantum) for s in sizes),
        table_capacities=tuple(caps),
        max_ip=max_ip,
        total_ip=int(ip.sum()),
        row_ip=ip.astype(np.int64),
    )


def support_footprint(indptr: np.ndarray, indices: np.ndarray,
                      rows: np.ndarray) -> np.ndarray:
    """Sorted unique column ids of A on ``rows``: the B rows that the
    chunks owning those rows read, and nothing else.  Host arithmetic on
    A's structure, with no loop over rows and no sort (the ids are marked
    in a table of B's rows)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices)
    rows = np.asarray(rows, np.int64)
    if rows.size == 0:
        return np.empty(0, np.int64)
    starts = indptr[rows]
    counts = indptr[rows + 1] - starts
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    # every (row, slot) pair's flat slot id
    offsets = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    flat = np.repeat(starts - offsets, counts) + np.arange(total)
    cols = np.asarray(indices[flat], np.int64)
    seen = np.zeros(int(cols.max()) + 1, bool)
    seen[cols] = True
    return np.flatnonzero(seen)
