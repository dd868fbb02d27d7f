"""Plan-compiled SpGEMM executor — the group pipeline behind ``spgemm()``.

Single-device counterpart of ``repro.core.executor``.  The row-grouping
phase (``core.grouping``) produces a ``GroupPlan``; ``partition_plan`` cuts
it into group-chunks, and ``execute_plan`` runs each chunk's A-row gather →
B-row gather → product formation → per-row accumulation on the operands'
device, then reassembles the CSR on that device.

Two pluggable axes:

* **engine** — ``"hash"`` (Algorithms 2/3/5, the linear-probing table),
  ``"sort"`` (the vectorised sort + segment-sum engine) and ``"fused_hash"``
  (the hash engine as one pass per chunk, with no allocate pass).
* **gather** — how B's rows are fetched for ``b_ell[cols_A]``: ``"xla"`` is
  a plain tensor take, ``"aia"`` the AIA row-gather kernel
  (``kernels.aia_gather``).  ``"auto"`` is ``"aia"`` on a CUDA device and
  ``"xla"`` on the CPU — the paper's Fig. 7 "without AIA" axis is one flag.

Two sizing lanes:

* **measured** (two waves): wave 1 forms every chunk's products and
  uniqueCounts, one coalesced device-to-host read sizes every chunk's
  output at once (``host_sync_count`` 1), wave 2 accumulates.
* **planned**: every output capacity comes from the plan's Alg. 1 IP
  bounds (uniqueCount <= min(IP, n_cols) per row), the indptr is built on
  the device, and the lane reads nothing back (``host_sync_count`` 0;
  ``nnz`` comes back as a 0-d device tensor).

All chunks' row ids go to the device in one copy from pinned memory before
the dispatch loop, and every shape in the loop comes from the host plan, so
the loop itself never waits for the device.  Before it, ``execute_plan``
reads A's and B's ``indptr`` back once (to cut the plan into chunks and
size B's ELL), as the reference does.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Literal, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import phases
from repro_torch.core.grouping import GroupPlan, group_rows
from repro_torch.kernels.aia_gather import gather_planes
from repro_torch.sparse.formats import CSR, csr_to_ell

Gather = Literal["auto", "xla", "aia"]
Sizing = Literal["auto", "planned", "measured"]

# Rows per chunk are padded to a multiple of this (-1 = padding row).
ROW_QUANTUM = 8


def next_pow2(x: int) -> int:
    """Smallest power of two >= ``x`` (and >= 1)."""
    return 1 << int(np.ceil(np.log2(max(int(x), 1))))


# ---------------------------------------------------------------------------
# Engine registry — hash, sort and fused_hash behind one interface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """One allocation/accumulation engine (paper phases 2 + 3).

    ``allocate(keys, table_cap)`` → per-row uniqueCount (Algorithms 2/3).
    ``accumulate(keys, vals, table_cap, out_cap)`` → (cols, vals, counts)
    with rows column-sorted and trimmed/padded to ``out_cap`` (Algorithm 5).
    ``fused=True`` marks a single-pass engine, which ``sizing="auto"`` runs
    in the planned lane.
    """

    name: str
    allocate: Callable
    accumulate: Callable
    fused: bool = False


ENGINES: Dict[str, Engine] = {}


def register_engine(engine: Engine) -> Engine:
    """Add an ``Engine`` to the registry (keyed by name) and return it."""
    ENGINES[engine.name] = engine
    return engine


def get_engine(name: str) -> Engine:
    """Look up a registered engine by name (ValueError when unknown)."""
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {sorted(ENGINES)}"
        ) from None


def available_engines() -> Tuple[str, ...]:
    """Sorted names of every registered engine (the ``engine=`` choices)."""
    return tuple(sorted(ENGINES))


def resolve_engine(engine: Optional[str] = None,
                   method: Optional[str] = None) -> str:
    """Validate ``engine=``; ``None`` falls back to ``method or "sort"``
    (``method`` is the façade's legacy alias)."""
    if engine is None:
        engine = method or "sort"
    elif method is not None and method != engine:
        raise ValueError(
            f"conflicting method={method!r} (legacy alias) and "
            f"engine={engine!r}")
    get_engine(engine)
    return engine


def _sort_accumulate(keys, vals, table_cap: int, out_cap: int):
    return phases.accumulate_sort(keys, vals, out_cap)


register_engine(Engine("hash", phases.allocate_hash, phases.fused_hash_sorted))
register_engine(Engine("sort", lambda keys, cap: phases.allocate_sort(keys),
                       _sort_accumulate))
# The paper's Alg. 2/3/5 as one pass over A's row: gather → products →
# linear-probe insert, with no allocate pass.  The allocate/accumulate pair
# serves sizing="measured".
register_engine(Engine("fused_hash", phases.allocate_hash,
                       phases.fused_hash_sorted, fused=True))


# ---------------------------------------------------------------------------
# Gather backends — how b_ell[cols_A] is served
# ---------------------------------------------------------------------------

def resolve_gather(gather: Gather, device) -> str:
    """``"auto"`` → the AIA kernel on a CUDA device, a plain take on the CPU."""
    if gather == "auto":
        return "aia" if torch.device(device).type == "cuda" else "xla"
    if gather not in ("xla", "aia"):
        raise ValueError(f"unknown gather backend {gather!r}")
    return gather


def _gather_b_xla(b_idx, b_val, cols_a):
    safe = cols_a.clamp(0, b_idx.shape[0] - 1).long()
    return b_idx[safe], b_val[safe]


def _gather_b_aia(b_idx, b_val, cols_a):
    """B-row gather as the paper's AIA stream: ``cols_a`` flattened into one
    index stream, served by one row-gather launch for both planes."""
    r, a_cap = cols_a.shape
    kb = b_idx.shape[1]
    bi, bv = gather_planes((b_idx, b_val), cols_a.reshape(-1))
    return bi.reshape(r, a_cap, kb), bv.reshape(r, a_cap, kb)


GATHERS: Dict[str, Callable] = {"xla": _gather_b_xla, "aia": _gather_b_aia}


# ---------------------------------------------------------------------------
# Output sizing — measured (uniqueCount read) vs planned (Alg. 1 bounds)
# ---------------------------------------------------------------------------

def resolve_sizing(sizing: Sizing, engine: str, plan=None) -> str:
    """``"auto"`` → ``"planned"`` for fused engines, ``"measured"``
    otherwise; ``"planned"`` needs a plan that carries ``row_ip``."""
    if sizing not in ("auto", "planned", "measured"):
        raise ValueError(f"unknown sizing {sizing!r}")
    has_ip = getattr(plan, "row_ip", None) is not None
    if sizing == "auto":
        return "planned" if get_engine(engine).fused and has_ip \
            else "measured"
    if sizing == "planned" and plan is not None and not has_ip:
        raise ValueError(
            "sizing='planned' needs a plan carrying Alg. 1 row IP counts "
            "(GroupPlan.row_ip); re-plan with core.grouping.group_rows")
    return sizing


def chunk_capacity_bounds(plan: GroupPlan, rows: np.ndarray,
                          n_cols: int) -> Tuple[int, int]:
    """(max-unique, total-unique) bounds for one chunk of rows: uniqueCount
    of row r is at most ``min(IP[r], n_cols(B))``.  Host arithmetic only."""
    ip = np.asarray(plan.row_ip)[rows].astype(np.int64)
    unique = np.minimum(ip, int(n_cols))
    return int(unique.max(initial=0)), int(unique.sum())


def _out_cap(max_unique: int, table_cap: int, ncol_cap: int) -> int:
    """pow2-quantized chunk output capacity from a chunk's largest row
    uniqueCount: the plan's bound (planned) or the measured count."""
    return max(min(next_pow2(max_unique), max(table_cap, 1), ncol_cap), 1)


_INT32_MAX = int(np.iinfo(np.int32).max)


def _int32_nnz_capacity(nnz: int) -> int:
    """pow2-quantized total-nnz capacity of the output CSR buffers; a
    result whose nnz does not fit int32 raises instead of wrapping."""
    if nnz > _INT32_MAX:
        raise OverflowError(
            f"SpGEMM output has {nnz} nonzeros, which does not fit the "
            "int32 CSR index space used by the reassembly epilogue")
    cap = next_pow2(max(nnz, 1))
    return cap if cap <= _INT32_MAX else max(int(nnz), 1)


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_PLAN_STATS = {"plan_hits": 0, "plan_misses": 0}
# One increment per deliberate blocking read of device results inside the
# pipeline: one per measured call, none per planned call.
_SYNC_STATS = {"host_sync_count": 0}


def cache_stats() -> Dict[str, int]:
    """Executor counters: ``plan_hits``/``plan_misses`` (``PlanCache``
    lookups, every instance folded in) and ``host_sync_count`` (blocking
    reads of device results inside the pipeline)."""
    return {**_PLAN_STATS, **_SYNC_STATS}


def clear_program_cache() -> None:
    """Zero the ``cache_stats()`` counters."""
    for stats in (_PLAN_STATS, _SYNC_STATS):
        for k in stats:
            stats[k] = 0


# ---------------------------------------------------------------------------
# Plan cache — amortize Alg. 1 + Table-I binning across same-pattern calls
# ---------------------------------------------------------------------------

def pattern_fingerprint(*mats: CSR) -> str:
    """Sparsity-pattern fingerprint of CSR operands: blake2b over shape,
    indptr and the occupied slots of indices (values and padding excluded).
    Reads the structure back to the host."""
    h = hashlib.blake2b(digest_size=16)
    for m in mats:
        indptr = m.indptr.cpu().numpy()
        nnz = int(indptr[-1])
        h.update(np.asarray(m.shape, np.int64).tobytes())
        h.update(indptr.tobytes())
        h.update(m.indices[:nnz].cpu().numpy().tobytes())
    return h.hexdigest()


class PlanCache:
    """Fingerprint-keyed ``GroupPlan`` cache (LRU, bounded)."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, GroupPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def plan_for(self, a: CSR, b: CSR) -> GroupPlan:
        """Serve (hit) or build (miss) the plan for ``(a, b)``'s pattern."""
        key = pattern_fingerprint(a, b)
        plan = self._entries.get(key)
        if plan is None:
            self.misses += 1
            _PLAN_STATS["plan_misses"] += 1
            plan = group_rows(a, b)
            self._entries[key] = plan
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        else:
            self.hits += 1
            _PLAN_STATS["plan_hits"] += 1
            self._entries.move_to_end(key)
        return plan

    def stats(self) -> Dict[str, int]:
        """Per-instance ``hits``, ``misses`` and ``entries``."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}


# ---------------------------------------------------------------------------
# Plan partitioning
# ---------------------------------------------------------------------------

def ungrouped_plan(plan: GroupPlan) -> GroupPlan:
    """Collapse to one natural-order group at worst-case capacity
    (the Fig. 7 "without AIA scheduling" software baseline)."""
    n = len(plan.map_rows)
    cap = next_pow2(max(plan.max_ip, 2))
    return GroupPlan(
        map_rows=np.arange(n, dtype=np.int32),
        group_id=np.zeros(n, np.int32),
        group_offsets=np.asarray([0, n, n, n, n], np.int32),
        group_sizes=(n, 0, 0, 0),
        group_sizes_padded=(n, 0, 0, 0),
        table_capacities=(cap, cap, cap, cap),
        max_ip=plan.max_ip,
        total_ip=plan.total_ip,
        row_ip=plan.row_ip,
    )


def _pad_rows(k: int) -> int:
    return int(np.ceil(k / ROW_QUANTUM) * ROW_QUANTUM)


@dataclasses.dataclass(frozen=True)
class WorkItem:
    """One (group, row-chunk) dispatch."""

    group: int
    rows: np.ndarray  # (R,) original row ids of this chunk
    a_cap: int        # exact max nnz(A row) over the *group*
    table_cap: int    # Table-I hash-table capacity of the group


def partition_plan(plan: GroupPlan, a_row_nnz: np.ndarray,
                   row_chunk: int) -> List[WorkItem]:
    """Split a ``GroupPlan`` into group-chunks of at most ``row_chunk``
    rows.  ``a_cap`` is a group-level maximum, so a row's result never
    depends on the chunking."""
    items: List[WorkItem] = []
    for g in range(4):
        rows = plan.rows_of_group(g)
        if len(rows) == 0:
            continue
        a_cap = max(int(a_row_nnz[rows].max(initial=0)), 1)
        for lo in range(0, len(rows), row_chunk):
            items.append(WorkItem(g, np.asarray(rows[lo: lo + row_chunk]),
                                  a_cap, plan.table_capacities[g]))
    return items


# ---------------------------------------------------------------------------
# Plan execution
# ---------------------------------------------------------------------------

def _upload(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array → ``device`` without waiting: on CUDA the copy is staged
    in pinned memory and queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _chunk_rows(items: List[WorkItem], device) -> Tuple[torch.Tensor,
                                                         List[torch.Tensor]]:
    """Every chunk's row ids, padded to ``ROW_QUANTUM`` with -1, uploaded in
    one copy; returns the whole stream and one view per chunk."""
    parts = []
    for item in items:
        pad = _pad_rows(len(item.rows)) - len(item.rows)
        parts.append(np.concatenate([item.rows.astype(np.int32),
                                     np.full(pad, -1, np.int32)]))
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=device), []
    rows_all = _upload(np.concatenate(parts), device)
    return rows_all, list(torch.split(rows_all, [len(p) for p in parts]))


def _coalesced_sync(counts: List[torch.Tensor]) -> List[np.ndarray]:
    """The measured lane's one blocking read: every chunk's uniqueCounts,
    already queued, come back in a single device-to-host copy."""
    if not counts:
        return []
    _SYNC_STATS["host_sync_count"] += 1
    host = torch.cat(counts).cpu().numpy()
    return np.split(host, np.cumsum([len(c) for c in counts])[:-1])


@dataclasses.dataclass
class _ChunkRun:
    """One chunk's accumulated output, on the device."""

    rows: torch.Tensor    # (R_pad,) row ids, -1 = padding
    cols: torch.Tensor    # (R_pad, out_cap)
    vals: torch.Tensor    # (R_pad, out_cap)
    counts: torch.Tensor  # (R_pad,)


def _enumerate(a: CSR, rows: torch.Tensor, item: WorkItem, b_idx, b_val,
               gather: str):
    """A-row gather → B-row gather → intermediate products of one chunk."""
    cols_a, vals_a = phases.gather_group_rows(a.indptr, a.indices, a.data,
                                              rows, item.a_cap)
    bi, bv = GATHERS[gather](b_idx, b_val, cols_a)
    return phases.combine_products(cols_a, vals_a, bi, bv)


def _run_measured(a, items, chunk_rows, b_idx, b_val, gather, eng, ncol_cap):
    """Two waves around one coalesced read of every chunk's uniqueCounts."""
    pend = []
    for item, rows in zip(items, chunk_rows):
        keys, vals = _enumerate(a, rows, item, b_idx, b_val, gather)
        pend.append((keys, vals, eng.allocate(keys, item.table_cap)))
    unique = _coalesced_sync(
        [p[2][: len(item.rows)] for p, item in zip(pend, items)])
    nnz = int(sum(int(u.sum()) for u in unique))
    runs = []
    for i, (item, rows) in enumerate(zip(items, chunk_rows)):
        keys, vals, _ = pend[i]
        pend[i] = None  # free this chunk's products once consumed
        out_cap = _out_cap(int(unique[i].max(initial=0)), item.table_cap,
                           ncol_cap)
        runs.append(_ChunkRun(rows, *eng.accumulate(keys, vals,
                                                    item.table_cap, out_cap)))
    return runs, nnz, _int32_nnz_capacity(nnz)


def _run_planned(a, items, chunk_rows, b_idx, b_val, gather, eng, ncol_cap,
                 plan, ncol):
    """Sizes from the plan's Alg. 1 bounds: nothing is read back."""
    bounds = [chunk_capacity_bounds(plan, item.rows, ncol) for item in items]
    runs = []
    for item, rows, (max_u, _) in zip(items, chunk_rows, bounds):
        out_cap = _out_cap(max_u, item.table_cap, ncol_cap)
        keys, vals = _enumerate(a, rows, item, b_idx, b_val, gather)
        runs.append(_ChunkRun(rows, *eng.accumulate(keys, vals,
                                                    item.table_cap, out_cap)))
    return runs, _int32_nnz_capacity(sum(s for _, s in bounds))


def _epilogue(runs: List[_ChunkRun], rows_all: torch.Tensor, n: int,
              cap: int, dtype, device):
    """Build the int32 indptr on the device from the chunks' counts, then
    scatter every chunk's rows into the (cap,) index and value buffers."""
    counts_all = torch.zeros(n + 1, dtype=torch.int32, device=device)
    if runs:  # padding rows (-1) land in the extra slot n; their count is 0
        dest = torch.where(rows_all < 0, n, rows_all).long()
        counts_all[dest] = torch.cat([r.counts for r in runs])
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    indptr[1:] = torch.cumsum(counts_all[:n], 0, dtype=torch.int32)
    idx_buf = torch.zeros(cap + 1, dtype=torch.int32, device=device)
    dat_buf = torch.zeros(cap + 1, dtype=dtype, device=device)
    for run in runs:
        phases.reassemble_device(idx_buf, dat_buf, run.cols, run.vals,
                                 run.counts, indptr[run.rows.clamp(min=0)])
    return indptr, idx_buf[:cap], dat_buf[:cap]


def operand_device(a: CSR, b: CSR) -> torch.device:
    """The device both operands live on (ValueError if they differ)."""
    if a.device != b.device:
        raise ValueError(f"A is on {a.device} but B is on {b.device}")
    return a.device


def execute_plan(a: CSR, b: CSR, plan: GroupPlan, engine: str = "sort",
                 gather: Gather = "auto", row_chunk: int = 4096,
                 sizing: Sizing = "auto"):
    """Run the group pipeline on the operands' device; returns (C, nnz_C).

    ``sizing="measured"`` reads every chunk's uniqueCounts back in one
    coalesced copy and returns ``nnz`` as an int; ``"planned"`` sizes from
    the plan's Alg. 1 bounds, reads nothing back and returns ``nnz`` as a
    0-d device tensor; ``"auto"`` is planned for fused engines and measured
    otherwise.  On a CUDA device the hash engines need float32 values.
    """
    device = operand_device(a, b)
    if row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1; got {row_chunk}")
    engine = resolve_engine(engine)
    mode = resolve_sizing(sizing, engine, plan)
    gather = resolve_gather(gather, device)
    eng = get_engine(engine)
    # The one read of structure before the dispatch loop: A's row lengths
    # cut the plan into chunks, B's longest row sizes its ELL.
    indptrs = torch.cat([a.indptr, b.indptr]).cpu().numpy().astype(np.int64)
    a_row_nnz = np.diff(indptrs[: a.n_rows + 1])
    kb_cap = int(np.diff(indptrs[a.n_rows + 1:]).max(initial=0)) or 1
    ncol_cap = next_pow2(max(b.n_cols, 1))
    b_ell = csr_to_ell(b, kb_cap)
    items = partition_plan(plan, a_row_nnz, row_chunk)
    rows_all, chunk_rows = _chunk_rows(items, device)
    if mode == "planned":
        runs, cap = _run_planned(a, items, chunk_rows, b_ell.indices,
                                 b_ell.data, gather, eng, ncol_cap, plan,
                                 b.n_cols)
    else:
        runs, nnz, cap = _run_measured(a, items, chunk_rows, b_ell.indices,
                                       b_ell.data, gather, eng, ncol_cap)
    indptr, indices, data = _epilogue(runs, rows_all, a.n_rows, cap,
                                      a.data.dtype, device)
    if mode == "planned":
        nnz = indptr[-1]
    return CSR(indptr, indices, data, (a.n_rows, b.n_cols)), nnz
