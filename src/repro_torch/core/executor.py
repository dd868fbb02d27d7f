"""Plan-compiled SpGEMM executor — the group pipeline behind ``spgemm()``.

Counterpart of ``repro.core.executor``.  The row-grouping phase
(``core.grouping``) produces a ``GroupPlan``; ``partition_plan`` cuts it
into group-chunks, each pinned to a shard, and ``execute_plan`` runs each
chunk's A-row gather → B-row gather → product formation → per-row
accumulation on its shard's device, then reassembles the CSR on the merge
device.  ``mesh=None`` is one shard on the operands' device; a mesh is a
sequence of ``torch.device``s (``launch.sharding``), one a shard, where a
device may repeat.  Under a mesh the operands live on the merge device
(the first shard's), each shard gets A and its placement of B, the
chunks pack into shard-local CSR segments on their own devices, and the
merge device applies one destination-mapped scatter a shard.  Rows are
disjoint across shards and ``a_cap`` is a group-level maximum, so every
row's result is the one ``mesh=None`` gives.

Three pluggable axes:

* **engine** — ``"hash"`` (Algorithms 2/3/5, the linear-probing table),
  ``"sort"`` (the vectorised sort + segment-sum engine) and ``"fused_hash"``
  (the hash engine as one pass per chunk, with no allocate pass);
  ``"auto"`` picks one engine per Table-I bin (the ``AutotuneCache``, or a
  plan's forced ``group_engines``).
* **gather** — how B's rows are fetched for ``b_ell[cols_A]``: ``"xla"`` is
  a plain tensor take, ``"aia"`` the AIA row-gather kernel
  (``kernels.aia_gather``).  ``"auto"`` is ``"aia"`` on a CUDA device and
  ``"xla"`` on the CPU — the paper's Fig. 7 "without AIA" axis is one flag.
* **pipeline** — ``"two_wave"`` or ``"legacy"`` (below).
* **operands** — where B's rows go under a mesh: ``"replicate"`` places
  B's whole ELL on every shard, ``"footprint"`` only the rows a shard's
  chunks read (``place_operand_block``, with a global→local ``remap``
  that the chunk's gather goes through), ``"auto"`` the footprint where it
  is under ``FOOTPRINT_THRESHOLD`` of B's rows on more than one shard.

Three sync structures:

* **measured** (two waves): wave 1 forms every chunk's products and
  uniqueCounts, one coalesced device-to-host read sizes every chunk's
  output at once (``host_sync_count`` 1), wave 2 accumulates.
* **planned**: every output capacity (and every shard's segment) comes
  from the plan's Alg. 1 IP bounds (uniqueCount <= min(IP, n_cols) per
  row), the indptr is built on the merge device, and the lane reads
  nothing back (``host_sync_count`` 0; ``nnz`` comes back as a 0-d device
  tensor).
* **legacy** (``pipeline="legacy"``): one blocking read of the uniqueCounts
  per chunk and the CSR reassembled on the host — the reference lane the
  others are diffed against.

All chunks' row ids go to the device in one copy from pinned memory before
the dispatch loop, and every shape in the loop comes from the host plan, so
the two-wave loop itself never waits for the device.  Before it,
``execute_plan`` reads A's and B's ``indptr`` back once (to cut the plan
into chunks and size B's ELL), as the reference does.

Amortisation across calls:

* ``PlanCache`` — plans keyed on the operands' sparsity patterns.
* ``OperandCache`` — B's ELL buffers and their per-shard placements,
  keyed on B's tensors and their versions, the shard devices and the
  footprints, so repeated calls against one B convert and place it once.
* ``partition_plan_cached`` / the footprint cache — a plan served twice
  keeps its chunks, shards and footprints.
* ``AutotuneCache`` — ``engine="auto"``'s measured per-bin assignments.
* ``execute_plan_batched`` — one plan run for a batch of same-pattern
  operands: keys, sizing, output structure and reassembly offsets are
  computed once per chunk, and only the value streams carry the batch
  axis.  B's batched values are held folded, ``(n_b, batch * kb)``, so one
  row-gather launch a chunk serves B's index plane and every member's
  values.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import weakref
from collections import OrderedDict
from typing import Callable, Dict, List, Literal, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import faults, phases
from repro_torch.core.grouping import GroupPlan, group_rows, support_footprint
from repro_torch.kernels.aia_gather import gather_planes
from repro_torch.launch.sharding import (
    SHARDING_STATS, merge_device, place_operand_block, replicate_to,
    shard_devices)
from repro_torch.sparse.formats import (
    CSR, ELL, csr_to_ell, ell_values_folded)

Gather = Literal["auto", "xla", "aia"]
Pipeline = Literal["two_wave", "legacy"]
Sizing = Literal["auto", "planned", "measured"]
Operands = Literal["auto", "footprint", "replicate"]
OnBudget = Literal["error", "stream"]
Schedule = Literal["grouped", "natural"]

# Rows per chunk are padded to a multiple of this (-1 = padding row).
ROW_QUANTUM = 8


def next_pow2(x: int) -> int:
    """Smallest power of two >= ``x`` (and >= 1)."""
    return 1 << int(np.ceil(np.log2(max(int(x), 1))))


# A shard whose B-row footprint covers at least this share of B's rows
# keeps the full replica under operands="auto".
FOOTPRINT_THRESHOLD = 0.7


def resolve_operands(operands: Operands) -> str:
    """Validate ``operands=``: ``"auto"`` (footprint blocks on shards whose
    footprint is under ``FOOTPRINT_THRESHOLD`` of B's rows, on more than
    one shard; full replicas elsewhere), ``"footprint"`` (blocks on every
    shard, one included) or ``"replicate"`` (B's whole ELL everywhere).
    All three give the same result bit for bit."""
    if operands not in ("auto", "footprint", "replicate"):
        raise ValueError(
            f"unknown operands policy {operands!r}; valid choices: "
            "'auto', 'footprint', 'replicate'")
    return operands


def mesh_devices(mesh, a: CSR, b: CSR) -> list:
    """The shards' devices for a call on ``(a, b)``: ``[a.device]`` for
    ``mesh=None``, else the mesh's, whose first (the merge device) must
    hold both operands."""
    if mesh is None:
        return [operand_device(a, b)]
    devices = shard_devices(mesh)
    merge = merge_device(devices)
    for name, m in (("A", a), ("B", b)):
        if m.device != merge:
            raise ValueError(
                f"{name} is on {m.device} but the mesh's merge device (its "
                f"first) is {merge}; place the operands there")
    return devices


# ---------------------------------------------------------------------------
# Engine registry — hash, sort and fused_hash behind one interface
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Engine:
    """One allocation/accumulation engine (paper phases 2 + 3).

    ``allocate(keys, table_cap)`` → per-row uniqueCount (Algorithms 2/3).
    ``accumulate(keys, vals, table_cap, out_cap)`` → (cols, vals, counts)
    with rows column-sorted and trimmed/padded to ``out_cap`` (Algorithm 5).
    ``accumulate`` also takes a batch ``(B, R, L)`` of value streams over
    the one key stream and returns (B, R, out_cap) values.  ``fused=True``
    marks a single-pass engine, which ``sizing="auto"`` runs in the planned
    lane.
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
    """Sorted names of every registered engine (the ``engine=`` choices
    besides ``"auto"``)."""
    return tuple(sorted(ENGINES))


AUTO_ENGINE = "auto"


def resolve_engine(engine: Optional[str] = None,
                   method: Optional[str] = None) -> str:
    """Validate ``engine=``: a registered name or ``"auto"`` (per-bin
    dispatch); ``None`` falls back to ``method or "sort"`` (``method`` is
    the façade's legacy alias)."""
    if engine is None:
        engine = method or "sort"
    elif method is not None and method != engine:
        raise ValueError(
            f"conflicting method={method!r} (legacy alias) and "
            f"engine={engine!r}")
    if engine != AUTO_ENGINE and engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r}; valid choices: "
            f"{', '.join(sorted(ENGINES))}, or 'auto' (per-bin adaptive "
            "dispatch)")
    return engine


def static_bin_engines(device) -> Tuple[str, ...]:
    """The seed of ``engine="auto"`` for every Table-I bin, by the
    operands' device type: ``"sort"`` on the CPU (as the reference seeds
    off-TPU) and ``"fused_hash"`` on CUDA.  The CUDA seed is the port's
    choice: on the H100 the fused lane ran ahead of the sort lane on both
    Table-II self-products (device time RoadTX 75.6 vs 145.0 ms,
    p2p-Gnutella04 7.47 vs 65.4 ms; ``PERF.md`` §5).  It is only the
    starting point: the ``AutotuneCache`` measures each bin's candidates."""
    name = "fused_hash" if torch.device(device).type == "cuda" else "sort"
    return (name,) * 4


def _sort_accumulate(keys, vals, table_cap: int, out_cap: int):
    return phases.accumulate_sort(keys, vals, out_cap)


register_engine(Engine("hash", phases.allocate_hash, phases.fused_hash_sorted))
register_engine(Engine("sort", lambda keys, cap: phases.allocate_sort(keys),
                       _sort_accumulate))
# The paper's Alg. 2/3/5 as one pass over A's row: gather → products →
# linear-probe insert, with no allocate pass.  The allocate/accumulate pair
# serves sizing="measured" and pipeline="legacy".
register_engine(Engine("fused_hash", phases.allocate_hash,
                       phases.fused_hash_sorted, fused=True))


# ---------------------------------------------------------------------------
# Gather backends — how b_ell[cols_A] is served
# ---------------------------------------------------------------------------

def check_gather(gather: Gather) -> str:
    """Validate a ``gather=`` name without resolving ``"auto"``."""
    if gather not in ("auto", "xla", "aia"):
        raise ValueError(f"unknown gather backend {gather!r}")
    return gather


def resolve_gather(gather: Gather, device) -> str:
    """``"auto"`` → the AIA kernel on a CUDA device, a plain take on the CPU."""
    if check_gather(gather) == "auto":
        return "aia" if torch.device(device).type == "cuda" else "xla"
    return gather


def _gather_b_xla(b_idx, b_val, cols_a):
    safe = cols_a.clamp(0, b_idx.shape[0] - 1).long()
    return b_idx[safe], b_val[safe]


def _gather_b_aia(b_idx, b_val, cols_a):
    """B-row gather as the paper's AIA stream: ``cols_a`` flattened into one
    index stream, served by one row-gather launch for both planes (on the
    batched lane the value plane is the folded ``(n_b, batch * kb)``)."""
    r, a_cap = cols_a.shape
    bi, bv = gather_planes((b_idx, b_val), cols_a.reshape(-1))
    return (bi.reshape(r, a_cap, b_idx.shape[1]),
            bv.reshape(r, a_cap, b_val.shape[1]))


GATHERS: Dict[str, Callable] = {"xla": _gather_b_xla, "aia": _gather_b_aia}


def _gather_b_xla_batched(b_idx, b_val_b, cols_a):
    """One structural gather, the value sets ``b_val_b`` (B, n_b, kb)
    gathered alike: (bi (R, a_cap, kb), bv (B, R, a_cap, kb))."""
    safe = cols_a.clamp(0, b_idx.shape[0] - 1).long()
    return b_idx[safe], b_val_b[:, safe]


def _gather_b_aia_batched(b_idx, b_val_b, cols_a):
    """The batched AIA gather: the batch folds into the row payload
    (``(n_b, B * kb)``), so one row-gather launch serves every member."""
    batch, nb, kb = b_val_b.shape
    folded = b_val_b.permute(1, 0, 2).reshape(nb, batch * kb)
    bi, bv = _gather_b_aia(b_idx, folded.contiguous(), cols_a)
    r, a_cap = cols_a.shape
    return bi, bv.reshape(r, a_cap, batch, kb).permute(2, 0, 1, 3)


# the reference's batched gathers by name, value sets on a leading axis (the
# port's batched lane calls ``GATHERS`` on the folded plane itself)
BATCHED_GATHERS: Dict[str, Callable] = {
    "xla": _gather_b_xla_batched, "aia": _gather_b_aia_batched,
}


# ---------------------------------------------------------------------------
# Output sizing — measured (uniqueCount read) vs planned (Alg. 1 bounds)
# ---------------------------------------------------------------------------

def _engines_in_use(engine: str, plan=None,
                    group_engines: Optional[Sequence[str]] = None
                    ) -> Tuple[str, ...]:
    """The engines a call dispatches: the per-bin assignment restricted to
    non-empty groups when one is set, else the uniform ``engine=``."""
    if group_engines is None:
        return (engine,)
    sizes = getattr(plan, "group_sizes", None)
    used = tuple(e for g, e in enumerate(group_engines)
                 if sizes is None or sizes[g] > 0)
    return used or (group_engines[0],)


def resolve_sizing(sizing: Sizing, engine: str, plan=None,
                   group_engines: Optional[Sequence[str]] = None) -> str:
    """``"auto"`` → ``"planned"`` when every engine the call dispatches is
    fused (and the plan carries ``row_ip``), ``"measured"`` otherwise;
    ``"planned"`` needs a plan that carries ``row_ip``."""
    if sizing not in ("auto", "planned", "measured"):
        raise ValueError(f"unknown sizing {sizing!r}")
    has_ip = getattr(plan, "row_ip", None) is not None
    if sizing == "auto":
        engines = _engines_in_use(engine, plan, group_engines)
        all_fused = all(get_engine(e).fused for e in engines)
        return "planned" if all_fused and has_ip else "measured"
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
# Streamed-lane knobs and the device budget
# ---------------------------------------------------------------------------

# Rows per A row-block tile, and how many staged tiles may be resident on
# the device at once (1 = no overlap, 2 = double buffering: tile k+1's
# host-to-device copy overlaps tile k's compute).
DEFAULT_TILE_ROWS = 4096
DEFAULT_PREFETCH = 2


def _positive_int(value, what: str, default: int) -> int:
    if value is None:
        return default
    if isinstance(value, bool) or not isinstance(value, (int, np.integer)):
        raise ValueError(f"{what} must be a positive int (or None for the "
                         f"default {default}); got {value!r}")
    if int(value) < 1:
        raise ValueError(f"{what} must be >= 1; got {int(value)}")
    return int(value)


def resolve_tile_rows(tile_rows) -> int:
    """Validate ``tile_rows=`` (rows per tile; ``None`` is
    ``DEFAULT_TILE_ROWS``).  ``tile_rows >= n_rows(A)`` is one tile."""
    return _positive_int(tile_rows, "tile_rows", DEFAULT_TILE_ROWS)


def resolve_prefetch(prefetch) -> int:
    """Validate ``prefetch=`` (staged tiles in flight; ``None`` is
    ``DEFAULT_PREFETCH``)."""
    return _positive_int(prefetch, "prefetch", DEFAULT_PREFETCH)


# Optional cap (bytes) on the estimated working set of one execute_plan
# call; None disables the check.
_DEVICE_BUDGET = {"bytes": None}


class DeviceBudgetExceeded(RuntimeError):
    """A plan's estimated working set exceeds ``set_device_budget``.

    Raised by ``execute_plan`` before anything is allocated; the streamed
    lane runs the same check per tile, so a product whose whole plan
    exceeds the budget completes there with small enough tiles.
    """


def set_device_budget(nbytes: Optional[int]) -> None:
    """Set (or clear, with ``None``) the working-set budget in bytes.  It
    is a model of the device's memory (``estimated_device_bytes``), not a
    reading of it."""
    _DEVICE_BUDGET["bytes"] = None if nbytes is None else int(nbytes)


def device_budget() -> Optional[int]:
    """The configured working-set budget in bytes (None = off)."""
    return _DEVICE_BUDGET["bytes"]


def estimated_device_bytes(plan: GroupPlan, itemsize: int) -> int:
    """The reference's model of a plan's working set: every intermediate
    product held as an int32 key and one value, ``total_ip × (4 +
    itemsize)`` bytes.  Operands and the output are left out."""
    return int(plan.total_ip) * (4 + int(itemsize))


def resolve_on_budget(on_budget: OnBudget) -> str:
    """Validate ``on_budget=``: ``"error"`` raises ``DeviceBudgetExceeded``
    for an over-budget plan, ``"stream"`` re-routes the call through the
    streamed lane (bit-identical).  Inert with no budget set."""
    if on_budget not in ("error", "stream"):
        raise ValueError(
            f"unknown on_budget policy {on_budget!r}; valid choices: "
            "'error', 'stream'")
    return on_budget


def derive_degradation_tile_rows(plan: GroupPlan, n_rows: int,
                                 itemsize: int) -> int:
    """The largest power-of-two ``tile_rows`` whose worst row-block tile
    fits the budget under ``estimated_device_bytes``'s model (the fewest
    tiles).  Raises ``DeviceBudgetExceeded`` when one row alone exceeds
    it, ``ValueError`` with no budget set."""
    budget = _DEVICE_BUDGET["bytes"]
    if budget is None:
        raise ValueError(
            "derive_degradation_tile_rows needs a device budget; call "
            "set_device_budget first")
    row_bytes = np.asarray(plan.row_ip, dtype=np.int64) * (4 + int(itemsize))
    if row_bytes.size != n_rows:
        raise ValueError(
            f"plan has {row_bytes.size} row_ip entries but n_rows={n_rows}")
    worst_row = int(row_bytes.max()) if row_bytes.size else 0
    if worst_row > budget:
        raise DeviceBudgetExceeded(
            f"a single row's intermediate products need ~{worst_row} device "
            f"bytes but the configured device budget is {budget}; no "
            "tile_rows can degrade this call: raise the budget")
    prefix = np.concatenate(([0], np.cumsum(row_bytes)))

    def worst_tile(t: int) -> int:
        starts = np.arange(0, n_rows, t)
        ends = np.minimum(starts + t, n_rows)
        return int((prefix[ends] - prefix[starts]).max()) if starts.size else 0

    t = next_pow2(max(n_rows, 1))
    while t > 1 and worst_tile(t) > budget:
        t //= 2
    return t


def _check_budget(plan: GroupPlan, dtype: torch.dtype) -> None:
    budget = _DEVICE_BUDGET["bytes"]
    if budget is None:
        return
    need = estimated_device_bytes(plan, dtype.itemsize)
    if need > budget:
        raise DeviceBudgetExceeded(
            f"plan needs ~{need} device bytes for its intermediate products "
            f"(total IP {plan.total_ip}) but the configured device budget "
            f"is {budget}; stream the call instead: spgemm_streamed with "
            "tile_rows small enough that every tile's estimate fits")


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_PLAN_STATS = {"plan_hits": 0, "plan_misses": 0}
# One increment per deliberate blocking read of device results inside the
# pipeline: one per measured call, none per planned call, one per chunk on
# the legacy lane.
_SYNC_STATS = {"host_sync_count": 0}
# OperandCache lookups, and what its builds placed: bytes of B's blocks
# (indices, values, remap) on the shards, B rows placed summed over the
# shards, and the rows full replication would have placed (n_shards x
# n_rows(B)).
_OPERAND_STATS = {"operand_hits": 0, "operand_misses": 0,
                  "operand_bytes_placed": 0, "operand_rows_footprint": 0,
                  "operand_rows_total": 0}
_AUTOTUNE_STATS = {"autotune_hits": 0, "autotune_misses": 0}
# The streamed lane: tiles dispatched, bytes of tile operands staged host
# to device, and tiles staged while an earlier tile's compute was in flight.
_STREAM_STATS = {"tiles_streamed": 0, "tile_bytes_h2d": 0,
                 "prefetch_overlap_hits": 0}
# Recovery events, 0 on every clean path: planned calls whose overflow flag
# tripped and were re-run at measured capacity, and calls that
# on_budget="stream" re-routed through the streamed lane.
_RESILIENCE_STATS = {"capacity_retries": 0, "budget_degradations": 0}


def cache_stats() -> Dict[str, int]:
    """Executor counters: ``plan_hits``/``plan_misses`` (``PlanCache``
    lookups), ``host_sync_count`` (blocking reads of device results inside
    the pipeline), ``operand_hits``/``operand_misses`` (``OperandCache``
    lookups: a hit converts and places nothing), ``operand_bytes_placed``/
    ``operand_rows_footprint``/``operand_rows_total`` (what the builds
    placed on the shards: bytes, B rows, and the rows full replication
    would have placed), ``autotune_hits``/
    ``autotune_misses`` (``engine="auto"`` lookups: a hit measures
    nothing), ``tiles_streamed``/``tile_bytes_h2d``/
    ``prefetch_overlap_hits`` (the streamed lane; the last is the
    reference's count of tiles staged while an earlier tile was
    dispatched, 0 at ``prefetch=1``) and ``capacity_retries``/
    ``budget_degradations`` (recovery events), and
    ``sharding_fallbacks`` (``launch.sharding.constrain`` calls on a plain
    tensor outside a mesh).  Every cache instance folds into these."""
    return {**_PLAN_STATS, **_SYNC_STATS, **_OPERAND_STATS,
            **_AUTOTUNE_STATS, **_STREAM_STATS, **_RESILIENCE_STATS,
            **SHARDING_STATS}


def clear_program_cache() -> None:
    """Zero the ``cache_stats()`` counters and drop the module-level
    operand, autotune, partition and footprint caches."""
    _PARTITION_CACHE.clear()
    _FOOTPRINT_CACHE.clear()
    _OPERAND_CACHE.clear()
    _AUTOTUNE_CACHE.clear()
    for stats in (_PLAN_STATS, _SYNC_STATS, _OPERAND_STATS, _AUTOTUNE_STATS,
                  _STREAM_STATS, _RESILIENCE_STATS, SHARDING_STATS):
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

    def plan_for(self, a: CSR, b: CSR,
                 supplier: Optional[Callable[[], GroupPlan]] = None
                 ) -> GroupPlan:
        """Serve (hit) or build (miss) the plan for ``(a, b)``'s pattern.
        ``supplier`` fills a miss instead of ``group_rows`` (the serving
        layer accounts a plan another tenant built against this cache's
        quota); it still counts as a miss."""
        key = pattern_fingerprint(a, b)
        plan = self._entries.get(key)
        if plan is None:
            self.misses += 1
            _PLAN_STATS["plan_misses"] += 1
            plan = group_rows(a, b) if supplier is None else supplier()
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
# Operand cache — B's ELL buffers shared across calls
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _OperandEntry:
    """B's ELL conversion and its per-shard placements.  ``source`` pins
    B's three tensors so their ``id()``s (part of the key) cannot be reused
    while the entry lives.  Each shard holds ``(b_idx, b_val, remap)``: the
    whole ELL with ``remap=None``, or its footprint block with the block's
    global→local row map; ``footprints`` keeps each shard's rows (None =
    whole ELL) so that the batched lane cuts its value planes alike."""

    source: tuple
    b_ell: ELL
    shards: List[tuple]
    footprints: Optional[List[Optional[np.ndarray]]] = None


def _footprint_fingerprint(footprints) -> Optional[str]:
    """Digest of the shards' row selections (None = full replicas
    everywhere): the key part that keeps blocks built for one partition
    from serving another."""
    if footprints is None:
        return None
    h = hashlib.blake2b(digest_size=8)
    for fp in footprints:
        if fp is None:
            h.update(b"\xff")
        else:
            fp = np.asarray(fp, np.int64)
            h.update(np.int64(fp.size).tobytes())
            h.update(fp.tobytes())
    return h.hexdigest()


class OperandCache:
    """(B's tensors and versions, ``kb_cap``, devices, footprints)-keyed
    cache of B's ELL buffers and their per-shard placements (LRU, bounded).

    Iterative and batched workloads multiply against the same B object call
    after call; a hit serves its ELL and placements with no conversion and
    no copy.  A torch tensor is mutable, so the key holds each of B's three
    tensors' identity *and* its ``_version``, which every in-place PyTorch
    operation on the tensor or a view of it bumps: an edit of ``b.data``
    between calls misses and rebuilds instead of serving stale values.
    (Writes that bypass autograd's version counter — through a NumPy view
    of the storage or ``tensor.data`` — are not seen.)  The shard devices
    and a digest of the footprints are in the key too, so blocks built for
    one mesh or partition never serve another.  Lookups fold into
    ``cache_stats()`` as ``operand_hits``/``operand_misses``; every build
    adds what it placed to ``operand_bytes_placed``/
    ``operand_rows_footprint``/``operand_rows_total``, counted as the
    reference counts them (a shard on B's own device counts its placement
    though no copy is made).
    """

    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._entries: "OrderedDict[tuple, _OperandEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every cached entry (does not touch the counters)."""
        self._entries.clear()

    @staticmethod
    def _build(b: CSR, kb_cap: int, devices, footprints) -> _OperandEntry:
        b_ell = csr_to_ell(b, kb_cap)
        n_rows = int(b_ell.indices.shape[0])
        shards = []
        for sh, dev in enumerate(devices):
            fp = None if footprints is None else footprints[sh]
            if fp is None:
                shard = (replicate_to(b_ell.indices, dev),
                         replicate_to(b_ell.data, dev), None)
                rows_placed = n_rows
            else:
                shard = place_operand_block(b_ell.indices, b_ell.data, fp,
                                            dev)
                rows_placed = len(fp)
            _OPERAND_STATS["operand_bytes_placed"] += sum(
                t.numel() * t.element_size() for t in shard if t is not None)
            _OPERAND_STATS["operand_rows_footprint"] += rows_placed
            _OPERAND_STATS["operand_rows_total"] += n_rows
            shards.append(shard)
        return _OperandEntry((b.indptr, b.indices, b.data), b_ell, shards,
                             None if footprints is None else list(footprints))

    def b_operands(self, b: CSR, kb_cap: int, devices=None,
                   footprints=None) -> _OperandEntry:
        """Serve (hit) or build and place (miss) B's ELL at row capacity
        ``kb_cap`` on ``devices`` (default: B's own device), each shard's
        ``footprints`` entry choosing its block (None = the whole ELL)."""
        devices = [b.device] if devices is None else list(devices)
        source = (b.indptr, b.indices, b.data)
        key = tuple((id(t), t._version) for t in source) \
            + (int(kb_cap), str(b.device), tuple(str(d) for d in devices),
               _footprint_fingerprint(footprints))
        entry = self._entries.get(key)
        if entry is None:
            _OPERAND_STATS["operand_misses"] += 1
            entry = self._build(b, kb_cap, devices, footprints)
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        else:
            _OPERAND_STATS["operand_hits"] += 1
            self._entries.move_to_end(key)
        return entry


_OPERAND_CACHE = OperandCache()


# ---------------------------------------------------------------------------
# Autotune cache — measured per-bin engine assignment for engine="auto"
# ---------------------------------------------------------------------------

def autotune_key(a: CSR, b: CSR, plan: GroupPlan) -> tuple:
    """AutotuneCache key: the operands' pattern fingerprint, the device
    type (the winning engine depends on it) and the plan's bin signature
    (group sizes and table capacities)."""
    return (pattern_fingerprint(a, b), a.device.type,
            tuple(plan.group_sizes), tuple(plan.table_capacities))


@dataclasses.dataclass
class _AutotuneEntry:
    """Measured per-bin state for one key: each non-empty group's
    candidates still to measure (seed first), the measured µs per (group,
    engine), and the current pick (argmin where measured, else the seed)."""

    seed: Tuple[str, ...]
    pending: Dict[int, List[str]]
    timings: Dict[int, Dict[str, float]]
    assignment: Tuple[str, ...]

    @property
    def converged(self) -> bool:
        return not any(self.pending.values())

    def _recompute(self) -> None:
        picks = []
        for g in range(4):
            t = self.timings.get(g)
            picks.append(min(t, key=t.get) if t else self.seed[g])
        self.assignment = tuple(picks)


class AutotuneCache:
    """LRU cache of measured per-bin engine assignments (``engine="auto"``).

    The first sighting of a key seeds every non-empty Table-I group with
    ``static_bin_engines`` for the key's device type and queues the other
    registered engines (or ``candidates``); each later ``engine="auto"``
    call measures **one** candidate per bin until the queue drains, after
    which every call is a pure hit with no measurement.  Lookups fold into
    ``cache_stats()`` as ``autotune_hits``/``autotune_misses``.
    """

    def __init__(self, max_entries: int = 64,
                 candidates: Optional[Sequence[str]] = None):
        self.max_entries = max_entries
        self.candidates = tuple(candidates) if candidates else None
        self._entries: "OrderedDict[tuple, _AutotuneEntry]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        """Drop every cached assignment (does not touch the counters)."""
        self._entries.clear()

    def _candidate_order(self, seed_engine: str) -> List[str]:
        cands = self.candidates or available_engines()
        return [seed_engine] + [e for e in sorted(cands) if e != seed_engine]

    def _entry_for(self, key: tuple, plan: GroupPlan) -> _AutotuneEntry:
        entry = self._entries.get(key)
        if entry is None:
            seed = static_bin_engines(key[1])
            entry = _AutotuneEntry(
                seed=seed,
                pending={g: self._candidate_order(seed[g])
                         for g in range(4) if plan.group_sizes[g] > 0},
                timings={},
                assignment=seed,
            )
            self._entries[key] = entry
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
        else:
            self._entries.move_to_end(key)
        return entry

    def converged(self, key: tuple) -> bool:
        """True when ``key``'s assignment has no candidate left to measure."""
        entry = self._entries.get(key)
        return entry is not None and entry.converged

    def assignment_for(self, key: tuple, plan: GroupPlan,
                       measure: Callable[[int, str], float]
                       ) -> Tuple[str, ...]:
        """Serve (hit) or refine (miss + one measurement round) the per-bin
        assignment; ``measure(group, engine)`` returns µs."""
        entry = self._entry_for(key, plan)
        if entry.converged:
            self.hits += 1
            _AUTOTUNE_STATS["autotune_hits"] += 1
            return entry.assignment
        self.misses += 1
        _AUTOTUNE_STATS["autotune_misses"] += 1
        for g, cands in entry.pending.items():
            if cands:
                eng = cands.pop(0)
                entry.timings.setdefault(g, {})[eng] = float(measure(g, eng))
        entry._recompute()
        return entry.assignment

    def record(self, key: tuple, plan: GroupPlan, group: int, engine: str,
               us: float) -> None:
        """Fold one externally measured timing in."""
        entry = self._entry_for(key, plan)
        pend = entry.pending.get(group)
        if pend is not None and engine in pend:
            pend.remove(engine)
        entry.timings.setdefault(group, {})[engine] = float(us)
        entry._recompute()

    def stats(self) -> Dict[str, int]:
        """Per-instance ``hits``, ``misses`` and ``entries``."""
        return {"hits": self.hits, "misses": self.misses,
                "entries": len(self._entries)}

    def summary(self) -> List[Dict]:
        """JSON-friendly view of every entry: device type, bin signature,
        measured timings and the chosen assignment."""
        return [
            {
                "device": key[1],
                "group_sizes": list(key[2]),
                "assignment": list(e.assignment),
                "converged": e.converged,
                "timings_us": {str(g): dict(t)
                               for g, t in sorted(e.timings.items())},
            }
            for key, e in self._entries.items()
        ]


_AUTOTUNE_CACHE = AutotuneCache()


def default_autotune_cache() -> AutotuneCache:
    """The module-level cache ``engine="auto"`` uses when no ``autotune=``
    cache is passed (cleared by ``clear_program_cache``)."""
    return _AUTOTUNE_CACHE


def bin_subplan(plan: GroupPlan, group: int) -> GroupPlan:
    """A plan restricted to one Table-I group (every other bin empty):
    executing it runs exactly that bin's chunks (other rows come back
    empty), so its time isolates the bin's cost under one engine."""
    rows = np.asarray(plan.rows_of_group(group), np.int32)
    sizes = [0, 0, 0, 0]
    sizes[group] = len(rows)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return GroupPlan(
        map_rows=rows,
        group_id=plan.group_id,
        group_offsets=offsets,
        group_sizes=tuple(sizes),
        group_sizes_padded=tuple(sizes),
        table_capacities=plan.table_capacities,
        max_ip=plan.max_ip,
        total_ip=plan.total_ip,
        row_ip=plan.row_ip,
    )


def _sync(devices) -> None:
    """Wait for every CUDA device among ``devices``."""
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def measure_group_engine(
    a: CSR,
    b: CSR,
    plan: GroupPlan,
    group: int,
    engine: str,
    gather: Gather = "auto",
    row_chunk: int = 4096,
    mesh=None,
    pipeline: Pipeline = "two_wave",
    reps: int = 2,
    warmup: int = 1,
    timer: Callable[[], float] = None,
) -> float:
    """Wall time (µs) of one Table-I bin under one concrete engine: the
    bin-restricted subplan through ``execute_plan`` (on ``mesh``'s shards),
    ``warmup`` untimed passes, then the min over ``reps`` timed passes,
    each ending in a synchronise of every shard's device.  ``timer`` is
    injectable."""
    timer = timer or time.perf_counter
    get_engine(engine)  # concrete engines only
    sub = bin_subplan(plan, group)
    devices = mesh_devices(mesh, a, b)

    def run():
        execute_plan(a, b, sub, engine=engine, gather=gather,
                     row_chunk=row_chunk, mesh=mesh, pipeline=pipeline)
        _sync(devices)

    for _ in range(warmup):
        run()
    best = float("inf")
    for _ in range(reps):
        t0 = timer()
        run()
        best = min(best, timer() - t0)
    return best * 1e6


def _autotune_assignment(a, b, plan, gather, row_chunk, mesh, pipeline,
                         cache: Optional[AutotuneCache]) -> Tuple[str, ...]:
    """``engine="auto"``'s per-bin assignment through ``cache`` (the module
    cache when None), measured on ``mesh``'s shards."""
    cache = _AUTOTUNE_CACHE if cache is None else cache

    def measure(g, eng):
        return measure_group_engine(a, b, plan, g, eng, gather=gather,
                                    row_chunk=row_chunk, mesh=mesh,
                                    pipeline=pipeline)

    return cache.assignment_for(autotune_key(a, b, plan), plan, measure)


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
    """One (group, row-chunk) dispatch, pinned to one shard."""

    group: int
    shard: int
    rows: np.ndarray  # (R,) original row ids of this chunk
    a_cap: int        # exact max nnz(A row) over the *group*
    table_cap: int    # Table-I hash-table capacity of the group
    engine: Optional[str] = None  # per-bin engine (None = caller's engine=)


def partition_plan(plan: GroupPlan, a_row_nnz: np.ndarray, row_chunk: int,
                   n_shards: int = 1,
                   group_engines: Optional[Sequence[str]] = None
                   ) -> List[WorkItem]:
    """Split a ``GroupPlan`` into group-chunks of at most ``row_chunk``
    rows, dealt to the shards round-robin with a cursor that carries across
    groups (every shard gets a mix of the Table-I bins).  With more than
    one shard a group's chunk shrinks to ``ceil(rows / n_shards)``
    (quantised to ``ROW_QUANTUM``) so that every shard gets work from every
    group it can.  ``a_cap`` is a group-level maximum, so a row's result
    never depends on the chunking or the shard count.  ``group_engines``
    stamps each chunk with its bin's engine."""
    items: List[WorkItem] = []
    cursor = 0
    for g in range(4):
        rows = plan.rows_of_group(g)
        if len(rows) == 0:
            continue
        a_cap = max(int(a_row_nnz[rows].max(initial=0)), 1)
        chunk = row_chunk
        if n_shards > 1:
            per_shard = _pad_rows(int(np.ceil(len(rows) / n_shards)))
            chunk = max(min(row_chunk, per_shard), ROW_QUANTUM)
        for lo in range(0, len(rows), chunk):
            items.append(WorkItem(
                g, cursor % n_shards, np.asarray(rows[lo: lo + chunk]),
                a_cap, plan.table_capacities[g],
                None if group_engines is None else group_engines[g]))
            cursor += 1
    return items


_PARTITION_CACHE: Dict[tuple, List[WorkItem]] = {}


def partition_plan_cached(plan: GroupPlan, a_row_nnz: np.ndarray,
                          row_chunk: int, n_shards: int = 1,
                          group_engines: Optional[Sequence[str]] = None
                          ) -> List[WorkItem]:
    """``partition_plan`` memoised on the plan's identity: a plan served
    twice (a ``PlanCache`` hit, a reused ``plan=``) keeps its chunks and
    their shards.  A ``weakref.finalize`` on the plan drops the entry when
    the plan dies, so a reused ``id()`` never aliases."""
    key = (id(plan), int(row_chunk), int(n_shards),
           None if group_engines is None else tuple(group_engines))
    items = _PARTITION_CACHE.get(key)
    if items is None:
        items = partition_plan(plan, a_row_nnz, row_chunk, n_shards,
                               group_engines)
        _PARTITION_CACHE[key] = items
        weakref.finalize(plan, _PARTITION_CACHE.pop, key, None)
    return items


def shard_footprints(items: Sequence[WorkItem], a_indptr: np.ndarray,
                     a_indices: np.ndarray,
                     n_shards: int) -> List[np.ndarray]:
    """Each shard's B-row footprint: the union of A's column ids over the
    rows of its chunks (``grouping.support_footprint``).  A shard with no
    work (or only empty rows) gets ``[0]``, so that its block keeps a valid
    shape; nothing gathers from it."""
    by_shard: List[list] = [[] for _ in range(n_shards)]
    for item in items:
        by_shard[item.shard].append(item.rows)
    out = []
    for rows in by_shard:
        fp = support_footprint(
            a_indptr, a_indices,
            np.concatenate(rows) if rows else np.empty(0, np.int64))
        out.append(fp if fp.size else np.zeros(1, np.int64))
    return out


_FOOTPRINT_CACHE: Dict[tuple, List[np.ndarray]] = {}


def _shard_footprints_cached(plan: GroupPlan, items: Sequence[WorkItem],
                             a: CSR, a_indptr: np.ndarray, row_chunk: int,
                             n_shards: int, group_engines) -> List[np.ndarray]:
    """``shard_footprints`` memoised like the partition: a reused plan
    reads A's indices back and derives its footprints once."""
    key = (id(plan), int(row_chunk), int(n_shards),
           None if group_engines is None else tuple(group_engines))
    fps = _FOOTPRINT_CACHE.get(key)
    if fps is None:
        nnz = int(a_indptr[-1])
        fps = shard_footprints(items, a_indptr,
                               a.indices[:nnz].cpu().numpy(), n_shards)
        _FOOTPRINT_CACHE[key] = fps
        weakref.finalize(plan, _FOOTPRINT_CACHE.pop, key, None)
    return fps


def _resolve_footprints(operands: str, plan, items, a, a_indptr, row_chunk,
                        n_shards, group_engines, n_b: int):
    """The ``operands=`` policy: None (full replicas everywhere), or one
    entry a shard, its footprint rows or None for that shard's replica.
    ``"auto"`` engages on more than one shard only (one shard's footprint
    is the whole support: nothing to save)."""
    if operands == "replicate" or (operands == "auto" and n_shards == 1):
        return None
    raw = _shard_footprints_cached(plan, items, a, a_indptr, row_chunk,
                                   n_shards, group_engines)
    limit = FOOTPRINT_THRESHOLD * max(n_b, 1)
    fps = [fp if operands == "footprint" or len(fp) < limit else None
           for fp in raw]
    return None if all(fp is None for fp in fps) else fps


def _shard_a_operands(a_tensors: Sequence[torch.Tensor],
                      devices) -> List[tuple]:
    """A's tensors on every shard's device (the identity where a shard is
    on A's own device).  A is placed per call; B's placements ride the
    ``OperandCache``."""
    return [tuple(replicate_to(x, dev) for x in a_tensors)
            for dev in devices]


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


def _chunk_rows(items: List[WorkItem], devices
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Every chunk's row ids, padded to ``ROW_QUANTUM`` with -1: the whole
    stream on the merge device in one copy, and each chunk's view on its
    shard's device (a shard on another device gets its chunks' rows in one
    copy of its own)."""
    parts = []
    for item in items:
        pad = _pad_rows(len(item.rows)) - len(item.rows)
        parts.append(np.concatenate([item.rows.astype(np.int32),
                                     np.full(pad, -1, np.int32)]))
    merge = merge_device(devices)
    if not parts:
        return torch.zeros(0, dtype=torch.int32, device=merge), []
    rows_all = _upload(np.concatenate(parts), merge)
    views = list(torch.split(rows_all, [len(p) for p in parts]))
    for dev in set(devices) - {merge}:
        mine = [i for i, item in enumerate(items)
                if devices[item.shard] == dev]
        if mine:
            up = _upload(np.concatenate([parts[i] for i in mine]), dev)
            for i, v in zip(mine, torch.split(up, [len(parts[i])
                                                   for i in mine])):
                views[i] = v
    return rows_all, views


def _coalesced_sync(counts: List[torch.Tensor], merge) -> List[np.ndarray]:
    """The measured lane's one blocking read: every chunk's uniqueCounts,
    already queued on their shards, gathered on the merge device and read
    back in a single device-to-host copy."""
    if not counts:
        return []
    _SYNC_STATS["host_sync_count"] += 1
    host = torch.cat([replicate_to(c, merge) for c in counts]).cpu().numpy()
    return np.split(host, np.cumsum([len(c) for c in counts])[:-1])


@dataclasses.dataclass(frozen=True)
class _Operands:
    """One shard's operands on its device: A's structure with one value set
    ``(cap,)`` or a batch ``(B, cap)``; B's ELL index plane and its value
    plane, ``(n_b, kb)`` or the batch folded ``(n_b, B * kb)`` (a
    footprint block's rows when ``remap`` is set: B's global row ids to
    the block's)."""

    a_indptr: torch.Tensor
    a_indices: torch.Tensor
    a_data: torch.Tensor
    b_idx: torch.Tensor
    b_val: torch.Tensor
    remap: Optional[torch.Tensor] = None
    batch: Optional[int] = None


@dataclasses.dataclass
class _Setup:
    """A call's resolved knobs, its shards and its chunks."""

    engine: str
    mode: str  # "measured", "planned" or "legacy"
    gather: str
    kb_cap: int
    ncol_cap: int
    devices: list
    footprints: Optional[list]
    items: List[WorkItem]
    rows_all: torch.Tensor
    chunk_rows: List[torch.Tensor]

    @property
    def merge(self) -> torch.device:
        return self.devices[0]


def _setup(a, b, plan, engine, gather, row_chunk, mesh, pipeline, sizing,
           autotune, operands) -> _Setup:
    """Validate and resolve the knobs (``engine="auto"`` through the plan's
    forced ``group_engines`` or the autotune cache), then read A's and B's
    ``indptr`` back once to cut the plan into chunks, deal them to the
    shards and size B's ELL; resolve each shard's placement of B."""
    devices = mesh_devices(mesh, a, b)
    operands = resolve_operands(operands)
    if row_chunk < 1:
        raise ValueError(f"row_chunk must be >= 1; got {row_chunk}")
    if pipeline not in ("two_wave", "legacy"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    engine = resolve_engine(engine)
    group_engines = plan.group_engines
    if group_engines is None and engine == AUTO_ENGINE:
        group_engines = _autotune_assignment(a, b, plan, gather, row_chunk,
                                             mesh, pipeline, autotune)
    for name in group_engines or (engine,):
        get_engine(name)  # the whole assignment, before any dispatch
    mode = resolve_sizing(sizing, engine, plan, group_engines)
    if pipeline == "legacy":
        if sizing == "planned":
            raise ValueError(
                "sizing='planned' requires pipeline='two_wave' (the legacy "
                "reference lane sizes each chunk from a blocking read)")
        mode = "legacy"
    gather = resolve_gather(gather, devices[0])
    indptrs = torch.cat([a.indptr, b.indptr]).cpu().numpy().astype(np.int64)
    a_indptr = indptrs[: a.n_rows + 1]
    kb_cap = int(np.diff(indptrs[a.n_rows + 1:]).max(initial=0)) or 1
    n_shards = len(devices)
    items = partition_plan_cached(plan, np.diff(a_indptr), row_chunk,
                                  n_shards, group_engines)
    footprints = _resolve_footprints(operands, plan, items, a, a_indptr,
                                     row_chunk, n_shards, group_engines,
                                     b.n_rows)
    rows_all, chunk_rows = _chunk_rows(items, devices)
    return _Setup(engine, mode, gather, kb_cap, next_pow2(max(b.n_cols, 1)),
                  devices, footprints, items, rows_all, chunk_rows)


def _enumerate(ops: _Operands, rows: torch.Tensor, item: WorkItem,
               gather: str):
    """A-row gather → B-row gather → intermediate products of one chunk,
    on its shard.  Through a footprint block, A's column ids are remapped
    to the block's rows first (a column the block lacks becomes padding).
    On the batched lane one gather of the folded plane serves every
    member; its rows unfold to (B, R, a_cap, kb)."""
    cols_a, vals_a = phases.gather_group_rows(ops.a_indptr, ops.a_indices,
                                              ops.a_data, rows, item.a_cap)
    if ops.remap is not None:
        cols_a = phases.remap_columns(cols_a, ops.remap)
    bi, bv = GATHERS[gather](ops.b_idx, ops.b_val, cols_a)
    if ops.batch is not None:
        r, a_cap, kb = bi.shape
        bv = bv.reshape(r, a_cap, ops.batch, kb).movedim(2, 0)
    return phases.combine_products(cols_a, vals_a, bi, bv)


@dataclasses.dataclass
class _ChunkRun:
    """One chunk's accumulated output, on its shard's device."""

    rows: torch.Tensor    # (R_pad,) row ids, -1 = padding
    cols: torch.Tensor    # (R_pad, out_cap)
    vals: torch.Tensor    # (R_pad, out_cap) or (B, R_pad, out_cap)
    counts: torch.Tensor  # (R_pad,)


def _run_measured(ops: List[_Operands], s: _Setup):
    """Two waves around one coalesced read of every chunk's uniqueCounts
    (all shards'); returns the runs, nnz, the capacity and each chunk's
    nnz."""
    pend = []
    for item, rows in zip(s.items, s.chunk_rows):
        eng = get_engine(item.engine or s.engine)
        keys, vals = _enumerate(ops[item.shard], rows, item, s.gather)
        pend.append((eng, keys, vals, eng.allocate(keys, item.table_cap)))
    unique = _coalesced_sync(
        [p[3][: len(item.rows)] for p, item in zip(pend, s.items)], s.merge)
    chunk_nnz = [int(u.sum()) for u in unique]
    nnz = sum(chunk_nnz)
    runs = []
    for i, (item, rows) in enumerate(zip(s.items, s.chunk_rows)):
        eng, keys, vals, _ = pend[i]
        pend[i] = None  # free this chunk's products once consumed
        out_cap = _out_cap(int(unique[i].max(initial=0)), item.table_cap,
                           s.ncol_cap)
        runs.append(_ChunkRun(rows, *eng.accumulate(keys, vals,
                                                    item.table_cap, out_cap)))
    return runs, nnz, _int32_nnz_capacity(nnz), chunk_nnz


def _run_planned(ops: List[_Operands], s: _Setup, plan: GroupPlan,
                 ncol: int):
    """Sizes from the plan's Alg. 1 bounds: nothing is read back.  Returns
    the runs, the capacity and each chunk's nnz bound."""
    bounds = [chunk_capacity_bounds(plan, item.rows, ncol)
              for item in s.items]
    runs = []
    for item, rows, (max_u, _) in zip(s.items, s.chunk_rows, bounds):
        out_cap = _out_cap(max_u, item.table_cap, s.ncol_cap)
        if faults.trigger("capacity_undersize"):
            # Chaos hook: a capacity below the chunk's uniqueCounts, so the
            # overflow flag and the measured-capacity retry run.
            out_cap = 1
        keys, vals = _enumerate(ops[item.shard], rows, item, s.gather)
        runs.append(_ChunkRun(rows, *get_engine(item.engine or s.engine)
                              .accumulate(keys, vals, item.table_cap,
                                          out_cap)))
    return runs, _int32_nnz_capacity(sum(t for _, t in bounds)), \
        [t for _, t in bounds]


def _capacity_overflow(runs: List[_ChunkRun], merge) -> bool:
    """The planned lane's overflow flag: a chunk whose true uniqueCounts
    (the engines never clip them) pass its output width was trimmed.  It
    is computed and read only while ``capacity_undersize`` is armed: a
    clean planned capacity is a bound that cannot overflow, and the clean
    lane keeps ``host_sync_count`` 0."""
    if not runs or not faults.armed("capacity_undersize"):
        return False
    return bool(torch.stack([
        replicate_to((r.counts > r.cols.shape[1]).any(), merge)
        for r in runs]).any())


def _shard_seg_caps(items: Sequence[WorkItem], n_shards: int,
                    chunk_nnz: Sequence[int]) -> List[int]:
    """Each shard's segment capacity (pow2), from its chunks' nnz: the
    measured counts or the planned bounds; 0 for a shard with none."""
    totals = [0] * n_shards
    for item, nnz in zip(items, chunk_nnz):
        totals[item.shard] += int(nnz)
    return [next_pow2(t) if t > 0 else 0 for t in totals]


def _epilogue(runs: List[_ChunkRun], s: _Setup, n: int, cap: int, dtype,
              batch: Optional[int], chunk_nnz: Sequence[int]):
    """Build the int32 indptr on the merge device from the chunks' counts,
    then reassemble the (cap,) index and value buffers there (value buffers
    (B, cap) on the batched lane: one structure).  One shard: every chunk
    scatters straight into them.  More: each chunk packs into its shard's
    segment on the shard's device (``phases.reassemble_segment``; buffers
    a shard, never shared), then one merge scatter a shard
    (``phases.merge_segments``)."""
    merge = s.merge
    counts_all = torch.zeros(n + 1, dtype=torch.int32, device=merge)
    if runs:  # padding rows (-1) land in the extra slot n; their count is 0
        dest = torch.where(s.rows_all < 0, n, s.rows_all).long()
        counts_all[dest] = torch.cat([replicate_to(r.counts, merge)
                                      for r in runs])
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=merge)
    indptr[1:] = torch.cumsum(counts_all[:n], 0, dtype=torch.int32)
    lead = () if batch is None else (batch,)
    idx_buf = torch.zeros(cap + 1, dtype=torch.int32, device=merge)
    dat_buf = torch.zeros(lead + (cap + 1,), dtype=dtype, device=merge)
    if len(s.devices) == 1:
        for run in runs:
            phases.reassemble_device(idx_buf, dat_buf, run.cols, run.vals,
                                     run.counts,
                                     indptr[run.rows.clamp(min=0)])
        return indptr, idx_buf[:cap], dat_buf[..., :cap]
    segs = {}
    for sh, seg_cap in enumerate(_shard_seg_caps(s.items, len(s.devices),
                                                 chunk_nnz)):
        if seg_cap:  # a shard whose rows hold no output has no segment
            dev = s.devices[sh]
            segs[sh] = [
                torch.zeros(seg_cap + 1, dtype=torch.int32, device=dev),
                torch.zeros(lead + (seg_cap + 1,), dtype=dtype, device=dev),
                # the sentinel: the final capacity, the merge's sink slot
                torch.full((seg_cap + 1,), cap, dtype=torch.int32,
                           device=dev),
                torch.zeros((), dtype=torch.int32, device=dev)]
    indptr_on = {merge: indptr}
    for item, run in zip(s.items, runs):
        seg = segs.get(item.shard)
        if seg is None:
            continue
        dev = s.devices[item.shard]
        if dev not in indptr_on:
            indptr_on[dev] = replicate_to(indptr, dev)
        seg[:] = phases.reassemble_segment(
            *seg, run.cols, run.vals, run.counts,
            indptr_on[dev][run.rows.clamp(min=0)])
    for sh in sorted(segs):
        seg_idx, seg_dat, dest, _ = segs.pop(sh)
        phases.merge_segments(idx_buf, dat_buf, replicate_to(seg_idx, merge),
                              replicate_to(seg_dat, merge),
                              replicate_to(dest, merge))
    return indptr, idx_buf[:cap], dat_buf[..., :cap]


def _run_legacy(ops: List[_Operands], s: _Setup, n: int, dtype):
    """The reference lane: one blocking read of the uniqueCounts per chunk
    (``host_sync_count`` one a chunk), each chunk's output copied to the
    host, and the CSR reassembled there at its exact nnz."""
    chunks = []
    counts_all = torch.zeros(n, dtype=torch.int64)
    for item, rows in zip(s.items, s.chunk_rows):
        eng = get_engine(item.engine or s.engine)
        keys, vals = _enumerate(ops[item.shard], rows, item, s.gather)
        _SYNC_STATS["host_sync_count"] += 1
        unique = eng.allocate(keys, item.table_cap).cpu()
        out_cap = _out_cap(int(unique.max()) if unique.numel() else 0,
                           item.table_cap, s.ncol_cap)
        cols, out_vals, counts = (t.cpu() for t in eng.accumulate(
            keys, vals, item.table_cap, out_cap))
        r = len(item.rows)
        ids = torch.from_numpy(item.rows.astype(np.int64))
        counts_all[ids] = counts[:r].long()
        chunks.append((ids, cols[:r], out_vals[..., :r, :], counts[:r]))
    indptr = torch.zeros(n + 1, dtype=torch.int64)
    indptr[1:] = torch.cumsum(counts_all, 0)
    nnz = int(indptr[-1])
    cap = max(nnz, 1)
    lead = () if ops[0].batch is None else (ops[0].batch,)
    indices = torch.zeros(cap, dtype=torch.int32)
    data = torch.zeros(lead + (cap,), dtype=dtype)
    for ids, cols, out_vals, counts in chunks:
        offs = torch.arange(cols.shape[1])[None, :]
        ok = offs < counts[:, None]
        pos = (indptr[ids][:, None] + offs)[ok]
        indices[pos] = cols[ok]
        data[..., pos] = out_vals[..., ok]
    return (indptr.to(torch.int32).to(s.merge), indices.to(s.merge),
            data.to(s.merge), nnz)


def _execute(ops: List[_Operands], s: _Setup, plan: GroupPlan, n: int,
             ncol: int):
    """Run the chunks on ``s.mode``'s lane; (indptr, indices, data, nnz)
    on the merge device."""
    dtype = ops[0].a_data.dtype
    batch = ops[0].batch
    if s.mode == "legacy":
        return _run_legacy(ops, s, n, dtype)
    mode = s.mode
    if mode == "planned":
        runs, cap, chunk_nnz = _run_planned(ops, s, plan, ncol)
        if _capacity_overflow(runs, s.merge):
            # An under-sized chunk makes the whole planned result
            # untrustworthy: drop it before the epilogue and re-run every
            # chunk on the measured lane, sized from the real counts.
            _RESILIENCE_STATS["capacity_retries"] += 1
            runs = None
            mode = "measured"
    if mode == "measured":
        runs, nnz, cap, chunk_nnz = _run_measured(ops, s)
    indptr, indices, data = _epilogue(runs, s, n, cap, dtype, batch,
                                      chunk_nnz)
    if mode == "planned":
        nnz = indptr[-1]
    return indptr, indices, data, nnz


def operand_device(a: CSR, b: CSR) -> torch.device:
    """The device both operands live on (ValueError if they differ)."""
    if a.device != b.device:
        raise ValueError(f"A is on {a.device} but B is on {b.device}")
    return a.device


def _operand_cache(operand_cache: Optional[OperandCache]) -> OperandCache:
    return _OPERAND_CACHE if operand_cache is None else operand_cache


def _placed_b(b: CSR, s: _Setup, operand_cache) -> _OperandEntry:
    """B's ELL placed on the shards through the operand cache; a failed
    placement (the ``gather_fail`` fault point) is re-issued once, since
    it is a pure function of B and the shards."""
    ocache = _operand_cache(operand_cache)
    try:
        faults.fire("gather_fail")
        return ocache.b_operands(b, s.kb_cap, s.devices, s.footprints)
    except faults.FaultInjected:
        return ocache.b_operands(b, s.kb_cap, s.devices, s.footprints)


def execute_plan(a: CSR, b: CSR, plan: GroupPlan, engine: str = "sort",
                 gather: Gather = "auto", row_chunk: int = 4096, mesh=None,
                 pipeline: Pipeline = "two_wave", sizing: Sizing = "auto",
                 autotune: Optional[AutotuneCache] = None,
                 operands: Operands = "auto",
                 operand_cache: Optional[OperandCache] = None):
    """Run the group pipeline; returns (C, nnz_C) on the merge device.

    ``sizing="measured"`` reads every chunk's uniqueCounts back in one
    coalesced copy (all shards') and returns ``nnz`` as an int;
    ``"planned"`` sizes from the plan's Alg. 1 bounds, reads nothing back
    and returns ``nnz`` as a 0-d device tensor; ``"auto"`` is planned when
    every engine the call dispatches is fused, measured otherwise.
    ``pipeline="legacy"`` reads each chunk's counts back on its own and
    reassembles on the host.  ``engine="auto"`` dispatches one engine per
    Table-I bin: the plan's ``group_engines`` when set (which also wins
    over a concrete engine), else the ``autotune`` cache's assignment (the
    module cache when None).  ``mesh`` deals the chunks to its shards
    (``partition_plan``); A and B must be on its merge device (its first).
    ``operands`` places B on the shards (``resolve_operands``);
    ``operand_cache`` scopes B's ELL cache (the module cache when None).
    Every mesh, placement and lane gives the ``mesh=None`` result: bit for
    bit where the lane is deterministic.  On a CUDA device the hash
    engines need float32 values.  A plan whose ``estimated_device_bytes``
    exceed ``set_device_budget`` raises ``DeviceBudgetExceeded`` before
    anything is allocated.
    """
    _check_budget(plan, a.data.dtype)
    s = _setup(a, b, plan, engine, gather, row_chunk, mesh, pipeline, sizing,
               autotune, operands)
    entry = _placed_b(b, s, operand_cache)
    ops = [_Operands(*a_sh, *b_sh) for a_sh, b_sh in zip(
        _shard_a_operands((a.indptr, a.indices, a.data), s.devices),
        entry.shards)]
    indptr, indices, data, nnz = _execute(ops, s, plan, a.n_rows, b.n_cols)
    return CSR(indptr, indices, data, (a.n_rows, b.n_cols)), nnz


def _batched_operands(a: CSR, b: CSR, a_data_batch, b_data_batch,
                      s: _Setup, operand_cache) -> List[_Operands]:
    """The batched lane's operands on every shard: A's value stack, B's
    cached ELL index plane (or footprint block), and B's value planes
    folded ``(n_b, batch * kb)`` (``b.data`` repeated when ``b_data_batch``
    is None: one B for every member), cut to the shard's footprint rows
    where it has a block."""
    a_data_batch = torch.as_tensor(a_data_batch, device=a.device)
    if a_data_batch.dim() != 2:
        raise ValueError(f"a_data_batch must be (batch, capacity), got "
                         f"{tuple(a_data_batch.shape)}")
    batch = a_data_batch.shape[0]
    entry = _operand_cache(operand_cache).b_operands(b, s.kb_cap, s.devices,
                                                     s.footprints)
    folded = None
    if b_data_batch is not None:
        b_data_batch = torch.as_tensor(b_data_batch, device=b.device)
        if b_data_batch.shape[0] != batch:
            raise ValueError(
                f"batch mismatch: {batch} A value sets vs "
                f"{b_data_batch.shape[0]} B value sets")
        folded = ell_values_folded(b, s.kb_cap, b_data_batch)
    fps = entry.footprints or [None] * len(s.devices)
    out = []
    for a_sh, (b_idx, b_val, remap), fp, dev in zip(
            _shard_a_operands((a.indptr, a.indices, a_data_batch),
                              s.devices), entry.shards, fps, s.devices):
        if folded is None:
            val = b_val.repeat(1, batch)
        elif fp is None:
            val = replicate_to(folded, dev)
        else:
            sel = torch.from_numpy(np.asarray(fp, np.int64)).to(b.device)
            val = replicate_to(folded.index_select(0, sel), dev)
        out.append(_Operands(*a_sh, b_idx, val, remap, batch))
    return out


def execute_plan_batched(
    a: CSR,
    b: CSR,
    a_data_batch,
    b_data_batch=None,
    plan: Optional[GroupPlan] = None,
    engine: str = "sort",
    gather: Gather = "auto",
    row_chunk: int = 4096,
    mesh=None,
    pipeline: Pipeline = "two_wave",
    sizing: Sizing = "auto",
    autotune: Optional[AutotuneCache] = None,
    operands: Operands = "auto",
    operand_cache: Optional[OperandCache] = None,
):
    """Run the pipeline once for a batch of same-pattern operands; returns
    ``(indptr, indices, data_batch, nnz)``.

    ``a``/``b`` carry the shared structure; ``a_data_batch`` is a ``(batch,
    capacity)`` stack of A's value sets, ``b_data_batch`` the same for B
    (``None``: ``b.data`` for every member).  Keys, sizing (one coalesced
    read for the whole batch on the measured lane, none on the planned
    lane), output structure and reassembly offsets are computed once per
    chunk; only the value streams carry the batch axis.  Under a mesh the
    whole batch rides one shard assignment, and a shard with a footprint
    block takes those rows of the folded value plane.  Member i's result
    is ``CSR(indptr, indices, data_batch[i], (a.n_rows, b.n_cols))``, the
    same as ``execute_plan`` on member i's values (bit for bit on the CPU).
    Every knob means what it means for ``execute_plan``.
    """
    if plan is None:
        plan = group_rows(a, b)
    s = _setup(a, b, plan, engine, gather, row_chunk, mesh, pipeline, sizing,
               autotune, operands)
    ops = _batched_operands(a, b, a_data_batch, b_data_batch, s,
                            operand_cache)
    return _execute(ops, s, plan, a.n_rows, b.n_cols)


# ---------------------------------------------------------------------------
# Streamed (out-of-core) lane: row-block tiles of A through the same pipeline
# ---------------------------------------------------------------------------

def tile_ranges(n_rows: int, tile_rows: int) -> List[Tuple[int, int]]:
    """Half-open ``[r0, r1)`` row blocks of ``tile_rows`` rows covering
    ``[0, n_rows)``; the last is ragged when ``tile_rows`` does not divide
    ``n_rows``."""
    return [(r0, min(r0 + tile_rows, n_rows))
            for r0 in range(0, n_rows, tile_rows)]


def _host_copy(t: torch.Tensor, pin: bool) -> torch.Tensor:
    """``t`` in host memory, page-locked when ``pin`` (so that slices of
    it copy to the card without waiting)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
    return out.copy_(t)


def execute_plan_streamed(
    a: CSR,
    b: CSR,
    *,
    tile_rows: Optional[int] = None,
    prefetch: Optional[int] = None,
    plan: Optional[PlanCache] = None,
    engine: str = "sort",
    gather: Gather = "auto",
    row_chunk: int = 4096,
    schedule: Schedule = "grouped",
    mesh=None,
    pipeline: Pipeline = "two_wave",
    sizing: Sizing = "auto",
    autotune: Optional[AutotuneCache] = None,
    operands: Operands = "auto",
    operand_cache: Optional[OperandCache] = None,
) -> Tuple[CSR, int, Dict[str, int]]:
    """Out-of-core SpGEMM: A in host memory, streamed through the pipeline
    in row-block tiles; returns ``(C, nnz_C, stream_info)``.

    A's structure and values are copied once into page-locked host memory.
    Each tile is staged on B's device (``launch.sharding.stage_tile``: on
    CUDA a copy on a side stream that the compute stream waits for), planned
    through the lane's ``PlanCache`` (fingerprinted on the host slices, so
    a tile hits whichever device it went to; a miss plans on the staged
    tile) and run by ``execute_plan`` with every knob as it means there,
    ``mesh`` included (B on the mesh's merge device, which each tile's
    call fans out to the shards), the budget checked per tile.  Up to
    ``prefetch`` tiles are staged at once: the next tiles are staged after
    this tile's work is dispatched and before its result is read back, so
    their copies overlap its compute.  Each tile's compact segment (exact nnz) comes back to the
    host and is merged there with ``phases.merge_segments_host``; C is
    returned on B's device.  Tiles are disjoint row blocks and each row is
    planned into the same Table-I bin as in the whole call, so C is the
    monolithic product bit for bit wherever that lane is deterministic.
    ``stream_info`` holds ``n_tiles``, the resolved ``tile_rows`` and
    ``prefetch``, ``max_tile_ip`` and ``total_ip``.
    """
    from repro_torch.launch.sharding import stage_tile

    if mesh is not None and b.device != merge_device(shard_devices(mesh)):
        raise ValueError(
            f"B is on {b.device} but the mesh's merge device (its first) is "
            f"{merge_device(shard_devices(mesh))}; place B there")
    t_rows = resolve_tile_rows(tile_rows)
    depth = resolve_prefetch(prefetch)
    if plan is not None and not isinstance(plan, PlanCache):
        raise TypeError(
            "the streamed lane plans per tile, so plan= must be a "
            f"PlanCache (or None for a call-local cache); got {type(plan)!r}")
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} and {b.shape} do not chain")
    if schedule not in ("grouped", "natural"):
        raise ValueError(f"unknown schedule {schedule!r}")
    cache = plan if plan is not None else PlanCache()
    n = a.n_rows
    dev = b.device
    pin = dev.type == "cuda"
    a_indptr = a.indptr.cpu().numpy().astype(np.int64)
    nnz_a = int(a_indptr[-1])
    ipt_h = _host_copy(a.indptr.to(torch.int32), pin)
    idx_h = _host_copy(a.indices[:nnz_a], pin)
    dat_h = _host_copy(a.data[:nnz_a], pin)
    side = torch.cuda.Stream(dev) if pin else None
    tiles = tile_ranges(n, t_rows)
    staged: List[tuple] = []
    next_tile = [0]

    def stage(in_flight: bool) -> None:
        r0, r1 = tiles[next_tile[0]]
        lo, hi = int(a_indptr[r0]), int(a_indptr[r1])
        host = (ipt_h[r0:r1 + 1], idx_h[lo:hi], dat_h[lo:hi])
        try:
            faults.fire("stage_tile_fail")
            placed, ready = stage_tile(host, dev, side)
        except faults.FaultInjected:
            # Staging is a pure copy of host slices: re-stage the tile.
            placed, ready = stage_tile(host, dev, side)
        _STREAM_STATS["tile_bytes_h2d"] += sum(
            t.numel() * t.element_size() for t in host)
        if in_flight:
            _STREAM_STATS["prefetch_overlap_hits"] += 1
        staged.append((r0, r1, host, placed, ready))
        next_tile[0] += 1

    segments = []
    max_tile_ip = total_ip = 0
    for _ in range(len(tiles)):
        if not staged:
            stage(in_flight=False)
        r0, r1, host, placed, ready = staged.pop(0)
        if ready is not None:  # the compute stream waits for the copy
            compute = torch.cuda.current_stream(dev)
            compute.wait_event(ready)
            for t in placed:
                t.record_stream(compute)
        shape_t = (r1 - r0, a.n_cols)
        ipt_t = host[0] - host[0][0]
        tile_host = CSR(ipt_t, host[1], host[2], shape_t)
        tile_dev = CSR(placed[0] - placed[0][0], placed[1], placed[2],
                       shape_t)
        tplan = cache.plan_for(tile_host, b,
                               supplier=lambda: group_rows(tile_dev, b))
        _STREAM_STATS["tiles_streamed"] += 1
        max_tile_ip = max(max_tile_ip, int(tplan.total_ip))
        total_ip += int(tplan.total_ip)
        run = None
        if tplan.total_ip > 0:
            run_plan = ungrouped_plan(tplan) if schedule == "natural" \
                else tplan
            run = execute_plan(
                tile_dev, b, run_plan, engine=engine, gather=gather,
                row_chunk=row_chunk, mesh=mesh, pipeline=pipeline,
                sizing=sizing, autotune=autotune, operands=operands,
                operand_cache=operand_cache)
        # stage the next tiles while this tile's work runs, then read back
        while next_tile[0] < len(tiles) and len(staged) < depth - 1:
            stage(in_flight=run is not None)
        if run is None:  # no products: only empty rows
            segments.append((r0, r1, np.zeros(r1 - r0 + 1, np.int64),
                             np.empty(0, np.int32),
                             np.empty(0, dat_h.numpy().dtype)))
            continue
        c_t = run[0]
        t_ipt = c_t.indptr.cpu().numpy().astype(np.int64)
        t_nnz = int(t_ipt[-1])
        segments.append((r0, r1, t_ipt, c_t.indices[:t_nnz].cpu().numpy(),
                         c_t.data[:t_nnz].cpu().numpy()))
        del run, c_t, tile_dev, placed  # free them before the next tile runs

    # tiles are contiguous disjoint row blocks: the merged indptr is their
    # offset-shifted concatenation, and each segment lands in one scatter
    indptr = np.zeros(n + 1, np.int64)
    for r0, r1, t_ipt, _, _ in segments:
        indptr[r0 + 1:r1 + 1] = indptr[r0] + t_ipt[1:]
    nnz = int(indptr[-1])
    _int32_nnz_capacity(nnz)  # the int32 index space, as the other lanes
    cap = max(nnz, 1)
    idx_buf = np.zeros(cap, np.int32)
    dat_buf = np.zeros(cap, dat_h.numpy().dtype)
    for r0, _, _, seg_idx, seg_dat in segments:
        dest = int(indptr[r0]) + np.arange(len(seg_idx), dtype=np.int64)
        phases.merge_segments_host(idx_buf, dat_buf, seg_idx, seg_dat, dest)
    c = CSR(torch.from_numpy(indptr.astype(np.int32)).to(dev),
            torch.from_numpy(idx_buf).to(dev),
            torch.from_numpy(dat_buf).to(dev), (n, b.n_cols))
    info = {"n_tiles": len(tiles), "tile_rows": t_rows, "prefetch": depth,
            "max_tile_ip": max_tile_ip, "total_ip": total_ip}
    return c, nnz, info
