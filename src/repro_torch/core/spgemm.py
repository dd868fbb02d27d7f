"""Public SpGEMM API — the paper's three-phase pipeline end to end.

``spgemm(A, B)`` runs, on the device its operands live on:

  1. **Row-grouping**: Algorithm 1 IP counts → Table-I groups → ``Map``
     (the counts are read back to the host to plan the launches).
  2. **Allocation + accumulation** per group-chunk, dispatched by the
     executor (``repro_torch.core.executor``).
  3. **Reassembly** into one CSR in original row order, on the device.

``mesh=`` (a sequence of ``torch.device``s, ``launch.sharding``) deals the
chunks to its shards, each on its own device, with B placed whole or as a
footprint block (``operands=``); the operands live on its merge device
(the first), where the result is assembled.

Amortized entry points:

* ``spgemm(..., plan=)`` — a ``GroupPlan`` is used as it is, a
  ``PlanCache`` skips ``group_rows`` whenever the operands' sparsity
  patterns were seen before.
* ``spgemm_batched`` — one pipeline run for a batch of same-pattern
  operands (values differ, structure shared); bit-identical to a
  per-matrix loop on the CPU.

``spgemm_streamed`` is the out-of-core lane: A streamed from host memory
in row-block tiles, each through the same pipeline, merged on the host.
``spgemm(on_budget="stream")`` re-routes a call whose plan exceeds
``executor.set_device_budget`` through it.

``spgemm_ell_fixed`` is the single-group, fixed-capacity variant with no
host read (for loops over a fixed structure).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Literal, Optional, Sequence, Union

import torch

from repro_torch.core import executor, phases
from repro_torch.core.executor import PlanCache
from repro_torch.core.grouping import GroupPlan, group_rows
from repro_torch.launch.sharding import shard_devices
from repro_torch.sparse.formats import CSR, ELL

PlanLike = Union[GroupPlan, PlanCache, None]


@dataclasses.dataclass
class SpGEMMResult:
    """One SpGEMM product: the CSR result ``c``, the ``GroupPlan`` that
    executed it, and the ``info`` counter dict."""

    c: CSR
    plan: GroupPlan
    info: Dict[str, float]


@dataclasses.dataclass
class SpGEMMBatchResult:
    """Batched product: ``cs[i] = a_batch[i] @ b_batch[i]``; every member
    shares one output structure (indptr/indices are the same tensors)."""

    cs: List[CSR]
    plan: GroupPlan
    info: Dict[str, float]


def _resolve_plan(a: CSR, b: CSR, plan: PlanLike) -> GroupPlan:
    if isinstance(plan, PlanCache):
        return plan.plan_for(a, b)
    if isinstance(plan, GroupPlan):
        return plan
    if plan is not None:
        raise TypeError(
            f"plan must be a GroupPlan, PlanCache, or None; got {type(plan)!r}")
    return group_rows(a, b)


def spgemm(
    a: CSR,
    b: CSR,
    method: Optional[Literal["hash", "sort"]] = None,
    row_chunk: int = 4096,
    schedule: Literal["grouped", "natural"] = "grouped",
    engine: Optional[str] = None,
    gather: executor.Gather = "auto",
    mesh=None,
    plan: PlanLike = None,
    pipeline: executor.Pipeline = "two_wave",
    sizing: executor.Sizing = "auto",
    autotune: Optional[executor.AutotuneCache] = None,
    operands: executor.Operands = "auto",
    operand_cache: Optional[executor.OperandCache] = None,
    on_budget: str = "error",
) -> SpGEMMResult:
    """C = A @ B via the paper's multi-phase pipeline.

    ``engine`` picks the allocation/accumulation engine (``"sort"``, the
    default, ``"hash"``, ``"fused_hash"``, or ``"auto"``: one engine per
    Table-I bin from the ``autotune`` cache; ``method`` is the legacy
    alias).  ``gather`` picks how B's rows are served: ``"xla"`` (a plain
    take), ``"aia"`` (the AIA row-gather kernel) or ``"auto"`` (``"aia"`` on
    a CUDA device, ``"xla"`` on the CPU).  ``schedule="natural"`` turns the
    Table-I grouping off (every row at the worst-case capacity).  ``sizing``
    picks the measured lane (one coalesced read of the uniqueCounts) or the
    planned lane (sizes from the plan's Alg. 1 bounds, no read);
    ``"auto"`` is planned for ``"fused_hash"`` and measured otherwise.
    ``pipeline="legacy"`` is the per-chunk-read reference lane.
    ``operand_cache`` scopes B's ELL cache (the executor's module cache
    when None).  ``on_budget`` picks what a plan whose
    ``executor.estimated_device_bytes`` exceed ``executor.
    set_device_budget`` does: ``"error"`` raises ``DeviceBudgetExceeded``,
    ``"stream"`` re-routes the call through ``spgemm_streamed`` with the
    largest power-of-two ``tile_rows`` whose every tile fits (bit-identical
    on a deterministic lane; ``info["degraded_to_stream"]``,
    ``cache_stats()["budget_degradations"]``); inert with no budget.
    ``mesh`` runs the chunks on its shards (``executor.execute_plan``; A
    and B on its first device) and ``operands`` places B there
    (``executor.resolve_operands``); every mesh and placement gives the
    ``mesh=None`` product.  The façade reads ``nnz`` back once, after
    every chunk was dispatched, to fill ``info``.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} and {b.shape} do not chain")
    executor.mesh_devices(mesh, a, b)
    on_budget = executor.resolve_on_budget(on_budget)
    if schedule not in ("grouped", "natural"):
        raise ValueError(f"unknown schedule {schedule!r}")
    engine = executor.resolve_engine(engine, method)
    plan = _resolve_plan(a, b, plan)
    run_plan = executor.ungrouped_plan(plan) if schedule == "natural" \
        else plan
    budget = executor.device_budget()
    if on_budget == "stream" and budget is not None:
        itemsize = a.data.element_size()
        if executor.estimated_device_bytes(plan, itemsize) > budget:
            return _degrade_to_stream(
                a, b, plan, run_plan, itemsize, method=method,
                row_chunk=row_chunk, schedule=schedule, engine=engine,
                gather=gather, mesh=mesh, pipeline=pipeline, sizing=sizing,
                autotune=autotune, operands=operands,
                operand_cache=operand_cache)
    c, nnz = executor.execute_plan(
        a, b, run_plan, engine=engine, gather=gather, row_chunk=row_chunk,
        mesh=mesh, pipeline=pipeline, sizing=sizing, autotune=autotune,
        operands=operands, operand_cache=operand_cache)
    return SpGEMMResult(c=c, plan=run_plan,
                        info=spgemm_info(a, b, run_plan, nnz, mesh=mesh))


def spgemm_info(a: CSR, b: CSR, plan: GroupPlan, nnz_c,
                mesh=None) -> Dict[str, float]:
    """Hardware-independent counters; the three nnz values come back from
    the device in one read."""
    nnz_c = torch.as_tensor(nnz_c, device=a.device)
    nnz_a, nnz_b, nnz_c = torch.stack(
        [a.nnz.long(), b.nnz.long(), nnz_c.long()]).tolist()
    total_ip = plan.total_ip
    return {
        "n_shards": len(shard_devices(mesh)),
        "nnz_a": nnz_a,
        "nnz_b": nnz_b,
        "nnz_c": nnz_c,
        "intermediate_products": int(total_ip),
        "flops": 2.0 * total_ip,  # paper's FLOP definition (§VI Methodology)
        "compression_ratio": float(total_ip) / max(nnz_c, 1),
        "group_sizes": list(plan.group_sizes),
        "max_ip": plan.max_ip,
    }


def _degrade_to_stream(a, b, plan, run_plan, itemsize, *, method,
                       row_chunk, schedule, engine, gather, mesh, pipeline,
                       sizing, autotune, operands,
                       operand_cache) -> SpGEMMResult:
    """``on_budget="stream"``: the whole plan's estimate exceeds the budget,
    so the call runs through ``spgemm_streamed`` with the largest
    ``tile_rows`` whose worst tile fits.  The result keeps the monolithic
    ``run_plan`` (still the pattern's plan) and marks ``info`` with
    ``degraded_to_stream`` beside the streamed lane's tile counters."""
    tile_rows = executor.derive_degradation_tile_rows(plan, a.n_rows,
                                                      itemsize)
    executor._RESILIENCE_STATS["budget_degradations"] += 1
    sres = spgemm_streamed(
        a, b, tile_rows=tile_rows, method=method, row_chunk=row_chunk,
        schedule=schedule, engine=engine, gather=gather, mesh=mesh,
        pipeline=pipeline, sizing=sizing, autotune=autotune,
        operands=operands, operand_cache=operand_cache)
    info = dict(sres.info)
    info["degraded_to_stream"] = 1
    return SpGEMMResult(c=sres.c, plan=run_plan, info=info)


# ---------------------------------------------------------------------------
# Streamed (out-of-core) SpGEMM over row-block tiles of A
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SpGEMMStreamResult:
    """Streamed product: the merged CSR ``c`` and ``info`` with the lane's
    tile counters (``n_tiles``, the resolved ``tile_rows`` and
    ``prefetch``, ``max_tile_ip``).  Each tile ran its own ``GroupPlan``,
    kept by the lane's ``PlanCache``."""

    c: CSR
    info: Dict[str, float]


def spgemm_streamed(
    a: CSR,
    b: CSR,
    *,
    tile_rows: Optional[int] = None,
    prefetch: int = 2,
    method: Optional[Literal["hash", "sort"]] = None,
    row_chunk: int = 4096,
    schedule: Literal["grouped", "natural"] = "grouped",
    engine: Optional[str] = None,
    gather: executor.Gather = "auto",
    mesh=None,
    plan: Optional[PlanCache] = None,
    pipeline: executor.Pipeline = "two_wave",
    sizing: executor.Sizing = "auto",
    autotune: Optional[executor.AutotuneCache] = None,
    operands: executor.Operands = "auto",
    operand_cache: Optional[executor.OperandCache] = None,
) -> SpGEMMStreamResult:
    """C = A @ B out-of-core (``executor.execute_plan_streamed``): A is
    streamed from page-locked host memory in ``tile_rows`` row blocks
    (default ``executor.DEFAULT_TILE_ROWS``), ``prefetch`` tiles staged at
    once (default 2: the next tile's copy overlaps this tile's compute),
    each tile planned through ``plan`` (a ``PlanCache``, or None for a
    call-local one) and run with every other knob as ``spgemm`` runs it.
    The device holds B, the staged tiles and one tile's intermediates; C
    is merged on the host and returned on B's device, the monolithic
    product bit for bit on a deterministic lane.
    """
    engine = executor.resolve_engine(engine, method)
    c, nnz, stream = executor.execute_plan_streamed(
        a, b, tile_rows=tile_rows, prefetch=prefetch, plan=plan,
        engine=engine, gather=gather, row_chunk=row_chunk,
        schedule=schedule, mesh=mesh, pipeline=pipeline, sizing=sizing,
        autotune=autotune, operands=operands, operand_cache=operand_cache)
    total_ip = stream["total_ip"]
    nnz_a, nnz_b = torch.stack([a.nnz.long().cpu(),
                                b.nnz.long().cpu()]).tolist()
    info = {
        "n_shards": len(shard_devices(mesh)),
        "nnz_a": nnz_a,
        "nnz_b": nnz_b,
        "nnz_c": int(nnz),
        "intermediate_products": int(total_ip),
        "flops": 2.0 * total_ip,
        "compression_ratio": float(total_ip) / max(nnz, 1),
        **stream,
    }
    return SpGEMMStreamResult(c=c, info=info)


# ---------------------------------------------------------------------------
# Batched SpGEMM over same-pattern operands
# ---------------------------------------------------------------------------

def _as_members(x, what: str) -> List[CSR]:
    if isinstance(x, CSR):
        return [x]
    members = list(x)
    if not members:
        raise ValueError(f"{what} must contain at least one matrix")
    return members


def _require_same_pattern(mats: List[CSR], what: str) -> None:
    """Raise unless every member has ``mats[0]``'s shape and occupied
    structure (members sharing its structure tensors pass without a read)."""
    t = mats[0]
    nnz = None
    for i, m in enumerate(mats[1:], 1):
        if (m.shape == t.shape and m.indptr is t.indptr
                and m.indices is t.indices):
            continue
        if nnz is None:
            nnz = int(t.nnz)
        if (m.shape != t.shape or m.device != t.device
                or not torch.equal(m.indptr, t.indptr)
                or not torch.equal(m.indices[:nnz], t.indices[:nnz])):
            raise ValueError(
                f"{what}[{i}] does not share {what}[0]'s sparsity pattern; "
                "spgemm_batched requires structure-identical operands "
                "(values may differ)")


def _stack_values(mats: List[CSR], template: CSR,
                  batch: int) -> torch.Tensor:
    """(batch, capacity) value stack aligned to the template's slots, on
    its device (a one-member list broadcasts)."""
    nnz = int(template.nnz)
    out = torch.zeros((batch, template.capacity), dtype=template.data.dtype,
                      device=template.device)
    out[:, :nnz] = torch.stack([mats[i % len(mats)].data[:nnz]
                                for i in range(batch)])
    return out


def spgemm_batched(
    a_batch: Union[CSR, Sequence[CSR]],
    b_batch: Union[CSR, Sequence[CSR]],
    method: Optional[Literal["hash", "sort"]] = None,
    row_chunk: int = 4096,
    schedule: Literal["grouped", "natural"] = "grouped",
    engine: Optional[str] = None,
    gather: executor.Gather = "auto",
    mesh=None,
    plan: PlanLike = None,
    pipeline: executor.Pipeline = "two_wave",
    sizing: executor.Sizing = "auto",
    autotune: Optional[executor.AutotuneCache] = None,
    operands: executor.Operands = "auto",
    operand_cache: Optional[executor.OperandCache] = None,
) -> SpGEMMBatchResult:
    """``cs[i] = a_batch[i] @ b_batch[i]`` for same-pattern operand batches.

    Either side may be a single ``CSR`` (its values shared by every member)
    or a sequence of CSRs with one sparsity pattern.  The plan runs once for
    the whole batch (``executor.execute_plan_batched``); results equal a
    loop of ``spgemm`` over the members (bit for bit on the CPU).  Every
    knob means what it means for ``spgemm``.
    """
    a_members = _as_members(a_batch, "a_batch")
    b_members = _as_members(b_batch, "b_batch")
    batch = max(len(a_members), len(b_members))
    if len(a_members) not in (1, batch) or len(b_members) not in (1, batch):
        raise ValueError(
            f"batch mismatch: {len(a_members)} A members vs "
            f"{len(b_members)} B members")
    a, b = a_members[0], b_members[0]
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} and {b.shape} do not chain")
    executor.mesh_devices(mesh, a, b)
    if schedule not in ("grouped", "natural"):
        raise ValueError(f"unknown schedule {schedule!r}")
    engine = executor.resolve_engine(engine, method)
    _require_same_pattern(a_members, "a_batch")
    _require_same_pattern(b_members, "b_batch")

    plan = _resolve_plan(a, b, plan)
    run_plan = executor.ungrouped_plan(plan) if schedule == "natural" \
        else plan
    a_data = _stack_values(a_members, a, batch)
    b_data = None if len(b_members) == 1 \
        else _stack_values(b_members, b, batch)
    indptr, indices, data_batch, nnz = executor.execute_plan_batched(
        a, b, a_data, b_data, run_plan, engine=engine, gather=gather,
        row_chunk=row_chunk, mesh=mesh, pipeline=pipeline, sizing=sizing,
        autotune=autotune, operands=operands, operand_cache=operand_cache)
    shape = (a.n_rows, b.n_cols)
    cs = [CSR(indptr, indices, data_batch[i], shape) for i in range(batch)]
    info = spgemm_info(a, b, run_plan, nnz, mesh=mesh)
    info["batch"] = batch
    return SpGEMMBatchResult(cs=cs, plan=run_plan, info=info)


# ---------------------------------------------------------------------------
# Fixed-capacity variant (no host read)
# ---------------------------------------------------------------------------

def spgemm_ell_fixed(a: ELL, b: ELL, out_cap: int,
                     engine: str = "sort") -> ELL:
    """C = A @ B as one group at static capacities, with no host read.

    C's row capacity is ``out_cap`` (entries beyond it are dropped — size it
    from Algorithm-1 IP bounds), which is also the hash table's capacity.
    ``engine="auto"`` has no Table-I bins to dispatch over and raises.
    """
    engine = executor.resolve_engine(engine)
    if engine == executor.AUTO_ENGINE:
        raise ValueError(
            "spgemm_ell_fixed runs a single fixed-capacity group, so there "
            "are no Table-I bins for engine='auto' to dispatch over; pick a "
            f"concrete engine: {', '.join(executor.available_engines())}")
    keys, vals = phases.enumerate_products(a.indices, a.data, b.indices,
                                           b.data)
    cols, out_vals, _ = executor.get_engine(engine).accumulate(
        keys, vals, out_cap, out_cap)
    return ELL(cols, out_vals, (a.shape[0], b.shape[1]))
