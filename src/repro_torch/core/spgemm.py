"""Public SpGEMM API — the paper's three-phase pipeline end to end.

``spgemm(A, B)`` runs, on the device its operands live on:

  1. **Row-grouping**: Algorithm 1 IP counts → Table-I groups → ``Map``
     (the counts are read back to the host to plan the launches).
  2. **Allocation + accumulation** per group-chunk, dispatched by the
     executor (``repro_torch.core.executor``).
  3. **Reassembly** into one CSR in original row order, on the device.

``plan=`` amortizes phase 1: a ``GroupPlan`` is used as it is, a
``PlanCache`` skips ``group_rows`` whenever the operands' sparsity patterns
were seen before.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Literal, Optional, Union

import torch

from repro_torch.core import executor
from repro_torch.core.executor import PlanCache
from repro_torch.core.grouping import GroupPlan, group_rows
from repro_torch.sparse.formats import CSR

PlanLike = Union[GroupPlan, PlanCache, None]


@dataclasses.dataclass
class SpGEMMResult:
    """One SpGEMM product: the CSR result ``c``, the ``GroupPlan`` that
    executed it, and the ``info`` counter dict."""

    c: CSR
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
    plan: PlanLike = None,
    sizing: executor.Sizing = "auto",
) -> SpGEMMResult:
    """C = A @ B via the paper's multi-phase pipeline.

    ``engine`` picks the allocation/accumulation engine (``"sort"``, the
    default, ``"hash"`` or ``"fused_hash"``; ``method`` is the legacy
    alias).  ``gather`` picks how B's rows are served: ``"xla"`` (a plain
    take), ``"aia"`` (the AIA row-gather kernel) or ``"auto"`` (``"aia"`` on
    a CUDA device, ``"xla"`` on the CPU).  ``schedule="natural"`` turns the
    Table-I grouping off (every row at the worst-case capacity).  ``sizing``
    picks the measured lane (one coalesced read of the uniqueCounts) or the
    planned lane (sizes from the plan's Alg. 1 bounds, no read);
    ``"auto"`` is planned for ``"fused_hash"`` and measured otherwise.  The
    façade reads ``nnz`` back once, after every chunk was dispatched, to
    fill ``info``.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shapes {a.shape} and {b.shape} do not chain")
    executor.operand_device(a, b)
    if schedule not in ("grouped", "natural"):
        raise ValueError(f"unknown schedule {schedule!r}")
    engine = executor.resolve_engine(engine, method)
    plan = _resolve_plan(a, b, plan)
    run_plan = executor.ungrouped_plan(plan) if schedule == "natural" \
        else plan
    c, nnz = executor.execute_plan(a, b, run_plan, engine=engine,
                                   gather=gather, row_chunk=row_chunk,
                                   sizing=sizing)
    return SpGEMMResult(c=c, plan=run_plan,
                        info=spgemm_info(a, b, run_plan, nnz))


def spgemm_info(a: CSR, b: CSR, plan: GroupPlan, nnz_c) -> Dict[str, float]:
    """Hardware-independent counters; the three nnz values come back from
    the device in one read."""
    nnz_c = torch.as_tensor(nnz_c, device=a.device)
    nnz_a, nnz_b, nnz_c = torch.stack(
        [a.nnz.long(), b.nnz.long(), nnz_c.long()]).tolist()
    total_ip = plan.total_ip
    return {
        "nnz_a": nnz_a,
        "nnz_b": nnz_b,
        "nnz_c": nnz_c,
        "intermediate_products": int(total_ip),
        "flops": 2.0 * total_ip,  # paper's FLOP definition (§VI Methodology)
        "compression_ratio": float(total_ip) / max(nnz_c, 1),
        "group_sizes": list(plan.group_sizes),
        "max_ip": plan.max_ip,
    }
