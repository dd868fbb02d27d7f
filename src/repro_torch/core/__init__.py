"""The paper's hash-based multi-phase SpGEMM.

Phases: Algorithm 1 IP counting + Table-I grouping (``grouping``), then
allocation and accumulation per group-chunk (``phases``, dispatched by
``executor`` on one device or on a mesh's shards).  ``spgemm.spgemm`` is
the public entry point, re-exported here with the names
``repro.core`` exports; ``spgemm_bsr`` is the block-CSR x dense product of
the sparse-activation path.
"""
from repro_torch.core.ip_count import (
    intermediate_products, ip_histogram, total_intermediate_products)
from repro_torch.core.grouping import GroupPlan, TABLE_I, group_rows
from repro_torch.core.executor import (
    DeviceBudgetExceeded, Engine, OperandCache, PlanCache,
    available_engines, cache_stats, chunk_capacity_bounds,
    clear_program_cache, device_budget, estimated_device_bytes,
    execute_plan, execute_plan_streamed, get_engine, register_engine,
    resolve_gather, resolve_operands, resolve_prefetch, resolve_sizing,
    resolve_tile_rows, set_device_budget, tile_ranges,
)
from repro_torch.core.spgemm import (
    SpGEMMResult, SpGEMMStreamResult, spgemm, spgemm_info, spgemm_streamed,
)
from repro_torch.core.spgemm_bsr import bsr_spgemm_dense_rhs

__all__ = [
    "intermediate_products", "ip_histogram", "total_intermediate_products",
    "group_rows", "GroupPlan", "TABLE_I",
    "Engine", "register_engine", "get_engine", "available_engines",
    "execute_plan", "resolve_gather", "resolve_operands", "resolve_sizing",
    "chunk_capacity_bounds", "cache_stats", "clear_program_cache",
    "OperandCache", "PlanCache",
    "execute_plan_streamed", "tile_ranges", "resolve_tile_rows",
    "resolve_prefetch", "set_device_budget", "device_budget",
    "estimated_device_bytes", "DeviceBudgetExceeded",
    "spgemm", "spgemm_info", "SpGEMMResult",
    "spgemm_streamed", "SpGEMMStreamResult",
    "bsr_spgemm_dense_rhs",
]
