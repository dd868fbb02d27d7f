"""The port's single-device SpGEMM path against the JAX package, on the CPU.

The same numpy-built operands go through ``repro.core.spgemm.spgemm`` and
``repro_torch.core.spgemm.spgemm`` (``device="cpu"``) with the same knobs.
``indptr`` and the occupied ``indices`` must be equal, and the values bit
for bit: integer-valued inputs make every lane exact, and on float inputs
the port keeps the reference's summation order (stream order in the hash
table, index order in the sort engine's CPU scatter-add).
"""
import functools

import numpy as np
import pytest
import torch

from repro.apps.graphs import table_ii_matrix as ref_table_ii_matrix
from repro.core import executor as ref_exec
from repro.core.spgemm import spgemm as ref_spgemm
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.apps.graphs import table_ii_matrix
from repro_torch.core import executor
from repro_torch.core.grouping import group_rows
from repro_torch.core.ref import spgemm_dense
from repro_torch.core.spgemm import spgemm
from repro_torch.kernels import ops
from repro_torch.sparse.formats import csr_from_dense, csr_to_dense

ENGINES = ("sort", "hash", "fused_hash")
GATHERS = ("xla", "aia")
SCHEDULES = ("grouped", "natural")


def int_sparse(rng, n, m, density=0.3):
    """Integer-valued float32 matrix: exact under any accumulation order."""
    x = rng.integers(-4, 5, (n, m)).astype(np.float32)
    return np.where(rng.random((n, m)) < density, x, 0.0).astype(np.float32)


def both(*dense):
    """Each dense operand as (port CSR on the CPU, reference CSR)."""
    return [(csr_from_dense(x, device="cpu"), ref_csr_from_dense(x))
            for x in dense]


def assert_same_product(got, want):
    """``got``: the port's SpGEMMResult; ``want``: the reference's."""
    nnz = want.info["nnz_c"]
    assert got.info["nnz_c"] == nnz
    np.testing.assert_array_equal(got.c.indptr.numpy(),
                                  np.asarray(want.c.indptr))
    np.testing.assert_array_equal(got.c.indices[:nnz].numpy(),
                                  np.asarray(want.c.indices)[:nnz])
    np.testing.assert_array_equal(got.c.data[:nnz].numpy(),
                                  np.asarray(want.c.data)[:nnz])
    for key in ("intermediate_products", "compression_ratio", "group_sizes",
                "max_ip", "nnz_a", "nnz_b"):
        assert got.info[key] == want.info[key], key


def grid_operands(values="int"):
    """The grid's operands; ``values="float"`` keeps their sparsity pattern
    (and so every shape the reference compiles for) with random floats."""
    rng = np.random.default_rng(7)
    xa, xb = int_sparse(rng, 18, 14, 0.25), int_sparse(rng, 14, 16, 0.35)
    if values == "float":
        xa = np.where(xa != 0, rng.standard_normal(xa.shape), 0)
        xb = np.where(xb != 0, rng.standard_normal(xb.shape), 0)
    return xa.astype(np.float32), xb.astype(np.float32)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("gather", GATHERS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_engine_gather_schedule_grid_matches_reference(engine, gather,
                                                       schedule):
    xa, xb = grid_operands()
    (a, ra), (b, rb) = both(xa, xb)
    got = spgemm(a, b, engine=engine, gather=gather, schedule=schedule)
    assert_same_product(got, ref_spgemm(ra, rb, engine=engine, gather=gather,
                                        schedule=schedule))
    np.testing.assert_array_equal(csr_to_dense(got.c).numpy(), xa @ xb)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_float_values_bit_exact(engine, schedule):
    """Random float values: the port sums every output entry in the same
    order as the reference, so the values agree bit for bit."""
    (a, ra), (b, rb) = both(*grid_operands("float"))
    assert_same_product(
        spgemm(a, b, engine=engine, schedule=schedule, row_chunk=8),
        ref_spgemm(ra, rb, engine=engine, schedule=schedule, row_chunk=8))


@functools.lru_cache(maxsize=None)
def reference_case(name):
    """(dense A, dense B, the reference's sort-engine product) for the edge
    cases below.  On their integer values every reference engine gives this
    same product (the reference's own suite holds its engines to that), so
    each case pays for one reference run and every port engine is held to
    it."""
    rng = np.random.default_rng({"zero_rows": 3, "group3": 11}[name])
    if name == "zero_rows":
        xa = int_sparse(rng, 40, 30, 0.3)
        xa[::2] = 0.0  # every other row empty
        xb = int_sparse(rng, 30, 25, 0.2)
    else:
        # row 0 of A: 128 nnz; every B row: 64 nnz -> IP(row 0) = 8192
        xa = np.zeros((4, 128), np.float32)
        xa[0] = rng.integers(1, 4, 128)
        xa[1, :3] = 1.0
        xb = np.zeros((128, 256), np.float32)
        for i in range(128):
            xb[i, rng.choice(256, 64, replace=False)] = rng.integers(1, 4, 64)
    want = ref_spgemm(ref_csr_from_dense(xa), ref_csr_from_dense(xb))
    return xa, xb, want


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_matrix(engine):
    """An all-zero A: the reference returns an all-zero indptr and nnz 0
    (its own suite checks that), so the port is held to those values."""
    rng = np.random.default_rng(0)
    a = csr_from_dense(np.zeros((6, 5), np.float32), device="cpu")
    b = csr_from_dense(int_sparse(rng, 5, 4, 0.5), device="cpu")
    got = spgemm(a, b, engine=engine, gather="aia")
    assert got.info["nnz_c"] == 0 and got.info["intermediate_products"] == 0
    np.testing.assert_array_equal(got.c.indptr.numpy(), np.zeros(7, np.int32))
    assert got.c.capacity >= 1 and got.plan.group_sizes == (6, 0, 0, 0)


@pytest.mark.parametrize("engine", ENGINES)
def test_all_zero_rows_interleaved(engine):
    xa, xb, want = reference_case("zero_rows")
    assert_same_product(spgemm(*(csr_from_dense(x, device="cpu")
                                 for x in (xa, xb)), engine=engine), want)


@pytest.mark.parametrize("engine", ENGINES)
def test_group3_row(engine):
    """A row with IP >= 8192 lands in Table-I group 3 (the global table)."""
    xa, xb, want = reference_case("group3")
    got = spgemm(*(csr_from_dense(x, device="cpu") for x in (xa, xb)),
                 engine=engine)
    assert got.plan.group_sizes[3] == 1
    assert got.plan.table_capacities[3] == 8192
    assert_same_product(got, want)


@pytest.mark.parametrize("engine", ENGINES)
def test_row_chunking_matches_reference(engine):
    xa, xb, want = reference_case("zero_rows")
    a, b = (csr_from_dense(x, device="cpu") for x in (xa, xb))
    got = spgemm(a, b, engine=engine, row_chunk=8)
    assert_same_product(got, want)
    assert_same_product(spgemm(a, b, engine=engine), got)


def test_fused_lane_against_reference_pallas_kernel(monkeypatch):
    """REPRO_KERNEL_BACKEND=interpret makes the reference's fused lane run
    its Pallas Algorithm-4 kernel; the port's fused lane matches it."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    assert ref_exec._fused_kernel_mode(np.dtype(np.float32).str) == "interpret"
    rng = np.random.default_rng(7)
    x = np.where(rng.random((12, 12)) < 0.3,
                 rng.standard_normal((12, 12)), 0).astype(np.float32)
    ((a, ra),) = both(x)
    assert_same_product(spgemm(a, a, engine="fused_hash"),
                        ref_spgemm(ra, ra, engine="fused_hash"))


def test_table_ii_self_product_matches_reference():
    """The slice as a whole on a Table II stand-in, from its generator.
    Every engine sums each output entry in stream order (the sort engine's
    stable sort keeps it), so all of them match the reference's default."""
    a = table_ii_matrix("p2p-Gnutella04", seed=0, n_override=200, device="cpu")
    ra = ref_table_ii_matrix("p2p-Gnutella04", seed=0, n_override=200)
    want = ref_spgemm(ra, ra)
    assert_same_product(spgemm(a, a), want)
    assert_same_product(spgemm(a, a, engine="fused_hash", gather="aia"), want)
    np.testing.assert_allclose(csr_to_dense(spgemm(a, a).c).numpy(),
                               spgemm_dense(a, a).numpy(), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Sync structure, plans, devices
# ---------------------------------------------------------------------------

def test_host_syncs_planned_zero_measured_one():
    rng = np.random.default_rng(2)
    a = csr_from_dense(int_sparse(rng, 40, 40, 0.2), device="cpu")
    for engine, sizing, syncs in (("fused_hash", "auto", 0),
                                  ("fused_hash", "measured", 1),
                                  ("hash", "auto", 1), ("sort", "auto", 1),
                                  ("sort", "planned", 0)):
        executor.clear_program_cache()
        res = spgemm(a, a, engine=engine, sizing=sizing, row_chunk=8)
        assert executor.cache_stats()["host_sync_count"] == syncs, engine
        assert len(res.plan.map_rows) == 40


def test_planned_returns_device_nnz_and_matches_measured():
    rng = np.random.default_rng(8)
    a = csr_from_dense(int_sparse(rng, 20, 20, 0.3), device="cpu")
    plan = group_rows(a, a)
    c_p, nnz_p = executor.execute_plan(a, a, plan, engine="fused_hash")
    c_m, nnz_m = executor.execute_plan(a, a, plan, engine="fused_hash",
                                       sizing="measured")
    assert isinstance(nnz_p, torch.Tensor) and nnz_p.dim() == 0
    assert isinstance(nnz_m, int) and int(nnz_p) == nnz_m
    assert c_p.capacity >= nnz_m and c_m.capacity >= nnz_m
    torch.testing.assert_close(c_p.indptr, c_m.indptr, rtol=0, atol=0)
    for x, y in ((c_p.indices, c_m.indices), (c_p.data, c_m.data)):
        torch.testing.assert_close(x[:nnz_m], y[:nnz_m], rtol=0, atol=0)
    assert c_p.indptr.dtype == c_p.indices.dtype == torch.int32


def test_plan_reuse_and_cache():
    rng = np.random.default_rng(9)
    pattern = rng.random((16, 16)) < 0.3
    xs = [np.where(pattern, rng.integers(1, 5, (16, 16)), 0).astype(np.float32)
          for _ in range(2)]
    a1, a2 = (csr_from_dense(x, device="cpu") for x in xs)
    executor.clear_program_cache()
    cache = executor.PlanCache()
    r1 = spgemm(a1, a1, plan=cache)
    r2 = spgemm(a2, a2, plan=cache)
    assert r1.plan is r2.plan
    assert executor.cache_stats()["plan_hits"] == 1
    r3 = spgemm(a2, a2, plan=r1.plan, engine="hash")
    np.testing.assert_array_equal(csr_to_dense(r3.c).numpy(), xs[1] @ xs[1])
    with pytest.raises(TypeError, match="plan must be"):
        spgemm(a1, a1, plan="cached")


def test_knobs_and_devices_are_checked():
    a = csr_from_dense(np.eye(4, dtype=np.float32), device="cpu")
    b = csr_from_dense(np.eye(5, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="do not chain"):
        spgemm(a, b)
    with pytest.raises(ValueError, match="unknown schedule"):
        spgemm(a, a, schedule="shuffled")
    with pytest.raises(ValueError, match="unknown engine"):
        spgemm(a, a, engine="osrt")
    on_meta = csr_from_dense(np.eye(4, dtype=np.float32), device="meta")
    with pytest.raises(ValueError, match="is on"):
        spgemm(a, on_meta)


def test_cpu_path_launches_no_kernel():
    ops.reset_launch_counts()
    a = csr_from_dense(np.eye(6, dtype=np.float32), device="cpu")
    spgemm(a, a, engine="fused_hash", gather="aia")
    counts = ops.launch_counts()
    assert {"gather_rows", "hash_accumulate"} <= set(counts)
    assert all(n == 0 for n in counts.values())
