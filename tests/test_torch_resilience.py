"""The port's resilience layer against the JAX package's, on the CPU: the
capacity, budget, degradation, ``gather_fail``, ``stage_tile_fail`` and
int32-capacity cases of ``tests/test_resilience.py`` (its serving cases
are in ``tests/test_torch_serve.py``; its trainer cases are ROADMAP Queue A
item 12).

Both packages multiply the same numpy-built small-integer matrices, so
every recovered product is held bit for bit against the clean call and the
reference's; the recovery counters (``capacity_retries``,
``budget_degradations``) and the derived ``tile_rows`` equal the
reference's.
"""
import numpy as np
import pytest

from repro.core import executor as ref_executor
from repro.core import faults as ref_faults
from repro.core.spgemm import spgemm as ref_spgemm
from repro.core.spgemm import spgemm_batched as ref_spgemm_batched
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.apps.markov_clustering import mcl
from repro_torch.core import executor, faults
from repro_torch.core.spgemm import spgemm, spgemm_batched, spgemm_streamed
from repro_torch.sparse.formats import csr_from_dense


def int_sparse(rng, n, m, density=0.3):
    """Small-integer sparse block: float32-exact products."""
    x = rng.integers(-4, 5, (n, m)).astype(np.float32)
    mask = rng.random((n, m)) < density
    return np.where(mask, x, 0.0).astype(np.float32)


def _pair(seed=7, n=96, k=64, m=80, density=0.25):
    """(A, B) in the port and in the reference, the same arrays."""
    rng = np.random.default_rng(seed)
    da, db = int_sparse(rng, n, k, density), int_sparse(rng, k, m, density)
    return ((csr_from_dense(da, device="cpu"), csr_from_dense(db, device="cpu")),
            (ref_csr_from_dense(da), ref_csr_from_dense(db)))


def assert_bit_exact(got, want):
    """``got`` (a port CSR) equals ``want`` (a port or reference CSR) over
    the ``indptr``-addressed prefix, bit for bit."""
    def host(x):
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x)

    ipt = host(want.indptr)
    np.testing.assert_array_equal(got.indptr.numpy(), ipt)
    nnz = int(ipt[-1])
    np.testing.assert_array_equal(got.indices[:nnz].numpy(),
                                  host(want.indices)[:nnz])
    np.testing.assert_array_equal(got.data[:nnz].numpy(),
                                  host(want.data)[:nnz])


def delta(ex, key, before):
    return ex.cache_stats()[key] - before[key]


@pytest.fixture(autouse=True)
def _clean_state():
    executor.clear_program_cache()
    for ex in (executor, ref_executor):
        ex.set_device_budget(None)
    yield
    for ex in (executor, ref_executor):
        ex.set_device_budget(None)


# ---------------------------------------------------------------------------
# the three points are registered, with the reference's harness semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["capacity_undersize", "gather_fail",
                                  "stage_tile_fail"])
def test_points_registered_with_schedules(name):
    assert name in faults.FAULT_POINTS and name in ref_faults.FAULT_POINTS
    with faults.fault_injection(name, on_hit=2, times=2):
        assert not faults.trigger(name)   # hit 1: before on_hit
        assert faults.trigger(name)       # hit 2: fires
        assert faults.trigger(name)       # hit 3: times=2
        assert not faults.trigger(name)   # exhausted
    assert not faults.armed(name)
    assert not faults.trigger(name)       # disarmed: never fires
    with pytest.raises(faults.FaultInjected):
        with faults.fault_injection(name):
            faults.fire(name)
    assert not faults.armed(name)


# ---------------------------------------------------------------------------
# capacity detect-and-retry (planned lane)
# ---------------------------------------------------------------------------

def test_capacity_retry_bit_exact_vs_measured():
    (a, b), (ra, rb) = _pair()
    ref = spgemm(a, b, engine="fused_hash", sizing="measured")
    before, ref_before = executor.cache_stats(), ref_executor.cache_stats()
    with faults.fault_injection("capacity_undersize") as fault:
        res = spgemm(a, b, engine="fused_hash", sizing="planned")
    with ref_faults.fault_injection("capacity_undersize"):
        want = ref_spgemm(ra, rb, engine="fused_hash", sizing="planned")
    assert fault.triggers == 1
    assert delta(executor, "capacity_retries", before) == 1 \
        == delta(ref_executor, "capacity_retries", ref_before)
    assert_bit_exact(res.c, ref.c)
    assert_bit_exact(res.c, want.c)


def test_capacity_retry_on_the_sort_engine():
    """The planned lane on a non-fused engine retries the same way."""
    (a, b), _ = _pair(seed=5)
    ref = spgemm(a, b, engine="sort", sizing="measured")
    before = executor.cache_stats()
    with faults.fault_injection("capacity_undersize"):
        res = spgemm(a, b, engine="sort", sizing="planned")
    assert delta(executor, "capacity_retries", before) == 1
    assert_bit_exact(res.c, ref.c)


def test_capacity_clean_path_no_retries_no_syncs():
    (a, b), _ = _pair()
    spgemm(a, b, engine="fused_hash", sizing="planned")  # warm caches
    before = executor.cache_stats()
    res = spgemm(a, b, engine="fused_hash", sizing="planned")
    assert delta(executor, "capacity_retries", before) == 0
    assert delta(executor, "host_sync_count", before) == 0
    assert_bit_exact(res.c, spgemm(a, b, engine="fused_hash",
                                   sizing="measured").c)


def test_capacity_retry_batched_lane_bit_exact():
    rng = np.random.default_rng(11)
    mask = rng.random((72, 72)) < 0.2
    dense = [np.where(mask, rng.integers(1, 5, mask.shape), 0.0)
             .astype(np.float32) for _ in range(3)]
    bs = [csr_from_dense(d, device="cpu") for d in dense]
    rbs = [ref_csr_from_dense(d) for d in dense]
    refs = [spgemm(bm, bm, engine="fused_hash", sizing="measured").c
            for bm in bs]
    before, ref_before = executor.cache_stats(), ref_executor.cache_stats()
    with faults.fault_injection("capacity_undersize"):
        res = spgemm_batched(bs, bs, engine="fused_hash", sizing="planned")
    with ref_faults.fault_injection("capacity_undersize"):
        want = ref_spgemm_batched(rbs, rbs, engine="fused_hash",
                                  sizing="planned")
    assert delta(executor, "capacity_retries", before) == 1 \
        == delta(ref_executor, "capacity_retries", ref_before)
    for got, ref, w in zip(res.cs, refs, want.cs):
        assert_bit_exact(got, ref)
        assert_bit_exact(got, w)


# ---------------------------------------------------------------------------
# on_budget graceful degradation
# ---------------------------------------------------------------------------

def test_resolve_on_budget_validates():
    for ex in (executor, ref_executor):
        assert ex.resolve_on_budget("error") == "error"
        assert ex.resolve_on_budget("stream") == "stream"
        with pytest.raises(ValueError, match="on_budget"):
            ex.resolve_on_budget("retry")
    (a, b), _ = _pair()
    with pytest.raises(ValueError, match="on_budget"):
        spgemm(a, b, on_budget="explode")


def test_on_budget_stream_degrades_bit_exact():
    (a, b), (ra, rb) = _pair(n=128)
    ref = spgemm(a, b)
    need = executor.estimated_device_bytes(ref.plan, 4)
    for ex in (executor, ref_executor):
        ex.set_device_budget(need // 3)
    with pytest.raises(executor.DeviceBudgetExceeded):
        spgemm(a, b)  # on_budget="error" by default
    before, ref_before = executor.cache_stats(), ref_executor.cache_stats()
    res = spgemm(a, b, on_budget="stream")
    want = ref_spgemm(ra, rb, on_budget="stream")
    assert delta(executor, "budget_degradations", before) == 1 \
        == delta(ref_executor, "budget_degradations", ref_before)
    assert res.info["degraded_to_stream"] == 1
    assert res.info["n_tiles"] > 1
    for key in ("n_tiles", "tile_rows", "max_tile_ip"):
        assert res.info[key] == want.info[key], key
    assert_bit_exact(res.c, ref.c)
    assert_bit_exact(res.c, want.c)


def test_on_budget_stream_inert_under_budget():
    (a, b), _ = _pair()
    ref = spgemm(a, b)
    executor.set_device_budget(
        executor.estimated_device_bytes(ref.plan, 4) * 2)
    before = executor.cache_stats()
    res = spgemm(a, b, on_budget="stream")
    assert delta(executor, "budget_degradations", before) == 0
    assert "degraded_to_stream" not in res.info
    assert_bit_exact(res.c, ref.c)


def test_degradation_tile_rows_single_row_too_big_raises():
    (a, b), (ra, rb) = _pair()
    plan, ref_plan = spgemm(a, b).plan, ref_spgemm(ra, rb).plan
    budget = executor.estimated_device_bytes(plan, 4) // 5
    for ex in (executor, ref_executor):
        ex.set_device_budget(budget)
    assert executor.derive_degradation_tile_rows(plan, a.n_rows, 4) == \
        ref_executor.derive_degradation_tile_rows(ref_plan, ra.n_rows, 4)
    executor.set_device_budget(1)  # below any row's estimate
    with pytest.raises(executor.DeviceBudgetExceeded, match="single row"):
        executor.derive_degradation_tile_rows(plan, a.n_rows, 4)
    executor.set_device_budget(None)
    with pytest.raises(ValueError, match="budget"):
        executor.derive_degradation_tile_rows(plan, a.n_rows, 4)


def test_mcl_threads_on_budget():
    rng = np.random.default_rng(5)
    g = csr_from_dense(np.where(rng.random((64, 64)) < 0.08,
                                rng.integers(1, 5, (64, 64)), 0)
                       .astype(np.float32), device="cpu")
    mref = mcl(g, e=2, max_iters=2, tol=0.0)
    lo = max(i["max_ip"] for i in mref.spgemm_info) * 8
    hi = min(i["intermediate_products"] for i in mref.spgemm_info) * 8
    assert lo < hi, "graph too small to separate worst-row from total"
    executor.set_device_budget((lo + hi) // 2)
    with pytest.raises(executor.DeviceBudgetExceeded):
        mcl(g, e=2, max_iters=2, tol=0.0)
    before = executor.cache_stats()
    mdeg = mcl(g, e=2, max_iters=2, tol=0.0, on_budget="stream")
    assert delta(executor, "budget_degradations", before) >= 1
    assert_bit_exact(mdeg.matrix, mref.matrix)
    np.testing.assert_array_equal(mdeg.clusters, mref.clusters)
    with pytest.raises(ValueError, match="on_budget"):
        mcl(g, on_budget="panic")


# ---------------------------------------------------------------------------
# transient-site recovery: B's placement and tile staging
# ---------------------------------------------------------------------------

def test_gather_fail_recovered_bit_exact():
    (a, b), (ra, rb) = _pair(seed=9)
    ref = spgemm(a, b)
    with faults.fault_injection("gather_fail") as fault:
        res = spgemm(a, b)
    assert fault.triggers == 1
    assert_bit_exact(res.c, ref.c)
    assert_bit_exact(res.c, ref_spgemm(ra, rb).c)


def test_stage_tile_fail_recovered_bit_exact():
    (a, b), (ra, rb) = _pair(seed=13, n=128)
    ref = spgemm(a, b)
    with faults.fault_injection("stage_tile_fail", on_hit=2) as fault:
        res = spgemm_streamed(a, b, tile_rows=32)
    assert fault.triggers == 1 and fault.hits == 4  # one hit a tile
    assert_bit_exact(res.c, ref.c)
    assert_bit_exact(res.c, ref_spgemm(ra, rb).c)


# ---------------------------------------------------------------------------
# int32 capacity boundary and the budget error's detail
# ---------------------------------------------------------------------------

def test_int32_nnz_capacity_boundaries():
    for ex in (executor, ref_executor):
        assert ex._int32_nnz_capacity(0) == 1
        assert ex._int32_nnz_capacity(5) == 8
        assert ex._int32_nnz_capacity(ex._INT32_MAX) == ex._INT32_MAX
        with pytest.raises(OverflowError):
            ex._int32_nnz_capacity(ex._INT32_MAX + 1)


def test_device_budget_error_names_total_ip():
    (a, b), _ = _pair()
    plan = spgemm(a, b).plan
    executor.set_device_budget(8)
    with pytest.raises(executor.DeviceBudgetExceeded,
                       match=str(plan.total_ip)):
        spgemm(a, b)
