"""The port's streamed (out-of-core) lane against the JAX package's, on the
CPU: the single-device cases of ``tests/test_streaming.py``.

Both packages multiply the same numpy-built small-integer matrices (float32
products and sums exact), so every result is held bit for bit: the
streamed product against the port's monolithic ``spgemm`` and against the
reference's ``spgemm_streamed``, over the ``indptr``-addressed prefix
(the monolithic lanes may pad their buffers).  Tile counts, ``PlanCache``
hits and misses and the ``cache_stats()`` stream counters equal the
reference's.  The reference's mesh case runs here on logical CPU shards,
against its ``mesh=None`` lane (the reference's own suite holds its
sharded lanes to that).
"""
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core.spgemm import PlanCache as RefPlanCache
from repro.core.spgemm import spgemm_streamed as ref_spgemm_streamed
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.apps.graphs import rmat_graph
from repro_torch.apps.markov_clustering import mcl
from repro_torch.core import executor
from repro_torch.core.grouping import group_rows
from repro_torch.core.spgemm import PlanCache, spgemm, spgemm_streamed
from repro_torch.sparse.formats import csr_from_dense, csr_to_dense


def int_sparse(rng, n, m, density=0.3):
    """Small-integer sparse block: float32-exact products."""
    x = rng.integers(-4, 5, (n, m)).astype(np.float32)
    mask = rng.random((n, m)) < density
    return np.where(mask, x, 0.0).astype(np.float32)


def both(dense):
    return csr_from_dense(dense, device="cpu"), ref_csr_from_dense(dense)


def _pair(seed=7, n=150, k=64, m=90, density=0.25):
    """(A, B) in the port and (A, B) in the reference, the same arrays."""
    rng = np.random.default_rng(seed)
    (a, ra), (b, rb) = both(int_sparse(rng, n, k, density)), \
        both(int_sparse(rng, k, m, density))
    return (a, b), (ra, rb)


def assert_bit_exact(got, want):
    """The occupied prefix of ``got`` (a port CSR) equals ``want`` (a port
    or reference CSR) bit for bit."""
    ipt = np.asarray(want.indptr.numpy() if hasattr(want.indptr, "numpy")
                     else want.indptr)
    np.testing.assert_array_equal(got.indptr.numpy(), ipt)
    nnz = int(ipt[-1])

    def host(x):
        return np.asarray(x.numpy() if hasattr(x, "numpy") else x)[:nnz]

    np.testing.assert_array_equal(host(got.indices), host(want.indices))
    np.testing.assert_array_equal(host(got.data), host(want.data))


def check_streamed(pair, ref_pair, **kw):
    """The port's streamed product against its monolithic one and the
    reference's streamed one; returns the port's result."""
    mono_kw = {k: v for k, v in kw.items()
               if k not in ("tile_rows", "prefetch")}
    res = spgemm_streamed(*pair, **kw)
    want = ref_spgemm_streamed(*ref_pair, **kw)
    assert_bit_exact(res.c, spgemm(*pair, **mono_kw).c)
    assert_bit_exact(res.c, want.c)
    for key in ("n_tiles", "tile_rows", "prefetch", "max_tile_ip",
                "total_ip", "nnz_c", "intermediate_products"):
        assert res.info[key] == want.info[key], key
    return res


@pytest.fixture(autouse=True)
def _clean_state():
    executor.clear_program_cache()  # the reference keeps its programs
    for ex in (executor, ref_executor):
        ex.set_device_budget(None)
    yield
    for ex in (executor, ref_executor):
        ex.set_device_budget(None)


# ---------------------------------------------------------------------------
# bit-exactness grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sort", "hash", "fused_hash"])
@pytest.mark.parametrize("pipeline", ["two_wave", "legacy"])
def test_streamed_bit_exact_engine_pipeline(engine, pipeline):
    pair, ref_pair = _pair()
    res = check_streamed(pair, ref_pair, tile_rows=48, engine=engine,
                         pipeline=pipeline)
    assert res.info["n_tiles"] == 4  # ceil(150 / 48)
    a, b = pair
    np.testing.assert_array_equal(
        csr_to_dense(res.c).numpy(),
        csr_to_dense(a).numpy() @ csr_to_dense(b).numpy())


@pytest.mark.parametrize("n_shards", [2, 4])
def test_streamed_bit_exact_under_mesh(n_shards):
    """``tests/test_streaming.py``'s mesh case on logical CPU shards: the
    streamed product under the mesh against the monolithic product under
    it, the port's ``mesh=None`` one and the reference's ``mesh=None``
    streamed one."""
    pair, ref_pair = _pair()
    mesh = [torch.device("cpu")] * n_shards
    res = check_streamed(pair, ref_pair, tile_rows=48)
    sharded = spgemm_streamed(*pair, tile_rows=48, mesh=mesh)
    assert_bit_exact(sharded.c, res.c)
    assert_bit_exact(sharded.c, spgemm(*pair, mesh=mesh).c)
    assert sharded.info["n_shards"] == n_shards
    assert sharded.info["n_tiles"] == res.info["n_tiles"] == 4


@pytest.mark.parametrize("gather", ["xla", "aia"])
def test_streamed_bit_exact_gather(gather):
    pair, ref_pair = _pair()
    check_streamed(pair, ref_pair, tile_rows=40, gather=gather)


def test_streamed_natural_schedule_matches():
    pair, ref_pair = _pair()
    check_streamed(pair, ref_pair, tile_rows=64, schedule="natural")


@pytest.mark.parametrize("sizing", ["planned", "measured"])
def test_streamed_sizing_matches(sizing):
    pair, ref_pair = _pair()
    check_streamed(pair, ref_pair, tile_rows=48, engine="fused_hash",
                   sizing=sizing)


# ---------------------------------------------------------------------------
# tile-boundary edges
# ---------------------------------------------------------------------------

def test_tile_ranges_shapes():
    for n, t in ((10, 4), (8, 4), (3, 100), (0, 4)):
        assert executor.tile_ranges(n, t) == ref_executor.tile_ranges(n, t)
    assert executor.tile_ranges(10, 4) == [(0, 4), (4, 8), (8, 10)]
    assert executor.tile_ranges(0, 4) == []


def test_tile_rows_ge_n_rows_collapses_to_single_tile():
    pair, ref_pair = _pair()
    res = check_streamed(pair, ref_pair, tile_rows=4096)
    assert res.info["n_tiles"] == 1


def test_empty_tiles_merge_correctly():
    # rows 40..119 all zero: the middle tiles plan to total_ip == 0 and
    # contribute empty segments without dispatching anything
    rng = np.random.default_rng(21)
    dense = int_sparse(rng, 160, 64, 0.25)
    dense[40:120] = 0.0
    (a, ra), (b, rb) = both(dense), both(int_sparse(rng, 64, 90, 0.25))
    res = check_streamed((a, b), (ra, rb), tile_rows=40)
    assert res.info["n_tiles"] == 4


def test_ragged_last_tile():
    pair, ref_pair = _pair()
    res = check_streamed(pair, ref_pair, tile_rows=64)  # 64+64+22
    assert res.info["n_tiles"] == 3


# ---------------------------------------------------------------------------
# plan reuse across repeated tiles
# ---------------------------------------------------------------------------

def test_plan_cache_hits_across_repeated_streams():
    pair, ref_pair = _pair()
    cache, ref_cache = PlanCache(), RefPlanCache()
    for _ in range(2):
        spgemm_streamed(*pair, tile_rows=48, plan=cache)
        ref_spgemm_streamed(*ref_pair, tile_rows=48, plan=ref_cache)
        assert (cache.hits, cache.misses) == (ref_cache.hits,
                                              ref_cache.misses)
    assert (cache.hits, cache.misses) == (4, 4)  # every tile re-served


def test_tile_plan_fingerprint_is_device_independent():
    """A tile's plan is keyed on its host slices: the same tile built
    directly from its rows hits the entry the streamed lane left."""
    (a, b), _ = _pair()
    cache = PlanCache()
    spgemm_streamed(a, b, tile_rows=48, plan=cache)
    tile = csr_from_dense(csr_to_dense(a)[48:96], device="cpu")
    plan = cache.plan_for(tile, b)
    assert cache.hits == 1
    assert plan.total_ip == group_rows(tile, b).total_ip


def test_streamed_rejects_non_plancache_plan():
    (a, b), (ra, rb) = _pair(seed=2, n=40)
    for stream, x, y in ((spgemm_streamed, a, b),
                         (ref_spgemm_streamed, ra, rb)):
        with pytest.raises(TypeError):
            stream(x, y, tile_rows=16, plan=object())


# ---------------------------------------------------------------------------
# knob validation
# ---------------------------------------------------------------------------

def test_resolve_tile_rows():
    for ex in (executor, ref_executor):
        assert ex.resolve_tile_rows(None) == ex.DEFAULT_TILE_ROWS == 4096
        assert ex.resolve_tile_rows(128) == 128
        for bad in (0, -1, 1.5, "64", True):
            with pytest.raises(ValueError):
                ex.resolve_tile_rows(bad)


def test_resolve_prefetch():
    for ex in (executor, ref_executor):
        assert ex.resolve_prefetch(None) == ex.DEFAULT_PREFETCH == 2
        assert ex.resolve_prefetch(1) == 1
        for bad in (0, -3, 2.0, "2", False):
            with pytest.raises(ValueError):
                ex.resolve_prefetch(bad)


def test_spgemm_streamed_validates_knobs_up_front():
    (a, b), _ = _pair(seed=2, n=40)
    with pytest.raises(ValueError):
        spgemm_streamed(a, b, tile_rows=0)
    with pytest.raises(ValueError):
        spgemm_streamed(a, b, prefetch=0)
    with pytest.raises(TypeError, match="a mesh is"):
        spgemm_streamed(a, b, mesh=object())


# ---------------------------------------------------------------------------
# device budget
# ---------------------------------------------------------------------------

def test_estimated_device_bytes_formula():
    (a, b), (ra, rb) = _pair(seed=23, n=50)
    from repro.core.grouping import group_rows as ref_group_rows
    plan, ref_plan = group_rows(a, b), ref_group_rows(ra, rb)
    assert plan.total_ip == ref_plan.total_ip
    assert executor.estimated_device_bytes(plan, 4) == plan.total_ip * 8 \
        == ref_executor.estimated_device_bytes(ref_plan, 4)


def test_budget_rejects_monolithic_but_streamed_fits():
    pair, _ = _pair(seed=29)
    mono = spgemm(*pair)  # unbudgeted
    whole_ip = int(group_rows(*pair).total_ip)
    max_tile_ip = int(spgemm_streamed(*pair, tile_rows=16)
                      .info["max_tile_ip"])
    budget = (max_tile_ip * 8) + ((whole_ip * 8 - max_tile_ip * 8) // 2)
    assert max_tile_ip * 8 < budget < whole_ip * 8
    executor.set_device_budget(budget)
    assert executor.device_budget() == budget
    with pytest.raises(executor.DeviceBudgetExceeded):
        spgemm(*pair)
    res = spgemm_streamed(*pair, tile_rows=16)
    assert_bit_exact(res.c, mono.c)
    executor.set_device_budget(None)
    assert executor.device_budget() is None


def test_over_memory_mcl_completes_bit_exactly():
    """A graph whose monolithic expansion exceeds the budget still
    clusters, bit for bit (the port's monolithic MCL is held against the
    reference's in ``tests/test_torch_apps.py``; the reference's MCL at
    this size takes over a minute on the CPU)."""
    g = rmat_graph(128, 8.0, seed=4, device="cpu")
    ref = mcl(g, max_iters=4)
    free = mcl(g, max_iters=4, stream=16)
    whole_ip = max(int(i["intermediate_products"]) for i in ref.spgemm_info)
    max_tile_ip = max(int(i["max_tile_ip"]) for i in free.spgemm_info)
    assert max_tile_ip * 8 < whole_ip * 8
    budget = (max_tile_ip * 8 + whole_ip * 8) // 2
    executor.set_device_budget(budget)
    with pytest.raises(executor.DeviceBudgetExceeded):
        mcl(g, max_iters=4)
    res = mcl(g, max_iters=4, stream=16)
    np.testing.assert_array_equal(res.clusters, ref.clusters)
    assert_bit_exact(res.matrix, ref.matrix)
    assert res.n_iterations == ref.n_iterations
    assert all(int(i["n_tiles"]) == 8 for i in res.spgemm_info)


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefetch", [1, 2, 3])
def test_stream_counters_match_reference(prefetch):
    pair, ref_pair = _pair()
    ref_executor.clear_program_cache()
    assert all(executor.cache_stats()[k] == 0 for k in (
        "tiles_streamed", "tile_bytes_h2d", "prefetch_overlap_hits"))
    spgemm_streamed(*pair, tile_rows=48, prefetch=prefetch)
    ref_spgemm_streamed(*ref_pair, tile_rows=48, prefetch=prefetch)
    got, want = executor.cache_stats(), ref_executor.cache_stats()
    for key in ("tiles_streamed", "tile_bytes_h2d", "prefetch_overlap_hits"):
        assert got[key] == want[key], key
    assert got["tiles_streamed"] == 4
    # every tile after the first was staged while a prior tile computed
    assert got["prefetch_overlap_hits"] == (0 if prefetch == 1 else 3)
    assert got["tile_bytes_h2d"] >= int(pair[0].nnz) * 8
    executor.clear_program_cache()
    assert executor.cache_stats()["tiles_streamed"] == 0
