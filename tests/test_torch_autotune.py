"""The port's ``engine="auto"`` (per-bin dispatch, ``AutotuneCache``,
``bin_subplan``, ``measure_group_engine``) against the JAX package, on the
CPU.

The caches' logic is held against the reference's under one stub
``measure`` (the same timings give the same assignments, hits and misses);
products are held bit for bit against the reference's on the same
numpy-built float operands (on the CPU every engine of the port sums in the
reference's order, so every per-bin assignment gives the reference's
product).
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.core import executor as ref_exec
from repro.core.grouping import group_rows as ref_group_rows
from repro.core.spgemm import spgemm as ref_spgemm
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.core import executor
from repro_torch.core.grouping import group_rows
from repro_torch.core.spgemm import spgemm
from repro_torch.sparse.formats import csr_from_dense


def float_on(pattern, rng):
    return np.where(pattern, rng.standard_normal(pattern.shape),
                    0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def dense_operands():
    """A and B (dense float32) whose product fills Table-I groups 0-2 on
    short streams (B's rows 0-3 hold 2 entries, rows 4-15 hold 44)."""
    rng = np.random.default_rng(5)
    pb = np.zeros((16, 48), bool)
    for i in range(16):
        pb[i, rng.choice(48, 2 if i < 4 else 44, replace=False)] = True
    pa = np.zeros((24, 16), bool)
    pa[np.arange(8), rng.integers(0, 4, 8)] = True
    for i in range(8, 20):
        pa[i, 4 + rng.choice(12, 3, replace=False)] = True
    pa[20:] = True
    return float_on(pa, rng), float_on(pb, rng)


def port_operands():
    xa, xb = dense_operands()
    return csr_from_dense(xa, device="cpu"), csr_from_dense(xb, device="cpu")


@functools.lru_cache(maxsize=None)
def reference_product():
    """(indptr, occupied indices, values) of the reference's default
    product of ``dense_operands``."""
    xa, xb = dense_operands()
    res = ref_spgemm(ref_csr_from_dense(xa), ref_csr_from_dense(xb),
                     row_chunk=8)
    nnz = res.info["nnz_c"]
    return (np.asarray(res.c.indptr), np.asarray(res.c.indices)[:nnz],
            np.asarray(res.c.data)[:nnz])


def assert_reference_product(c):
    indptr, indices, data = reference_product()
    nnz = len(indices)
    np.testing.assert_array_equal(c.indptr.numpy(), indptr)
    np.testing.assert_array_equal(c.indices[:nnz].numpy(), indices)
    np.testing.assert_array_equal(c.data[:nnz].numpy(), data)


def stub_measure(timings=None, calls=None):
    """measure(group, engine): record the call, serve canned µs."""
    def measure(group, engine):
        if calls is not None:
            calls.append((group, engine))
        return 100.0 if timings is None else timings[(group, engine)]
    return measure


# ---------------------------------------------------------------------------
# Knob resolution
# ---------------------------------------------------------------------------

def test_resolve_engine_matches_reference():
    for name in (None, "auto", *executor.available_engines()):
        assert executor.resolve_engine(name) == ref_exec.resolve_engine(name)
    assert executor.resolve_engine(None, method="hash") == "hash"
    assert executor.available_engines() == ref_exec.available_engines()
    for mod in (executor, ref_exec):
        with pytest.raises(ValueError) as e:
            mod.resolve_engine("osrt")
        assert "auto" in str(e.value) and "fused_hash" in str(e.value)
        with pytest.raises(ValueError, match="conflicting method"):
            mod.resolve_engine("sort", method="hash")


def test_static_bin_engines_by_device_type():
    """The CPU seed is the reference's off-TPU seed; the CUDA seed is the
    port's choice (the fused lane, as the reference seeds its TPU)."""
    assert executor.static_bin_engines("cpu") \
        == ref_exec.static_bin_engines("cpu") == ("sort",) * 4
    assert executor.static_bin_engines("cuda") \
        == ref_exec.static_bin_engines("tpu") == ("fused_hash",) * 4


def test_resolve_sizing_and_engines_in_use_match_reference():
    a, b = port_operands()
    plan = group_rows(a, b)
    fused = ("fused_hash",) * 4
    one_sort = list(fused)
    one_sort[next(g for g in range(4) if plan.group_sizes[g] > 0)] = "sort"
    for ge in (fused, tuple(one_sort), None):
        for sizing in ("auto", "measured"):
            engine = "auto" if ge else "fused_hash"
            assert executor.resolve_sizing(sizing, engine, plan, ge) \
                == ref_exec.resolve_sizing(sizing, engine, plan, ge)
        assert executor._engines_in_use("sort", plan, ge) \
            == ref_exec._engines_in_use("sort", plan, ge)
    assert executor.resolve_sizing("auto", "auto", plan, fused) == "planned"
    assert executor.resolve_sizing("auto", "auto", plan,
                                   tuple(one_sort)) == "measured"


# ---------------------------------------------------------------------------
# AutotuneCache: the reference's bars under one stub measure
# ---------------------------------------------------------------------------

def both_plans():
    xa, xb = dense_operands()
    a, b = port_operands()
    ra, rb = ref_csr_from_dense(xa), ref_csr_from_dense(xb)
    return (a, b, group_rows(a, b)), (ra, rb, ref_group_rows(ra, rb))


def test_autotune_argmin_and_rounds_match_reference():
    """Measured timings override the seed: per round one candidate per
    populated bin, the per-bin argmin once converged, then pure hits — the
    same assignments, calls and counters as the reference's cache."""
    (a, b, plan), (ra, rb, rplan) = both_plans()
    assert plan.group_sizes == rplan.group_sizes
    engines = executor.available_engines()
    timings = {(g, e): 50.0 + 10 * ((g + i) % 3)
               for g in range(4) for i, e in enumerate(engines)}
    got, want = [], []
    for mod, x, y, p, out in ((executor, a, b, plan, got),
                              (ref_exec, ra, rb, rplan, want)):
        cache = mod.AutotuneCache()
        key = mod.autotune_key(x, y, p)
        calls = []
        for _ in range(len(engines) + 1):
            out.append(cache.assignment_for(key, p, stub_measure(timings,
                                                                 calls)))
        out.append((tuple(calls), cache.stats(), cache.converged(key)))
    assert got == want
    assert got[-1][1] == {"hits": 1, "misses": 3, "entries": 1}


def test_autotune_cache_keying_and_lru():
    """Same support with other values → one key (a hit); the ungrouped
    plan's bins → a separate entry; the LRU bound evicts the oldest."""
    rng = np.random.default_rng(21)
    pattern = rng.random((12, 12)) < 0.3
    m1, m2 = (csr_from_dense(float_on(pattern, rng), device="cpu")
              for _ in range(2))
    plan = group_rows(m1, m1)
    cache = executor.AutotuneCache(candidates=("sort",))
    calls = []
    cache.assignment_for(executor.autotune_key(m1, m1, plan), plan,
                         stub_measure(calls=calls))
    assert cache.assignment_for(executor.autotune_key(m2, m2, plan), plan,
                                stub_measure(calls=calls)) == ("sort",) * 4
    assert cache.stats() == {"hits": 1, "misses": 1, "entries": 1}
    natural = executor.ungrouped_plan(plan)
    cache.assignment_for(executor.autotune_key(m1, m1, natural), natural,
                         stub_measure())
    assert len(cache) == 2
    small = executor.AutotuneCache(max_entries=2, candidates=("sort",))
    keys = []
    for _ in range(3):
        m = csr_from_dense(float_on(rng.random((10, 10)) < 0.4, rng),
                           device="cpu")
        p = group_rows(m, m)
        keys.append((executor.autotune_key(m, m, p), p))
        small.assignment_for(*keys[-1], stub_measure())
    assert len(small) == 2 and not small.converged(keys[0][0])
    small.assignment_for(*keys[0], stub_measure())  # re-measures
    assert (small.misses, small.hits) == (4, 0)
    assert keys[0][0][1] == "cpu"  # the device type, not a JAX backend


def test_autotune_stats_fold_into_cache_stats():
    a, b = port_operands()
    plan = group_rows(a, b)
    executor.clear_program_cache()
    cache = executor.AutotuneCache(candidates=("sort",))
    key = executor.autotune_key(a, b, plan)
    cache.assignment_for(key, plan, stub_measure())
    cache.assignment_for(key, plan, stub_measure())
    stats = executor.cache_stats()
    assert (stats["autotune_misses"], stats["autotune_hits"]) == (1, 1)


# ---------------------------------------------------------------------------
# Measurement plumbing
# ---------------------------------------------------------------------------

def test_bin_subplan_matches_reference():
    (a, b, plan), (_, _, rplan) = both_plans()
    for g in range(4):
        if plan.group_sizes[g] == 0:
            continue
        sub, rsub = executor.bin_subplan(plan, g), \
            ref_exec.bin_subplan(rplan, g)
        np.testing.assert_array_equal(sub.map_rows, rsub.map_rows)
        np.testing.assert_array_equal(sub.group_offsets, rsub.group_offsets)
        assert sub.group_sizes == rsub.group_sizes
        assert sub.table_capacities == rsub.table_capacities
        c, _ = executor.execute_plan(a, b, sub, engine="sort", row_chunk=8)
        rows = np.zeros(a.n_rows, bool)
        rows[plan.rows_of_group(g)] = True
        assert (np.diff(c.indptr.numpy())[~rows] == 0).all()


def test_measure_group_engine_refuses_auto_and_uses_timer():
    a, b = port_operands()
    plan = group_rows(a, b)
    g = next(i for i in range(4) if plan.group_sizes[i] > 0)
    with pytest.raises(ValueError, match="unknown engine"):
        executor.measure_group_engine(a, b, plan, g, "auto")
    ticks = iter(range(100))
    us = executor.measure_group_engine(a, b, plan, g, "sort",
                                       timer=lambda: float(next(ticks)))
    assert us == 1e6  # the stub clock advances one second a reading


# ---------------------------------------------------------------------------
# engine="auto" through the façade
# ---------------------------------------------------------------------------

def test_auto_converges_then_serves_pure_hits():
    """One measurement round per candidate, then every call is a hit that
    measures nothing; every round's product is the reference's."""
    a, b = port_operands()
    tuner = executor.AutotuneCache()
    rounds = len(executor.available_engines())
    for _ in range(rounds):
        res = spgemm(a, b, engine="auto", autotune=tuner, row_chunk=8)
        assert_reference_product(res.c)
    key = executor.autotune_key(a, b, res.plan)
    assert tuner.misses == rounds and tuner.converged(key)
    [entry] = tuner._entries.values()
    for g in range(4):
        if res.plan.group_sizes[g] > 0:
            assert set(entry.timings[g]) == set(executor.available_engines())
    assert_reference_product(spgemm(a, b, engine="auto", autotune=tuner,
                                     row_chunk=8).c)
    assert (tuner.hits, tuner.misses) == (1, rounds)
    [summary] = tuner.summary()
    assert summary["device"] == "cpu" and summary["converged"]


@pytest.mark.parametrize("pipeline", ("two_wave", "legacy"))
def test_forced_mixed_assignment_matches_reference(pipeline):
    """``plan.group_engines`` with sort, hash and fused_hash on the three
    populated bins gives the reference's product, and wins over the call's
    concrete ``engine=``."""
    a, b = port_operands()
    plan = group_rows(a, b)
    populated = [g for g in range(4) if plan.group_sizes[g] > 0]
    ge = ["sort"] * 4
    for g, e in zip(populated, ("sort", "hash", "fused_hash")):
        ge[g] = e
    forced = dataclasses.replace(plan, group_engines=tuple(ge))
    assert_reference_product(spgemm(a, b, engine="auto", plan=forced,
                                    pipeline=pipeline, row_chunk=8).c)
    assert_reference_product(spgemm(a, b, engine="sort", plan=forced,
                                    pipeline=pipeline, row_chunk=8).c)
    bad = dataclasses.replace(plan, group_engines=("sort", "osrt", "sort",
                                                   "sort"))
    with pytest.raises(ValueError, match="unknown engine"):
        spgemm(a, b, plan=bad)


def test_forced_all_fused_auto_pays_zero_host_syncs():
    a, b = port_operands()
    forced = dataclasses.replace(group_rows(a, b),
                                 group_engines=("fused_hash",) * 4)
    before = executor.cache_stats()["host_sync_count"]
    res = spgemm(a, b, engine="auto", plan=forced, row_chunk=8)
    assert executor.cache_stats()["host_sync_count"] == before
    assert_reference_product(res.c)
