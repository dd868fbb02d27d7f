"""The port's batched and legacy lanes, ``OperandCache`` and
``spgemm_ell_fixed`` against the JAX package, on the CPU.

The same numpy-built operands (random float values on a seeded pattern) go
through ``repro.core.spgemm`` and ``repro_torch.core.spgemm``
(``device="cpu"``).  Tolerance: bit for bit — indptr and the occupied
indices equal, the values identical — since on the CPU every lane of the
port keeps the reference's summation order (stream order in the hash
table, index order in the sort engine's scatter-add).  The reference's own
suite holds its lanes (gather, sizing, pipeline) bit-identical to each
other, so each port lane is held to the reference's result for its
engine, computed once per engine.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core.grouping import group_rows as ref_group_rows
from repro.core.spgemm import spgemm_batched as ref_spgemm_batched
from repro.core.spgemm import spgemm_ell_fixed as ref_spgemm_ell_fixed
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro.sparse.formats import ell_from_dense as ref_ell_from_dense
from repro_torch import apps
from repro_torch.core import executor
from repro_torch.core.grouping import group_rows
from repro_torch.core.spgemm import spgemm, spgemm_batched, spgemm_ell_fixed
from repro_torch.sparse.formats import (
    csr_from_dense, csr_to_dense, ell_from_dense)

ENGINES = ("sort", "hash", "fused_hash", "auto")
GATHERS = ("xla", "aia")
LANES = (("two_wave", "measured"), ("two_wave", "planned"),
         ("legacy", "measured"))
BATCH = 3


def float_on(pattern, rng):
    return np.where(pattern, rng.standard_normal(pattern.shape),
                    0).astype(np.float32)


def multibin_dense(rng):
    """Patterns of A and B whose product's rows fall in Table-I groups 0,
    1 and 2 on short streams: B's rows 0-3 hold 2 entries, its rows 4-15
    hold 44; A's rows 0-7 take one of B's short rows (IP 2), rows 8-19 three
    long ones (IP 132), rows 20-23 every row (IP 536)."""
    xb = np.zeros((16, 48), bool)
    for i in range(16):
        xb[i, rng.choice(48, 2 if i < 4 else 44, replace=False)] = True
    xa = np.zeros((24, 16), bool)
    xa[np.arange(8), rng.integers(0, 4, 8)] = True
    for i in range(8, 20):
        xa[i, 4 + rng.choice(12, 3, replace=False)] = True
    xa[20:] = True
    return xa, xb


@functools.lru_cache(maxsize=None)
def operands():
    """(A patterns' members, B members) as dense float32 arrays, and the
    forced mixed per-bin assignment for ``engine="auto"``."""
    rng = np.random.default_rng(19)
    pa, pb = multibin_dense(rng)
    xas = [float_on(pa, rng) for _ in range(BATCH)]
    xbs = [float_on(pb, rng) for _ in range(BATCH)]
    return xas, xbs


def forced(plan):
    """``plan`` with sort, hash and fused_hash on its three populated bins
    (a genuinely mixed assignment)."""
    populated = [g for g in range(4) if plan.group_sizes[g] > 0]
    assert len(populated) >= 3, plan.group_sizes
    ge = ["fused_hash"] * 4
    for g, e in zip(populated, ("sort", "hash", "fused_hash")):
        ge[g] = e
    return dataclasses.replace(plan, group_engines=tuple(ge))


def port_members(xs):
    return [csr_from_dense(x, device="cpu") for x in xs]


@functools.lru_cache(maxsize=None)
def reference_batch(engine, shared_b=False):
    """The reference's ``spgemm_batched`` (xla gather, two waves, default
    sizing, 8-row chunks) per engine: indptr, indices, each member's
    values, host arrays."""
    xas, xbs = operands()
    ras = [ref_csr_from_dense(x) for x in xas]
    rbs = ref_csr_from_dense(xbs[0]) if shared_b \
        else [ref_csr_from_dense(x) for x in xbs]
    plan = None
    if engine == "auto":
        plan = forced(ref_group_rows(ras[0], rbs[0]))
    res = ref_spgemm_batched(ras, rbs, engine=engine, gather="xla",
                             row_chunk=8, plan=plan)
    nnz = res.info["nnz_c"]
    return (np.asarray(res.cs[0].indptr), np.asarray(res.cs[0].indices)[:nnz],
            [np.asarray(c.data)[:nnz] for c in res.cs])


def assert_members(res, want):
    indptr, indices, datas = want
    nnz = int(indptr[-1])
    assert res.info["nnz_c"] == nnz and len(res.cs) == len(datas)
    for c, data in zip(res.cs, datas):
        np.testing.assert_array_equal(c.indptr.numpy(), indptr)
        np.testing.assert_array_equal(c.indices[:nnz].numpy(), indices)
        np.testing.assert_array_equal(c.data[:nnz].numpy(), data)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("gather", GATHERS)
@pytest.mark.parametrize("pipeline,sizing", LANES)
def test_batched_grid_matches_reference(engine, gather, pipeline, sizing):
    xas, xbs = operands()
    a_m, b_m = port_members(xas), port_members(xbs)
    plan = forced(group_rows(a_m[0], b_m[0])) if engine == "auto" else None
    res = spgemm_batched(a_m, b_m, engine=engine, gather=gather,
                         pipeline=pipeline, sizing=sizing, row_chunk=8,
                         plan=plan)
    assert res.info["batch"] == BATCH
    assert_members(res, reference_batch(engine))


def test_shared_b_matches_reference():
    """One B for every member (its values broadcast) on the two-wave and
    the legacy lane."""
    xas, xbs = operands()
    a_m = port_members(xas)
    b = csr_from_dense(xbs[0], device="cpu")
    want = reference_batch("sort", shared_b=True)
    for pipeline in ("two_wave", "legacy"):
        assert_members(spgemm_batched(a_m, b, row_chunk=8,
                                      pipeline=pipeline), want)


@pytest.mark.parametrize("engine", ENGINES[:3])
def test_members_equal_a_loop_of_spgemm(engine):
    """Each member of the port's batched product equals the port's own
    ``spgemm`` of that member, bit for bit (pow2 capacities included)."""
    xas, xbs = operands()
    a_m, b_m = port_members(xas), port_members(xbs)
    res = spgemm_batched(a_m, b_m, engine=engine, gather="aia", row_chunk=8)
    for i, c in enumerate(res.cs):
        solo = spgemm(a_m[i], b_m[i], engine=engine, gather="aia",
                      row_chunk=8).c
        for x, y in ((c.indptr, solo.indptr), (c.indices, solo.indices),
                     (c.data, solo.data)):
            assert torch.equal(x, y)


def test_batched_refuses_mismatched_members():
    xas, xbs = operands()
    a_m, b_m = port_members(xas), port_members(xbs)
    with pytest.raises(ValueError, match="batch mismatch"):
        spgemm_batched(a_m, b_m[:2])
    other = csr_from_dense(np.eye(*xas[0].shape, dtype=np.float32),
                           device="cpu")
    with pytest.raises(ValueError, match="sparsity pattern"):
        spgemm_batched([a_m[0], other], b_m[0])
    with pytest.raises(TypeError, match="a mesh is"):
        spgemm_batched(a_m, b_m, mesh=object())


@pytest.mark.parametrize("placement", ("auto", "footprint", "replicate"))
@pytest.mark.parametrize("shared_b", (False, True))
def test_batched_runs_under_a_cpu_mesh(placement, shared_b):
    """Under three logical CPU shards every member is the reference's
    batched result bit for bit, with B whole or as footprint blocks (a
    shared B's values or per-member value planes cut to the rows)."""
    xas, xbs = operands()
    b = csr_from_dense(xbs[0], device="cpu") if shared_b \
        else port_members(xbs)
    res = spgemm_batched(port_members(xas), b, engine="sort", row_chunk=8,
                         mesh=[torch.device("cpu")] * 3, operands=placement)
    assert res.info["n_shards"] == 3
    assert_members(res, reference_batch("sort", shared_b))


# ---------------------------------------------------------------------------
# Host syncs per lane
# ---------------------------------------------------------------------------

def sync_delta(fn):
    before = executor.cache_stats()["host_sync_count"]
    out = fn()
    return out, executor.cache_stats()["host_sync_count"] - before


def test_host_syncs_per_batched_lane():
    """Two-wave measured: one coalesced read for the whole batch; planned
    (fused_hash): none; legacy: one per chunk."""
    xas, xbs = operands()
    a_m, b_m = port_members(xas), port_members(xbs)
    nnz = np.diff(a_m[0].indptr.numpy())
    n_chunks = len(executor.partition_plan(group_rows(a_m[0], b_m[0]), nnz,
                                           8))
    assert n_chunks > 1
    for kwargs, want in (({"engine": "sort"}, 1),
                         ({"engine": "fused_hash"}, 0),
                         ({"engine": "sort", "pipeline": "legacy"},
                          n_chunks)):
        _, syncs = sync_delta(lambda: spgemm_batched(a_m, b_m, row_chunk=8,
                                                     **kwargs))
        assert syncs == want, kwargs
    with pytest.raises(ValueError, match="requires pipeline='two_wave'"):
        spgemm_batched(a_m, b_m, pipeline="legacy", sizing="planned")


# ---------------------------------------------------------------------------
# OperandCache
# ---------------------------------------------------------------------------

def test_operand_cache_hits_across_batched_and_iterative_calls():
    xas, xbs = operands()
    a_m = port_members(xas)
    b = csr_from_dense(xbs[0], device="cpu")
    executor.clear_program_cache()
    spgemm_batched(a_m, b)
    s1 = executor.cache_stats()
    assert (s1["operand_misses"], s1["operand_hits"]) == (1, 0)
    spgemm_batched(a_m[:2], b)
    for a in a_m:
        spgemm(a, b)
    s2 = executor.cache_stats()
    assert (s2["operand_misses"], s2["operand_hits"]) == (1, 4)
    spgemm(a_m[0], csr_from_dense(xbs[0], device="cpu"))  # new B object
    assert executor.cache_stats()["operand_misses"] == 2


def test_operand_cache_misses_after_in_place_edit_of_b():
    """A torch tensor is mutable: the key holds each tensor's ``_version``,
    so an in-place edit of ``b.data`` is honoured, never served stale: the
    edited B's product equals the product of a fresh B with those values."""
    xas, xbs = operands()
    a = csr_from_dense(xas[0], device="cpu")
    b = csr_from_dense(xbs[0], device="cpu")
    cache = executor.OperandCache()
    executor.clear_program_cache()
    spgemm(a, b, operand_cache=cache)
    b.data.mul_(2.0)  # in place: same tensor object, new version
    got = spgemm(a, b, operand_cache=cache).c
    stats = executor.cache_stats()
    assert (stats["operand_hits"], stats["operand_misses"]) == (0, 2)
    want = spgemm(a, csr_from_dense(2.0 * xbs[0], device="cpu")).c
    for x, y in ((got.indptr, want.indptr), (got.indices, want.indices),
                 (got.data, want.data)):
        assert torch.equal(x, y)
    spgemm(a, b, operand_cache=cache)
    assert executor.cache_stats()["operand_hits"] == 1


def test_operand_cache_lru_bound_and_clear():
    rng = np.random.default_rng(25)
    cache = executor.OperandCache(max_entries=2)
    mats = [csr_from_dense(float_on(rng.random((10, 10)) < 0.4, rng),
                           device="cpu") for _ in range(3)]
    executor.clear_program_cache()
    for m in mats:
        cache.b_operands(m, 4)
    assert len(cache) == 2
    cache.b_operands(mats[2], 4)  # the newest entry: a hit
    cache.b_operands(mats[0], 4)  # evicted: a miss
    stats = executor.cache_stats()
    assert (stats["operand_hits"], stats["operand_misses"]) == (1, 4)
    cache.clear()
    assert len(cache) == 0


# ---------------------------------------------------------------------------
# spgemm_ell_fixed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ("sort", "hash"))
def test_ell_fixed_matches_reference(engine):
    rng = np.random.default_rng(4)
    x = float_on(rng.random((12, 12)) < 0.25, rng)
    re = ref_ell_from_dense(x, k_cap=8)
    e = ell_from_dense(x, k_cap=8, device="cpu")
    np.testing.assert_array_equal(e.indices.numpy(), np.asarray(re.indices))
    np.testing.assert_array_equal(e.data.numpy(), np.asarray(re.data))
    want = ref_spgemm_ell_fixed(re, re, out_cap=12, engine=engine)
    got = spgemm_ell_fixed(e, e, out_cap=12, engine=engine)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.shape == tuple(want.shape)
    with pytest.raises(ValueError, match="Table-I bins"):
        spgemm_ell_fixed(e, e, out_cap=12, engine="auto")
    with pytest.raises(ValueError, match="unknown engine"):
        spgemm_ell_fixed(e, e, out_cap=12, engine="osrt")


# ---------------------------------------------------------------------------
# The applications pass engine="auto" and pipeline="legacy" through
# ---------------------------------------------------------------------------

def test_apps_take_auto_and_legacy():
    """Graph contraction with ``pipeline="legacy"`` and with
    ``method="auto"``, and MCL on the legacy lane, equal the port's default
    two-wave runs (which ``test_torch_apps.py`` holds to the reference)."""
    rng = np.random.default_rng(3)
    x = float_on(rng.random((24, 24)) < 0.2, rng)
    g = csr_from_dense(np.abs(x) + np.abs(x.T), device="cpu")
    labels = np.arange(24) % 5
    want, _ = apps.graph_contraction(g, labels)
    for kwargs in ({"pipeline": "legacy"}, {"method": "auto"}):
        got, _ = apps.graph_contraction(g, labels, **kwargs)
        assert torch.equal(csr_to_dense(got), csr_to_dense(want))
    legacy = apps.mcl(g, max_iters=2, pipeline="legacy")
    two_wave = apps.mcl(g, max_iters=2)
    assert torch.equal(csr_to_dense(legacy.matrix),
                       csr_to_dense(two_wave.matrix))
    np.testing.assert_array_equal(legacy.clusters, two_wave.clusters)
