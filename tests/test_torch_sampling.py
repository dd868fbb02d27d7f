"""The port's bulk sampler (``repro_torch.apps.sampling``) against the JAX
package's, on the CPU.

Both packages run on the same numpy-built graph (the R-MAT generators
draw the same arrays from one seed; one graph for the file, so that the
reference compiles its programs once).  Every case of
``tests/test_sampling.py`` runs through both packages; the sampler's
results are held exactly:

* frontiers equal (the row sums, and so the draws, are the reference's:
  ``np.add.at`` in slot order and the per-row ``Generator`` loop);
* adjacencies and probability matrices bit for bit (every product of a
  selection matrix has one term);
* ``PlanCache`` hits and misses equal, and the same errors raised;
* the ensemble mean (``torch.stack(...).mean(0)`` against ``jnp.mean``:
  equal at 2 and 4 members, one ulp apart at 3 or 7) within 1e-6
  relative, and its sampled chain exactly the reference's.
"""
import numpy as np
import pytest
import torch

from repro.apps import sampling as ref_sampling
from repro.apps.graphs import rmat_graph as ref_rmat
from repro.core.spgemm import PlanCache as RefPlanCache
from repro.core.spgemm import spgemm as ref_spgemm
from repro.sparse.formats import csr_to_dense as ref_csr_to_dense
from repro_torch.apps import sampling
from repro_torch.apps.graphs import rmat_graph
from repro_torch.core import executor
from repro_torch.core.spgemm import PlanCache, spgemm
from repro_torch.sparse.formats import csr_to_dense


def graphs(n, deg, seed):
    return rmat_graph(n, deg, seed=seed, device="cpu"), \
        ref_rmat(n, deg, seed=seed)


# one chain for the chain cases
BATCH = np.asarray([1, 4, 9, 20])
CHAIN = dict(fanout=2, n_layers=2, seed=3)


@pytest.fixture(scope="module")
def g96():
    return graphs(96, 5.0, 5)


def assert_same_csr(got, want):
    """Shape, indptr and the occupied slots equal, values bit for bit."""
    assert got.shape == tuple(want.shape)
    indptr = np.asarray(want.indptr)
    np.testing.assert_array_equal(got.indptr.numpy(), indptr)
    n = int(indptr[-1])
    np.testing.assert_array_equal(got.indices[:n].numpy(),
                                  np.asarray(want.indices)[:n])
    np.testing.assert_array_equal(got.data[:n].numpy(),
                                  np.asarray(want.data)[:n])


def assert_same_chain(got, want):
    (adjs, frontiers), (ref_adjs, ref_frontiers) = got, want
    assert len(frontiers) == len(ref_frontiers)
    for f, rf in zip(frontiers, ref_frontiers):
        np.testing.assert_array_equal(f, rf)
    assert len(adjs) == len(ref_adjs)
    for adj, ref_adj in zip(adjs, ref_adjs):
        assert_same_csr(adj, ref_adj)


def test_selection_matrix_extracts_rows(g96):
    g, rg = g96
    rows = np.asarray([3, 10, 17])
    r = sampling.selection_matrix(rows, 96, device="cpu")
    assert r.device.type == "cpu"
    assert_same_csr(r, ref_sampling.selection_matrix(rows, 96))
    got = spgemm(r, g, method="sort").c
    want = ref_spgemm(ref_sampling.selection_matrix(rows, 96), rg,
                      method="sort").c
    assert_same_csr(got, want)
    np.testing.assert_array_equal(csr_to_dense(got).numpy(),
                                  np.asarray(ref_csr_to_dense(rg))[rows])


def test_extract_submatrix_matches_reference(g96):
    g, rg = g96
    rows = np.asarray([1, 5, 9])
    cols = np.asarray([0, 2, 5, 9, 30])
    sub = sampling.extract(g, rows, cols)
    assert_same_csr(sub, ref_sampling.extract(rg, rows, cols))
    np.testing.assert_array_equal(
        csr_to_dense(sub).numpy(),
        np.asarray(ref_csr_to_dense(rg))[np.ix_(rows, cols)])


def test_norm_rows_matches_reference(g96):
    g, rg = g96
    q = np.asarray([0, 4, 8])
    p = sampling.norm_rows(
        spgemm(sampling.selection_matrix(q, 96, "cpu"), g, method="sort").c)
    ref_p = ref_sampling.norm_rows(
        ref_spgemm(ref_sampling.selection_matrix(q, 96), rg,
                   method="sort").c)
    assert_same_csr(p, ref_p)
    for s in csr_to_dense(p).numpy().sum(axis=1):
        assert s == pytest.approx(1.0, abs=1e-5) or s == pytest.approx(0.0)


def test_sample_rows_matches_reference(g96):
    g, rg = g96
    q = np.asarray([2, 7])
    p = sampling.norm_rows(
        spgemm(sampling.selection_matrix(q, 96, "cpu"), g, method="sort").c)
    ref_p = ref_sampling.norm_rows(
        ref_spgemm(ref_sampling.selection_matrix(q, 96), rg,
                   method="sort").c)
    s1 = sampling.sample_rows(p, 3, np.random.default_rng(0))
    s2 = sampling.sample_rows(p, 3, np.random.default_rng(0))
    np.testing.assert_array_equal(s1, s2)  # deterministic per seed
    np.testing.assert_array_equal(
        s1, ref_sampling.sample_rows(ref_p, 3, np.random.default_rng(0)))
    support = set(np.nonzero(csr_to_dense(p).numpy().sum(0))[0].tolist())
    assert set(s1.tolist()) <= support  # sampled ⊆ neighbours


def test_bulk_sample_plan_cache_hits_on_repeat(g96):
    """The second identical call's chain is served from the PlanCache, with
    the reference's hit and miss counts."""
    g, rg = g96
    cache, ref_cache = PlanCache(), RefPlanCache()
    first = sampling.bulk_sample(g, BATCH, plan_cache=cache, **CHAIN)
    ref_first = ref_sampling.bulk_sample(rg, BATCH, plan_cache=ref_cache,
                                         **CHAIN)
    assert (cache.hits, cache.misses) == (ref_cache.hits, ref_cache.misses)
    misses, hits = cache.misses, cache.hits
    assert misses > 0
    second = sampling.bulk_sample(g, BATCH, plan_cache=cache, **CHAIN)
    assert cache.misses == misses, "repeat call re-planned"
    assert cache.hits == 2 * hits + misses
    assert_same_chain(first, ref_first)
    assert_same_chain(second, ref_first)


def _weights(g, *scales):
    nnz = int(g.nnz)
    base = g.data[:nnz].numpy()
    return np.stack([base * s for s in scales]).astype(np.float32)


def test_bulk_sample_weight_ensemble_identity(g96):
    """Identical weight copies reproduce the single-matrix chain exactly
    (the mean of equal floats is exact) through the batched executor."""
    g, rg = g96
    ws = _weights(g, 1.0, 1.0)
    single = sampling.bulk_sample(g, BATCH, **CHAIN)
    executor.clear_program_cache()
    ens = sampling.bulk_sample(g, BATCH, weight_sets=ws, **CHAIN)
    assert_same_chain(ens, single)
    assert_same_chain(ens, ref_sampling.bulk_sample(rg, BATCH,
                                                    weight_sets=ws, **CHAIN))


@pytest.mark.parametrize("n_members", [2, 4])
def test_ensemble_mean_matches_reference(g96, n_members):
    """``_ensemble_mean`` against ``jnp.mean`` on the batched products of
    W reweightings, and the chain sampled from them."""
    g, rg = g96
    ws = _weights(g, *(1.0 + 0.37 * i for i in range(n_members)))
    cs = sampling.spgemm_batched(sampling.selection_matrix(BATCH, 96, "cpu"),
                                 sampling._weighted_members(g, ws)).cs
    ref_cs = ref_sampling.spgemm_batched(
        ref_sampling.selection_matrix(BATCH, 96),
        ref_sampling._weighted_members(rg, ws)).cs
    for c, rc in zip(cs, ref_cs):
        assert_same_csr(c, rc)
    got = sampling._ensemble_mean(cs)
    want = ref_sampling._ensemble_mean(ref_cs)
    nnz = int(got.nnz)
    np.testing.assert_allclose(got.data[:nnz].numpy(),
                               np.asarray(want.data)[:nnz], rtol=1e-6)
    assert_same_chain(
        sampling.bulk_sample(g, BATCH, weight_sets=ws, **CHAIN),
        ref_sampling.bulk_sample(rg, BATCH, weight_sets=ws, **CHAIN))


def test_bulk_sample_weight_ensemble_reweights_probabilities(g96):
    """A member with other weights still gives true submatrices of A."""
    g, rg = g96
    ws = _weights(g, 1.0, 3.0)
    kw = dict(fanout=2, n_layers=1, seed=2, weight_sets=ws)
    adjs, frontiers = sampling.bulk_sample(g, BATCH, **kw)
    assert len(adjs) == 1 and len(frontiers) == 2
    np.testing.assert_array_equal(
        csr_to_dense(adjs[0]).numpy(),
        csr_to_dense(g).numpy()[np.ix_(frontiers[0], frontiers[1])])
    assert_same_chain((adjs, frontiers),
                      ref_sampling.bulk_sample(rg, BATCH, **kw))


def test_bulk_sample_weight_sets_shape_validated(g96):
    g, rg = g96
    bad = np.ones((2, 3), np.float32)
    for sample, graph in ((sampling.bulk_sample, g),
                          (ref_sampling.bulk_sample, rg)):
        with pytest.raises(ValueError, match="weight_sets"):
            sample(graph, np.asarray([0]), fanout=2, n_layers=1,
                   weight_sets=bad)


def test_bulk_sample_chain(g96):
    g, rg = g96
    adjs, frontiers = sampling.bulk_sample(g, BATCH, **CHAIN)
    assert len(adjs) == 2 and len(frontiers) == 3
    # frontiers grow monotonically and contain the batch
    assert set(BATCH.tolist()) <= set(frontiers[1].tolist())
    assert set(frontiers[1].tolist()) <= set(frontiers[2].tolist())
    # each A^l has shape (|Q^l|, |Q^{l+1}|) and is a true submatrix of A
    dense = csr_to_dense(g).numpy()
    for layer, adj in enumerate(adjs):
        q_rows, q_cols = frontiers[layer], frontiers[layer + 1]
        assert adj.shape == (len(q_rows), len(q_cols))
        np.testing.assert_array_equal(csr_to_dense(adj).numpy(),
                                      dense[np.ix_(q_rows, q_cols)])
    assert_same_chain((adjs, frontiers),
                      ref_sampling.bulk_sample(rg, BATCH, **CHAIN))


@pytest.mark.parametrize("gather", ["xla", "aia"])
@pytest.mark.parametrize("engine", ["sort", "hash", "fused_hash"])
def test_bulk_sample_grid_matches_reference(g96, engine, gather):
    """Every engine x gather: the reference's frontiers, adjacencies bit
    for bit, and the same PlanCache hits and misses over two calls."""
    g, rg = g96
    cache, ref_cache = PlanCache(), RefPlanCache()
    kw = dict(CHAIN, engine=engine, gather=gather)
    for _ in range(2):
        got = sampling.bulk_sample(g, BATCH, plan_cache=cache, **kw)
        want = ref_sampling.bulk_sample(rg, BATCH, plan_cache=ref_cache,
                                        **kw)
        assert_same_chain(got, want)
        assert (cache.hits, cache.misses) == (ref_cache.hits,
                                              ref_cache.misses)


def test_bulk_sample_errors_match_reference(g96):
    g, rg = g96
    one = np.asarray([0])
    for mod, graph in ((sampling, g), (ref_sampling, rg)):
        with pytest.raises(ValueError, match="unknown engine"):
            mod.bulk_sample(graph, one, fanout=2, n_layers=1, engine="nope")
        with pytest.raises(ValueError, match="unknown engine"):
            mod.extract(graph, one, one, engine="nope")
    with pytest.raises(TypeError, match="a mesh is"):
        sampling.bulk_sample(g, one, fanout=2, n_layers=1, mesh=object())


def test_bulk_sample_runs_under_a_cpu_mesh(g96):
    """Under three logical CPU shards: the reference's ``mesh=None`` chain
    bit for bit, and with a weight ensemble (through the batched lane) the
    port's own ``mesh=None`` chain."""
    g, rg = g96
    mesh = [torch.device("cpu")] * 3
    kw = dict(CHAIN, engine="fused_hash")
    assert_same_chain(sampling.bulk_sample(g, BATCH, mesh=mesh, **kw),
                      ref_sampling.bulk_sample(rg, BATCH, **kw))
    ws = _weights(g, 1.0, 2.0)
    assert_same_chain(
        sampling.bulk_sample(g, BATCH, mesh=mesh, weight_sets=ws, **kw),
        sampling.bulk_sample(g, BATCH, weight_sets=ws, **kw))


def test_zero_weight_rows_raise_like_reference(g96):
    """The sampler draws min(fanout, row nnz) columns whatever their
    weights, so a row with fewer positive weights than that makes numpy's
    choice raise, in both packages alike."""
    g, rg = g96
    indptr = g.indptr.numpy()
    row = int(np.nonzero(np.diff(indptr) == 2)[0][0])
    ws = _weights(g, 1.0, 1.0)
    ws[:, indptr[row]] = 0.0  # every member drops one of its two edges
    for mod, graph in ((sampling, g), (ref_sampling, rg)):
        with pytest.raises(ValueError, match="non-zero entries in p"):
            mod.bulk_sample(graph, np.asarray([row]), fanout=2, n_layers=1,
                            weight_sets=ws)
