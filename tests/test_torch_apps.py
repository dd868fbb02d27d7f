"""The port's applications (graph contraction, Markov clustering with its
streamed and degraded lanes, full-batch GNN training) and the ``optim``
functions they use, against the JAX package, on the CPU.

Both packages run on the same numpy-built graphs (the generators draw the
same arrays from one seed) and, for the GNN, on the reference's parameters
carried across with ``gnn_params_from_numpy``.  Tolerances:

* graph contraction and MCL: structure exact, values bit for bit (on the
  CPU every lane sums in the reference's order); the MCL clusters equal;
* ``_change`` equal to the reference's (both are a max of float64
  differences of the same float32 sums); ``interpret_clusters`` equal to
  the reference's ``networkx`` labels;
* the GNN forward within 1e-5 of the largest |logit| (matrix products and
  ``log_softmax`` in another library's order), the 3-step loss history
  within 1e-5 relative;
* AdamW's updates and the clipped gradients within 1e-6 relative (the
  bias corrections' ``b ** step`` is another library's ``pow``).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import gnn as ref_gnn
from repro.apps import markov_clustering as ref_mcl
from repro.apps.graphs import rmat_graph as ref_rmat
from repro.apps.graphs import uniform_graph as ref_uniform
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch import apps
from repro_torch.apps import gnn, markov_clustering
from repro_torch.apps.graphs import rmat_graph, uniform_graph
from repro_torch.sparse.formats import csr_from_arrays, csr_from_dense
from repro_torch.sparse.formats import csr_to_dense
from repro_torch.sparse.ops import csr_column_sums

# the modules (the packages' __init__ binds the name to the function)
ref_gc = importlib.import_module("repro.apps.graph_contraction")
graph_contraction = importlib.import_module(
    "repro_torch.apps.graph_contraction")
ref_adamw = importlib.import_module("repro.optim.adamw")
adamw = importlib.import_module("repro_torch.optim.adamw")
ENGINES = ("sort", "hash", "fused_hash")


def port(ref):
    return csr_from_arrays(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, device="cpu")


def assert_same_csr(got, want, nnz_only=True):
    """Shape, indptr and the occupied slots equal, values bit for bit
    (``nnz_only=False``: every slot, and so the capacity)."""
    assert got.shape == tuple(want.shape)
    indptr = np.asarray(want.indptr)
    np.testing.assert_array_equal(got.indptr.numpy(), indptr)
    n = int(indptr[-1]) if nnz_only else None
    np.testing.assert_array_equal(got.indices[:n].numpy(),
                                  np.asarray(want.indices)[:n])
    np.testing.assert_array_equal(got.data[:n].numpy(),
                                  np.asarray(want.data)[:n])


# ---------------------------------------------------------------------------
# Graph contraction (Algorithm 7)
# ---------------------------------------------------------------------------

def contraction_case(name):
    """The graphs and labels of ``tests/test_apps.py``'s contraction tests."""
    if name == "dense_oracle":
        return (uniform_graph(30, 3.0, seed=2, device="cpu"),
                ref_uniform(30, 3.0, seed=2),
                np.random.default_rng(0).integers(0, 5, 30))
    return (rmat_graph(64, 4.0, seed=3, device="cpu"), ref_rmat(64, 4.0, seed=3),
            np.random.default_rng(1).integers(0, 7, 64))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", ["dense_oracle", "total_weight"])
def test_contraction_matches_reference(engine, case):
    g, rg, labels = contraction_case(case)
    c, infos = graph_contraction.graph_contraction(g, labels, method=engine)
    want, ref_infos = ref_gc.graph_contraction(rg, labels, method=engine)
    assert_same_csr(c, want)
    assert [i["nnz_c"] for i in infos] == [i["nnz_c"] for i in ref_infos]
    m = int(labels.max()) + 1
    s = np.zeros((m, g.n_rows), np.float32)
    s[labels, np.arange(g.n_rows)] = 1.0
    gd = csr_to_dense(g).numpy()
    np.testing.assert_allclose(csr_to_dense(c).numpy(), s @ gd @ s.T,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(csr_to_dense(c).sum()), gd.sum(),
                               rtol=1e-4)


def test_label_matrix_matches_reference():
    labels = np.array([2, 0, 1, 0])
    s = graph_contraction.label_matrix(labels, device="cpu")
    assert_same_csr(s, ref_gc.label_matrix(labels), nnz_only=False)
    np.testing.assert_array_equal(csr_to_dense(s).sum(0).numpy(), np.ones(4))


# ---------------------------------------------------------------------------
# Markov clustering (Algorithm 6)
# ---------------------------------------------------------------------------

def two_blocks():
    n = 16
    x = np.zeros((n, n), np.float32)
    x[:8, :8] = 1.0
    x[8:, 8:] = 1.0
    np.fill_diagonal(x, 0)
    x[7, 8] = x[8, 7] = 0.1  # weak bridge
    return csr_from_dense(x, device="cpu"), ref_csr_from_dense(x)


MCL_CASES = {
    # tests/test_apps.py's three MCL tests
    "two_blocks": (two_blocks, dict(e=2, r=2.0, k=16, max_iters=12)),
    "column_stochastic": (
        lambda: (rmat_graph(48, 3.0, seed=4, device="cpu"),
                 ref_rmat(48, 3.0, seed=4)),
        dict(e=2, r=2.0, k=16, max_iters=3, tol=0.0)),
    "spgemm_per_iteration": (
        lambda: (rmat_graph(32, 3.0, seed=5, device="cpu"),
                 ref_rmat(32, 3.0, seed=5)),
        dict(e=2, max_iters=3, tol=0.0)),
}


@pytest.mark.parametrize("engine", ["sort", "fused_hash"])
@pytest.mark.parametrize("case", sorted(MCL_CASES))
def test_mcl_matches_reference(case, engine):
    make, kwargs = MCL_CASES[case]
    g, rg = make()
    got = markov_clustering.mcl(g, method=engine, **kwargs)
    want = ref_mcl.mcl(rg, method=engine, **kwargs)
    assert got.n_iterations == want.n_iterations
    assert got.plan_cache_hits == want.plan_cache_hits
    assert [i["nnz_c"] for i in got.spgemm_info] == \
        [i["nnz_c"] for i in want.spgemm_info]
    assert_same_csr(got.matrix, want.matrix)
    np.testing.assert_array_equal(got.clusters, want.clusters)
    s = csr_column_sums(got.matrix).numpy()
    np.testing.assert_allclose(s[s > 1e-9], 1.0, rtol=1e-4)
    if case == "two_blocks":
        assert len(set(got.clusters[:8])) == len(set(got.clusters[8:])) == 1
        assert got.clusters[0] != got.clusters[8]


def test_add_self_loops_matches_reference():
    """An existing diagonal entry is summed with the weight; the capacity is
    the merged nnz."""
    rng = np.random.default_rng(9)
    x = np.where(rng.random((12, 12)) < 0.3, rng.random((12, 12)), 0)
    x[3, 3] = 0.5
    x = x.astype(np.float32)
    got = markov_clustering.add_self_loops(csr_from_dense(x, device="cpu"),
                                           weight=0.75)
    want = ref_mcl.add_self_loops(ref_csr_from_dense(x), weight=0.75)
    assert_same_csr(got, want, nnz_only=False)


def test_change_matches_reference_across_structures():
    """Matrices of different structure (each holds entries the other lacks,
    and explicit zeros), with spare capacity."""
    rng = np.random.default_rng(10)
    for _ in range(3):
        xa = np.where(rng.random((20, 20)) < 0.2, rng.random((20, 20)), 0)
        xb = np.where(rng.random((20, 20)) < 0.3, rng.random((20, 20)), 0)
        ra = ref_csr_from_dense(xa.astype(np.float32), capacity=100)
        rb = ref_csr_from_dense(xb.astype(np.float32), capacity=150)
        rb = type(rb)(rb.indptr, rb.indices, rb.data.at[:5].set(0.0),
                      rb.shape)
        assert markov_clustering._change(port(ra), port(rb)) == \
            ref_mcl._change(ra, rb)
    assert markov_clustering._change(port(ra), port(ra)) == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_interpret_clusters_matches_networkx(seed):
    """Random graphs with isolated nodes, self-loops and entries at and
    below the 1e-6 cut, directed (the components are weak)."""
    rng = np.random.default_rng(seed)
    n = 40
    x = np.where(rng.random((n, n)) < 0.03, rng.random((n, n)), 0)
    x[rng.integers(0, n, 6), rng.integers(0, n, 6)] = 1e-6
    np.fill_diagonal(x[:10, :10], 0.5)
    x[20:25] = 0
    x[:, 20:25] = 0
    x = x.astype(np.float32)
    got = markov_clustering.interpret_clusters(csr_from_dense(x, device="cpu"))
    want = ref_mcl.interpret_clusters(ref_csr_from_dense(x))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# ---------------------------------------------------------------------------
# GNN full-batch training (Eq. 1-3)
# ---------------------------------------------------------------------------

def gnn_case(arch, mode, n=48, seed=6):
    cfg_kw = dict(arch=arch, d_in=12, d_hidden=16, n_classes=5, topk=6,
                  sparse_mode=mode)
    g, rg = rmat_graph(n, 4.0, seed=seed, device="cpu"), ref_rmat(n, 4.0,
                                                                  seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 12)).astype(np.float32)
    labels = rng.integers(0, 5, n)
    ref_cfg = ref_gnn.GNNConfig(**cfg_kw)
    ref_params = ref_gnn.init_gnn(ref_cfg, jax.random.PRNGKey(seed))
    cfg = gnn.GNNConfig(**cfg_kw)
    params = gnn.gnn_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in ref_params.items()}, device="cpu")
    return cfg, ref_cfg, params, ref_params, g, rg, x, labels


def assert_close_csr(got, want, rtol):
    """Structure equal, values within ``rtol``."""
    indptr = np.asarray(want.indptr)
    np.testing.assert_array_equal(got.indptr.numpy(), indptr)
    n = int(indptr[-1])
    np.testing.assert_array_equal(got.indices[:n].numpy(),
                                  np.asarray(want.indices)[:n])
    np.testing.assert_allclose(got.data[:n].numpy(),
                               np.asarray(want.data)[:n], rtol=rtol)


def test_mcl_streamed_and_degraded_match_reference():
    """``mcl(stream=...)`` and ``mcl(on_budget="stream")`` under a budget
    that every expansion exceeds: bit for bit the port's monolithic MCL;
    the reference's streamed MCL's tile counts, plan hits and clusters,
    and its iterate within 1e-6 relative (inflation's ``torch.pow(x,
    2.0)`` is correctly rounded where XLA's CPU ``pow`` can be one ulp
    off; two iterations of the per-iteration case, one engine: the
    reference compiles every tile's programs.  The degraded lane is held
    against the reference in ``tests/test_torch_resilience.py``)."""
    from repro_torch.core import executor

    make, kwargs = MCL_CASES["spgemm_per_iteration"]
    kwargs = dict(kwargs, max_iters=2, method="fused_hash")
    g, rg = make()
    mono = markov_clustering.mcl(g, **kwargs)
    streamed = markov_clustering.mcl(g, stream=16, **kwargs)
    want = ref_mcl.mcl(rg, stream=16, **kwargs)
    assert [i["n_tiles"] for i in streamed.spgemm_info] == \
        [i["n_tiles"] for i in want.spgemm_info] == [2, 2]
    assert streamed.plan_cache_hits == want.plan_cache_hits
    assert_same_csr(streamed.matrix, mono.matrix)
    assert_close_csr(streamed.matrix, want.matrix, rtol=1e-6)
    np.testing.assert_array_equal(streamed.clusters, want.clusters)
    budget = 8 * min(i["intermediate_products"]
                     for i in streamed.spgemm_info) - 1
    executor.set_device_budget(budget)
    try:
        degraded = markov_clustering.mcl(g, on_budget="stream", **kwargs)
    finally:
        executor.set_device_budget(None)
    assert all(i["degraded_to_stream"] for i in degraded.spgemm_info)
    assert all(i["n_tiles"] > 1 for i in degraded.spgemm_info)
    assert_same_csr(degraded.matrix, mono.matrix)
    np.testing.assert_array_equal(degraded.clusters, want.clusters)


def test_normalize_adjacency_matches_reference():
    g, rg = rmat_graph(40, 4.0, seed=2, device="cpu"), ref_rmat(40, 4.0,
                                                                seed=2)
    assert_same_csr(gnn.normalize_adjacency(g),
                    ref_gnn.normalize_adjacency(rg), nnz_only=False)


@pytest.mark.parametrize("mode", ["topk", "dense"])
@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_gnn_forward_matches_reference(arch, mode):
    cfg, ref_cfg, params, ref_params, g, rg, x, _ = gnn_case(arch, mode)
    a, ra = gnn.normalize_adjacency(g), ref_gnn.normalize_adjacency(rg)
    want = np.asarray(ref_gnn.gnn_forward(ref_cfg, ref_params, ra,
                                          jnp.asarray(x)))
    got = gnn.gnn_forward(cfg, params, a, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (48, 5)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_gnn_forward_aia_gather_matches_reference():
    """The ``aia`` gather (the reference's Pallas row gather in interpret
    mode; the port's kernel wrapper in its plain version)."""
    cfg, ref_cfg, params, ref_params, g, rg, x, _ = gnn_case("gcn", "topk")
    a, ra = gnn.normalize_adjacency(g), ref_gnn.normalize_adjacency(rg)
    cfg = dataclasses.replace(cfg, gather="aia")
    ref_cfg = dataclasses.replace(ref_cfg, gather="aia")
    want = np.asarray(ref_gnn.gnn_forward(ref_cfg, ref_params, ra,
                                          jnp.asarray(x)))
    got = gnn.gnn_forward(cfg, params, a, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_train_gnn_loss_history_matches_reference(arch):
    """Three steps from the reference's starting parameters (its
    ``train_gnn`` draws them from ``seed``)."""
    cfg, ref_cfg, params, _, g, rg, x, labels = gnn_case(arch, "topk", seed=0)
    a, ra = gnn.normalize_adjacency(g), ref_gnn.normalize_adjacency(rg)
    _, want = ref_gnn.train_gnn(ref_cfg, ra, x, labels, n_steps=3, lr=5e-3,
                                seed=0)
    got_params, got = gnn.train_gnn(cfg, a, x, labels, n_steps=3, lr=5e-3,
                                    params=params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert set(got_params) == set(params)
    assert all(torch.isfinite(p).all() for p in got_params.values())


def test_init_gnn_shapes_and_seeded():
    cfg = gnn.GNNConfig(arch="sage", n_layers=3, d_in=8, d_hidden=16,
                        n_classes=4)
    p1 = gnn.init_gnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    p2 = gnn.init_gnn(cfg, torch.Generator().manual_seed(3), device="cpu")
    ref = ref_gnn.init_gnn(ref_gnn.GNNConfig(arch="sage", n_layers=3, d_in=8,
                                             d_hidden=16, n_classes=4),
                           jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p1.items()} == \
        {k: tuple(np.shape(v)) for k, v in ref.items()}
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    with pytest.raises(ValueError, match="keys"):
        gnn.gnn_params_from_numpy(cfg, {"w0": np.zeros((8, 16))})


# ---------------------------------------------------------------------------
# optim: AdamW, clipping
# ---------------------------------------------------------------------------

def test_adamw_and_clipping_match_reference():
    rng = np.random.default_rng(12)
    shapes = {"w0": (5, 3), "b": (3,), "eps0": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32)
              for k, s in shapes.items()}
    ref_opt = ref_adamw.adamw(1e-2, weight_decay=0.05)
    opt = adamw.adamw(1e-2, weight_decay=0.05)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for _ in range(3):
        grads = {k: np.asarray(3 * rng.standard_normal(s), np.float32)
                 for k, s in shapes.items()}
        rg, rnorm = ref_adamw.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads.items()}, 1.0)
        tg, tnorm = adamw.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in grads.items()}, 1.0)
        np.testing.assert_allclose(float(tnorm), float(rnorm), rtol=1e-6)
        ru, rs = ref_opt.update(rg, rs, rp)
        tu, ts = opt.update(tg, ts, tp)
        rp = ref_adamw.apply_updates(rp, ru)
        tp = adamw.apply_updates(tp, tu)
        for k in shapes:
            np.testing.assert_allclose(tg[k].numpy(), np.asarray(rg[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                       rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(rs.step) == 3
    np.testing.assert_allclose(float(adamw.global_norm(tp)),
                               float(ref_adamw.global_norm(rp)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Refusals: a value that is not a mesh says what a mesh is
# ---------------------------------------------------------------------------

def test_unported_knobs_name_their_item():
    g = uniform_graph(16, 3.0, seed=1, device="cpu")
    labels = np.arange(16) % 4
    gc = graph_contraction.graph_contraction
    cases = [
        lambda: gc(g, labels, mesh=object()),
        lambda: apps.mcl(g, mesh=object()),
        lambda: apps.train_gnn(apps.GNNConfig(d_in=4, d_hidden=4),
                               gnn.normalize_adjacency(g),
                               np.zeros((16, 4), np.float32),
                               np.zeros(16, np.int64), n_steps=1,
                               mesh=object()),
    ]
    for call in cases:
        with pytest.raises(TypeError, match="a mesh is"):
            call()
    with pytest.raises(ValueError, match="pipeline"):
        gc(g, labels, pipeline="three_wave")
    with pytest.raises(ValueError, match="on_budget"):
        apps.mcl(g, on_budget="ignore")


# ---------------------------------------------------------------------------
# The applications under a mesh of logical CPU shards
# ---------------------------------------------------------------------------

CPU_MESH = [torch.device("cpu")] * 3


@pytest.mark.parametrize("engine", ("sort", "fused_hash"))
def test_contraction_and_mcl_run_under_a_cpu_mesh(engine):
    """Contraction against the reference's ``mesh=None`` result and MCL
    (two iterations) against the port's, bit for bit, on three shards."""
    g, rg, labels = contraction_case("total_weight")
    got, infos = graph_contraction.graph_contraction(
        g, labels, method=engine, mesh=CPU_MESH)
    want, _ = ref_gc.graph_contraction(rg, labels, method=engine)
    assert_same_csr(got, want)
    assert [i["n_shards"] for i in infos] == [3, 3]
    kw = dict(method=engine, max_iters=2, tol=0.0)
    sharded = apps.mcl(g, mesh=CPU_MESH, **kw)
    plain = apps.mcl(g, **kw)
    assert sharded.n_iterations == plain.n_iterations == 2
    for x, y in ((sharded.matrix.indptr, plain.matrix.indptr),
                 (sharded.matrix.indices, plain.matrix.indices),
                 (sharded.matrix.data, plain.matrix.data)):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(sharded.clusters, plain.clusters)


def test_train_gnn_runs_under_a_cpu_mesh():
    """Three steps on three shards against the reference's ``mesh=None``
    history, at the tolerance of
    ``test_train_gnn_loss_history_matches_reference``; the first loss (the
    forward alone) equals the port's ``mesh=None`` one bit for bit.  X's
    gradient adds the shards' parts, in another order than one segment
    sum, so later steps may differ in the last bits."""
    cfg, ref_cfg, params, _, g, rg, x, labels = gnn_case("gcn", "topk",
                                                         seed=0)
    a, ra = gnn.normalize_adjacency(g), ref_gnn.normalize_adjacency(rg)
    _, want = ref_gnn.train_gnn(ref_cfg, ra, x, labels, n_steps=3, lr=5e-3,
                                seed=0)
    _, got = gnn.train_gnn(cfg, a, x, labels, n_steps=3, lr=5e-3,
                           params=params, mesh=CPU_MESH)
    _, plain = gnn.train_gnn(cfg, a, x, labels, n_steps=1, lr=5e-3,
                             params=params)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[0] == plain[0]
