"""The port's mini-batch GNN (``gnn_forward_minibatch``,
``train_gnn_minibatch``) against the JAX package's, on the CPU.

Both packages run on the same numpy-built graphs and features; the port
starts from the reference's parameters (carried across with
``gnn_params_from_numpy``) and, for the forward, from the reference's own
sampled chain (its CSRs carried across with ``csr_from_arrays``).
Tolerances, as ``tests/test_torch_apps.py`` holds the full batch:

* the forward's logits within 1e-5 of the largest |logit| (matrix
  products in another library's order);
* the loss history within 1e-5 relative (the sampled chains are the
  reference's exactly, so only float32 rounding differs);
* ``stats`` (the PlanCache's hits and misses) exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import gnn as ref_gnn
from repro.apps import sampling as ref_sampling
from repro.apps.graphs import rmat_graph as ref_rmat
from repro_torch.apps import gnn, sampling
from repro_torch.apps.graphs import rmat_graph
from repro_torch.sparse.formats import csr_from_arrays


def port(ref):
    return csr_from_arrays(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, device="cpu")


def case(arch, n, d_in, d_hidden, n_classes, seed, key_seed):
    """The normalised graph in both packages, features, labels and both
    configs and parameter sets (the reference's ``init_gnn``)."""
    cfg_kw = dict(arch=arch, n_layers=2, d_in=d_in, d_hidden=d_hidden,
                  n_classes=n_classes, topk=8)
    a = gnn.normalize_adjacency(rmat_graph(n, 4.0, seed=seed, device="cpu"))
    ra = ref_gnn.normalize_adjacency(ref_rmat(n, 4.0, seed=seed))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d_in)).astype(np.float32)
    labels = rng.integers(0, n_classes, n)
    ref_cfg = ref_gnn.GNNConfig(**cfg_kw)
    ref_params = ref_gnn.init_gnn(ref_cfg, jax.random.PRNGKey(key_seed))
    cfg = gnn.GNNConfig(**cfg_kw)
    params = gnn.gnn_params_from_numpy(
        cfg, {k: np.asarray(v) for k, v in ref_params.items()}, device="cpu")
    return cfg, ref_cfg, params, ref_params, a, ra, x, labels


@pytest.mark.parametrize("ensemble", [False, True])
@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_forward_minibatch_matches_reference(arch, ensemble):
    """On the reference's sampled chain (as ``tests/test_apps.py``'s
    mini-batch forward, with its weight ensemble of two equal members; on
    the training case's graph, so that the reference compiles once)."""
    cfg, ref_cfg, params, ref_params, a, ra, x, _ = case(
        arch, 48, 8, 16, 3, seed=11, key_seed=0)
    batch = np.asarray([3, 7, 11])
    nnz = int(a.nnz)
    ws = (np.stack([a.data[:nnz].numpy()] * 2) if ensemble else None)
    ref_adjs, frontiers = ref_sampling.bulk_sample(
        ra, batch, fanout=2, n_layers=2, seed=4, weight_sets=ws)
    want = np.asarray(ref_gnn.gnn_forward_minibatch(
        ref_cfg, ref_params, ref_adjs, frontiers, jnp.asarray(x)))
    got = gnn.gnn_forward_minibatch(cfg, params, [port(r) for r in ref_adjs],
                                    frontiers, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(batch), 3)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the port's own chain is the same one
    adjs, port_frontiers = sampling.bulk_sample(
        a, batch, fanout=2, n_layers=2, seed=4, weight_sets=ws)
    for f, rf in zip(port_frontiers, frontiers):
        np.testing.assert_array_equal(f, rf)
    np.testing.assert_array_equal(
        gnn.gnn_forward_minibatch(cfg, params, adjs, port_frontiers,
                                  torch.from_numpy(x)).numpy(), got)


@pytest.mark.parametrize("arch", ["gcn", "gin", "sage"])
def test_train_minibatch_matches_reference(arch):
    """``tests/test_apps.py``'s mini-batch training case (n = 48, batches
    of 16, 2 epochs, fanout 3, seed 2) from the reference's starting
    parameters: the loss history, and the PlanCache's amortisation."""
    cfg, ref_cfg, params, _, a, ra, x, labels = case(
        arch, 48, 8, 16, 3, seed=11, key_seed=2)
    kw = dict(batch_size=16, n_epochs=2, fanout=3, seed=2)
    _, want, ref_stats = ref_gnn.train_gnn_minibatch(ref_cfg, ra, x, labels,
                                                     **kw)
    got_params, got, stats = gnn.train_gnn_minibatch(cfg, a, x, labels,
                                                     params=params, **kw)
    assert len(got) == len(want) == 2 * 3
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert stats == ref_stats
    assert stats["plan_cache_hits"] > 0
    assert set(got_params) == set(params)
    assert all(torch.isfinite(p).all() for p in got_params.values())


def test_train_minibatch_without_plan_reuse():
    """``reuse_plan=False`` plans every SpGEMM and reports no hits, as the
    reference does; the losses are the same as with the cache."""
    cfg, ref_cfg, params, _, a, ra, x, labels = case(
        "sage", 48, 8, 16, 3, seed=11, key_seed=2)
    kw = dict(batch_size=16, n_epochs=1, fanout=3, seed=2)
    _, want, ref_stats = ref_gnn.train_gnn_minibatch(
        ref_cfg, ra, x, labels, reuse_plan=False, **kw)
    _, got, stats = gnn.train_gnn_minibatch(cfg, a, x, labels, params=params,
                                            reuse_plan=False, **kw)
    assert stats == ref_stats == {"plan_cache_hits": 0,
                                  "plan_cache_misses": 0}
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _, cached, _ = gnn.train_gnn_minibatch(cfg, a, x, labels, params=params,
                                           **kw)
    assert cached == got


def test_minibatch_refusals():
    cfg, _, params, _, a, _, x, labels = case("gcn", 48, 8, 16, 3, seed=11,
                                              key_seed=2)
    with pytest.raises(TypeError, match="a mesh is"):
        gnn.train_gnn_minibatch(cfg, a, x, labels, mesh=object())
    with pytest.raises(TypeError, match="a mesh is"):
        gnn.gnn_forward_minibatch(cfg, params, [], [], torch.from_numpy(x),
                                  mesh=object())
    with pytest.raises(ValueError, match="adjacencies"):
        gnn.gnn_forward_minibatch(cfg, params, [], [], torch.from_numpy(x))
    with pytest.raises(ValueError, match="unknown engine"):
        gnn.train_gnn_minibatch(cfg, a, x, labels, engine="nope")


def test_minibatch_runs_under_a_cpu_mesh():
    """Under three logical CPU shards: the sampled chain, the forward's
    logits bit for bit the port's ``mesh=None`` ones, and one epoch of
    training within the file's 1e-5 of the ``mesh=None`` losses (X's
    gradient adds the shards' parts in another order)."""
    cfg, _, params, _, a, _, x, labels = case("sage", 48, 8, 16, 3, seed=11,
                                              key_seed=2)
    mesh = [torch.device("cpu")] * 3
    batch = np.asarray([3, 7, 11])
    adjs, frontiers = sampling.bulk_sample(a, batch, fanout=2, n_layers=2,
                                           seed=4, mesh=mesh)
    plain_adjs, plain_frontiers = sampling.bulk_sample(
        a, batch, fanout=2, n_layers=2, seed=4)
    for f, pf in zip(frontiers, plain_frontiers):
        np.testing.assert_array_equal(f, pf)
    xt = torch.from_numpy(x)
    got = gnn.gnn_forward_minibatch(cfg, params, adjs, frontiers, xt,
                                    mesh=mesh)
    want = gnn.gnn_forward_minibatch(cfg, params, plain_adjs,
                                     plain_frontiers, xt)
    assert torch.equal(got, want)
    kw = dict(batch_size=16, n_epochs=1, fanout=3, seed=2, params=params)
    _, sharded, stats = gnn.train_gnn_minibatch(cfg, a, x, labels,
                                                mesh=mesh, **kw)
    _, plain, plain_stats = gnn.train_gnn_minibatch(cfg, a, x, labels, **kw)
    np.testing.assert_allclose(sharded, plain, rtol=1e-5)
    assert stats == plain_stats
