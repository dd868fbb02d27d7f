"""The port's BSR/TopKRows formats, ``sparse.topk`` and ``core.spgemm_bsr``
against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
formats and the TopK selections must agree exactly (ties included: both
take the lower index first).  ``bsr_spgemm_dense_rhs`` must agree to 1e-6
of the largest |value| in float32 (each block product sums in another
order), and in bfloat16, where both round every block product and every
partial sum to bfloat16, to one bfloat16 rounding step of the largest
|value| (2**-8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spgemm_bsr import bsr_spgemm_dense_rhs as ref_dense_rhs
from repro.sparse import formats as rf
from repro.sparse import topk as rtopk
from repro_torch.core.spgemm_bsr import bsr_spgemm_dense_rhs
from repro_torch.sparse import formats as tf
from repro_torch.sparse import topk

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]


def host(x):
    """A torch tensor or JAX array as numpy, bfloat16 widened exactly."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def same(got, want):
    np.testing.assert_array_equal(host(got), host(want))


def close(got, want, rel):
    want = host(want)
    np.testing.assert_allclose(host(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max(initial=1)))


def block_sparse(rng, n, m, block_shape, keep=0.5):
    """Dense (n, m) with whole blocks zeroed, each kept with prob. keep."""
    br, bc = block_shape
    x = rng.standard_normal((n, m)).astype(np.float32)
    kept = rng.random((n // br, m // bc)) < keep
    return x * np.kron(kept, np.ones(block_shape, np.float32))


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------

def test_from_numpy_carries_bfloat16_bit_for_bit():
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.standard_normal(60).astype(np.float32),
                           [0.0, -0.0, np.inf, -np.inf, 1e-40, 3e38]])
    jx = np.asarray(jnp.asarray(vals, jnp.bfloat16))
    got = tf.from_numpy(jx, device="cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  jx.view(np.int16))
    ints = np.arange(5, dtype=np.int32)
    t = tf.from_numpy(ints, device="cpu")
    t += 1  # a copy: the caller's array is untouched
    same(ints, np.arange(5))


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,m,block_shape,capacity", [
    (8, 12, (2, 3), None), (16, 16, (4, 4), 20), (6, 4, (3, 2), 5),
])
def test_bsr_from_dense_matches_reference(dt, n, m, block_shape, capacity):
    jdt, tdt = dt
    x = np.asarray(jnp.asarray(
        block_sparse(np.random.default_rng(n), n, m, block_shape), jdt))
    want = rf.bsr_from_dense(x, block_shape, capacity)
    for src in (x, tf.from_numpy(x, "cpu")):
        got = tf.bsr_from_dense(src, block_shape, capacity, device="cpu")
        for f in ("indptr", "indices", "blocks"):
            same(getattr(got, f), getattr(want, f))
        assert got.blocks.dtype == tdt
        assert got.shape == want.shape
        assert got.block_shape == want.block_shape
        assert (got.n_brows, got.n_bcols) == (want.n_brows, want.n_bcols)
        assert int(got.nnzb) == int(want.nnzb)
        same(tf.bsr_to_dense(got), rf.bsr_to_dense(want))


def test_bsr_from_arrays_carries_reference_bsr_across():
    x = block_sparse(np.random.default_rng(3), 12, 8, (4, 2))
    x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    ref = rf.bsr_from_dense(x, (4, 2), capacity=16)  # padded capacity
    got = tf.bsr_from_arrays(ref.indptr, ref.indices, ref.blocks, ref.shape,
                             device="cpu")
    assert got.blocks.dtype == torch.bfloat16
    same(tf.bsr_to_dense(got), rf.bsr_to_dense(ref))
    same(tf.bsr_to_dense(got), x)
    with pytest.raises(ValueError, match="indptr"):
        tf.bsr_from_arrays(ref.indptr[:-1], ref.indices, ref.blocks,
                           ref.shape, device="cpu")
    with pytest.raises(ValueError, match="blocks"):
        tf.bsr_from_arrays(ref.indptr, ref.indices, ref.blocks, (13, 8),
                           device="cpu")


def test_topk_rows_from_arrays_to_dense_accumulates_repeats():
    rng = np.random.default_rng(4)
    vals = rng.standard_normal((3, 4)).astype(np.float32)
    idx = np.array([[0, 5, 5, 2], [1, 1, 1, 1], [7, 6, 0, 3]], np.int32)
    want = rf.TopKRows(jnp.asarray(vals), jnp.asarray(idx), (3, 8))
    got = tf.topk_rows_from_arrays(vals, idx, (3, 8), device="cpu")
    assert got.k == want.k == 4
    same(got.to_dense(), want.to_dense())
    with pytest.raises(ValueError, match="values"):
        tf.topk_rows_from_arrays(vals, idx[:, :3], (3, 8), device="cpu")


# ---------------------------------------------------------------------------
# sparse/topk
# ---------------------------------------------------------------------------

def tie_heavy(rng, n, d):
    """Integer values in [-3, 3]: most rows hold many equal |values|."""
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("make", ["ties", "normal"])
@pytest.mark.parametrize("n,d,k", [(5, 16, 4), (8, 64, 13), (3, 7, 7)])
def test_topk_rows_and_mask_match_lax_top_k(dt, make, n, d, k):
    jdt, _ = dt
    rng = np.random.default_rng(d + k)
    x = tie_heavy(rng, n, d) if make == "ties" else \
        rng.standard_normal((n, d)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = tf.from_numpy(np.asarray(jx), "cpu")
    want = rtopk.topk_rows(jx, k)
    got = topk.topk_rows(tx, k)
    same(got.indices, want.indices)
    same(got.values, want.values)
    assert got.indices.dtype == torch.int32 and got.shape == want.shape
    same(topk.topk_mask(tx, k), rtopk.topk_mask(jx, k))


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("make", ["ties", "normal"])
@pytest.mark.parametrize("n,d,kb,block", [(6, 32, 2, 8), (4, 64, 3, 16),
                                          (3, 16, 4, 4)])
def test_block_topk_rows_matches_reference(dt, make, n, d, kb, block):
    jdt, _ = dt
    rng = np.random.default_rng(n * d)
    x = tie_heavy(rng, n, d) if make == "ties" else \
        rng.standard_normal((n, d)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    want = rtopk.block_topk_rows(jx, kb, block)
    got = topk.block_topk_rows(tf.from_numpy(np.asarray(jx), "cpu"), kb,
                               block)
    same(got.indices, want.indices)
    same(got.values, want.values)
    assert got.shape == want.shape


@pytest.mark.parametrize("make", ["ties", "normal"])
def test_topk_rows_st_gradient_matches_jax_grad(make):
    rng = np.random.default_rng(7)
    n, d, k = 6, 24, 5
    x = tie_heavy(rng, n, d) if make == "ties" else \
        rng.standard_normal((n, d)).astype(np.float32)
    g = rng.standard_normal((n, d)).astype(np.float32)

    def loss(v):
        return jnp.sum(rtopk.topk_rows_st(v, k) * g)

    want_y = rtopk.topk_rows_st(jnp.asarray(x), k)
    want_dx = jax.grad(loss)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = topk.topk_rows_st(tx, k)
    (y * torch.from_numpy(g)).sum().backward()
    same(y.detach(), want_y)
    same(tx.grad, want_dx)


# ---------------------------------------------------------------------------
# core/spgemm_bsr (the reference's XLA path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,m,block_shape,d,capacity", [
    (16, 24, (4, 4), 8, None), (8, 16, (8, 8), 32, 6), (12, 6, (3, 2), 5, 20),
])
def test_bsr_spgemm_dense_rhs_matches_reference(dt, n, m, block_shape, d,
                                                capacity):
    jdt, tdt = dt
    rng = np.random.default_rng(m + d)
    a = np.asarray(jnp.asarray(block_sparse(rng, n, m, block_shape), jdt))
    x = np.asarray(jnp.asarray(rng.standard_normal((m, d)), jdt))
    want = ref_dense_rhs(rf.bsr_from_dense(a, block_shape, capacity),
                         jnp.asarray(x))
    got = bsr_spgemm_dense_rhs(
        tf.bsr_from_dense(a, block_shape, capacity, device="cpu"),
        tf.from_numpy(x, "cpu"))
    assert got.dtype == tdt and got.shape == want.shape
    close(got, want, 1e-6 if tdt == torch.float32 else 2.0 ** -8)
