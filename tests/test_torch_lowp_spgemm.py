"""SpGEMM and the CSR primitives in bfloat16 and float16, the port against the
JAX package, on the CPU.

The operands are built in numpy from a seed in float32 and cast to the low
precision on both sides.  The reference takes such operands on every engine;
the port's plain versions (the segment sum's ``_add_rounded``, the hash
table's adds in the values' dtype) round each add to the values' type as
XLA's scatter-add and the reference's table do, so every comparison is bit
for bit: indices, indptr and the values' 16-bit patterns.  (The CPU's
``index_add_`` sums a bf16 run in float32 and rounds once; at these
densities that misses the reference's bits.)  On the card the
segment-sum kernel and K2 add in float32 and round each add to the values'
type (``csrc/dtypes.cuh``'s ``round_to``); ``emulate_round`` repeats that
arithmetic here and is held to the plain version on runs that mix
magnitudes, where another rounding would give other bits.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.spgemm import spgemm as ref_spgemm
from repro.sparse import ops as ref_ops
from repro.sparse.formats import CSR as RefCSR
from repro.sparse.formats import csr_from_coo as ref_csr_from_coo
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.core.spgemm import spgemm
from repro_torch.kernels import hash_accum
from repro_torch.kernels import segment_sum as ss
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.formats import (csr_from_coo, csr_from_dense,
                                        csr_to_dense, ell_from_dense,
                                        from_numpy)

ENGINES = ("sort", "hash", "fused_hash")
LOWP = {"bf16": (torch.bfloat16, jnp.bfloat16, ml_dtypes.bfloat16),
        "f16": (torch.float16, jnp.float16, np.float16)}


def sparse_dense(rng, n, m, density):
    x = rng.standard_normal((n, m)).astype(np.float32)
    return np.where(rng.random((n, m)) < density, x, 0).astype(np.float32)


def bits(x) -> np.ndarray:
    """A 16-bit tensor or array as its bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.detach().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def pair(x, lowp):
    """A float32 dense matrix as (port CSR, reference CSR), values cast to
    the low precision after the compaction (the port's from a tensor of
    that dtype, through ``csr_from_dense``)."""
    tdt, jdt, _ = LOWP[lowp]
    a = csr_from_dense(torch.from_numpy(x).to(tdt), device="cpu")
    r = ref_csr_from_dense(x)
    r = RefCSR(r.indptr, r.indices, r.data.astype(jdt), r.shape)
    return a, r


@pytest.mark.parametrize("lowp", sorted(LOWP))
@pytest.mark.parametrize("engine", ENGINES)
def test_lowp_spgemm_matches_reference_bit_for_bit(lowp, engine):
    rng = np.random.default_rng(11)
    xa, xb = sparse_dense(rng, 40, 64, 0.4), sparse_dense(rng, 64, 44, 0.4)
    (a, ra), (b, rb) = pair(xa, lowp), pair(xb, lowp)
    got = spgemm(a, b, engine=engine)
    want = ref_spgemm(ra, rb, engine=engine)
    nnz = want.info["nnz_c"]
    assert got.info["nnz_c"] == nnz > 0
    assert got.c.data.dtype == LOWP[lowp][0]
    np.testing.assert_array_equal(got.c.indptr.numpy(),
                                  np.asarray(want.c.indptr))
    np.testing.assert_array_equal(got.c.indices[:nnz].numpy(),
                                  np.asarray(want.c.indices)[:nnz])
    np.testing.assert_array_equal(bits(got.c.data[:nnz]),
                                  bits(want.c.data)[:nnz])


def test_csr_from_dense_takes_a_bf16_tensor():
    """A bf16 tensor goes through float32 on the host and keeps its dtype
    and bits; the COO and ELL helpers do the same."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(sparse_dense(rng, 12, 9, 0.3)).bfloat16()
    a = csr_from_dense(x, device="cpu")
    assert a.data.dtype == torch.bfloat16
    assert torch.equal(csr_to_dense(a).view(torch.int16),
                       x.view(torch.int16))
    r = ref_csr_from_dense(np.asarray(x.float().numpy(), ml_dtypes.bfloat16))
    nnz = int(np.asarray(r.indptr)[-1])
    np.testing.assert_array_equal(a.indices[:nnz].numpy(),
                                  np.asarray(r.indices)[:nnz])
    np.testing.assert_array_equal(bits(a.data[:nnz]),
                                  bits(np.asarray(r.data)[:nnz]))
    e = ell_from_dense(x, device="cpu")
    assert e.data.dtype == torch.bfloat16
    rows, cols = np.nonzero(x.float().numpy())
    dup = torch.cat([x[rows, cols], x[rows, cols]])  # each entry twice
    c = csr_from_coo(np.r_[rows, rows], np.r_[cols, cols], dup, x.shape,
                     device="cpu")
    assert c.data.dtype == torch.bfloat16
    assert torch.equal(csr_to_dense(c), (x + x))


@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_csr_from_coo_rounds_each_merge_like_reference(lowp):
    """Three to five copies of each entry, of magnitudes 1e-3 to 1e2, in a
    shuffled stream: merged in ``np.add.at``'s order with every add
    rounded, bit for bit the reference's ``csr_from_coo`` on an array of
    that dtype.  Summing each run in float32 and rounding once gives other
    bits on these data (checked)."""
    tdt, _, ndt = LOWP[lowp]
    rng = np.random.default_rng(9)
    n, m = 6, 5
    cells = rng.choice(n * m, 14, replace=False)
    key = np.repeat(cells, rng.integers(3, 6, cells.size))
    rng.shuffle(key)
    vals = (rng.standard_normal(key.size)
            * 10.0 ** rng.integers(-3, 3, key.size)).astype(ndt)
    rows, cols = key // m, key % m
    got = csr_from_coo(rows, cols,
                       torch.from_numpy(vals.astype(np.float32)).to(tdt),
                       (n, m), device="cpu")
    want = ref_csr_from_coo(rows, cols, vals, (n, m))
    nnz = int(np.asarray(want.indptr)[-1])
    assert nnz == cells.size and got.data.dtype == tdt
    np.testing.assert_array_equal(got.indptr.numpy(),
                                  np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices[:nnz].numpy(),
                                  np.asarray(want.indices)[:nnz])
    np.testing.assert_array_equal(bits(got.data[:nnz]),
                                  bits(np.asarray(want.data)[:nnz]))
    order = np.lexsort((cols, rows))
    once = np.zeros(n * m, np.float32)
    np.add.at(once, key[order], vals[order].astype(np.float32))
    once = once[np.sort(cells)].astype(ndt)
    assert (bits(once) != bits(np.asarray(want.data)[:nnz])).any()


@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_lowp_csr_primitives_match_reference(lowp):
    """``csr_spmv``, ``csr_spmm`` (on a column slice of a wider X, through
    both gathers) and the column sums in the low precision."""
    tdt, jdt, _ = LOWP[lowp]
    rng = np.random.default_rng(4)
    a, ra = pair(sparse_dense(rng, 30, 20, 0.3), lowp)
    xv = rng.standard_normal(20).astype(np.float32)
    np.testing.assert_array_equal(
        bits(sparse_ops.csr_spmv(a, torch.from_numpy(xv).to(tdt))),
        bits(ref_ops.csr_spmv(ra, jnp.asarray(xv, jdt))))
    np.testing.assert_array_equal(
        bits(sparse_ops.csr_column_sums(a)),
        bits(ref_ops.csr_column_sums(ra)))
    wide = rng.standard_normal((20, 24)).astype(np.float32)
    x = torch.from_numpy(wide).to(tdt)[:, 4:12]  # rows 24 apart
    assert x.stride() == (24, 1) and not x.is_contiguous()
    want = ref_ops.csr_spmm(ra, jnp.asarray(wide[:, 4:12], jdt))
    for gather in ("xla", "aia"):
        np.testing.assert_array_equal(
            bits(sparse_ops.csr_spmm(a, x, gather=gather)), bits(want))


@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_lowp_hash_table_adds_in_the_values_dtype(lowp):
    """K2's plain version keeps the values' dtype and rounds each add to
    it, as the kernel's float32 add rounded to that type does."""
    tdt, _, ndt = LOWP[lowp]
    rng = np.random.default_rng(9)
    keys = rng.integers(0, 6, (3, 50)).astype(np.int32)
    keys[:, 40:] = -1
    vals = np.where(rng.random((3, 50)) < 0.3, 300.0,
                    rng.random((3, 50))).astype(np.float32)
    cols, out, cnt = hash_accum.hash_accumulate(
        torch.from_numpy(keys), torch.from_numpy(vals).to(tdt), 64)
    assert out.dtype == tdt
    for r in range(3):
        for key in range(6):
            terms = vals[r][(keys[r] == key)].astype(ndt)
            want = emulate_round(terms, ndt)
            slot = (cols[r] == key).nonzero()
            got = out[r, slot[0, 0]] if len(slot) else torch.zeros((), tdt)
            assert bits(got.reshape(1)) == bits(np.asarray([want], ndt))


def emulate_round(terms, ndt):
    """The kernels' add: float32 sum rounded to the values' type, left to
    right from +0."""
    acc = np.float32(0)
    for x in terms:
        acc = np.float32(ndt(np.float32(acc) + np.float32(x)))
    return ndt(acc)


@pytest.mark.parametrize("lowp", sorted(LOWP))
def test_segment_sum_kernel_rounding_matches_plain(lowp):
    """Runs that mix 300 and about 1: the plain segment sum equals the
    kernel's float32 add rounded to the values' type at every add, and
    differs from one rounding of the float32 sum."""
    tdt, _, ndt = LOWP[lowp]
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, 7, 200)).astype(np.int64)
    vals = np.where(rng.random(200) < 0.3, 300.0,
                    rng.random(200) + 0.5).astype(np.float32)
    got = ss.segment_sum(torch.from_numpy(ids),
                         torch.from_numpy(vals).to(tdt)[:, None], 7)[:, 0]
    lowv = vals.astype(ndt)
    want = np.asarray([emulate_round(lowv[ids == s], ndt) for s in range(7)],
                      ndt)
    np.testing.assert_array_equal(bits(got), bits(want))
    once = np.asarray([ndt(lowv[ids == s].astype(np.float32).sum())
                       for s in range(7)], ndt)
    assert (bits(once) != bits(want)).any()


def test_segment_sum_takes_more_value_sets_than_a_grid_holds():
    """70,000 value sets: the plain version here; the kernel walks its
    grid's y dimension in slices of 65,535."""
    ids = torch.tensor([0, 0, 2], dtype=torch.int64)
    vals = torch.arange(70_000 * 3, dtype=torch.float32).reshape(70_000, 3,
                                                                 1)
    out = ss.segment_sum(ids, vals, 3)
    assert out.shape == (70_000, 3, 1)
    assert torch.equal(out[:, 0, 0], vals[:, 0, 0] + vals[:, 1, 0])
    assert torch.equal(out[:, 2, 0], vals[:, 2, 0])
    assert not out[:, 1].any()


def test_from_numpy_still_carries_reference_bf16_arrays():
    x = jnp.asarray(np.linspace(-2, 2, 12, dtype=np.float32), jnp.bfloat16)
    got = from_numpy(np.asarray(x), "cpu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits(got), bits(np.asarray(x)))
    assert jax.devices()[0].platform == "cpu"
