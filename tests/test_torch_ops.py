"""The port's sparse-activation kernels behind ``kernels.ops`` against the
JAX package, on the CPU.

On a CPU tensor each ``ops`` wrapper runs its kernel's plain PyTorch
version; these tests hold those against the reference's Pallas kernels
(interpret mode, as ``tests/test_kernels.py`` runs them) and against
``repro.kernels.ops(..., backend="xla")``, with ``tests/test_kernels.py``'s
shapes in float32 and bfloat16.  The CUDA kernels are held against the
same plain versions on the card by ``chip_smoke.py``.

Tolerances: the ranged gather is a copy and must be bit-exact.
``topk_spmm`` rounds each product, then adds it, in ``t`` order from zero,
as the Pallas kernel's source reads; run in interpret mode on the CPU, XLA
fuses that multiply and add into one rounding (an FMA), so in float32 the
two agree to 1e-5 of the largest |value| (they differ in the last bit of
some sums), while in bfloat16, whose products are exact in float32, they
must agree bit for bit.  ``bsr_spmm`` and
``block_topk_spmm`` form bfloat16 products exactly in float32 in both
packages but sum each block product in another order: within 1e-5 of the
largest |value|, in both dtypes.  Against the reference's einsum oracles
(``backend="xla"``) the float32 results agree to 1e-5 of the largest
|value|; the reference's XLA ``bsr_spmm`` returns bfloat16 for bfloat16
blocks, so it is held to one bfloat16 rounding step of the largest |value|
(2**-8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.spgemm_bsr import bsr_spgemm_dense_rhs as ref_dense_rhs
from repro.kernels import aia_gather as ref_aia
from repro.kernels import ops as ref_ops
from repro.kernels import spgemm_bsr as ref_bsr
from repro.kernels import topk_spmm as ref_topk
from repro.sparse import formats as rf
from repro.sparse import topk as rtopk
from repro_torch.kernels import aia_gather, ops
from repro_torch.sparse import formats as tf
from repro_torch.sparse import topk

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["f32", "bf16"]
REL = 1e-5


def host(x):
    """A torch tensor or JAX array as numpy, bfloat16 widened exactly."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def same(got, want):
    np.testing.assert_array_equal(host(got), host(want))


def close(got, want, rel=REL):
    want = host(want)
    np.testing.assert_allclose(host(got), want, rtol=rel,
                               atol=rel * float(np.abs(want).max(initial=1)))


def both(x, dtype=None):
    """``x`` as a JAX array (of ``dtype``) and the same values in torch."""
    jx = jnp.asarray(x, dtype)
    return jx, tf.from_numpy(np.asarray(jx), "cpu")


# ---------------------------------------------------------------------------
# K3: the ranged AIA gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n_blocks,r,d,n_idx", [
    (8, 1, 128, 16), (8, 2, 128, 5), (16, 4, 256, 32), (4, 8, 8, 3),
])
def test_aia_ranged_gather_matches_reference(dt, n_blocks, r, d, n_idx):
    jdt, _ = dt
    rng = np.random.default_rng(0)
    jx, tx = both(rng.standard_normal((n_blocks * r, d)), jdt)
    jidx, tidx = both(rng.integers(0, n_blocks, n_idx), jnp.int32)
    got = ops.aia_ranged_gather(tx, tidx, r)
    assert got.dtype == tx.dtype
    same(got, ref_aia.aia_ranged_gather(jx, jidx, r, interpret=True))
    same(got, ref_ops.aia_ranged_gather(jx, jidx, r, backend="xla"))
    same(ops.aia_ranged_gather(tx, tidx, r, backend="xla"), got)


def test_aia_ranged_gather_clips_out_of_range_ids():
    """The reference's contract is in-range ids; the port clips the rest to
    the first or last range, as the row gather does."""
    rng = np.random.default_rng(1)
    jx, tx = both(rng.standard_normal((12, 5)), jnp.float32)
    idx = np.array([-4, 0, 5, 2, 99], np.int32)
    want = ref_aia.aia_ranged_gather(jx, jnp.asarray(np.clip(idx, 0, 5)), 2,
                                     interpret=True)
    same(ops.aia_ranged_gather(tx, torch.from_numpy(idx), 2), want)


def test_aia_ranged_gather_refuses_bad_ranges():
    idx = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="4-byte"):
        aia_gather._aia_ranged_gather_cuda(
            torch.zeros((4, 3), dtype=torch.bfloat16), idx, 1)
    with pytest.raises(ValueError, match="whole number"):
        ops.aia_ranged_gather(torch.zeros((5, 4)), idx, 2)


# ---------------------------------------------------------------------------
# K4: BSR x dense
# ---------------------------------------------------------------------------

def random_bsr(rng, n_brows, n_bcols, bs, avg_blocks):
    """``tests/test_kernels.py``'s generator: sorted distinct block columns,
    1 to 2*avg_blocks of them per row."""
    rows = [sorted(rng.choice(
        n_bcols, size=min(n_bcols, 1 + rng.integers(0, 2 * avg_blocks)),
        replace=False).tolist()) for _ in range(n_brows)]
    rowptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    colidx = np.concatenate(rows)
    blocks = rng.standard_normal((len(colidx), bs, bs))
    return rowptr.astype(np.int32), colidx.astype(np.int32), blocks


def bsr_operands(rowptr, colidx, blocks, b, jdt):
    j = (jnp.asarray(rowptr), jnp.asarray(colidx), jnp.asarray(blocks, jdt),
         jnp.asarray(b, jdt))
    return j, tuple(tf.from_numpy(np.asarray(x), "cpu") for x in j)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n_brows,n_bcols,bs,d", [
    (4, 6, 8, 16), (8, 8, 16, 32), (3, 10, 8, 128), (1, 2, 8, 8),
])
def test_bsr_spmm_matches_reference(dt, n_brows, n_bcols, bs, d):
    jdt, tdt = dt
    rng = np.random.default_rng(3)
    rowptr, colidx, blocks = random_bsr(rng, n_brows, n_bcols, bs, 2)
    b = rng.standard_normal((n_bcols * bs, d))
    max_bpr = int(np.diff(rowptr).max())
    j, t = bsr_operands(rowptr, colidx, blocks, b, jdt)
    got = ops.bsr_spmm(*t, max_bpr)
    assert got.dtype == torch.float32
    close(got, ref_bsr.bsr_spmm(*j, max_blocks_per_row=max_bpr,
                                interpret=True))
    xla = ref_ops.bsr_spmm(*j, max_bpr, backend="xla")
    close(got, xla, REL if tdt == torch.float32 else 2.0 ** -8)
    port_xla = ops.bsr_spmm(*t, max_bpr, backend="xla")
    assert port_xla.dtype == tdt
    close(port_xla, xla, 1e-6 if tdt == torch.float32 else 2.0 ** -8)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_bsr_spmm_drops_blocks_past_max_blocks_per_row(dt):
    """The reference's grid has max_blocks_per_row steps per block-row, so
    a longer row loses its later blocks; the port drops them too."""
    jdt, _ = dt
    rng = np.random.default_rng(8)
    bs, d = 8, 16
    rowptr = np.array([0, 3, 4, 7], np.int32)  # rows of 3, 1 and 3 blocks
    colidx = np.array([0, 2, 3, 1, 3, 0, 1], np.int32)
    blocks = rng.standard_normal((7, bs, bs))
    b = rng.standard_normal((4 * bs, d))
    j, t = bsr_operands(rowptr, colidx, blocks, b, jdt)
    got = ops.bsr_spmm(*t, 2)
    close(got, ref_bsr.bsr_spmm(*j, max_blocks_per_row=2, interpret=True))
    full = ops.bsr_spmm(*t, 3)
    assert not np.allclose(host(got)[:bs], host(full)[:bs])
    same(got[bs:2 * bs], full[bs:2 * bs])  # the 1-block row is whole


def test_bsr_spmm_empty_row_gives_zeros():
    rowptr = np.array([0, 2, 2, 3], np.int32)  # row 1 empty
    colidx = np.array([0, 1, 1], np.int32)
    rng = np.random.default_rng(4)
    bs, d = 8, 16
    j, t = bsr_operands(rowptr, colidx, rng.standard_normal((3, bs, bs)),
                        rng.standard_normal((2 * bs, d)), jnp.float32)
    got = ops.bsr_spmm(*t, 2)
    close(got, ref_bsr.bsr_spmm(*j, max_blocks_per_row=2, interpret=True))
    assert float(got[bs:2 * bs].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# K5 and K6: TopK-SpMM per token and per tile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n,k,dff,d", [(4, 2, 16, 8), (16, 4, 64, 128),
                                       (3, 8, 32, 16)])
def test_topk_spmm_matches_reference(dt, n, k, dff, d):
    jdt, _ = dt
    rng = np.random.default_rng(5)
    jv, tv = both(rng.standard_normal((n, k)), jdt)
    ji, ti = both(rng.integers(0, dff, (n, k)), jnp.int32)
    jw, tw = both(rng.standard_normal((dff, d)), jdt)
    got = ops.topk_spmm(tv, ti, tw)
    assert got.dtype == torch.float32
    want = ref_topk.topk_spmm(jv, ji, jw, interpret=True)
    (same if jdt == jnp.bfloat16 else close)(got, want)
    close(got, ref_ops.topk_spmm(jv, ji, jw, backend="xla"))
    same(ops.topk_spmm(tv, ti, tw, backend="xla"), got)


def test_topk_spmm_duplicate_ids_accumulate():
    vals = torch.tensor([[1.0, 2.0]])
    idx = torch.tensor([[3, 3]], dtype=torch.int32)
    w2 = torch.from_numpy(np.eye(8, 4, k=-3, dtype=np.float32))  # row 3: e0
    same(ops.topk_spmm(vals, idx, w2), [[3.0, 0, 0, 0]])


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("n_tiles,kb,tile,block,d", [
    (2, 2, 8, 16, 32), (4, 3, 8, 128, 64), (1, 1, 8, 8, 8),
])
def test_block_topk_spmm_matches_reference(dt, n_tiles, kb, tile, block, d):
    jdt, _ = dt
    rng = np.random.default_rng(6)
    n_blocks = kb + 2
    jh, th = both(rng.standard_normal((n_tiles, kb, tile, block)), jdt)
    jb, tb = both(np.stack([rng.choice(n_blocks, kb, replace=False)
                            for _ in range(n_tiles)]), jnp.int32)
    jw, tw = both(rng.standard_normal((n_blocks * block, d)), jdt)
    got = ops.block_topk_spmm(th, tb, tw, block)
    assert got.dtype == torch.float32
    close(got, ref_topk.block_topk_spmm(jh, jb, jw, block=block,
                                        interpret=True))
    close(got, ref_ops.block_topk_spmm(jh, jb, jw, block, backend="xla"))


# ---------------------------------------------------------------------------
# The ops policy
# ---------------------------------------------------------------------------

def small_operands(device="cpu"):
    f = dict(device=device)
    i = dict(dtype=torch.int32, device=device)
    return {
        "aia_ranged_gather": (torch.zeros((4, 2), **f), torch.zeros(2, **i),
                              2),
        "bsr_spmm": (torch.tensor([0, 1], **i), torch.zeros(1, **i),
                     torch.zeros((1, 2, 2), **f), torch.zeros((2, 3), **f),
                     1),
        "topk_spmm": (torch.zeros((2, 2), **f), torch.zeros((2, 2), **i),
                      torch.zeros((4, 3), **f)),
        "block_topk_spmm": (torch.zeros((1, 1, 2, 2), **f),
                            torch.zeros((1, 1), **i), torch.zeros((4, 3), **f),
                            2),
    }


@pytest.mark.parametrize("name", ["aia_ranged_gather", "bsr_spmm",
                                  "topk_spmm", "block_topk_spmm"])
def test_ops_refuse_tpu_backends_and_other_devices(name):
    fn = getattr(ops, name)
    args = small_operands()[name]
    for backend in ("pallas", "interpret", "triton"):
        with pytest.raises(ValueError, match="backend"):
            fn(*args, backend=backend)
    with pytest.raises(ValueError, match="no kernel"):
        fn(*small_operands("meta")[name])


def test_ops_on_cpu_launch_nothing():
    ops.reset_launch_counts()
    for name, args in small_operands().items():
        getattr(ops, name)(*args)
        getattr(ops, name)(*args, backend="xla")
    assert set(ops.launch_counts()) >= set(small_operands())
    assert all(n == 0 for n in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The whole slice, carried across from the JAX package's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_topk_ffn_down_projection_matches_reference(dt):
    """topk_rows -> ops.topk_spmm equals the JAX ops.topk_spmm and
    ``topk_rows_st(h, k) @ w2`` (the last line of ``topk_ffn``)."""
    jdt, _ = dt
    rng = np.random.default_rng(9)
    n, d_ff, d, k = 16, 64, 24, 8
    jh, th = both(rng.standard_normal((n, d_ff)), jdt)
    jw, tw = both(rng.standard_normal((d_ff, d)) / 8, jdt)
    jk = rtopk.topk_rows(jh, k)
    want = ref_ops.topk_spmm(jk.values, jk.indices, jw, backend="interpret")
    tk = topk.topk_rows(th, k)
    got = ops.topk_spmm(tk.values, tk.indices, tw)
    (same if jdt == jnp.bfloat16 else close)(got, want)
    dense = topk.topk_rows_st(th.float(), k) @ tw.float()
    close(got, dense)
    close(dense, rtopk.topk_rows_st(jh.astype(jnp.float32), k)
          @ jw.astype(jnp.float32))


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_block_topk_rows_to_block_topk_spmm_matches_reference(dt):
    """block_topk_rows at tile 1 -> ops.block_topk_spmm equals the JAX
    kernel on the JAX selection."""
    jdt, _ = dt
    rng = np.random.default_rng(10)
    n, d_ff, d, kb, block = 8, 64, 16, 3, 8
    jh, th = both(rng.standard_normal((n, d_ff)), jdt)
    jw, tw = both(rng.standard_normal((d_ff, d)), jdt)
    jsel = rtopk.block_topk_rows(jh, kb, block)
    want = ref_ops.block_topk_spmm(
        jsel.values.reshape(n, kb, 1, block), jsel.indices, jw, block,
        backend="interpret")
    sel = topk.block_topk_rows(th, kb, block)
    same(sel.indices, jsel.indices)
    got = ops.block_topk_spmm(sel.values.reshape(n, kb, 1, block),
                              sel.indices, tw, block)
    close(got, want)


@pytest.mark.parametrize("dt", DTYPES, ids=DTYPE_IDS)
def test_bsr_from_dense_to_bsr_spmm_matches_reference(dt):
    """bsr_from_dense -> ops.bsr_spmm equals the JAX ops.bsr_spmm and the
    JAX core.spgemm_bsr, from the same dense matrix and from the JAX
    BSR's own arrays."""
    jdt, tdt = dt
    rng = np.random.default_rng(11)
    bs, nbr, nbc, d = 8, 4, 6, 16
    kept = rng.random((nbr, nbc)) < 0.4
    kept[2] = False  # an empty block-row
    a = rng.standard_normal((nbr * bs, nbc * bs)) * np.kron(
        kept, np.ones((bs, bs)))
    ja, ta = both(a, jdt)
    jb, tb = both(rng.standard_normal((nbc * bs, d)), jdt)
    jbsr = rf.bsr_from_dense(np.asarray(ja), (bs, bs))
    max_bpr = int(kept.sum(1).max())
    want = ref_ops.bsr_spmm(jbsr.indptr, jbsr.indices, jbsr.blocks, jb,
                            max_bpr, backend="interpret")
    want_xla = ref_dense_rhs(jbsr, jb)
    for bsr in (tf.bsr_from_dense(ta, (bs, bs), device="cpu"),
                tf.bsr_from_arrays(jbsr.indptr, jbsr.indices, jbsr.blocks,
                                   jbsr.shape, device="cpu")):
        got = ops.bsr_spmm(bsr.indptr, bsr.indices, bsr.blocks, tb, max_bpr)
        close(got, want)
        close(got, want_xla, REL if tdt == torch.float32 else 2.0 ** -8)
