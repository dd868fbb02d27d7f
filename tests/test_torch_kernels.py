"""The port's kernel modules and phases against the JAX package, on the CPU.

On a CPU tensor each kernel wrapper runs its plain PyTorch version; these
tests hold those plain versions, and the phases built on them, against the
reference's Pallas kernels (interpret mode) and phases.  The CUDA kernels
themselves are held against the same plain versions on the card by
``chip_smoke.py``.  All comparisons are exact: the gather is a copy, and the
hash table sums each key in stream order exactly as the reference does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashtable as ref_ht
from repro.core import phases as ref_phases
from repro.kernels.aia_gather import gather_rows_any as ref_gather_rows_any
from repro.kernels.hash_accum import hash_accumulate as ref_hash_accumulate
from repro_torch.core import hashtable, phases
from repro_torch.kernels import _build, aia_gather, hash_accum, ops


# the reference's helpers, jitted once each (eager JAX compiles op by op)
ref_gather_group_rows = jax.jit(ref_phases.gather_group_rows,
                                static_argnums=4)
ref_enumerate_products = jax.jit(ref_phases.enumerate_products)
ref_reassemble_device = jax.jit(ref_phases.reassemble_device)
ref_hash = jax.jit(ref_ht._hash, static_argnums=1)


def t(x):
    return torch.from_numpy(np.array(x))


def same(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def random_stream(rng, r, ip_cap, n_cols, dtype=np.float32):
    keys = rng.integers(0, n_cols, (r, ip_cap)).astype(np.int32)
    pad = rng.random((r, ip_cap)) < 0.3
    keys = np.where(pad, -1, keys)
    vals = np.where(pad, 0, rng.standard_normal((r, ip_cap))).astype(dtype)
    return keys, vals


# ---------------------------------------------------------------------------
# K1: the AIA row gather
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d,n_idx", [(40, 14, 21), (7, 8, 8), (1, 3, 5),
                                       (33, 1, 64)])
def test_gather_rows_matches_reference_kernel(n, d, n_idx):
    rng = np.random.default_rng(n_idx)
    idx = rng.integers(-3, n + 3, n_idx).astype(np.int32)  # ids out of range
    planes = (rng.integers(-1, 50, (n, d)).astype(np.int32),
              rng.standard_normal((n, d)).astype(np.float32))
    for x in planes:
        want = ref_gather_rows_any(jnp.asarray(x), jnp.asarray(idx),
                                   interpret=True)
        same(aia_gather.gather_rows_any(t(x), t(idx)), want)
        same(aia_gather.gather_rows_plain(t(x), t(idx)), want)


def test_wrappers_run_plain_on_cpu_and_count_no_launch():
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    keys, vals = random_stream(rng, 3, 9, 5)
    aia_gather.gather_rows(t(vals), t(np.array([2, 0], np.int32)))
    hash_accum.hash_accumulate(t(keys), t(vals), 16)
    counts = ops.launch_counts()
    assert {"gather_rows", "hash_accumulate"} <= set(counts)
    assert all(n == 0 for n in counts.values())


def test_wrappers_refuse_other_devices():
    x = torch.zeros((4, 4), device="meta")
    idx = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        aia_gather.gather_rows(x, idx)
    with pytest.raises(ValueError, match="no kernel"):
        hash_accum.hash_accumulate(idx[None], x[:1, :2], 8)


def test_cuda_wrappers_validate_before_launch():
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="idx"):
        aia_gather._gather_rows_cuda(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        aia_gather._gather_rows_cuda(
            torch.zeros((4, 6), dtype=torch.int8)[:, ::2],
            torch.zeros(2, dtype=torch.int32))
    keys = torch.zeros((2, 5), dtype=torch.int32)
    with pytest.raises(ValueError, match="vals"):
        hash_accum._hash_accumulate_cuda(keys, torch.zeros((2, 5),
                                                           dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="must match"):
        hash_accum._hash_accumulate_cuda(keys, torch.zeros((2, 4)), 8)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="building the CUDA kernels failed"):
        _build.build()


# ---------------------------------------------------------------------------
# K2: Algorithm 4, slot for slot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("r,ip_cap,n_cols,table_cap", [
    (4, 16, 8, 16), (2, 32, 64, 64), (8, 8, 4, 8), (1, 64, 16, 32),
])
def test_hash_accumulate_matches_reference_kernel(r, ip_cap, n_cols,
                                                  table_cap):
    keys, vals = random_stream(np.random.default_rng(0), r, ip_cap, n_cols)
    want = ref_hash_accumulate(jnp.asarray(keys), jnp.asarray(vals),
                               table_cap, interpret=True)
    got = hash_accum.hash_accumulate(t(keys), t(vals), table_cap)
    for g, w in zip(got, want):  # cols, vals, counts: bit for bit
        same(g, w)


def test_hash_accumulate_full_table_drops_like_reference():
    """More distinct keys than slots: the probe bound drops the rest."""
    keys = np.array([[5, 9, 1, 7, 3, 9, -1, 11]], np.int32)
    vals = np.arange(1, 9, dtype=np.float32)[None]
    want = ref_hash_accumulate(jnp.asarray(keys), jnp.asarray(vals), 4,
                               interpret=True)
    for g, w in zip(hash_accum.hash_accumulate(t(keys), t(vals), 4), want):
        same(g, w)


@pytest.mark.parametrize("r,ip_cap,n_cols,table_cap,out_cap", [
    (4, 16, 8, 16, 8), (2, 32, 64, 64, 32), (8, 8, 4, 8, 4),
    (3, 100, 1000, 128, 128),
])
def test_hash_accumulate_sorted_matches_fused_phase(r, ip_cap, n_cols,
                                                    table_cap, out_cap):
    keys, vals = random_stream(np.random.default_rng(5), r, ip_cap, n_cols)
    want = ref_phases.fused_hash_sorted(jnp.asarray(keys), jnp.asarray(vals),
                                        table_cap, out_cap, kernel="xla")
    got = hash_accum.hash_accumulate_sorted(t(keys), t(vals), table_cap,
                                            out_cap)
    for g, w in zip(got, want):
        same(g, w)


def test_hash_slot_matches_reference():
    keys = np.array([0, 1, 7, 12345, 2**31 - 1, 99991], np.int32)
    for cap in (1, 8, 64, 1000, 8192, 65536):
        same(hashtable.hash_slot(t(keys), cap),
             ref_hash(jnp.asarray(keys), cap))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def test_allocate_and_accumulate_hash_match_reference():
    keys, vals = random_stream(np.random.default_rng(1), 6, 48, 20)
    same(phases.allocate_hash(t(keys), 64),
         ref_phases.allocate_hash(jnp.asarray(keys), 64))
    want = ref_phases.accumulate_hash(jnp.asarray(keys), jnp.asarray(vals), 64)
    for g, w in zip(phases.accumulate_hash(t(keys), t(vals), 64), want):
        same(g, w)


@pytest.mark.parametrize("out_cap", [4, 32])
def test_sort_engine_matches_reference(out_cap):
    """Float values: the CPU scatter-add sums in index order, like XLA."""
    keys, vals = random_stream(np.random.default_rng(2), 5, 40, 12)
    want = ref_phases.accumulate_sort(jnp.asarray(keys), jnp.asarray(vals),
                                      out_cap)
    for g, w in zip(phases.sort_unique(t(keys), t(vals), out_cap), want):
        same(g, w)
    same(phases.allocate_sort(t(keys)), ref_phases.allocate_sort(jnp.asarray(keys)))


def test_product_formation_matches_reference():
    rng = np.random.default_rng(3)
    x = np.where(rng.random((9, 6)) < 0.5, rng.standard_normal((9, 6)), 0)
    from repro.sparse.formats import csr_from_dense as ref_csr
    from repro_torch.sparse.formats import csr_from_dense
    ra = ref_csr(x.astype(np.float32))
    a = csr_from_dense(x.astype(np.float32), device="cpu")
    rows = np.array([4, 0, 8, -1, 2, -1], np.int32)
    cols, vals = phases.gather_group_rows(a.indptr, a.indices, a.data,
                                          t(rows), 5)
    want = ref_gather_group_rows(ra.indptr, ra.indices, ra.data,
                                        jnp.asarray(rows), 5)
    same(cols, want[0])
    same(vals, want[1])
    b_idx = rng.integers(-1, 9, (6, 4)).astype(np.int32)
    b_val = rng.standard_normal((6, 4)).astype(np.float32)
    got = phases.enumerate_products(cols, vals, t(b_idx), t(b_val))
    ref = ref_enumerate_products(want[0], want[1], jnp.asarray(b_idx),
                                        jnp.asarray(b_val))
    for g, w in zip(got, ref):
        same(g, w)


def test_reassemble_device_matches_reference():
    rng = np.random.default_rng(4)
    counts = np.array([2, 0, 3, 1], np.int32)
    starts = np.array([0, 2, 2, 5], np.int32)
    cols = rng.integers(0, 9, (4, 3)).astype(np.int32)
    vals = rng.standard_normal((4, 3)).astype(np.float32)
    want = ref_reassemble_device(
        jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.float32), jnp.asarray(cols),
        jnp.asarray(vals), jnp.asarray(counts), jnp.asarray(starts))
    idx_buf, dat_buf = phases.reassemble_device(
        torch.zeros(9, dtype=torch.int32), torch.zeros(9), t(cols), t(vals),
        t(counts), t(starts))
    same(idx_buf[:8], want[0])
    same(dat_buf[:8], want[1])
