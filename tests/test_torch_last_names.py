"""The last public names of the JAX package that the port gives under the
reference's name, against the reference, on the CPU: ``core.hashtable``'s
``HashTable``, ``make_table`` and ``insert``; ``core.phases``'s batched
gathers, products and scatter; ``core.executor.BATCHED_GATHERS``;
``core.ref.intermediate_products_dense``; ``kernels.hash_accum``'s
``EMPTY`` and ``MULTIPLIER``; ``models.transformer.Transformer``; and
``launch.dryrun``'s HLO collective count.  Inputs are numpy-built
(small integers, so products and sums are exact); results are held bit
for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core import hashtable as ref_ht
from repro.core import phases as ref_phases
from repro.core.ref import intermediate_products_dense as ref_ip_dense
from repro.kernels import hash_accum as ref_hash_accum
from repro.models import transformer as ref_tf
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.core import executor, hashtable, phases
from repro_torch.core.ref import intermediate_products_dense
from repro_torch.kernels import hash_accum
from repro_torch.launch.dryrun import COLLECTIVE_RE, collective_bytes_from_hlo
from repro_torch.models import Transformer
from repro_torch.sparse import csr_from_dense


def _same_table(t, r):
    np.testing.assert_array_equal(t.keys.numpy(), np.asarray(r.keys))
    np.testing.assert_array_equal(t.vals.numpy(), np.asarray(r.vals))
    assert int(t.count) == int(r.count)


@pytest.mark.parametrize("capacity", [8, 13])
@pytest.mark.parametrize("accumulate", [True, False])
def test_hash_table_inserts_match_reference(capacity, accumulate):
    """A stream with repeats, padding keys and, for 8 slots, more distinct
    keys than slots (the reference drops the overflow)."""
    rng = np.random.default_rng(capacity)
    keys = rng.integers(-1, 40, 24).astype(np.int32)
    vals = rng.integers(-4, 5, 24).astype(np.float32)
    t = hashtable.make_table(capacity, device="cpu")
    r = ref_ht.make_table(capacity)
    _same_table(t, r)
    assert isinstance(t, hashtable.HashTable)
    assert t._fields == ref_ht.HashTable._fields
    ref_insert = jax.jit(ref_ht.insert, static_argnames="accumulate")
    for k, v in zip(keys, vals):
        before = t.keys.clone()
        t = hashtable.insert(t, int(k), float(v), accumulate=accumulate)
        r = ref_insert(r, jnp.int32(k), jnp.float32(v),
                       accumulate=accumulate)
        _same_table(t, r)
        if k < 0:
            assert torch.equal(t.keys, before)


def test_hash_constants_match_reference():
    assert hash_accum.EMPTY == ref_hash_accum.EMPTY == hashtable.EMPTY
    assert hash_accum.MULTIPLIER == ref_hash_accum.MULTIPLIER \
        == int(ref_ht.MULTIPLIER)


def _batched_operands(seed=0, n=12, batch=3, a_cap=4, kb=3):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((n, n)) < 0.3,
                 rng.integers(1, 5, (n, n)), 0).astype(np.float32)
    a, ra = csr_from_dense(x, device="cpu"), ref_csr_from_dense(x)
    data_b = rng.integers(-3, 4, (batch, a.indices.shape[0])) \
        .astype(np.float32)
    rows = np.array([0, 3, -1, 7, 11], np.int32)
    b_idx = rng.integers(-1, n, (n, kb)).astype(np.int32)
    b_val_b = rng.integers(-3, 4, (batch, n, kb)).astype(np.float32)
    return a, ra, data_b, rows, a_cap, b_idx, b_val_b


def test_batched_phases_match_reference():
    a, ra, data_b, rows, a_cap, b_idx, b_val_b = _batched_operands()
    cols, vals = phases.gather_group_rows_batched(
        a.indptr, a.indices, torch.from_numpy(data_b),
        torch.from_numpy(rows), a_cap)
    rcols, rvals = ref_phases.gather_group_rows_batched(
        ra.indptr, ra.indices, jnp.asarray(data_b), jnp.asarray(rows),
        a_cap)
    np.testing.assert_array_equal(cols.numpy(), np.asarray(rcols))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))

    for name in ("xla", "aia"):
        bi, bv = executor.BATCHED_GATHERS[name](
            torch.from_numpy(b_idx), torch.from_numpy(b_val_b), cols)
        rbi, rbv = ref_executor.BATCHED_GATHERS["xla"](
            jnp.asarray(b_idx), jnp.asarray(b_val_b), rcols)
        np.testing.assert_array_equal(bi.numpy(), np.asarray(rbi))
        np.testing.assert_array_equal(bv.numpy(), np.asarray(rbv))
    assert set(executor.BATCHED_GATHERS) == set(ref_executor.BATCHED_GATHERS)

    keys, pv = phases.combine_products_batched(cols, vals, bi, bv)
    rkeys, rpv = ref_phases.combine_products_batched(rcols, rvals, rbi, rbv)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(rkeys))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(rpv))

    # one chunk of two rows, each with 2 of its 3 slots kept, written at
    # offsets 0 and 2 of a 4-entry output
    out_cols = torch.tensor([[1, 4, -1], [0, 2, -1]], dtype=torch.int32)
    out_vals = torch.arange(18, dtype=torch.float32).reshape(3, 2, 3)
    counts = torch.tensor([2, 2], dtype=torch.int32)
    starts = torch.tensor([0, 2], dtype=torch.int32)
    idx_buf, dat_buf = phases.reassemble_device_batched(
        torch.zeros(5, dtype=torch.int32), torch.zeros(3, 5), out_cols,
        out_vals, counts, starts)
    ridx, rdat = ref_phases.reassemble_device_batched(
        jnp.zeros(4, jnp.int32), jnp.zeros((3, 4)), jnp.asarray(out_cols),
        jnp.asarray(out_vals), jnp.asarray(counts), jnp.asarray(starts))
    np.testing.assert_array_equal(idx_buf[:4].numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(dat_buf[:, :4].numpy(), np.asarray(rdat))


def test_intermediate_products_dense_matches_reference():
    rng = np.random.default_rng(3)
    x = np.where(rng.random((20, 20)) < 0.25, 1.0, 0.0).astype(np.float32)
    a, ra = csr_from_dense(x, device="cpu"), ref_csr_from_dense(x)
    got = intermediate_products_dense(a, a)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref_ip_dense(ra, ra))


def test_transformer_record_matches_reference():
    assert Transformer._fields == ref_tf.Transformer._fields
    t = Transformer(cfg="c", params={"embed": 1})
    assert (t.cfg, t.params) == ("c", {"embed": 1})


def _ref_collective_bytes_from_hlo():
    """The reference's function; its module sets ``XLA_FLAGS`` when it is
    imported, so the variable is put back at once (the backend of this
    process is not touched)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import collective_bytes_from_hlo as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


def test_collective_bytes_from_hlo_matches_reference():
    """The reference's HLO count (its regex, copied) on HLO text."""
    hlo = "\n".join([
        "%all-reduce.1 = f32[8,16]{1,0} all-reduce(f32[8,16]{1,0} %p)",
        "%all-gather.2 = bf16[4,4]{1,0} all-gather(bf16[2,4]{1,0} %q)",
        "%all-reduce-start = (s32[10]{0}) all-reduce-start(s32[10]{0} %r)",
        "%reduce-scatter = f32[4]{0} reduce-scatter(f32[16]{0} %s)",
        "%cp = u8[3,3]{1,0} collective-permute(u8[3,3]{1,0} %t)",
        "%add.4 = f32[8,16]{1,0} add(f32[8,16]{1,0} %a, f32[8,16] %b)",
    ])
    got = collective_bytes_from_hlo(hlo)
    assert got == _ref_collective_bytes_from_hlo()(hlo)
    assert set(got) == {"all-reduce", "all-gather", "reduce-scatter",
                        "collective-permute"}
    assert COLLECTIVE_RE.pattern.startswith("(all-gather|all-reduce|")
