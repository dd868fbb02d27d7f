"""The port's sharded SpGEMM executor against the JAX package's, on the CPU.

The mesh is a list of logical CPU shards (``[torch.device("cpu")] * n``),
so every line a multi-card mesh runs runs here but the copies between
cards.  The reference runs in-process on its one CPU device: its own suite
holds its sharded results bit-identical to ``mesh=None``
(``tests/test_sharded_executor.py``), so the port's sharded result is held
against the reference's ``mesh=None`` result and the port's own.

One banded operand (footprints well under B's rows, so ``operands="auto"``
places blocks) with a few dense rows (Table-I groups 0, 1 and 2 all
populated), small-integer values: every product and sum is exact in
float32, and every comparison is bit for bit.  The host-side pieces
(partition, footprints, blocks, remap, segment packing and merge) are held
equal to the reference's on the same inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core import phases as ref_phases
from repro.core.grouping import group_rows as ref_group_rows
from repro.core.grouping import support_footprint as ref_support_footprint
from repro.core.spgemm import spgemm as ref_spgemm
from repro.launch import sharding as ref_sharding
from repro.sparse import ops as ref_ops
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.core import executor, phases
from repro_torch.core.grouping import group_rows, support_footprint
from repro_torch.core.spgemm import (
    PlanCache, spgemm, spgemm_batched, spgemm_streamed)
from repro_torch.launch import sharding
from repro_torch.launch.mesh import make_spgemm_mesh
from repro_torch.sparse import ops
from repro_torch.sparse.formats import csr_from_dense

SHARDS = (1, 2, 4, 8)
ENGINES = ("sort", "hash", "fused_hash")
GATHERS = ("xla", "aia")
SIZINGS = ("measured", "planned")
ROW_CHUNK = 16
N = 96  # the operand's rows and columns


def cpu_mesh(n):
    return [torch.device("cpu")] * n


@functools.lru_cache(maxsize=None)
def banded():
    """A 96 x 96 banded matrix (half-width 6) whose rows 0-3 also hold
    columns 0-39, and whose last 12 rows hold their diagonal only."""
    rng = np.random.default_rng(7)
    n = N
    i, j = np.indices((n, n))
    mask = np.abs(i - j) <= 6
    mask[:4, :40] = True
    mask[n - 12:] = i[n - 12:] == j[n - 12:]
    vals = rng.integers(1, 4, (n, n)) * rng.choice([-1, 1], (n, n))
    return np.where(mask, vals, 0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def operands():
    x = banded()
    return csr_from_dense(x, device="cpu"), ref_csr_from_dense(x)


@functools.lru_cache(maxsize=None)
def reference_product():
    """The reference's ``mesh=None`` self-product: indptr, indices and
    values over the occupied slots.  On these small integers every engine
    and chunking gives the same product exactly (the reference's suite
    holds its engines to one another), so its sort engine at its default
    chunking, the quickest to compile, stands for all of them."""
    _, ra = operands()
    c = ref_spgemm(ra, ra, engine="sort").c
    ipt = np.asarray(c.indptr)
    nnz = int(ipt[-1])
    return ipt, np.asarray(c.indices)[:nnz], np.asarray(c.data)[:nnz]


def assert_product(c, want):
    ipt, idx, dat = want
    nnz = int(ipt[-1])
    np.testing.assert_array_equal(c.indptr.numpy(), ipt)
    np.testing.assert_array_equal(c.indices[:nnz].numpy(), idx)
    np.testing.assert_array_equal(c.data[:nnz].numpy(), dat)


@pytest.fixture(autouse=True)
def _clean():
    executor.clear_program_cache()
    yield


def test_fixture_spans_three_groups_and_small_footprints():
    a, _ = operands()
    plan = group_rows(a, a)
    assert all(plan.group_sizes[g] > 0 for g in range(3))
    items = executor.partition_plan(plan, np.diff(a.indptr.numpy()),
                                    ROW_CHUNK, n_shards=4)
    fps = executor.shard_footprints(items, a.indptr.numpy(),
                                    a.indices.numpy(), 4)
    assert max(len(fp) for fp in fps) < executor.FOOTPRINT_THRESHOLD * N


# ---------------------------------------------------------------------------
# Host-side pieces, equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_partition_plan_matches_reference(n_shards):
    a, ra = operands()
    nnz = np.diff(a.indptr.numpy())
    got = executor.partition_plan(group_rows(a, a), nnz, ROW_CHUNK,
                                  n_shards=n_shards)
    want = ref_executor.partition_plan(ref_group_rows(ra, ra), nnz,
                                       ROW_CHUNK, n_shards=n_shards)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.group, g.shard, g.a_cap, g.table_cap, g.engine) == \
            (w.group, w.shard, w.a_cap, w.table_cap, w.engine)
        np.testing.assert_array_equal(g.rows, w.rows)


@pytest.mark.parametrize("n_shards", (2, 8))
def test_shard_footprints_match_reference(n_shards):
    """Including the ``[0]`` footprint of a shard with no work (the chunks
    of a two-shard partition footprinted over three shards)."""
    a, _ = operands()
    ipt, idx = a.indptr.numpy(), a.indices.numpy()
    items = executor.partition_plan(group_rows(a, a), np.diff(ipt), 64,
                                    n_shards=n_shards)
    for k in (n_shards, n_shards + 1):
        got = executor.shard_footprints(items, ipt, idx, k)
        want = ref_executor.shard_footprints(items, ipt, idx, k)
        assert len(got) == len(want) == k
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[-1].tolist() == [0]
    rows = np.asarray([0, 5, 77, 95, 3])
    np.testing.assert_array_equal(support_footprint(ipt, idx, rows),
                                  ref_support_footprint(ipt, idx, rows))
    assert support_footprint(ipt, idx, np.empty(0, np.int64)).size == 0


def test_place_operand_block_and_remap_match_reference():
    rng = np.random.default_rng(3)
    b_idx = rng.integers(-1, 50, (40, 6)).astype(np.int32)
    b_val = rng.standard_normal((40, 6)).astype(np.float32)
    rows = np.asarray([1, 4, 5, 17, 39])
    got = sharding.place_operand_block(torch.from_numpy(b_idx),
                                       torch.from_numpy(b_val), rows,
                                       torch.device("cpu"))
    want = ref_sharding.place_operand_block(jnp.asarray(b_idx),
                                            jnp.asarray(b_val), rows,
                                            jax.devices()[0])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.int32
    cols = np.asarray([[1, 4, -1, 2], [39, 0, 17, -1]], np.int32)
    np.testing.assert_array_equal(
        phases.remap_columns(torch.from_numpy(cols), got[2]).numpy(),
        np.asarray(ref_phases.remap_columns(jnp.asarray(cols),
                                            jnp.asarray(np.asarray(want[2])))))


def _chunk(rng, r=6, out_cap=5, batch=None):
    counts = rng.integers(0, out_cap + 1, r).astype(np.int32)
    counts[-1] = 0  # a padding row
    cols = rng.integers(0, 90, (r, out_cap)).astype(np.int32)
    shape = (r, out_cap) if batch is None else (batch, r, out_cap)
    vals = rng.standard_normal(shape).astype(np.float32)
    starts = (np.cumsum(counts) - counts + 11).astype(np.int32)
    return cols, vals, counts, starts


@pytest.mark.parametrize("batch", (None, 3))
def test_segment_pack_and_merge_match_reference(batch):
    """Two chunks packed into one segment (the second one overflowing it:
    its tail slots are dropped) and merged into the final buffers; the
    port's buffers carry a trailing sink slot, the reference's drop the
    sentinel positions.  Unused segment slots keep the sentinel."""
    rng = np.random.default_rng(5)
    seg_cap, cap = 24, 80
    lead = () if batch is None else (batch,)
    t_seg = [torch.zeros(seg_cap + 1, dtype=torch.int32),
             torch.zeros(lead + (seg_cap + 1,)),
             torch.full((seg_cap + 1,), cap, dtype=torch.int32),
             torch.zeros((), dtype=torch.int32)]
    r_seg = (jnp.zeros(seg_cap, jnp.int32), jnp.zeros(lead + (seg_cap,)),
             jnp.full(seg_cap, cap, jnp.int32), jnp.zeros((), jnp.int32))
    pack = phases.reassemble_segment if batch is None \
        else phases.reassemble_segment_batched
    ref_pack = ref_phases.reassemble_segment if batch is None \
        else ref_phases.reassemble_segment_batched
    for _ in range(2):
        cols, vals, counts, starts = _chunk(rng, r=6 if _ == 0 else 8,
                                            batch=batch)
        t_seg = list(pack(*t_seg, *(torch.from_numpy(x) for x in
                                    (cols, vals, counts, starts))))
        r_seg = ref_pack(*r_seg, *(jnp.asarray(x) for x in
                                   (cols, vals, counts, starts)))
    for g, w in zip(t_seg, r_seg):
        np.testing.assert_array_equal(g[..., :seg_cap].numpy()
                                      if g.dim() else g.numpy(),
                                      np.asarray(w))
    assert int(t_seg[2][-1]) == cap  # the sink slot keeps the sentinel
    merge = phases.merge_segments if batch is None \
        else phases.merge_segments_batched
    ref_merge = ref_phases.merge_segments if batch is None \
        else ref_phases.merge_segments_batched
    idx_buf, dat_buf = merge(torch.zeros(cap + 1, dtype=torch.int32),
                             torch.zeros(lead + (cap + 1,)), *t_seg[:3])
    want = ref_merge(jnp.zeros(cap, jnp.int32), jnp.zeros(lead + (cap,)),
                     *r_seg[:3])
    np.testing.assert_array_equal(idx_buf[:cap].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(dat_buf[..., :cap].numpy(),
                                  np.asarray(want[1]))


# ---------------------------------------------------------------------------
# The executor on logical CPU shards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_grid_bit_exact(n_shards, engine):
    """Every gather x sizing on ``n_shards`` shards: the reference's
    ``mesh=None`` product bit for bit; one coalesced read on the measured
    lane, none on the planned lane, whatever the shard count."""
    a, _ = operands()
    want = reference_product()
    for gather in GATHERS:
        for sizing in SIZINGS:
            before = executor.cache_stats()["host_sync_count"]
            res = spgemm(a, a, engine=engine, gather=gather, sizing=sizing,
                         row_chunk=ROW_CHUNK, mesh=cpu_mesh(n_shards))
            syncs = executor.cache_stats()["host_sync_count"] - before
            assert syncs == (1 if sizing == "measured" else 0)
            assert res.info["n_shards"] == n_shards
            assert_product(res.c, want)


@pytest.mark.parametrize("n_shards", (1, 4))
def test_legacy_lane_under_a_mesh(n_shards):
    a, _ = operands()
    before = executor.cache_stats()["host_sync_count"]
    res = spgemm(a, a, engine="hash", pipeline="legacy",
                 row_chunk=ROW_CHUNK, mesh=cpu_mesh(n_shards))
    items = executor.partition_plan(group_rows(a, a),
                                    np.diff(a.indptr.numpy()), ROW_CHUNK,
                                    n_shards=n_shards)
    assert executor.cache_stats()["host_sync_count"] - before == len(items)
    assert_product(res.c, reference_product())


@pytest.mark.parametrize("n_shards", (2, 4, 8))
def test_operand_placements_identical(n_shards):
    """``operands`` auto, footprint and replicate give one product; the
    blocks place fewer B rows and bytes than the replicas."""
    a, _ = operands()
    out = {}
    for placement in ("replicate", "footprint", "auto"):
        before = executor.cache_stats()
        res = spgemm(a, a, engine="fused_hash", row_chunk=ROW_CHUNK,
                     mesh=cpu_mesh(n_shards), operands=placement,
                     operand_cache=executor.OperandCache())
        after = executor.cache_stats()
        out[placement] = {k: after[k] - before[k] for k in (
            "operand_bytes_placed", "operand_rows_footprint",
            "operand_rows_total")}
        assert_product(res.c, reference_product())
    rep, fp, auto = out["replicate"], out["footprint"], out["auto"]
    assert rep["operand_rows_footprint"] == rep["operand_rows_total"] \
        == n_shards * N
    assert fp["operand_rows_footprint"] < fp["operand_rows_total"]
    assert fp["operand_bytes_placed"] < rep["operand_bytes_placed"]
    items = executor.partition_plan(group_rows(a, a),
                                    np.diff(a.indptr.numpy()), ROW_CHUNK,
                                    n_shards=n_shards)
    fps = executor.shard_footprints(items, a.indptr.numpy(),
                                    a.indices.numpy(), n_shards)
    limit = executor.FOOTPRINT_THRESHOLD * N
    assert fp["operand_rows_footprint"] == sum(len(f) for f in fps)
    # "auto" keeps the replica where a footprint reaches the threshold
    assert auto["operand_rows_footprint"] == sum(
        len(f) if len(f) < limit else N for f in fps)


def test_footprint_counters_match_reference_on_one_shard():
    """``tests/test_sharded_executor.py``'s forced-footprint case on one
    shard (on the sort engine: the counters do not depend on it): the
    counters equal the reference's, replicate and footprint."""
    a, ra = operands()

    def delta(stats, fn):
        before = stats()
        fn()
        after = stats()
        return {k: after[k] - before[k] for k in (
            "operand_bytes_placed", "operand_rows_footprint",
            "operand_rows_total")}

    for placement in ("replicate", "footprint"):
        got = delta(executor.cache_stats, lambda: spgemm(
            a, a, engine="sort", operands=placement, mesh=cpu_mesh(1),
            operand_cache=executor.OperandCache()))
        want = delta(ref_executor.cache_stats, lambda: ref_spgemm(
            ra, ra, engine="sort", operands=placement,
            operand_cache=ref_executor.OperandCache()))
        assert got == want, placement


def test_partition_and_footprints_reused_on_a_plan_hit():
    a, _ = operands()
    cache = PlanCache()
    kw = dict(engine="sort", row_chunk=ROW_CHUNK, mesh=cpu_mesh(4),
              operands="footprint", plan=cache)
    spgemm(a, a, **kw)
    sizes = (len(executor._PARTITION_CACHE), len(executor._FOOTPRINT_CACHE))
    assert sizes[0] > 0 and sizes[1] > 0
    before = executor.cache_stats()["operand_hits"]
    spgemm(a, a, **kw)
    assert (len(executor._PARTITION_CACHE),
            len(executor._FOOTPRINT_CACHE)) == sizes
    assert cache.hits == 1
    assert executor.cache_stats()["operand_hits"] == before + 1


def test_operand_cache_keys_on_devices_and_footprints():
    """A hit never serves blocks built for another shard list or another
    footprint."""
    a, _ = operands()
    oc = executor.OperandCache()
    for mesh, placement in ((cpu_mesh(2), "footprint"),
                            (cpu_mesh(4), "footprint"),
                            (cpu_mesh(4), "replicate"),
                            (cpu_mesh(4), "footprint")):
        spgemm(a, a, engine="sort", row_chunk=ROW_CHUNK, mesh=mesh,
               operands=placement, operand_cache=oc)
    assert len(oc) == 3


@pytest.mark.parametrize("engine,n_shards,placement", (
    ("sort", 2, "replicate"), ("fused_hash", 4, "footprint")))
def test_batched_under_a_mesh_equals_a_loop(engine, n_shards, placement):
    a, _ = operands()
    rng = np.random.default_rng(11)
    nnz = int(a.nnz)
    members = []
    for _ in range(3):
        data = a.data.clone()
        data[:nnz] = torch.from_numpy(
            rng.integers(-3, 4, nnz).astype(np.float32))
        members.append(type(a)(a.indptr, a.indices, data, a.shape))
    res = spgemm_batched(members, members, engine=engine,
                         row_chunk=ROW_CHUNK, mesh=cpu_mesh(n_shards),
                         operands=placement)
    for m, c in zip(members, res.cs):
        want = spgemm(m, m, engine=engine, row_chunk=ROW_CHUNK).c
        nnz_c = int(want.indptr[-1])
        assert torch.equal(c.indptr, want.indptr)
        assert torch.equal(c.indices[:nnz_c], want.indices[:nnz_c])
        assert torch.equal(c.data[:nnz_c], want.data[:nnz_c])


def test_auto_engine_under_a_mesh():
    """``engine="auto"`` measures its bins on the mesh's shards and gives
    the reference's product (every engine's is the same here)."""
    a, _ = operands()
    cache = executor.AutotuneCache()
    for _ in range(4):
        res = spgemm(a, a, engine="auto", row_chunk=ROW_CHUNK,
                     mesh=cpu_mesh(4), autotune=cache)
        assert_product(res.c, reference_product())
    assert cache.stats()["hits"] >= 1


def test_streamed_under_a_mesh():
    a, _ = operands()
    res = spgemm_streamed(a, a, tile_rows=24, engine="fused_hash",
                          row_chunk=ROW_CHUNK, mesh=cpu_mesh(4),
                          operands="footprint")
    assert res.info["n_shards"] == 4 and res.info["n_tiles"] == 4
    assert_product(res.c, reference_product())


# ---------------------------------------------------------------------------
# csr_spmm under a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gather", GATHERS)
def test_csr_spmm_under_a_mesh_matches_reference(gather):
    """The forward and both gradients (X and A's values) on three shards
    against ``jax.grad`` of the reference's ``mesh=None`` product; on
    small integers every sum is exact, so bit for bit."""
    a, ra = operands()
    rng = np.random.default_rng(2)
    x_np = rng.integers(-3, 4, (N, 5)).astype(np.float32)
    w = rng.integers(-2, 3, (N, 5)).astype(np.float32)
    data = a.data.clone().requires_grad_()
    x = torch.from_numpy(x_np).requires_grad_()
    at = type(a)(a.indptr, a.indices, data, a.shape)
    y = ops.csr_spmm(at, x, gather=gather, mesh=cpu_mesh(3))
    (y * torch.from_numpy(w)).sum().backward()

    def loss(d, xx):
        ya = ref_ops.csr_spmm(type(ra)(ra.indptr, ra.indices, d, ra.shape),
                              xx, gather="xla")
        return jnp.sum(ya * w), ya

    (_, want), (g_d, g_x) = jax.value_and_grad(loss, (0, 1), has_aux=True)(
        ra.data, jnp.asarray(x_np))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g_x))
    np.testing.assert_array_equal(data.grad.numpy(), np.asarray(g_d))


# ---------------------------------------------------------------------------
# Meshes: what is one, and where the operands live
# ---------------------------------------------------------------------------

def test_make_spgemm_mesh_never_yields_a_cpu_device():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="shard devices"):
        make_spgemm_mesh(visible + 1)
    if visible == 0:
        with pytest.raises(ValueError, match="shard devices"):
            make_spgemm_mesh()


def test_mesh_validation():
    a, _ = operands()
    for bad in (object(), "cpu", torch.device("cpu"), 3):
        with pytest.raises(TypeError, match="a mesh is"):
            spgemm(a, a, mesh=bad)
    with pytest.raises(ValueError, match="mixes device types"):
        spgemm(a, a, mesh=[torch.device("cpu"), torch.device("meta")])
    with pytest.raises(ValueError, match="empty"):
        spgemm(a, a, mesh=[])
    with pytest.raises(ValueError, match="merge device"):
        spgemm(a, a, mesh=[torch.device("meta")] * 2)
    assert sharding.shard_devices(None) == [None]
    assert sharding.shard_devices(["cpu", "cpu"]) == cpu_mesh(2)


def test_row_sharding_and_replicate_to():
    assert sharding.row_sharding(cpu_mesh(4), 10) == \
        [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert sharding.row_sharding(cpu_mesh(4), 2) == \
        [(0, 1), (1, 2), (2, 2), (2, 2)]
    x = torch.arange(4)
    assert sharding.replicate_to(x, torch.device("cpu")) is x
    assert sharding.replicate_to(x, None) is x
    assert sharding.merge_device(cpu_mesh(3)) == torch.device("cpu")
