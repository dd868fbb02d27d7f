"""The sorted segment sum (``repro_torch.kernels.segment_sum``) against the
reference's ``.at[ids].add``, on the CPU.

Inputs are built in numpy from a seed.  Every comparison is bit for bit:
the reference's scatter-add adds each output's updates one at a time in
update order, and so do the plain version (``index_add_`` on the CPU) and
the CUDA kernel.  The kernel cannot run here, so ``emulate`` repeats its
indexing (for one column a run found at its first entry and ended by
galloping; for wider rows each run's bounds marked once, short runs
packed several to a warp with the lanes' column map, runs past a
threshold on the block route in tiles; reads through ``order``, skipped
segments, adds left to right, each rounded to the values' type) and is
held against the plain version and the reference in the four value
types and, patched in as the plain version, through the port's call
sites against the reference.  ``emulate_keyless`` repeats the keyless
pass's split of the rows and its fixed order of partial sums
(``csrc/flash_attention.cu``), held against the plain attention and the
reference.  Float32 inputs mix magnitudes (1e8 and 1) over many
duplicates, so another order of adds gives other bits; the tests check
that it does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import markov_clustering as ref_mcl
from repro.apps.graphs import rmat_graph as ref_rmat
from repro.core import phases as ref_phases
from repro.sparse import ops as ref_ops
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.apps import markov_clustering
from repro_torch.apps.graphs import rmat_graph
from repro_torch.core import phases
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels._build import source_constants
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.formats import csr_from_arrays

# the kernel's constants (csrc/segment_sum.cu): threads a block, the block
# route's tile bytes
KERNEL = source_constants("segment_sum.cu")


def mixed(rng, shape, dtype=np.float32):
    """Values of mixed magnitude: each 1e8 (either sign) or about 1, so a
    run's sum depends on the order of its adds."""
    big = rng.random(shape) < 0.3
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    return np.where(big, sign * 1e8, rng.random(shape) + 0.5).astype(dtype)


def sorted_ids(rng, n, n_out, empty=()):
    """``n`` non-decreasing ids in ``[0, n_out)`` with many repeats, none
    in ``empty``."""
    pool = np.setdiff1d(np.arange(n_out), np.asarray(empty, np.int64))
    return np.sort(rng.choice(pool, n)).astype(np.int64)


def ref_scatter(ids, vals, n_out, dtype=None):
    """The reference's sum: ``zeros(...).at[ids].add(vals)`` on the update
    axis (-2), in ``dtype`` (a jnp dtype; default vals')."""
    vals = jnp.asarray(vals, dtype)
    out = jnp.zeros(vals.shape[:-2] + (n_out, vals.shape[-1]), vals.dtype)
    out = out.at[..., jnp.asarray(ids), :].add(vals)
    return np.asarray(out.astype(jnp.float32) if dtype in (jnp.bfloat16,
                                                           jnp.float16)
                      else out)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def layout(width, itemsize):
    """The W > 1 kernel's (vec, lanes): a lane holds one 16-byte vector of
    ``vec`` columns where a row is whole 16-byte vectors (else vec = 1,
    and no block route), and a segment takes the fewest lanes, a power of
    two up to 32, that cover its ``width // vec`` vectors."""
    vec = 16 // itemsize if width * itemsize % 16 == 0 else 1
    lanes = 1
    while lanes < 32 and lanes < width // vec:
        lanes *= 2
    return vec, lanes


def lane_columns(width, itemsize):
    """The columns lane ``sub`` of a segment adds: vectors sub, sub +
    lanes, ... of ``vec`` columns each; the segments a warp packs, 32 //
    lanes, each have their own."""
    vec, lanes = layout(width, itemsize)
    return [[c * vec + e for c in range(sub, width // vec, lanes)
             for e in range(vec)] for sub in range(lanes)]


def mark_runs(ids, n_out, skip, long_run):
    """The kernel's ``mark_runs``: lo[s] at a run's first entry, hi[s]
    after its last (0 and 0 for a segment without entries), and the
    segments whose last entry i has ids[i - long_run] == s (long_run > 0):
    the runs longer than ``long_run``.  Ids outside [0, n_out) and skipped
    segments mark nothing."""
    n = len(ids)
    lo, hi = np.zeros(n_out, np.int64), np.zeros(n_out, np.int64)
    ok = (ids >= 0) & (ids < n_out)
    if skip:
        ok &= ids % skip != skip - 1
    first = ok & np.r_[True, ids[1:] != ids[:-1]][:n]
    last = ok & np.r_[ids[:-1] != ids[1:], True][:n]
    lo[ids[first]] = np.flatnonzero(first)
    hi[ids[last]] = np.flatnonzero(last) + 1
    long_runs = []
    if long_run > 0:
        ends = np.flatnonzero(last)
        ends = ends[ends >= long_run]
        long_runs = ids[ends][ids[ends - long_run] == ids[ends]].tolist()
    return lo, hi, long_runs


def run_end(ids, i):
    """The narrow kernel's ``run_end``: galloping from run start i, then a
    binary search, for the first j > i with ids[j] != ids[i]."""
    n, s = len(ids), ids[i]
    lo, step = i + 1, 1
    while True:
        probe = i + step
        if probe >= n or ids[probe] != s:
            hi = min(probe, n)
            break
        lo, step = probe + 1, step * 2
    while lo < hi:
        mid = lo + (hi - lo) // 2
        lo, hi = (mid + 1, hi) if ids[mid] == s else (lo, mid)
    return lo


def chain(acc, rows, dtype):
    """``acc`` plus each of ``rows`` in turn, as the kernel adds: float32
    (float64 for float64) sums, each rounded to ``dtype``."""
    for x in rows:
        acc = acc + x.to(acc.dtype)
        if dtype in (torch.bfloat16, torch.float16):
            acc = acc.to(dtype).to(acc.dtype)
    return acc


def add_runs(out, v3, src, runs, dtype):
    """The runs ``(seg, lo, hi)`` (arrays) added into ``out[:, seg]`` left
    to right, a step of every run at once (a step's segments are
    distinct)."""
    seg, lo, hi = runs
    length = hi - lo
    low = dtype in (torch.bfloat16, torch.float16)
    o, x = (out, v3) if low else (out.numpy(), v3.numpy())  # numpy: faster
    for step in range(int(length.max(initial=0))):
        m = length > step
        if low:
            o[:, seg[m]] = chain(o[:, seg[m]], [x[:, src[lo[m] + step]]],
                                 dtype)
        else:
            o[:, seg[m]] = o[:, seg[m]] + x[:, src[lo[m] + step]]


def emulate(ids, values, n_out, order=None, skip=0, long_run=None):
    """The CUDA kernel's arithmetic and indexing on torch tensors: the ids
    must be sorted and >= 0 (those >= n_out left out); segment s sums its
    run [lo, hi) of its value set, read through ``order``, left to right
    from +0.0, each add rounded to the values' type (a skipped segment:
    none, and 0).  W == 1: a run is found at its first entry and ended by
    ``run_end``.  W > 1: the runs' bounds marked once (``mark_runs``); a
    run longer than ``long_run`` (default the kernel's ``kLongRun``; none
    where a row is not whole 16-byte vectors) on the block route, added
    in tiles of kStageBytes / (the slab's row bytes) rows of slabs of at
    most kThreads columns (pairs of a 16-bit type); the rest on the warp
    route, ``32 // lanes`` segments a warp, their columns spread over the
    lanes as ``lane_columns`` says.  A 16-bit sum rounds at every add
    whether the kernel adds in float32 and rounds or adds natively (the
    source's ``Chains`` says why), so ``chain`` adds in float32 and
    rounds."""
    ids_np = ids.numpy()
    assert ids.dtype == torch.int64 and ids.dim() == 1
    assert np.all(np.diff(ids_np) >= 0), "the kernel needs sorted ids"
    assert ids_np.size == 0 or ids_np[0] >= 0
    v = values.detach()
    n, width = v.shape[-2:]
    v3 = v.reshape(-1, n, width)
    acc_t = torch.float64 if v.dtype == torch.float64 else torch.float32
    src = np.arange(n) if order is None else order.numpy()
    out = torch.zeros((v3.shape[0], n_out, width), dtype=acc_t)
    if width == 1:
        lo = np.flatnonzero(np.r_[n > 0, ids_np[1:] != ids_np[:-1]][:n])
        hi = np.array([run_end(ids_np, i) for i in lo], np.int64)
        seg = ids_np[lo]
        keep = (seg < n_out) & ((seg % skip != skip - 1) if skip else True)
        warp, block = (seg[keep], lo[keep], hi[keep]), []
    else:
        vec, lanes = layout(width, v.element_size())
        cols = sorted(c for lane in lane_columns(width, v.element_size())
                      for c in lane)
        assert cols == list(range(width)), "lanes must cover every column"
        long_run = ss.long_run() if long_run is None else long_run
        if vec == 1 or n <= long_run:
            long_run = 0
        lo, hi, long_runs = mark_runs(ids_np, n_out, skip, long_run)
        longer = set(np.flatnonzero(hi - lo > long_run).tolist()) \
            if long_run else set()
        assert sorted(long_runs) == sorted(longer)
        per_warp = 32 // lanes
        segs = [s for w0 in range(0, n_out, per_warp)
                for s in range(w0, min(w0 + per_warp, n_out))]
        assert segs == list(range(n_out))
        seg = np.asarray([s for s in segs if s not in longer
                          and not (skip and s % skip == skip - 1)], np.int64)
        warp = (seg, lo[seg], hi[seg])
        block = [(s, lo[s], hi[s]) for s in long_runs]
    add_runs(out, v3, src, warp, v.dtype)
    # the block route: a thread adds 1 column (2 of a 16-bit type)
    cols = KERNEL["kThreads"] * (2 if v.element_size() == 2 else 1)
    for s, a, b in block:
        for c0 in range(0, width, cols):
            slab = min(width - c0, cols)
            assert slab * v.element_size() % 16 == 0  # whole 16-byte copies
            cs = slice(c0, c0 + slab)
            tr = KERNEL["kStageBytes"] // (slab * v.element_size())
            tiles = [range(r0, min(r0 + tr, b)) for r0 in range(a, b, tr)]
            assert [i for tile in tiles for i in tile] == list(range(a, b))
            for tile in tiles:
                out[:, s, cs] = chain(out[:, s, cs],
                                      (v3[:, src[i], cs] for i in tile),
                                      v.dtype)
    return out.to(v.dtype).reshape(v.shape[:-2] + (n_out, width))


# ---------------------------------------------------------------------------
# The plain version and the kernel's emulation against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 3, 64])
def test_plain_matches_reference_and_sees_order(width):
    rng = np.random.default_rng(0)
    n_out = 40
    ids = sorted_ids(rng, 600, n_out)
    vals = mixed(rng, (600, width))
    want = ref_scatter(ids, vals, n_out)
    got = ss.segment_sum(t(ids), t(vals), n_out)
    np.testing.assert_array_equal(got.numpy(), want)
    # the same terms in reverse give other bits: the test can see order
    rev = ss.segment_sum_plain(t(ids[::-1].copy()), t(vals[::-1].copy()),
                               n_out)
    assert not np.array_equal(rev.numpy(), want)


@pytest.mark.parametrize("width", [1, 5])
def test_order_route_matches_stream_order_scatter(width):
    """Unsorted ids: a stable sort, then the runs read through its
    permutation, add each output's terms in stream order."""
    rng = np.random.default_rng(1)
    n_out = 30
    idx = rng.integers(0, n_out, 500).astype(np.int64)
    vals = mixed(rng, (500, width))
    want = ref_scatter(idx, vals, n_out)
    np.testing.assert_array_equal(
        ss.index_sum(t(idx), t(vals), n_out).numpy(), want)
    np.testing.assert_array_equal(
        ss.index_sum_sorted(t(idx), t(vals), n_out).numpy(), want)
    ids, order = torch.sort(t(idx), stable=True)
    np.testing.assert_array_equal(
        emulate(ids, t(vals), n_out, order).numpy(), want)
    np.testing.assert_array_equal(  # int32 ids sort in their own dtype
        ss.index_sum_sorted(t(idx.astype(np.int32)), t(vals), n_out).numpy(),
        want)


def test_empty_segments_padding_row_batch_and_float64():
    rng = np.random.default_rng(2)
    n_out = 50
    empty = [0, 7, 8, 9, 49]
    ids = sorted_ids(rng, 400, n_out, empty)
    vals = mixed(rng, (3, 400, 2))
    got = ss.segment_sum(t(ids), t(vals), n_out)
    want = ref_scatter(ids, vals, n_out)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, empty].any()
    for b in range(3):  # a leading batch axis: each member on its own
        np.testing.assert_array_equal(
            got[b].numpy(), ss.segment_sum(t(ids), t(vals[b]), n_out).numpy())
    # the padding: ids past n_out are left out, here and in the kernel
    rid = np.concatenate([ids, np.full(20, n_out, np.int64),
                          np.full(5, n_out + 3, np.int64)])
    padded = np.concatenate([vals[0], mixed(rng, (25, 2))])
    np.testing.assert_array_equal(
        ss.segment_sum(t(rid), t(padded), n_out).numpy(), want[0])
    np.testing.assert_array_equal(
        emulate(t(rid), t(padded), n_out).numpy(), want[0])
    np.testing.assert_array_equal(
        emulate(t(rid), t(padded[:, :1].copy()), n_out).numpy(),
        want[0][:, :1])
    np.testing.assert_array_equal(
        ss.index_sum(t(rid[::-1].copy()), t(padded[::-1].copy()),
                     n_out).numpy(),
        ref_scatter(ids[::-1], vals[0][::-1], n_out))
    # float64 against numpy's unbuffered ``add.at`` (adds in index order)
    v64 = mixed(rng, (400, 1), np.float64) * np.float64(1 + 1e-9)
    want64 = np.zeros((n_out, 1))
    np.add.at(want64, ids, v64)
    got64 = ss.segment_sum(t(ids), t(v64), n_out)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), want64)
    np.testing.assert_array_equal(emulate(t(ids), t(v64), n_out).numpy(),
                                  want64)
    # no entry at all, and no segment
    assert not ss.segment_sum(t(ids[:0]), t(vals[0][:0]), 4).any()
    assert ss.segment_sum(t(ids[:0]), t(vals[0][:0]), 0).shape == (0, 2)


def _case(*args, id=None):
    return pytest.param(*args, id=id)


# (width, value sets, order, segments, skip, dtype, long_run: None for the
# kernel's kLongRun); the first eight keep their ids from before the dtype
# and the threshold were parameters
@pytest.mark.parametrize(
    "width,batch,with_order,n_out,skip,dtype,long_run", [
        _case(1, 1, False, 300, 0, "float32", None, id="1-1-False-300-0"),
        _case(1, 2, True, 700, 0, "float32", None, id="1-2-True-700-0"),
        _case(1, 1, True, 2, 0, "float32", None, id="1-1-True-2-0"),
        _case(1, 1, False, 300, 7, "float32", None, id="1-1-False-300-7"),
        _case(3, 1, False, 45, 0, "float32", None, id="3-1-False-45-0"),
        _case(64, 2, True, 45, 5, "float32", None, id="64-2-True-45-5"),
        _case(96, 1, True, 30, 0, "float32", None, id="96-1-True-30-0"),
        _case(130, 1, False, 12, 0, "float32", None, id="130-1-False-12-0"),
        # the block route: runs of ~220 past a threshold of 20, in tiles of
        # 64 float32 rows (4 a run) or 128 bf16 ones, a batch, the order
        # route, skipped segments
        _case(64, 1, False, 9, 0, "float32", 20, id="block-float32"),
        _case(64, 2, True, 9, 5, "bfloat16", 20, id="block-bf16-order-skip"),
        # 2,048 bf16 columns: one slab of 256 vectors, tiles of 4 rows; a
        # warp a segment, 8 vectors a lane
        _case(2048, 1, True, 12, 0, "bfloat16", 100, id="block-bf16-2048"),
        # rows not whole 16-byte vectors: a column a lane, no block route
        _case(3, 1, True, 9, 0, "bfloat16", 20, id="unaligned-bf16"),
        # 32 segments a warp (a lane a row), and float64 vectors of 2
        _case(8, 3, False, 40, 0, "float16", 30, id="packed-float16"),
        _case(2, 1, False, 700, 0, "float64", None, id="packed-float64"),
    ])
def test_kernel_emulation_matches_plain(width, batch, with_order, n_out,
                                        skip, dtype, long_run):
    """The kernel's indexing: runs of one and of hundreds (the galloping
    end), empty segments, the runs marked once, short runs packed several
    to a warp, long ones on the block route in tiles, wide rows past one
    lane and one slab, a batch, the order route, skipped segments, the four
    value types: the emulation bit for bit the plain version and the
    reference's ``.at[].add`` (values read through ``order``, the skipped
    segments 0)."""
    rng = np.random.default_rng(3 + width)
    n = 2000
    ids = t(sorted_ids(rng, n, n_out, empty=[n_out // 2]))
    big = 1e8 if dtype in ("float32", "float64") else 300.0
    vals_np = mixed(rng, (batch, n, width) if batch > 1 else (n, width),
                    np.float64) * (big / 1e8)
    vals = t(vals_np).to(getattr(torch, dtype))
    order = t(rng.permutation(n).astype(np.int64)) if with_order else None
    want = ss.segment_sum_plain(ids, vals, n_out, order, skip)
    if skip:  # the kept segments are the full sums, the skipped ones 0
        full = ss.segment_sum_plain(ids, vals, n_out, order)
        full[..., skip - 1::skip, :] = 0
        np.testing.assert_array_equal(want.float().numpy(),
                                      full.float().numpy())
    got = emulate(ids, vals, n_out, order, skip, long_run)
    assert got.dtype == vals.dtype
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    jdt = {"float32": jnp.float32, "float64": jnp.float64,
           "bfloat16": jnp.bfloat16, "float16": jnp.float16}[dtype]
    read = vals.float().numpy() if order is None \
        else vals.float().numpy()[..., order.numpy(), :]
    if dtype == "float64":
        read = vals.numpy() if order is None \
            else vals.numpy()[..., order.numpy(), :]
        ref = np.zeros(read.shape[:-2] + (n_out, width))
        np.add.at(ref, (..., ids.numpy(), slice(None)), read)
    else:
        ref = ref_scatter(ids.numpy(), read, n_out, jdt)
    if skip:
        ref = np.array(ref)
        ref[..., skip - 1::skip, :] = 0
    np.testing.assert_array_equal(got.float().numpy() if dtype != "float64"
                                  else got.numpy(), ref)


def test_backward_matches_reference_gradient():
    """d/dvalues of ``<ct, segment sums>``: the cotangent gathered at ids,
    and through ``order`` back to each value's place."""
    rng = np.random.default_rng(4)
    n_out, n = 25, 300
    idx = rng.integers(0, n_out, n).astype(np.int64)
    vals = mixed(rng, (n, 4))
    ct = mixed(rng, (n_out, 4))

    def ref(v, ids):
        return jnp.zeros((n_out, 4), v.dtype).at[ids].add(v)

    _, vjp = jax.vjp(lambda v: ref(v, jnp.asarray(idx)), jnp.asarray(vals))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    for route in (ss.index_sum_sorted, ss.index_sum):
        v = t(vals).requires_grad_()
        route(t(idx), v, n_out).backward(t(ct))
        np.testing.assert_array_equal(v.grad.numpy(), want)
    ids = np.sort(idx)
    _, vjp = jax.vjp(lambda v: ref(v, jnp.asarray(ids)), jnp.asarray(vals))
    v = t(vals).requires_grad_()
    ss.segment_sum(t(ids), v, n_out).backward(t(ct))
    np.testing.assert_array_equal(v.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(ct))[0]))
    # values left out (skipped segments, ids past the end) move nothing
    ids = np.sort(rng.integers(0, n_out + 3, n))
    v = t(vals).requires_grad_()
    ss.segment_sum(t(ids), v, n_out, skip=5).backward(t(ct))
    out = (ids >= n_out) | (ids % 5 == 4)
    np.testing.assert_array_equal(
        v.grad.numpy(),
        np.where(out[:, None], 0, ct[np.minimum(ids, n_out - 1)]))


def test_cuda_wrapper_refuses_before_launch():
    """What the kernel cannot take raises before the library is loaded."""
    ids = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int64"):
        ss._segment_sum_cuda(ids.int(), torch.zeros(4, 1), 2, None)
    with pytest.raises(ValueError, match="floating-point"):
        ss._segment_sum_cuda(ids, torch.zeros(4, 1, dtype=torch.int32), 2,
                             None)
    with pytest.raises(ValueError, match=r"ids \(N,\)"):
        ss._segment_sum_cuda(ids, torch.zeros(5, 1), 2, None)
    with pytest.raises(ValueError, match="order"):
        ss._segment_sum_cuda(ids, torch.zeros(4, 1), 2, ids[:3])
    with pytest.raises(ValueError, match="skip"):
        ss._segment_sum_cuda(ids, torch.zeros(4, 1), 2, None, -1)


# ---------------------------------------------------------------------------
# The call sites on the kernel's route (emulated) against the reference
# ---------------------------------------------------------------------------

@pytest.fixture
def kernel_route(monkeypatch):
    """The CUDA routes on the CPU: ``segment_sum`` runs ``emulate`` and
    every ``index_sum`` call site takes the sorted route."""
    monkeypatch.setattr(ss, "segment_sum_plain", emulate)
    for mod in (sparse_ops, markov_clustering):
        monkeypatch.setattr(mod, "index_sum", ss.index_sum_sorted)
    before = ops.launch_counts()
    yield
    assert ops.launch_counts() == before  # nothing launched on the CPU


def test_sort_engine_on_the_kernel_route(kernel_route):
    """The sort engine's flattened segment ids, a batch of value sets."""
    rng = np.random.default_rng(5)
    r, ip_cap = 7, 60
    keys = rng.integers(-1, 12, (r, ip_cap)).astype(np.int32)
    vals = mixed(rng, (2, r, ip_cap))
    for out_cap in (4, 13):
        for b in range(2):
            want = ref_phases.sort_unique(jnp.asarray(keys),
                                          jnp.asarray(vals[b]), out_cap)
            got = phases.sort_unique(t(keys), t(vals[b]), out_cap)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            np.testing.assert_array_equal(
                phases.sort_unique(t(keys), t(vals), out_cap)[1][b].numpy(),
                np.asarray(want[1]))


def sparse_pair(rng, n, m, spare=6):
    x = np.where(rng.random((n, m)) < 0.35, mixed(rng, (n, m)), 0)
    x = x.astype(np.float32)
    ref = ref_csr_from_dense(x, capacity=int(np.count_nonzero(x)) + spare)
    return csr_from_arrays(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape,
                           device="cpu"), ref


def test_csr_primitives_on_the_kernel_route(kernel_route):
    """``csr_spmv``, ``csr_spmm`` with its gradients, ``csr_column_sums``."""
    rng = np.random.default_rng(6)
    a, ra = sparse_pair(rng, 30, 20)
    xv = mixed(rng, (20,))
    np.testing.assert_array_equal(
        sparse_ops.csr_spmv(a, t(xv)).numpy(),
        np.asarray(ref_ops.csr_spmv(ra, jnp.asarray(xv))))
    np.testing.assert_array_equal(
        sparse_ops.csr_column_sums(a).numpy(),
        np.asarray(ref_ops.csr_column_sums(ra)))
    x = mixed(rng, (20, 8))
    ct = mixed(rng, (30, 8))

    def ref_loss(data, x):
        b = type(ra)(ra.indptr, ra.indices, data, ra.shape)
        return jnp.sum(ref_ops.csr_spmm(b, x) * jnp.asarray(ct))

    want_y = np.asarray(ref_ops.csr_spmm(ra, jnp.asarray(x)))
    want_dd, want_dx = jax.grad(ref_loss, argnums=(0, 1))(ra.data,
                                                          jnp.asarray(x))
    for gather in ("xla", "aia"):
        xt = t(x).requires_grad_()
        data = a.data.clone().requires_grad_()
        b = type(a)(a.indptr, a.indices, data, a.shape)
        y = sparse_ops.csr_spmm(b, xt, gather=gather)
        np.testing.assert_array_equal(y.detach().numpy(), want_y)
        y.backward(t(ct))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_dx))
        np.testing.assert_array_equal(data.grad.numpy(), np.asarray(want_dd))


def test_mcl_on_the_kernel_route(kernel_route):
    """MCL's iterations (the sort engine, the column sums, the self loops
    and ``_change``) bit for bit the reference's."""
    g, rg = rmat_graph(32, 3.0, seed=5, device="cpu"), ref_rmat(32, 3.0,
                                                                seed=5)
    kwargs = dict(e=2, r=2.0, k=16, max_iters=2, tol=0.0)
    got = markov_clustering.mcl(g, method="sort", **kwargs)
    want = ref_mcl.mcl(rg, method="sort", **kwargs)
    nnz = int(want.matrix.indptr[-1])
    np.testing.assert_array_equal(got.matrix.indptr.numpy(),
                                  np.asarray(want.matrix.indptr))
    np.testing.assert_array_equal(got.matrix.indices[:nnz].numpy(),
                                  np.asarray(want.matrix.indices)[:nnz])
    np.testing.assert_array_equal(got.matrix.data[:nnz].numpy(),
                                  np.asarray(want.matrix.data)[:nnz])
    np.testing.assert_array_equal(got.clusters, want.clusters)
    sl = markov_clustering.add_self_loops(g, weight=0.75)
    rsl = ref_mcl.add_self_loops(rg, weight=0.75)
    np.testing.assert_array_equal(sl.data.numpy(), np.asarray(rsl.data))
    assert markov_clustering._change(sl, g) == ref_mcl._change(rsl, rg)



@pytest.mark.parametrize("rows,reps,cols", [(300, 24, 3), (4, 60000, 2)])
def test_dense_conversions_add_repeats_in_slot_order(rows, reps, cols):
    """``TopKRows.to_dense``, ``csr_to_dense``, ``ell_to_dense`` and
    ``bsr_to_dense`` with repeated indices (long runs of one index too,
    where the CPU's ``index_put_(accumulate=True)`` adds in no fixed
    order) against the reference's ``.at[].add``, bit for bit."""
    from repro.sparse import formats as rf
    from repro_torch.sparse import formats as f

    rng = np.random.default_rng(8)
    idx = rng.integers(0, cols, (rows, reps)).astype(np.int32)
    vals = mixed(rng, (rows, reps))
    ptr = np.arange(0, rows * reps + 1, reps, dtype=np.int32)
    ell_idx = rng.integers(-1, cols, (rows, reps)).astype(np.int32)
    nb, bs = rows * reps // 64, 8
    bidx = rng.integers(0, cols, nb).astype(np.int32)
    blocks = mixed(rng, (nb, bs, bs))
    bptr = np.array([0, nb], np.int32)
    pairs = (
        (f.TopKRows(t(vals), t(idx), (rows, 16)).to_dense(),
         rf.TopKRows(jnp.asarray(vals), jnp.asarray(idx), (rows, 16))
         .to_dense()),
        (f.csr_to_dense(f.CSR(t(ptr), t(idx.reshape(-1)),
                              t(vals.reshape(-1)), (rows, 16))),
         rf.csr_to_dense(rf.CSR(jnp.asarray(ptr),
                                jnp.asarray(idx.reshape(-1)),
                                jnp.asarray(vals.reshape(-1)), (rows, 16)))),
        (f.ell_to_dense(f.ELL(t(ell_idx), t(vals), (rows, 16))),
         rf.ell_to_dense(rf.ELL(jnp.asarray(ell_idx), jnp.asarray(vals),
                                (rows, 16)))),
        (f.bsr_to_dense(f.BSR(t(bptr), t(bidx), t(blocks),
                              (bs, cols * bs))),
         rf.bsr_to_dense(rf.BSR(jnp.asarray(bptr), jnp.asarray(bidx),
                                jnp.asarray(blocks), (bs, cols * bs)))),
    )
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# The keyless pass's split-and-combine order (csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

KEYLESS = source_constants("flash_attention.cu")


def emulate_keyless(x, den, p_bf16=False):
    """``keyless_kernel``'s column sums of ``x`` (BH, rows, Dv) over its
    rows, / ``den``, in its order: the rows cut into kKeylessCluster *
    (kThreads / 32) contiguous chunks of ceil(rows / chunks), each a
    warp's float32 chain from +0.0 (v rounded to bf16 first under
    ``p_bf16``); a block's chunks added in warp order, then the cluster's
    block sums in rank order.  (BH, Dv) float32."""
    x = x.float()
    if p_bf16:
        x = x.bfloat16().float()
    warps = KEYLESS["kThreads"] // 32
    chunks = KEYLESS["kKeylessCluster"] * warps
    n = x.shape[1]
    length = -(-n // chunks)
    part = []
    for g in range(chunks):
        acc = torch.zeros_like(x[:, 0])
        for r in range(g * length, min(n, (g + 1) * length)):
            acc = acc + x[:, r]
        part.append(acc)
    total = torch.zeros_like(x[:, 0])
    for rank in range(KEYLESS["kKeylessCluster"]):
        block = torch.zeros_like(x[:, 0])
        for w in range(warps):
            block = block + part[rank * warps + w]
        total = total + block
    return total / den


@pytest.mark.parametrize("dtype,p_dtype", [
    (torch.float32, None), (torch.bfloat16, None),
    (torch.bfloat16, torch.bfloat16)])
def test_keyless_split_and_combine_matches_plain_and_reference(dtype,
                                                               p_dtype):
    """The keyless pass's order on the CPU: the forward's rows (every query
    without a key, kv_len 0; and a causal call whose first queries see no
    key) within ``chip_smoke.py``'s FLASH_TOL of the plain version and of
    the reference's chunked attention, the same bits on a repeat; the
    backward's dV (the keyless queries' dO) within the card's check
    (rtol 1e-5, atol 1e-6) of the plain sum."""
    import importlib.util
    import pathlib

    from repro.models import attention as ref_attn
    from repro_torch.kernels import flash_attention as k7

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)
    rtol, atol = chip.FLASH_TOL[str(dtype)]
    rng = np.random.default_rng(9)
    bh, s, d, dv = 3, 200, 16, 130  # two column slabs of 128
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape)
                                    .astype(np.float32)).to(dtype)
                   for shape in ((bh, s, d), (bh, s, d), (bh, s, dv),
                                 (bh, s, dv)))
    den = k7.keyless_den(s, 1024)
    mean = emulate_keyless(v, den, p_dtype is not None).to(dtype)
    assert torch.equal(mean, emulate_keyless(v, den, p_dtype is not None)
                       .to(dtype))
    plain = k7.flash_attention_masked_plain(q, k, v, False, kv_len=0,
                                            p_dtype=p_dtype)
    got = mean[:, None].expand_as(plain)
    diff = (got.double() - plain.double()).abs()
    assert bool((diff <= atol + rtol * plain.double().abs()).all())
    if p_dtype is None:
        def nhd(x):
            return jnp.asarray(x.float().numpy().transpose(1, 0, 2)[None])

        ref = ref_attn.flash_attention(
            nhd(q), nhd(k), nhd(v), causal=False, k_chunk=1024,
            kv_valid_len=jnp.asarray(0, jnp.int32))
        ref = torch.from_numpy(np.asarray(ref, np.float32)[0]
                               .transpose(1, 0, 2).copy())
        diff = (got.double() - ref.double()).abs()
        assert bool((diff <= atol + rtol * ref.double().abs()).all())
    # a causal call with q_offset -5: queries 0..4 see no key
    a, b = k7.keyless_rows(s, s, True, 0, -5)
    assert (a, b) == (5, s)
    plain = k7.flash_attention_masked_plain(q, k, v, True, q_offset=-5,
                                            p_dtype=p_dtype)
    diff = (mean[:, None].double() - plain[:, :a].double()).abs()
    assert bool((diff <= atol + rtol * plain[:, :a].double().abs()).all())
    # the backward's dV: the keyless queries' dO, [0, a), summed likewise
    g = emulate_keyless(do[:, :a], den)
    want = do[:, :a].float().sum(1) / den
    assert torch.allclose(g, want, rtol=1e-5, atol=1e-6)
