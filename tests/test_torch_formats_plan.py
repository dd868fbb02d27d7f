"""The port's formats, generators and planning against the JAX package.

Inputs are built from a seed with numpy and handed to both packages; the
port runs on the CPU.  Everything here is integer or copy arithmetic, so
every comparison is exact.
"""
import ast
import importlib
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.apps import graphs as ref_graphs
from repro.core import executor as ref_exec
from repro.core import grouping as ref_grouping
from repro.core import ip_count as ref_ip
from repro.sparse import formats as ref_formats
from repro_torch.apps import graphs
from repro_torch.core import executor, grouping, ip_count
from repro_torch.core.ref import spgemm_dense
from repro_torch.sparse import formats

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the reference's converters, jitted once each (eager JAX compiles op by op)
ref_csr_to_ell = jax.jit(ref_formats.csr_to_ell, static_argnums=1)
ref_ell_to_csr = jax.jit(ref_formats.ell_to_csr)


def sparse(rng, n, m, density):
    x = rng.integers(-4, 5, (n, m)).astype(np.float32)
    return np.where(rng.random((n, m)) < density, x, 0.0).astype(np.float32)


def port_of(c):
    """The JAX package's CSR, read out with numpy, as the port's CSR."""
    return formats.csr_from_arrays(np.asarray(c.indptr), np.asarray(c.indices),
                                   np.asarray(c.data), c.shape, device="cpu")


def assert_same_csr(got, want, full=True):
    """Exact comparison of a port CSR with a reference CSR; ``full`` also
    compares the capacity padding."""
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    nnz = None if full else int(np.asarray(want.indptr)[-1])
    for g, w in ((got.indices, want.indices), (got.data, want.data)):
        np.testing.assert_array_equal(g.numpy()[:nnz], np.asarray(w)[:nnz])


# ---------------------------------------------------------------------------
# Formats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,density,capacity", [
    (7, 5, 0.4, None), (12, 9, 0.2, 40), (6, 6, 0.0, None), (1, 13, 0.9, None),
])
def test_csr_from_dense_and_back(n, m, density, capacity):
    x = sparse(np.random.default_rng(n * m), n, m, density)
    got = formats.csr_from_dense(x, capacity=capacity, device="cpu")
    assert_same_csr(got, ref_formats.csr_from_dense(x, capacity=capacity))
    np.testing.assert_array_equal(formats.csr_to_dense(got).numpy(), x)
    assert got.indptr.dtype == torch.int32 and got.indices.dtype == torch.int32


def test_csr_from_coo_merges_duplicates_like_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 7, 60)
    vals = rng.standard_normal(60).astype(np.float32)
    got = formats.csr_from_coo(rows, cols, vals, (9, 7), device="cpu")
    assert_same_csr(got, ref_formats.csr_from_coo(rows, cols, vals, (9, 7)))


def test_csr_from_arrays_round_trips_reference_padding():
    x = sparse(np.random.default_rng(4), 10, 8, 0.3)
    ref = ref_formats.csr_from_dense(x, capacity=64)
    got = port_of(ref)
    assert got.capacity == 64
    assert_same_csr(got, ref)
    with pytest.raises(ValueError, match="indptr"):
        formats.csr_from_arrays(np.zeros(3), np.zeros(1), np.zeros(1), (5, 5),
                                device="cpu")


@pytest.mark.parametrize("k_cap", [1, 3, 8])
def test_csr_to_ell_and_back(k_cap):
    x = sparse(np.random.default_rng(k_cap), 11, 9, 0.35)
    ref = ref_formats.csr_from_dense(x, capacity=50)
    got_ell = formats.csr_to_ell(port_of(ref), k_cap)
    want_ell = ref_csr_to_ell(ref, k_cap)
    np.testing.assert_array_equal(got_ell.indices.numpy(),
                                  np.asarray(want_ell.indices))
    np.testing.assert_array_equal(got_ell.data.numpy(),
                                  np.asarray(want_ell.data))
    assert_same_csr(formats.ell_to_csr(got_ell),
                    ref_ell_to_csr(want_ell))
    np.testing.assert_array_equal(got_ell.row_nnz().numpy(),
                                  np.asarray(want_ell.row_nnz()))


def test_spgemm_dense_oracle():
    rng = np.random.default_rng(5)
    x, y = sparse(rng, 8, 6, 0.4), sparse(rng, 6, 7, 0.4)
    a = formats.csr_from_dense(x, device="cpu")
    b = formats.csr_from_dense(y, device="cpu")
    np.testing.assert_array_equal(spgemm_dense(a, b).numpy(), x @ y)


# ---------------------------------------------------------------------------
# Generators (the paper's workloads) — bit for bit from the same seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen,n,deg,seed", [
    ("rmat_graph", 300, 3.7, 0), ("rmat_graph", 257, 5.6, 2),
    ("uniform_graph", 400, 2.8, 0), ("uniform_graph", 33, 19.2, 5),
])
def test_generators_match_reference(gen, n, deg, seed):
    got = getattr(graphs, gen)(n, deg, seed=seed, device="cpu")
    assert_same_csr(got, getattr(ref_graphs, gen)(n, deg, seed=seed))


@pytest.mark.parametrize("name", ["RoadTX", "p2p-Gnutella04", "web-Google"])
def test_table_ii_matrix_matches_reference(name):
    got = graphs.table_ii_matrix(name, seed=1, n_override=512, device="cpu")
    assert_same_csr(got, ref_graphs.table_ii_matrix(name, seed=1,
                                                    n_override=512))


def test_workload_tables_match_reference():
    assert graphs.TABLE_II_SCALED == ref_graphs.TABLE_II_SCALED
    assert graphs.TABLE_III_SCALED == ref_graphs.TABLE_III_SCALED


# ---------------------------------------------------------------------------
# Algorithm 1 + Table-I grouping
# ---------------------------------------------------------------------------

def _group3_pair(rng):
    """A with one row whose IP is 128 * 64 = 8192 (Table-I group 3)."""
    xa = np.zeros((6, 128), np.float32)
    xa[0] = rng.integers(1, 4, 128)
    xa[1, :3] = 1.0
    xa[2, :40] = 2.0
    xb = np.zeros((128, 256), np.float32)
    for i in range(128):
        xb[i, rng.choice(256, 64, replace=False)] = rng.integers(1, 4, 64)
    return xa, xb


def _pairs():
    rng = np.random.default_rng(11)
    yield sparse(rng, 18, 14, 0.25), sparse(rng, 14, 16, 0.35)
    yield sparse(rng, 40, 30, 0.6), sparse(rng, 30, 50, 0.8)
    yield np.zeros((5, 4), np.float32), sparse(rng, 4, 3, 0.5)
    yield _group3_pair(rng)


@pytest.mark.parametrize("case", range(4))
def test_ip_count_and_group_plan_match_reference(case):
    xa, xb = list(_pairs())[case]
    ra, rb = ref_formats.csr_from_dense(xa), ref_formats.csr_from_dense(xb)
    a, b = port_of(ra), port_of(rb)
    np.testing.assert_array_equal(ip_count.intermediate_products(a, b).numpy(),
                                  np.asarray(ref_ip.intermediate_products(ra, rb)))
    got, want = grouping.group_rows(a, b), ref_grouping.group_rows(ra, rb)
    for field in ("map_rows", "group_id", "group_offsets", "row_ip"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    for field in ("group_sizes", "group_sizes_padded", "table_capacities",
                  "max_ip", "total_ip"):
        assert getattr(got, field) == getattr(want, field), field
    for g in range(4):
        np.testing.assert_array_equal(got.rows_of_group(g),
                                      want.rows_of_group(g))
    ungot, unwant = executor.ungrouped_plan(got), ref_exec.ungrouped_plan(want)
    assert ungot.table_capacities == unwant.table_capacities
    np.testing.assert_array_equal(ungot.group_offsets, unwant.group_offsets)


def test_group3_plan_really_has_group3():
    xa, xb = _group3_pair(np.random.default_rng(0))
    plan = grouping.group_rows(formats.csr_from_dense(xa, device="cpu"),
                               formats.csr_from_dense(xb, device="cpu"))
    assert plan.group_sizes[3] == 1 and plan.table_capacities[3] == 8192
    np.testing.assert_array_equal(
        grouping.assign_groups(np.array([0, 31, 32, 511, 512, 8191, 8192])),
        np.asarray(ref_grouping.assign_groups(
            jnp.asarray([0, 31, 32, 511, 512, 8191, 8192]))))


@pytest.mark.parametrize("row_chunk", [3, 8, 4096])
def test_partition_plan_matches_reference(row_chunk):
    xa, xb = list(_pairs())[3]
    ra, rb = ref_formats.csr_from_dense(xa), ref_formats.csr_from_dense(xb)
    row_nnz = np.diff(np.asarray(ra.indptr))
    got = executor.partition_plan(grouping.group_rows(port_of(ra), port_of(rb)),
                                  row_nnz, row_chunk)
    want = ref_exec.partition_plan(ref_grouping.group_rows(ra, rb), row_nnz,
                                   row_chunk)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.group, g.a_cap, g.table_cap) == (w.group, w.a_cap,
                                                   w.table_cap)
        np.testing.assert_array_equal(g.rows, w.rows)


# ---------------------------------------------------------------------------
# Sizing arithmetic and knobs
# ---------------------------------------------------------------------------

def test_capacity_arithmetic_matches_reference():
    for x in (0, 1, 2, 3, 64, 65, 2**20 + 1):
        assert executor.next_pow2(x) == ref_exec.next_pow2(x)
        assert executor._int32_nnz_capacity(x) == ref_exec._int32_nnz_capacity(x)
    for args in ((0, 64, 16), (40, 64, 16), (300, 1024, 2048), (5, 0, 1)):
        assert executor._out_cap(*args) == ref_exec._planned_out_cap(*args)
    for counts in ([3, 0, 17], [0, 0], [600, 2]):
        counts = np.array(counts, np.int32)
        assert executor._out_cap(int(counts.max()), 64, 32) \
            == ref_exec._out_cap_from_counts(counts, 64, 32)
    with pytest.raises(OverflowError):
        executor._int32_nnz_capacity(2**31)
    xa, xb = list(_pairs())[1]
    ra, rb = ref_formats.csr_from_dense(xa), ref_formats.csr_from_dense(xb)
    got = grouping.group_rows(port_of(ra), port_of(rb))
    want = ref_grouping.group_rows(ra, rb)
    rows = np.arange(0, 40, 3)
    for n_cols in (7, 50):
        assert executor.chunk_capacity_bounds(got, rows, n_cols) \
            == ref_exec.chunk_capacity_bounds(want, rows, n_cols)


def test_knob_resolution():
    assert executor.resolve_gather("auto", "cuda") == "aia"
    assert executor.resolve_gather("auto", "cpu") == "xla"
    assert executor.resolve_gather("xla", "cuda") == "xla"
    with pytest.raises(ValueError, match="unknown gather"):
        executor.resolve_gather("dma", "cpu")
    assert executor.resolve_engine() == "sort"
    assert executor.resolve_engine(method="hash") == "hash"
    assert executor.resolve_engine("auto") == "auto"
    with pytest.raises(ValueError, match="unknown engine"):
        executor.resolve_engine("nope")
    with pytest.raises(ValueError, match="conflicting"):
        executor.resolve_engine("sort", method="hash")
    assert set(executor.available_engines()) == {"hash", "sort", "fused_hash"}
    plan = grouping.group_rows(*(formats.csr_from_dense(np.eye(3, dtype=np.float32),
                                                        device="cpu"),) * 2)
    assert executor.resolve_sizing("auto", "fused_hash", plan) == "planned"
    assert executor.resolve_sizing("auto", "hash", plan) == "measured"
    assert executor.resolve_sizing("measured", "fused_hash", plan) == "measured"
    with pytest.raises(ValueError, match="unknown sizing"):
        executor.resolve_sizing("eager", "sort", plan)


def test_pattern_fingerprint_and_plan_cache():
    rng = np.random.default_rng(9)
    pattern = rng.random((12, 12)) < 0.3
    x1 = np.where(pattern, rng.integers(1, 5, (12, 12)), 0).astype(np.float32)
    x2 = np.where(pattern, rng.integers(1, 5, (12, 12)), 0).astype(np.float32)
    r1 = ref_formats.csr_from_dense(x1)
    a1, a2 = port_of(r1), formats.csr_from_dense(x2, device="cpu")
    # the same digest as the reference: the same int32 bytes are hashed
    assert executor.pattern_fingerprint(a1, a1) \
        == ref_exec.pattern_fingerprint(r1, r1)
    executor.clear_program_cache()
    cache = executor.PlanCache(max_entries=2)
    p1 = cache.plan_for(a1, a1)
    assert cache.plan_for(a2, a2) is p1  # same support, other values: a hit
    x3 = x1.copy()
    x3[0, np.argmax(x3[0] == 0)] = 1.0  # one more nonzero: a new pattern
    cache.plan_for(formats.csr_from_dense(x3, device="cpu"), a1)
    assert cache.stats() == {"hits": 1, "misses": 2, "entries": 2}
    stats = executor.cache_stats()
    assert (stats["plan_hits"], stats["plan_misses"]) == (1, 2)


# ---------------------------------------------------------------------------
# The port stands alone: no JAX, nothing of the JAX package, and no
# networkx (the card's machine has none)
# ---------------------------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "networkx"), \
                f"{path}: {name}"


def test_kernel_modules_import_first():
    """The kernel modules import before anything else of the package (no
    import cycle through ``core``): the package is imported afresh, kernel
    modules first, and the loaded modules are put back afterwards."""
    loaded = {k: v for k, v in sys.modules.items()
              if k == "repro_torch" or k.startswith("repro_torch.")}
    try:
        for k in loaded:
            del sys.modules[k]
        importlib.import_module("repro_torch.kernels.hash_accum")
        importlib.import_module("repro_torch.kernels.aia_gather")
        importlib.import_module("repro_torch.core.spgemm")
    finally:
        for k in [k for k in sys.modules if k.startswith("repro_torch")]:
            del sys.modules[k]
        sys.modules.update(loaded)
