"""The public names the port's ``core``, ``sparse`` and ``kernels.ops``
share with the JAX package, against the reference, on the CPU.

Both packages take the same numpy-built inputs.  Counts, maps and
structures are held equal; values bit for bit (small-integer products and
sums, or copies).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core.grouping import build_map as ref_build_map
from repro.core.ip_count import (
    total_intermediate_products as ref_total_ip)
from repro.kernels import ops as ref_kops
from repro.sparse import ell_from_dense as ref_ell_from_dense
from repro.sparse import ell_to_dense as ref_ell_to_dense
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
import repro_torch.core as core
from repro_torch.core import executor
from repro_torch.core.grouping import build_map
from repro_torch.kernels import ops as kops
from repro_torch.sparse import (
    csr_from_dense, csr_to_dense, csr_to_ell, ell_from_dense, ell_to_csr,
    ell_to_dense)


def int_sparse(seed, n, m, density):
    rng = np.random.default_rng(seed)
    x = rng.integers(-4, 5, (n, m)).astype(np.float32)
    return np.where(rng.random((n, m)) < density, x, 0.0).astype(np.float32)


def test_core_exports_the_reference_names():
    """``repro_torch.core`` exports every name of ``repro.core.__all__``
    (plus ``total_intermediate_products``), ``spgemm`` as the function."""
    assert set(ref_core.__all__) <= set(core.__all__)
    for name in core.__all__:
        assert hasattr(core, name), name
    assert callable(core.spgemm) and core.spgemm.__name__ == "spgemm"
    x = int_sparse(0, 12, 12, 0.3)
    a = csr_from_dense(x, device="cpu")
    np.testing.assert_array_equal(csr_to_dense(core.spgemm(a, a).c).numpy(),
                                  x @ x)


def test_ip_counts_map_and_histogram_match_reference():
    x = int_sparse(1, 60, 60, 0.4)
    a, ra = csr_from_dense(x, device="cpu"), ref_csr_from_dense(x)
    ip = core.intermediate_products(a, a)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(
        ref_core.intermediate_products(ra, ra)))
    assert int(core.total_intermediate_products(a, a)) == \
        int(ref_total_ip(ra, ra))
    spread = np.asarray([0, 5, 31, 32, 40, 511, 512, 600, 8191, 8192, 9000,
                         3, 100], np.int32)
    for v in (ip.numpy(), spread):
        np.testing.assert_array_equal(
            core.ip_histogram(torch.from_numpy(v)).numpy(),
            np.asarray(ref_core.ip_histogram(jnp.asarray(v))))
        np.testing.assert_array_equal(build_map(torch.from_numpy(v)),
                                      np.asarray(ref_build_map(
                                          jnp.asarray(v))))
        np.testing.assert_array_equal(build_map(v), build_map(
            torch.from_numpy(v)))


@pytest.mark.parametrize("k_cap", (None, 3))
def test_ell_round_trip_matches_reference(k_cap):
    """``ell_from_dense`` (a row's nonzeros past ``k_cap`` drop) and
    ``ell_to_dense`` as the reference's; CSR -> ELL -> CSR keeps the
    matrix."""
    x = int_sparse(2, 20, 17, 0.3)
    x[3] = 0  # an empty row
    e, re = ell_from_dense(x, k_cap=k_cap, device="cpu"), \
        ref_ell_from_dense(x, k_cap=k_cap)
    np.testing.assert_array_equal(e.indices.numpy(), np.asarray(re.indices))
    np.testing.assert_array_equal(e.data.numpy(), np.asarray(re.data))
    assert e.shape == tuple(re.shape)
    np.testing.assert_array_equal(ell_to_dense(e).numpy(),
                                  np.asarray(ref_ell_to_dense(re)))
    if k_cap is None:
        np.testing.assert_array_equal(ell_to_dense(e).numpy(), x)
        a = csr_from_dense(x, device="cpu")
        back = ell_to_csr(csr_to_ell(a, e.k_cap))
        np.testing.assert_array_equal(csr_to_dense(back).numpy(), x)


def test_kernel_ops_gather_rows_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 7)).astype(np.float32)
    idx = rng.integers(0, 30, 50).astype(np.int32)
    want = np.asarray(ref_kops.gather_rows(jnp.asarray(x), jnp.asarray(idx),
                                           backend="xla"))
    for backend in ("auto", "xla"):
        np.testing.assert_array_equal(
            kops.gather_rows(torch.from_numpy(x), torch.from_numpy(idx),
                             rows_per_block=8, backend=backend).numpy(),
            want)
    for bad in ("pallas", "interpret"):
        with pytest.raises(ValueError, match="TPU path"):
            kops.gather_rows(torch.from_numpy(x), torch.from_numpy(idx),
                             backend=bad)


def test_kernel_ops_hash_accumulate_matches_reference():
    """``backend="xla"``: the column-sorted rows as the reference's
    fallback gives them; ``"auto"`` on the CPU: the table in probe order,
    the same (column, sum) content and counts."""
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 40, (6, 24)).astype(np.int32)
    keys[rng.random(keys.shape) < 0.3] = -1
    vals = rng.integers(-3, 4, keys.shape).astype(np.float32)
    tk, tv = torch.from_numpy(keys), torch.from_numpy(vals)
    want = ref_kops.hash_accumulate(jnp.asarray(keys), jnp.asarray(vals), 64,
                                    backend="xla")
    got = kops.hash_accumulate(tk, tv, 64, backend="xla")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    cols, sums, counts = kops.hash_accumulate(tk, tv, 64)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want[2]))
    for r in range(keys.shape[0]):
        live = cols[r] >= 0
        order = torch.argsort(cols[r][live])
        n = int(counts[r])
        np.testing.assert_array_equal(cols[r][live][order].numpy(),
                                      np.asarray(want[0])[r, :n])
        np.testing.assert_array_equal(sums[r][live][order].numpy(),
                                      np.asarray(want[1])[r, :n])


def test_resolve_operands_accepts_every_placement():
    for p in ("auto", "footprint", "replicate"):
        assert executor.resolve_operands(p) == ref_core.resolve_operands(p)
    with pytest.raises(ValueError, match="operands"):
        executor.resolve_operands("scatter")
