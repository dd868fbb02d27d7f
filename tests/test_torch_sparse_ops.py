"""The port's CSR primitives (``repro_torch.sparse.ops``) against the
reference's (``repro.sparse.ops``), on the CPU.

Each test builds its operands in numpy from a seed and runs both packages
on them.  Structure (``indptr``, ``indices``, capacity) must be equal, and
the values bit for bit: on the CPU every op keeps the reference's order of
sums (``index_add`` adds in index order, as XLA's scatter-add does).
``csr_spmm``'s gradients in ``x`` and ``a.data`` are held against
``jax.grad`` of the reference's custom-VJP take, for the ``xla`` gather and
for ``aia`` (the reference's Pallas row gather in interpret mode; the port's
kernel wrapper runs its plain version on the CPU), with ``x`` contiguous and
transposed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sparse import ops as ref_ops
from repro.sparse.formats import CSR as RefCSR
from repro.sparse.formats import csr_from_dense as ref_csr_from_dense
from repro_torch.sparse import ops
from repro_torch.sparse.formats import CSR, csr_from_arrays


def sparse_matrix(rng, n, m, density=0.3, values="float"):
    """A dense (n, m) float32 matrix with ``density`` of it nonzero; integer
    values make ties."""
    if values == "int":
        x = rng.integers(1, 4, (n, m)).astype(np.float32)
    else:
        x = (rng.random((n, m)) + 0.05).astype(np.float32)
    return np.where(rng.random((n, m)) < density, x, 0).astype(np.float32)


def pair(x, spare=5):
    """``x`` as (port CSR on the CPU, reference CSR), with ``spare`` padding
    slots past nnz."""
    nnz = int(np.count_nonzero(x))
    ref = ref_csr_from_dense(x, capacity=nnz + spare)
    return port(ref), ref


def port(ref):
    return csr_from_arrays(np.asarray(ref.indptr), np.asarray(ref.indices),
                           np.asarray(ref.data), ref.shape, device="cpu")


def assert_same_csr(got: CSR, want: RefCSR):
    """Same shape, capacity and every slot (padding included), bit for bit."""
    assert got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_row_nnz_and_spmv_match_reference():
    rng = np.random.default_rng(0)
    a, ra = pair(sparse_matrix(rng, 20, 17))
    x = rng.standard_normal(17).astype(np.float32)
    np.testing.assert_array_equal(ops.csr_row_nnz(a).numpy(),
                                  np.asarray(ref_ops.csr_row_nnz(ra)))
    np.testing.assert_array_equal(
        ops.csr_spmv(a, torch.from_numpy(x)).numpy(),
        np.asarray(ref_ops.csr_spmv(ra, jnp.asarray(x))))


@pytest.mark.parametrize("capacity", ["smaller", "equal", "larger"])
def test_transpose_matches_reference(capacity):
    """A 23 x 11 matrix with 5 spare slots; the transpose's capacity below
    nnz (entries past it dropped), equal to the input's, and above it."""
    rng = np.random.default_rng(1)
    a, ra = pair(sparse_matrix(rng, 23, 11))
    cap = {"smaller": a.capacity - 9, "equal": None,
           "larger": a.capacity + 7}[capacity]
    got = ops.csr_transpose(a, capacity=cap)
    assert_same_csr(got, ref_ops.csr_transpose(ra, capacity=cap))
    assert got.shape == (11, 23)


@pytest.mark.parametrize("op", ["scale_rows", "scale_columns",
                                "hadamard_power", "column_normalize"])
def test_value_ops_match_reference(op):
    rng = np.random.default_rng(2)
    x = sparse_matrix(rng, 19, 13)
    x[:, 4] = 0  # an empty column: normalize leaves it at zero
    a, ra = pair(x)
    s_rows = (rng.random(19) + 0.5).astype(np.float32)
    s_cols = (rng.random(13) + 0.5).astype(np.float32)
    got, want = {
        "scale_rows": lambda: (
            ops.csr_scale_rows(a, torch.from_numpy(s_rows)),
            ref_ops.csr_scale_rows(ra, jnp.asarray(s_rows))),
        "scale_columns": lambda: (
            ops.csr_scale_columns(a, torch.from_numpy(s_cols)),
            ref_ops.csr_scale_columns(ra, jnp.asarray(s_cols))),
        "hadamard_power": lambda: (ops.csr_hadamard_power(a, 2.0),
                                   ref_ops.csr_hadamard_power(ra, 2.0)),
        "column_normalize": lambda: (ops.csr_column_normalize(a),
                                     ref_ops.csr_column_normalize(ra)),
    }[op]()
    assert_same_csr(got, want)
    np.testing.assert_array_equal(ops.csr_column_sums(a).numpy(),
                                  np.asarray(ref_ops.csr_column_sums(ra)))


@pytest.mark.parametrize("r", [1.5, 2.0, 3.0, 0.5])
def test_hadamard_power_is_correctly_rounded(r):
    """On 200,000 float32 values in (0, 4): bit-equal to the float64 power
    rounded once to float32, and within one ulp of the reference's
    ``jnp.power`` (which misses the correctly rounded value on about 0.06%
    of them, by one ulp).  Each assert names the entries it fails on."""
    rng = np.random.default_rng(int(r * 10))
    n = 200_000
    x = (rng.random(n) * 4).astype(np.float32)
    a = CSR(torch.tensor([0, n], dtype=torch.int32),
            torch.zeros(n, dtype=torch.int32), torch.from_numpy(x), (1, 1))
    got = ops.csr_hadamard_power(a, r).data.numpy()
    want = np.power(x.astype(np.float64), r).astype(np.float32)
    off = np.flatnonzero(got != want)
    assert off.size == 0, (
        f"port: {off.size} entries off the correctly rounded power, first "
        f"at {off[:4].tolist()}: x={x[off[:4]].tolist()} "
        f"got={got[off[:4]].tolist()} want={want[off[:4]].tolist()}")
    ref = np.asarray(ref_ops.csr_hadamard_power(
        RefCSR(jnp.asarray([0, n], jnp.int32), jnp.zeros(n, jnp.int32),
               jnp.asarray(x), (1, 1)), r).data)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - ref.view(np.int32))
    far = np.flatnonzero(ulps > 1)
    assert far.size == 0, (
        f"reference: {far.size} entries more than one ulp off, first at "
        f"{far[:4].tolist()}: x={x[far[:4]].tolist()} "
        f"ref={ref[far[:4]].tolist()} port={got[far[:4]].tolist()}")


@pytest.mark.parametrize("theta,k", [(0.0, 2), (2.0, 3), (1.5, 1), (0.0, 99)])
def test_prune_columns_with_ties_matches_reference(theta, k):
    """Values in {1, 2, 3}, so most columns hold ties at their k-th value:
    the kept entries among equal values are the first slots, as the
    reference keeps them."""
    rng = np.random.default_rng(3)
    a, ra = pair(sparse_matrix(rng, 30, 9, density=0.6, values="int"))
    got = ops.csr_prune_columns(a, theta, k)
    assert_same_csr(got, ref_ops.csr_prune_columns(ra, theta, k))
    kept = (got.data.numpy() != 0)
    per_col = np.bincount(got.indices.numpy()[kept], minlength=9)
    assert per_col.max() <= k


@pytest.mark.parametrize("inverse", [False, True])
def test_permute_rows_matches_reference(inverse):
    rng = np.random.default_rng(4)
    x = sparse_matrix(rng, 16, 12)
    x[5] = 0  # an empty row
    a, ra = pair(x)
    perm = rng.permutation(16).astype(np.int32)
    got = ops.csr_permute_rows(a, perm, inverse=inverse)
    assert_same_csr(got, ref_ops.csr_permute_rows(ra, jnp.asarray(perm),
                                                  inverse=inverse))


def spmm_case(transposed):
    """A (14 x 11, 4 spare slots), X (11, 6) (built as the transpose of a
    (6, 11) array when ``transposed``) and the loss weights W (14, 6)."""
    rng = np.random.default_rng(5)
    a, ra = pair(sparse_matrix(rng, 14, 11, density=0.35), spare=4)
    xt = rng.standard_normal((6, 11)).astype(np.float32)
    x = torch.from_numpy(xt).T if transposed else \
        torch.from_numpy(np.ascontiguousarray(xt.T))
    w = rng.standard_normal((14, 6)).astype(np.float32)
    return a, ra, x, np.ascontiguousarray(xt.T), w


@pytest.mark.parametrize("gather", ["xla", "aia"])
@pytest.mark.parametrize("transposed", [False, True])
def test_spmm_and_gradients_match_jax_grad(gather, transposed):
    a, ra, x, x_np, w = spmm_case(transposed)
    assert x.is_contiguous() != transposed

    def ref_loss(data, xx):
        out = ref_ops.csr_spmm(RefCSR(ra.indptr, ra.indices, data, ra.shape),
                               xx, gather=gather)
        return jnp.sum(out * w), out

    (_, want), (g_data, g_x) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(ra.data, jnp.asarray(x_np))
    data = a.data.clone().requires_grad_()
    xv = x.detach().clone() if not transposed else x.detach()
    xv.requires_grad_()
    out = ops.csr_spmm(CSR(a.indptr, a.indices, data, a.shape), xv,
                       gather=gather)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xv.grad.numpy(), np.asarray(g_x))
    # d loss / d data[p] = sum_j w[row(p), j] * x[col(p), j]: a sum of d
    # products that XLA and PyTorch reduce in other orders, so within d
    # float32 epsilons of the sum of the terms' magnitudes
    rows = np.minimum(np.asarray(ra.row_ids()), 13)
    terms = np.abs(w[rows] * x_np[np.asarray(ra.indices)]).sum(1)
    bound = w.shape[1] * np.finfo(np.float32).eps * terms
    assert (np.abs(data.grad.numpy() - np.asarray(g_data)) <= bound).all()


def test_spmm_auto_gather_and_refusals():
    """``gather="auto"`` is the plain take on the CPU; a value that is not
    a mesh says what a mesh is; operands on two devices and unknown
    gathers raise."""
    a, ra, x, x_np, _ = spmm_case(False)
    np.testing.assert_array_equal(
        ops.csr_spmm(a, x, gather="auto").numpy(),
        np.asarray(ref_ops.csr_spmm(ra, jnp.asarray(x_np), gather="xla")))
    with pytest.raises(TypeError, match="a mesh is"):
        ops.csr_spmm(a, x, mesh=object())
    with pytest.raises(ValueError, match="gather"):
        ops.csr_spmm(a, x, gather="pallas")
    with pytest.raises(ValueError, match="X is on meta"):
        ops.csr_spmm(a, x.to("meta"))
