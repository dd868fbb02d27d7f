"""K1's one-launch gather of both ELL planes, on the CPU.

``gather_planes`` takes one or two planes of equal row count through one
id stream; on the card it is one launch whose copy unit (``gather_unit``:
16, 8, 4, 2 or 1 bytes) divides every plane's row bytes and every address.
On a CPU tensor it runs ``gather_planes_plain``.  These tests hold the
plain version bit for bit against the reference's Pallas row gather
(``repro.kernels.aia_gather.gather_rows_any``, interpret mode) plane by
plane, check the unit chosen for the Table II matrices' ELL rows, odd
widths and misaligned views, check that the CUDA wrapper refuses bad
operands before any launch, and hold the executor's AIA gather of B's
planes against its plain take.  The kernel itself is held against the same
plain version on the card by ``chip_smoke.py`` (every chunk of both
matrices, and every copy unit).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.aia_gather import gather_rows_any as ref_gather_rows_any
from repro_torch.core import executor
from repro_torch.kernels import aia_gather, ops
from repro_torch.sparse import formats as tf


def plane(rng, dtype, n, width):
    """A plane of ``n`` rows as a JAX array and the same values in torch."""
    x = jnp.asarray(rng.integers(-50, 50, (n, width)), dtype)
    return x, tf.from_numpy(np.asarray(x), "cpu")


def same(got, want):
    """Bit for bit: every value here is a small integer, exact in float64."""
    np.testing.assert_array_equal(got.double().numpy(),
                                  np.asarray(want).astype(np.float64))


@pytest.mark.parametrize("dtypes,n,width,n_idx", [
    ((jnp.int32, jnp.float32), 40, 14, 50),    # RoadTX's ELL rows
    ((jnp.int32, jnp.bfloat16), 30, 7, 33),    # an odd-width bf16 plane
    ((jnp.bfloat16,), 12, 7, 9),               # the same plane alone
    ((jnp.float32,), 17, 5, 64),               # one plane
    ((jnp.int32, jnp.float32), 6, 591, 20),    # p2p-Gnutella04's ELL rows
], ids=["int32_float32", "int32_bf16_odd", "bf16_odd_alone", "one_plane",
        "p2p_rows"])
def test_gather_planes_plain_matches_reference(dtypes, n, width, n_idx):
    rng = np.random.default_rng(n * width)
    idx = rng.integers(-3, n + 3, n_idx).astype(np.int32)  # clipped ids
    pairs = [plane(rng, dt, n, width) for dt in dtypes]
    got = aia_gather.gather_planes([t for _, t in pairs],
                                   torch.from_numpy(idx))
    assert len(got) == len(pairs)
    for (jx, tx), g in zip(pairs, got):
        assert g.dtype == tx.dtype
        same(g, ref_gather_rows_any(jx, jnp.asarray(idx), interpret=True))


@pytest.mark.parametrize("n_planes", [1, 2])
def test_gather_planes_empty_stream(n_planes):
    """The reference's Pallas gather cannot take an empty stream (its grid
    slices a 0-row block); the plain version and the CUDA wrapper return
    empty planes of the right width, the wrapper without a launch."""
    ops.reset_launch_counts()
    planes = [torch.ones((4, 3), dtype=torch.int32),
              torch.ones((4, 5), dtype=torch.bfloat16)][:n_planes]
    idx = torch.zeros(0, dtype=torch.int32)
    for fn in (aia_gather.gather_planes, aia_gather._gather_planes_cuda):
        out = fn(planes, idx)
        assert [tuple(o.shape) for o in out] == \
            [(0, p.shape[1]) for p in planes]
        assert [o.dtype for o in out] == [p.dtype for p in planes]
    assert ops.launch_counts()["gather_rows"] == 0


def test_gather_rows_is_the_one_plane_case():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((9, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(-2, 12, 15).astype(np.int32))
    assert torch.equal(aia_gather.gather_rows(x, idx),
                       aia_gather.gather_planes_plain((x,), idx)[0])
    assert aia_gather.gather_rows_any is aia_gather.gather_rows


@pytest.mark.parametrize("row_bytes,ptrs,unit", [
    ([56, 56], [0, 256, 512, 768], "v8"),        # RoadTX: 14 int32 / f32
    ([2364, 2364], [0, 256, 512, 768], "words"),  # p2p: 591 int32 / f32
    ([6], [0, 256], "u16"),                       # bf16 rows of 3
    ([14, 28], [0, 256, 512, 768], "u16"),        # bf16 of 7 beside int32 of 7
    ([3], [0, 256], "bytes"),                     # int8 rows of 3
    ([32, 16], [0, 256, 512, 768], "v16"),
    ([16, 16], [4, 256, 516, 768], "words"),     # 4-byte aligned views
    ([16], [2, 256], "u16"),
    ([16], [1, 256], "bytes"),
])
def test_gather_unit(row_bytes, ptrs, unit):
    assert aia_gather.gather_unit(row_bytes, ptrs) == unit


@pytest.mark.parametrize("dtype,width,offset,unit", [
    (torch.float32, 4, 0, "v16"), (torch.float32, 4, 1, "words"),
    (torch.bfloat16, 8, 1, "u16"), (torch.int8, 16, 3, "bytes"),
    (torch.int32, 14, 2, "v8"),
])
def test_gather_unit_of_views(dtype, width, offset, unit):
    """A row-slice view is contiguous but starts ``offset`` elements into
    its allocation, which narrows the unit."""
    base = torch.zeros(10 * width + offset, dtype=dtype)
    x = base[offset:].view(10, width)
    assert x.is_contiguous()
    out = torch.empty((5, width), dtype=dtype)  # aligned, as allocated
    assert aia_gather.gather_unit([width * x.element_size()],
                                  [x.data_ptr(), out.data_ptr()]) == unit


@pytest.mark.parametrize("planes,idx,match", [
    ((torch.zeros((4, 3)), torch.zeros((5, 3))),
     torch.zeros(2, dtype=torch.int32), "equal row count"),
    ((torch.zeros((4, 3)),) * 3, torch.zeros(2, dtype=torch.int32),
     "one or two planes"),
    ((torch.zeros((4, 6))[:, ::2],), torch.zeros(2, dtype=torch.int32),
     "contiguous"),
    ((torch.zeros((4, 3)),), torch.zeros(2, dtype=torch.int64), "idx"),
    ((torch.zeros((0, 3)),), torch.zeros(2, dtype=torch.int32), "empty x"),
    ((torch.zeros(4),), torch.zeros(2, dtype=torch.int32), "2-d"),
])
def test_cuda_gather_planes_refuses_before_a_launch(planes, idx, match):
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=match):
        aia_gather._gather_planes_cuda(planes, idx)
    assert ops.launch_counts()["gather_rows"] == 0


@pytest.mark.parametrize("plane_devs,idx_dev", [
    (("meta",), "cpu"), (("meta", "meta"), "cpu"), (("cpu", "meta"), "cpu"),
    (("cpu",), "meta"), (("cpu", "cpu"), "meta"),
])
def test_gather_planes_refuses_mixed_devices(plane_devs, idx_dev):
    """Planes on another device than ``idx`` raise, whichever side is off
    the CPU: no plain take of planes that lie on a device (``meta`` stands
    in for the card here), and no launch."""
    planes = tuple(torch.zeros((4, 3), device=d) for d in plane_devs)
    idx = torch.zeros(2, dtype=torch.int32, device=idx_dev)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match=" on "):
        aia_gather.gather_planes(planes, idx)
    assert ops.launch_counts()["gather_rows"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_executor_aia_gather_matches_plain_take(dtype):
    """``_gather_b_aia`` (one ``gather_planes`` call for both of B's
    planes) equals ``_gather_b_xla`` on the CPU: padding ids (-1) and ids
    past B's rows are clipped alike."""
    rng = np.random.default_rng(7)
    n, kb, r, a_cap = 23, 5, 6, 4
    b_idx = torch.from_numpy(np.where(rng.random((n, kb)) < 0.3, -1,
                                      rng.integers(0, 40, (n, kb)))
                             .astype(np.int32))
    b_val = torch.from_numpy(rng.standard_normal((n, kb))).to(dtype)
    cols_a = torch.from_numpy(rng.integers(-1, n + 2, (r, a_cap))
                              .astype(np.int32))
    got = executor._gather_b_aia(b_idx, b_val, cols_a)
    want = executor._gather_b_xla(b_idx, b_val, cols_a)
    assert all(g.shape == (r, a_cap, kb) for g in got)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
