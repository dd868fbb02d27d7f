"""The routes of the FFN path's redesigned kernels, on the CPU.

K4 (``bsr_spmm``) goes by dtype to one of two CUDA kernels, and K3
(``aia_ranged_gather``) by the range's size and ``x``'s alignment to one of
two copies; these tests check the choices, the launch counts kept per
route, and that every route names a built entry point.  The kernels
themselves run only on the card, where ``chip_smoke.py`` holds each route
against its plain version.

They also hold K4's plain version against the reference's Pallas kernel in
interpret mode at the FFN path's block size (128), in float32 and bfloat16,
within 1e-5 of the largest |value| (block products summed in another
order), as ``tests/test_torch_ops.py`` does at smaller blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spgemm_bsr as ref_bsr
from repro_torch.kernels import _build, aia_gather, ops, spgemm_bsr
from repro_torch.sparse import formats as tf

REL = 1e-5


def test_bsr_spmm_routes_by_dtype_to_built_entry_points():
    assert spgemm_bsr.route(torch.bfloat16) == "wgmma"
    assert spgemm_bsr.route(torch.float32) == "cuda_cores"
    assert all(name in _build.SIGNATURES
               for name, _ in spgemm_bsr.KERNELS.values())
    assert (_build.SIGNATURES["repro_bsr_spmm"]
            == _build.SIGNATURES["repro_bsr_spmm_wgmma"])


def test_bsr_wgmma_ring_fits_two_blocks_an_sm():
    """The kernel's launch bounds ask for two blocks an SM: the dynamic
    shared memory it launches with (``kSmemBytes``, which the source
    checks against its ring with a static_assert) must fit half of an
    H100 SM's 228 KB of shared memory, less 1 KB a block."""
    c = _build.source_constants("bsr_spmm_wgmma.cu")
    assert c["kTK"] == 64  # one SW128 panel of depth a stage
    assert 2 * (c["kSmemBytes"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype,r,d,offset,want", [
    (torch.bfloat16, 128, 3072, 0, "v16"),   # the FFN path's W2 ranges
    (torch.bfloat16, 1, 8, 0, "v16"),        # one 16-byte vector
    (torch.float32, 2, 128, 0, "v16"),
    (torch.float32, 1, 4, 256, "v16"),       # aligned, not at the start
    (torch.bfloat16, 1, 6, 0, "words"),      # 12 bytes
    (torch.float32, 1, 3, 0, "words"),       # 12 bytes
    (torch.float32, 1, 4, 4, "words"),       # 16 bytes at a 4-byte offset
    (torch.bfloat16, 128, 3072, 8, "words"),
    (torch.float32, 3, 4, 0, "v16"),         # 48 bytes
    (torch.float32, 5, 1, 0, "words"),       # 20 bytes
])
def test_ranged_route(dtype, r, d, offset, want):
    size = torch.tensor([], dtype=dtype).element_size()
    assert aia_gather.ranged_route(r * d * size, 1 << 20 | offset) == want


@pytest.mark.parametrize("offset,want", [(0, "v16"), (1, "words"),
                                         (4, "v16")])
def test_ranged_route_of_a_tensor_view(offset, want):
    """A float32 view ``offset`` elements into a 16-byte aligned
    allocation: 4 bytes in is off the 16-byte grid, 16 bytes in is on it."""
    base = torch.zeros(64 * 4 + offset, dtype=torch.float32)
    assert base.data_ptr() % 16 == 0
    x = base[offset:].view(64, 4)
    assert aia_gather.ranged_route(x.shape[1] * 4, x.data_ptr()) == want


def test_ranged_gather_refuses_an_x_off_the_word_grid():
    """The word copy reads 4-byte words: a bf16 view 2 bytes into its
    allocation is off their grid, so it takes the 2-byte copy instead."""
    x = torch.zeros(2 * 4 + 1, dtype=torch.bfloat16)[1:].view(2, 4)
    assert x.data_ptr() % 4 == 2
    assert aia_gather.ranged_route(8, x.data_ptr()) == "u16"


def test_launches_are_counted_by_route():
    ops.reset_launch_counts()
    try:
        ops.check_launch("bsr_spmm", 0, "wgmma")
        ops.check_launch("bsr_spmm", 0, "wgmma")
        ops.check_launch("aia_ranged_gather", 0, "v16")
        ops.check_launch("topk_spmm", 0)
        assert ops.launch_counts()["bsr_spmm"] == 2
        assert ops.route_counts() == {"bsr_spmm/wgmma": 2,
                                      "aia_ranged_gather/v16": 1}
        with pytest.raises(RuntimeError, match="failed to launch"):
            ops.check_launch("bsr_spmm", 1, "wgmma")
        assert ops.route_counts()["bsr_spmm/wgmma"] == 2
    finally:
        ops.reset_launch_counts()
    assert ops.route_counts() == {}
    assert all(n == 0 for n in ops.launch_counts().values())


def test_cpu_calls_count_no_route():
    ops.reset_launch_counts()
    rp = torch.tensor([0, 1], dtype=torch.int32)
    ops.bsr_spmm(rp, torch.zeros(1, dtype=torch.int32),
                 torch.zeros((1, 2, 2)), torch.zeros((2, 3)), 1)
    ops.aia_ranged_gather(torch.zeros((4, 4)), torch.zeros(2, dtype=torch.int32),
                          2)
    assert ops.route_counts() == {}


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_bsr_spmm_at_the_ffn_block_size_matches_reference(jdt):
    """bs 128 as on the FFN path, 3 blocks a row, d 16; the middle row has
    4 blocks, one past max_blocks_per_row, which both drop."""
    rng = np.random.default_rng(12)
    bs, d, n_bcols, max_bpr = 128, 16, 4, 3
    rowptr = np.array([0, 3, 7, 10], np.int32)
    colidx = np.array([0, 2, 3, 1, 0, 3, 2, 3, 1, 0], np.int32)
    blocks = rng.standard_normal((10, bs, bs))
    b = rng.standard_normal((n_bcols * bs, d))
    j = (jnp.asarray(rowptr), jnp.asarray(colidx), jnp.asarray(blocks, jdt),
         jnp.asarray(b, jdt))
    t = tuple(tf.from_numpy(np.asarray(x), "cpu") for x in j)
    got = ops.bsr_spmm(*t, max_bpr)
    assert got.dtype == torch.float32 and got.shape == (3 * bs, d)
    want = np.asarray(ref_bsr.bsr_spmm(*j, max_blocks_per_row=max_bpr,
                                       interpret=True), np.float64)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))
    full = ops.bsr_spmm(*t, 4)
    assert not torch.allclose(got[bs:2 * bs], full[bs:2 * bs])
    assert torch.equal(got[:bs], full[:bs])
