"""The routes of K6 (``block_topk_spmm``) and K2 (``hash_accumulate``), on
the CPU.

K6 goes by dtype to one of two CUDA kernels: bfloat16 and float16 to the
block-major ``wgmma`` kernel (``csrc/block_topk_spmm_wgmma.cu``; any block,
in depth panels of ``kPanelLanes``, and any number of blocks), float32 to
the CUDA-core kernel (``csrc/topk_spmm.cu``).  K2 goes by table size: a
table of at most ``kSmemTableBytes`` (Table-I groups 0-2) lives in shared
memory, a larger one (group 3) in global memory.  These tests check the
choices, that every route names a built entry point, that the CPU path
counts no launch, that the 16-bit calls past the tensor-core kernel's old
limits take it, and that the shared-memory budgets the sources state fit
an H100 SM.  The kernels run only on the card, where ``chip_smoke.py``
holds every route against its plain version.

They also hold K6's plain version against the reference's Pallas kernel in
interpret mode on the edges the tensor-core kernel's stacking meets: a tile
that picks one block twice, tile 1, and a block that every tile picks; and
an emulation of the tensor-core kernel's order of sums (a partial product
a (pair, depth panel) in a slot of its own, the slots added in (t, panel)
order) against the plain version and the reference, in bf16 and float16 at
blocks of 128, 512 and 2,048 lanes, the same bits in any order of the
blocks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_spmm as ref_topk
from repro_torch.kernels import _build, hash_accum, ops, topk_spmm
from repro_torch.sparse import formats as tf

REL = 1e-5
SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory, 1 KB a block kept


def test_block_topk_routes_by_dtype_to_built_entry_points():
    assert topk_spmm.route(torch.bfloat16) == "wgmma"
    assert topk_spmm.route(torch.float32) == "cuda_cores"
    assert topk_spmm.route(torch.float16) == "wgmma"
    assert all(name in _build.SIGNATURES
               for name in topk_spmm.KERNELS.values())


@pytest.mark.parametrize("cap,want", [(64, "smem"), (1024, "smem"),
                                      (8192, "smem"), (8193, "global"),
                                      (16384, "global"), (4, "smem")])
def test_hash_accumulate_routes_by_table_size(cap, want):
    """Table I's groups 0-2 (64, 1,024 and 8,192 slots) keep their tables
    in shared memory; group 3's next_pow2(max IP) >= 16,384 in global."""
    assert hash_accum.route(cap) == want


def test_hash_tables_fit_three_blocks_an_sm():
    """A block's shared memory (kBlockBytes) must let three blocks share an
    SM and hold a group-2 row's 64 KB table; a mask word covers 32
    windows of 32 slots."""
    c = _build.source_constants("hash_accum.cu")
    assert 3 * (c["kBlockBytes"] + 1024) <= SM_SHARED_BYTES
    assert c["kSmemTableBytes"] == 8192 * 8 <= c["kBlockBytes"]
    assert c["kWordSlots"] == 32 * 32


def test_block_topk_wgmma_fits_two_blocks_an_sm_at_the_ffn_block():
    """At block 128 (the FFN path's) B's two panels and four A slots of 64
    rows take 1024 + 128 * 768 bytes: two blocks an SM.  At the deepest
    panel, kPanelLanes, the block still fits an SM alone."""
    c = _build.source_constants("block_topk_spmm_wgmma.cu")

    def smem(kp):  # B: kp rows x 2 panels; 4 A slots of kTM rows x kp lanes
        return 1024 + kp * 2 * 128 + 4 * c["kTM"] * kp * 2

    assert 2 * (smem(128) + 1024) <= SM_SHARED_BYTES
    assert smem(c["kPanelLanes"]) + 1024 <= SM_SHARED_BYTES


def test_cpu_calls_count_no_launch_or_route():
    ops.reset_launch_counts()
    bidx = torch.tensor([[0, 1]], dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        ops.block_topk_spmm(torch.ones((1, 2, 3, 4), dtype=dt), bidx,
                            torch.ones((8, 5), dtype=dt), 4)
    keys = torch.tensor([[3, -1, 3]], dtype=torch.int32)
    hash_accum.hash_accumulate(keys, torch.ones((1, 3)), 64)
    assert ops.route_counts() == {}
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.mark.parametrize("block,n_blocks", [(264, 2), (8, 32769)])
def test_bf16_route_refuses_past_its_limits_before_a_launch(block, n_blocks):
    """A block past one depth panel (kPanelLanes), or more blocks than the
    counting sort's shared-memory counters hold (kMaxInvertBlocks), were
    once past the tensor-core kernel's limits and took the CUDA cores.
    Now the kernel walks the depth in panels, a slot of its workspace each,
    and keeps the sort's counters in global memory past the limit: the
    bf16 and float16 calls take ``"wgmma"`` and float32 ``"cuda_cores"``,
    whatever the block and number of blocks."""
    c = _build.source_constants("block_topk_spmm_wgmma.cu")
    assert block > c["kPanelLanes"] or n_blocks > c["kMaxInvertBlocks"]
    for dtype in (torch.bfloat16, torch.float16):
        assert topk_spmm.route(dtype) == "wgmma"
    assert topk_spmm.route(torch.float32) == "cuda_cores"
    panels = -(-block // c["kPanelLanes"])
    assert panels == (2 if block > c["kPanelLanes"] else 1)
    assert topk_spmm.wgmma_workspace(1, 1, 1, block, 1) == panels * c["kTN"]


def both(x, jdt):
    j = jnp.asarray(x, jdt)
    return j, tf.from_numpy(np.asarray(j), "cpu")


@pytest.mark.parametrize("jdt", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_tiles,kb,tile,block,d,ids", [
    (3, 3, 8, 16, 24, "repeat"),   # tile 0 names one block twice
    (5, 2, 1, 8, 12, "repeat"),    # tile 1
    (20, 2, 8, 8, 16, "every"),    # 160 rows of one block: 3 chunks of 64
])
def test_block_topk_spmm_edges_match_reference(jdt, n_tiles, kb, tile, block,
                                               d, ids):
    rng = np.random.default_rng(n_tiles * 10 + tile)
    n_blocks = kb + 2
    bidx = rng.integers(0, n_blocks, (n_tiles, kb)).astype(np.int32)
    if ids == "repeat":
        bidx[0, 1] = bidx[0, 0]
    else:
        bidx[:, 0] = 1
    jh, th = both(rng.standard_normal((n_tiles, kb, tile, block)), jdt)
    jb, tb = both(bidx, jnp.int32)
    jw, tw = both(rng.standard_normal((n_blocks * block, d)), jdt)
    got = ops.block_topk_spmm(th, tb, tw, block)
    want = np.asarray(ref_topk.block_topk_spmm(jh, jb, jw, block=block,
                                               interpret=True), np.float64)
    assert got.dtype == torch.float32 and got.shape == (n_tiles * tile, d)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=REL,
                               atol=REL * float(np.abs(want).max()))


def emulate_wgmma_order(h, bidx, w2, block, order):
    """The tensor-core kernel's sums, with its W2 blocks run in ``order``
    (a permutation of the blocks): each (pair, depth panel of
    ``kPanelLanes`` lanes) product in float32 (16-bit products are exact)
    stored to a slot of its own, then each tile's slots added in (t, panel)
    order from 0."""
    panel = _build.source_constants("block_topk_spmm_wgmma.cu")["kPanelLanes"]
    n_tiles, kb, tile, _ = h.shape
    n_blocks = w2.shape[0] // block
    ids = bidx.clamp(0, n_blocks - 1).long()
    w2b = w2.float().reshape(n_blocks, block, -1)
    lanes = list(range(0, block, panel))
    slots = torch.full((n_tiles, kb, len(lanes), tile, w2.shape[1]), np.nan)
    for b in order:
        for i, t in (ids == b).nonzero().tolist():
            for dp, l0 in enumerate(lanes):
                slots[i, t, dp] = (h[i, t, :, l0:l0 + panel].float()
                                   @ w2b[b, l0:l0 + panel])
    out = torch.zeros((n_tiles, tile, w2.shape[1]))
    for t in range(kb):
        for dp in range(len(lanes)):
            out = out + slots[:, t, dp]
    return out.reshape(n_tiles * tile, -1)


@pytest.mark.parametrize("jdt", [jnp.bfloat16, jnp.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("block", [128, 512, 2048])
def test_block_topk_wgmma_order_matches_and_repeats(jdt, block):
    """The fixed order of sums within FFN_REL of the plain version and of
    the reference's Pallas kernel, and the same bits whatever order the
    blocks run in (a repeat)."""
    n_tiles, kb, tile, d = 3, 2, 4, 16
    rng = np.random.default_rng(block)
    n_blocks = kb + 2
    bidx = rng.integers(0, n_blocks, (n_tiles, kb)).astype(np.int32)
    bidx[0, 1] = bidx[0, 0]  # one tile names a block twice
    jh, th = both(rng.standard_normal((n_tiles, kb, tile, block)), jdt)
    jb, tb = both(bidx, jnp.int32)
    jw, tw = both(rng.standard_normal((n_blocks * block, d)), jdt)
    got = emulate_wgmma_order(th, tb, tw, block, range(n_blocks))
    again = emulate_wgmma_order(th, tb, tw, block,
                                rng.permutation(n_blocks).tolist())
    assert torch.equal(got, again)
    plain = ops.block_topk_spmm(th, tb, tw, block).double().numpy()
    want = np.asarray(ref_topk.block_topk_spmm(jh, jb, jw, block=block,
                                               interpret=True), np.float64)
    for ref in (plain, want):
        np.testing.assert_allclose(got.double().numpy(), ref, rtol=REL,
                                   atol=REL * float(np.abs(ref).max()))
