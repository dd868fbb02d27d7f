"""The routes the card takes for the calls it once refused, on the CPU.

The CUDA kernels run only on the card, where ``chip_smoke.py`` holds each
route against its plain version; here the routes are checked as
``gather_unit``'s are (``tests/test_torch_gather_planes.py``), from sizes,
pointers and strides, and the plain versions of the newly reachable calls
are held against the JAX package:

* K3 (``aia_gather.ranged_route``): ``"v16"`` for whole 16-byte vectors at
  a 16-byte aligned, contiguous ``x``; else the widest of ``"words"``,
  ``"u16"`` and ``"bytes"`` dividing the range (a strided ``x``: a row and
  the pitch) and ``x``'s address.  K1's unit divides the pitch too.
* K6 (``topk_spmm.route``): the tensor cores for bf16 within ``kMaxBlock``
  and ``kMaxInvertBlocks``, the CUDA cores for everything else.
* K5: float16 on the ``"l2"`` kernel.  K7 (``flash_attention.route`` and
  ``bwd_route``): bf16 and float16 forwards up to a qk width of 384 on
  ``wgmma`` (``wgmma_p1`` under ``p_dtype``; values in slabs past 256),
  their backwards up to 256 columns, ``p_dtype`` and keyless queries
  included; float32 and wider heads on the CUDA cores (in slabs past
  192); each build family's entry point.
* The plain versions on float16 (K3, K5, K6), a strided ``x`` (K1, K3)
  and a bf16 block of 512 lanes (K6) against the reference's Pallas kernels
  in interpret mode: bit for bit for the copies and for K5 in float16
  (whose products are exact in float32), within 1e-5 of the largest
  |value| for K6 (another order of sums).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import aia_gather as ref_aia
from repro.kernels import topk_spmm as ref_topk
from repro_torch.kernels import _build, aia_gather, ops, topk_spmm
from repro_torch.kernels import flash_attention as k7
from repro_torch.sparse import formats as tf
from repro_torch.sparse.ops import _TakeRows

REL = 1e-5


@pytest.mark.parametrize("range_bytes,ptr,pitch,row,want", [
    (48, 0, None, None, "v16"),     # whole vectors, aligned
    (42, 0, None, None, "u16"),     # bf16 3 x 7: no whole word
    (16, 2, None, None, "u16"),     # an x 2 bytes past a word
    (15, 0, None, None, "bytes"),   # uint8 3 x 5
    (16, 1, None, None, "bytes"),   # an x 1 byte past a word
    (12, 4, None, None, "words"),
    (480, 0, 256, 160, "words"),    # float32 3 rows of 40 in rows of 64
    (480, 0, 160, 160, "v16"),      # the same rows, contiguous
    (42, 0, 128, 14, "u16"),        # bf16 rows of 7 in rows of 64
    (15, 0, 7, 5, "bytes"),         # uint8 rows of 5 in rows of 7
])
def test_ranged_route_units(range_bytes, ptr, pitch, row, want):
    assert aia_gather.ranged_route(range_bytes, (1 << 20) + ptr, pitch,
                                   row) == want


@pytest.mark.parametrize("row_bytes,ptrs,unit", [
    ([160, 256], [0, 0], "v16"),   # a column slice, pitch and row 16 B
    ([160, 200], [0, 0], "v8"),    # a pitch of 200 bytes
    ([8, 6], [0, 0], "u16"),       # bf16 rows of 4 in rows of 3 + ...
    ([4, 4], [2, 0], "u16"),
])
def test_gather_unit_divides_the_pitch(row_bytes, ptrs, unit):
    assert aia_gather.gather_unit(row_bytes, ptrs) == unit


def test_pitch_of_views():
    x = torch.zeros((10, 24))
    assert aia_gather._pitch(x[:, 4:12]) == 24
    assert aia_gather._pitch(x) == 24
    assert aia_gather._pitch(x[:1, 3:5]) == 2
    with pytest.raises(ValueError, match="inner stride"):
        aia_gather._pitch(x.t())
    with pytest.raises(ValueError, match="overlap"):
        aia_gather._pitch(torch.zeros(5)[None].expand(3, 5))


def test_take_rows_keeps_a_unit_stride_view(monkeypatch):
    """``csr_spmm``'s take hands K1 a column slice as it is (K1 reads rows
    a pitch apart) and copies only a view whose inner stride is not 1."""
    seen = []

    def spy(x, idx):
        seen.append(x)
        return aia_gather.gather_rows_plain(x, idx)

    monkeypatch.setattr("repro_torch.sparse.ops.gather_rows", spy)
    wide = torch.arange(60.0).view(6, 10)
    idx = torch.tensor([5, 0, 7, -1], dtype=torch.int32)
    for x, copied in ((wide[:, 2:7], False), (wide.t()[:, :4], True)):
        got = _TakeRows.apply(x, idx, "aia")
        assert seen[-1].data_ptr() == x.data_ptr() or copied
        assert seen[-1].is_contiguous() == (copied or x.is_contiguous())
        assert torch.equal(got, x[idx.clamp(0, x.shape[0] - 1).long()])


@pytest.mark.parametrize("dtype,block,n_blocks,want", [
    (torch.bfloat16, 128, 64, "wgmma"), (torch.bfloat16, 256, 32_768, "wgmma"),
    (torch.bfloat16, 264, 3, "cuda_cores"),
    (torch.bfloat16, 512, 16, "cuda_cores"),
    (torch.bfloat16, 8, 32_769, "cuda_cores"),
    (torch.float32, 2048, 4, "cuda_cores"),
    (torch.float16, 128, 64, "cuda_cores"),
])
def test_block_topk_route_by_dtype_block_and_blocks(dtype, block, n_blocks,
                                                    want):
    c = _build.source_constants("block_topk_spmm_wgmma.cu")
    assert (c["kMaxBlock"], c["kMaxInvertBlocks"]) == (256, 32_768)
    assert topk_spmm.route(dtype, block, n_blocks) == want


def test_block_topk_panel_is_the_old_float32_cap():
    """The CUDA-core kernel stages 8 rows of at most kPanel lanes as
    float32: the 48 KB a block had before, now a panel of any block."""
    assert _build.source_constants("topk_spmm.cu")["kPanel"] * 8 * 4 \
        == 48 * 1024


@pytest.mark.parametrize("dtype,d_ff,want", [
    (torch.bfloat16, 8192, "smem"), (torch.float32, 8192, "smem"),
    (torch.float16, 8192, "l2"), (torch.bfloat16, 20000, "l2")])
def test_topk_spmm_route_by_dtype(dtype, d_ff, want):
    assert topk_spmm.topk_spmm_route(d_ff, dtype) == want


# 16-bit forwards up to a qk width of 384 (any value width, in slabs past
# 256) take the tensor cores (bf16 past 256 and every float16 call once
# took the CUDA cores)
@pytest.mark.parametrize("dtype,d,dv,p_dtype,want", [
    (torch.bfloat16, 96, 96, None, "wgmma"),
    (torch.bfloat16, 96, 96, torch.bfloat16, "wgmma_p1"),
    (torch.bfloat16, 256, 256, None, "wgmma"),
    (torch.bfloat16, 64, 128, None, "wgmma"),
    (torch.bfloat16, 320, 320, None, "wgmma"),
    (torch.bfloat16, 64, 300, torch.bfloat16, "wgmma_p1"),
    (torch.bfloat16, 384, 512, None, "wgmma"),
    (torch.bfloat16, 385, 64, None, "cuda_cores_slabs"),
    (torch.float32, 192, 192, None, "cuda_cores"),
    (torch.float32, 256, 256, torch.bfloat16, "cuda_cores_slabs"),
    (torch.float16, 96, 96, None, "wgmma"),
    (torch.float16, 96, 96, torch.bfloat16, "wgmma_p1"),
    (torch.float16, 8, 200, None, "wgmma"),
    (torch.float16, 400, 400, None, "cuda_cores_slabs"),
])
def test_k7_forward_routes(dtype, d, dv, p_dtype, want):
    assert k7.route(dtype, d, dv, p_dtype) == want
    assert all(name in _build.SIGNATURES for name in k7.KERNELS[want])


# 16-bit backwards with D and Dv up to 256 take the tensor cores; p_dtype
# and keyless queries choose no route (p_dtype, keyless queries, Dv > D,
# float16 and heads past 128 but MLA's once took the CUDA cores)
@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 64, 64, "wgmma"),
    (torch.bfloat16, 96, 80, "wgmma"),
    (torch.bfloat16, 8, 16, "wgmma"),
    (torch.bfloat16, 64, 128, "wgmma"),
    (torch.bfloat16, 192, 128, "wgmma"),
    (torch.bfloat16, 256, 256, "wgmma"),
    (torch.bfloat16, 257, 64, "cuda_cores_slabs"),
    (torch.float16, 96, 96, "wgmma"),
    (torch.float16, 160, 200, "wgmma"),
    (torch.float16, 64, 320, "cuda_cores_slabs"),
    (torch.float32, 64, 64, "cuda_cores"),
    (torch.float32, 8, 320, "cuda_cores_slabs"),
])
def test_k7_backward_routes(dtype, d, dv, want):
    assert k7.bwd_route(dtype, d, dv) == want
    assert all(name in _build.SIGNATURES for name in k7.BWD_KERNELS[want])


@pytest.mark.parametrize("dtype,d,dv,want", [
    (torch.bfloat16, 96, 96, "repro_flash_attention_wgmma"),
    (torch.float16, 96, 96, "repro_flash_attention_wgmma_f16"),
    (torch.float16, 200, 256, "repro_flash_attention_wgmma_f16"),
    (torch.bfloat16, 64, 300, "repro_flash_attention_wgmma_wide"),
    (torch.float16, 320, 320, "repro_flash_attention_wgmma_wide"),
])
def test_k7_forward_entry_by_build_family(dtype, d, dv, want):
    """bf16 and float16 up to 256 columns have a source and an entry point
    each; the wide builds one for both types."""
    assert k7.wgmma_entry("fwd", dtype, d, dv) == want
    assert want in _build.SIGNATURES


@pytest.mark.parametrize("d,dv,want", [
    (320, 320, (320, 160)), (257, 100, (320, 160)), (64, 300, (320, 160)),
    (321, 64, (384, 128)), (384, 512, (384, 128))])
def test_wgmma_widths_of_the_wide_builds(d, dv, want):
    """Past 256 columns: the qk width's wide build, the values in slabs of
    its value width; the builds' widths are the source's constants."""
    c = k7.wgmma_constants()
    assert (c["kSlabD"], c["kSlabDV"], c["kWideD"], c["kWideDV"]) == (
        320, 160, 384, 128)
    assert k7.wgmma_widths(d, dv) == want


@pytest.mark.parametrize("d,dv,want", [
    (96, 96, (96, 96)), (192, 128, (192, 128)), (160, 150, (160, 160)),
    (64, 128, (128, 128)), (8, 16, (32, 32)), (200, 200, (256, 256)),
    (256, 64, (256, 256)), (100, 190, (192, 192))])
def test_wgmma_widths_take_the_value_width(d, dv, want):
    assert k7.wgmma_widths(d, dv) == want
    assert max(want) <= k7.wgmma_constants()["kMaxD"] == 256


@pytest.mark.parametrize("args,want", [
    ((16, 16, True, 0, -1, None), (1, 16)),
    ((16, 16, False, 0, 0, 0), (16, 16)),
    ((8, 32, False, 4, 40, None), (8, 8)),
    ((64, 64, True, 4, 0, 20), (0, 23)),
    ((64, 64, True, 0, 0, None), (0, 64)),
    ((10, 5, True, 0, -3, 2), (3, 10)),
])
def test_keyless_rows_are_a_prefix_and_a_suffix(args, want):
    assert k7.keyless_rows(*args) == want


def test_keyless_rows_match_every_query_checked():
    """``keyless_rows``' integer bounds against each query's key range
    (``_key_range``) over a grid of masks: the queries with a key are
    exactly ``[a, b)``, or none where ``(a, b) == (sq, sq)``."""
    for sq, sk, causal, window, q_offset, kv_len in itertools.product(
            (1, 5, 17), (1, 4, 9), (True, False), (0, 1, 3, 20),
            range(-20, 21, 3), (None, -1, 0, 2, 100)):
        kvl = sk if kv_len is None else max(0, min(kv_len, sk))
        lo, hi = k7._key_range(torch.arange(sq) + q_offset, kvl, causal,
                               window)
        has = (hi > lo).nonzero().flatten().tolist()
        want = (has[0], has[-1] + 1) if has else (sq, sq)
        assert has == list(range(*want)) or not has
        assert k7.keyless_rows(sq, sk, causal, window, q_offset,
                               kv_len) == want, (sq, sk, causal, window,
                                                 q_offset, kv_len)


@pytest.mark.parametrize("sk,k_chunk,den", [(16, 1024, 16), (40, 16, 48),
                                            (40, 24, 48), (48, 16, 48)])
def test_keyless_denominator(sk, k_chunk, den):
    assert k7.keyless_den(sk, k_chunk) == den


@pytest.mark.parametrize("dtype,code", [
    (torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2)])
def test_kernel_dtype_codes(dtype, code):
    assert ops.expect_float(torch.zeros(2, 3, dtype=dtype), 2, "x") == code
    with pytest.raises(ValueError, match="float16"):
        ops.expect_float(torch.zeros(2, 3, dtype=torch.int32), 2, "x")


def both(x, jdt):
    j = jnp.asarray(x, jdt)
    return j, tf.from_numpy(np.asarray(j), "cpu")


def same(got, want):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("r,d", [(2, 8), (3, 7)])
def test_ranged_gather_float16_and_strided_match_reference(r, d):
    rng = np.random.default_rng(r * 10 + d)
    idx = np.array([4, -2, 0, 9, 3], np.int32)
    jx, tx = both(rng.standard_normal((6 * r, d)), jnp.float16)
    want = ref_aia.aia_ranged_gather(jx, jnp.asarray(np.clip(idx, 0, 5)), r,
                                     interpret=True)
    same(ops.aia_ranged_gather(tx, torch.from_numpy(idx), r), want)
    wide = torch.zeros((6 * r, d + 5), dtype=torch.float16)
    wide[:, 2:2 + d] = tx
    same(ops.aia_ranged_gather(wide[:, 2:2 + d], torch.from_numpy(idx), r),
         want)
    same(ops.gather_rows(wide[:, 2:2 + d], torch.from_numpy(idx)),
         np.asarray(jx)[np.clip(idx, 0, 6 * r - 1)])


def test_topk_spmm_float16_matches_reference():
    rng = np.random.default_rng(1)
    jv, tv = both(rng.standard_normal((4, 6)), jnp.float16)
    jw, tw = both(rng.standard_normal((20, 24)), jnp.float16)
    ji, ti = both(rng.integers(0, 20, (4, 6)), jnp.int32)
    want = ref_topk.topk_spmm(jv, ji, jw, interpret=True)
    same(ops.topk_spmm(tv, ti, tw), want)


@pytest.mark.parametrize("jdt,block", [(jnp.float16, 16), (jnp.bfloat16, 512)])
def test_block_topk_spmm_new_routes_match_reference(jdt, block):
    rng = np.random.default_rng(block)
    n_tiles, kb, tile, d, n_blocks = 3, 2, 4, 12, 4
    jh, th = both(rng.standard_normal((n_tiles, kb, tile, block)), jdt)
    jb, tb = both(rng.integers(0, n_blocks, (n_tiles, kb)), jnp.int32)
    jw, tw = both(rng.standard_normal((n_blocks * block, d)), jdt)
    got = ops.block_topk_spmm(th, tb, tw, block).double().numpy()
    want = np.asarray(ref_topk.block_topk_spmm(jh, jb, jw, block=block,
                                               interpret=True), np.float64)
    assert np.abs(got - want).max() <= REL * np.abs(want).max()
