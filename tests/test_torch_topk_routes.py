"""The routes of K5 (``topk_spmm``, per token), on the CPU.

On CUDA, W2's row count chooses the kernel: ``"smem"``
(``csrc/topk_spmm_smem.cu``: a 16-byte column slice of W2 for all its rows
in one block's shared memory, beside the pair buffers) where that fits the
shared memory a block may use, else ``"l2"`` (``csrc/topk_spmm.cu``).  The
limit is read from the source's constants.  The ``"smem"`` kernel's
pre-pass packs each (clipped id, value) pair t-major within groups of
``kThreads`` tokens; a NumPy emulation of that packing is held here against
the plain version's clipped ids, and the plain version (which both kernels
equal bit for bit on the card, ``chip_smoke.py``) against the reference's
Pallas kernel in interpret mode on both sides of the limit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_spmm as ref_topk
from repro_torch.kernels import _build, ops, topk_spmm
from repro_torch.sparse import formats as tf

SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory, 1 KB a block kept
C = _build.source_constants("topk_spmm_smem.cu")
# the largest d_ff whose slice and pair buffers fit one block
LIMIT = (C["kMaxSmem"] - C["kStages"] * C["kStageBytes"]
         - C["kBarrierBytes"]) // C["kSliceBytes"]


@pytest.mark.parametrize("d_ff,route", [
    (1, "smem"), (8192, "smem"), (LIMIT - 1, "smem"), (LIMIT, "smem"),
    (LIMIT + 1, "l2"), (2 * LIMIT, "l2"), (65536, "l2"),
])
def test_topk_spmm_routes_by_w2_rows(d_ff, route):
    assert topk_spmm.topk_spmm_route(d_ff) == route


def test_smem_route_limits_fit_an_h100_block():
    """At the limit the block takes at most ``kMaxSmem`` (an H100 block's
    227 KB), one block an SM; Phi-3-mini's d_ff 8,192 takes the route; the
    route's ids fit the 16 bits a bf16 pair keeps for them; a stage holds
    at least one step of t for every token of a group in either dtype, in
    whole 16-byte bulk copies; each stage's two barriers fit their room."""
    assert C["kMaxSmem"] == 232448
    assert topk_spmm.topk_spmm_smem_bytes(LIMIT) <= C["kMaxSmem"] \
        < topk_spmm.topk_spmm_smem_bytes(LIMIT + 1)
    assert topk_spmm.topk_spmm_smem_bytes(LIMIT) + 1024 <= SM_SHARED_BYTES
    assert LIMIT >= 8192 and LIMIT < 2 ** 16
    assert C["kStageBytes"] // (C["kThreads"] * 8) >= 1
    assert C["kThreads"] % 32 == 0 and C["kStageBytes"] % 16 == 0
    assert 2 * 8 * C["kStages"] <= C["kBarrierBytes"]


def pack_pairs(vals_bits, idx, d_ff, group, wide):
    """The pre-pass in NumPy: pairs[g][t][j] for token g * group + j, each
    (clip(id), value bits) as one word (bf16: bits << 16 | id) or two
    (float32: id, bits), zero pairs past the last token."""
    n, k = idx.shape
    n_pad = -(-n // group) * group
    ids = np.zeros((n_pad, k), np.uint32)
    bits = np.zeros((n_pad, k), np.uint32)
    ids[:n] = np.clip(idx, 0, d_ff - 1)
    bits[:n] = vals_bits
    if wide:
        packed = np.stack([ids, bits], axis=-1)          # (n_pad, k, 2)
    else:
        packed = (bits << 16) | ids                       # (n_pad, k)
    packed = packed.reshape((n_pad // group, group, k) + packed.shape[2:])
    return np.swapaxes(packed, 1, 2)                      # (groups, k, group)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("n,k,d_ff", [(3, 13, 64), (600, 9, LIMIT),
                                      (1100, 5, 500)])
def test_pair_packing_matches_the_plain_versions_ids(dt, n, k, d_ff):
    rng = np.random.default_rng(n + k)
    idx = rng.integers(-3, d_ff + 3, (n, k)).astype(np.int32)
    idx[:, 1::3] = idx[:, :1]  # repeated ids
    vals = torch.from_numpy(rng.standard_normal((n, k))).to(dt)
    wide = dt == torch.float32
    vals_bits = (vals.view(torch.int32) if wide else
                 vals.view(torch.int16)).numpy().astype(np.uint32) \
        & (0xFFFFFFFF if wide else 0xFFFF)
    group = C["kThreads"]
    pairs = pack_pairs(vals_bits, idx, d_ff, group, wide)
    assert pairs.shape[:3] == (-(-n // group), k, group)
    flat = np.swapaxes(pairs, 1, 2).reshape((-1, k) + pairs.shape[3:])
    got_ids = flat[..., 0] if wide else flat & 0xFFFF
    got_bits = flat[..., 1] if wide else flat >> 16
    # the plain version's clipped ids, token by token; values unchanged
    want_ids = torch.from_numpy(idx).clamp(0, d_ff - 1).numpy()
    np.testing.assert_array_equal(got_ids[:n], want_ids)
    np.testing.assert_array_equal(got_bits[:n], vals_bits)
    assert not flat[n:].any()  # padding tokens: zero pairs
    # a step of t for a group is one contiguous run of ``group`` pairs
    g, t, j = (n - 1) // group, k - 1, (n - 1) % group
    np.testing.assert_array_equal(
        pairs.reshape((-1,) + pairs.shape[3:])[(g * k + t) * group + j],
        flat[n - 1, t])


@pytest.mark.parametrize("d_ff", [LIMIT, LIMIT + 1], ids=["at", "past"])
def test_topk_spmm_plain_matches_reference_across_the_limit(d_ff):
    """bf16, repeated ids: the plain version equals the reference's Pallas
    kernel bit for bit on both sides of the route's limit (the reference
    does not clip, so the ids are in range)."""
    rng = np.random.default_rng(d_ff)
    n, k, d = 5, 7, 12
    idx = rng.integers(0, d_ff, (n, k)).astype(np.int32)
    idx[:, 2] = idx[:, 0]
    idx[1] = d_ff - 1
    jv = jnp.asarray(rng.standard_normal((n, k)), jnp.bfloat16)
    jw = jnp.asarray(rng.standard_normal((d_ff, d)), jnp.bfloat16)
    got = topk_spmm.topk_spmm_plain(tf.from_numpy(np.asarray(jv), "cpu"),
                                    torch.from_numpy(idx),
                                    tf.from_numpy(np.asarray(jw), "cpu"))
    want = ref_topk.topk_spmm(jv, jnp.asarray(idx), jw, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_topk_spmm_counts_no_launch_or_route():
    ops.reset_launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        ops.topk_spmm(torch.ones((2, 3), dtype=dt),
                      torch.tensor([[0, 1, 9], [2, 2, -1]], dtype=torch.int32),
                      torch.ones((LIMIT + 1, 4), dtype=dt))
    assert ops.route_counts() == {}
    assert ops.launch_counts()["topk_spmm"] == 0
