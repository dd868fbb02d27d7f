"""The port's distributed pieces on four CPU processes (gloo), against the
one-process port and the JAX package.

One spawn of four ranks a module (``tests/_torch_dist_worker.py``, a
``FileStore`` under tmp_path) runs every check once; each test reads its
part.  The reference's own tests of these paths fail under jax 0.9
(ROADMAP Queue C), so the oracle is what they intend:

* the sharded loss on a (2, 2) data x model mesh: the one-process loss,
  rtol 2e-4 (the reference test's);
* the sharded AdamW step with ZeRO-1 moments: loss and grad norm within
  rtol 2e-4 (also at 2 microbatches, each rank halving its own shard), the moments within 1e-5 of their largest |value| (partial sums
  over the ranks add in another order), each parameter within 2 lr (the
  most one AdamW step can move an element further: its update is about
  lr x sign(g), and a gradient near 0 may change sign), the moments split
  over ``data`` on top of the parameters' placements;
* three decode steps with the caches' sequence split over ``model``:
  logits within 1e-5 of the largest |logit|, the caches within 1e-5;
* ``moe_ffn_shard_map``: its routed experts bit for bit ``moe_ffn``'s
  (llama4-scout's smoke config at capacity factor 1000 on the (2, 2) mesh;
  DeepSeek-V2-Lite's at its own capacity on a (1, 4) mesh, drops included,
  since the token stream is the same); with DeepSeek's shared experts,
  whose SwiGLU is tensor-parallel, within 1e-6 of the largest |value|;
  llama4-scout's whole sharded forward within the
  reference test's rtol 2e-3 / atol 2e-4; DeepSeek-V2-Lite's forward on a
  (1, 1) mesh bit for bit the plain forward;
* ``compressed_psum`` on four ranks: bit for bit the reference's under
  ``jax.vmap(axis_name=)`` on the same rows;
* ``pipeline_apply`` over 4 stages and 8 microbatches: bit for bit the
  stages applied in turn to each microbatch, and within rtol 2e-4 of the
  batched sequential product;
* ``restore_checkpoint(shardings=)`` from a 4-rank data mesh onto a 2-rank
  placement: bit for bit;
* every kernel wrapper raises on a DTensor.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker as worker
from repro.optim import compressed_psum as ref_compressed_psum

WORLD = 4
LR = 1e-3


def _psum_rows():
    rng = np.random.default_rng(5)
    rows = (rng.standard_normal((WORLD, 64)) * 3).astype(np.float32)
    rows[2, 7] = 0.0
    return rows


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    mp.start_processes(worker.main, args=(WORLD, str(d / "store"), str(d),
                                          _psum_rows()),
                       nprocs=WORLD, join=True, start_method="spawn")
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def test_sharded_loss_matches_one_process(results):
    for r in results:
        np.testing.assert_allclose(r["loss"]["sharded"], r["loss"]["single"],
                                   rtol=2e-4)


def test_sharded_step_with_zero1_matches_one_process(results):
    s = results[0]["step"]
    np.testing.assert_allclose(s["loss"][1], s["loss"][0], rtol=2e-4)
    np.testing.assert_allclose(s["grad_norm"][1], s["grad_norm"][0],
                               rtol=2e-4)
    assert s["mu_diff"] <= 1e-5 * s["mu_scale"]
    assert s["nu_diff"] <= 1e-5 * s["nu_scale"]
    assert s["param_diff"] <= 2 * LR
    assert s["step"] == (1, 1)
    for k, (one, sharded) in s["microbatched"].items():
        np.testing.assert_allclose(sharded, one, rtol=2e-4, err_msg=k)
    # ZeRO-1: every moment adds the data split to its parameter's
    for k, pl in s["param_placements"].items():
        assert pl[0] == "R", (k, pl)
        assert s["mu_placements"][k][0].startswith("S("), (k, s["mu_placements"][k])
        assert s["mu_placements"][k][1] == pl[1], k


def test_sharded_decode_matches_one_process(results):
    """Decode steps with the caches' sequence split over ``model`` (the
    split write and flash-decoding's all-reduced softmax)."""
    for r in results:
        d = r["decode"]
        assert "model" in d["split"], d["split"]
        assert d["rel"] <= 1e-5, d["rel"]
        assert d["caches"]


@pytest.mark.parametrize("case", ["moe_llama4", "moe_deepseek"])
def test_moe_shard_map_is_bit_for_bit_moe_ffn(results, case):
    for r in results:
        routed, full = r[case]["routed"], r[case]["full"]
        assert torch.equal(routed["got"], routed["want"]), case
        # the shared experts' SwiGLU adds its row-parallel partial sums
        scale = float(full["want"].abs().max())
        assert float((full["got"] - full["want"]).abs().max()) \
            <= 1e-6 * scale, case
        # aux: each batch shard's estimate, averaged (the reference's)
        assert np.isfinite(routed["aux"][1]) and routed["aux"][1] > 0


def test_sharded_moe_forward_matches_unsharded(results):
    for r in results:
        np.testing.assert_allclose(r["moe_forward"]["got"].numpy(),
                                   r["moe_forward"]["want"].numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_unit_mesh_forward_is_bit_for_bit(results):
    for r in results:
        assert torch.equal(r["unit_mesh"]["got"], r["unit_mesh"]["want"])


def test_compressed_psum_matches_reference(results):
    rows = _psum_rows()
    ref = np.asarray(jax.vmap(lambda r: ref_compressed_psum(r, "data"),
                              axis_name="data")(jnp.asarray(rows)))
    for rank, r in enumerate(results):
        got = r["psum"].numpy()
        np.testing.assert_array_equal(got, ref[rank])
        amax = np.abs(rows).max()
        assert np.abs(got - rows.sum(0)).max() <= 8 * amax / 127.0 + 1e-6


def test_pipeline_apply_equals_sequential(results):
    for r in results:
        p = r["pipeline"]
        assert torch.equal(p["out"], p["seq"])
        np.testing.assert_allclose(p["out"].numpy(), p["batched"].numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_restore_checkpoint_reshards(results):
    for r in results:
        c = r["ckpt"]
        assert torch.equal(c["full"], c["want"])
        assert torch.equal(c["b"], torch.ones(8))
        assert c["mesh_size"] == 2
        assert c["local_shape"] == (8, 4)


def test_kernel_wrappers_refuse_dtensors(results):
    """A DTensor reaching a kernel wrapper raises (K7 takes local tensors
    through ``local_map``); none is gathered or unwrapped silently."""
    for r in results:
        for name, msg in r["refusals"].items():
            assert msg is not None and "local_map" in msg, (name, msg)
