"""The rank side of ``tests/test_torch_dist.py``: every check of the port's
distributed pieces, run once in each of four gloo processes (a
``FileStore`` under the test's tmp_path, so parallel test workers never
share a port).  Each rank writes its results to ``out_dir/rank<r>.pt``;
the test process holds them against the one-process runs and the
reference.  Imports no JAX."""
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


def _granite(n_layers=2):
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config("granite-3-2b"),
                               n_layers=n_layers)


def _batch(cfg, seed=0, shape=(4, 32)):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, shape)),
            "labels": torch.from_numpy(rng.integers(0, cfg.vocab, shape))}


def _placed(cfg, params, mesh, model_size):
    from repro_torch.launch.sharding import NamedSharding, distribute, \
        tree_map
    from repro_torch.models import transformer as tf

    specs = tf.param_specs(cfg, params, model_size=model_size)
    return tree_map(lambda x, s: distribute(x, NamedSharding(mesh, s)),
                    params, specs)


def _on_data(batch, mesh):
    from repro_torch.launch.sharding import NamedSharding, P, distribute
    return {k: distribute(v, NamedSharding(mesh, P("data", None)))
            for k, v in batch.items()}


def sharded_loss(mesh):
    """granite's 2-layer smoke loss, one process and on the (2, 2) mesh."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import make_shardings
    from repro_torch.models import transformer as tf

    cfg = _granite()
    params = tf.init_transformer(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    batch = _batch(cfg)
    single = float(tf.train_loss(cfg, params, batch))
    with use_mesh(mesh):
        loss = tf.train_loss(cfg, _placed(cfg, params, mesh, 2),
                             _on_data(batch, mesh), make_shardings(mesh))
    return {"single": single, "sharded": float(loss.full_tensor())}


def sharded_step(mesh):
    """One AdamW step of granite's smoke config, one process and on the
    (2, 2) mesh with ZeRO-1 moments: metrics, and the largest difference of
    every new leaf."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import make_shardings
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.optim.zero import zero1_state_specs
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        shard_train_state)

    cfg = _granite()
    state = init_train_state(cfg, torch.Generator().manual_seed(1),
                             device="cpu")
    batch = _batch(cfg, seed=1)
    s1, m1 = make_train_step(cfg, adamw(1e-3))(state, batch)
    specs = tf.param_specs(cfg, state.params, model_size=2)
    zspecs = zero1_state_specs(specs, state.params)
    placed = shard_train_state(cfg, state, mesh, specs, zspecs)
    with use_mesh(mesh):
        s2, m2 = make_train_step(cfg, adamw(1e-3),
                                 sh=make_shardings(mesh))(placed,
                                                          _on_data(batch,
                                                                   mesh))
    f1, f2 = tf.flat_params(s1.params), tf.flat_params(s2.params)

    def worst(a, b):
        return max(float((a[k] - b[k].full_tensor()).abs().max()) for k in a)

    def scale(a):
        return max(float(a[k].abs().max()) for k in a)

    # two microbatches: each rank halves its own batch shard, so the
    # microbatches differ from the one process's; the mean loss and the
    # averaged gradients do not
    _, m1b = make_train_step(cfg, adamw(1e-3), microbatches=2)(state, batch)
    with use_mesh(mesh):
        _, m2b = make_train_step(cfg, adamw(1e-3), microbatches=2,
                                 sh=make_shardings(mesh))(
            placed, _on_data(batch, mesh))
    mu_pl = {k: tuple(str(p) for p in v.placements)
             for k, v in s2.opt.mu.items()}
    return {"loss": (float(m1["loss"]), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
            "param_diff": worst(f1, f2),
            "mu_diff": worst(s1.opt.mu, s2.opt.mu), "mu_scale":
            scale(s1.opt.mu), "nu_diff": worst(s1.opt.nu, s2.opt.nu),
            "nu_scale": scale(s1.opt.nu), "mu_placements": mu_pl,
            "param_placements": {k: tuple(str(p) for p in v.placements)
                                 for k, v in f2.items()},
            "step": (int(s1.step), int(s2.step.full_tensor())),
            "microbatched": {k: (float(m1b[k]), float(m2b[k]))
                             for k in ("loss", "grad_norm")}}


def sharded_decode(mesh):
    """Three decode steps of granite's 2-layer smoke config with the
    caches placed by ``launch.specs.cache_specs`` (their sequence split
    over ``model``: the split write and flash-decoding), against the
    plain steps; the largest logit difference over the largest |logit|,
    and whether the caches hold the same values."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import (NamedSharding, P, distribute,
                                             make_shardings)
    from repro_torch.models import transformer as tf

    cfg = _granite()
    params = tf.init_transformer(cfg, torch.Generator().manual_seed(5),
                                 "cpu")
    b, s = 4, 16
    cache = tf.init_decode_cache(cfg, b, s, device="cpu")
    rules = specs.cache_specs(cfg, ShapeSpec("decode", s, b, "decode"),
                              mesh)
    placed_cache = {k: distribute(v.clone(), NamedSharding(mesh,
                                                           rules[k].spec))
                    for k, v in cache.items()}
    placed = _placed(cfg, params, mesh, 2)
    sh = make_shardings(mesh)
    tokens = _batch(cfg, seed=5, shape=(b, 3))["tokens"]
    worst = 0.0
    with torch.no_grad():
        for t in range(3):
            tok = tokens[:, t:t + 1]
            want, cache = tf.decode_step(cfg, params, cache, tok)
            with use_mesh(mesh):
                got, placed_cache = tf.decode_step(
                    cfg, placed, placed_cache,
                    distribute(tok, NamedSharding(mesh, P("data", None))),
                    sh)
            got = got.full_tensor()
            worst = max(worst, float((got - want).abs().max()
                                     / want.abs().max()))
    same = all(torch.allclose(placed_cache[k].full_tensor(), cache[k],
                              rtol=1e-5, atol=1e-6) for k in cache)
    return {"rel": worst, "caches": same,
            "split": str(rules["k"].spec)}


def _moe_case(arch, mesh, capacity_factor=None):
    """``moe_ffn_shard_map`` on a DTensor x against ``moe_ffn`` on the full
    x, on the first MoE layer of ``arch``'s 2-layer smoke config."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import mesh_sizes, use_mesh
    from repro_torch.launch.sharding import (NamedSharding, P, distribute,
                                             make_shardings)
    from repro_torch.models import ffn
    from repro_torch.models import transformer as tf

    base = smoke_config(arch)
    moe = base.moe if capacity_factor is None else dataclasses.replace(
        base.moe, capacity_factor=capacity_factor)
    cfg = dataclasses.replace(base, n_layers=2, moe=moe)
    params = tf.init_transformer(cfg, torch.Generator().manual_seed(2),
                                 "cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 32, cfg.d_model))
                         .astype(np.float32))
    lp = tf.layer_params(params, 0)["ffn"]
    sh = make_shardings(mesh)
    placed = _placed(cfg, params, mesh, mesh_sizes(mesh)["model"])
    lps = tf.layer_params(placed, 0)["ffn"]
    xs = distribute(x, NamedSharding(mesh, P("data", None, None)))
    out = {}
    # the routed experts alone (the shard_map's own part), then with the
    # shared experts, whose SwiGLU is tensor-parallel (partial sums)
    for name, shared in (("routed", None), ("full", lp.shared)):
        want, aux = ffn.moe_ffn(lp._replace(shared=shared), x, cfg.moe)
        with use_mesh(mesh):
            got, aux_s = ffn.moe_ffn_shard_map(
                lps._replace(shared=None if shared is None else lps.shared),
                xs, cfg.moe, sh)
        out[name] = {"want": want, "got": got.full_tensor(),
                     "aux": (float(aux), float(aux_s.full_tensor()))}
    return out


def moe_forward(mesh):
    """llama4-scout's 2-layer smoke ``forward_hidden`` with
    ``moe.impl="shard_map"`` on the (2, 2) mesh against the unsharded
    forward (the reference test's comparison)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.launch.sharding import make_shardings
    from repro_torch.models import transformer as tf

    base = smoke_config("llama4-scout-17b-a16e")
    moe = dataclasses.replace(base.moe, capacity_factor=1000.0)
    cfg_g = dataclasses.replace(base, n_layers=2, moe=moe)
    cfg_s = dataclasses.replace(cfg_g, moe=dataclasses.replace(
        moe, impl="shard_map"))
    params = tf.init_transformer(cfg_g, torch.Generator().manual_seed(3),
                                 "cpu")
    tokens = _batch(cfg_g, seed=3)["tokens"]
    hg, _ = tf.forward_hidden(cfg_g, params, tokens)
    with use_mesh(mesh):
        hs, _ = tf.forward_hidden(cfg_s, _placed(cfg_g, params, mesh, 2),
                                  _on_data({"t": tokens}, mesh)["t"],
                                  make_shardings(mesh))
    return {"want": hg, "got": hs.full_tensor()}


def unit_mesh_forward(rank):
    """DeepSeek-V2-Lite's 2-layer smoke ``forward_hidden`` with
    ``moe.impl="shard_map"`` on a (1, 1) mesh of this rank alone against
    the plain forward (the card's world-size-1 check)."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch.mesh import compat_make_mesh, use_mesh
    from repro_torch.launch.sharding import make_shardings
    from repro_torch.models import transformer as tf

    base = smoke_config("deepseek-v2-lite-16b")
    cfg_g = dataclasses.replace(base, n_layers=2)
    cfg_s = dataclasses.replace(cfg_g, moe=dataclasses.replace(
        base.moe, impl="shard_map"))
    params = tf.init_transformer(cfg_g, torch.Generator().manual_seed(4),
                                 "cpu")
    tokens = _batch(cfg_g, seed=4)["tokens"]
    hg, _ = tf.forward_hidden(cfg_g, params, tokens)
    mesh = compat_make_mesh((1, 1), ("data", "model"), devices=[rank],
                            device_type="cpu")
    with use_mesh(mesh):
        hs, _ = tf.forward_hidden(cfg_s, _placed(cfg_g, params, mesh, 1),
                                  _on_data({"t": tokens}, mesh)["t"],
                                  make_shardings(mesh))
    return {"want": hg, "got": hs.full_tensor()}


def psum(rows, mesh):
    """``compressed_psum`` of this rank's row over the 4-rank data mesh."""
    from repro_torch.launch.mesh import use_mesh
    from repro_torch.optim import compressed_psum

    r = mesh.get_local_rank("data")
    with use_mesh(mesh):
        return compressed_psum(torch.from_numpy(rows[r]), "data")


def pipeline(mesh):
    """A 4-stage pipe of tanh(h @ w) over 8 microbatches, and the stages
    applied one after another to each microbatch."""
    from repro_torch.launch.pipeline import pipeline_apply

    rng = np.random.default_rng(0)
    ws = torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32)
                          * 0.3)
    x = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    out = pipeline_apply(mesh, ws, x, stage_fn, n_microbatches=8)
    seq = []
    for i in range(8):
        h = x[i]
        for s in range(4):
            h = stage_fn(ws[s], h)
        seq.append(h)
    batched = x
    for s in range(4):
        batched = stage_fn(ws[s], batched)
    return {"out": out, "seq": torch.stack(seq), "batched": batched}


def elastic_checkpoint(mesh4, sub2, directory):
    """Save a tree whose ``w`` is split over a 4-rank data mesh; restore it
    onto a 2-rank mesh split the other way."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.launch.sharding import NamedSharding, P, distribute

    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8) / 7.0,
            "b": torch.ones(8)}
    tree4 = {"w": distribute(tree["w"], NamedSharding(mesh4, P("data",
                                                               None))),
             "b": tree["b"]}
    save_checkpoint(directory, 1, tree4)
    restored = restore_checkpoint(
        directory, 1, tree,
        shardings={"w": NamedSharding(sub2, P(None, "data")), "b": None})
    w = restored["w"]
    return {"full": w.full_tensor(), "local_shape": tuple(w.to_local().shape),
            "mesh_size": w.device_mesh.size(), "b": restored["b"],
            "want": tree["w"]}


def dtensor_refusals(mesh):
    """What each kernel wrapper does with a DTensor: the message of the
    ``TypeError`` it raised, or None."""
    from repro_torch.kernels import ops
    from repro_torch.launch.sharding import NamedSharding, P, distribute

    def dt(x, spec):
        return distribute(x, NamedSharding(mesh, spec))

    q = dt(torch.randn(4, 16, 8), P("data", None, None))
    x = dt(torch.randn(8, 4), P(None, None))
    idx = dt(torch.zeros(4, dtype=torch.int32), P(None))
    calls = {
        "flash_attention_masked": lambda: ops.flash_attention_masked(q, q, q),
        "flash_attention_fused": lambda: ops.flash_attention_fused(q, q, q),
        "gather_rows": lambda: ops.gather_rows(x, idx),
        "aia_ranged_gather": lambda: ops.aia_ranged_gather(x, idx, 2),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def main(rank, world, store_path, out_dir, psum_rows):
    torch.manual_seed(0)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.launch.mesh import make_test_mesh

        mesh22 = make_test_mesh((2, 2), device_type="cpu")
        mesh14 = make_test_mesh((1, 4), device_type="cpu")
        data4 = make_test_mesh((4,), ("data",), device_type="cpu")
        pipe4 = make_test_mesh((4,), ("pipe",), device_type="cpu")
        torch.set_num_threads(1)
        out = {
            "loss": sharded_loss(mesh22),
            "step": sharded_step(mesh22),
            "decode": sharded_decode(mesh22),
            "moe_llama4": _moe_case("llama4-scout-17b-a16e", mesh22, 1000.0),
            "moe_deepseek": _moe_case("deepseek-v2-lite-16b", mesh14),
            "moe_forward": moe_forward(mesh22),
            "unit_mesh": unit_mesh_forward(rank),
            "psum": psum(psum_rows, data4),
            "pipeline": pipeline(pipe4),
            "refusals": dtensor_refusals(mesh22),
        }
        ckpt_dir = os.path.join(out_dir, "ckpt")
        out["ckpt"] = elastic_checkpoint(data4, mesh22["data"], ckpt_dir)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
