"""The spec layer against the JAX package, spec for spec, on the CPU.

``models.transformer.param_specs``, ``optim.zero.zero1_state_specs`` and
all six functions of ``launch.specs`` (``batch_specs``, ``param_sds``,
``train_state_sds``, ``cache_specs``, ``decode_token_specs``,
``cell_is_runnable``) on every config at its full size, on every shape of
``SHAPE_SETS``, on both production meshes: the reference runs on a
``jax.sharding.AbstractMesh``, the port on a ``launch.mesh.AbstractMesh``
of the same names and sizes.  Every leaf's shape, dtype and spec must be
equal (a port spec is a tuple equal to ``tuple(jax_spec)``); nothing is
allocated on either side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs.base import SHAPE_SETS as REF_SHAPES
from repro.launch import specs as ref_specs
from repro.models import transformer as ref_tf
from repro.optim.zero import zero1_state_specs as ref_zero1
from repro_torch.configs import ARCH_IDS, SHAPE_SETS, get_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import AbstractMesh, production_mesh_shape
from repro_torch.launch.sharding import P
from repro_torch.models import transformer
from repro_torch.optim.zero import zero1_state_specs

MESHES = [production_mesh_shape(False), production_mesh_shape(True)]


def _ref_mesh(shape, axes):
    return jax.sharding.AbstractMesh(shape, axes)


def _path(path_tuple) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "name",
                                                  getattr(p, "idx", p))))
                    for p in path_tuple)


def _ref_flat(tree):
    """``{tree path: leaf}`` of a reference tree (a spec is a leaf)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {_path(p): x for p, x in leaves}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _same_sds(port, ref, what):
    """A port ``ShapeDtypeStruct`` equals a reference ``ShapeDtypeStruct``."""
    assert tuple(port.shape) == tuple(ref.shape), what
    assert _dtype_name(port.dtype) == str(jnp.dtype(ref.dtype)), what
    assert isinstance(port.spec, P), what
    assert port.spec == tuple(ref.sharding.spec), (what, port.spec,
                                                   ref.sharding.spec)


def _same_flat(port: dict, ref: dict, what):
    assert set(port) == set(ref), (what, sorted(set(port) ^ set(ref)))
    for k in ref:
        _same_sds(port[k], ref[k], f"{what} {k}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)
    assert [s.name for s in SHAPE_SETS] == [s.name for s in REF_SHAPES]
    for shape_axes in MESHES:
        mesh, rmesh = AbstractMesh(*shape_axes), _ref_mesh(*shape_axes)
        model_size = dict(zip(shape_axes[1], shape_axes[0]))["model"]

        # parameters: param_sds, and param_specs / zero1 on their shapes
        p_sds, p_specs = specs.param_sds(cfg, mesh)
        r_sds, r_specs = ref_specs.param_sds(rcfg, rmesh)
        _same_flat(transformer.flat_params(p_sds), _ref_flat(r_sds),
                   "param_sds")
        direct = transformer.param_specs(cfg, p_sds, model_size=model_size)
        r_direct = ref_tf.param_specs(rcfg, r_sds, model_size=model_size)
        assert transformer.flat_params(direct) == {
            k: tuple(v) for k, v in _ref_flat(r_direct).items()}
        assert transformer.flat_params(p_specs) == transformer.flat_params(
            direct)
        shapes = transformer._tree(cfg, lambda k: tuple(
            transformer.param_shapes(cfg)[k][0]))
        r_shapes = jax.tree.map(lambda s: tuple(s.shape), r_sds)
        z = zero1_state_specs(p_specs, shapes)
        rz = ref_zero1(r_specs, r_shapes)
        assert transformer.flat_params(z) == {
            k: tuple(v) for k, v in _ref_flat(rz).items()}

        # the train state: parameters, moments keyed by tree path, steps
        st = specs.train_state_sds(cfg, mesh)
        rst = ref_specs.train_state_sds(rcfg, rmesh)
        _same_sds(st.step, rst.step, "step")
        _same_sds(st.opt.step, rst.opt.step, "opt.step")
        _same_flat(transformer.flat_params(st.params), _ref_flat(rst.params),
                   "state params")
        _same_flat(st.opt.mu, _ref_flat(rst.opt.mu), "mu")
        _same_flat(st.opt.nu, _ref_flat(rst.opt.nu), "nu")

        for shape, rshape in zip(SHAPE_SETS, REF_SHAPES):
            assert specs.cell_is_runnable(cfg, shape) == \
                ref_specs.cell_is_runnable(rcfg, rshape)
            _same_flat(specs.batch_specs(cfg, shape, mesh),
                       ref_specs.batch_specs(rcfg, rshape, rmesh), "batch")
            _same_sds(specs.decode_token_specs(cfg, shape, mesh),
                      ref_specs.decode_token_specs(rcfg, rshape, rmesh),
                      "decode tokens")
            _same_flat(specs.cache_specs(cfg, shape, mesh),
                       ref_specs.cache_specs(rcfg, rshape, rmesh), "cache")


def test_param_shapes_allocate_nothing_and_match_init():
    """``param_shapes`` (the fake-tensor trace of ``init_transformer``)
    equals a real init's shapes and dtypes at the smoke size."""
    from repro_torch.configs import smoke_config

    for arch in ("granite-3-2b", "deepseek-v2-lite-16b", "zamba2-1.2b",
                 "rwkv6-1.6b", "whisper-large-v3"):
        cfg = smoke_config(arch)
        real = transformer.flat_params(transformer.init_transformer(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        assert transformer.param_shapes(cfg) == {
            k: (tuple(t.shape), t.dtype) for k, t in real.items()}
        sds = specs.param_sds(cfg, AbstractMesh((1, 2), ("data", "model")))[0]
        assert all(s.meta().device.type == "meta"
                   for s in transformer.flat_params(sds).values())


def test_smoke_param_specs_on_a_small_model_dim():
    """``param_specs`` at ``model_size=2`` on granite's 2-layer smoke config
    (the sharded tests' placement) equals the reference's on its params."""
    import dataclasses
    from repro.configs import smoke_config as ref_smoke
    from repro_torch.configs import smoke_config

    cfg = dataclasses.replace(smoke_config("granite-3-2b"), n_layers=2)
    rcfg = dataclasses.replace(ref_smoke("granite-3-2b"), n_layers=2)
    rparams = jax.eval_shape(lambda k: ref_tf.init_transformer(rcfg, k)[0],
                             jax.random.PRNGKey(0))
    ref = _ref_flat(ref_tf.param_specs(rcfg, rparams, model_size=2))
    params = transformer.init_transformer(
        cfg, torch.Generator().manual_seed(0), "cpu")
    port = transformer.flat_params(
        transformer.param_specs(cfg, params, model_size=2))
    assert port == {k: tuple(v) for k, v in ref.items()}
    assert len(port) == 12
    np.testing.assert_equal(sorted(port), sorted(ref))
