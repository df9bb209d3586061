"""The port's large-model sharding rules against the JAX package's.

For every config, every input shape of configs/shapes.py, the production
meshes (single and multi pod), a 2 × 2 and a 1 × 1 mesh, and the four
distinct ``ShardingOptions`` of the dry run's variants: every param,
optimizer, batch, cache and logits spec of the port equals the
reference's ``PartitionSpec``, the reference on
``jax.sharding.AbstractMesh`` over ``jax.eval_shape``'d trees, the port on
fake tensors (launch/specs.py).  Both sides see the same shapes; the
specs are pure functions of key paths, shapes and mesh axis sizes.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.launch import specs as jax_specs
from repro.launch.variants import VARIANTS as JAX_VARIANTS
from repro.models import init_cache as jax_init_cache
from repro.models import make_train_step as jax_make_train_step
from repro.sharding import rules as jax_rules
from repro_torch.configs import (INPUT_SHAPES, PORT_ONLY, get_config,
                                 list_architectures)
from repro_torch.launch import specs
from repro_torch.launch.mesh import (AbstractMesh as TorchAbstractMesh,
                                     make_host_mesh, make_production_mesh)
from repro_torch.launch.variants import VARIANTS
from repro_torch.models import init_cache, make_train_step
from repro_torch.sharding import (PartitionSpec, batch_specs, cache_specs,
                                  logits_spec, opt_specs, param_specs,
                                  shard_shape)
from repro_torch.sharding.rules import leaves_with_path

# (port mesh, reference mesh) pairs
MESHES = {
    "single": (lambda: make_production_mesh(),
               lambda: AbstractMesh((16, 16), ("data", "model"))),
    "multi": (lambda: make_production_mesh(multi_pod=True),
              lambda: AbstractMesh((2, 16, 16), ("pod", "data", "model"))),
    "2x2": (lambda: TorchAbstractMesh((("data", 2), ("model", 2))),
            lambda: AbstractMesh((2, 2), ("data", "model"))),
    "1x1": (lambda: make_host_mesh(device="cpu"),
            lambda: AbstractMesh((1, 1), ("data", "model"))),
}


def _distinct_options(variants):
    seen = []
    for v in variants.values():
        if v.sharding not in seen:
            seen.append(v.sharding)
    return seen


def _jax_flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxP))
    return {tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            tuple(spec) for path, spec in flat}


def _port_flat(tree) -> dict:
    return {path: tuple(spec) for path, spec in leaves_with_path(tree)}


def _fake(fn):
    """``fn(generator)`` under a fresh fake mode: shapes without data."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    with FakeTensorMode(shape_env=ShapeEnv()):
        return fn(torch.Generator().manual_seed(0))


def test_variants_use_four_distinct_sharding_options():
    opts = _distinct_options(VARIANTS)
    assert len(opts) == 4
    assert [vars(o) for o in opts] == [
        vars(o) for o in _distinct_options(JAX_VARIANTS)]


@pytest.mark.parametrize("arch", [a for a in list_architectures()
                                  if a not in PORT_ONLY])
def test_every_spec_equals_the_reference(arch):
    options = _distinct_options(VARIANTS)
    jax_options = _distinct_options(JAX_VARIANTS)
    checked = 0
    for cfg_kind in ("base", "long"):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        if cfg_kind == "long":
            if not cfg.supports_long_context:
                continue
            cfg, jcfg = cfg.long_context(), jcfg.long_context()
        state = _fake(make_train_step(cfg)[1])
        jstate = jax.eval_shape(
            lambda: jax_make_train_step(jcfg)[1](jax.random.PRNGKey(0)))
        for mesh_name, (port_mesh, ref_mesh) in MESHES.items():
            mesh, jmesh = port_mesh(), ref_mesh()
            for opts, jopts in zip(options, jax_options):
                p = param_specs(state["params"], mesh, opts)
                jp = jax_rules.param_specs(jstate["params"], jmesh, jopts)
                assert _port_flat(p) == _jax_flat(jp), (mesh_name, opts)
                assert _port_flat(opt_specs(state["opt"], p, mesh, opts)) \
                    == _jax_flat(jax_rules.opt_specs(
                        jstate["opt"], jp, jmesh, jopts)), (mesh_name, opts)
                checked += 1
    assert checked >= 16

    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        if name == "long_500k" and not cfg.supports_long_context:
            continue                    # the dry run skips the pair
        rcfg = specs.resolve_config(cfg, shape)
        jrcfg = jax_specs.resolve_config(jcfg, JAX_SHAPES[name])
        B, S = shape.global_batch, shape.seq_len
        cache = _fake(lambda gen: init_cache(rcfg, B, S, torch.bfloat16,
                                             gen.device))
        jcache = jax.eval_shape(lambda: jax_init_cache(jrcfg, B, S,
                                                       jnp.bfloat16))
        if shape.kind == "decode":
            _, tokens, pos = _fake(
                lambda gen: specs.decode_input_specs(rcfg, shape, gen))
            _, jtokens, jpos = jax_specs.decode_input_specs(
                jrcfg, JAX_SHAPES[name])
            batch, jbatch = {"tokens": tokens, "pos": pos}, \
                {"tokens": jtokens, "pos": jpos}
            out_len = 1
        else:
            batch = _fake(lambda gen: specs.input_specs(rcfg, shape, gen))
            jbatch = jax_specs.input_specs(jrcfg, JAX_SHAPES[name])
            out_len = S
        V = cfg.vocab * max(1, cfg.n_codebooks)
        logits = torch.empty((B, out_len, V), device="meta")
        jlogits = jax.ShapeDtypeStruct((B, out_len, V), jnp.float32)
        for mesh_name, (port_mesh, ref_mesh) in MESHES.items():
            mesh, jmesh = port_mesh(), ref_mesh()
            where = (name, mesh_name)
            for opts, jopts in zip(options, jax_options):
                assert _port_flat(batch_specs(batch, mesh, opts)) == \
                    _jax_flat(jax_rules.batch_specs(jbatch, jmesh, jopts)), \
                    (where, opts)
                assert _port_flat(cache_specs(cache, mesh, opts)) == \
                    _jax_flat(jax_rules.cache_specs(jcache, jmesh, jopts)), \
                    (where, opts)
            assert tuple(specs._logits_struct_spec(logits, mesh)) == \
                tuple(jax_specs._logits_struct_spec(jlogits, jmesh)), where
            assert tuple(logits_spec(mesh)) == \
                tuple(jax_rules.logits_spec(jmesh)), where


def test_shard_shape_divides_the_sharded_dims():
    mesh = make_production_mesh(multi_pod=True)
    assert shard_shape((64, 4096, 48), PartitionSpec(
        ("pod", "data"), None, "model"), mesh) == (2, 4096, 3)
    assert shard_shape((5, 7), PartitionSpec(None, None), mesh) == (5, 7)
    assert shard_shape((17,), PartitionSpec("model"), mesh) == (2,)
    assert PartitionSpec("data", None) == ("data", None)
