"""The JAX package's steps for tests/test_torch_sharded_train.py.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/jax_sharded_reference.py ARCH STATE OUT \\
        [CARRIED_ARCH ...]

runs reduced ARCH's ``make_train_step`` jitted with the reference's
shardings (``param_specs`` / ``opt_specs`` / ``batch_specs``,
``repro.sharding.to_named``, ``in_shardings`` / ``out_shardings``, as
src/repro/launch/pretrain.py jits it) over a (2, 2) ("data", "model")
mesh of 4 forced host CPU devices, from the train state and batches in
the npz STATE (``state`` and ``batches|<i>``, save_pytree's keys), and
writes the step losses to OUT/jax_out.json.  The mesh is
``jax.sharding.Mesh`` (Auto axes): ``jax.make_mesh``'s Explicit axes fail
in this JAX (ROADMAP Queue 3, caveat 4).

Then, for each CARRIED_ARCH, it compiles reduced ``make_train_step``
jitted on one device for a batch of STATE's shape, waits for a line on
stdin (the port's run has written OUT/<arch>.npz by then), runs one step
from that file's ``before`` state on its ``batch``, and writes the state
after it and the loss to OUT/<arch>_jax.npz (``state``, ``loss``): the
route of tests/test_torch_pretrain.py's carried-state test, compiled while
the port's ranks run.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro.checkpoint import load_pytree, save_pytree
from repro.configs import get_config
from repro.models import make_train_step
from repro.sharding import batch_specs, opt_specs, param_specs, to_named

REMAT = ("mamba2-130m",)


def _config(arch: str):
    return get_config(arch).reduced().replace(efficient_ce=True,
                                              remat=arch in REMAT)


def sharded_losses(arch: str, state_path: str) -> list:
    """ARCH's steps over the (2, 2) mesh from STATE: the losses."""
    if len(jax.devices()) != 4:
        raise SystemExit(f"want 4 host devices, got {jax.devices()}")
    train_step, init_state = make_train_step(_config(arch))
    like = jax.tree_util.tree_map(
        np.asarray, init_state(jax.random.PRNGKey(0)))
    state = load_pytree(state_path, {"state": like})["state"]
    with np.load(state_path) as raw:
        n = len({k.split("|")[1] for k in raw if k.startswith("batches|")})
        batches = [{k: raw[f"batches|{i}|{k}"] for k in ("tokens", "labels")}
                   for i in range(n)]
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    with mesh:
        p_specs = param_specs(state["params"], mesh)
        state_sh = to_named({"params": p_specs,
                             "opt": opt_specs(state["opt"], p_specs, mesh)},
                            mesh)
        b_sh = to_named(batch_specs(
            {k: jnp.asarray(v, jnp.int32) for k, v in batches[0].items()},
            mesh), mesh)
        step = jax.jit(train_step, in_shardings=(state_sh, b_sh),
                       out_shardings=(state_sh, None))
        state = jax.device_put(state, state_sh)
        losses = []
        for b in batches:
            state, loss = step(state, {k: jnp.asarray(v, jnp.int32)
                                       for k, v in b.items()})
            losses.append(float(loss))
    return losses


def compiled_step(arch: str, batch_shape: tuple):
    """ARCH's step jitted on one device, compiled for its state and a
    (tokens, labels) batch of ``batch_shape``; and the state's structure
    (zeros) for load_pytree."""
    cfg = _config(arch)
    if cfg.n_codebooks or cfg.n_patches:
        raise SystemExit(f"{arch}: a batch of tokens and labels only")
    train_step, init_state = make_train_step(cfg)
    shapes = jax.eval_shape(init_state, jax.random.PRNGKey(0))
    batch = {k: jax.ShapeDtypeStruct(batch_shape, jnp.int32)
             for k in ("tokens", "labels")}
    like = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    return jax.jit(train_step).lower(shapes, batch).compile(), like


def main(arch: str, state_path: str, out: str, *carried: str) -> None:
    losses = sharded_losses(arch, state_path)
    with open(f"{out}/jax_out.json", "w") as f:
        json.dump({"losses": losses,
                   "devices": [str(d) for d in jax.devices()]}, f)
    with np.load(state_path) as raw:
        batch_shape = raw["batches|0|tokens"].shape
    steps = {a: compiled_step(a, batch_shape) for a in carried}
    sys.stdin.readline()
    for a, (step, like) in steps.items():
        before = load_pytree(f"{out}/{a}.npz", {"before": like})["before"]
        with np.load(f"{out}/{a}.npz") as raw:
            batch = {k: jnp.asarray(raw[f"batch|{k}"], jnp.int32)
                     for k in ("tokens", "labels")}
        state, loss = step(before, batch)
        save_pytree({"state": jax.tree_util.tree_map(np.asarray, state),
                     "loss": np.asarray(loss)}, f"{out}/{a}_jax.npz")


if __name__ == "__main__":
    main(*sys.argv[1:])
