"""Input stand-ins and step builders for the dry run.

The port of the JAX package's launch/specs.py.  There, every input is a
``jax.ShapeDtypeStruct`` and the state comes from ``jax.eval_shape`` over
the real init functions.  Here, with ``device=None``, every input and the
whole state are fake tensors (``torch._subclasses.FakeTensorMode``: shapes,
dtypes and strides, no data, no allocation), made from a CPU generator
inside one ``FakeTensorMode`` with a ``ShapeEnv`` (the MoE's kept tokens
have a data-dependent count).  The model code runs on them unchanged:
the kernel wrappers see CPU tensors and take their plain versions.  With
a device, the same builders make real tensors from a generator seeded 0
on it.

Each builder returns a ``StepSpec``: the step function, its example args,
the specs of its args (sharding/rules.py, for ``mesh``) and a function
from the step's outputs to their specs.  Nothing is compiled: the dry run
(launch/dryrun.py) runs the step once on the fake args and counts it.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from ..configs.shapes import InputShape
from ..device import DeviceLike, resolve_device
from ..models import (decode_step, init_cache, init_params, make_train_step,
                      prefill)
from ..models.config import ArchConfig
from ..sharding.rules import (DEFAULT_OPTIONS, PartitionSpec, ShardingOptions,
                              batch_specs, cache_specs, data_axes, opt_specs,
                              param_specs)

P = PartitionSpec


class StepSpec(NamedTuple):
    fn: Callable
    args: tuple
    in_specs: tuple
    out_specs: Callable[[Any], Any]      # the step's outputs → their specs


def resolve_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k runs the long-context variant (attn → sliding window)."""
    if shape.name == "long_500k":
        return cfg.long_context()
    return cfg


def _maker(device: DeviceLike):
    """(context, generator): a fresh FakeTensorMode and a CPU generator
    for ``device=None``, else no context and a generator on the device;
    both seeded 0."""
    if device is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.fx.experimental.symbolic_shapes import ShapeEnv
        mode = FakeTensorMode(shape_env=ShapeEnv())
        with mode:
            gen = torch.Generator().manual_seed(0)
        return mode, gen
    dev = resolve_device(device)
    return contextlib.nullcontext(), torch.Generator(device=dev).manual_seed(0)


def input_specs(cfg: ArchConfig, shape: InputShape,
                gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The batch of a train/prefill step, drawn from ``gen`` on its device:
    int32 tokens (and labels), bf16 image embeddings for a VLM."""
    B, S = shape.global_batch, shape.seq_len
    tok_shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)

    def tokens():
        return torch.randint(0, cfg.vocab, tok_shape, generator=gen,
                             device=gen.device, dtype=torch.int32)

    batch = {"tokens": tokens()}
    if shape.kind == "train":
        batch["labels"] = tokens()
    if cfg.n_patches:
        batch["image_embeds"] = (0.1 * torch.randn(
            (B, cfg.n_patches, cfg.d_model), generator=gen,
            device=gen.device)).to(torch.bfloat16)
    return batch


def decode_input_specs(cfg: ArchConfig, shape: InputShape,
                       gen: torch.Generator) -> Tuple:
    """(cache, tokens, pos) of a serve step: a zero bf16 cache of
    ``shape.seq_len`` positions, one int32 token a row, and every row at
    the cache's last position."""
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, torch.bfloat16, gen.device)
    tok_shape = (B, cfg.n_codebooks, 1) if cfg.n_codebooks else (B, 1)
    tokens = torch.randint(0, cfg.vocab, tok_shape, generator=gen,
                           device=gen.device, dtype=torch.int32)
    pos = torch.full((B,), S - 1, dtype=torch.int32, device=gen.device)
    return cache, tokens, pos


def _logits_struct_spec(logits: torch.Tensor, mesh) -> PartitionSpec:
    """Logits (B, S, V): batch over data axes, vocab over model when
    divisible."""
    daxes = data_axes(mesh)
    dsize = 1
    for a in daxes:
        dsize *= mesh.shape[a]
    dspec = daxes if len(daxes) > 1 else daxes[0]
    shape = tuple(logits.shape)
    spec = [None] * len(shape)
    if shape[0] % dsize == 0:
        spec[0] = dspec
    if shape[-1] % mesh.shape["model"] == 0:
        spec[-1] = "model"
    return P(*spec)


def build_train_step(cfg: ArchConfig, shape: InputShape, mesh,
                     opts: ShardingOptions = DEFAULT_OPTIONS,
                     device: DeviceLike = None) -> StepSpec:
    """``make_train_step``'s step on (state, batch)."""
    train_step, init_state = make_train_step(cfg)
    ctx, gen = _maker(device)
    with ctx:
        state = init_state(gen)
        batch = input_specs(cfg, shape, gen)
    p_specs = param_specs(state["params"], mesh, opts)
    o_specs = opt_specs(state["opt"], p_specs, mesh, opts)
    state_specs = {"params": p_specs, "opt": o_specs}
    b_specs = batch_specs(batch, mesh, opts)
    return StepSpec(train_step, (state, batch), (state_specs, b_specs),
                    lambda out: (state_specs, P()))


def build_prefill_step(cfg: ArchConfig, shape: InputShape, mesh,
                       opts: ShardingOptions = DEFAULT_OPTIONS,
                       device: DeviceLike = None) -> StepSpec:
    """``prefill`` on (params, batch) → (logits, cache)."""
    ctx, gen = _maker(device)
    with ctx:
        params = init_params(cfg, gen)
        batch = input_specs(cfg, shape, gen)

    def prefill_step(params, batch):
        return prefill(cfg, params, batch)

    return StepSpec(
        prefill_step, (params, batch),
        (param_specs(params, mesh, opts), batch_specs(batch, mesh, opts)),
        lambda out: (_logits_struct_spec(out[0], mesh),
                     cache_specs(out[1], mesh, opts)))


def build_decode_step(cfg: ArchConfig, shape: InputShape, mesh,
                      opts: ShardingOptions = DEFAULT_OPTIONS,
                      device: DeviceLike = None) -> StepSpec:
    """``decode_step`` on (params, cache, tokens, pos) → (logits, cache);
    the cache is written in place."""
    ctx, gen = _maker(device)
    with ctx:
        params = init_params(cfg, gen)
        cache, tokens, pos = decode_input_specs(cfg, shape, gen)

    def serve_step(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)

    return StepSpec(
        serve_step, (params, cache, tokens, pos),
        (param_specs(params, mesh, opts), cache_specs(cache, mesh, opts),
         batch_specs(tokens, mesh, opts), batch_specs(pos, mesh, opts)),
        lambda out: (_logits_struct_spec(out[0], mesh),
                     cache_specs(out[1], mesh, opts)))


def build_step(cfg: ArchConfig, shape: InputShape, mesh,
               opts: ShardingOptions = DEFAULT_OPTIONS,
               device: DeviceLike = None) -> StepSpec:
    cfg = resolve_config(cfg, shape)
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, opts, device)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, opts, device)
    return build_decode_step(cfg, shape, mesh, opts, device)
