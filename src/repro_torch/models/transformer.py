"""Decoder backbone: the port of the JAX package's models/transformer.py
for the block kinds ``attn``, ``local``, ``mamba`` (Mamba2, models/ssm.py)
and ``shared_attn`` (Zamba2's weight-tied full-attention block), with
audio codebooks (musicgen: summed per-codebook embeddings of (B, n_cb, S)
tokens, per-codebook logits (B, S, n_cb·V)).

Params keep the reference's tree: the layer stack is ``n_super``
superblocks (one repetition of cfg.pattern) whose params are stacked on a
leading axis under ``params["blocks"]["pos{i}"]``, plus an unrolled
remainder of ``n_layers % period`` leading pattern positions under
``params["rem"]``; ``shared_attn`` positions hold no params of their own
and all read ``params["shared_attn"]``.  ``lax.scan`` over the stack
becomes a Python loop; with ``cfg.remat`` each superblock of ``forward``
runs under ``torch.utils.checkpoint`` when autograd records it (the
reference's ``jax.checkpoint``).  Block kind ``cross`` and mixtures of
experts are not ported yet (ROADMAP Queue 1.9): every entry point raises
``NotImplementedError`` for such a config.

Entry points:
  init_params(cfg, gen)                        → params
  forward(cfg, params, batch)                  → logits           (eval)
  prefill(cfg, params, batch)                  → (logits, cache)  (prefill)
  decode_step(cfg, params, cache, tokens, pos) → (logits, cache)  (decode)
  init_cache(cfg, batch_size, context_len)     → cache tree
  loss_fn(cfg, params, batch)                  → mean token CE  (train)
  make_train_step(cfg)                         → (train_step, init_state)

Params live on the device of the ``torch.Generator`` that made them (or of
the tensors loaded with ``convert.params_from_numpy``); batches and caches
live beside them.  ``decode_step`` writes the new token's keys and values,
and the Mamba blocks' conv windows and SSM states, into the cache tensors
in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.flatten import tree_leaves, tree_map
from ..optim import apply_updates, make_optimizer
from .attention import (attn_init, decode_self_attention, init_kv_cache,
                        kv_to_cache, self_attention)
from .config import ArchConfig
from .layers import (cross_entropy_loss, dtype_of, embed_init, gated_mlp,
                     gated_mlp_init, he_init, rms_norm, softcap)
from .ssm import init_mamba_cache, mamba_block, mamba_decode_step, mamba_init

Pytree = Any

PORTED_KINDS = ("attn", "local", "mamba", "shared_attn")


def _check_ported(cfg: ArchConfig) -> None:
    """Raise for a config that needs a block kind or feature the port does
    not have yet."""
    missing = sorted(set(cfg.pattern) - set(PORTED_KINDS))
    if cfg.n_experts > 0:
        missing.append("moe")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to the PyTorch "
            f"package yet (ROADMAP Queue 1.9); ported block kinds: "
            f"{', '.join(PORTED_KINDS)}")


def _layer_positions(cfg: ArchConfig):
    return [i for i, k in enumerate(cfg.pattern) if k != "shared_attn"]


def _unstack(tree: Pytree, n: int) -> list:
    """The ``n`` superblocks of a tree stacked on its leading axis, as
    views.  Under autograd one ``unbind`` a leaf stacks the superblocks'
    grads once; indexing each superblock would add a zero-filled tensor
    of the whole stack a superblock."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda p: p[s], parts) for s in range(n)]


# ============================================================ param init
def _block_init(gen: torch.Generator, kind: str, cfg: ArchConfig,
                dtype) -> Pytree:
    D = cfg.d_model
    if kind == "mamba":
        return {"ln1": torch.zeros((D,), dtype=dtype, device=gen.device),
                "mamba": mamba_init(gen, cfg, dtype)}
    return {"ln1": torch.zeros((D,), dtype=dtype, device=gen.device),
            "attn": attn_init(gen, cfg, dtype),
            "ln2": torch.zeros((D,), dtype=dtype, device=gen.device),
            "mlp": gated_mlp_init(gen, D, cfg.d_ff, dtype)}


def init_params(cfg: ArchConfig, gen: torch.Generator) -> Pytree:
    """Random params from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype``, with the reference's keys and shapes."""
    _check_ported(cfg)
    dtype = dtype_of(cfg.param_dtype)
    D, V = cfg.d_model, cfg.vocab
    embed_shape = (cfg.n_codebooks, V, D) if cfg.n_codebooks else (V, D)
    params: Dict[str, Any] = {"embed": embed_init(gen, embed_shape, dtype)}
    blocks: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "shared_attn":
            continue
        stack = [_block_init(gen, kind, cfg, dtype)
                 for _ in range(cfg.n_super)]
        blocks[f"pos{i}"] = tree_map(lambda *xs: torch.stack(xs), *stack)
    params["blocks"] = blocks
    positions = _layer_positions(cfg)
    rem = {f"pos{positions[j]}": _block_init(gen, cfg.pattern[positions[j]],
                                             cfg, dtype)
           for j in range(cfg.n_rem)}
    if rem:
        params["rem"] = rem
    if "shared_attn" in cfg.pattern:
        params["shared_attn"] = _block_init(gen, "attn", cfg, dtype)
    params["final_norm"] = torch.zeros((D,), dtype=dtype, device=gen.device)
    if not cfg.tie_embeddings:
        params["head"] = he_init(gen, (D, V * max(1, cfg.n_codebooks)), D,
                                 dtype)
    return params


# ============================================================ block fwd
def _window(kind: str, cfg: ArchConfig,
            window_override: Optional[int] = None) -> Optional[int]:
    return cfg.window if kind == "local" else window_override


def _at(cfg: ArchConfig, i: int, params_i: Pytree,
        shared: Optional[Pytree]) -> Tuple[str, Pytree, Optional[int]]:
    """Pattern position i's block kind, params and window override: a
    ``shared_attn`` position is an ``attn`` block on the weight-tied
    params, windowed only when .long_context() set one."""
    if cfg.pattern[i] == "shared_attn":
        return "attn", shared, cfg.shared_attn_window or None
    return cfg.pattern[i], params_i[f"pos{i}"], None


def _apply_block(kind: str, p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor,
                 window_override: Optional[int] = None) -> torch.Tensor:
    if kind == "mamba":
        return x + mamba_block(p["mamba"],
                               rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + self_attention(p["attn"], h, positions, cfg,
                           _window(kind, cfg, window_override))
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h2, cfg.act)


def _superblock(params_i: Pytree, shared: Optional[Pytree], x: torch.Tensor,
                cfg: ArchConfig, positions: torch.Tensor) -> torch.Tensor:
    for i in range(len(cfg.pattern)):
        kind, p, window = _at(cfg, i, params_i, shared)
        x = _apply_block(kind, p, x, cfg, positions, window)
    return x


# ============================================================ embeddings
def _embed(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
           dtype) -> torch.Tensor:
    if cfg.n_codebooks:
        # tokens (B, n_cb, S) → the sum of per-codebook embeddings
        embs = [params["embed"][c][tokens[:, c, :].long()]
                for c in range(cfg.n_codebooks)]
        return sum(embs).to(dtype)
    return params["embed"][tokens.long()].to(dtype)


def _logits(cfg: ArchConfig, params: Pytree, h: torch.Tensor) -> torch.Tensor:
    if not cfg.tie_embeddings and "head" in params:
        out = torch.einsum("bsd,dv->bsv", h, params["head"].to(h.dtype))
    elif cfg.n_codebooks:
        out = torch.einsum("bsd,cvd->bscv", h, params["embed"].to(h.dtype))
        out = out.reshape(*h.shape[:2], cfg.n_codebooks * cfg.vocab)
    else:
        out = torch.einsum("bsd,vd->bsv", h, params["embed"].to(h.dtype))
    return softcap(out, cfg.final_logit_softcap)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    """Positions 0..S-1 of (B, S) tokens, or (B, n_cb, S) codebook tokens."""
    B, S = tokens.shape[0], tokens.shape[-1]
    return torch.arange(S, device=tokens.device)[None, :].expand(B, S)


# ============================================================ forward
def forward(cfg: ArchConfig, params: Pytree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V), or (B, S, n_cb·V) for
    codebook tokens (B, n_cb, S).  With ``cfg.remat`` and autograd on,
    each superblock keeps only its input and recomputes the rest in the
    backward pass."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")
    remat = cfg.remat and torch.is_grad_enabled()
    for params_i in _unstack(params["blocks"], cfg.n_super):
        if remat:
            x = checkpoint(_superblock, params_i, shared, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _superblock(params_i, shared, x, cfg, positions)
    positions_rem = _layer_positions(cfg)
    for j in range(cfg.n_rem):
        i = positions_rem[j]
        x = _apply_block(cfg.pattern[i], params["rem"][f"pos{i}"], x, cfg,
                         positions)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x)


# ============================================================ loss / train
def loss_fn(cfg: ArchConfig, params: Pytree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean token cross-entropy of ``forward`` against ``batch["labels"]``
    ((B, S), or (B, n_cb, S) for codebooks), in fp32; the logsumexp form
    when ``cfg.efficient_ce`` is set."""
    logits = forward(cfg, params, batch)
    labels = batch["labels"]
    if cfg.n_codebooks:
        B, S = labels.shape[0], labels.shape[-1]
        logits = logits.reshape(B, S, cfg.n_codebooks, cfg.vocab)
        logits = logits.transpose(1, 2)               # (B, n_cb, S, V)
    return cross_entropy_loss(
        logits, labels,
        impl="logsumexp" if cfg.efficient_ce else "logsoftmax")


def grads_of(cfg: ArchConfig, params: Pytree,
             batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Pytree]:
    """``(loss, grads)`` of ``loss_fn`` at ``params``, the grads a tree
    shaped like it (zeros for a param the loss does not reach), as
    ``jax.value_and_grad`` gives them; the loss is detached."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    by_leaf = dict(zip(map(id, leaves), grads))
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], live)


def make_train_step(cfg: ArchConfig):
    """Returns ``(train_step, init_state)``.  ``init_state(gen)`` → state
    ``{"params", "opt"}`` on ``gen``'s device; ``train_step(state, batch)``
    → ``(state, loss)``: one step of ``cfg.optimizer`` at
    ``cfg.learning_rate`` on ``loss_fn``'s grads, the loss a 0-d tensor on
    the device (no host sync)."""
    optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate)

    def init_state(gen: torch.Generator) -> Pytree:
        params = init_params(cfg, gen)
        return {"params": params, "opt": optimizer.init(params)}

    def train_step(state: Pytree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Pytree, torch.Tensor]:
        loss, grads = grads_of(cfg, state["params"], batch)
        updates, opt = optimizer.update(grads, state["opt"], state["params"])
        params = apply_updates(state["params"], updates)
        return {"params": params, "opt": opt}, loss

    return train_step, init_state


# ============================================================ caches
def _block_cache(kind: str, cfg: ArchConfig, batch: int, context: int,
                 dtype=torch.bfloat16, device=None) -> Pytree:
    if kind == "mamba":
        return init_mamba_cache(cfg, batch, torch.float32, device)
    if kind == "local":
        length = min(cfg.window, context)
    elif kind == "shared_attn" and cfg.shared_attn_window:
        length = min(cfg.shared_attn_window, context)
    else:
        length = context
    return init_kv_cache(cfg, batch, length, dtype, device)


def init_cache(cfg: ArchConfig, batch: int, context: int,
               dtype=torch.bfloat16, device=None) -> Pytree:
    """Zero-initialised cache tree matching decode_step's expectations."""
    _check_ported(cfg)
    cache: Dict[str, Any] = {"blocks": {}}
    for i, kind in enumerate(cfg.pattern):
        blk = _block_cache(kind, cfg, batch, context, dtype, device)
        cache["blocks"][f"pos{i}"] = tree_map(
            lambda t: t[None].repeat((max(1, cfg.n_super),)
                                     + (1,) * t.dim()), blk)
    positions = _layer_positions(cfg)
    rem = {f"pos{positions[j]}": _block_cache(
        cfg.pattern[positions[j]], cfg, batch, context, dtype, device)
        for j in range(cfg.n_rem)}
    if rem:
        cache["rem"] = rem
    return cache


# ============================================================ prefill
def _prefill_block(kind: str, p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, cache_dtype, cache_len: int,
                   window_override: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Pytree]:
    if kind == "mamba":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, c = mamba_block(p["mamba"], h, cfg, return_cache=True)
        return x + y, c
    window = _window(kind, cfg, window_override)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, (k, v) = self_attention(p["attn"], h, positions, cfg, window,
                               return_kv=True)
    x = x + y
    kc, vc = kv_to_cache(k, v, window, cache_dtype)
    if not window and cache_len > kc.shape[2]:
        pad = (0, 0, 0, cache_len - kc.shape[2])
        kc = torch.nn.functional.pad(kc, pad)
        vc = torch.nn.functional.pad(vc, pad)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    x = x + gated_mlp(p["mlp"], h2, cfg.act)
    return x, {"k": kc, "v": vc}


def prefill(cfg: ArchConfig, params: Pytree, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Pytree]:
    """Inference prefill: full-sequence forward that also emits the decode
    cache (KV per attention block in ring/linear layout, fp32 conv windows
    and SSM states for Mamba blocks)."""
    _check_ported(cfg)
    tokens = batch["tokens"]
    S = tokens.shape[-1]
    cache_len = cache_len or S
    positions = _positions(tokens)
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")

    per_super = []
    for params_i in _unstack(params["blocks"], cfg.n_super):
        new_cache = {}
        for i in range(len(cfg.pattern)):
            kind, p, window = _at(cfg, i, params_i, shared)
            x, new_cache[f"pos{i}"] = _prefill_block(
                kind, p, x, cfg, positions, cache_dtype, cache_len, window)
        per_super.append(new_cache)
    cache: Dict[str, Any] = {}
    if per_super:
        cache["blocks"] = tree_map(lambda *xs: torch.stack(xs), *per_super)
    positions_rem = _layer_positions(cfg)
    rem = {}
    for j in range(cfg.n_rem):
        i = positions_rem[j]
        x, rem[f"pos{i}"] = _prefill_block(
            cfg.pattern[i], params["rem"][f"pos{i}"], x, cfg, positions,
            cache_dtype, cache_len)
    if rem:
        cache["rem"] = rem

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache


# ============================================================ decode
def _decode_block(kind: str, p: Pytree, x: torch.Tensor, blk_cache: Pytree,
                  pos: torch.Tensor, cfg: ArchConfig,
                  window_override: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Pytree]:
    if kind == "mamba":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, new_cache = mamba_decode_step(p["mamba"], h, blk_cache, cfg)
        return x + y, new_cache
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    y, kv = decode_self_attention(p["attn"], h, blk_cache, pos, cfg,
                                  _window(kind, cfg, window_override))
    x = x + y
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + gated_mlp(p["mlp"], h2, cfg.act), kv


def decode_step(cfg: ArchConfig, params: Pytree, cache: Pytree,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
    """One decode step. tokens: (B, 1) (codebooks: (B, n_cb, 1)); pos:
    (B,).  The cache's tensors are updated in place; the same tree is
    returned."""
    _check_ported(cfg)
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")
    # views into the stacks: the cache is written in place
    for params_i, cache_i in zip(_unstack(params["blocks"], cfg.n_super),
                                 _unstack(cache["blocks"], cfg.n_super)):
        for i in range(len(cfg.pattern)):
            kind, p, window = _at(cfg, i, params_i, shared)
            x, _ = _decode_block(kind, p, x, cache_i[f"pos{i}"], pos, cfg,
                                 window)
    positions_rem = _layer_positions(cfg)
    for j in range(cfg.n_rem):
        i = positions_rem[j]
        x, _ = _decode_block(cfg.pattern[i], params["rem"][f"pos{i}"], x,
                             cache["rem"][f"pos{i}"], pos, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
