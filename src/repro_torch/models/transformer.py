"""Decoder backbone: the port of the JAX package's models/transformer.py
for every block kind: ``attn``, ``local``, ``mamba`` (Mamba2,
models/ssm.py), ``shared_attn`` (Zamba2's weight-tied full-attention
block), ``cross`` (self attention, then tanh-gated cross attention over
the batch's ``image_embeds`` (B, n_patches, D)), and the port's own
single-mixer kinds ``attn_only`` and ``moe`` (Nemotron-H; models/config.py);
mixtures of experts (models/moe.py) in place of the MLP where
``cfg.use_moe``; audio codebooks
(musicgen: summed per-codebook embeddings of (B, n_cb, S) tokens,
per-codebook logits (B, S, n_cb·V)).

Params keep the reference's tree: the layer stack is ``n_super``
superblocks (one repetition of cfg.pattern) whose params are stacked on a
leading axis under ``params["blocks"]["pos{i}"]``, plus an unrolled
remainder of ``n_layers % period`` leading pattern positions under
``params["rem"]``; ``shared_attn`` positions hold no params of their own
and all read ``params["shared_attn"]``.  ``lax.scan`` over the stack
becomes a Python loop; with ``cfg.remat`` each superblock of ``forward``
runs under ``torch.utils.checkpoint`` when autograd records it (the
reference's ``jax.checkpoint``), except under a ``torch.func`` transform,
whose ``grad`` cannot run checkpoint's saved-tensor hooks: the vectorized
executor's ``vmap(grad_and_value(...))`` does not remat.  As in the
reference, a ``cross`` block skips its cross attention when the batch
holds no ``image_embeds``, and its prefill then leaves the cache without
the ``ck``/``cv`` that decode reads.  A stack of the port's single-mixer
kinds (``cfg.single_mixer``) remats each block on its own, and with
``cfg.ce_chunk`` the loss runs the head and the CE in chunks of tokens
(``layers.chunked_cross_entropy``).  Prefill and decode do not take the
``attn_only`` and ``moe`` kinds.

Entry points:
  init_params(cfg, gen)                        → params
  forward(cfg, params, batch)                  → logits           (eval)
  prefill(cfg, params, batch)                  → (logits, cache)  (prefill)
  decode_step(cfg, params, cache, tokens, pos) → (logits, cache)  (decode)
  init_cache(cfg, batch_size, context_len)     → cache tree
  warm_cross_caches(cfg, params, cache, feats) → cache with cross K/V
  loss_fn(cfg, params, batch)                  → mean token CE  (train)
  make_train_step(cfg)                         → (train_step, init_state)

Params live on the device of the ``torch.Generator`` that made them (or of
the tensors loaded with ``convert.params_from_numpy``); batches and caches
live beside them.  The train path also takes DTensor params and batches
(launch/sharded.py): the vocab-parallel embedding and head here, the loss
in models/layers.py, and the blocks' regions in their modules run as
``local_map`` regions over the model axis (sharding/spmd.py); the rest is
DTensor's.  ``decode_step`` writes the new token's keys and values, and
the Mamba blocks' conv windows and SSM states, into the cache tensors in
place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from .. import tracing
from ..core.flatten import tree_leaves, tree_map
from ..optim import make_optimizer
from .attention import (attn_init, cross_attention, decode_cross_attention,
                        decode_self_attention, init_cross_cache,
                        init_kv_cache, kv_to_cache, self_attention)
from .config import ArchConfig
from .layers import (chunked_cross_entropy, cross_entropy_loss, dtype_of,
                     embed_init, gated_mlp, gated_mlp_init, he_init,
                     rms_norm, softcap)
from .moe import moe_block, moe_init, moe_layer, moe_layer_init
from .ssm import init_mamba_cache, mamba_block, mamba_decode_step, mamba_init
from ..sharding.spmd import (act_in, batch_placements, model_shard, region,
                             split_on, unsharded_on, weight_in)

Pytree = Any


def _layer_positions(cfg: ArchConfig):
    return [i for i, k in enumerate(cfg.pattern) if k != "shared_attn"]


def _unstack(tree: Pytree, n: int) -> list:
    """The ``n`` superblocks of a tree stacked on its leading axis, as
    views.  Under autograd one ``unbind`` a leaf stacks the superblocks'
    grads once; indexing each superblock would add a zero-filled tensor
    of the whole stack a superblock.  A DTensor stack sharded on its
    leading axis is gathered there first."""
    parts = tree_map(lambda t: unsharded_on(t, 0).unbind(0), tree)
    return [tree_map(lambda p: p[s], parts) for s in range(n)]


def _stack(trees: list) -> Pytree:
    """Trees of equal shape stacked on a new leading axis; one tree is
    viewed with an axis of 1 (an expert stack is 32 GB at full width)."""
    if len(trees) == 1:
        return tree_map(lambda t: t[None], trees[0])
    return tree_map(lambda *xs: torch.stack(xs), *trees)


# ============================================================ param init
def _block_init(gen: torch.Generator, kind: str, cfg: ArchConfig,
                dtype, use_moe: bool = False) -> Pytree:
    D = cfg.d_model

    def zeros():
        return torch.zeros((D,), dtype=dtype, device=gen.device)

    if kind == "mamba":
        return {"ln1": zeros(), "mamba": mamba_init(gen, cfg, dtype)}
    if kind == "attn_only":
        return {"ln1": zeros(), "attn": attn_init(gen, cfg, dtype)}
    if kind == "moe":
        return {"ln1": zeros(), "moe": moe_layer_init(gen, cfg, dtype)}
    p = {"ln1": zeros(), "attn": attn_init(gen, cfg, dtype), "ln2": zeros()}
    if use_moe and kind in ("attn", "local", "cross"):
        p["moe"] = moe_init(gen, cfg, dtype)
    else:
        p["mlp"] = gated_mlp_init(gen, D, cfg.d_ff, dtype)
    if kind == "cross":
        p["lnx"] = zeros()
        p["xattn"] = attn_init(gen, cfg, dtype)
        p["xgate"] = torch.zeros((1,), dtype=torch.float32,
                                 device=gen.device)
    return p


def _placed(place, tree: Pytree, path: Tuple[str, ...],
            lead: Tuple[int, ...] = ()) -> Pytree:
    """``place(path, leaf, lead)`` of each leaf of ``tree`` (a dict of
    leaves, or a leaf) under ``path``; ``place`` None keeps the tree."""
    if place is None:
        return tree
    if isinstance(tree, dict):
        return {k: _placed(place, v, path + (k,), lead)
                for k, v in tree.items()}
    return place(path, tree, lead)


def init_params(cfg: ArchConfig, gen: torch.Generator,
                place=None) -> Pytree:
    """Random params from ``gen``, on ``gen``'s device, in
    ``cfg.param_dtype``, with the reference's keys and shapes.
    ``place(path, leaf, lead)``, if given, lays each leaf out (as a
    DTensor, launch/sharded.py) as soon as its block is made, before the
    next block is drawn: ``lead`` is the stack dims the leaf will sit
    under ((n_super,) in ``params["blocks"]``), and stacking keeps the
    layout; each stack is offered to ``place`` again (``lead`` empty) for
    a leaf it left as it was.  The draws and their order do not
    change."""
    dtype = dtype_of(cfg.param_dtype)
    D, V = cfg.d_model, cfg.vocab
    embed_shape = (cfg.n_codebooks, V, D) if cfg.n_codebooks else (V, D)
    params: Dict[str, Any] = {"embed": _placed(
        place, embed_init(gen, embed_shape, dtype), ("embed",))}
    blocks: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.pattern):
        if kind == "shared_attn":
            continue
        path = ("blocks", f"pos{i}")
        blocks[f"pos{i}"] = _placed(place, _stack([
            _placed(place, _block_init(gen, kind, cfg, dtype,
                                       cfg.use_moe(i)), path, (cfg.n_super,))
            for _ in range(cfg.n_super)]), path)
    params["blocks"] = blocks
    rem = {f"pos{i}": _placed(place, _block_init(gen, cfg.pattern[i], cfg,
                                                 dtype, cfg.use_moe(i)),
                              ("rem", f"pos{i}"))
           for i in _layer_positions(cfg)[:cfg.n_rem]}
    if rem:
        params["rem"] = rem
    if "shared_attn" in cfg.pattern:
        params["shared_attn"] = _placed(
            place, _block_init(gen, "attn", cfg, dtype), ("shared_attn",))
    params["final_norm"] = _placed(
        place, torch.zeros((D,), dtype=dtype, device=gen.device),
        ("final_norm",))
    if not cfg.tie_embeddings:
        params["head"] = _placed(
            place, he_init(gen, (D, V * max(1, cfg.n_codebooks)), D, dtype),
            ("head",))
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


def _gated_cross(p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                 attend) -> torch.Tensor:
    """x plus tanh(xgate) times ``attend`` of x's lnx-normed states."""
    gate = torch.tanh(p["xgate"]).to(x.dtype)
    return x + gate * attend(rms_norm(x, p["lnx"], cfg.norm_eps))


def _ffn(p: Pytree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The block's second half: x plus its MoE or MLP of the ln2-normed
    states."""
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + moe_block(p["moe"], h2, cfg)
    return x + gated_mlp(p["mlp"], h2, cfg.act)


def _apply_block(kind: str, p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor,
                 window_override: Optional[int] = None,
                 image_embeds: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    if kind == "mamba":
        return x + mamba_block(p["mamba"],
                               rms_norm(x, p["ln1"], cfg.norm_eps), cfg)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "moe":
        return x + moe_layer(p["moe"], h, cfg)
    x = x + self_attention(p["attn"], h, positions, cfg,
                           _window(kind, cfg, window_override),
                           sdpa=kind == "attn_only")
    if kind == "attn_only":
        return x
    if kind == "cross" and image_embeds is not None:
        x = _gated_cross(p, x, cfg, lambda hx: cross_attention(
            p["xattn"], hx, image_embeds, cfg))
    return _ffn(p, x, cfg)


def _superblock(params_i: Pytree, shared: Optional[Pytree], x: torch.Tensor,
                cfg: ArchConfig, positions: torch.Tensor,
                image_embeds: Optional[torch.Tensor],
                remat_blocks: bool = False) -> torch.Tensor:
    for i in range(len(cfg.pattern)):
        kind, p, window = _at(cfg, i, params_i, shared)
        if remat_blocks:
            x = checkpoint(_apply_block, kind, p, x, cfg, positions, window,
                           image_embeds, use_reentrant=False)
        else:
            x = _apply_block(kind, p, x, cfg, positions, window,
                             image_embeds)
    return x


# ============================================================ embeddings
def _embed(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
           dtype) -> torch.Tensor:
    if isinstance(params["embed"], DTensor):
        return _vocab_parallel_embed(params["embed"], tokens).to(dtype)
    if cfg.n_codebooks:
        # tokens (B, n_cb, S) → the sum of per-codebook embeddings
        embs = [params["embed"][c][tokens[:, c, :].long()]
                for c in range(cfg.n_codebooks)]
        return sum(embs).to(dtype)
    return params["embed"][tokens.long()].to(dtype)


def _vocab_parallel_embed(table: DTensor, tokens) -> DTensor:
    """The embedding lookup of DTensor ``table`` ((V, D), or (n_cb, V, D)
    with (B, n_cb, S) tokens summed over codebooks) as a ``local_map``
    region over its vocab shards on the model axis: each rank looks up the
    ids inside its shard, zero for the rest, and the rows are all-reduced
    over the axis."""
    vocab = split_on(table, table.dim() - 2)
    sharded = vocab != Replicate()
    rank, _ = model_shard(table.device_mesh)

    def local(tok, tab):
        n = tab.shape[-2]
        idx = tok.long() - rank * n if sharded else tok.long()
        inside = (idx >= 0) & (idx < n)
        idx = idx.clamp(0, n - 1)
        if tab.dim() == 3:          # codebooks: (B, n_cb, S) ids
            picked = [tab[c][idx[:, c, :]] * inside[:, c, :, None]
                      for c in range(tab.shape[0])]
            return sum(picked)
        return tab[idx] * inside[..., None]

    out = region(local, [act_in(tokens), weight_in(table, vocab)],
                 Partial() if sharded else Replicate())
    return out.redistribute(placements=batch_placements(out))


def _vocab_parallel_head(h: DTensor, weight: DTensor, tied: bool) -> DTensor:
    """``h`` (B, S, D) against the vocab-sharded ``weight`` (the untied
    head (D, V'), the tied table (V, D) or (n_cb, V, D)) as a ``local_map``
    region: each rank makes the logits of its own vocab shard, (B, S, V /
    m) or (B, S, n_cb, V / m), which stay sharded on the model axis."""
    vocab = split_on(weight, weight.dim() - 2 if tied else weight.dim() - 1)

    def local(x, w):
        w = w.to(x.dtype)
        if not tied:
            return torch.einsum("bsd,dv->bsv", x, w)
        if w.dim() == 3:
            return torch.einsum("bsd,cvd->bscv", x, w)
        return torch.einsum("bsd,vd->bsv", x, w)

    out_dim = 2 if weight.dim() == 2 else 3
    return region(local, [act_in(h), weight_in(weight, vocab)],
                  Shard(out_dim) if vocab != Replicate() else Replicate())


def _logits(cfg: ArchConfig, params: Pytree, h: torch.Tensor) -> torch.Tensor:
    if isinstance(h, DTensor):
        tied = cfg.tie_embeddings or "head" not in params
        out = _vocab_parallel_head(h, params["embed"] if tied
                                   else params["head"], tied)
        if out.dim() == 4:
            out = out.reshape(*h.shape[:2], cfg.n_codebooks * cfg.vocab)
        return softcap(out, cfg.final_logit_softcap)
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


def _image_embeds(cfg: ArchConfig,
                  batch: Dict[str, torch.Tensor]) -> Optional[torch.Tensor]:
    """The batch's vision features (B, n_patches, D) in cfg.dtype, if any."""
    feats = batch.get("image_embeds")
    return None if feats is None else feats.to(dtype_of(cfg.dtype))


# ============================================================ forward
def _under_func_transform() -> bool:
    """Whether a ``torch.func`` transform (vmap, grad, ...) is active."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def _remat(cfg: ArchConfig) -> bool:
    """Whether to remat: ``cfg.remat`` with autograd on, outside a
    ``torch.func`` transform."""
    return (cfg.remat and torch.is_grad_enabled()
            and not _under_func_transform())


def hidden(cfg: ArchConfig, params: Pytree,
           batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The final-normed hidden states (B, S, D) that ``forward``'s head
    reads (see ``forward``)."""
    tokens = batch["tokens"]
    positions = _positions(tokens)
    image_embeds = _image_embeds(cfg, batch)
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")
    remat = _remat(cfg)
    per_block = remat and cfg.single_mixer
    for params_i in _unstack(params["blocks"], cfg.n_super):
        if remat and not per_block:
            x = checkpoint(_superblock, params_i, shared, x, cfg, positions,
                           image_embeds, use_reentrant=False)
        else:
            x = _superblock(params_i, shared, x, cfg, positions,
                            image_embeds, per_block)
    for i in _layer_positions(cfg)[:cfg.n_rem]:
        x = _apply_block(cfg.pattern[i], params["rem"][f"pos{i}"], x, cfg,
                         positions, None, image_embeds)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(cfg: ArchConfig, params: Pytree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, V), or (B, S, n_cb·V) for
    codebook tokens (B, n_cb, S).  With ``cfg.remat`` and autograd on,
    each superblock (each block, in a stack of the port's single-mixer
    kinds) keeps only its input and recomputes the rest in the backward
    pass; under a ``torch.func`` transform (the vectorized executor's
    ``vmap(grad_and_value(...))``) it does not remat, since
    ``torch.func.grad`` cannot run checkpoint's saved-tensor hooks, and
    recomputation changes memory, never values.  ``batch["image_embeds"]``
    (B, n_patches, D), if given, feeds the ``cross`` blocks."""
    return _logits(cfg, params, hidden(cfg, params, batch))


# ============================================================ loss / train
def loss_fn(cfg: ArchConfig, params: Pytree,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean token cross-entropy of ``forward`` against ``batch["labels"]``
    ((B, S), or (B, n_cb, S) for codebooks), in fp32; the logsumexp form
    when ``cfg.efficient_ce`` is set, in chunks of ``cfg.ce_chunk`` tokens
    when that is set (an untied head, plain tensors)."""
    if cfg.ce_chunk:
        if cfg.tie_embeddings or cfg.n_codebooks or \
                isinstance(params["head"], DTensor):
            raise ValueError(f"{cfg.name}: ce_chunk takes an untied head of "
                             f"plain tensors and no codebooks")
        return chunked_cross_entropy(hidden(cfg, params, batch),
                                     params["head"], batch["labels"],
                                     cfg.ce_chunk, _remat(cfg))
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
    ``jax.value_and_grad`` gives them; the loss is detached.  DTensor
    params get grads with their own placements."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = loss_fn(cfg, live, batch)
        leaves = tree_leaves(live)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    # a DTensor's grad comes out laid out as its last op left it: lay it
    # out as its param
    by_leaf = {id(p): g.redistribute(p.device_mesh, p.placements)
               if isinstance(g, DTensor) else g
               for p, g in zip(leaves, grads)}
    return loss.detach(), tree_map(lambda t: by_leaf[id(t)], live)


def make_train_step(cfg: ArchConfig):
    """Returns ``(train_step, init_state)``.  ``init_state(gen, place=None)``
    → state ``{"params", "opt"}`` on ``gen``'s device (``place`` as
    ``init_params`` takes it); ``train_step(state, batch)``
    → ``(state, loss)``: one step of ``cfg.optimizer`` at
    ``cfg.learning_rate`` on ``loss_fn``'s grads, the loss a 0-d tensor on
    the device (no host sync)."""
    optimizer = make_optimizer(cfg.optimizer, cfg.learning_rate)

    def init_state(gen: torch.Generator, place=None) -> Pytree:
        params = init_params(cfg, gen, place)
        return {"params": params, "opt": optimizer.init(params)}

    def train_step(state: Pytree, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Pytree, torch.Tensor]:
        loss, grads = grads_of(cfg, state["params"], batch)
        with tracing.span("train.optimizer", step=state["opt"].get("count")):
            params, opt = optimizer.step(grads, state["opt"],
                                         state["params"])
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
    c = init_kv_cache(cfg, batch, length, dtype, device)
    if kind == "cross":
        shape = (batch, cfg.n_patches, cfg.n_kv_heads, cfg.hd)
        c["ck"] = torch.zeros(shape, dtype=dtype, device=device)
        c["cv"] = torch.zeros(shape, dtype=dtype, device=device)
    return c


def init_cache(cfg: ArchConfig, batch: int, context: int,
               dtype=torch.bfloat16, device=None) -> Pytree:
    """Zero-initialised cache tree matching decode_step's expectations."""
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


def warm_cross_caches(cfg: ArchConfig, params: Pytree, cache: Pytree,
                      image_embeds: torch.Tensor) -> Pytree:
    """Populate cross-attn K/V from vision features (before decoding): a
    new cache tree whose stacked ``cross`` blocks hold ``init_cross_cache``
    of each superblock's ``xattn`` params; other leaves are shared."""
    dtype = dtype_of(cfg.dtype)
    feats = image_embeds.to(dtype)
    blocks = dict(cache["blocks"])
    for i, kind in enumerate(cfg.pattern):
        if kind != "cross":
            continue
        per_super = [init_cross_cache(pw, feats, dtype) for pw in _unstack(
            params["blocks"][f"pos{i}"]["xattn"], cfg.n_super)]
        blocks[f"pos{i}"] = dict(blocks[f"pos{i}"], **_stack(per_super))
    return dict(cache, blocks=blocks)


# ============================================================ prefill
def _prefill_block(kind: str, p: Pytree, x: torch.Tensor, cfg: ArchConfig,
                   positions: torch.Tensor, cache_dtype, cache_len: int,
                   window_override: Optional[int] = None,
                   image_embeds: Optional[torch.Tensor] = None
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
    c = {"k": kc, "v": vc}
    if kind == "cross" and image_embeds is not None:
        x = _gated_cross(p, x, cfg, lambda hx: cross_attention(
            p["xattn"], hx, image_embeds, cfg))
        c.update(init_cross_cache(p["xattn"], image_embeds, cache_dtype))
    return _ffn(p, x, cfg), c


def prefill(cfg: ArchConfig, params: Pytree, batch: Dict[str, torch.Tensor],
            cache_len: Optional[int] = None,
            cache_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Pytree]:
    """Inference prefill: full-sequence forward that also emits the decode
    cache (KV per attention block in ring/linear layout, fp32 conv windows
    and SSM states for Mamba blocks, cross-attn K/V for VLM blocks from
    ``batch["image_embeds"]``)."""
    tokens = batch["tokens"]
    S = tokens.shape[-1]
    cache_len = cache_len or S
    positions = _positions(tokens)
    image_embeds = _image_embeds(cfg, batch)
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")

    per_super = []
    for params_i in _unstack(params["blocks"], cfg.n_super):
        new_cache = {}
        for i in range(len(cfg.pattern)):
            kind, p, window = _at(cfg, i, params_i, shared)
            x, new_cache[f"pos{i}"] = _prefill_block(
                kind, p, x, cfg, positions, cache_dtype, cache_len, window,
                image_embeds)
        per_super.append(new_cache)
    cache: Dict[str, Any] = {}
    if per_super:
        cache["blocks"] = _stack(per_super)
    rem = {}
    for i in _layer_positions(cfg)[:cfg.n_rem]:
        x, rem[f"pos{i}"] = _prefill_block(
            cfg.pattern[i], params["rem"][f"pos{i}"], x, cfg, positions,
            cache_dtype, cache_len, None, image_embeds)
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
    if kind == "cross":
        x = _gated_cross(p, x, cfg, lambda hx: decode_cross_attention(
            p["xattn"], hx, blk_cache, cfg))
    return _ffn(p, x, cfg), kv


def decode_step(cfg: ArchConfig, params: Pytree, cache: Pytree,
                tokens: torch.Tensor, pos: torch.Tensor
                ) -> Tuple[torch.Tensor, Pytree]:
    """One decode step. tokens: (B, 1) (codebooks: (B, n_cb, 1)); pos:
    (B,).  The cache's tensors are updated in place; the same tree is
    returned.  A ``cross`` block reads its K/V from the cache's ``ck``/``cv``
    (prefill with ``image_embeds``, or ``warm_cross_caches``)."""
    x = _embed(cfg, params, tokens, dtype_of(cfg.dtype))
    shared = params.get("shared_attn")
    # views into the stacks: the cache is written in place
    for params_i, cache_i in zip(_unstack(params["blocks"], cfg.n_super),
                                 _unstack(cache["blocks"], cfg.n_super)):
        for i in range(len(cfg.pattern)):
            kind, p, window = _at(cfg, i, params_i, shared)
            x, _ = _decode_block(kind, p, x, cache_i[f"pos{i}"], pos, cfg,
                                 window)
    for i in _layer_positions(cfg)[:cfg.n_rem]:
        x, _ = _decode_block(cfg.pattern[i], params["rem"][f"pos{i}"], x,
                             cache["rem"][f"pos{i}"], pos, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x), cache
