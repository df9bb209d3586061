"""Serving: prefill a batch of prompts, then decode tokens from the cache
(KV for attention blocks, conv window and SSM state for Mamba blocks), on
the card.  The port of the JAX package's examples/serve_decode.py.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b --new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch gemma2-2b --pallas-attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
        --full-width --pallas-attention --prompt-len 5120 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch zamba2-1.2b --pallas-attention
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --full-width --batch 4 --prompt-len 4096 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --full-width --pallas-attention --prompt-len 4096 --new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen-medium \
        --full-width --pallas-attention --prompt-len 1024 --new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch llama-3.2-vision-11b --pallas-attention
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b --full-width --pallas-attention \
        --prompt-len 2048 --new 32

Weights are random, made from seed 0 (the prompt from seed 1).  Without
``--full-width`` the config is its ``.reduced()`` smoke variant, as in the
reference example.  Mamba blocks run their prefill scan in the
hand-written ``ssd_scan`` kernel.  A codebook model (musicgen-medium)
takes (batch, n_codebooks, prompt-len) prompts.  A VLM config
(llama-3.2-vision-11b, ``n_patches`` > 0) gets image embeddings
(batch, n_patches, d_model) of normal × 0.1 from seed 2, as the reference
example makes them.  The MoE configs (arctic-480b,
llama4-maverick-400b-a17b) serve reduced; at full width and depth their
params do not fit on one card, and the CLI does not hide that.
``--pallas-attention`` sets the config's ``use_pallas_attention``: prefill
attention (zamba2's shared block included) then runs in the hand-written
``flash_attention`` kernel.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import NamedTuple, Optional

import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.config import ArchConfig
from ..models.transformer import decode_step, init_params, prefill


class Generation(NamedTuple):
    tokens: torch.Tensor          # (B, new) generated ids
    prefill_logits: torch.Tensor  # (B, S, V) (or n_cb·V) prompt logits
    prefill_s: float              # host seconds of the prefill
    decode_s: float               # host seconds of the decode loop


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg: ArchConfig, params, prompt: torch.Tensor, new: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             cache_dtype=torch.float32,
             image_embeds: Optional[torch.Tensor] = None) -> Generation:
    """Prefill ``prompt`` (B, S), or (B, n_cb, S) codebook tokens, with the
    VLM's ``image_embeds`` (B, n_patches, D) if given, into a cache of
    S + new positions, then decode ``new`` tokens, greedily or by
    sampling at ``temperature`` (with ``generator``).  As in the reference
    example, the first decode step feeds the prompt's last token again,
    at position S, and a codebook model picks from its first codebook's
    logits and feeds the pick to every codebook.  Times are host seconds
    up to a synchronise of the prompt's device."""
    if cfg.single_mixer:
        raise ValueError(f"{cfg.name}: serving lacks the grouped Mamba2 "
                         f"decode step and the KV cache of the single-mixer "
                         f"(NoPE attention, MoE) blocks")
    B, S = prompt.shape[0], prompt.shape[-1]
    device = prompt.device
    batch = {"tokens": prompt}
    if image_embeds is not None:
        batch["image_embeds"] = image_embeds
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, params, batch, cache_len=S + new,
                            cache_dtype=cache_dtype)
    _sync(device)
    prefill_s = time.perf_counter() - t0

    tok = prompt[..., -1:]
    generated = []
    t0 = time.perf_counter()
    for i in range(new):
        pos = torch.full((B,), S + i, dtype=torch.int64, device=device)
        step_logits, cache = decode_step(cfg, params, cache, tok, pos)
        last = step_logits[:, -1, :cfg.vocab]
        if temperature > 0:
            probs = torch.softmax(last.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(last, dim=-1)
        tok = (nxt[:, None, None].expand(B, cfg.n_codebooks, 1)
               if cfg.n_codebooks else nxt[:, None])
        generated.append(nxt)
    _sync(device)
    decode_s = time.perf_counter() - t0
    return Generation(torch.stack(generated, dim=1), logits, prefill_s,
                      decode_s)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--full-width", action="store_true",
                    help="serve the published config, not .reduced()")
    ap.add_argument("--pallas-attention", action="store_true",
                    help="prefill attention in the flash_attention kernel")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_width:
        cfg = cfg.reduced()
    cfg = cfg.replace(use_pallas_attention=args.pallas_attention)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    shape = ((args.batch, cfg.n_codebooks, args.prompt_len)
             if cfg.n_codebooks else (args.batch, args.prompt_len))
    prompt = torch.randint(0, cfg.vocab, shape, generator=gen,
                           device=device)
    image_embeds = None
    if cfg.n_patches:
        image_embeds = torch.randn(
            (args.batch, cfg.n_patches, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(2)) * 0.1
    out = generate(cfg, params, prompt, args.new, args.temperature, gen,
                   image_embeds=image_embeds)
    n_new = args.new * args.batch
    print(json.dumps({
        "arch": cfg.name, "full_width": args.full_width,
        "pallas_attention": args.pallas_attention, "device": str(device),
        "batch": args.batch, "prompt_len": args.prompt_len, "new": args.new,
        "prefill_s": out.prefill_s,
        "prefill_logits_shape": list(out.prefill_logits.shape),
        "decode_s": out.decode_s,
        "decode_tok_per_s": n_new / out.decode_s if out.decode_s else None,
        "generated": out.tokens.tolist()}))


if __name__ == "__main__":
    main()
