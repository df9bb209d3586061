"""Serving example: prefill a prompt batch, then decode tokens
autoregressively from the KV/SSM cache — the serve-side path that the
decode_32k / long_500k dry-run shapes lower at production scale.  The
port of the JAX package's examples/serve_decode.py, over
``launch.serve.generate``.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode \
        --arch gemma2-2b --new 8 [--device cpu]

Weights are random from seed 0 and the prompt from seed 1 (image
embeddings, for a VLM config, normal × 0.1 from seed 2), drawn with
``torch.Generator``s: the same distributions as the reference's
``jax.random`` draws, not its numbers.  ``--temperature`` > 0 samples
from softmax(logits / temperature) with the prompt's generator.
"""
import argparse

import torch

from ..configs import get_config
from ..device import resolve_device
from ..launch.serve import generate
from ..models import init_params
from ..models.config import ArchConfig


def make_inputs(cfg: ArchConfig, batch: int, prompt_len: int,
                device: torch.device):
    """(params, prompt, image embeddings or None, the prompt's generator)
    as the reference example makes them, from seeds 0, 1 and 2."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    gen = torch.Generator(device=device).manual_seed(1)
    shape = ((batch, cfg.n_codebooks, prompt_len) if cfg.n_codebooks
             else (batch, prompt_len))
    prompt = torch.randint(0, cfg.vocab, shape, generator=gen, device=device)
    feats = None
    if cfg.n_patches:
        feats = torch.randn(
            (batch, cfg.n_patches, cfg.d_model), device=device,
            generator=torch.Generator(device=device).manual_seed(2)) * 0.1
    return params, prompt, feats, gen


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    B, S = args.batch, args.prompt_len
    params, prompt, feats, gen = make_inputs(cfg, B, S, device)

    out = generate(cfg, params, prompt, args.new, args.temperature, gen,
                   image_embeds=feats)
    print(f"prefill: {S} tokens × {B} seqs in {out.prefill_s:.2f}s "
          f"(logits {tuple(out.prefill_logits.shape)})")
    dt = out.decode_s
    print(f"decoded {args.new} tokens × {B} seqs in {dt:.2f}s "
          f"({args.new*B/dt:.1f} tok/s on {device.type.upper()}, "
          f"reduced config)")
    print("generated ids:", out.tokens.tolist())


if __name__ == "__main__":
    main()
