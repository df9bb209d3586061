"""The benchmark's weights, made from the seed on the device in a few
large draws, in the program's tree and the type they are served in
(float32).  Both sides get the same tensors."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def _split(flat: torch.Tensor, shapes: List[Tuple[int, ...]]):
    sizes = [math.prod(s) for s in shapes]
    return [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def cnn_params(model: dict, gen: torch.Generator) -> Dict[str, dict]:
    """He-normal kernels and dense weights (std sqrt(2 / fan_in)), zero
    biases; one normal draw for all weights."""
    k, c = model["kernel_size"], model["channels"]
    c1, c2 = model["conv_channels"]
    side = model["image_size"] // model["pool"] ** 2
    shapes = [(k, k, c, c1), (k, k, c1, c2), (side * side * c2,
                                               model["fc_width"]),
              (model["fc_width"], model["classes"])]
    fans = [k * k * c, k * k * c1, side * side * c2, model["fc_width"]]
    total = sum(math.prod(s) for s in shapes)
    flat = torch.randn(total, generator=gen, device=gen.device)
    ws = _split(flat, shapes)
    out = {}
    for name, w, fan in zip(("conv1", "conv2", "fc1", "out"), ws, fans):
        w.mul_(math.sqrt(2.0 / fan))
        out[name] = {"w": w, "b": torch.zeros(w.shape[-1],
                                              device=gen.device)}
    return out


def lm_params(model: dict, gen: torch.Generator) -> dict:
    """Mamba2 LM params: embedding 0.02·N(0, 1); in_proj and out_proj
    He-normal; conv weights N(0, 1)/sqrt(d_conv), conv bias 0;
    A_log = log U(1, 16); dt log-uniform in [1e-3, 1e-1] and
    dt_bias = dt + log(-expm1(-dt)) (softplus⁻¹); D = 1; norm scales 0.
    One normal and one uniform draw."""
    D, V, L = model["d_model"], vocab_rows(model), model["n_layer"]
    ssm = model["ssm_cfg"]
    d_inner, H, N, K = model["d_inner"], model["nheads"], ssm["d_state"], \
        ssm["d_conv"]
    conv_dim = d_inner + 2 * N
    e = 2 * d_inner + 2 * N + H
    dev = gen.device
    shapes = [(V, D), (L, D, e), (L, conv_dim, K), (L, d_inner, D)]
    flat = torch.randn(sum(math.prod(s) for s in shapes), generator=gen,
                       device=dev)
    embed, in_proj, conv_w, out_proj = _split(flat, shapes)
    embed.mul_(0.02)
    in_proj.mul_(math.sqrt(2.0 / D))
    conv_w.mul_(1.0 / math.sqrt(K))
    out_proj.mul_(math.sqrt(2.0 / d_inner))
    u = torch.rand(2, L, H, generator=gen, device=dev)
    dt = torch.exp(u[0] * (math.log(0.1) - math.log(0.001))
                   + math.log(0.001))
    mamba = {"in_proj": in_proj, "conv_w": conv_w,
             "conv_b": torch.zeros(L, conv_dim, device=dev),
             "A_log": torch.log(1.0 + 15.0 * u[1]),
             "dt_bias": dt + torch.log(-torch.expm1(-dt)),
             "D": torch.ones(L, H, device=dev),
             "norm": torch.zeros(L, d_inner, device=dev),
             "out_proj": out_proj}
    return {"embed": embed,
            "blocks": {"pos0": {"ln1": torch.zeros(L, D, device=dev),
                                "mamba": mamba}},
            "final_norm": torch.zeros(D, device=dev)}


def vocab_rows(model: dict) -> int:
    """The embedding table's rows: the vocabulary padded up to a multiple
    of ``pad_vocab_size_multiple`` (1 when the file gives none)."""
    pad = model.get("pad_vocab_size_multiple", 1)
    return -(-model["vocab_size"] // pad) * pad


def leaves(tree: dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` in sorted-key order, the order in which the
    program flattens a tree into an update row."""
    out = {}
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(leaves(val, path + "/"))
        else:
            out[path] = val
    return out


def flat(tree: dict) -> torch.Tensor:
    """The tree's leaves raveled and joined in sorted-key order."""
    return torch.cat([t.reshape(-1).float() for t in leaves(tree).values()])


def count(tree: dict) -> int:
    return sum(t.numel() for t in leaves(tree).values())
