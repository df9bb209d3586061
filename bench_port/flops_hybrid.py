"""Model FLOPs and the experts' work of the hybrid (Nemotron-H) train
cell, from its configuration file; the peaks are ``flops.py``'s.

A train step counts 6 operations a parameter for each token that passes
through it (forward and backward): every parameter but the embedding
(a lookup) and the experts on every token, the held experts on the pairs
routed to them (``moe.routed_pairs`` a step), and the causal attention's
score and value products, 6·S²·H·hd a sequence and layer (each of the two
products 2·S²·H·hd over the causal half, three times).  The scan's own
products and remat's recomputation are not counted, as ``flops.py``
leaves them out of the Mamba2 LM's count.
"""
from __future__ import annotations

from typing import Tuple


def _layers(config: dict, letter: str) -> int:
    cut = config["hybrid_override_pattern"][:config["num_hidden_layers"]]
    return cut.count(letter)


def expert_params(config: dict) -> int:
    """Parameters of one held expert: up and down."""
    return 2 * config["hidden_size"] * config["moe_intermediate_size"]


def train_flops(config: dict, batch: int, seq: int,
                routed_pairs: float) -> float:
    """One step's model FLOPs at ``routed_pairs`` token-expert pairs a
    step on the held experts."""
    D, V = config["hidden_size"], config["vocab_size"]
    stacks = _layers(config, "E") * config["n_routed_experts"] * \
        expert_params(config)
    every_token = config["params"] - V * D - stacks
    attn = 6.0 * seq * seq * config["num_attention_heads"] * \
        config["head_dim"] * batch * _layers(config, "*")
    return (6.0 * every_token * batch * seq
            + 6.0 * expert_params(config) * routed_pairs + attn)


def experts_work(config: dict, pairs: float, calls: int,
                 itemsize: int = 2) -> Tuple[float, float]:
    """(operations, bytes) of the held experts' forward products over
    ``calls`` layer calls that computed ``pairs`` pairs in all: 4·D·F a
    pair (up and down), each call reading the held experts' weights once
    in the activations' type; what computes them does not change it."""
    ops = 4.0 * config["hidden_size"] * config["moe_intermediate_size"] \
        * pairs
    weights = config["n_routed_experts"] * expert_params(config) * itemsize
    return ops, float(weights * calls)
