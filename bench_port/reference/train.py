"""Plain training arithmetic: Adam, a client's local epochs, the LM's
train steps computed a sequence at a time, and the FedLesScan merge
(arXiv:2211.05739, Eq. 3)."""
from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import Quant
from .models import cnn_forward, lm_hidden, lm_logits
from .weights import leaves

_PLAIN = Quant()


class Adam:
    """Adam (Kingma & Ba) over a dict of float32 leaves."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"t": 0, "m": {k: torch.zeros_like(v) for k, v in
                              params.items()},
                "v": {k: torch.zeros_like(v) for k, v in params.items()}}

    def step(self, params, grads, state) -> Dict[str, torch.Tensor]:
        state["t"] += 1
        t = state["t"]
        out = {}
        for k, p in params.items():
            g = grads[k]
            m = state["m"][k] = self.b1 * state["m"][k] + (1 - self.b1) * g
            v = state["v"][k] = self.b2 * state["v"][k] + (1 - self.b2) * g * g
            mh = m / (1 - self.b1 ** t)
            vh = v / (1 - self.b2 ** t)
            out[k] = p - self.lr * mh / (torch.sqrt(vh) + self.eps)
        return out


def unflatten_like(flat: Dict[str, torch.Tensor], like: dict) -> dict:
    """A nested tree shaped as ``like`` from its ``{path: leaf}`` dict."""
    def build(node, prefix):
        return {k: build(v, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"] for k, v in node.items()}
    return build(like, "")


# ------------------------------------------------------------- clients
def client_seed(cid: str, round_number: int, seed: int) -> int:
    """The client's shuffle seed for a round: CRC32 of
    ``"<cid>:<round>:<seed>"`` mod 2³¹."""
    return zlib.crc32(f"{cid}:{round_number}:{seed}".encode()) % (2 ** 31)


def batch_schedule(n: int, batch: int, epochs: int, seed: int
                   ) -> List[np.ndarray]:
    """The sample indices of each local step: every epoch a fresh
    permutation (all epochs drawn at once, row by row, from one
    generator), cut into batches; the last batch of an epoch may be
    short."""
    rng = np.random.default_rng(seed)
    orders = rng.permuted(np.tile(np.arange(n), (epochs, 1)), axis=1)
    return [order[i:i + batch] for order in orders
            for i in range(0, n, batch)]


def cnn_loss(params, x, y, model: dict, q: Quant = _PLAIN):
    return F.cross_entropy(cnn_forward(params, x, q), y.long())


def lm_last_token_loss(params, x, y, model: dict, q: Quant = _PLAIN):
    """Next-token loss at the last position only."""
    h = lm_hidden(params, x, model, q)[:, -1]
    return F.cross_entropy(lm_logits(params, h, q), y.long())


def local_train(loss_fn: Callable, global_params: dict, x: torch.Tensor,
                y: torch.Tensor, model: dict, local: dict, seed: int,
                q: Quant = _PLAIN) -> Tuple[dict, float]:
    """A client's local epochs from ``global_params``: returns its
    trained tree and the mean of its steps' losses."""
    params = {k: v.detach().clone() for k, v in
              leaves(global_params).items()}
    opt = Adam(local["learning_rate"])
    state = opt.init(params)
    losses = []
    for idx in batch_schedule(x.shape[0], local["batch_size"],
                              local["epochs"], seed):
        live = {k: v.requires_grad_(True) for k, v in params.items()}
        tree = unflatten_like(live, global_params)
        i = torch.as_tensor(idx, device=x.device)
        loss = loss_fn(tree, x[i], y[i], model, q)
        grads = torch.autograd.grad(loss, list(live.values()))
        with torch.no_grad():
            params = opt.step({k: v.detach() for k, v in live.items()},
                              dict(zip(live, grads)), state)
        losses.append(float(loss.detach()))
    return unflatten_like(params, global_params), float(np.mean(losses))


# ------------------------------------------------------------- the LM
def lm_step_grads(params: Dict[str, torch.Tensor], like: dict,
                  tokens: torch.Tensor, labels: torch.Tensor, model: dict,
                  q: Quant = _PLAIN) -> Tuple[float, Dict[str, torch.Tensor]]:
    """Mean token cross-entropy over the (B, S) batch and its gradient,
    computed one sequence at a time (each sequence's summed loss over
    B·S, the gradients added), so the float32 graph of one sequence is
    all that is held."""
    total = tokens.numel()
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    loss_sum = 0.0
    for r in range(tokens.shape[0]):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        tree = unflatten_like(live, like)
        h = lm_hidden(tree, tokens[r:r + 1], model, q)
        logits = lm_logits(tree, h, q)
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               labels[r].reshape(-1).long(),
                               reduction="sum") / total
        got = torch.autograd.grad(loss, list(live.values()))
        for k, g in zip(live, got):
            grads[k] += g
        loss_sum += float(loss.detach())
        del live, tree, h, logits, loss, got
    return loss_sum, grads


# ------------------------------------------------------------- merge
def fedlesscan_merge(rows: Sequence[torch.Tensor],
                     rounds: Sequence[int], samples: Sequence[int],
                     current_round: int, tau: int) -> torch.Tensor:
    """Eq. 3 over the updates younger than τ rounds:
    Σ_k ((t_k + 1)/(t + 1))·(n_k / n)·W_k, n the fresh updates' samples,
    summed in float64."""
    fresh = [k for k, t in enumerate(rounds) if current_round - t < tau]
    n = float(sum(samples[k] for k in fresh))
    out = torch.zeros_like(rows[0], dtype=torch.float64)
    for k in fresh:
        c = (rounds[k] + 1) / (current_round + 1) * samples[k] / n
        out += c * rows[k].double()
    return out
