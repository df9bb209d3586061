"""Training tasks: model + loss + local-training loop for FL clients.

A Task turns a ModelDef into the pieces Client_Update needs:
`init_params`, `local_train` (with FedProx proximal hook) and `evaluate`.
One task serves every client of an experiment — mirroring how FedLess
ships one function image.  It runs on one device, the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import numpy as np
import torch

from ..core.flatten import tree_map
from ..data.synthetic import ArrayDataset
from ..device import DeviceLike, resolve_device
from ..models.small import ModelDef
from ..optim import make_optimizer

Pytree = Any


@dataclass(frozen=True)
class TaskConfig:
    epochs: int = 5
    batch_size: int = 10
    learning_rate: float = 1e-3
    optimizer: str = "adam"
    per_sample_time_s: float = 0.01   # nominal seconds/sample/epoch (sim)


def _cross_entropy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample −log softmax(logits)[y]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None])[:, 0]


class ClassificationTask:
    """Cross-entropy classification of the paper's image models."""

    def __init__(self, model: ModelDef, config: TaskConfig,
                 device: DeviceLike = None):
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(config.optimizer,
                                        config.learning_rate)

    # ------------------------------------------------------------------
    def init_params(self, seed: int = 0) -> Pytree:
        return self.model.init(seed, self.device)

    # ------------------------------------------------------------------
    def _train_step(self, params, opt_state, global_params, x, y, mu):
        params = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = _cross_entropy(self.model.apply(params, x), y).mean()
        loss.backward()
        with torch.no_grad():
            grads = tree_map(lambda p: p.grad, params)
            params = tree_map(lambda p: p.detach(), params)
            params, opt_state = self.optimizer.step(
                grads, opt_state, params, global_params, mu)
            return params, opt_state, loss.detach()

    def local_train(self, global_params: Pytree, ds: ArrayDataset,
                    mu: float = 0.0, seed: int = 0) -> Tuple[Pytree, float]:
        """Run `epochs` local epochs from the global model. Returns the new
        local params and the mean training loss.

        The shard goes to the device once; each epoch's batches are cut
        from one numpy permutation (the batch order of data/loader.py),
        indexed on the device.
        """
        cfg = self.config
        rng = np.random.default_rng(seed)
        x_all = torch.from_numpy(ds.x).to(self.device)
        y_all = torch.from_numpy(ds.y).to(self.device, torch.int64)
        n = len(ds)
        params = global_params
        opt_state = self.optimizer.init(params)
        losses = []
        for _ in range(cfg.epochs):
            order = torch.from_numpy(rng.permutation(n)).to(self.device)
            for i in range(0, n, cfg.batch_size):
                idx = order[i:i + cfg.batch_size]
                params, opt_state, loss = self._train_step(
                    params, opt_state, global_params, x_all[idx],
                    y_all[idx], float(mu))
                losses.append(loss)
        mean_loss = (float(torch.stack(losses).double().mean())
                     if losses else 0.0)
        return params, mean_loss

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, params: Pytree, ds: ArrayDataset,
                 batch_size: int = 256) -> Tuple[float, float]:
        """Returns (accuracy, mean loss)."""
        correct, loss_sum, n = 0.0, 0.0, 0
        for i in range(0, len(ds), batch_size):
            x = torch.from_numpy(ds.x[i:i + batch_size]).to(self.device)
            y = torch.from_numpy(ds.y[i:i + batch_size]).to(self.device,
                                                              torch.int64)
            logits = self.model.apply(params, x)
            correct += float((logits.argmax(dim=-1) == y).sum())
            loss_sum += float(_cross_entropy(logits, y).sum())
            n += x.shape[0]
        return correct / max(1, n), loss_sum / max(1, n)

    # ------------------------------------------------------------------
    def nominal_work_seconds(self, ds: ArrayDataset) -> float:
        """Ideal training duration used by the virtual-time simulation:
        proportional to epochs × samples (plus model/data load overhead)."""
        cfg = self.config
        load_overhead = 2.0  # model + dataset fetch (paper Alg.1 line 19)
        return load_overhead + cfg.epochs * len(ds) * cfg.per_sample_time_s
