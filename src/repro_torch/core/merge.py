"""Unified delta-based merge pipeline with pluggable server optimizers.

Every strategy's model merge — FedAvg's cardinality-weighted average,
Eq. 3's staleness damping, FedAsync's mixing-rate merge, FedBuff's
buffered flush — is one algebraic shape:

    w' = ServerOpt(w, Δ),   Δ = mix · (Σ_k c_k · W_k − w)

i.e. a weighted sum of client updates forms a *pseudo-gradient* Δ against
the current global model, and a server-side optimizer decides how to fold
it in (Reddi et al., "Adaptive Federated Optimization", arXiv:2003.00295).
`mix` is 1 for the barrier strategies (the weighted sum replaces the
model outright when ServerOpt is the identity), FedAsync's staleness-
damped α_s, or FedBuff's server rate η.

`MergePipeline` owns that step for all strategies (core/strategies.py
constructs one per strategy from `StrategyConfig.server_opt*`):

* the **identity** server optimizer (``sgd`` with lr=1 and no momentum —
  the default) computes the weighted sum directly, with the global model
  folded in as an anchor row when mix < 1, through
  `core.aggregation.aggregate`, i.e. the ``fed_agg`` kernel;
* the adaptive optimizers — ``fedavgm`` (server momentum),
  ``fedadagrad``, ``fedadam``, ``fedyogi`` — keep flat fp32 moment
  buffers and run the whole weighted-sum → Δ → moment-update → apply
  step as one ``fed_agg_apply`` call (kernels/fed_agg.py).

With ``mesh`` set to a ``launch.mesh.Mesh`` of more than one device
(``ExperimentConfig.merge_devices``), both paths split the P dim over it:
the identity path through ``fed_agg_sharded``, the optimizer path through
``fed_agg_apply_sharded``.  ``None`` or a size-1 mesh is the unsharded
call.

Empty merges are uniform across strategies and training modes: no
updates → the global model is returned unchanged and ``last_update_norm``
reads 0.0.  `last_update_norm` carries ‖Δ‖₂ of the latest merge on the
optimizer path — the fused kernel emits Σ Δ² per block, so the
diagnostic costs no extra pass over the model.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from .. import tracing
from ..kernels.fed_agg import fed_agg_apply, fed_agg_apply_sharded
from ..optim.optimizers import zeros_like_f32
from .aggregation import (ClientUpdate, aggregate, coefficient_tensor,
                          flat_update_matrix)
from .flatten import flatten_params, tree_leaves, tree_map

Pytree = Any

SERVER_OPTS = ("sgd", "fedavgm", "fedadagrad", "fedadam", "fedyogi")
# second-moment families (need the v buffer)
_ADAPTIVE = ("fedadagrad", "fedadam", "fedyogi")


@dataclass(frozen=True)
class ServerOptConfig:
    """Server optimizer family + hyperparameters (FedOpt conventions:
    no bias correction; `eps` is the adaptivity degree τ)."""
    name: str = "sgd"
    lr: float = 1.0
    momentum: float = 0.0         # heavy-ball β for sgd / fedavgm
    b1: float = 0.9               # first-moment decay (adaptive families)
    b2: float = 0.99              # second-moment decay (fedadam/fedyogi)
    eps: float = 1e-3

    def normalized(self) -> "ServerOptConfig":
        if self.name not in SERVER_OPTS:
            raise ValueError(f"unknown server optimizer {self.name!r}; "
                             f"available: {SERVER_OPTS}")
        # fedavgm *is* momentum — picking it with β=0 means the caller
        # wants the family default, not a silent plain-SGD
        if self.name == "fedavgm" and self.momentum == 0.0:
            return replace(self, momentum=0.9)
        return self

    @property
    def is_identity(self) -> bool:
        """Plain server-SGD with lr=1 and no momentum: w' = w + Δ, i.e.
        exactly the replace-with-weighted-average merge."""
        return (self.name == "sgd" and self.lr == 1.0
                and self.momentum == 0.0)


def _wait_for_rows(update: ClientUpdate) -> None:
    """The ``fl.device_wait`` span: with the update's rows on a card,
    wait there for its stream, so that the merge's first blocking upload
    does not hide the round's wait for the card (tracing on only)."""
    if update.batch is not None:
        device = update.batch.mat.device
    else:
        device = tree_leaves(update.params)[0].device
    with tracing.span("fl.device_wait"):
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()


class MergePipeline:
    """Delta-based merge: weighted sum → pseudo-gradient → server opt."""

    def __init__(self, config: Optional[ServerOptConfig] = None,
                 mesh=None):
        self.config = (config or ServerOptConfig()).normalized()
        # P-sharded merge over a launch.mesh.Mesh; None or size 1: unsharded
        self.mesh = mesh
        self.steps = 0                  # server-optimizer steps taken
        self.last_update_norm: Optional[float] = None   # ‖Δ‖₂
        self._m: Optional[torch.Tensor] = None   # flat fp32 moments (P,)
        self._v: Optional[torch.Tensor] = None
        self._unflatten32 = None        # flat fp32 → params-shaped tree

    @property
    def is_identity(self) -> bool:
        return self.config.is_identity

    # ------------------------------------------------------------------
    def merge(self, global_params: Optional[Pytree],
              updates: Sequence[ClientUpdate], coeffs,
              mix: float = 1.0) -> Optional[Pytree]:
        """Fold `updates` into `global_params`.

        coeffs are the caller's weighted-sum coefficients over `updates`
        (fedavg / staleness / buffer weights); `mix` scales the resulting
        pseudo-gradient (barrier strategies: 1.0, FedAsync: α_s,
        FedBuff: η).  With no updates the global model is returned
        unchanged — the unified empty-cohort / zero-update path.
        """
        if not updates:
            self.last_update_norm = 0.0
            return global_params
        if tracing.enabled():
            _wait_for_rows(updates[0])
        coeffs = np.asarray(coeffs, dtype=np.float64)
        if self.is_identity:
            self.last_update_norm = None    # not computed on this path
            return self._merge_identity(global_params, list(updates), coeffs,
                                        mix)
        if global_params is None:
            raise ValueError(
                f"server optimizer {self.config.name!r} is delta-based and "
                f"needs the current global params")
        new_params = self._merge_opt(global_params, list(updates), coeffs,
                                     float(mix))
        self.steps += 1
        return new_params

    # ---- identity path -------------------------------------------------
    def _merge_identity(self, global_params, updates: List[ClientUpdate],
                        coeffs: np.ndarray, mix: float) -> Pytree:
        if mix >= 1.0:
            # w' = w + (Σ c·W − w) = Σ c·W
            return aggregate(updates, coeffs, mesh=self.mesh)
        if global_params is None:
            raise ValueError("mix < 1 folds the global model in as an "
                             "anchor; global params are required")
        anchor = ClientUpdate("__global__", global_params, num_samples=0,
                              round_number=updates[0].round_number)
        folded = np.concatenate(([1.0 - mix], mix * coeffs))
        return aggregate([anchor] + updates, folded, mesh=self.mesh)

    # ---- optimizer path ----------------------------------------------
    def _kernel_scalars(self):
        c = self.config
        b1 = c.momentum if c.name in ("sgd", "fedavgm") else c.b1
        return c.lr, b1, c.b2, c.eps

    def _merge_opt(self, global_params, updates: List[ClientUpdate],
                   coeffs: np.ndarray, mix: float) -> Pytree:
        flat_g, unflatten = flatten_params(global_params)
        mat, _ = flat_update_matrix(updates)
        if mat.shape[1] != flat_g.shape[0]:
            raise RuntimeError(
                f"update/global size mismatch: updates flatten to "
                f"{mat.shape[1]} parameters, global model to "
                f"{flat_g.shape[0]}")
        if self._unflatten32 is None:
            # moments unflatten through an fp32 view of the params
            # structure, so low-precision models keep fp32 moment state
            _, self._unflatten32 = flatten_params(
                zeros_like_f32(global_params))
        m = (self._m if self._m is not None
             else torch.zeros_like(flat_g, dtype=torch.float32))
        v = (self._v if self._v is not None
             else torch.zeros_like(flat_g, dtype=torch.float32))
        lr, b1, b2, eps = self._kernel_scalars()
        args = (mat, coefficient_tensor(coeffs, mat.device), flat_g.float(),
                m, v, lr, mix, b1, b2, eps)
        # outputs are fresh tensors: the strategy keeps global_params
        if self.mesh is not None and self.mesh.size > 1:
            out, m_new, v_new, norm = fed_agg_apply_sharded(
                *args, opt=self.config.name, mesh=self.mesh)
        else:
            out, m_new, v_new, norm = fed_agg_apply(*args,
                                                    opt=self.config.name)
        self._m = m_new
        if self.config.name in _ADAPTIVE:
            self._v = v_new
        self.last_update_norm = float(norm)
        return unflatten(out.to(flat_g.dtype))

    # ---- checkpoint surface ------------------------------------------
    def state_dict(self, arrays: Optional[dict] = None) -> dict:
        """Moment trees go into `arrays` (they share the global model's
        tree structure, so a checkpointer's array store handles them)."""
        arrays = {} if arrays is None else arrays
        state = {"name": self.config.name, "steps": self.steps}
        if self._m is not None:
            arrays["server_opt/m"] = self._unflatten32(self._m)
            state["has_m"] = True
        if self._v is not None:
            arrays["server_opt/v"] = self._unflatten32(self._v)
            state["has_v"] = True
        return state

    def load_state_dict(self, state: dict,
                        arrays: Optional[dict] = None) -> None:
        """Missing state (moment-free checkpoints) restores as a fresh
        optimizer: moments re-accumulate from the resume point."""
        arrays = {} if arrays is None else arrays
        if not state:
            return
        name = state.get("name")
        if name is not None and name != self.config.name:
            raise ValueError(f"checkpoint was written with server "
                             f"optimizer {name!r}, pipeline runs "
                             f"{self.config.name!r}")
        self.steps = int(state.get("steps", 0))

        def flat32(key: str) -> torch.Tensor:
            tree = tree_map(lambda l: torch.as_tensor(l, dtype=torch.float32),
                            arrays[key])
            flat, self._unflatten32 = flatten_params(tree)
            return flat

        self._m = flat32("server_opt/m") if state.get("has_m") else None
        self._v = flat32("server_opt/v") if state.get("has_v") else None
