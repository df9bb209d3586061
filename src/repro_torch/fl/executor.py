"""Vectorized client execution: a group's local epochs as one batched loop.

The eager loop (``ClassificationTask.local_train``) trains one client at a
time, so every step launches every operation once per client.  This
module trains a whole group of same-shape clients together:

  * each client's shuffled epoch schedule is an index matrix
    (``_batch_indices``, replicating ``data.loader.batches`` draw for
    draw, so the results match the per-client loop);
  * a partial trailing batch is padded to the full batch size with a
    per-sample mask; the masked mean cross-entropy
    ``Σ ce·m / max(Σ m, 1)`` gives padded samples exactly zero gradient;
  * the group's batches stack into (K, T, B, ...) tensors staged on the
    device once, and each of the T steps is one
    ``torch.func.vmap(torch.func.grad_and_value(masked_loss))`` call over
    the K-stacked params, followed by the optimizer's step (the proximal
    term, the update and the apply), which is elementwise and runs on the
    stacked trees directly: for Adam one ``kernels.adam`` launch on the
    card (the Python loop over T is the counterpart of ``lax.scan``);
  * K is padded to a power-of-two bucket by repeating the last client
    (padded rows are never read), as the JAX package does to reuse its
    compiled executables; ``compile_count`` counts the distinct dispatch
    signatures per mesh, as there.

``run_group_batch`` flattens the trained stack into the (K_bucket, P)
matrix of a ``core.device_batch.DeviceUpdateBatch``, which the packaging,
the compression stage and the merge read row by row; per-client trees
are built lazily.  CUDA launches are asynchronous and nothing here waits
for the card: the only host syncs of a round are the batch's one loss
fetch and the merge's read-back.

Multi-device (``mesh``): given a ("clients",) ``launch.mesh.Mesh`` of
more than one device, each device trains its contiguous slice of the
bucket (``sharding.rules.shard_slices``), the steps of the slices
interleaved so that every device has work queued, and the slices' stacks
are gathered on the mesh's first device.  ``None`` or a size-1 mesh is
the unsharded path.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import grad_and_value, vmap

from .. import tracing
from ..core.device_batch import DeviceUpdateBatch
from ..core.flatten import flatten_params, tree_leaves, tree_map
from ..sharding.rules import shard_slices
from .tasks import _cross_entropy

Pytree = Any


def _batch_indices(n: int, batch_size: int, epochs: int,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(T, B) index + mask matrices reproducing `loader.batches` order.

    Trailing partial batches are padded with index 0 / mask 0.

    Vectorized: one ``rng.permuted`` over a tiled arange draws all E
    epoch permutations at once — bit-identical, draw-for-draw, to E
    sequential ``rng.permutation(n)`` calls (both reduce to E row-wise
    Fisher–Yates passes over the same bit stream), without the
    O(E·n/B) per-batch Python loop.
    """
    orders = rng.permuted(np.tile(np.arange(n), (epochs, 1)), axis=1)
    per_epoch = -(-n // batch_size)             # batches per epoch
    pad = per_epoch * batch_size - n
    if pad:
        orders = np.concatenate(
            [orders, np.zeros((epochs, pad), dtype=orders.dtype)], axis=1)
    idx = orders.reshape(epochs * per_epoch, batch_size)
    mask = np.ones((epochs, per_epoch * batch_size), dtype=np.float32)
    if pad:
        mask[:, n:] = 0.0
    return idx, mask.reshape(epochs * per_epoch, batch_size)


def _bucket(k: int, multiple: int = 1) -> int:
    """Next power of two ≥ k, rounded up to a ``multiple`` (the mesh
    device count) so the cohort dim always divides the ``clients`` axis.
    With ``multiple=1`` this is exactly the historical bucket."""
    b = 1 << (k - 1).bit_length() if k > 1 else 1
    if multiple > 1 and b % multiple:
        b = -(-b // multiple) * multiple
    return b


def _normalize_mesh(mesh):
    """A missing or size-1 mesh is *no* mesh: the executor falls back to
    the plain vmap path, keeping single-device runs bitwise-identical."""
    if mesh is None or int(mesh.size) <= 1:
        return None
    return mesh


def _flatten_stacked(stacked: Pytree) -> torch.Tensor:
    """(K, P) matrix whose row k is ``flatten_params`` of client k's tree:
    the leaves in sorted-key order, each raveled, in the promoted dtype."""
    leaves = tree_leaves(stacked)
    k = leaves[0].shape[0]
    dtype = leaves[0].dtype
    for leaf in leaves[1:]:
        dtype = torch.promote_types(dtype, leaf.dtype)
    return torch.cat([leaf.reshape(k, -1).to(dtype) for leaf in leaves],
                     dim=1)


class VectorizedExecutor:
    """Runs the local epochs of a group of clients as one batched loop."""

    def __init__(self, task, mesh=None):
        self.task = task
        self.mesh = _normalize_mesh(mesh)
        # distinct dispatch signatures (mu, mesh, bucketed operand shapes),
        # counted per mesh: flat across rounds once every bucket was seen
        self._dispatch_keys: set = set()
        self._compile_counts: Dict[Any, int] = {}
        self._unflatten_cache: Dict[tuple, Any] = {}
        # telemetry (wall clock, never fed back into virtual time): each
        # group dispatch's launch latency, stamped onto its updates as
        # ``dispatch_s`` when enabled
        self.collect_timing = False
        self.last_dispatch_s: Optional[float] = None

    # ------------------------------------------------------------------
    def configure_mesh(self, mesh) -> None:
        """Point later dispatches at ``mesh`` (size 1 → unsharded)."""
        self.mesh = _normalize_mesh(mesh)

    def _mesh_key(self) -> Optional[tuple]:
        return None if self.mesh is None else self.mesh.key

    @property
    def compile_count(self) -> int:
        """Distinct dispatch signatures seen on the current mesh."""
        return self._compile_counts.get(self._mesh_key(), 0)

    @property
    def compile_count_total(self) -> int:
        """Distinct dispatch signatures across every mesh used."""
        return sum(self._compile_counts.values())

    # ------------------------------------------------------------------
    def _masked_loss(self, params, x, y, m):
        """Mean cross-entropy over the unmasked samples of one batch."""
        ce = _cross_entropy(self.task.model.apply(params, x), y)
        return torch.sum(ce * m) / torch.clamp(torch.sum(m), min=1.0)

    def _train_slices(self, global_params: Pytree, slices, mu: float):
        """Train each slice ``(device, xs, ys, ms)`` of (k, T, B, ...)
        tensors on its device; the T steps of all slices are interleaved.
        Returns ``[(stacked params, mean losses (k,))]`` per slice."""
        optimizer = self.task.optimizer
        step = vmap(grad_and_value(self._masked_loss))
        states = []
        for dev, xs, _, _ in slices:
            g = tree_map(lambda l: l.detach().to(dev), global_params)
            k = xs.shape[0]
            params = tree_map(
                lambda l: l.unsqueeze(0).expand(k, *l.shape).clone(), g)
            states.append({"g": g, "params": params,
                           "opt": optimizer.init(params), "losses": []})
        for t in range(slices[0][1].shape[1]):
            for st, (_, xs, ys, ms) in zip(states, slices):
                grads, loss = step(st["params"], xs[:, t], ys[:, t],
                                   ms[:, t])
                with tracing.span("fl.optimizer"):
                    st["params"], st["opt"] = optimizer.step(
                        grads, st["opt"], st["params"], st["g"], mu)
                st["losses"].append(loss)
        return [(st["params"], torch.stack(st["losses"], dim=1).mean(dim=1))
                for st in states]

    def _stage(self, datasets, seeds, k_bucket: int):
        """Host (K_bucket, T, B, ...) inputs, labels and masks; rows past
        the group repeat its last client."""
        cfg = self.task.config
        xs, ys, ms = [], [], []
        for ds, seed in zip(datasets, seeds):
            rng = np.random.default_rng(seed)
            idx, mask = _batch_indices(len(ds), cfg.batch_size, cfg.epochs,
                                       rng)
            xs.append(ds.x[idx])        # (T, B, ...)
            ys.append(ds.y[idx])
            ms.append(mask)
        pad = k_bucket - len(xs)
        xs, ys, ms = [np.stack(a + a[-1:] * pad) for a in (xs, ys, ms)]
        return xs, ys.astype(np.int64), ms

    def _train_group(self, cids: Sequence[str], datasets,
                     global_params: Pytree, mu: float,
                     seeds: Sequence[int]) -> Tuple[Pytree, torch.Tensor]:
        """(stacked params, losses) of one group, K padded to the bucket
        (rows ≥ len(cids) are pads), on the executor's home device: the
        task's device, or the first device of the mesh."""
        n_devices = 1 if self.mesh is None else self.mesh.size
        with tracing.span("fl.stage"):
            xs, ys, ms = self._stage(datasets, seeds,
                                     _bucket(len(cids), n_devices))
            parts = ([(self.task.device, slice(None))] if self.mesh is None
                     else shard_slices(xs.shape[0], self.mesh))
            slices = [(dev, *(torch.from_numpy(a[rows]).to(dev)
                              for a in (xs, ys, ms)))
                      for dev, rows in parts]
        mesh_key = self._mesh_key()
        key = (mu, mesh_key, xs.shape, str(xs.dtype), ys.shape,
               str(ys.dtype))
        if key not in self._dispatch_keys:
            self._dispatch_keys.add(key)
            self._compile_counts[mesh_key] = \
                self._compile_counts.get(mesh_key, 0) + 1
        tracing.count("fl.local_steps", xs.shape[1])
        with tracing.span("fl.steps"):
            trained = self._train_slices(global_params, slices, float(mu))
        if len(trained) == 1:
            return trained[0]
        home = parts[0][0]
        stacked = tree_map(lambda *ls: torch.cat([l.to(home) for l in ls]),
                           *(p for p, _ in trained))
        return stacked, torch.cat([loss.to(home) for _, loss in trained])

    def run_group(self, cids: Sequence[str], datasets, global_params: Pytree,
                  mu: float, seeds: Sequence[int]
                  ) -> Dict[str, Tuple[Pytree, float]]:
        """Train one same-shape group; returns cid -> (params, mean loss)."""
        out_params, losses = self._train_group(cids, datasets, global_params,
                                               mu, seeds)
        losses_np = losses.cpu().numpy()          # one transfer for all K
        return {cid: (tree_map(lambda l: l[k], out_params),
                      float(losses_np[k]))
                for k, cid in enumerate(cids)}

    def _unflatten_for(self, stacked: Pytree):
        """The row → tree inverse of ``_flatten_stacked`` (cached per
        tree layout)."""
        leaves = tree_leaves(stacked)
        key = tuple((tuple(l.shape[1:]), l.dtype) for l in leaves)
        unflatten = self._unflatten_cache.get(key)
        if unflatten is None:
            _, unflatten = flatten_params(tree_map(lambda l: l[0], stacked))
            self._unflatten_cache[key] = unflatten
        return unflatten

    def run_group_batch(self, cids: Sequence[str], datasets,
                        global_params: Pytree, mu: float,
                        seeds: Sequence[int]) -> DeviceUpdateBatch:
        """``run_group`` that keeps the trained stack on the device, as
        the (K_bucket, P) matrix of a DeviceUpdateBatch."""
        out_params, losses = self._train_group(cids, datasets, global_params,
                                               mu, seeds)
        return DeviceUpdateBatch(_flatten_stacked(out_params), cids,
                                 self._unflatten_for(out_params),
                                 losses=losses)

    # ------------------------------------------------------------------
    def _group(self, pool, cids: Sequence[str]) -> Dict[tuple, List[str]]:
        """Bucket clients by (dataset size, sample shape, dtype)."""
        groups: Dict[tuple, List[str]] = {}
        for cid in cids:
            ds = pool.clients[cid].dataset
            key = (len(ds), ds.x.shape[1:], str(ds.x.dtype))
            groups.setdefault(key, []).append(cid)
        return groups

    def warmup(self, pool, cids: Sequence[str], global_params: Pytree,
               round_number: int = 0) -> int:
        """Run the groups ``cids`` would form once and discard the result
        (first-call costs such as cuDNN's algorithm choice fall here, not
        in round 0), touching no round state.  Returns the compile count
        of the current mesh."""
        for group_cids in self._group(pool, cids).values():
            datasets = [pool.clients[c].dataset for c in group_cids]
            seeds = [pool.client_seed(c, round_number) for c in group_cids]
            out_params, _ = self._train_group(group_cids, datasets,
                                              global_params,
                                              pool.proximal_mu, seeds)
            _flatten_stacked(out_params)
        return self.compile_count

    def run_clients(self, pool, cids: Sequence[str], global_params: Pytree,
                    round_number: int) -> Dict[str, tuple]:
        """Group → train → package: cid -> (ClientUpdate, nominal_work_s),
        the contract of `ClientPool.work_fn` per client.  Each group's
        updates are rows of one DeviceUpdateBatch; the card is not waited
        for."""
        results: Dict[str, tuple] = {}
        for group_cids in self._group(pool, cids).values():
            datasets = [pool.clients[c].dataset for c in group_cids]
            seeds = [pool.client_seed(c, round_number) for c in group_cids]
            # wall-clock telemetry only — never folded into virtual time
            t0 = (time.perf_counter()  # repro-lint: disable=DET002
                  if self.collect_timing else None)
            batch = self.run_group_batch(group_cids, datasets, global_params,
                                         pool.proximal_mu, seeds)
            dispatch_s = self._lap(t0)
            for i, cid in enumerate(group_cids):
                update = pool.package_update(cid, None, round_number,
                                             global_params, batch=batch,
                                             row=i)
                update.dispatch_s = dispatch_s
                results[cid] = (update, self.task.nominal_work_seconds(
                    pool.clients[cid].dataset))
        return results

    def _lap(self, t0: Optional[float]) -> Optional[float]:
        """Elapsed wall seconds since ``t0`` when timing is on."""
        if t0 is None:
            return None
        self.last_dispatch_s = \
            time.perf_counter() - t0  # repro-lint: disable=DET002
        return self.last_dispatch_s
