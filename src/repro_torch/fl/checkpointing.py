"""Full-fidelity checkpoint/resume of the training driver.

A checkpoint tagged *r* is two files in one directory::

    round_000004.npz    arrays: the global params plus every tree the
                        snapshot references (in-flight rounds' global
                        params, cached client updates, semi-async/FedBuff
                        update buffers, server-optimizer moments,
                        compression residuals) and a `_meta` pair
                        descriptor
    round_000004.json   driver state (TrainingDriver.checkpoint_state():
                        history payload, RNG streams, scheduler state,
                        cost tallies, virtual clock, trailing RoundStats,
                        the pending event queue, the invocation engine's
                        in-flight state, warm pools / fleet routing, and
                        — in async mode — the barrier-free loop state)

The files are the JAX package's, key for key (``checkpoint.checkpoint``
paths under ``params|`` and ``extra|<key>|``), so a checkpoint written by
either package resumes in the other.

Schema v2 checkpoints are **event-queue snapshots**: the pending
timeline (events + seq counter) and every in-flight invocation are part
of the state, so a restored run replays the remaining events
byte-identically to an uninterrupted same-seed run — in-flight
stragglers included.  In barrier modes the tag is the next round to
execute; in async mode there is no round, so `checkpoint_every` counts
*virtual seconds* and the tag is a monotone snapshot index (resume
always continues mid-timeline from the restored loop state).

Saving moves every tensor of the snapshot to the host in one copy per
(device, dtype) (``checkpoint.host_arrays``); an executor update that is
still a row of its group's matrix builds its tree on the way, the tree
the eager path would have saved.  Restoring hands the driver's hooks
tensors on the device of the template params (the experiment's device),
fp32 for server-optimizer moments and compression residuals.

Both files are written to temp names and moved into place with
``os.replace``, so a crash mid-write can never leave a torn file; the
JSON and npz of one tag carry a matching ``pair`` descriptor (schema,
tag, virtual clock, charge count) that `restore` validates, so a
half-updated pair is rejected loudly instead of silently resumed.

Schema v1 checkpoints (round-boundary only) still load: they migrate to
an empty-queue snapshot, which preserves their documented semantics (any
invocation in flight at the boundary loses its future arrival).
Surface: ``ExperimentConfig.checkpoint_dir`` / ``checkpoint_every`` to
write, ``ExperimentConfig.resume_from`` to resume.
"""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.checkpoint import (flatten_with_paths, host_arrays,
                                     load_pytree, unflatten_like)

Pytree = Any

SCHEMA_VERSION = 2
_SEP = "|"
_META_KEY = "_meta"


def _atomic_write_text(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def _atomic_write_npz(path: Path, entries: Dict[str, np.ndarray]) -> None:
    tmp = path.with_name(path.name + ".tmp")
    # np.savez appends ".npz" to bare filenames; an open handle keeps the
    # temp name exact so os.replace lands on the real target
    with open(tmp, "wb") as fh:
        np.savez(fh, **entries)
    os.replace(tmp, path)


class RoundCheckpointer:
    """Writes/restores tagged full-fidelity checkpoints with retention.

    Retention combines two policies (long async studies would otherwise
    accumulate unbounded npz/json pairs):

    * ``keep_last_n`` — the trailing N tags always survive (the resume
      frontier); ``keep`` is the historical alias for the same knob.
    * ``keep_best`` — additionally keep the top-K tags by a history
      metric: ``best_metric`` names a `RoundStats` field (``accuracy``
      by default, ``eur``/``cost``/… work too) and the score of a save
      is that field's most recent non-None value in the driver's
      trailing stats window; pass a callable ``(driver, params, tag) →
      float`` for custom scoring.  Tags without a score are never
      retained as "best".

    GC deletes a pruned tag's npz *before* its json: `rounds()` only
    lists tags with both files present, so a crash between the two
    unlinks leaves a torn pair that is already invisible to `restore`
    (and cleaned up by the next GC) rather than a loadable half-pair.
    """

    def __init__(self, directory: str, keep: int = 3,
                 keep_last_n: Optional[int] = None, keep_best: int = 0,
                 best_metric="accuracy"):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep if keep_last_n is None else keep_last_n
        self.keep_best = keep_best
        self.best_metric = best_metric
        self._scores: Dict[int, Optional[float]] = {}

    # ---- write --------------------------------------------------------
    def _score(self, driver, params: Pytree, tag: int) -> Optional[float]:
        if not self.keep_best:
            return None
        if callable(self.best_metric):
            return self.best_metric(driver, params, tag)
        for stats in reversed(getattr(driver, "_recent_stats", [])):
            value = getattr(stats, self.best_metric, None)
            if value is not None:
                return float(value)
        return None

    def save(self, driver, params: Pytree, next_round: int) -> Path:
        """Snapshot `driver` + `params` under tag `next_round` (barrier
        modes: the first round a resumed run will execute; async mode:
        the snapshot index — resume continues mid-timeline)."""
        arrays: Dict[str, Pytree] = {}
        state = driver.checkpoint_state(arrays)
        state["schema"] = SCHEMA_VERSION
        state["next_round"] = int(next_round)
        score = self._score(driver, params, next_round)
        if score is not None:
            state["score"] = score
        self._scores[int(next_round)] = score
        # the pair descriptor ties the two files of one save together:
        # clock + charge count make it unique across re-saves of a tag
        pair = {"schema": SCHEMA_VERSION, "tag": int(next_round),
                "clock": float(driver.queue.clock.now),
                "charges": int(driver.cost.invocations)}
        state["pair"] = pair
        state["array_keys"] = sorted(arrays)

        entries = flatten_with_paths(params, "params")
        for key, tree in arrays.items():
            entries.update(flatten_with_paths(tree, f"extra{_SEP}{key}"))
        # one host copy a (device, dtype) for the whole snapshot: params,
        # server moments and every cached in-flight update together
        entries = dict(zip(entries, host_arrays(list(entries.values()))))
        entries[_META_KEY] = np.array(json.dumps(pair, sort_keys=True))
        _atomic_write_npz(self._params_path(next_round), entries)
        _atomic_write_text(self._state_path(next_round), json.dumps(state))
        self._gc()
        return self._state_path(next_round)

    # ---- read ---------------------------------------------------------
    def rounds(self) -> List[int]:
        out = []
        for f in self.dir.glob("round_*.json"):
            m = re.match(r"round_(\d+)\.json$", f.name)
            if m and self._params_path(int(m.group(1))).exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_round(self) -> Optional[int]:
        rounds = self.rounds()
        return rounds[-1] if rounds else None

    def restore(self, driver, like_params: Pytree,
                round_number: Optional[int] = None) -> Tuple[Pytree, int]:
        """Load the checkpoint (latest by default) into `driver` and
        return ``(params, next_round)`` (async checkpoints return
        ``next_round=0`` — the restored loop state carries the position).
        Every restored tensor lies on the device of ``like_params``.
        """
        rnd = round_number if round_number is not None else self.latest_round()
        if rnd is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        state = json.loads(self._state_path(rnd).read_text())
        for field, have in (("strategy", driver.strategy.name),
                            ("scheduler_name", driver.scheduler.name),
                            ("mode", driver.mode)):
            want = state.get(field)
            if want is not None and want != have:
                raise ValueError(
                    f"checkpoint was written with {field}={want!r}, "
                    f"driver runs {have!r}")
        schema = int(state.get("schema", 1))
        if schema > SCHEMA_VERSION:
            raise ValueError(
                f"checkpoint {self._state_path(rnd)} has schema {schema}; "
                f"this build reads up to {SCHEMA_VERSION}")
        if schema >= 2:
            params, arrays = self._load_arrays(rnd, state, like_params)
        else:
            # schema v1: params-only npz, no timeline snapshot — restores
            # with the old round-boundary semantics (in-flight invocations
            # at the boundary lose their future arrival)
            params, arrays = load_pytree(str(self._params_path(rnd)),
                                         like_params), {}
        driver.restore_state(state, arrays)
        if "async" in state:
            return params, 0
        return params, int(state["next_round"])

    def _load_arrays(self, rnd: int, state: dict, like_params: Pytree):
        with np.load(self._params_path(rnd), allow_pickle=False) as data:
            if _META_KEY not in data:
                raise ValueError(
                    f"checkpoint pair mismatch at tag {rnd}: "
                    f"{self._params_path(rnd).name} carries no pair "
                    f"descriptor (torn or foreign write)")
            meta = json.loads(str(data[_META_KEY]))
            if meta != state.get("pair"):
                raise ValueError(
                    f"checkpoint pair mismatch at tag {rnd}: the .json and "
                    f".npz descriptors disagree ({state.get('pair')} vs "
                    f"{meta}) — the pair is torn (crash mid-write?); "
                    f"delete it or resume from an older tag")
            params = unflatten_like(data, like_params, "params")
            # every extra tree shares the model-params structure (round
            # params, cached client updates, pending/buffered updates);
            # server-optimizer moments and compression error-feedback
            # residuals stay fp32 regardless of params dtype
            arrays = {key: unflatten_like(
                data, like_params, f"extra{_SEP}{key}",
                force_dtype=(torch.float32
                             if key.startswith(("server_opt/", "compress/"))
                             else None))
                for key in state.get("array_keys", [])}
        return params, arrays

    # ---- internals ----------------------------------------------------
    def _params_path(self, rnd: int) -> Path:
        return self.dir / f"round_{rnd:06d}.npz"

    def _state_path(self, rnd: int) -> Path:
        return self.dir / f"round_{rnd:06d}.json"

    def _score_of(self, rnd: int) -> Optional[float]:
        """Score of an on-disk tag (reads the json once; pre-existing
        tags written by an earlier process are scored from their file)."""
        if rnd not in self._scores:
            try:
                state = json.loads(self._state_path(rnd).read_text())
                self._scores[rnd] = state.get("score")
            except (OSError, ValueError):
                self._scores[rnd] = None
        return self._scores[rnd]

    def _gc(self) -> None:
        tags = self.rounds()
        if self.keep:
            survivors = set(tags[-self.keep:])
        elif self.keep_best:
            # keep_last_n=0 with best-K retention: best-only GC — an
            # empty trailing window, not the legacy keep-everything
            survivors = set()
        else:
            # bare keep=0 retains everything (historical `[:-0]` no-op)
            survivors = set(tags)
        if self.keep_best:
            scored = [(self._score_of(t), t) for t in tags]
            ranked = sorted((s, t) for s, t in scored if s is not None)
            survivors.update(t for _, t in ranked[-self.keep_best:])
        for rnd in tags:
            if rnd in survivors:
                continue
            # npz first: the tag disappears from rounds() immediately, so
            # a crash between the two unlinks can't leave a loadable
            # half-pair (torn-pair-safe deletion)
            self._params_path(rnd).unlink(missing_ok=True)
            self._state_path(rnd).unlink(missing_ok=True)
            self._scores.pop(rnd, None)
        # sweep orphan jsons a crashed GC left behind (npz-before-json
        # order means a lone json is always GC litter, never a mid-save)
        for f in self.dir.glob("round_*.json"):
            m = re.match(r"round_(\d+)\.json$", f.name)
            if m and not self._params_path(int(m.group(1))).exists():
                f.unlink(missing_ok=True)
