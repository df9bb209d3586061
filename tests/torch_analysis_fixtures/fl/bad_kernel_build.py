# ruff: noqa
"""TORCH003 fixture: libraries built or bound outside their one place,
and torch.compile inside a round-path function."""
import ctypes
import subprocess

import torch

from ..kernels import build

_STEP = torch.compile(lambda b: b)      # allowed: module scope


def _library():
    return build.bind("good", {})       # allowed: a module-level _library()


def run_round(train_fn, batch):
    step = torch.compile(train_fn)      # line 19: TORCH003 (compile a round)
    lib = build.bind("good", {})        # line 20: TORCH003 (bind per call)
    return step(batch), lib


def load_by_hand(path, src):
    subprocess.run(["nvcc", "-shared", "-o", path, src])  # line 25: TORCH003
    build.build(["good"])               # line 26: TORCH003
    return ctypes.CDLL(path)            # line 27: TORCH003


class Trainer:
    def __init__(self, fn):
        self.step = torch.compile(fn)   # allowed: construction time
