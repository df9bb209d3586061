# ruff: noqa
"""Pragma fixture: every violation suppressed on its own line, each
pragma with its reason beside it."""
import random

import torch


def seed(cid):
    return hash(cid)  # repro-lint: disable=DET003 — fixture: by rule id


def jitter():
    return random.random()  # repro-lint: disable=unseeded-random — by slug


def noise():
    return torch.randn(2)  # repro-lint: disable=DET001 — fixture: torch draw
