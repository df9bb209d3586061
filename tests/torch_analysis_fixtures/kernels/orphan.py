# ruff: noqa
"""CON003 fixture: a wrapper whose library has no csrc/ source."""
from . import build


def _library():
    return build.bind("missing", {})


def orphan_kernel(x):
    return _library()
