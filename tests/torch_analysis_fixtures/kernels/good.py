# ruff: noqa
"""CON003 fixture: a wrapper module binding csrc/good.cu."""
from . import build


def _library():
    return build.bind("good", {})


def good_kernel_plain(x):
    return x


def good_kernel(x):
    return good_kernel_plain(x) if x.device.type == "cpu" else _library()


def good_kernel_sharded(x, mesh):
    return good_kernel(x)
