# ruff: noqa
"""CON003 fixture: one kernel with every part, and two that lack some."""
from .good import good_kernel, good_kernel_plain, good_kernel_sharded
from .orphan import orphan_kernel
from .unbound import unbound_kernel, unbound_kernel_plain

KERNELS = (good_kernel,                 # allowed: plain, csrc/good.cu, test
           good_kernel_sharded,         # allowed: maps to good_kernel_plain
           orphan_kernel,               # line 9: CON003 (plain, .cu, test)
           unbound_kernel)              # line 10: CON003 (library, test)

__all__ = ["KERNELS", "good_kernel", "good_kernel_plain",
           "good_kernel_sharded", "orphan_kernel", "unbound_kernel",
           "unbound_kernel_plain"]
