# ruff: noqa
"""CON003 fixture: the parity surface of the fixture kernels.

It names good_kernel, good_kernel_sharded and their plain version
good_kernel_plain, and no other fixture kernel.  It holds no test.
"""
