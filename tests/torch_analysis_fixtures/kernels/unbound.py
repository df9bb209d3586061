# ruff: noqa
"""CON003 fixture: a wrapper module that binds no library."""


def unbound_kernel_plain(x):
    return x


def unbound_kernel(x):
    return x
