# ruff: noqa
"""DET003 fixture: builtin hash() used for seed derivation."""


def client_seed(client_id):
    return hash(client_id) % 2**32      # line 6: DET003
