"""FedLesScan in PyTorch: the port of the JAX package ``repro`` to CUDA.

Same layout as ``repro`` (core/, faas/, fl/, data/, models/, optim/,
kernels/, launch/); the hot kernels are hand-written CUDA C++ under
csrc/, built at first use (kernels/build.py).  Entry points run on the
card unless the caller passes ``device="cpu"``.  Nothing here imports
JAX or the ``repro`` package.
"""
