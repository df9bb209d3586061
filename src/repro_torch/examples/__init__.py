"""The JAX package's example CLIs over ``repro_torch``, one module each,
run as ``python -m repro_torch.examples.<name>``:

  quickstart           FedLesScan vs FedAvg on an MNIST-like CNN
  straggler_study      strategies × straggler ratios on the speech CNN
  scheduler_study      four cohort schedulers (exit 1 when apodotiko's EUR
                       falls below fedlesscan's)
  async_study          sync vs semi-async vs barrier-free modes, server
                       optimizers, compressed updates, a repeated trace
  crash_recovery_smoke SIGKILL a checkpointing child run, resume, compare
  federated_pretrain   a reduced decoder (mamba2-130m) as the FL payload
  serve_decode         prefill, then decode from the cache

Each takes its reference's flags and defaults, plus ``--device`` (``cuda``
unless told ``cpu``), prints the reference's lines, and writes its files
where the reference does (``results/<study>/`` of the repository; the
paths are module constants, ``OUT``).
"""
from pathlib import Path

REPO = Path(__file__).resolve().parents[3]
RESULTS = REPO / "results"
