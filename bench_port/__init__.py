"""The benchmark of the PyTorch port (``repro_torch``) on NVIDIA cards.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Each cell of ``BENCHMARK.json`` names a configuration
(``bench_port/configs/<config>.json``) and a traffic mix
(``bench_port/traffic/<traffic>.json``); the mix's ``kind`` picks the
driver (``bench_port/drivers/<kind>.py``), and each per-layer metric is
read by ``bench_port/metrics/<metric>.py``.  The limits that decide
``correct`` sit in ``bench_port/limits/<cell>.json``.  The plain
reference (``bench_port/reference/``) imports nothing of the port.
"""
