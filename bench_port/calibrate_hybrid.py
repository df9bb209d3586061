"""``calibrate.py`` for the hybrid train cell: the same readings, the
control and the faults worked out by ``drivers/train_hybrid.readings``.

    python3 bench_port/calibrate_hybrid.py --workload <cell> --seeds <n> ...
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench_port import calibrate  # noqa: E402
from bench_port.drivers import train_hybrid  # noqa: E402

if __name__ == "__main__":
    calibrate.train_readings = train_hybrid.readings
    sys.exit(calibrate.main())
