#!/usr/bin/env python3
"""Show how whole ``chip_smoke.device_ms``' profiled windows are.

    python3 tools/profiler_windows.py [--phases kernels,quota,cost]

Builds the port's kernels and runs the named kernel phases of
``chip_smoke.py`` (``kernels``: phase 3, ``quota``: the quota kernels,
``cost``: the cost-transform kernels) on the card. Each device-time
reading of those phases is logged by ``chip_smoke.device_ms``: its kernel
name filter, the matching kernels seen in two one-call windows and in
each window of ``iters`` calls, and, for a window that is not whole, the
kernels it did hold by name. Prints each reading as one JSON line, then
one line with the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

PHASES = {
    "kernels": lambda torch, dev, report: chip_smoke.phase_kernels(torch, dev, report),
    "quota": lambda torch, dev, report: chip_smoke.phase_quota_kernels(torch, dev, report),
    "cost": lambda torch, dev, report: chip_smoke.phase_cost_transform_kernels(torch, dev,
                                                                             report),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default="kernels,quota,cost")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    from koordinator_tpu_torch import kernels

    kernels.build()
    dev = torch.device("cuda")
    report: dict = {}
    for name in args.phases.split(","):
        start = len(chip_smoke.DEVICE_WINDOWS)
        PHASES[name](torch, dev, report)
        for reading in chip_smoke.DEVICE_WINDOWS[start:]:
            print(json.dumps(dict(phase=name, **reading)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
