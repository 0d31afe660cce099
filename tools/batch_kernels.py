#!/usr/bin/env python3
"""Time a batch's set-up and teardown kernels (``csrc/batch.cu``) on the card.

    python3 tools/batch_kernels.py [--tree DIR ...] [--pods P ...] [--turns N]

For each tree in turns (``--tree``: a checkout of the repository, an
unpacked older commit or a variant; default this one), builds only
``csrc/batch.cu`` and times, on batch 3 of ``chip_smoke.py``'s kernel
checks' fixture (``rich_fixture``: cpuset-bound pods, gangs) at each
``--pods`` P, the three launches a headline batch makes: the set-up (the
rollback's fields and the loop state with the sorted fields), the un-sort (``batch_teardown``,
on the plain set-up's outputs) and the output row (``batch_outputs``);
``--only`` times only the kernels named (a variant whose set-up stops
early, say). Prints one JSON line a tree and
turn: CUDA-event ms a call (``chip_smoke.cuda_ms``, 200 calls) and device
ms (``chip_smoke.device_ms``), with the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def load_port(tree: Path):
    """The port's modules of ``tree`` (the previous tree's dropped)."""
    for name in [m for m in sys.modules if m.startswith("koordinator_tpu_torch")]:
        del sys.modules[name]
    sys.path.insert(0, str(tree))
    try:
        kernels = importlib.import_module("koordinator_tpu_torch.kernels")
        solver = importlib.import_module("koordinator_tpu_torch.ops.solver")
    finally:
        sys.path.remove(str(tree))
    return kernels, solver


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", nargs="+", default=[str(ROOT)])
    ap.add_argument("--pods", nargs="+", type=int, default=[512])
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--only", nargs="+", default=None,
                    help="time only these kernels (batch_setup, batch_teardown, batch_outputs)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=False).stdout.strip()
    dev = torch.device("cuda")
    trees = [Path(t).resolve() for t in args.tree]
    for tree in trees:
        load_port(tree)[0].build(["batch"])
    for turn in range(args.turns):
        for tree in trees if turn % 2 == 0 else trees[::-1]:
            kernels, solver = load_port(tree)
            for p in args.pods:
                nodes, pods, _ = smoke.rich_fixture(1, 2000, 4 * p, batch=p)
                pods_s = solver.PodBatch.create(
                    device=dev, **{k: torch.from_numpy(v.reshape((4, p) + v.shape[1:]))
                                   for k, v in pods.items()})
                index = torch.tensor([3], device=dev)
                setup = solver.batch_setup_plain(pods_s, index)
                amp = torch.from_numpy(nodes["cpu_amp"]).to(dev)
                rows_b = 1024
                outs = (torch.zeros((rows_b, p), dtype=torch.int32, device=dev),
                        torch.zeros(rows_b, dtype=torch.int32, device=dev),
                        torch.zeros(rows_b, dtype=torch.int32, device=dev), None, None)
                at = torch.zeros(1, dtype=torch.int64, device=dev)
                calls = [0]

                def outputs():
                    calls[0] += 1
                    if calls[0] % (rows_b - 8) == 0:  # the index stays inside the rows
                        at.zero_()
                    solver.batch_outputs(outs, at, setup.assigned, None, setup.state[1], None)

                fns = {
                    "batch_setup": (lambda: solver.batch_setup(pods_s, index),
                                    "batch_setup_kernel"),
                    "batch_teardown": (lambda: solver.batch_teardown(setup, amp, None),
                                       "unsort_kernel"),
                    "batch_outputs": (outputs, "outputs_kernel"),
                }
                row = {}
                for name, (fn, kname) in fns.items():
                    if args.only and name not in args.only:
                        continue
                    row[name] = dict(ms=smoke.cuda_ms(torch, fn, 200),
                                     device_ms=smoke.device_ms(torch, fn, 50, kname))
                print(json.dumps(dict(tree=str(tree), turn=turn, pods=p, card=card, **row)),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
