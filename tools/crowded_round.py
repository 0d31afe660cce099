#!/usr/bin/env python3
"""The round tail's device time on rounds whose pods crowd onto a few nodes.

    python3 tools/crowded_round.py [--tree DIR] [--iters 20]

Imports ``koordinator_tpu_torch`` from ``DIR`` (default: this checkout; an
unpacked older commit compares two versions, in turns inside one call),
builds its kernels and runs ``chip_smoke.crowded_round_inputs``' rounds
(``chip_smoke.CROWDED_ROUNDS``: every pod nominates one of four GPU nodes,
512 and 4,096 pods in shared memory, 8,192 with quotas and zones and
32,768 in device memory) through ``ops/commit.py:round_tail`` with the
device phase on the card. Each round is first held against
``round_tail_plain`` on CPU copies (tables, loop state, slots, stats, RDMA
and FPGA bitwise equal), then timed: the device time of a call of the
round-tail kernel (``chip_smoke.device_ms``, each call on fresh copies of
the tables it charges). Prints one JSON line a round with the card's name
and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="root of the tree whose port to run")
    ap.add_argument("--iters", type=int, default=20, help="calls a timed window")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke_fixture", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = smoke  # its dataclasses look their module up
    spec.loader.exec_module(smoke)
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops

    if not str(Path(commit_ops.__file__).resolve()).startswith(str(tree)):
        print(f"FAIL: imported {commit_ops.__file__}, not the port of {tree}", file=sys.stderr)
        return 1
    kernels.build()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    for p, both in smoke.CROWDED_ROUNDS:
        args_t, terms, q, z = smoke.crowded_round_inputs(torch, dev, p, quota=both, zones=both)
        pairs, _, _, _ = smoke.device_round_both(torch, args_t, terms, q, z)
        torch.cuda.synchronize()
        differ = [name for name, a, b in pairs if not smoke.bits_equal(a.cpu(), b)]
        if differ:
            print(f"FAIL: P={p}: the round tail differs from its plain version in {differ}")
            return 1
        mut = smoke.ROUND_MUTABLE
        fixed = args_t[:mut.start]

        def fresh():
            return ([t.clone() for t in args_t[mut]], smoke.device_terms_copy(terms),
                    None if q is None else (q[0], q[1], q[2].clone(), q[3].clone()),
                    None if z is None else (z[0].clone(),) + z[1:5] + (z[5].clone(),) + z[6:])

        copies = iter([fresh() for _ in range(4 * args.iters + 8)])

        def call():
            m, d, qq, zz = next(copies)
            commit_ops.round_tail(*fixed, *m, 0.35, quota=qq, zone=zz, dev=d)

        ms = smoke.device_ms(torch, call, args.iters, "round_tail_kernel")
        print(json.dumps(dict(tree=str(tree), card=smi, pods=p, quotas_and_zones=both,
                              device_ms=ms)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
