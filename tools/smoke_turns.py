#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two trees in turns and compare their passes.

    python3 tools/smoke_turns.py --tree OLD NEW [--phase NAME ...] [--logs DIR] [--timeout S]
                                 [--turns 2]

Each tree (this checkout, or another commit unpacked with ``git archive``)
first builds its kernels, both trees at once; then each tree's
``chip_smoke.py`` runs from its own root in turns, OLD NEW NEW OLD (with
``--turns 2`` OLD NEW, where a call has time for two), each
run's output kept in ``DIR/turn<i>_<tree name>.log`` (default
``smoke_turns/`` in this checkout, git-ignored). For every run it prints
the run's exit code and the median of the timed passes of each stream
line the smoke prints (the headline and shortlist streams, the quota,
NUMA and device streams, s a pass on the card), with its rounds and
placed pods. Two versions are
compared only inside one call on one card (PERF.md). With ``--phase``
each turn runs only the named phases of the tree's smoke (for example
``phase_quota_streams``: the four quota streams with their golden and
plain checks), in order, in one process; ``phase_stream`` needs
``phase_kernels`` before it and ``phase_shortlist_stream`` needs
``phase_stream``, as ``chip_smoke.main`` runs them. Needs a CUDA device; the smoke's
own checks decide whether a run passed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: the stream lines of the smoke whose cells are named under their key
NAMED = ("quota_stream", "numa_stream", "device_stream")
KINDS = ("stream", "shortlist_stream") + NAMED


def passes(log: Path) -> dict:
    """Each stream cell of a smoke log: (median pass s, rounds, placed)."""
    out = {}
    for line in log.read_text().splitlines():
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except ValueError:
            continue
        for kind in KINDS:
            if kind not in obj:
                continue
            cells = obj[kind] if kind in NAMED else {"": obj[kind]}
            for name, cell in cells.items():
                if isinstance(cell, dict) and "pass_seconds" in cell:
                    ps = sorted(cell["pass_seconds"])
                    out[f"{kind} {name}".strip()] = (ps[len(ps) // 2], cell.get("rounds_used"),
                                                     cell.get("placed"))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, nargs=2, required=True)
    ap.add_argument("--logs", type=Path, default=ROOT / "smoke_turns")
    ap.add_argument("--timeout", type=int, default=1100)
    ap.add_argument("--turns", type=int, choices=[2, 4], default=4)
    ap.add_argument("--phase", nargs="+", default=None,
                    help="run only these phase functions of chip_smoke.py (phase_...)")
    args = ap.parse_args()
    args.logs.mkdir(parents=True, exist_ok=True)
    trees = [t.resolve() for t in args.tree]
    build = ("from koordinator_tpu_torch import kernels; import json; "
             "print(json.dumps({k: round(v, 1) for k, v in kernels.build().items()}))")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=t, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for t in trees]
    for tree, proc in zip(trees, procs):
        out, _ = proc.communicate()
        print(f"build {tree.name}: rc {proc.returncode} {out.strip()[-400:]}", flush=True)
        if proc.returncode != 0:
            return 1
    worst = 0
    for i, tree in enumerate((trees[0], trees[1], trees[1], trees[0])[: args.turns], 1):
        log = args.logs / f"turn{i}_{tree.name}.log"
        t0 = time.perf_counter()
        with log.open("w") as f:
            cmd = [sys.executable, "chip_smoke.py"]
            if args.phase:
                # the headline stream takes phase_kernels' trip inputs, the
                # shortlist stream the headline's result, as main() hands them
                cmd = [sys.executable, "-c",
                       "import sys, torch, chip_smoke; dev = torch.device('cuda'); "
                       "report = {'kernels': []}; out = {}\n"
                       f"for name in {args.phase!r}:\n"
                       "    extra = {'phase_stream': ('phase_kernels',),\n"
                       "             'phase_shortlist_stream': ('phase_stream',)}.get(name, ())\n"
                       "    out[name] = getattr(chip_smoke, name)(torch, dev, report,\n"
                       "                                          *(out[e] for e in extra))"]
            rc = subprocess.run(cmd, cwd=tree, stdout=f,
                                stderr=subprocess.STDOUT, timeout=args.timeout).returncode
        print(json.dumps({"turn": i, "tree": str(tree), "rc": rc,
                          "seconds": round(time.perf_counter() - t0, 1)}), flush=True)
        for cell, (med, rounds, placed) in passes(log).items():
            print(f"  {cell}: median {med:.5f} s, rounds {rounds}, placed {placed}", flush=True)
        worst = max(worst, rc)
    return worst


if __name__ == "__main__":
    sys.exit(main())
