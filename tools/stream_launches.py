#!/usr/bin/env python3
"""Count what one pass of the headline stream launches and syncs.

    python3 tools/stream_launches.py [--tree DIR] [--shortlist-k K] [--passes N] [--gaps]

Imports ``koordinator_tpu_torch`` from ``DIR`` (default: this checkout; an
unpacked older commit of the repository compares two versions), builds its
kernels, and runs ``chip_smoke.py``'s headline stream (``bench.py``'s
fixture and parameters: 98,304 pods, 10,000 nodes, 192 batches of 512;
with ``--shortlist-k`` the candidate shortlist of that size) on the card:
one warm-up pass, then

- one pass under ``torch.profiler``: kernels and copies that ran on the
  device, their busy milliseconds, and the host's launch calls
  (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaGraphLaunch``) as the
  profiler sees them;
- one pass under ``torch.cuda.set_sync_debug_mode("warn")``: the host
  syncs PyTorch reports inside ``solve_stream``, and the pass's wall time;
- with ``--passes N``, N more passes timed on the host clock (each ends
  in the caller's read of the placed counts), to compare two trees in
  turns inside one call;
- with ``--gaps``, the profiled pass's idle time on the device between
  consecutive kernels, summed by the pair of kernel names around each gap
  (the ten largest sums): where a pass's wall time exceeds its busy time.

Prints one JSON line with the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

HOST_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cudaLaunchKernelExC", "cuLaunchKernelEx")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(ROOT), help="root of the tree whose port to run")
    ap.add_argument("--shortlist-k", type=int, default=None,
                    help="run the stream with the candidate shortlist of this size")
    ap.add_argument("--passes", type=int, default=0, help="timed passes after the counts")
    ap.add_argument("--gaps", action="store_true",
                    help="sum the device's idle gaps by the kernels around them")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("smoke_fixture", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    solve = dict(smoke.SOLVE)
    if args.shortlist_k is not None:
        solve["shortlist_k"] = args.shortlist_k
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    if not str(Path(solver.__file__).resolve()).startswith(str(tree)):
        print(f"FAIL: imported {solver.__file__}, not the port of {tree}", file=sys.stderr)
        return 1
    kernels.build()
    dev = torch.device("cuda")
    nodes, pods, params = smoke.headline_inputs(smoke.build_fixture(0))
    nodes_t, pods_t, params_t = smoke.port_inputs(torch, nodes, smoke.stacked(pods), params, dev)
    inputs = (pods_t, nodes_t, params_t)

    def run():
        out = solver.solve_stream(*inputs, **solve)
        return int(out[2].sum())

    run()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        placed = run()
        torch.cuda.synchronize()
    device_kernels = copies = host_launches = 0
    busy_us = 0.0
    intervals = []
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            busy_us += evt.time_range.elapsed_us()
            intervals.append((evt.time_range.start, evt.time_range.end, evt.name.split("(")[0][-40:]))
            if evt.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                device_kernels += 1
        elif evt.name in HOST_LAUNCHES:
            host_launches += 1

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = solver.solve_stream(*inputs, **solve)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    placed_after = int(out[2].sum())
    seconds = time.perf_counter() - t0
    syncs = sum(smoke.is_sync_warning(w) for w in caught)
    passes = []
    for _ in range(args.passes):
        t0 = time.perf_counter()
        run()
        passes.append(time.perf_counter() - t0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip()
    gaps, gap_ms = {}, 0.0
    if args.gaps:
        intervals.sort()
        for (_, end, before), (start, _, after) in zip(intervals, intervals[1:]):
            if start > end:
                key = f"{before} -> {after}"
                gaps[key] = gaps.get(key, 0.0) + (start - end) / 1e3
        gap_ms = sum(gaps.values())
        gaps = dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:10])
    print(json.dumps(dict(
        tree=str(tree), card=smi, shortlist_k=args.shortlist_k, placed=placed,
        placed_again=placed_after,
        device_kernels=device_kernels, device_copies=copies,
        device_busy_ms=busy_us / 1e3, host_launch_calls=host_launches,
        host_syncs=syncs, sync_pass_seconds=seconds, pass_seconds=passes,
        **({"gap_ms_by_kernels": gaps, "gap_ms": gap_ms} if args.gaps else {}),
    )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
