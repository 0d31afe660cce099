#!/usr/bin/env python3
"""Where the shortlist round kernel spends its cycles, phase by phase.

    python3 tools/shortlist_phases.py [--modes plain masked numa devices] [--built]
                                      [--variant NAME ...] [--tree DIR]
    python3 tools/shortlist_phases.py --ptxas [--tree DIR]

For each instantiation of ``csrc/shortlist_round.cu`` (``plain``, ``masked``:
the node mask, ``numa``: the zone terms, ``devices``: the device terms), on
the kernel-check fixture the smoke times it on (``chip_smoke.rich_fixture``
at P = 512, N = 10,000, D = 2, K = 64: batch 0; the one-hot quota tree's
masks after ``chip_smoke.QUOTA_LATER`` batches; the NUMA and device
fixtures after 3 batches, LeastAllocated), prints one JSON line with:

- the built kernel's CUDA-event ms a call (100 calls) and its
  ``torch.profiler`` device ms (``chip_smoke.device_ms``);
- the floor any launch pays: the same call with the round loop's ``done``
  set (the kernel returns at once) in a CUDA graph of 100 launches, event
  ms a launch, and the smoke's empty trip (``chip_smoke.empty_trip_ms``:
  nomination's two kernels and the round tail after the fixed point);
- unless ``--built``: the SM cycles of each phase, from a copy of the
  kernel in which lane 0 of every warp reads ``clock64()`` after the
  ``done`` check, at each phase comment of the kernel ("// s1. ...") and
  at the kernel's end, run through the tree's own ``shortlist_round`` with
  the copy loaded in place of its library. The copy's outputs must equal
  the built kernel's. Each phase is reported over the warps that ran it:
  the median and the largest. A tree whose kernel has no phase comments
  gets them at the lines of the design they mark (pricing, top-k, the
  exactness check, the flags and the count ticket).

``--variant NAME ...`` also times the design's alternatives
(:data:`VARIANTS`: the tree's kernel with one knob changed, only D = 2
built), each against the built kernel's outputs: its event and device ms
a call beside the built kernel's, in the same process.

``--ptxas`` prints the registers and spill bytes of every instantiation
of the tree's kernel (``-Xptxas -v``).

``--tree DIR`` runs another tree's package and smoke (a commit unpacked
with ``git archive``): run OLD NEW NEW OLD in one call to compare two
trees. Needs a CUDA device and ``nvcc``; the copies are built under the
tree's ``koordinator_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

#: clock slots a warp: the start, the phase comments s1-s8, the end
SLOTS = 10
MARK = ("if ((threadIdx.x & 31) == 0 && blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5) < "
        "{cap}) koord_sl_clock[((size_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) "
        "* {slots} + {k}] = clock64();")

#: the design's alternatives: name -> (text of the kernel, its replacement)
VARIANTS = {
    "one_warp_a_pod": [("constexpr int kPodWarps = 2;", "constexpr int kPodWarps = 1;"),
                       ("constexpr int kBlockPods = 4;", "constexpr int kBlockPods = 8;")],
    "one_warp_four_pods": [("constexpr int kPodWarps = 2;", "constexpr int kPodWarps = 1;")],
    "eight_pods_a_block": [("constexpr int kBlockPods = 4;", "constexpr int kBlockPods = 8;")],
    "two_pods_a_block": [("constexpr int kBlockPods = 4;", "constexpr int kBlockPods = 2;")],
    "table_cols": [("      const LoadedCols<D> col(a.nodes, pod.mask, n);",
                    "      const TableCols<D> col{a.nodes, pod.mask, n};")],
}


def build_copy(kernels, src: str, name: str) -> "ctypes.CDLL":
    """``src`` built with the port's flags as ``lib<name>.so`` and loaded,
    with the shortlist round's C signature."""
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"{name}.cu"
    so = kernels.BUILD / f"lib{name}.so"
    cu.write_text(src)
    build = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
    if build.returncode != 0:
        raise SystemExit(f"FAIL: {name} did not build\n{build.stdout}{build.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in kernels.SIGNATURES["shortlist_round"].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    lib.koord_error_string.argtypes = [ctypes.c_int]
    lib.koord_error_string.restype = ctypes.c_char_p
    return lib


def ptxas(kernels) -> dict:
    """Registers and spill bytes (stores and loads) of every instantiation
    of ``shortlist_round_kernel`` in the tree's ``-Xptxas -v`` log, the
    source built first: ``<D,C,flags>`` with the flags of the template
    (numa, devices)."""
    kernels.build(["shortlist_round"])
    rows, entry = {}, None
    for line in kernels.build_log("shortlist_round").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)", line)
        if m:
            k = re.search(r"shortlist_round_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E", m.group(1))
            entry = None
            if k:
                on = [f for f, b in zip(("numa", "devices"), k.groups()[2:]) if b == "1"]
                entry = f"<{k.group(1)},{k.group(2)}{''.join(',' + f for f in on)}>"
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            rows.setdefault(entry, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rows.setdefault(entry, {})["registers"] = int(m.group(1))
    return rows


def only_d2(src: str) -> str:
    return re.sub(r"\n\s*case (\d): return op\.template run<\d>\(\);",
                  lambda m: m.group(0) if m.group(1) == "2" else "", src)


#: a kernel without phase comments: (line it starts with, comment put before it)
ANCHORS = (
    ("    const int* cand = a.cand + (size_t)p * a.K;", "// s1. pricing"),
    ("    const bool cand_any = __any_sync(kFull, finite);", "// s2. top-k"),
    ("    if (lane == 0) {\n      // exact when", "// s3. the exactness check"),
    ("  __syncthreads();\n  if (tid != 0) return;", "// s4. the block's barrier"),
    ("  if (tid != 0) return;\n#pragma unroll", "// s5. the flags and the count ticket"),
)


def instrumented(src: str, warps_cap: int) -> "tuple[str, list[str]]":
    """The source with the clock marks, only D = 2 instantiated; and the
    phases' names by slot."""
    src = only_d2(src)
    if "// s1. " not in src:
        for line, comment in ANCHORS:
            if line not in src:
                raise SystemExit(f"FAIL: the kernel has no phase comments nor the line {line!r}")
            indent = line[: len(line) - len(line.lstrip())]
            src = src.replace(line, f"{indent}{comment}\n{line}", 1)
    at = src.index("shortlist_round_kernel(")
    body = src.index("{", at)
    depth, end = 0, body
    for end in range(body, len(src)):
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        if depth == 0:
            break
    head, kernel, tail = src[:at], src[at:end], src[end:]
    names = ["start"] + [""] * (SLOTS - 2) + ["end"]
    out = []
    for line in kernel.splitlines(keepends=True):
        m = re.match(r"(\s+)// s(\d)\. (.*)", line)
        if m:
            k = int(m.group(2))
            out.append(m.group(1) + MARK.format(cap=warps_cap, slots=SLOTS, k=k) + "\n")
            names[k] = re.split(r" \(|:|,", m.group(3))[0]
        out.append(line)
        if line.strip() == "if (a.state[0] != 0) return;":
            out.append("  " + MARK.format(cap=warps_cap, slots=SLOTS, k=0) + "\n")
    kernel = "".join(out) + "  " + MARK.format(cap=warps_cap, slots=SLOTS, k=SLOTS - 1) + "\n"
    first = head.index("namespace {")
    decl = f"__device__ long long koord_sl_clock[{warps_cap * SLOTS}];\n"
    read = ('\nextern "C" int koord_sl_read(long long* out, int n) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_sl_clock, sizeof(long long) * n);\n}\n"
            'extern "C" int koord_sl_clear(int n) {\n'
            "  static long long zero[%d];\n"
            "  return (int)cudaMemcpyToSymbol(koord_sl_clock, zero, sizeof(long long) * n);\n}\n"
            % (warps_cap * SLOTS))
    return head[:first] + decl + head[first:] + kernel + tail + read, names


def cases(torch, chip_smoke, solver, sl, dev, modes):
    """Each mode's (nom_args, build kwargs, round kwargs) at P = 512."""
    out = {}
    fixture = chip_smoke.rich_fixture(1, chip_smoke.N_NODES, 16 * chip_smoke.BATCH)
    if "plain" in modes:
        nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, *fixture, dev)
        batch = solver.tree_map(lambda a: a[: chip_smoke.BATCH], pods_t)
        _, nom_args = chip_smoke.round_inputs(batch, nodes_t, params_t)
        out["plain"] = (nom_args, {}, {})
    if "masked" in modes:
        pods_s, nodes_t, params_t, quotas, mask = chip_smoke.quota_port_inputs(
            torch, "onehot", fixture, dev)
        _, nodes_t, _, later = solver.solve_stream(
            solver.tree_map(lambda a: a[: chip_smoke.QUOTA_LATER], pods_s), nodes_t, params_t,
            quotas=quotas, **chip_smoke.SOLVE)
        at = chip_smoke.QUOTA_LATER
        batch = solver.tree_map(lambda a: a[at], pods_s)
        _, nom_args, smask, _ = chip_smoke.quota_round_case(
            torch, batch, nodes_t, params_t, later.used, mask[at], quotas.runtime)
        out["masked"] = (nom_args, {"mask": smask}, {"mask": smask})
    if "numa" in modes:
        nodes_z, pods_z, params_z, numa_z = chip_smoke.numa_port_inputs(torch, dev)
        pods_zs = solver.tree_map(lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]),
                                  pods_z)
        zf = numa_z.zone_free
        for b in range(3):
            res = solver.assign(solver.tree_map(lambda a: a[b], pods_zs), nodes_z, params_z,
                                numa=numa_z, numa_carry=zf, **chip_smoke.SOLVE)
            nodes_z = chip_smoke.dataclasses.replace(
                nodes_z, requested=res.node_requested, estimated_used=res.node_estimated_used,
                prod_used=res.node_prod_used)
            zf = res.node_zone_free
        _, nom_args, terms, _ = chip_smoke.numa_round_case(
            torch, solver.tree_map(lambda a: a[3], pods_zs), nodes_z, zf, numa_z, params_z, 1)
        out["numa"] = (nom_args, {"zones": terms}, {"zones": terms})
    if "devices" in modes:
        nodes_d, pods_d, params_d, dev_d = chip_smoke.device_port_inputs(torch, dev)
        pods_ds = solver.tree_map(lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]),
                                  pods_d)
        carry = solver._dev_carry0(dev_d, nodes_d.allocatable.shape[0])
        for b in range(3):
            res = solver.assign(solver.tree_map(lambda a: a[b], pods_ds), nodes_d, params_d,
                                devices=dev_d, dev_carry=carry, device_scoring="LeastAllocated",
                                **chip_smoke.SOLVE)
            nodes_d = chip_smoke.dataclasses.replace(
                nodes_d, requested=res.node_requested, estimated_used=res.node_estimated_used,
                prod_used=res.node_prod_used)
            carry = (res.node_dev_slots, res.node_rdma_free, res.node_fpga_free)
        _, nom_args, terms = chip_smoke.device_round_case(
            torch, solver.tree_map(lambda a: a[3], pods_ds), nodes_d, carry, dev_d, params_d, 1)
        out["devices"] = (nom_args, {"devices": terms}, {"devices": terms})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", nargs="+", default=["plain", "masked", "numa", "devices"],
                    choices=["plain", "masked", "numa", "devices"])
    ap.add_argument("--built", action="store_true",
                    help="only the built kernel's times, no instrumented copy")
    ap.add_argument("--variant", nargs="+", default=[], choices=sorted(VARIANTS),
                    help="also time these alternatives of the design")
    ap.add_argument("--ptxas", action="store_true",
                    help="only print every instantiation's registers and spills")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="the tree whose package, kernels and smoke run (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    import chip_smoke
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import shortlist as sl
    from koordinator_tpu_torch.ops import solver

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    if args.ptxas:
        print(json.dumps({"tree": str(args.tree), "shortlist_round": ptxas(kernels)}), flush=True)
        return 0
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    # a tree whose round tail folds the counts takes no counts here
    takes_counts = "counts" in inspect.signature(sl.shortlist_round).parameters
    warps_cap = 4096
    lib = names = None
    source = (kernels.CSRC / "shortlist_round.cu").read_text()
    if not args.built:
        src, names = instrumented(source, warps_cap)
        lib = build_copy(kernels, src, "shortlist_phases")
        lib.koord_sl_read.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
    variants = {}
    for name in args.variant:
        src = only_d2(source)
        for old, new in VARIANTS[name]:
            if old not in src:
                print(f"FAIL: the kernel has no {old!r} for variant {name}", file=sys.stderr)
                return 1
            src = src.replace(old, new)
        variants[name] = build_copy(kernels, src, f"shortlist_variant_{name}")
    empty_trip = None
    for mode, (nom_args, build_kw, round_kw) in cases(torch, chip_smoke, solver, sl, dev,
                                                      args.modes).items():
        plan = sl.shortlist_build(*nom_args[:4], *nom_args[5:], chip_smoke.SHORTLIST_K, 4.0,
                                  **build_kw)
        p = nom_args[0].shape[0]

        def fresh(done=0):
            word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
            counts = torch.zeros(2, dtype=torch.int32, device=dev)
            state = torch.tensor([done, 0], dtype=torch.int32, device=dev)
            return word, counts, state

        def run(word, counts, state):
            tail = (word, counts, state) if takes_counts else (word, state)
            return sl.shortlist_round(*nom_args, *plan, 4, 4.0, True, *tail, **round_kw)

        want = fresh()
        want_top = [t.clone() for t in run(*want)]
        bufs = fresh()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        run(*bufs)
        torch.cuda.synchronize()
        start.record()
        for _ in range(100):
            run(*bufs)
        end.record()
        torch.cuda.synchronize()
        row = {"tree": str(args.tree), "mode": mode, "pods": p, "card": smi,
               "event_ms_per_call": start.elapsed_time(end) / 100,
               "device_ms_per_call": chip_smoke.device_ms(torch, lambda: run(*bufs), 50,
                                                          "shortlist_round_kernel")}
        # the floor: the same launch returning at once, 100 in a graph
        idle = fresh(done=1)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run(*idle)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            for _ in range(100):
                run(*idle)
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        row["empty_launch_event_ms"] = chip_smoke.cuda_ms(torch, graph.replay, 10) / 100
        if empty_trip is None:
            top = nominate_ops.nominate(*nom_args, 4, 4.0, True, **round_kw)
            rt = chip_smoke.round_tail_args(torch, _sorted_pods(nom_args), nom_args, *top)
            empty_trip = chip_smoke.empty_trip_ms(torch, nom_args, rt)
        row["empty_trip_event_ms"] = empty_trip
        saved = kernels._libs.get("shortlist_round")
        for name, vlib in variants.items():
            kernels._libs["shortlist_round"] = vlib
            try:
                got = fresh()
                top = run(*got)
                same = all(torch.equal(x, y) for x, y in zip(top, want_top))
                if not (same and all(torch.equal(x, y) for x, y in zip(got, want))):
                    print(f"FAIL: {mode}: variant {name} differs from the built kernel")
                    return 1
                vb = fresh()
                run(*vb)
                torch.cuda.synchronize()
                start.record()
                for _ in range(100):
                    run(*vb)
                end.record()
                torch.cuda.synchronize()
                row.setdefault("variants", {})[name] = {
                    "event_ms_per_call": start.elapsed_time(end) / 100,
                    "device_ms_per_call": chip_smoke.device_ms(
                        torch, lambda: run(*vb), 50, "shortlist_round_kernel")}
            finally:
                kernels._libs["shortlist_round"] = saved
        if lib is not None:
            saved = kernels._libs.get("shortlist_round")
            kernels._libs["shortlist_round"] = lib
            blocks = []
            try:
                for _ in range(20):
                    lib.koord_sl_clear(warps_cap * SLOTS)
                    got = fresh()
                    top = run(*got)
                    torch.cuda.synchronize()
                    same = all(torch.equal(a, b) for a, b in zip(top, want_top))
                    same = same and all(torch.equal(a, b) for a, b in zip(got, want))
                    if not same:
                        print(f"FAIL: {mode}: the instrumented kernel differs from the built one")
                        return 1
                    buf = (ctypes.c_longlong * (warps_cap * SLOTS))()
                    if lib.koord_sl_read(buf, warps_cap * SLOTS) != 0:
                        print("FAIL: could not read the clocks")
                        return 1
                    blocks.append(np.array(buf, dtype=np.int64).reshape(warps_cap, SLOTS))
            finally:
                kernels._libs["shortlist_round"] = saved
            c = np.concatenate(blocks[5:])
            phases = {}
            used = [k for k in range(SLOTS) if (c[:, k] != 0).any()]
            for a, b in zip(used, used[1:]):
                ok = (c[:, a] != 0) & (c[:, b] != 0)
                d = c[ok, b] - c[ok, a]
                phases[f"{names[a]} -> {names[b]}"] = dict(
                    warps=int(ok.sum()) // len(blocks[5:]), median=int(np.median(d)),
                    max=int(d.max()))
            whole = (c[:, 0] != 0) & (c[:, SLOTS - 1] != 0)
            phases["start -> end (the warps that reach the end)"] = dict(
                warps=int(whole.sum()) // len(blocks[5:]),
                median=int(np.median(c[whole, SLOTS - 1] - c[whole, 0])),
                max=int((c[whole, SLOTS - 1] - c[whole, 0]).max()))
            row["cycles_by_phase"] = phases
        print(json.dumps(row), flush=True)
    return 0


def _sorted_pods(nom_args):
    """The fields ``chip_smoke.round_tail_args`` reads of the sorted pods."""
    from types import SimpleNamespace

    return SimpleNamespace(requests=nom_args[0], estimate=nom_args[1], is_prod=nom_args[2],
                           valid=nom_args[4])


if __name__ == "__main__":
    sys.exit(main())
