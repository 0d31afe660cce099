#!/usr/bin/env python3
"""Where the round-tail kernel spends its cycles, phase by phase.

    python3 tools/round_phases.py [--pods 512 4096] [--quota none onehot sorted] [--zones]
                                  [--crowded] [--devices] [--big] [--built] [--tree DIR]
                                  [--variant split1]
    python3 tools/round_phases.py --ptxas [--tree DIR]

Builds a copy of the round tail (``koordinator_tpu_torch/csrc/round.cuh``
with the entry of ``round.cu``, or with ``--zones`` of ``round_zone.cu``)
in which thread 0 reads ``clock64()`` at the start of the kernel, before
each phase comment of ``round_tail_kernel`` ("// 1. ...", "// 4-5. ...",
"// Z. ...", "// 7d. ...") and before the state word is written, then runs it on
the card on round 0 of ``chip_smoke.py``'s kernel-check fixture (batch 0,
and the first P / 512 batches as one round for P > 512, N = 10,000,
D = 2), through the tree's own ``commit.round_tail`` with the copy loaded
in place of the entry's library. Each run's tables, assignments, active
flags and state word (and quota and zone tables) must equal the built
kernel's; the script prints, for each P, the median over 15 runs of the
SM cycles from the kernel's start to each mark, and the CUDA-event time
of a call.
``--quota`` names the rounds to run: ``none`` (the default), or a tree of
``chip_smoke.QUOTA_TREES`` (its chains, and the tables and quota state
after ``chip_smoke.QUOTA_LATER`` batches, where the quotas bind; phase 6
is then the quota commit). ``--zones`` runs the rounds with NUMA zones
(``chip_smoke.numa_port_inputs``, LeastAllocated pricing, after 3
batches); with ``--crowded`` instead this checkout's
``chip_smoke.crowded_zone_inputs`` (every pod nominating one of four
SINGLE_NUMA_NODE nodes: segments of about P / 4 zone candidates), and
``--crowded`` without ``--zones`` the same rounds with the zones off
(segments of about P / 4 rows through the node commit).
``--devices`` runs the rounds with devices
(``chip_smoke.device_port_inputs``: G = 16, RDMA and FPGA; LeastAllocated
pricing, after 3 batches; phases "D." and "7d." are the device
acceptance and charges), without quotas. ``--big`` runs the device-memory
entry, ``round_big.cu``: round 0 of the big batch
(``chip_smoke.big_port_inputs``, D = 4, ``--pods`` 8,192 to 32,768,
``--quota`` none or sorted) as phase 10 of the smoke sets it up, or with
``--zones`` the zone rounds of 8,192 to 32,768 pods; with ``--built``
also 65,536 (the round tail routes it to ``round_huge.cu``). The quota
commit's, the zone phase's and the node commit's cycles are also given by
sub-phase ("// q1. ...", "// z1. ...", "// n1. ...": the cycles from there
to the next mark, summed over the chain's levels, kept in shared memory
so that a mark costs a few cycles). Only the width the fixture uses is
instantiated in the copy. ``--variant NAME`` builds the copy with a design
of ``VARIANTS`` in place of the source's.
``--built`` times the tree's own round tail instead
(``commit.round_tail``, no instrumentation): the CUDA-event time of a
call and the ``torch.profiler`` device time of the round tail kernel.
``--tree DIR`` runs another tree's package and smoke (a commit unpacked
with ``git archive``; the crowded rounds come from this checkout's
smoke): run OLD NEW NEW OLD in one call to compare two trees.
``--ptxas`` builds the tree's round sources and prints the registers and
spill bytes of every ``round_tail_kernel`` instantiation and of the
quota commit's and the zone phase's own frames. Needs a CUDA device and
``nvcc``; the copy is built under the tree's
``koordinator_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

MARK = "if (threadIdx.x == 0) koord_phase_clock[{}] = clock64();"


#: a sub-phase mark: thread 0 adds the cycles since the last mark to the
#: current sub-phase's sum, in shared memory (a few cycles, where a
#: device-memory sum would stall the thread on its loads); the sums reach
#: device memory when the state word is written
QUOTA_MARK = ("if (threadIdx.x == 0) {{ const long long t_ = clock64(); "
              "koord_qs_cycles[koord_qs_cur] += t_ - koord_qs_t; "
              "koord_qs_t = t_; koord_qs_cur = {}; }}")


def instrumented(src: str, keep_d: "int | None" = None) -> "tuple[str, list[str], list[str]]":
    """The source with a clock read before each numbered phase comment of
    the kernel and before the state word's write, and, inside the quota
    commit, cycles summed over its levels by each lettered sub-phase
    comment ("// q1. ...": the cycles from there to the next mark); and
    the marks' and the sub-phases' names. With ``keep_d`` only that width
    is instantiated (``with_d``'s other cases go), which cuts the build."""
    if keep_d is not None:
        src = re.sub(r"\n\s*case (\d): return op\.template run<\d>\(\);",
                     lambda m: m.group(0) if int(m.group(1)) == keep_d else "", src)
    head = ("__device__ long long koord_phase_clock[32];\n"
            "__device__ long long koord_quota_cycles[32];\n"
            "__shared__ long long koord_qs_cycles[32];\n"
            "__shared__ long long koord_qs_t;\n"
            "__shared__ int koord_qs_cur;\n")
    # the marks' shared words come out of the round's own shared memory
    src = src.replace("max_smem() - sizeof(ScanLevels) - kWarps * sizeof(int);",
                      "max_smem() - sizeof(ScanLevels) - kWarps * sizeof(int) - 256;")
    quota_at = src.index("__device__ void quota_commit(")
    body_at = src.index("round_tail_kernel(")
    sub_names, out_q = ["outside"], []
    for line in src[quota_at:body_at].splitlines(keepends=True):
        m = re.match(r"(\s+)// ([qz]\d+)\. (.*)", line)
        if m:
            out_q.append(m.group(1) + QUOTA_MARK.format(len(sub_names)) + "\n")
            sub_names.append(f"{m.group(2)}. {re.split(r' \(|:|,', m.group(3))[0]}")
        out_q.append(line)
    names, out, k = ["start"], [], 1
    for line in src[body_at:].splitlines(keepends=True):
        m = re.match(r"(\s+)// (n\d+)\. (.*)", line)
        if m:
            out.append(m.group(1) + QUOTA_MARK.format(len(sub_names)) + "\n")
            sub_names.append(f"{m.group(2)}. {re.split(r' \(|:|,', m.group(3))[0]}")
        m = re.match(r"  // (\d+(?:-\d+)?[a-z]?|[A-Z])\. (.*)", line)
        if m:
            out.append("  " + MARK.format(k) + "\n")
            out.append("  " + QUOTA_MARK.format(0) + "\n")
            names.append(f"{m.group(1)}. {re.split(r' \(|:|,', m.group(2))[0]}")
            k += 1
        if line.startswith("  if (state[0] != 0) return;"):
            out.append(line)
            out.append("  " + MARK.format(0) + "\n")
            out.append("  if (threadIdx.x == 0) { for (int i_ = 0; i_ < 32; ++i_) "
                       "koord_qs_cycles[i_] = 0; koord_qs_t = clock64(); "
                       "koord_qs_cur = 0; }\n")
            continue
        if line.startswith("    state[1] = state[1] + 1;"):
            out.append("    " + MARK.format(k) + "\n")
            out.append("    for (int i_ = 0; i_ < 32; ++i_) koord_quota_cycles[i_] = "
                       "koord_qs_cycles[i_];\n")
            names.append("state written")
        out.append(line)
    read = ('\nextern "C" int koord_phase_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_phase_clock, sizeof(long long) * 32);\n}\n"
            'extern "C" int koord_quota_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_quota_cycles, sizeof(long long) * 32);\n}\n")
    first = src.index("namespace {")
    return (src[:first] + head + src[first:quota_at] + "".join(out_q) + "".join(out) + read,
            names, sub_names)


def big_round(torch, chip_smoke, solver, nominate_ops, p: int, tree, dev):
    """Round 0 of the big batch of ``p`` pods (``chip_smoke.big_port_inputs``,
    with the sorted tree when ``tree``), set up as phase 10 of the smoke
    sets it: the round tail's arguments and (chain, runtime, used, gate)
    or None."""
    from koordinator_tpu_torch.ops import quota as quota_ops

    pods_t, nodes_t, params_t, quotas = chip_smoke.big_port_inputs(torch, p, bool(tree), dev)
    _, spods, bind, thr, pthr = solver._round_setup(pods_t, nodes_t, params_t,
                                                    quota=bool(tree))
    gate = spods.valid.clone()
    nom_args = (spods.requests, spods.estimate, spods.is_prod, bind, gate,
                nodes_t.allocatable, nodes_t.requested, nodes_t.estimated_used,
                nodes_t.prod_used, nodes_t.metric_fresh, nodes_t.schedulable,
                nodes_t.cpu_amp, thr, pthr, params_t.score_weights)
    quota = None
    if tree:
        quota_ops.quota_gate_plain(spods.valid, spods.requests, spods.quota_chain,
                                   quotas.runtime, quotas.used, gate)
        quota = (spods.quota_chain, quotas.runtime, quotas.used.clone(), gate.clone())
    top = nominate_ops.nominate(*nom_args, 4, 4.0, True)
    return chip_smoke.round_tail_args(torch, spods, nom_args, *top), quota


#: designs measured against the source's own in the instrumented copy
#: (``--variant``): a name and its (text, replacement) pairs
VARIANTS = {
    # the node sort at one row a thread by the radix split too, not the
    # sort of the keys in registers
    "split1": [("  if (R == 1) {\n    // one key a thread", "  if (R == 0) {\n    // one key a thread")],
}

#: the round tail's sources, each a set of its instantiations
ROUND_SOURCES = ("round", "round_zone", "round_dev", "round_zone_dev", "round_big", "round_huge")


def ptxas(kernels) -> dict:
    """Registers and spill bytes (stores and loads) of every instantiation
    of ``round_tail_kernel`` and of the phases' own frames (``*_apart``:
    the quota commit, the zone phase) in each round source's ``-Xptxas -v`` log,
    the sources built first (all at once): ``<D,R,flags>`` with the flags
    of the template (quota, zone, device memory, devices)."""
    kernels.build(list(ROUND_SOURCES))
    flags = ("quota", "zone", "device memory", "devices")
    out = {}
    for src in ROUND_SOURCES:
        rows, entry = {}, None
        for line in kernels.build_log(src).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)",
                          line)
            if m:
                name = m.group(1)
                k = re.search(r"round_tail_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)ELb(\d)ELb(\d)E",
                              name)
                a = re.search(r"\d+([a-z][a-z_]*_apart)ILi(\d+)ELi(\d+)E", name)
                entry = None
                if k:
                    on = [f for f, b in zip(flags, k.groups()[2:]) if b == "1"]
                    entry = f"<{k.group(1)},{k.group(2)}{''.join(',' + f for f in on)}>"
                elif a:
                    entry = f"{a.group(1)}<{a.group(2)},{a.group(3)}>"
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                rows.setdefault(entry, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                rows.setdefault(entry, {})["registers"] = int(m.group(1))
        out[src] = rows
    return out


def zone_tuple(zone, free, picks, side_abi: bool) -> tuple:
    """The round tail's zone argument over a working copy's table and
    picks: the tree's own form (with the side table when its round tail
    takes one)."""
    return (free,) + tuple(zone[1:5]) + (picks,) + (tuple(zone[6:7]) if side_abi else ())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", type=int, nargs="+", default=[512, 4096])
    ap.add_argument("--quota", choices=["none", "onehot", "sorted"], nargs="+",
                    default=["none"], help="the rounds to run: without quotas, or a tree")
    ap.add_argument("--zones", action="store_true", help="the rounds with NUMA zones")
    ap.add_argument("--crowded", action="store_true",
                    help="the crowded rounds (chip_smoke.crowded_zone_inputs; without --zones "
                         "the same rounds with the zones off)")
    ap.add_argument("--devices", action="store_true", help="the rounds with devices")
    ap.add_argument("--big", action="store_true",
                    help="the device-memory entry round_big.cu: the big batch's round 0 "
                         "(chip_smoke.big_port_inputs, D=4; --quota none or sorted) or with "
                         "--zones the zone rounds")
    ap.add_argument("--variant", choices=sorted(VARIANTS),
                    help="the instrumented copy with this design in place of the source's")
    ap.add_argument("--ptxas", action="store_true",
                    help="only print every round tail instantiation's registers and spills")
    ap.add_argument("--built", action="store_true",
                    help="time the tree's built round tail, not the instrumented copy")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="the tree whose package, kernels and smoke run (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import importlib.util
    import inspect

    import numpy as np
    import torch

    import chip_smoke
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import solver

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    if args.ptxas:
        print(json.dumps({"tree": str(args.tree), **ptxas(kernels)}), flush=True)
        return 0
    # the crowded rounds come from this checkout's smoke, whatever the tree
    spec = importlib.util.spec_from_file_location("smoke_fixture", ROOT / "chip_smoke.py")
    fixtures = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = fixtures
    spec.loader.exec_module(fixtures)
    # a tree whose round tail reads the nodes' side table takes it in the zone tuple
    side_abi = "pod_zone, side = zone" in inspect.getsource(commit_ops.round_tail)
    entry = "round_zone" if args.zones else "round"
    if args.devices and (kernels.CSRC / f"{entry}_dev.cu").exists():
        entry += "_dev"  # the instantiations with the device phase
    if args.big:
        entry = "round_big"
        if args.devices or "onehot" in args.quota or (args.zones and args.quota != ["none"]):
            print("FAIL: --big runs without devices, --quota none or sorted (none with --zones)",
                  file=sys.stderr)
            return 1
    lib = None
    if not args.built:
        header = (kernels.CSRC / "round.cuh").read_text()
        for text, repl in VARIANTS.get(args.variant, []):
            if text not in header:
                print(f"FAIL: the variant {args.variant} does not apply to this tree",
                      file=sys.stderr)
                return 1
            header = header.replace(text, repl)
        src, names, sub_names = instrumented(
            (kernels.CSRC / f"{entry}.cu").read_text().replace('#include "round.cuh"', header),
            4 if args.big and not args.zones and not args.crowded else 2)
        kernels.BUILD.mkdir(parents=True, exist_ok=True)
        cu = kernels.BUILD / "round_phases.cu"
        so = kernels.BUILD / "libround_phases.so"
        cu.write_text(src)
        build = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                                "-o", str(so), str(cu)],
                               capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stdout + build.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        for name, argtypes in kernels.SIGNATURES[entry].items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.koord_error_string.argtypes = [ctypes.c_int]
        lib.koord_error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda")
    fixture = chip_smoke.rich_fixture(1, chip_smoke.N_NODES, 16 * chip_smoke.BATCH)
    zone_case = None
    if args.zones and not args.crowded:
        # the NUMA kernel check's state: three batches committed
        extra = max(args.pods) if args.big else 16 * chip_smoke.BATCH
        nodes_z, pods_z, params_z, numa_z = chip_smoke.numa_port_inputs(
            torch, dev, n_pods=max(16 * chip_smoke.BATCH, 3 * chip_smoke.BATCH + extra))
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
        zone_case = (nodes_z, pods_zs, params_z, numa_z, zf)
    dev_case = None
    if args.devices:
        # the device kernel check's state: three batches committed
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
        dev_case = (nodes_d, pods_ds, params_d, dev_d, carry)
    for mode in args.quota:
        tree = None if mode == "none" else mode
        quota = None
        zone = None
        if sum(map(bool, (tree, args.zones, dev_case))) > 1:
            print("FAIL: --zones and --devices each run without quotas, and not together",
                  file=sys.stderr)
            return 1
        if args.big or args.zones:
            pass
        elif tree:
            pods_s, nodes_t, params_t, quotas, mask = chip_smoke.quota_port_inputs(
                torch, tree, fixture, dev)
            _, nodes_t, _, later = solver.solve_stream(
                solver.tree_map(lambda a: a[:chip_smoke.QUOTA_LATER], pods_s), nodes_t, params_t,
                quotas=quotas, **chip_smoke.SOLVE)
        elif not dev_case:
            nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, *fixture, dev)
            pods_s = solver.tree_map(lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]), pods_t)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=False).stdout.strip()
        for p in args.pods:
            rt = None
            if args.crowded:
                rt, _, zone = fixtures.crowded_zone_inputs(torch, dev, p)
                zone = zone if args.zones else None
            elif args.big and not args.zones and not args.crowded:
                rt, quota = big_round(torch, chip_smoke, solver, nominate_ops, p, tree, dev)
            elif tree:
                # the batch after the later state; above 512 pods, the first
                # P / 512 batches as one round, as the smoke checks them
                b = max(1, p // chip_smoke.BATCH)
                at = chip_smoke.QUOTA_LATER if b == 1 else 0
                batch = solver.tree_map(lambda a: a[at : at + b].reshape((-1,) + a.shape[2:]),
                                        pods_s)
                masks = mask[at : at + b]
                spods, nom_args, smask, quota = chip_smoke.quota_round_case(
                    torch, batch, nodes_t, params_t, later.used, masks.reshape(b * chip_smoke.BATCH, -1),
                    quotas.runtime)
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True, mask=smask)
            elif dev_case:
                nodes_d, pods_ds, params_d, dev_d, carry = dev_case
                b = max(1, p // chip_smoke.BATCH)
                batch = solver.tree_map(lambda a: a[3 : 3 + b].reshape((-1,) + a.shape[2:]),
                                        pods_ds)
                spods, nom_args, terms = chip_smoke.device_round_case(
                    torch, batch, nodes_d, carry, dev_d, params_d, 1)
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True,
                                                          devices=terms)
            elif zone_case:
                nodes_z, pods_zs, params_z, numa_z, zf = zone_case
                b = max(1, p // chip_smoke.BATCH)
                batch = solver.tree_map(lambda a: a[3 : 3 + b].reshape((-1,) + a.shape[2:]),
                                        pods_zs)
                spods, nom_args, terms, zone = chip_smoke.numa_round_case(
                    torch, batch, nodes_z, zf, numa_z, params_z, 1)
                if len(zone) < 7:
                    zone = tuple(zone) + (terms.side,)
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True, zones=terms)
            else:
                batch = solver.tree_map(
                    lambda a: a[: max(1, p // chip_smoke.BATCH)].reshape((-1,) + a.shape[2:]),
                    pods_s)
                spods, nom_args = chip_smoke.round_inputs(batch, nodes_t, params_t)
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True)
            if rt is None:
                rt = chip_smoke.round_tail_args(torch, spods, nom_args, top_cost, top_idx)
            if quota is not None:
                rt += [quota[2], quota[3]]  # the used table and the gate, updated in place
            if zone is not None:
                rt += [zone[0], zone[5]]  # the zone table and the picks, updated in place
            if dev_case:
                # the tables the device phase charges, updated in place
                rt += [terms.slots, terms.stats] + [t for t in (terms.rdma, terms.fpga)
                                                    if t is not None]
            want = [t.clone() for t in rt]

            def dev_of(work):
                if not dev_case:
                    return None
                rest = iter(work[17:])
                return chip_smoke.dataclasses.replace(
                    terms, slots=next(rest), stats=next(rest),
                    rdma=None if terms.rdma is None else next(rest),
                    fpga=None if terms.fpga is None else next(rest))

            def built(work):
                commit_ops.round_tail(
                    *work[:17], 0.35,
                    quota=None if quota is None else (quota[0], quota[1], *work[17:]),
                    zone=None if zone is None else zone_tuple(zone, work[17], work[18], side_abi),
                    dev=dev_of(work))

            built(want)
            if args.built:
                copies = [[t.clone() for t in rt] for _ in range(101)]
                built(copies[0])
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for work in copies[1:]:
                    built(work)
                end.record()
                torch.cuda.synchronize()
                # each call on fresh copies (the copies' kernels are not counted)
                device = chip_smoke.device_ms(torch, lambda: built([t.clone() for t in rt]), 50,
                                              "round_tail_kernel")
                extra = {}
                if zone is not None:
                    # the same round without zones: the zone phase's own
                    # time is the difference
                    def bare():
                        commit_ops.round_tail(*[t.clone() for t in rt[:17]], 0.35)

                    extra["device_ms_without_zones"] = chip_smoke.device_ms(
                        torch, bare, 50, "round_tail_kernel")
                print(json.dumps({
                    "tree": str(args.tree), "pods": p, "quota": tree, "big": args.big,
                    "zones": zone is not None, "crowded": args.crowded,
                    "devices": dev_case is not None, "card": smi,
                    "event_ms_per_call": start.elapsed_time(end) / 100,
                    "device_ms_per_call": device, **extra,
                }), flush=True)
                continue

            def call(work):
                # the tree's own wrapper, with the copy in place of the entry's library
                saved = kernels._libs.get(entry)
                kernels._libs[entry] = lib
                try:
                    built(work)
                finally:
                    if saved is None:
                        kernels._libs.pop(entry, None)
                    else:
                        kernels._libs[entry] = saved

            clocks, sub = [], []
            for _ in range(20):
                work = [t.clone() for t in rt]
                torch.cuda.synchronize()
                call(work)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(work, want)):
                    print(f"FAIL: P={p}: the instrumented kernel differs from round_tail")
                    return 1
                buf = (ctypes.c_longlong * 32)()
                if lib.koord_phase_read(buf) != 0:
                    print("FAIL: could not read the phase clocks")
                    return 1
                clocks.append(list(buf)[: len(names)])
                qbuf = (ctypes.c_longlong * 32)()
                if lib.koord_quota_read(qbuf) != 0:
                    print("FAIL: could not read the quota sub-phase cycles")
                    return 1
                sub.append(list(qbuf)[: len(sub_names)])
            c = np.array(clocks[5:], dtype=np.int64)
            cycles = np.median(c - c[:, :1], axis=0)
            sub_cycles = np.median(np.array(sub[5:], dtype=np.int64), axis=0)
            copies = [[t.clone() for t in rt] for _ in range(101)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            call(copies[0])
            torch.cuda.synchronize()
            start.record()
            for work in copies[1:]:
                call(work)
            end.record()
            torch.cuda.synchronize()
            print(json.dumps({
                "tree": str(args.tree), "pods": p, "quota": tree, "big": args.big,
                "zones": zone is not None, "crowded": args.crowded, "card": smi,
                "variant": args.variant, "cycles_from_start": {name: int(v) for name, v in zip(names, cycles)},
                **({"quota_cycles_by_subphase": {name: int(v) for name, v in
                                                 zip(sub_names[1:], sub_cycles[1:])
                                                 if name.startswith("q")}}
                   if tree else {}),
                **({"zone_cycles_by_subphase": {name: int(v) for name, v in
                                                zip(sub_names[1:], sub_cycles[1:])
                                                if name.startswith("z")}}
                   if zone is not None else {}),
                **({"node_cycles_by_subphase": {name: int(v) for name, v in
                                                zip(sub_names[1:], sub_cycles[1:])
                                                if name.startswith("n")}}
                   if any(name.startswith("n") for name in sub_names) else {}),
                "event_ms_per_call": start.elapsed_time(end) / 100,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
