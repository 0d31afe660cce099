#!/usr/bin/env python3
"""Where the round-tail kernel spends its cycles, phase by phase.

    python3 tools/round_phases.py [--pods 512 4096] [--quota none onehot sorted] [--zones]
                                  [--devices]

Builds a copy of the round tail (``koordinator_tpu_torch/csrc/round.cuh``
with the entry of ``round.cu``, or with ``--zones`` of ``round_zone.cu``)
in which thread 0 reads ``clock64()`` at the start of the kernel, before
each phase comment of ``round_tail_kernel`` ("// 1. ...", "// 4-5. ...",
"// Z. ...", "// 7d. ...") and before the state word is written, then runs it on
the card on round 0 of ``chip_smoke.py``'s kernel-check fixture (batch 0,
and the first P / 512 batches as one round for P > 512, N = 10,000,
D = 2). Each run's tables, assignments, active flags and state word (and
quota and zone tables) must equal the built kernel's (``round_tail``); the
script prints, for each P, the median over 15 runs of the SM cycles from
the kernel's start to each mark, and the CUDA-event time of a call.
``--quota`` names the rounds to run: ``none`` (the default), or a tree of
``chip_smoke.QUOTA_TREES`` (its chains, and the tables and quota state
after ``chip_smoke.QUOTA_LATER`` batches, where the quotas bind; phase 6
is then the quota commit). ``--zones`` runs the rounds with NUMA zones
(``chip_smoke.numa_port_inputs``, LeastAllocated pricing, after 3
batches). ``--devices`` runs the rounds with devices
(``chip_smoke.device_port_inputs``: G = 16, RDMA and FPGA; LeastAllocated
pricing, after 3 batches; phases "D." and "7d." are the device
acceptance and charges), without quotas. The quota commit's and the zone phase's cycles are also given by
sub-phase ("// q1. ...", "// z1. ...": the cycles from there to the next
mark, summed over the chain's levels). Needs a CUDA device and ``nvcc``;
the copy is built under ``koordinator_tpu_torch/build/``.
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


QUOTA_MARK = ("if (threadIdx.x == 0) {{ const long long t_ = clock64(); "
              "koord_quota_cycles[koord_quota_cur] += t_ - koord_quota_t; "
              "koord_quota_t = t_; koord_quota_cur = {}; }}")


def instrumented(src: str) -> "tuple[str, list[str], list[str]]":
    """The source with a clock read before each numbered phase comment of
    the kernel and before the state word's write, and, inside the quota
    commit, cycles summed over its levels by each lettered sub-phase
    comment ("// q1. ...": the cycles from there to the next mark); and
    the marks' and the sub-phases' names."""
    head = ("__device__ long long koord_phase_clock[32];\n"
            "__device__ long long koord_quota_cycles[16];\n"
            "__device__ long long koord_quota_t;\n"
            "__device__ int koord_quota_cur;\n")
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
        m = re.match(r"  // (\d+(?:-\d+)?[a-z]?|[A-Z])\. (.*)", line)
        if m:
            out.append("  " + MARK.format(k) + "\n")
            out.append("  " + QUOTA_MARK.format(0) + "\n")
            names.append(f"{m.group(1)}. {re.split(r' \(|:|,', m.group(2))[0]}")
            k += 1
        if line.startswith("  if (state[0] != 0) return;"):
            out.append(line)
            out.append("  " + MARK.format(0) + "\n")
            out.append("  if (threadIdx.x == 0) { for (int i_ = 0; i_ < 16; ++i_) "
                       "koord_quota_cycles[i_] = 0; koord_quota_t = clock64(); "
                       "koord_quota_cur = 0; }\n")
            continue
        if line.startswith("    state[1] = state[1] + 1;"):
            out.append("    " + MARK.format(k) + "\n")
            names.append("state written")
        out.append(line)
    read = ('\nextern "C" int koord_phase_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_phase_clock, sizeof(long long) * 32);\n}\n"
            'extern "C" int koord_quota_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_quota_cycles, sizeof(long long) * 16);\n}\n")
    first = src.index("namespace {")
    return (src[:first] + head + src[first:quota_at] + "".join(out_q) + "".join(out) + read,
            names, sub_names)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pods", type=int, nargs="+", default=[512, 4096])
    ap.add_argument("--quota", choices=["none", "onehot", "sorted"], nargs="+",
                    default=["none"], help="the rounds to run: without quotas, or a tree")
    ap.add_argument("--zones", action="store_true", help="the rounds with NUMA zones")
    ap.add_argument("--devices", action="store_true", help="the rounds with devices")
    args = ap.parse_args()

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
    entry = "round_zone" if args.zones else "round"
    header = (kernels.CSRC / "round.cuh").read_text()
    src, names, sub_names = instrumented(
        (kernels.CSRC / f"{entry}.cu").read_text().replace('#include "round.cuh"', header))
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
    fn = getattr(lib, f"koord_{entry.replace('round', 'round_tail')}")
    fn.argtypes = kernels.SIGNATURES[entry][fn.__name__]
    dev = torch.device("cuda")
    fixture = chip_smoke.rich_fixture(1, chip_smoke.N_NODES, 16 * chip_smoke.BATCH)
    zone_case = None
    if args.zones:
        # the NUMA kernel check's state: three batches committed
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
        if sum(map(bool, (tree, zone_case, dev_case))) > 1:
            print("FAIL: --zones and --devices each run without quotas, and not together",
                  file=sys.stderr)
            return 1
        if tree:
            pods_s, nodes_t, params_t, quotas, mask = chip_smoke.quota_port_inputs(
                torch, tree, fixture, dev)
            _, nodes_t, _, later = solver.solve_stream(
                solver.tree_map(lambda a: a[:chip_smoke.QUOTA_LATER], pods_s), nodes_t, params_t,
                quotas=quotas, **chip_smoke.SOLVE)
        else:
            nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, *fixture, dev)
            pods_s = solver.tree_map(lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]), pods_t)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=False).stdout.strip()
        for p in args.pods:
            batch = solver.tree_map(
                lambda a: a[: max(1, p // chip_smoke.BATCH)].reshape((-1,) + a.shape[2:]), pods_s
            )
            if tree:
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
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True, zones=terms)
            else:
                spods, nom_args = chip_smoke.round_inputs(batch, nodes_t, params_t)
                top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True)
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

            commit_ops.round_tail(
                *want[:17], 0.35, quota=None if quota is None else (quota[0], quota[1], *want[17:]),
                zone=None if zone is None else (want[17],) + zone[1:5] + (want[18],),
                dev=dev_of(want))
            n, d = nom_args[5].shape
            q_cap, levels = (0, 0) if quota is None else (quota[1].shape[0], quota[0].shape[1])

            def call(work):
                q_ptrs = ([None] * 4 if quota is None else
                          [quota[0].data_ptr(), quota[1].data_ptr(), work[17].data_ptr(),
                           work[18].data_ptr()])
                z_args = [] if zone is None else [
                    work[17].data_ptr(), zone[1].data_ptr(), zone[2].data_ptr(),
                    zone[3].data_ptr(), zone[4].data_ptr(), work[18].data_ptr(),
                    zone[1].shape[1], zone[1].shape[2]]
                d_args = commit_ops.checked_round_devices(dev_of(work), work[0], p, n)
                code = fn(*[t.data_ptr() for t in work[:17]], ctypes.c_float(0.35), p, n, d, 4,
                          *q_ptrs, q_cap, levels, *z_args, *d_args, kernels.stream_of(work[0]))
                if code != 0:
                    raise RuntimeError(f"round_phases: CUDA error {code}")

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
                qbuf = (ctypes.c_longlong * 16)()
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
                "pods": p, "quota": tree, "zones": zone is not None, "card": smi,
                "cycles_from_start": {name: int(v) for name, v in zip(names, cycles)},
                **({"quota_cycles_by_subphase": {name: int(v) for name, v in
                                                 zip(sub_names[1:], sub_cycles[1:])
                                                 if name.startswith("q")}}
                   if tree else {}),
                **({"zone_cycles_by_subphase": {name: int(v) for name, v in
                                                zip(sub_names[1:], sub_cycles[1:])
                                                if name.startswith("z")}}
                   if zone is not None else {}),
                "event_ms_per_call": start.elapsed_time(end) / 100,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
