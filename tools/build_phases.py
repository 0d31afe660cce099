#!/usr/bin/env python3
"""How the shortlist build's time splits between pricing and selection.

    python3 tools/build_phases.py [--tree DIR ...] [--pods 512 4096] [--k 64]
                                  [--terms plain numa devices]

For each tree (default: this checkout; another commit unpacked with
``git archive``), builds two copies of its ``csrc/shortlist_build.cu``:
the build as it is, and a price-only copy that prices every pair as the
build does and returns (the text ``// A.`` marks the cut, or, in a build
that keeps every key of a pod in shared memory, ``// radix select``; the
keys are folded into a value the kernel could write, so the compiler keeps
the pricing). Runs both on
the card on ``chip_smoke.py``'s kernel-check fixture (round 0 of batch 0,
or the first P / 512 batches as one build for P > 512; N = 10,000, D = 2,
K = 64) with the jitter on and off, and with ``--terms`` the NUMA and
device instantiations (the jitter on), checks the whole copy against the
plain build, and prints, for each tree and case, the device time of a
call of each copy (``chip_smoke.device_ms``, a window of 50 calls):
pricing, and the rest, the selection. The trees run in turns.
Needs a CUDA device and ``nvcc``; the copies are built under
``koordinator_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: where each design's selection starts, and the cut's code there: fold
#: the pairs' keys into a value the kernel could write, then return
CUTS = (
    ("  // A. ", "  { uint32_t x_ = 0; for (int n_ = w0 + lane; n_ < w1; n_ += 32) "
                "x_ ^= (uint32_t)(key_at(n_) >> 32); if (x_ == 0x9E3779B9u) "
                "a.out_bound[0] = 0.0f; return; }\n"),
    ("  // radix select of the key", "  { uint32_t x_ = 0; for (int i_ = threadIdx.x; i_ < N; "
                                    "i_ += blockDim.x) x_ ^= costs[i_]; if (x_ == 0x9E3779B9u) "
                                    "a.out_bound[0] = 0.0f; return; }\n"),
)


def price_only(src: str) -> str:
    """The source with the kernel cut after pricing."""
    for mark, cut in CUTS:
        at = src.find(mark)
        if at >= 0:
            return src[:at] + cut + src[at:]
    raise SystemExit("build_phases: no selection mark in shortlist_build.cu")


#: clock marks of the current design, block 0: before A., B., C., the
#: candidates' write
MARKS = ("  // A. ", "  // B. ", "  // C. ", "  int* out = a.out_cand")


#: where a buffer's overflow is compacted (B.)
OVERFLOW = "      // the buffer keeps its K+1 lowest"


def with_clocks(src: str) -> str:
    """The source with block 0's thread 0 reading clock64() at each mark of
    MARKS present (and at the kernel's start), every block's cycles from
    its start to its last mark and its count of overflow compactions, and
    their readers."""
    head = ("__device__ long long koord_build_clock[8];\n"
            "__device__ long long koord_block_cycles[1 << 16];\n"
            "__device__ int koord_block_overflows[1 << 16];\n")
    start = "  const int p = blockIdx.x;\n"
    if MARKS[0] not in src or start not in src:
        return src
    mark = "  if (blockIdx.x == 0 && threadIdx.x == 0) koord_build_clock[{}] = clock64();\n"
    src = src.replace(start, start + "  const long long t0_ = clock64();\n" + mark.format(0), 1)
    for i, m in enumerate(MARKS, 1):
        at = src.find(m)
        if at >= 0:
            src = src[:at] + mark.format(i) + src[at:]
    at = src.find(MARKS[-1])
    src = (src[:at] + "  if (threadIdx.x == 0) koord_block_cycles[blockIdx.x] = clock64() - t0_;\n"
           + src[at:])
    at = src.find(OVERFLOW)
    if at >= 0:
        src = (src[:at] + "      if ((threadIdx.x & 31) == 0) atomicAdd(&koord_block_overflows["
               "blockIdx.x], 1);\n" + src[at:])
    first = src.index("namespace {")
    return (src[:first] + head + src[first:] + '\nextern "C" int koord_build_clock_read(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, koord_build_clock, sizeof(long long) * 8);\n}\n"
            'extern "C" int koord_build_blocks_read(long long* cycles, int* overflows, int n) {\n'
            "  cudaMemcpyFromSymbol(overflows, koord_block_overflows, sizeof(int) * n);\n"
            "  return (int)cudaMemcpyFromSymbol(cycles, koord_block_cycles, sizeof(long long) * n);\n}\n"
            'extern "C" int koord_build_blocks_reset(const int* zero, int n) {\n'
            "  return (int)cudaMemcpyToSymbol(koord_block_overflows, zero, sizeof(int) * n);\n}\n")


def start_build(tree: Path, variant: str, src: str):
    """nvcc started on one copy; returns (process, library path)."""
    from koordinator_tpu_torch import kernels

    tag = hashlib.sha256(src.encode()).hexdigest()[:12]
    kernels.BUILD.mkdir(parents=True, exist_ok=True)
    cu = kernels.BUILD / f"build_phases_{variant}_{tag}.cu"
    so = kernels.BUILD / f"libbuild_phases_{variant}_{tag}.so"
    cu.write_text(src)
    proc = subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I",
                             str(tree / "koordinator_tpu_torch" / "csrc"), "-o", str(so),
                             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, so


def load(proc, so: Path, what: str):
    """The built copy, its entry typed."""
    from koordinator_tpu_torch import kernels

    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"build_phases: {what} did not build:\n{out}")
    regs = sorted(set(re.findall(r"Used (\d+) registers", out)))
    spills = sorted(set(re.findall(r"(\d+) bytes spill stores", out)))
    print(json.dumps({"build": what, "registers": regs, "spill_store_bytes": spills}), flush=True)
    lib = ctypes.CDLL(str(so))
    lib.koord_shortlist_build.argtypes = kernels.SIGNATURES["shortlist_build"][
        "koord_shortlist_build"]
    return lib


def cases(torch, chip_smoke, dev, pods: list, terms: list):
    """The builds to time: (label, build arguments, the keyword arguments
    of the plain build, the C entry's zone and device arguments), at round
    0 of batch 0 (or the first P / 512 batches as one build) of the kernel
    checks' fixture: LoadAware alone, with ``numa_port_inputs``' zones or
    ``device_port_inputs``' devices (LeastAllocated pricing)."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.device import checked_devices
    from koordinator_tpu_torch.ops.numa import checked_zones

    no_zones, no_devices = [None] * 4 + [0] * 3, [None] * 9 + [0]
    for kind in terms:
        if kind == "numa":
            nodes_t, pods_t, params_t, numa_t = chip_smoke.numa_port_inputs(torch, dev)
        elif kind == "devices":
            nodes_t, pods_t, params_t, dev_t = chip_smoke.device_port_inputs(torch, dev)
        else:
            nodes, pods_np, params = chip_smoke.rich_fixture(1, chip_smoke.N_NODES,
                                                             16 * chip_smoke.BATCH)
            nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods_np, params, dev)
        for p in pods:
            batch = solver.tree_map(lambda a: a[:p], pods_t)
            n = nodes_t.allocatable.shape[0]
            if kind == "numa":
                _, nom_args, zt, _ = chip_smoke.numa_round_case(torch, batch, nodes_t,
                                                                numa_t.zone_free, numa_t,
                                                                params_t, 1)
                kw, c_args = dict(zones=zt), (checked_zones("build", zt, p, n, 2), no_devices)
            elif kind == "devices":
                _, nom_args, dt = chip_smoke.device_round_case(
                    torch, batch, nodes_t, solver._dev_carry0(dev_t, n), dev_t, params_t, 1)
                kw, c_args = dict(devices=dt), (no_zones, checked_devices("build", dt, p, n))
            else:
                _, nom_args = chip_smoke.round_inputs(batch, nodes_t, params_t)
                kw, c_args = {}, (no_zones, no_devices)
            yield kind, nom_args[:4] + nom_args[5:], kw, c_args


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, nargs="+", default=[ROOT])
    ap.add_argument("--pods", type=int, nargs="+", default=[512, 4096])
    ap.add_argument("--terms", nargs="+", default=["plain"],
                    choices=["plain", "numa", "devices"])
    ap.add_argument("--k", type=int, default=64)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import shortlist as sl

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    dev = torch.device("cuda")
    started = {}
    for tree in args.tree:
        src = (tree / "koordinator_tpu_torch" / "csrc" / "shortlist_build.cu").read_text()
        started[tree] = {"whole": start_build(tree, "whole", with_clocks(src)),
                         "price_only": start_build(tree, "price_only", price_only(src))}
    libs = {tree: {v: load(*b, f"{v} of {tree}") for v, b in builds.items()}
            for tree, builds in started.items()}
    for kind, build_args, kw, (zone_args, dev_args) in cases(torch, chip_smoke, dev, args.pods,
                                                             args.terms):
        pp, d = build_args[0].shape
        n = build_args[4].shape[0]
        k = args.k
        ptrs = [t.data_ptr() for t in build_args]
        for jitter in (4.0, 0.0) if kind == "plain" else (4.0,):
            want = sl.shortlist_build_plain(*build_args, k, jitter, **kw)
            for turn in (*args.tree, *reversed(args.tree)):
                row = {"tree": str(turn), "terms": kind, "pods": pp, "nodes": n, "k": k,
                       "jitter": jitter, "card": smi}
                for variant, lib in libs[turn].items():
                    cand = torch.empty((pp, k), dtype=torch.int32, device=dev)
                    bound = torch.empty((pp,), dtype=torch.float32, device=dev)

                    def call():
                        code = lib.koord_shortlist_build(
                            *ptrs, pp, n, d, k, ctypes.c_float(jitter / 65536.0),
                            int(jitter > 0.0), cand.data_ptr(), bound.data_ptr(), None, None,
                            *zone_args, *dev_args, 1, kernels.stream_of(cand))
                        if code != 0:
                            raise SystemExit(f"build_phases: CUDA error {code}")

                    call()
                    torch.cuda.synchronize()
                    fin = torch.isfinite(want[1])
                    if variant == "whole" and not (
                            torch.equal(cand.cpu(), want[0].cpu())
                            and torch.equal(torch.isfinite(bound), fin)
                            and chip_smoke.bits_equal(bound[fin].cpu(), want[1][fin].cpu())):
                        print(f"FAIL: {turn} {kind} P={pp} jitter {jitter}: the build differs "
                              "from the plain build")
                        return 1
                    row[variant] = chip_smoke.device_ms(torch, call, 50, "shortlist_build")
                    if variant == "whole" and hasattr(lib, "koord_build_clock_read"):
                        marks = []
                        for _ in range(5):
                            call()
                            torch.cuda.synchronize()
                            buf = (ctypes.c_longlong * 8)()
                            lib.koord_build_clock_read(buf)
                            marks.append([v - buf[0] for v in list(buf)[1:5]])
                        row["block0_cycles_at_marks"] = sorted(marks)[2]
                        # each block's cycles and overflow compactions, one call
                        zero = (ctypes.c_int * pp)()
                        lib.koord_build_blocks_reset(zero, pp)
                        call()
                        torch.cuda.synchronize()
                        cyc, ovf = (ctypes.c_longlong * pp)(), (ctypes.c_int * pp)()
                        lib.koord_build_blocks_read(cyc, ovf, pp)
                        cyc, ovf = sorted(cyc), list(ovf)
                        row["block_cycles"] = {"min": cyc[0], "median": cyc[pp // 2],
                                               "p90": cyc[pp * 9 // 10], "max": cyc[-1]}
                        row["overflows"] = {"blocks": sum(o > 0 for o in ovf),
                                            "total": sum(ovf), "max": max(ovf)}
                if row["whole"] is not None and row["price_only"] is not None:
                    row["selection"] = row["whole"] - row["price_only"]
                print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
