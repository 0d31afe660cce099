#!/usr/bin/env python3
"""Where the gang rollback kernel spends its cycles, sub-phase by sub-phase.

    python3 tools/gang_phases.py [--cases NAME ...] [--built] [--tree DIR]

Builds a copy of ``koordinator_tpu_torch/csrc/gangs.cu`` in which every
thread reads ``clock64()`` at each sub-phase comment of
``enforce_gangs_kernel`` ("// g1. ...", "// g2. ...") and adds the cycles
since its last mark to the sub-phase it leaves, then runs it on the card
through the tree's own ``solver.enforce_gangs`` with the copy loaded in
place of the built library. A sub-phase's cycles are the largest of any
thread's (a sub-phase that ends at a barrier: the block's time there; a
walk inside a loop of its own: the slowest thread's), summed over a chain
of levels where it repeats; the median over 15 runs is printed with the
CUDA-event time of a call, and each run's outputs must equal the built
kernel's. A tree whose ``gangs.cu`` has no such comments (an older
commit) gets them at the statements that begin its sub-phases
(``OLD_ANCHORS``). ``--built`` times the tree's own kernel instead
(``solver.enforce_gangs``, no instrumentation): the CUDA-event time of a
call and the ``torch.profiler`` device time of ``enforce_gangs_kernel``.

The cases (``--cases``, default all), each a batch's solve result before
its rollback:
- ``plain``: the kernel check's batch 0 at P=512 (``chip_smoke.rich_fixture(1,
  10000, 8192)``; Strict and NonStrict gangs, rollbacks on shared nodes);
- ``none``: the same batch with no gang, so nothing rolls back (R = 0):
  what each of the streams' 192 launches a pass costs where no batch rolls
  back;
- ``onehot``, ``sorted``: the quota kernel check after
  ``chip_smoke.QUOTA_LATER`` batches (the quota refund);
- ``zones``: the NUMA kernel check after 3 batches, a third of the pods that
  took a zone in a gang that falls short (the zone refund);
- ``devices``: the device kernel check after 3 batches (G = 16, RDMA and
  FPGA), a third of the GPU pods placed in a gang that falls short;
- ``fleet``: the first batch from ``FLEET_FROM`` on that rolls pods back,
  of the device streams' fixture (``chip_smoke.gpu_fleet``, two-member
  gangs on a quarter of each batch), the batches before it solved and
  rolled back in order;
- ``big8192`` ... ``big65536``: the big batch with the sorted tree
  (``chip_smoke.big_port_inputs``), its Strict gang rolled back (8,192 pods
  in shared memory, the rest in device memory).
Needs a CUDA device and ``nvcc``; the copy is built under the tree's
``koordinator_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CASES = ("plain", "none", "onehot", "sorted", "zones", "devices", "fleet",
         "big8192", "big16384", "big32768", "big65536")
#: ``fleet`` times the first batch from this one on whose rollback rolls
#: pods back: half way in, where the fleet runs out
FLEET_FROM = 96

#: the sub-phases of a gangs.cu without "// gN." comments (an older tree's): the
#: comment goes before the first line that starts with the anchor
OLD_ANCHORS = (
    ("  for (int i = tid; i < P; i += blockDim.x) {\n    s_asg[i] = assignment[i];",
     "g1. counts"),
    ("  for (int i = tid; i < P; i += blockDim.x) {\n    const int a = s_asg[i];",
     "g2. compaction"),
    ("  const int L = pow2_at_least(R);", "g3. node sort"),
    ("    const int node = (int)(keys[s] >> 32);", "g4. node sums"),
    ("    if (dv.slots != nullptr) {\n      // the device refunds", "g5. device refunds"),
    ("    if (zone_free == nullptr) continue;", "g6. zone refund"),
    ("    for (int s = tid; s < R; s += blockDim.x) pod_zone[", "g7. picks cleared"),
    ("    for (int s = tid; s < L; s += blockDim.x) {\n      uint64_t key = UINT64_MAX;",
     "g8. quota sort"),
    ("    for (int s = tid; s < R; s += blockDim.x) {\n      const int q = (int)(qkeys[s] >> 32);",
     "g9. quota sums"),
)

HEAD = """__device__ unsigned long long koord_gang_cycles[2][16];
__device__ __forceinline__ void koord_gang_flush(long long (&acc)[16], long long t0, int cur) {
  acc[cur] += clock64() - t0;
  for (int s = 0; s < 16; ++s) {
    atomicMax(&koord_gang_cycles[0][s], (unsigned long long)acc[s]);
    if (threadIdx.x == 0) koord_gang_cycles[1][s] = (unsigned long long)acc[s];
  }
}
"""
MARK = ("{{ const long long t_ = clock64(); koord_acc_[koord_cur_] += t_ - koord_t_; "
        "koord_t_ = t_; koord_cur_ = {}; }}")
#: the sub-phase that takes each thread's waits at the kernel body's own
#: barriers, so that a sub-phase's cycles are its work on the slowest thread
WAITS = 15
WAIT = ("{ const int koord_was_ = koord_cur_; " + MARK.format(WAITS)
        + " __syncthreads(); " + MARK.format("koord_was_") + " }")
START = "long long koord_acc_[16] = {0}; long long koord_t_ = clock64(); int koord_cur_ = 0;"
FLUSH = "koord_gang_flush(koord_acc_, koord_t_, koord_cur_);"
READ = """
extern "C" int koord_gang_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(koord_gang_cycles, z, sizeof(z));
}
extern "C" int koord_gang_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, koord_gang_cycles, sizeof(unsigned long long) * 32);
}
"""


def with_comments(src: str) -> str:
    """``src`` with a "// gN." comment before each old sub-phase's first
    statement where it has none of its own."""
    if re.search(r"\n\s*// g\d+\. ", src):
        return src
    for anchor, name in OLD_ANCHORS:
        at = src.find(anchor)
        if at < 0:
            raise SystemExit(f"FAIL: no anchor for {name!r} in the tree's gangs.cu")
        indent = anchor[: len(anchor) - len(anchor.lstrip(" "))]
        src = src[:at] + f"{indent}// {name}\n" + src[at:]
    return src


def instrumented(src: str) -> "tuple[str, list[str]]":
    """The kernel with a clock mark at each sub-phase comment, every thread
    summing its cycles by sub-phase (its waits at the body's own barriers
    apart) and flushing the sums (the largest over threads, and thread
    0's) at each return; and the names, by sub-phase index."""
    src = with_comments(src)
    body_at = src.index("enforce_gangs_kernel(")
    open_at = src.index(") {\n", body_at) + 2
    end_at = src.index("\n}\n", open_at)
    body = src[open_at + 1 : end_at]
    names, out = ["before g1"], []
    for line in body.splitlines(keepends=True):
        m = re.match(r"(\s+)// (g\d+)\. (.*)", line)
        if m:
            out.append(m.group(1) + MARK.format(len(names)) + "\n")
            names.append(f"{m.group(2)}. {re.split(r' \(|:|,', m.group(3))[0].strip()}")
        line = re.sub(r"\breturn;", "{ " + FLUSH + " return; }", line)
        out.append(re.sub(r"(?<![\w.])__syncthreads\(\);", lambda _: WAIT, line))
    first = src.index("namespace {") + len("namespace {")
    text = (src[:first] + "\n" + HEAD + src[first : open_at + 1] + "\n  " + START + "\n"
            + "".join(out) + "\n  " + FLUSH + src[end_at:] + READ)
    return text, names + [""] * (WAITS - len(names)) + ["barrier waits"]


def load_fixtures():
    """This checkout's smoke, whatever the tree (its fixtures)."""
    spec = importlib.util.spec_from_file_location("smoke_fixture", ROOT / "chip_smoke.py")
    fixtures = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = fixtures
    spec.loader.exec_module(fixtures)
    return fixtures


def gang_last(torch, pods_b, pick):
    """``pods_b`` with the pods where ``pick`` holds in gang 0, which
    asks for more members than the batch has (Strict)."""
    p_b = pods_b.gang_id.shape[0]
    gang_min = pods_b.gang_min.clone()
    gang_min[0] = p_b + 1
    nonstrict = pods_b.gang_nonstrict.clone()
    nonstrict[0] = False
    return dataclasses.replace(pods_b, gang_id=torch.where(pick, 0, pods_b.gang_id),
                               gang_min=gang_min, gang_nonstrict=nonstrict)


def make_case(name: str, torch, fx, dev):
    """(result before the rollback, pods, slot_exists or None) of a case."""
    from koordinator_tpu_torch.ops import solver

    solve = fx.SOLVE
    batch = fx.BATCH
    if name in ("plain", "none"):
        nodes, pods, params = fx.rich_fixture(1, fx.N_NODES, 16 * batch)
        nodes_t, pods_t, params_t = fx.port_inputs(torch, nodes, pods, params, dev)
        pods_b = solver.tree_map(lambda a: a.reshape((-1, batch) + a.shape[1:])[0], pods_t)
        if name == "none":
            pods_b = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
        return fx.gang_check_inputs(pods_b, nodes_t, params_t), pods_b, None
    if name in ("onehot", "sorted"):
        fixture = fx.rich_fixture(1, fx.N_NODES, 16 * batch)
        pods_s, nodes_t, params_t, quotas, _ = fx.quota_port_inputs(torch, name, fixture, dev)
        _, later, _, later_q = solver.solve_stream(
            solver.tree_map(lambda a: a[:fx.QUOTA_LATER], pods_s), nodes_t, params_t,
            quotas=quotas, **solve)
        pods_b = solver.tree_map(lambda a: a[fx.QUOTA_LATER], pods_s)
        free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
        pre = solver.assign(free, later, params_t, quotas=solver.QuotaState(
            runtime=quotas.runtime, used=later_q.used), **solve)
        return pre, pods_b, None
    if name == "zones":
        nodes_t, pods_t, params_t, numa_t = fx.numa_port_inputs(torch, dev)
        pods_s = solver.tree_map(lambda a: a.reshape((-1, batch) + a.shape[1:]), pods_t)
        later, zf = nodes_t, numa_t.zone_free
        for b in range(3):
            res = solver.assign(solver.tree_map(lambda a: a[b], pods_s), later, params_t,
                                numa=numa_t, numa_carry=zf, **solve)
            later = dataclasses.replace(later, requested=res.node_requested,
                                        estimated_used=res.node_estimated_used,
                                        prod_used=res.node_prod_used)
            zf = res.node_zone_free
        pods_b = solver.tree_map(lambda a: a[4], pods_s)
        free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
        pre = solver.assign(free, later, params_t, numa=numa_t, numa_carry=zf, **solve)
        third = (pre.pod_zone >= 0) & (torch.arange(batch, device=dev) % 3 == 0)
        return pre, gang_last(torch, pods_b, third), None
    if name in ("devices", "fleet"):
        from koordinator_tpu_torch.ops import device as device_ops
        from koordinator_tpu_torch.ops.device import DeviceState

        if name == "devices":
            nodes_t, pods_t, params_t, dev_t = fx.device_port_inputs(torch, dev)
            # the smoke's "after 3 batches" check: batches 0-2 committed, batch 4
            scoring, first = "LeastAllocated", 4
        else:
            nodes, pods, params = fx.headline_inputs(fx.build_fixture(0))
            pods, devices = fx.gpu_fleet(nodes, pods)
            nodes_t, pods_t, params_t = fx.port_inputs(torch, nodes, fx.stacked(pods), params,
                                                       dev)
            pods_t = solver.tree_map(lambda a: a.reshape((-1,) + a.shape[2:]), pods_t)
            dev_t = DeviceState.create(**devices, device=dev)
            scoring, first = None, None
        pods_s = solver.tree_map(lambda a: a.reshape((-1, batch) + a.shape[1:]), pods_t)
        later, carry = nodes_t, solver._dev_carry0(dev_t, nodes_t.allocatable.shape[0])
        exists = device_ops.slot_exists_of(dev_t.cap_total, dev_t.slot_free.shape[1])
        for b in range(pods_s.gang_id.shape[0]):
            pods_b = solver.tree_map(lambda a: a[b], pods_s)
            if name == "devices" and b == 3:
                continue
            if b == first or (first is None and b >= FLEET_FROM):
                free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
                pre = solver.assign(free, later, params_t, devices=dev_t, dev_carry=carry,
                                    device_scoring=scoring, **solve)
                after = solver.enforce_gangs(pre, pods_b, exists)
                if first is not None or bool(((pre.assignment >= 0)
                                              & (after.assignment < 0)).any()):
                    break
            # the batches before, each solved and rolled back as the stream does
            res = solver.assign(pods_b, later, params_t, devices=dev_t, dev_carry=carry,
                                device_scoring=scoring, **solve)
            later = dataclasses.replace(later, requested=res.node_requested,
                                        estimated_used=res.node_estimated_used,
                                        prod_used=res.node_prod_used)
            carry = (res.node_dev_slots, res.node_rdma_free, res.node_fpga_free)
        else:
            raise SystemExit(f"FAIL: {name}: no batch rolls pods back")
        if name == "devices":
            gpu = (pods_b.gpu_whole > 0) | (pods_b.gpu_share > 0)
            pods_b = gang_last(torch, pods_b,
                               gpu & (pre.assignment >= 0)
                               & (torch.arange(batch, device=dev) % 3 == 0))
        return pre, pods_b, exists
    if name.startswith("big"):
        p = int(name[3:])
        pods_t, nodes_t, params_t, quotas = fx.big_port_inputs(torch, p, True, dev)
        free = dataclasses.replace(pods_t, gang_id=torch.full_like(pods_t.gang_id, -1))
        return solver.assign(free, nodes_t, params_t, quotas=quotas, **solve), pods_t, None
    raise SystemExit(f"FAIL: unknown case {name!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="+", choices=CASES, default=list(CASES))
    ap.add_argument("--built", action="store_true",
                    help="time the tree's built kernel, not the instrumented copy")
    ap.add_argument("--tree", type=Path, default=ROOT,
                    help="the tree whose package and kernels run (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))

    import numpy as np
    import torch

    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    fx = load_fixtures()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    lib = names = None
    if not args.built:
        src, names = instrumented((kernels.CSRC / "gangs.cu").read_text())
        kernels.BUILD.mkdir(parents=True, exist_ok=True)
        cu, so = kernels.BUILD / "gang_phases.cu", kernels.BUILD / "libgang_phases.so"
        cu.write_text(src)
        build = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(kernels.CSRC),
                                "-o", str(so), str(cu)], capture_output=True, text=True)
        if build.returncode != 0:
            print(build.stdout + build.stderr, file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels.SIGNATURES["gangs"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.koord_error_string.argtypes = [ctypes.c_int]
        lib.koord_error_string.restype = ctypes.c_char_p
        lib.koord_gang_read.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    for name in args.cases:
        pre, pods, exists = make_case(name, torch, fx, dev)
        want = solver.enforce_gangs(pre, pods, exists)
        torch.cuda.synchronize()
        rolled = int(((pre.assignment >= 0) & (want.assignment < 0)).sum())
        line = {"tree": str(args.tree), "case": name, "pods": int(pre.assignment.shape[0]),
                "rolled_back": rolled, "card": smi}

        def call():
            return solver.enforce_gangs(pre, pods, exists)

        if not args.built:
            def call():  # noqa: F811 — the copy in place of the built library
                saved = kernels._libs.get("gangs")
                kernels._libs["gangs"] = lib
                try:
                    return solver.enforce_gangs(pre, pods, exists)
                finally:
                    if saved is None:
                        kernels._libs.pop("gangs", None)
                    else:
                        kernels._libs["gangs"] = saved

            most, first = [], []
            for _ in range(20):
                lib.koord_gang_reset()
                torch.cuda.synchronize()
                got = call()
                torch.cuda.synchronize()
                for f in dataclasses.fields(got):
                    a, b = getattr(got, f.name), getattr(want, f.name)
                    if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                        print(f"FAIL: {name}: the instrumented kernel's {f.name} differs")
                        return 1
                buf = (ctypes.c_ulonglong * 32)()
                if lib.koord_gang_read(buf) != 0:
                    print("FAIL: could not read the sub-phase cycles")
                    return 1
                most.append(list(buf)[:16])
                first.append(list(buf)[16:])
            med = np.median(np.array(most[5:], dtype=np.int64), axis=0)
            med0 = np.median(np.array(first[5:], dtype=np.int64), axis=0)
            line["cycles_by_subphase_most"] = {n: int(v) for n, v in zip(names, med) if n and v}
            line["cycles_by_subphase_thread0"] = {n: int(v) for n, v in zip(names, med0) if n and v}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        call()
        torch.cuda.synchronize()
        start.record()
        for _ in range(100):
            call()
        end.record()
        torch.cuda.synchronize()
        line["event_ms_per_call"] = start.elapsed_time(end) / 100
        if args.built:
            line["device_ms_per_call"] = fx.device_ms(torch, call, 50, "enforce_gangs_kernel")
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
