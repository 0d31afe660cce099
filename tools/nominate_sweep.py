#!/usr/bin/env python3
"""Sweep the port's nomination kernel on one NVIDIA GPU.

    python3 tools/nominate_sweep.py [--sass OUT_DIR]
    python3 tools/nominate_sweep.py --terms numa devices dev_numa [--tree DIR ...]
                                    [--pods 512 4096]

At the main path's shapes (P=512 pods, N=10,000 nodes, D=2, k=4: the pods
and nodes ``chip_smoke.py`` checks the kernels on, at round 0) it calls
``csrc/nominate.cu`` with node chunks of several sizes (how many nodes
each block walks; the default is ``koord_nominate_chunk``'s) and prints one
JSON line per chunk: the device time of the tiled kernel and of the merge
kernel (``torch.profiler``), the CUDA-event time per call, and whether the
result is bitwise equal to ``nominate_plain`` (it must be). ``--sass``
writes the SASS of ``nominate_kernel<2, 4>`` (D=2, four list slots;
``cuobjdump``) to OUT_DIR and prints its instruction counts.

With ``--terms`` it splits the device time of the term instantiations
(NUMA zones, devices, devices with zones) between the LoadAware part and
the terms: for each tree (default: this checkout; another commit unpacked
with ``git archive``, whose ``csrc/nominate.cu`` may hold the term
instantiations itself) it builds a copy of the tree's
``csrc/nominate.cu`` and ``nominate_terms.cu`` against its headers,
prints each
instantiation's ``ptxas -v`` registers, spills and resident blocks an SM
at D=2 with four list slots, then on the kernel checks' fixtures
(``chip_smoke.numa_port_inputs``, ``device_port_inputs`` and, for
``dev_numa``, ``dev_numa_port_inputs``: round 0 of batch 0, P pods, N =
10,000, D = 2, k = 4, each aligned and device scoring and none) times the
same call through the LoadAware instantiation (no terms) and through the
term instantiation (with the pod order ``nominate.pod_order`` where the
tree takes one), each at its own default chunk, checks the term call
bitwise against ``nominate_plain``, and prints one JSON line a case:
``loadaware`` and ``with_terms`` device ms (``chip_smoke.device_ms``, a
window of 50 calls) and ``terms`` their difference. The trees run in
turns (A B B A).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

D = 2
K = 4
JITTER = 4.0


def device_by_kernel(torch, fn, iters: int) -> dict:
    """Mean device ms per call, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            name = "merge" if "merge" in evt.name else "tiled" if "nominate" in evt.name else "other"
            by[name] += evt.time_range.elapsed_us() / 1e3 / iters
    return dict(by)


def sass_report(kernels, lib_path: Path, out_dir: Path) -> dict:
    cuobjdump = shutil.which("cuobjdump") or str(Path(kernels.nvcc()).parent / "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    blocks = re.split(r"\n\s*Function : ", text)
    name = "nominate_kernelILi2ELi4ELb0ELb0ELb0ELi1ELi1EE"  # nominate_kernel<2, 4>
    body = next((b for b in blocks if b.startswith("_Z") and name in b.split("\n")[0]), "")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "nominate_kernel_d2_c4.sass").write_text(body)
    ops = collections.Counter()
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    return {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common(25))}


#: the instantiations the term split reads, D=2, four list slots (the
#: zone instantiations at the kernel-check zone shape, Z = 4 and DN = 2):
#: the one kernel of every mode, and the two kernels of a tree with
#: ``nominate_terms_kernel``, and the one of a tree whose ``nominate.cu``
#: holds every instantiation (five template arguments)
INSTANTIATIONS = {
    "nominate_kernelILi2ELi4ELb0ELb0ELb0ELi1ELi1EE": "loadaware",
    "nominate_kernelILi2ELi4ELb1ELb0ELb0ELi1ELi1EE": "masked",
    "nominate_kernelILi2ELi4ELb1ELb1ELb0ELi4ELi2EE": "numa",
    "nominate_kernelILi2ELi4ELb1ELb0ELb1ELi1ELi1EE": "devices",
    "nominate_kernelILi2ELi4ELb1ELb1ELb1ELi4ELi2EE": "dev_numa",
    "nominate_kernelILi2ELi4ELb0EE": "loadaware",
    "nominate_kernelILi2ELi4ELb1EE": "masked",
    "nominate_terms_kernelILi2ELi4ELb1ELb1ELb0ELi4ELi2EE": "numa",
    "nominate_terms_kernelILi2ELi4ELb1ELb0ELb1ELi1ELi1EE": "devices",
    "nominate_terms_kernelILi2ELi4ELb1ELb1ELb1ELi4ELi2EE": "dev_numa",
    "nominate_kernelILi2ELi4ELb0ELb0ELb0EE": "loadaware",
    "nominate_kernelILi2ELi4ELb1ELb0ELb0EE": "masked",
    "nominate_kernelILi2ELi4ELb1ELb1ELb0EE": "numa",
    "nominate_kernelILi2ELi4ELb1ELb0ELb1EE": "devices",
    "nominate_kernelILi2ELi4ELb1ELb1ELb1EE": "dev_numa",
}
#: koord_nominate_chunk's mode of each instantiation
MODES = {"loadaware": 0, "masked": 1, "numa": 2, "devices": 3, "dev_numa": 4}
#: the zone shape the kernel-check fixtures give (``chip_smoke.zone_tables``)
ZONES = (4, 2)


class OldEntry:
    """A library of a tree before the pod order: its koord_nominate takes
    no order argument (the one before the stream)."""

    def __init__(self, lib):
        self.lib = lib

    def koord_nominate(self, *args):
        return self.lib.koord_nominate(*args[:-2], args[-1])

    def __getattr__(self, name):
        return getattr(self.lib, name)


class TreeLibs:
    """One tree's built nomination libraries: ``libs[mode]`` takes that
    mode; ``zone_shape`` is whether its koord_nominate_chunk takes the
    zone shape (a tree with ``nominate_terms.cu``)."""

    def __init__(self, libs: dict, zone_shape: bool):
        self.libs, self.zone_shape = libs, zone_shape

    def chunk(self, p: int, n: int, d: int, k: int, sms: int, mode: int) -> int:
        from koordinator_tpu_torch import kernels

        lib = self.libs[mode]
        chunk = ctypes.c_int(0)
        zones = ZONES if mode in (2, 4) else (0, 0)
        args = (p, n, d, k, sms, mode) + (zones if self.zone_shape else ())
        kernels.check(lib, lib.koord_nominate_chunk(*args, ctypes.byref(chunk)), "chunk")
        return chunk.value


def start_builds(tree: Path) -> dict:
    """nvcc started on a copy of each of ``tree``'s nomination sources
    against its headers: name → (process, library path)."""
    from koordinator_tpu_torch import kernels

    csrc = tree / "koordinator_tpu_torch" / "csrc"
    digest = hashlib.sha256()
    for header in sorted(csrc.glob("*.cuh")):
        digest.update(header.read_bytes())
    out = {}
    for name in ("nominate", "nominate_terms"):
        if not (csrc / f"{name}.cu").exists():
            continue
        src = (csrc / f"{name}.cu").read_text()
        d = digest.copy()
        d.update(src.encode())
        tag = d.hexdigest()[:12]
        kernels.BUILD.mkdir(parents=True, exist_ok=True)
        cu = kernels.BUILD / f"nominate_sweep_{name}_{tag}.cu"
        so = kernels.BUILD / f"lib{name}_sweep_{tag}.so"
        cu.write_text(src)
        out[name] = (subprocess.Popen([kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(csrc), "-o",
                                       str(so), str(cu)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True), so)
    return out


def load(builds: dict, tree: Path) -> TreeLibs:
    """The built copies, their entries typed, after printing each
    instantiation's registers, spills and resident blocks an SM (read back
    through ``koord_nominate_chunk``: one pod tile over one SM cuts 2^24
    nodes into that many chunks)."""
    from koordinator_tpu_torch import kernels

    zone_shape = "nominate_terms" in builds
    regs, libs = {}, {}
    for name, (proc, so) in builds.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nominate_sweep: {name}.cu of {tree} did not build:\n{out}")
        lib = ctypes.CDLL(str(so))
        for entry, argtypes in kernels.SIGNATURES["nominate"].items():
            if not zone_shape:
                argtypes = ([ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
                            if entry == "koord_nominate_chunk" else argtypes[:-2] + argtypes[-1:])
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        if not zone_shape:
            lib = OldEntry(lib)
        for mode in MODES.values():
            if name == "nominate" and (mode < 2 or not zone_shape) or name != "nominate" and mode >= 2:
                libs[mode] = lib
        entry = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = next((v for k, v in INSTANTIATIONS.items() if k in m.group(1)), None)
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                regs.setdefault(entry, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                regs.setdefault(entry, {}).update(registers=int(m.group(1)),
                                                  smem_bytes=int(smem.group(1)) if smem else 0)
    tl = TreeLibs(libs, zone_shape)
    n = 1 << 24
    for name, mode in MODES.items():
        regs.setdefault(name, {})["blocks_per_sm"] = round(n / tl.chunk(64, n, 2, 4, 1, mode))
    print(json.dumps({"tree": str(tree), "ptxas (D=2, C=4, zones Z=4 DN=2)": regs}), flush=True)
    return tl


def term_cases(torch, dev, kinds: list, pods: list):
    """(label, nomination arguments, ZoneTerms or None, DeviceTerms or
    None, scoring) at round 0 of batch 0 of each kind's kernel-check
    fixture, for each P and scoring."""
    from koordinator_tpu_torch.ops import solver

    for kind in kinds:
        if kind == "numa":
            nodes_t, pods_t, params_t, numa_t = chip_smoke.numa_port_inputs(torch, dev)
        elif kind == "devices":
            nodes_t, pods_t, params_t, dev_t = chip_smoke.device_port_inputs(torch, dev)
        else:
            nodes_t, pods_t, params_t, numa_t, dev_t = chip_smoke.dev_numa_port_inputs(
                torch, dev)
        n = nodes_t.allocatable.shape[0]
        for p in pods:
            batch = solver.tree_map(lambda a: a[:p], pods_t)
            for scoring in (0, 1) if kind == "numa" else (0, 1, 2):
                zt = dt = None
                if kind == "numa":
                    _, nom_args, zt, _ = chip_smoke.numa_round_case(
                        torch, batch, nodes_t, numa_t.zone_free, numa_t, params_t, scoring)
                elif kind == "devices":
                    _, nom_args, dt = chip_smoke.device_round_case(
                        torch, batch, nodes_t, solver._dev_carry0(dev_t, n), dev_t, params_t,
                        scoring)
                else:
                    _, nom_args, zt, dt = chip_smoke.dev_numa_round_case(
                        torch, batch, nodes_t, numa_t, solver._dev_carry0(dev_t, n), dev_t,
                        params_t, scoring)
                yield kind, p, scoring, nom_args, zt, dt


def term_split(torch, args) -> int:
    """The ``--terms`` split (module docstring)."""
    import numpy as np

    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops.device import checked_devices
    from koordinator_tpu_torch.ops.numa import checked_zones

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    started = {tree: start_builds(tree) for tree in args.tree}
    libs = {tree: load(b, tree) for tree, b in started.items()}
    index = dev.index or 0
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    for kind, p, scoring, nom_args, zt, dt in term_cases(torch, dev, args.terms, args.pods):
        n, d = nom_args[5].shape
        ptrs = nominate_ops.checked(nom_args, K)
        zone_args = checked_zones("nominate", zt, p, n, d)
        dev_args = checked_devices("nominate", dt, p, n)
        order = nominate_ops.pod_order(nom_args[3], zt, dt)
        want_c, want_i = nominate_ops.nominate_plain(*nom_args, K, JITTER, True, zones=zt,
                                                     devices=dt)
        want_c, want_i = want_c.cpu().numpy(), want_i.cpu().numpy()
        for turn in (*args.tree, *reversed(args.tree)):
            tl = libs[turn]
            row = {"tree": str(turn), "terms": kind, "scoring": scoring, "pods": p, "nodes": n,
                   "card": smi}
            for label, mode, za, da, op in (
                    ("loadaware", 0, (None,) * 4 + (0, 0, 0), (None,) * 9 + (0,), None),
                    ("with_terms", MODES[kind], zone_args, dev_args, order.data_ptr())):
                lib, chunk = tl.libs[mode], tl.chunk(p, n, d, K, sms, mode)

                def call(za=za, da=da, chunk=chunk, lib=lib, op=op):
                    c, i, code = nominate_ops.launch(lib, ptrs, p, n, d, K, JITTER, True, chunk,
                                                     dev, zone_args=za, dev_args=da,
                                                     order_ptr=op)
                    kernels.check(lib, code, f"nominate ({kind}, {label})")
                    return c, i

                c, i = call()
                torch.cuda.synchronize()
                if label == "with_terms":
                    c, i = c.cpu().numpy(), i.cpu().numpy()
                    fin = np.isfinite(want_c)
                    if not (np.array_equal(np.isfinite(c), fin)
                            and np.array_equal(c[fin].view(np.uint32), want_c[fin].view(np.uint32))
                            and np.array_equal(i[fin], want_i[fin])):
                        print(f"FAIL: {turn} {kind} P={p} scoring {scoring}: differs from "
                              "nominate_plain")
                        return 1
                row[f"{label}_chunk"] = chunk
                row[label] = chip_smoke.device_ms(torch, call, 50, "nominate")
            if row["loadaware"] is not None and row["with_terms"] is not None:
                row["terms_ms"] = row["with_terms"] - row["loadaware"]
            print(json.dumps(row), flush=True)
    return 0


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", type=Path, default=None)
    ap.add_argument("--terms", nargs="+", default=None, choices=["numa", "devices", "dev_numa"])
    ap.add_argument("--tree", type=Path, nargs="+", default=[ROOT])
    ap.add_argument("--pods", type=int, nargs="+", default=[512, 4096])
    args = ap.parse_args()
    if args.terms:
        if not torch.cuda.is_available():
            print("FAIL: CUDA is not available", file=sys.stderr)
            return 1
        return term_split(torch, args)
    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import nominate as nominate_ops

    dev = torch.device("cuda")
    def smi(query):
        return subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                              capture_output=True, text=True, check=False).stdout.strip()

    print(f"device: {smi('name,power.limit')}", flush=True)

    lib = kernels.library("nominate")
    if args.sass:
        lib_path = kernels.library_path(kernels.CSRC / "nominate.cu")
        print(json.dumps({"sass nominate_kernel<2,4>": sass_report(kernels, lib_path, args.sass)}),
              flush=True)

    nodes, pods, params = chip_smoke.rich_fixture(1, chip_smoke.N_NODES, chip_smoke.BATCH)
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, dev)
    _, nom_args = chip_smoke.round_inputs(pods_t, nodes_t, params_t)
    (p, d), n = nom_args[0].shape, nom_args[5].shape[0]
    ptrs = nominate_ops.checked(nom_args, K)
    want_c, want_i = nominate_ops.nominate_plain(*nom_args, K, JITTER, False)
    want_c, want_i = want_c.cpu().numpy(), want_i.cpu().numpy()
    default = nominate_ops.chunk_of(lib, p, n, d, K, 0)
    chunks = [default, n, 2048, 512, 256, 160, 128, 96, 64]
    # every chunk but one twice, in turns: the spread of one chunk inside
    # the call
    for chunk in chunks + chunks[:1] + chunks[2:]:
        def call():
            c, i, code = nominate_ops.launch(lib, ptrs, p, n, d, K, JITTER, False, chunk, dev)
            kernels.check(lib, code, f"nominate (chunk {chunk})")
            return c, i

        c, i = call()
        torch.cuda.synchronize()
        c, i = c.cpu().numpy(), i.cpu().numpy()
        if not (np.array_equal(c.view(np.uint32), want_c.view(np.uint32))
                and np.array_equal(i, want_i)):
            print(f"FAIL: chunk {chunk}: differs from nominate_plain")
            return 1
        print(json.dumps(dict(
            chunk=chunk, chunks=-(-n // chunk), default=chunk == default,
            ms=chip_smoke.cuda_ms(torch, call, 200),
            device_ms=device_by_kernel(torch, call, 50),
            sm_clock=smi("clocks.sm"),
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
