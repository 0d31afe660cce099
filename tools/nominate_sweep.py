#!/usr/bin/env python3
"""Sweep the port's nomination kernel on one NVIDIA GPU.

    python3 tools/nominate_sweep.py [--sass OUT_DIR]

At the main path's shapes (P=512 pods, N=10,000 nodes, D=2, k=4: the pods
and nodes ``chip_smoke.py`` checks the kernels on, at round 0) it calls
``csrc/nominate.cu`` with node chunks of several sizes (how many nodes
each block walks; the default is ``koord_nominate_chunk``'s) and prints one
JSON line per chunk: the device time of the tiled kernel and of the merge
kernel (``torch.profiler``), the CUDA-event time per call, and whether the
result is bitwise equal to ``nominate_plain`` (it must be). ``--sass``
writes the SASS of ``nominate_kernel<2, 4>`` (D=2, four list slots;
``cuobjdump``) to OUT_DIR and prints its instruction counts.
"""

from __future__ import annotations

import argparse
import collections
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
    body = next((b for b in blocks if b.startswith("_Z") and "nominate_kernelILi2ELi4E" in b.split("\n")[0]), "")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "nominate_kernel_d2_c4.sass").write_text(body)
    ops = collections.Counter()
    for line in body.splitlines():
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(1).split(".")[0]] += 1
    return {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common(25))}


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", type=Path, default=None)
    args = ap.parse_args()
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
