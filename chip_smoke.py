#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's LoadAware main path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. require CUDA; print the card's name and ``nvidia-smi`` name and power
   limit;
2. build every kernel of ``koordinator_tpu_torch/csrc`` with ``nvcc``,
   one process per source, all started together;
3. hold each kernel against its plain PyTorch version at the headline
   shapes (P=512 pods, N=10,000 nodes, D=2) on a fixture with stale
   metrics, unschedulable nodes, custom thresholds, amplified CPU with
   cpuset-bound pods, prod pods and gangs: nomination indices and finite
   costs bitwise equal, commit accepts and post-commit tables bitwise equal
   to ``commit_plain`` on CPU copies, gang rollback (with real rollbacks,
   one node refunded twice or more) bitwise equal to
   ``enforce_gangs_plain``; then time each kernel, its plain version and,
   where one exists, the one PyTorch call that computes the same function;
4. the headline stream: ``solve_stream`` over 98,304 pods and 10,000 nodes
   in 192 batches of 512 (``bench.py``'s fixture and parameters), one
   warm-up pass and 3 timed passes through the kernels (launch counts are
   zeroed just before the first timed pass and read just after it; one
   ``enforce_gangs`` launch a batch; a count is of wrapper calls, and
   ``kernels_per_launch`` in the kernels line says how many kernels one
   call runs: two for nomination, its tiled and merge kernels), then one
   pass through the plain versions on the card: assignments and final
   tables must be identical;
5. the committed golden (``tests/data/torch_golden_loadaware.npz``): the
   JAX package's ``solve_stream`` result on a 2×512-pod × 2,000-node
   fixture; the port on the card must reproduce it bit for bit.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it holds the per-kernel numbers as ``{"kernels": [...]}``.
The script imports nothing of JAX or of the JAX package: it keeps its own
copy of ``bench.build_fixture``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_golden_loadaware.npz")

N_NODES = 10_000
N_PODS = 98_304
BATCH = 512
PASSES = 3
THRESHOLDS = (65.0, 95.0)
#: bench.py's solve_stream arguments (topk=4, nomination_jitter=4.0 and
#: round_quantum=0.35 are the defaults)
SOLVE = dict(max_rounds=12, approx_topk=True)

#: H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor fp32 op/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: golden fixture: rich_fixture(GOLDEN_SEED, GOLDEN_NODES, GOLDEN_PODS)
GOLDEN_SEED = 7
GOLDEN_NODES = 2_000
GOLDEN_PODS = 2 * BATCH


def build_fixture(seed: int = 0, n_nodes: int = N_NODES, n_pods: int = N_PODS):
    """A copy of ``bench.build_fixture`` (same draws, same order)."""
    rng = np.random.default_rng(seed)
    shapes = np.array([[32_000, 128 * 1024], [64_000, 256 * 1024], [96_000, 384 * 1024]])
    alloc = shapes[rng.integers(0, 3, n_nodes)].astype(np.float32)
    util = rng.uniform(0.1, 0.55, (n_nodes, 1)).astype(np.float32)
    est_used = alloc * util
    req_cpu = rng.choice([500, 1000, 2000, 4000], n_pods, p=[0.4, 0.3, 0.2, 0.1])
    req_mem = req_cpu * rng.choice([2, 4, 8], n_pods)
    req = np.stack([req_cpu, req_mem], 1).astype(np.float32)
    est = (req * np.array([0.85, 0.70], np.float32)).astype(np.float32)
    prio = rng.integers(5000, 9999, n_pods).astype(np.int32)
    return dict(
        alloc=alloc,
        est_used=est_used,
        prod_used=est_used * 0.6,
        req=req,
        est=est,
        prio=prio,
        is_prod=prio >= 9000,
    )


def headline_inputs(fix):
    """``bench.bench_solver``'s NodeState / PodBatch / SolverParams arrays."""
    nodes = dict(
        allocatable=fix["alloc"],
        estimated_used=fix["est_used"],
        prod_used=fix["prod_used"],
    )
    pods = dict(
        requests=fix["req"],
        estimate=fix["est"],
        priority=fix["prio"],
        is_prod=fix["is_prod"],
    )
    params = dict(
        usage_thresholds=np.asarray(THRESHOLDS, np.float32),
        prod_thresholds=np.zeros(2, np.float32),
        score_weights=np.ones(2, np.float32),
    )
    return nodes, pods, params


def rich_fixture(seed: int, n_nodes: int, n_pods: int, batch: int = BATCH):
    """The bench fixture plus what it leaves out: stale metrics,
    unschedulable nodes, custom (prod) thresholds, amplified CPU with
    cpuset-bound LSR pods, prod thresholds, gangs (Strict and NonStrict,
    indexed per batch) and padded invalid pods. Returns numpy dicts
    (nodes, pods, params); pod arrays are flat [n_pods, ...]."""
    nodes, pods, params = headline_inputs(build_fixture(seed, n_nodes, n_pods))
    rng = np.random.default_rng(seed + 1)
    n, p = n_nodes, n_pods
    nodes["metric_fresh"] = rng.random(n) > 0.05
    nodes["schedulable"] = rng.random(n) > 0.03
    nodes["cpu_amp"] = np.where(rng.random(n) < 0.25, 1.5, 1.0).astype(np.float32)
    custom = np.where(rng.random((n, 1)) < 0.1, np.array([[70.0, 0.0]]), 0.0)
    nodes["custom_thresholds"] = custom.astype(np.float32)
    pcustom = np.where(rng.random((n, 1)) < 0.05, np.array([[50.0, 80.0]]), 0.0)
    nodes["custom_prod_thresholds"] = pcustom.astype(np.float32)
    pods["qos"] = np.where(rng.random(p) < 0.2, 3, 0).astype(np.int8)
    pods["valid"] = rng.random(p) > 0.01
    gangs = 8
    gang_id = np.where(rng.random(p) < 0.1, rng.integers(0, gangs, p), -1)
    gang_min = np.zeros((p // batch, batch), np.int32)
    gang_min[:, :gangs] = rng.integers(2, 12, (p // batch, gangs))
    gang_ns = np.zeros((p // batch, batch), bool)
    gang_ns[:, :gangs] = rng.random((p // batch, gangs)) < 0.3
    pods["gang_id"] = gang_id.astype(np.int32)
    pods["gang_min"] = gang_min.reshape(-1)
    pods["gang_nonstrict"] = gang_ns.reshape(-1)
    params["prod_thresholds"] = np.asarray((60.0, 0.0), np.float32)
    return nodes, pods, params


def fixture_digest(*dicts) -> str:
    h = hashlib.sha256()
    for d in dicts:
        for k in sorted(d):
            h.update(k.encode())
            h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def stacked(pods: dict, batch: int = BATCH) -> dict:
    return {k: v.reshape((-1, batch) + v.shape[1:]) for k, v in pods.items()}


# ---------------------------------------------------------------- helpers


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        return bool(np.array_equal(a.view(np.uint32), b.view(np.uint32)))
    return bool(np.array_equal(a, b))


def max_abs(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds per call on the card, by CUDA events around
    ``iters`` back-to-back calls (after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters: int, name_part: "str | None"):
    """Mean device time per call of the CUDA kernels whose name contains
    ``name_part`` (all of them for None), from ``torch.profiler``; None
    when the profiler shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(
        evt.time_range.elapsed_us()
        for evt in prof.events()
        if evt.device_type == DeviceType.CUDA
        and (name_part is None or name_part in evt.name)
    )
    return total / iters / 1000.0 if total > 0 else None


#: kernels one wrapper call launches together, listed under one name
KERNEL_GROUPS = {
    "nominate_kernel": "nominate_kernel + nominate_merge_kernel",
    "nominate_merge_kernel": "nominate_kernel + nominate_merge_kernel",
}


def stream_profile(torch, fn, wall_s: float) -> dict:
    """Device time of one profiled call of ``fn``, by kernel (a wrapper's
    kernels together, ``KERNEL_GROUPS``): the sum of the CUDA kernel and
    copy intervals ``torch.profiler`` records, and that sum's share of
    ``wall_s`` (an unprofiled run's wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        name = evt.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0].split("<")[0]
        name = name.split("::")[-1].strip()[:60]
        name = KERNEL_GROUPS.get(name, name)
        by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        return {"device_busy_ms": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "top_device_ms": dict(top),
    }


@contextlib.contextmanager
def plain_versions():
    """Route the solver through the kernels' plain versions for a run on
    the card (the wrappers launch the kernels for every CUDA tensor)."""
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import solver

    def enforce_gangs_plain_(result, pods):
        out = solver.enforce_gangs_plain(result, pods)
        for name in solver._GANG_FIELDS:
            if getattr(result, name) is not None:
                getattr(result, name).copy_(getattr(out, name))

    saved = (nominate_ops.nominate, commit_ops.commit, solver._enforce_gangs_)
    nominate_ops.nominate = nominate_ops.nominate_plain
    commit_ops.commit = commit_ops.commit_plain
    solver._enforce_gangs_ = enforce_gangs_plain_
    try:
        yield
    finally:
        nominate_ops.nominate, commit_ops.commit, solver._enforce_gangs_ = saved


def port_inputs(torch, nodes, pods, params, device):
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import from_numpy

    return (
        from_numpy(solver.NodeState, device=device, **nodes),
        from_numpy(solver.PodBatch, device=device, **pods),
        from_numpy(solver.SolverParams, device=device, **params),
    )


def round_inputs(pods_b, nodes_t, params_t):
    """What round 0 of ``assign`` hands the nomination kernel for batch
    ``pods_b`` at node state ``nodes_t`` (every valid pod active)."""
    from koordinator_tpu_torch.ops import solver

    _, spods, bind, thr, pthr = solver._round_setup(pods_b, nodes_t, params_t)
    nom_args = (
        spods.requests, spods.estimate, spods.is_prod, bind,
        spods.valid, nodes_t.allocatable, nodes_t.requested,
        nodes_t.estimated_used, nodes_t.prod_used, nodes_t.metric_fresh,
        nodes_t.schedulable, nodes_t.cpu_amp, thr, pthr,
        params_t.score_weights,
    )
    return spods, nom_args


def ptxas_summary(kernels) -> dict:
    """Registers, shared memory and spills of the main path's kernels
    (nominate at D=2 with four list slots, K <= 4), from ``nvcc -Xptxas -v``
    in the build logs, and the most registers and spill bytes over every
    nominate instantiation."""
    import re

    wanted = {
        "nominate_kernelILi2ELi4E": "nominate_kernel<2,4>",
        "nominate_merge_kernelILi4E": "nominate_merge_kernel<4>",
        "commit_kernel": "commit_kernel",
        "enforce_gangs_kernel": "enforce_gangs_kernel",
    }
    out: dict = {}
    worst = {"registers": 0, "spill_bytes": 0}
    for src in ("nominate", "commit", "gangs"):
        entry = None
        for line in kernels.build_log(src).splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
                continue
            if entry is None:
                continue
            label = next((v for k, v in wanted.items() if k in entry), None)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill = int(m.group(1)) + int(m.group(2))
                if label:
                    out.setdefault(label, {})["spill_bytes"] = spill
                if src == "nominate":
                    worst["spill_bytes"] = max(worst["spill_bytes"], spill)
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs = int(m.group(1))
                smem = re.search(r"(\d+) bytes smem", line)
                if label:
                    out.setdefault(label, {}).update(
                        registers=regs, smem_bytes=int(smem.group(1)) if smem else 0
                    )
                if src == "nominate":
                    worst["registers"] = max(worst["registers"], regs)
    out["nominate, every instantiation"] = worst
    return out


# ----------------------------------------------------------------- phases


def gang_check_inputs(pods_b, state, params_t):
    """What ``enforce_gangs`` receives for batch ``pods_b`` at node state
    ``state``: the batch's solve result before the rollback. The rounds do
    not read the gang fields, so this is ``assign`` with gangs off."""
    from koordinator_tpu_torch.ops import solver

    free = dataclasses.replace(pods_b, gang_id=pods_b.gang_id.new_full(pods_b.gang_id.shape, -1))
    return solver.assign(free, state, params_t, **SOLVE)


def phase_kernels(torch, dev, report):
    """Phase 3: each kernel against its plain version at headline shapes,
    then its times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = rich_fixture(1, N_NODES, 16 * BATCH)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, pods, params, dev)
    pods_s = solver.tree_map(lambda a: a.reshape((-1, BATCH) + a.shape[1:]), pods_t)
    # a later node state: after 15 batches through the kernels
    _, later, _, _ = solver.solve_stream(
        solver.tree_map(lambda a: a[:15], pods_s), nodes_t, params_t, **SOLVE
    )
    checks = {"nominate": 0.0, "commit": 0.0, "enforce_gangs": 0.0}
    rollbacks = []
    timing_inputs = None
    for label, state, b in (("start", nodes_t, 0), ("after 15 batches", later, 15)):
        pods_b = solver.tree_map(lambda a: a[b], pods_s)
        spods, nom_args = round_inputs(pods_b, state, params_t)
        for approx in (False, True):
            kc, ki = nominate_ops.nominate(*nom_args, 4, 4.0, approx)
            pc, pi = nominate_ops.nominate_plain(*nom_args, 4, 4.0, approx)
            torch.cuda.synchronize()
            kc, ki, pc, pi = (t.cpu().numpy() for t in (kc, ki, pc, pi))
            fin = np.isfinite(kc)
            if not np.array_equal(fin, np.isfinite(pc)):
                fail(f"nominate ({label}, approx={approx}): finite slots differ")
            if not (bits_equal(kc[fin], pc[fin]) and np.array_equal(ki[fin], pi[fin])):
                fail(f"nominate ({label}, approx={approx}): differs from nominate_plain")
            checks["nominate"] = max(checks["nominate"], max_abs(kc[fin], pc[fin]))
        # commit, on the kernel's own nomination of this round
        top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True)
        n = state.allocatable.shape[0]
        _, node_key = solver._choose(top_cost, top_idx, spods.valid, n)
        _, snode, sreq, sest, sprod = solver._commit_inputs(
            node_key, spods, nom_args[3], state.cpu_amp, n
        )
        thr, pthr = nom_args[12], nom_args[13]
        fixed = (snode, sreq, sest, sprod, state.allocatable, state.metric_fresh, thr, pthr)
        tables = [state.requested.clone(), state.estimated_used.clone(), state.prod_used.clone()]
        acc_k = commit_ops.commit(*fixed, *tables, 0.35)
        host_fixed = [t.cpu() for t in fixed]
        host_tables = [t.cpu() for t in (state.requested, state.estimated_used, state.prod_used)]
        acc_p = commit_ops.commit_plain(*host_fixed, *host_tables, 0.35)
        torch.cuda.synchronize()
        if not np.array_equal(acc_k.cpu().numpy(), acc_p.numpy()):
            fail(f"commit ({label}): accepts differ from commit_plain")
        for tk, tp in zip(tables, host_tables):
            if not bits_equal(tk.cpu().numpy(), tp.numpy()):
                fail(f"commit ({label}): post-commit tables differ from commit_plain")
            checks["commit"] = max(checks["commit"], max_abs(tk.cpu().numpy(), tp.numpy()))
        # gang rollback of this batch's solve result (Strict and NonStrict
        # gangs), against the plain version on CPU copies
        pre = gang_check_inputs(pods_b, state, params_t)
        got = solver.enforce_gangs(pre, pods_b)
        want = solver.enforce_gangs_plain(
            solver.tree_map(lambda a: a.cpu(), pre), solver.tree_map(lambda a: a.cpu(), pods_b)
        )
        torch.cuda.synchronize()
        for f in ("assignment", "pod_zone", "node_requested", "node_estimated_used", "node_prod_used"):
            gk, gp = getattr(got, f).cpu().numpy(), getattr(want, f).numpy()
            if not bits_equal(gk, gp):
                fail(f"enforce_gangs ({label}): {f} differs from enforce_gangs_plain")
            checks["enforce_gangs"] = max(checks["enforce_gangs"], max_abs(gk, gp))
        before = pre.assignment.cpu().numpy()
        rolled = (before >= 0) & (got.assignment.cpu().numpy() < 0)
        most = int(np.bincount(before[rolled]).max()) if rolled.any() else 0
        if most < 2:
            fail(f"enforce_gangs ({label}): the check needs rollbacks with a node refunded "
                 f"twice; got {int(rolled.sum())} rollbacks, at most {most} on one node")
        rollbacks.append(dict(at=label, rolled_back=int(rolled.sum()), most_on_one_node=most))
        if timing_inputs is None:
            timing_inputs = (nom_args, fixed, tables, spods, pre, pods_b)
    print(f"kernel checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"gang rollbacks {json.dumps(rollbacks)}", flush=True)

    nom_args, fixed, tables, spods, pre, pods_b = timing_inputs
    p, d = spods.requests.shape
    n = nom_args[5].shape[0]

    def t_nominate():
        nominate_ops.nominate(*nom_args, 4, 4.0, False)

    def t_nominate_plain():
        nominate_ops.nominate_plain(*nom_args, 4, 4.0, False)

    work = [t.clone() for t in tables]

    def t_commit():
        commit_ops.commit(*fixed, *work, 0.35)

    def t_commit_plain():
        commit_ops.commit_plain(*fixed, *[t.clone() for t in tables], 0.35)

    # the rollback works in place: every timed call gets its own copy, and
    # the list keeps it alive, so no call pays for freeing the one before
    gang_iters = 200
    copies = [solver.tree_map(lambda a: a.clone(), pre) for _ in range(2 * gang_iters + 2)]
    fresh_copies = iter(copies)

    def t_gangs():
        solver._enforce_gangs_(next(fresh_copies), pods_b)

    def t_gangs_plain():
        solver.enforce_gangs_plain(pre, pods_b)

    # yardstick: one index_add_ of the same refunds into a fresh [N, 3D]
    before = pre.assignment
    after = solver.enforce_gangs(pre, pods_b).assignment
    rolled = (before >= 0) & (after < 0)
    ids_l = before[rolled].long()
    refunds = torch.cat([pods_b.requests, pods_b.estimate,
                         torch.where(pods_b.is_prod[:, None], pods_b.estimate, 0.0)], dim=1)
    vals_l = refunds[rolled]

    def t_index_add():
        torch.zeros((n, 3 * d), device=dev).index_add_(0, ids_l, vals_l)

    # operation and byte counts from these inputs (see PERF.md)
    valid = spods.valid
    fresh_nodes = int(nom_args[9].sum())
    bind_pods = int(nom_args[3].sum())
    prod_pods = int(spods.is_prod.sum())
    active_pods = int(valid.sum())
    feas_pairs = int(nominate_ops.feasible_mask(*nom_args[:14]).sum())
    nom_ops = (
        p * n * (3 * d + 1)
        + bind_pods * n * 5
        + (active_pods + prod_pods) * fresh_nodes * 7 * d
        + feas_pairs * (9 * d + 3 + 7)
    )
    nom_bytes = n * (6 * d * 4 + 2 + 4) + p * (2 * d * 4 + 3) + d * 4 + p * 4 * 8
    snode = fixed[0]
    touched = int(torch.unique(snode[snode < n]).numel())
    commit_bytes = p * (4 + 2 * d * 4 + 1) + touched * d * 4 * 10 + touched + p
    commit_ops_n = p * (3 * d * 2 + d * 3 + 2 * d * 7 + d * 4)
    n_rolled = int(rolled.sum())
    refunded_nodes = int(torch.unique(ids_l).numel())
    gang_bytes = p * (4 * 4 + 2 * d * 4 + 2) + refunded_nodes * 3 * d * 4 * 2
    gang_ops = p * 4 + n_rolled * 3 * d + refunded_nodes * 3 * d

    # kernels a wrapper call launches: nomination adds a merge kernel when
    # the node axis is cut into chunks
    nom_chunk = nominate_ops.chunk_of(kernels.library("nominate"), p, n, d, 4, dev.index or 0)
    per_call = {"nominate": 1 if nom_chunk >= n else 2, "commit": 1, "enforce_gangs": 1}

    def bound(nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    rows = []
    for name, source, replaces, fn, plain, lib_fn, kname, nbytes, nops, err, iters in (
        ("nominate", "koordinator_tpu_torch/csrc/nominate.cu",
         "koordinator_tpu/ops/solver.py:1121", t_nominate, t_nominate_plain, None,
         "nominate", nom_bytes, nom_ops, checks["nominate"], 200),
        ("commit", "koordinator_tpu_torch/csrc/commit.cu",
         "koordinator_tpu/ops/solver.py:1204", t_commit, t_commit_plain, None,
         "commit_kernel", commit_bytes, commit_ops_n, checks["commit"], 200),
        ("enforce_gangs", "koordinator_tpu_torch/csrc/gangs.cu",
         "koordinator_tpu/ops/solver.py:1858", t_gangs, t_gangs_plain, t_index_add,
         "enforce_gangs_kernel", gang_bytes, gang_ops, checks["enforce_gangs"], gang_iters),
    ):
        b_ms, b_by = bound(nbytes, nops)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, kernels_per_launch=per_call[name], max_abs_err=err,
            ms=cuda_ms(torch, fn, iters),
            plain_ms=cuda_ms(torch, plain, 5),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if lib_fn is None else cuda_ms(torch, lib_fn, 200),
            device_ms=device_ms(torch, fn, min(50, iters // 4), kname),
            library_device_ms=None if lib_fn is None else device_ms(torch, lib_fn, 50, None),
            bytes=nbytes, operations=nops,
        ))
    report["kernels"] = rows
    report["rollbacks"] = rollbacks
    kernels.reset_launches()


def phase_stream(torch, dev, report):
    """Phase 4: the headline stream through the kernels, then once through
    the plain versions on the card."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = headline_inputs(build_fixture(0))
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)

    def run():
        t0 = time.perf_counter()
        out = solver.solve_stream(pods_t, nodes_t, params_t, **SOLVE)
        placed_total = int(out[2].sum())  # waits for the card
        return out, placed_total, time.perf_counter() - t0

    run()  # warm-up: first launches, allocator
    kernels.reset_launches()
    out, placed, seconds = run()
    launches = dict(kernels.launches)
    times = [seconds] + [run()[2] for _ in range(PASSES - 1)]
    n_batches = N_PODS // BATCH
    for name in ("nominate", "commit", "enforce_gangs"):
        if launches.get(name, 0) <= 0:
            fail(f"the headline stream launched no {name} kernel")
    if launches["enforce_gangs"] != n_batches:
        fail(f"enforce_gangs launched {launches['enforce_gangs']} times, not once a batch")
    with plain_versions():
        p_out, p_placed, p_seconds = run()
    if not bits_equal(out[0].cpu().numpy(), p_out[0].cpu().numpy()):
        fail("headline stream: kernel and plain assignments differ")
    for f in ("requested", "estimated_used", "prod_used"):
        if not bits_equal(getattr(out[1], f).cpu().numpy(), getattr(p_out[1], f).cpu().numpy()):
            fail(f"headline stream: kernel and plain final {f} differ")
    if placed < 0.5 * N_PODS:
        fail(f"headline stream placed only {placed}/{N_PODS} pods")
    med = sorted(times)[len(times) // 2]
    profile = stream_profile(torch, run, med)
    report["stream"] = dict(
        pods=N_PODS, nodes=N_NODES, batches=n_batches, placed=placed,
        pods_per_s=N_PODS / med, pass_seconds=times,
        plain_pass_seconds=p_seconds,
        mean_rounds_per_batch=launches["nominate"] / n_batches,
        launches=launches,
        syncs_per_stream=launches["nominate"] + n_batches,
        **profile,
    )
    print(json.dumps({"stream": report["stream"]}), flush=True)
    for row in report["kernels"]:
        row["launches"] = launches[row["name"]]


def phase_golden(torch, dev):
    """Phase 5: the port on the card against the JAX package's recorded
    solve_stream result."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import to_numpy

    gold = np.load(GOLDEN)
    nodes, pods, params = rich_fixture(GOLDEN_SEED, GOLDEN_NODES, GOLDEN_PODS)
    if str(gold["fixture_sha256"]) != fixture_digest(nodes, pods, params):
        fail("golden: fixture differs from the one the golden was made from")
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)
    asg, final, placed, _ = solver.solve_stream(pods_t, nodes_t, params_t, **SOLVE)
    got = to_numpy(final)
    if not bits_equal(asg.cpu().numpy(), gold["assignments"]):
        fail("golden: assignments differ from the JAX package's")
    for f in ("requested", "estimated_used", "prod_used"):
        if not bits_equal(got[f], gold[f]):
            fail(f"golden: final {f} differs from the JAX package's")
    print(
        f"golden: {int(placed.sum())} placed, assignments and tables equal "
        f"to the JAX package's bit for bit",
        flush=True,
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: CUDA is not available", file=sys.stderr)
        return 1
    from koordinator_tpu_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (count {torch.cuda.device_count()})", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: n/a"
    print(f"nvidia-smi: {smi_line}", flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,temperature.gpu,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True, check=False,
    )
    print(f"clocks (sm, max sm, temperature, power): {clocks.stdout.strip()}", flush=True)

    t0 = time.perf_counter()
    build = kernels.build()
    print(
        f"build: {json.dumps({k: round(v, 2) for k, v in build.items()})} "
        f"total {time.perf_counter() - t0:.2f}s",
        flush=True,
    )
    print(f"ptxas: {json.dumps(ptxas_summary(kernels))}", flush=True)
    report: dict = {}
    phase_kernels(torch, dev, report)
    phase_stream(torch, dev, report)
    phase_golden(torch, dev)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
