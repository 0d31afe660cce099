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
   costs bitwise equal; the round tail's tables, assignments, active flags
   and state word bitwise equal to ``round_tail_plain`` on CPU copies at
   round 0, after 15 batches and at P=4,096 (the JAX scheduler's batch
   bucket); gang rollback (with real rollbacks, one node refunded twice or
   more) bitwise equal to ``enforce_gangs_plain``; then time each kernel,
   its plain version and, where one exists, the one PyTorch call that
   computes the same function;
4. the headline stream: ``solve_stream`` over 98,304 pods and 10,000 nodes
   in 192 batches of 512 (``bench.py``'s fixture and parameters), one CUDA
   graph replay a batch. One warm-up pass (it captures the graph; its host
   syncs are counted), then 3 timed passes that must make no host sync
   (``torch.cuda.set_sync_debug_mode("error")``); launch counts are zeroed
   just before the first timed pass and read just after it (a count is of
   wrapper launches, replays included; ``kernels_per_launch`` in the
   kernels line says how many kernels one runs: two for nomination, its
   tiled and merge kernels); ``rounds_used`` a batch comes from the
   device. Then the kernels launched in one profiled pass, the busy share,
   the cost of the trips after each batch's fixed point (a graph of empty
   trips, timed), and one eager pass through the plain versions on the
   card: assignments, final tables and rounds must be identical;
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

    # a profiled window has been seen to lose its kernel intervals now and
    # then (PERF.md section 7): one more window before "not measured"
    for _ in range(2):
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
        if total > 0:
            return total / iters / 1000.0
    return None


#: kernels one wrapper call launches together, listed under one name
KERNEL_GROUPS = {
    "nominate_kernel": "nominate_kernel + nominate_merge_kernel",
    "nominate_merge_kernel": "nominate_kernel + nominate_merge_kernel",
}


def is_sync_warning(w) -> bool:
    """A host sync reported by ``torch.cuda.set_sync_debug_mode("warn")``
    (not the notice that the mode is a prototype, given when it is set)."""
    msg = str(w.message)
    return "synchronizing" in msg and "prototype" not in msg


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
    kernels = copies = 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        if evt.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        name = evt.name.replace("(anonymous namespace)::", "")
        name = name.removeprefix("void ").split("(")[0].split("<")[0]
        name = name.split("::")[-1].strip()[:60]
        name = KERNEL_GROUPS.get(name, name)
        by_name[name] = by_name.get(name, 0.0) + evt.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if busy_ms <= 0:
        return {"device_busy_ms": "not measured", "kernels_launched": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / (wall_s * 1e3),
        "kernels_launched": kernels,
        "copies_launched": copies,
        "top_device_ms": dict(top),
    }


@contextlib.contextmanager
def plain_versions():
    """Route the solver through the kernels' plain versions for a run on
    the card (the wrappers launch the kernels for every CUDA tensor)."""
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import solver

    def nominate_plain(*args, state=None):
        return nominate_ops.nominate_plain(*args)

    def enforce_gangs_plain_(result, pods):
        out = solver.enforce_gangs_plain(result, pods)
        for name in solver._GANG_FIELDS:
            if getattr(result, name) is not None:
                getattr(result, name).copy_(getattr(out, name))

    saved = (nominate_ops.nominate, commit_ops.round_tail, solver._enforce_gangs_)
    nominate_ops.nominate = nominate_plain
    commit_ops.round_tail = commit_ops.round_tail_plain
    solver._enforce_gangs_ = enforce_gangs_plain_
    try:
        yield
    finally:
        nominate_ops.nominate, commit_ops.round_tail, solver._enforce_gangs_ = saved


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


def round_tail_args(torch, spods, nom_args, top_cost, top_idx):
    """``round_tail``'s arguments for round 0 of a batch: its nomination,
    the sorted pods, the node state of ``nom_args`` (tables cloned), and
    the loop state before the first round (nothing assigned, every valid
    pod active, ``done`` clear, no rounds)."""
    p = spods.requests.shape[0]
    dev = top_cost.device
    state = torch.zeros((2,), dtype=torch.int32, device=dev)
    state[0].copy_(~spods.valid.any())
    return [
        top_cost, top_idx, spods.requests, spods.estimate, spods.is_prod, nom_args[3],
        nom_args[11], nom_args[5], nom_args[9], nom_args[12], nom_args[13],
        nom_args[6].clone(), nom_args[7].clone(), nom_args[8].clone(),
        torch.full((p,), -1, dtype=torch.int32, device=dev), spods.valid.clone(), state,
    ]


#: the arguments ``round_tail`` updates in place (tables and loop state)
ROUND_MUTABLE = slice(11, 17)


def ptxas_summary(kernels) -> dict:
    """Registers, shared memory and spills of the main path's kernels
    (nominate at D=2 with four list slots, K <= 4), from ``nvcc -Xptxas -v``
    in the build logs, and the most registers and spill bytes over every
    nominate instantiation."""
    import re

    wanted = {
        "nominate_kernelILi2ELi4E": "nominate_kernel<2,4>",
        "nominate_merge_kernelILi4E": "nominate_merge_kernel<4>",
        "round_tail_kernelILi2E": "round_tail_kernel<2>",
        "enforce_gangs_kernel": "enforce_gangs_kernel",
    }
    out: dict = {}
    worst = {"registers": 0, "spill_bytes": 0}
    for src in ("nominate", "round", "gangs"):
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
    checks = {"nominate": 0.0, "round_tail": 0.0, "enforce_gangs": 0.0}
    rollbacks = []
    timing_inputs = None

    def check_round_tail(label, spods, nom_args):
        """The round tail on the kernel's own nomination of round 0 against
        round_tail_plain on CPU copies; returns its arguments."""
        top_cost, top_idx = nominate_ops.nominate(*nom_args, 4, 4.0, True)
        args = round_tail_args(torch, spods, nom_args, top_cost, top_idx)
        host = [t.cpu() for t in args]
        work = [t.clone() for t in args]
        commit_ops.round_tail(*work, 0.35)
        commit_ops.round_tail_plain(*host, 0.35)
        torch.cuda.synchronize()
        names = ("requested", "estimated_used", "prod_used", "assigned", "active", "state")
        for name, tk, tp in zip(names, work[ROUND_MUTABLE], host[ROUND_MUTABLE]):
            if not bits_equal(tk.cpu().numpy(), tp.numpy()):
                fail(f"round_tail ({label}): {name} differs from round_tail_plain")
            checks["round_tail"] = max(checks["round_tail"], max_abs(tk.cpu().numpy(), tp.numpy()))
        if int((work[14] >= 0).sum()) == 0:
            fail(f"round_tail ({label}): the check needs a round that places pods")
        return args

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
        rt_args = check_round_tail(label, spods, nom_args)
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
            timing_inputs = (nom_args, rt_args, spods, pre, pods_b)
    # the JAX scheduler's batch bucket: 4,096 pods in one round
    big = solver.tree_map(lambda a: a[:8].reshape((-1,) + a.shape[2:]), pods_s)
    check_round_tail("P=4096", *round_inputs(big, nodes_t, params_t))
    print(f"kernel checks: bitwise equal to the plain versions {json.dumps(checks)} "
          f"(round tail at round 0, after 15 batches and at P=4096); "
          f"gang rollbacks {json.dumps(rollbacks)}", flush=True)

    nom_args, rt_args, spods, pre, pods_b = timing_inputs
    p, d = spods.requests.shape
    n = nom_args[5].shape[0]

    def t_nominate():
        nominate_ops.nominate(*nom_args, 4, 4.0, False)

    def t_nominate_plain():
        nominate_ops.nominate_plain(*nom_args, 4, 4.0, False)

    # the round tail works in place and may set `done`: every timed call
    # gets its own copy of the tables and the loop state
    rt_iters = 200
    rt_copies = iter([[t.clone() for t in rt_args[ROUND_MUTABLE]]
                      for _ in range(2 * rt_iters + 2)])
    rt_fixed = rt_args[:ROUND_MUTABLE.start]

    def t_round_tail():
        commit_ops.round_tail(*rt_fixed, *next(rt_copies), 0.35)

    def t_round_tail_plain():
        commit_ops.round_tail_plain(
            *rt_fixed, *[t.clone() for t in rt_args[ROUND_MUTABLE]], 0.35
        )

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
    # round tail: the nomination, the pods' columns and the loop state read
    # once, each nominated node's row of the node tables read once, the
    # winners' node rows and the loop state written once
    k = rt_args[0].shape[1]
    _, node_key = commit_ops._choose(rt_args[0], rt_args[1], rt_args[15], n)
    touched = int(torch.unique(node_key[node_key < n]).numel())
    after = [t.clone() for t in rt_args[ROUND_MUTABLE]]
    commit_ops.round_tail(*rt_fixed, *after, 0.35)
    won = int((after[0] != rt_args[11]).any(dim=1).sum())
    rt_bytes = (p * k * 8 + p * (2 * d * 4 + 2) + p * (1 + 4) * 2 + 8 * 2
                + touched * (6 * d * 4 + 1 + 4) + won * 3 * d * 4)
    sort_len = 1 << max(p - 1, 0).bit_length()
    lg = sort_len.bit_length() - 1
    rt_ops = (p * (k + 4) + (sort_len // 2) * lg * (lg + 1) // 2
              + p * d * (3 * 2 + 20) + p * d * 3)
    n_rolled = int(rolled.sum())
    refunded_nodes = int(torch.unique(ids_l).numel())
    gang_bytes = p * (4 * 4 + 2 * d * 4 + 2) + refunded_nodes * 3 * d * 4 * 2
    gang_ops = p * 4 + n_rolled * 3 * d + refunded_nodes * 3 * d

    # kernels a wrapper call launches: nomination adds a merge kernel when
    # the node axis is cut into chunks
    nom_chunk = nominate_ops.chunk_of(kernels.library("nominate"), p, n, d, 4, dev.index or 0)
    per_call = {"nominate": 1 if nom_chunk >= n else 2, "round_tail": 1, "enforce_gangs": 1}

    def bound(nbytes, nops):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / FP32_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    rows = []
    for name, source, replaces, fn, plain, lib_fn, kname, nbytes, nops, err, iters in (
        ("nominate", "koordinator_tpu_torch/csrc/nominate.cu",
         "koordinator_tpu/ops/solver.py:1121", t_nominate, t_nominate_plain, None,
         "nominate", nom_bytes, nom_ops, checks["nominate"], 200),
        ("round_tail", "koordinator_tpu_torch/csrc/round.cu",
         "koordinator_tpu/ops/solver.py:1204", t_round_tail, t_round_tail_plain, None,
         "round_tail_kernel", rt_bytes, rt_ops, checks["round_tail"], rt_iters),
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
    return nom_args, rt_args


def empty_trip_ms(torch, nom_args, rt_args, trips: int = 100):
    """CUDA-event milliseconds of one round trip after the fixed point —
    nomination (tiled and merge kernels) and round tail, each returning at
    once on ``done`` — from a CUDA graph of ``trips`` such trips, as the
    stream's graph runs them."""
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops

    args = list(rt_args)
    args[16] = torch.tensor([1, 0], dtype=torch.int32, device=rt_args[0].device)

    def trip():
        nominate_ops.nominate(*nom_args, 4, 4.0, True, state=args[16])
        commit_ops.round_tail(*args, 0.35)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trip()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        for _ in range(trips):
            trip()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    ms = cuda_ms(torch, graph.replay, 10) / trips
    torch.cuda.synchronize()
    return ms


def phase_stream(torch, dev, report, trip_inputs):
    """Phase 4: the headline stream through the kernels, one CUDA graph
    replay a batch, then once eagerly through the plain versions."""
    import warnings

    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = headline_inputs(build_fixture(0))
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)
    n_batches = N_PODS // BATCH
    rounds = torch.zeros(n_batches, dtype=torch.int32, device=dev)

    def run(sync_mode="error", **kw):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode(sync_mode)
        try:
            out = solver.solve_stream(pods_t, nodes_t, params_t, **SOLVE, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        placed_total = int(out[2].sum())  # the caller's read: waits for the card
        return out, placed_total, time.perf_counter() - t0

    # first pass: captures the graph; every host sync it makes is a warning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, first_seconds = run("warn")
    first_syncs = sum(is_sync_warning(w) for w in caught)
    kernels.reset_launches()
    # timed passes: any host sync inside solve_stream raises
    out, placed, seconds = run(rounds_out=rounds)
    launches = dict(kernels.launches)
    replays = dict(kernels.replays)
    rounds_np = rounds.cpu().numpy()
    times = [seconds] + [run()[2] for _ in range(PASSES - 1)]
    for name in ("nominate", "round_tail", "enforce_gangs"):
        if launches.get(name, 0) <= 0:
            fail(f"the headline stream launched no {name} kernel")
    if launches["enforce_gangs"] != n_batches or replays.get("solve_stream") != n_batches:
        fail(f"enforce_gangs launched {launches['enforce_gangs']} times and the graph "
             f"replayed {replays} times, not once a batch")
    plain_rounds = torch.zeros(n_batches, dtype=torch.int32, device=dev)
    with plain_versions():
        p_out, p_placed, p_seconds = run(0, cuda_graph=False, rounds_out=plain_rounds)
    if not bits_equal(out[0].cpu().numpy(), p_out[0].cpu().numpy()):
        fail("headline stream: kernel and plain assignments differ")
    for f in ("requested", "estimated_used", "prod_used"):
        if not bits_equal(getattr(out[1], f).cpu().numpy(), getattr(p_out[1], f).cpu().numpy()):
            fail(f"headline stream: kernel and plain final {f} differ")
    if not np.array_equal(rounds_np, plain_rounds.cpu().numpy()):
        fail("headline stream: rounds_used a batch differ between the graph and the plain run")
    if placed < 0.5 * N_PODS:
        fail(f"headline stream placed only {placed}/{N_PODS} pods")
    med = sorted(times)[len(times) // 2]
    profile = stream_profile(torch, run, med)
    empty_trips = int((SOLVE["max_rounds"] - rounds_np).sum())
    trip_ms = empty_trip_ms(torch, *trip_inputs)
    report["stream"] = dict(
        pods=N_PODS, nodes=N_NODES, batches=n_batches, placed=placed,
        pods_per_s=N_PODS / med, pass_seconds=times,
        first_pass_seconds=first_seconds, plain_pass_seconds=p_seconds,
        rounds_used=int(rounds_np.sum()), plain_rounds_used=int(plain_rounds.sum()),
        mean_rounds_per_batch=float(rounds_np.mean()),
        rounds_per_batch_histogram=np.bincount(rounds_np).tolist(),
        graph_replays=replays.get("solve_stream", 0),
        launches=launches,
        host_syncs_per_pass=0, host_syncs_first_pass=first_syncs,
        empty_trips=empty_trips, empty_trip_ms=trip_ms,
        empty_trips_ms_per_pass=empty_trips * trip_ms,
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
    trip_inputs = phase_kernels(torch, dev, report)
    phase_stream(torch, dev, report, trip_inputs)
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
