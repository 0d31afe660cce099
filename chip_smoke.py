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
   more) bitwise equal to ``enforce_gangs_plain``; the shortlist build and
   round at K=64 bitwise equal to their plain versions at round 0 and
   after 15 batches (the round also with a bound below every cost), and
   the contention fixture (384 pods × 32 nodes, K=4) run trip by trip
   through the kernels and through the plain versions on CPU copies, the
   fallback firing on both counts; then time each kernel, its plain
   version and, where one exists, the one PyTorch call that computes the
   same function;
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
   card: assignments, final tables and rounds must be identical. Then the
   same stream with the candidate shortlist at ``shortlist_k=64`` (the JAX
   scheduler's default), counts zeroed and read around its first timed
   pass as above: its assignments, final tables and rounds must equal the
   stream's without it, and an eager pass through the plain versions must
   match; the line reports both pods/s, the fallback counts and the
   builds;
5. the committed goldens (``tests/data/torch_golden_loadaware.npz`` and
   ``torch_golden_shortlist.npz``): the JAX package's ``solve_stream``
   result on a 2×512-pod × 2,000-node fixture, without and with the
   shortlist, and its shortlisted ``assign`` on the contention fixture
   with its fallback counts; the port on the card must reproduce them bit
   for bit;
6. two scheduling cycles on resident node tables (10,000 nodes, 16
   batches): a shortlist stream, 1% of the rows refreshed in place by
   ``scatter_rows`` (every ``data_ptr`` kept), a second stream that must
   replay the first one's graph and equal a fresh solve on freshly built
   tables; ``gather_rows`` and ``_apply_commit_deltas_`` against the CPU;
   the row functions' times.
7. quotas and node masks, kernels: on the kernel check's fixture with the
   quota trees of ``QUOTA_TREES`` (Q = 21, ``_quota_commit``'s one-hot
   branch; Q = 1,057, its sorted branch), their chains and node masks, the
   quota gate (``csrc/quota.cu``), the round tail's quota commit and next
   gate, and ``enforce_gangs``' quota refund (with rollbacks), bitwise
   equal to their plain versions at P=512 (round 0, and after
   ``QUOTA_LATER`` batches, where the quotas refuse pods their nodes
   accept) and P=4,096; the three pricing kernels with a node mask, some
   rows all false, equal to theirs; then their times;
8. the quota and node-mask streams: the scheduler's ``solve_stream_full``
   at full size (98,304 pods, 10,000 nodes, 192 batches of 512, bench's
   arguments) with each tree, its chains and the stacked [192, 512,
   10,000] node mask, with ``shortlist_k=64`` and without: one graph
   replay a chunk, a first pass, then 3 timed passes with no host sync
   (counts zeroed just before the first and read just after it, every
   kernel of the path launched), one profiled pass; placed pods and
   summed rounds equal to the JAX package's (``QUOTA_EXPECTED``), the
   assignments' sha256, placed count, rounds and fallback counts equal to
   ``tests/data/torch_golden_quota.npz``; then one eager pass through the
   plain versions, equal.
9. NUMA zones, kernels: on the kernel check's fixture with
   ``zone_tables``' zones (two zones a node, four on a quarter, padded
   zones, nodes without zones, all four policies, MostAllocated picks on
   half the nodes, CPU ratios 1.3 and 1.5, a fifth of the pods required),
   the three pricing kernels' NUMA instantiations with each aligned
   scoring and none, the round tail's zone phase (``csrc/round_zone.cu``)
   and ``enforce_gangs``' zone refund (a Strict gang of zoned pods rolled
   back), bitwise equal to their plain versions at P=512 (the start and
   after 3 batches) and 4,096; then their times;
10. rounds above 4,096 pods: the big batch (``bigbatch_fixture``: D=4,
    2,000 nodes, a Strict gang of 6,000 that rolls back) at P=8,192,
    16,384 and 32,768, without quotas and with the sorted tree: the round
    tail (``csrc/round_big.cu``, its working set in device memory) and the
    rollback against their plain versions, ``assign`` against the
    big-batch goldens (P=8,192 and 32,768) and the plain versions on the
    card (16,384 and 32,768); times;
11. the NUMA streams: ``solve_stream_full(numa=...)`` at full size on the
    headline fixture with ``binpack_numa``'s zones (``bench_suite.py``'s
    ``bench_numa_20k`` recipe) for each of ``NUMA_SCORINGS``, with
    ``shortlist_k=64`` and without: one graph replay a chunk, timed passes
    with no host sync, every kernel of the path launched; placed count,
    rounds, fallbacks and the sha256 of the assignments, zone picks and
    final zone table equal to ``tests/data/torch_golden_numa.npz``; then
    an eager pass through the plain versions, equal;
12. devices, kernels: on the kernel check's fixture with
    ``device_tables``' devices (8-GPU nodes, 4-GPU nodes padded, nodes
    without GPUs, a few 16-GPU nodes: G = 16; RDMA on half the nodes, FPGA
    on a tenth; and a G = 8 table with RDMA not tracked; pods asking for
    whole GPUs, shares, both, RDMA and FPGA; 2-member gangs that roll
    back), ``csrc/device_prep.cu``, the three pricing kernels' device
    instantiations under each ``device_scoring`` and none, the round
    tail's device phase (alone, with quotas, with zones, with both) and
    ``enforce_gangs``' device refunds, bitwise equal to their plain
    versions at P=512 (the start and after 3 batches) and 4,096; then
    their times;
13. the device streams: ``solve_stream_full(devices=...)`` at full size
    on the headline fixture with ``gpu_fleet``'s devices (after
    ``bench_suite.py``'s ``bench_device_gang_20k`` and
    ``_build_device_stream``) for each cell of ``DEVICE_CELLS`` (no
    scoring and LeastAllocated, K=64 and off; MostAllocated at K=64, which
    the reference's gate turns into the full-axis solve): one graph replay
    a chunk, timed passes with no host sync, every kernel of the path
    launched; placed count, rounds, fallbacks and the sha256 of the
    assignments and the final slot table, RDMA and FPGA counts equal to
    ``tests/data/torch_golden_device.npz``; then an eager pass through the
    plain versions, equal.
14. the cost-transform route's kernels: ``csrc/cost_full.cu`` (every
    pair's pre-jitter cost and flags) and ``csrc/nominate_cost.cu`` (the
    jitter, ``+inf`` and the top-k over a transformed cost) against their
    plain versions at P=512 and 4,096 over 10,000 nodes, plain, with a
    node mask, with ``zone_tables(2)``' zones, with ``device_tables(4)``'
    devices and with both, at round 0 and after 3 batches, under a veto
    and a bias transform, with ``approx_topk`` and without: cost, flags
    and nomination vector bitwise equal; then their times, the plain
    versions', ``torch.topk``'s, and ``device_consumption``'s;
15. the scheduler seam: ``BatchScheduler.schedule`` at full size on the
    ``__graft_entry__._dryrun_production_scheduler`` recipe
    (``production_scheduler``, ``production_pods``: 10,000 nodes, 20,480
    pods in five chunks through ``solve_stream_full`` at K=64, then two
    cycles on the leftovers and waves of 4,608), and with
    ``seam_transform`` registered (8,192 pods through
    ``_dispatch_pipelined`` and ``assign(cost_transform=)``): each
    cycle's digest of the bound pods with their nodes and annotations and
    of the unschedulable names equal to ``tests/data/torch_golden_seam.npz``
    (the JAX scheduler's), the fallback ladder at level 0 with no solver
    failure, counts zeroed before each path's cycles and read after them
    with every kernel of the path launched; each cycle's wall time split
    into host lowering, device solve and Reserve/commit, its graph
    captures, host syncs in the solve and whether the resident node
    tables kept their addresses; the busy share of each path's last
    cycle, profiled. The recipe is built from the modules a caller
    passes in (``SeamModules``; here the port's), so the golden's tool
    and the tests build the reference's from the same code.

A kernel's device time (``device_ms``) is read from ``torch.profiler``
only from a window that holds all of its kernels (else "not measured",
null), and the run fails if one falls below its bound.

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
GOLDEN_SHORTLIST = os.path.join(ROOT, "tests", "data", "torch_golden_shortlist.npz")

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

#: the JAX scheduler's candidate shortlist (``BatchScheduler.shortlist_k``)
SHORTLIST_K = 64
#: the contention fixture's shortlist: small enough that rounds fall back
CONTENTION_K = 4

GOLDEN_QUOTA = os.path.join(ROOT, "tests", "data", "torch_golden_quota.npz")
#: the quota streams' trees, (orgs, teams an org) under one root, the
#: 3-level shape of ``bench_suite.py:_build_quota`` at two sizes: Q = 21
#: takes ``_quota_commit``'s one-hot branch (Q·D = 42 <= 1024), Q = 1,057
#: its sorted branch
QUOTA_TREES = {"onehot": (4, 4), "sorted": (32, 32)}
#: the draws of the pods' orgs, teams and node constraints
QUOTA_SEED = 11
#: what the JAX package gives on the full-size quota streams (98,304 pods,
#: 10,000 nodes, 192 x 512, bench's arguments; the same with K=64 and
#: without): placed pods, rounds summed over the batches
QUOTA_EXPECTED = {"onehot": (58_826, 205), "sorted": (59_112, 252)}
#: the kernel checks' later state: this many batches of the check fixture
#: committed, after which both trees refuse pods their nodes accept
QUOTA_LATER = 9

GOLDEN_BIGBATCH = os.path.join(ROOT, "tests", "data", "torch_golden_bigbatch.npz")
#: the same at 32,768 pods (a gang past the bucket, padded)
GOLDEN_BIGBATCH_32K = os.path.join(ROOT, "tests", "data", "torch_golden_bigbatch_32768.npz")
#: the big batch: one round of BIG_PODS pods at D = 4 over BIG_NODES nodes,
#: with a Strict gang of BIG_GANG members that rolls back
BIG_PODS = 8_192
BIG_NODES = 2_000
BIG_GANG = 6_000
BIG_SEED = 5

GOLDEN_NUMA = os.path.join(ROOT, "tests", "data", "torch_golden_numa.npz")
#: the NUMA streams' aligned-score strategies, each run with K=64 and
#: without the shortlist
NUMA_SCORINGS = (None, "LeastAllocated")
#: the NUMA kernel checks' zone-table draws (``zone_tables``)
NUMA_SEED = 2
GOLDEN_DEVICE = os.path.join(ROOT, "tests", "data", "torch_golden_device.npz")
#: the device kernel checks' table draws (``device_tables``)
DEVICE_SEED = 4
#: the full-size device streams (phase 13): (device_scoring, shortlist_k);
#: MostAllocated turns the shortlist off (the reference's gate)
DEVICE_CELLS = ((None, SHORTLIST_K), (None, None), ("LeastAllocated", SHORTLIST_K),
                ("LeastAllocated", None), ("MostAllocated", SHORTLIST_K))
#: what a device stream returns, in order (``device_stream_full``)
DEVICE_OUTPUTS = ("assignments", "pod_zones", "rounds", "fallbacks", "slot_free",
                  "rdma_free", "fpga_free")


def device_key(scoring, k) -> str:
    """A device stream's key in the golden: its scoring and K (0: off)."""
    return f"{(scoring or 'none').lower()}_k{k or 0}"


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


def contention_fixture():
    """Near-identical pods hammering a few cheap nodes, which makes the
    shortlist's exactness check fail (a copy of the fixture of
    ``tests/test_shortlist.py::test_high_contention_forces_fallback_still_exact``:
    384 pods, 32 nodes, D=2, solved with ``assign``'s defaults and
    ``shortlist_k=CONTENTION_K``). Returns numpy dicts (nodes, pods,
    params)."""
    rng = np.random.default_rng(7)
    p, n, d = 384, 32, 2
    alloc = np.full((n, d), 64.0, np.float32)
    est_used = (alloc * 0.2 * rng.uniform(0.9, 1.1, (n, d))).astype(np.float32)
    req = np.full((p, d), 4.0, np.float32)
    pods = dict(
        requests=req,
        priority=rng.integers(5000, 9999, p).astype(np.int32),
        estimate=req * np.float32(0.85),
    )
    nodes = dict(allocatable=alloc, estimated_used=est_used, prod_used=est_used * np.float32(0.5))
    params = dict(
        usage_thresholds=np.asarray((60.0, 60.0), np.float32),
        prod_thresholds=np.zeros(d, np.float32),
        score_weights=np.ones(d, np.float32),
    )
    return nodes, pods, params


def quota_tree(orgs: int, teams: int, requests):
    """A 3-level ElasticQuota tree over ``requests`` [P, D] float32: row 0
    the root with runtime 0.6 of the pods' summed demand, rows 1..orgs the
    orgs at 1.1 times an even share of it, then each org's teams at 1.2
    times an even share (teams of org o at rows 1 + orgs + o * teams + t);
    the shares overlap, so the tree binds at every level. Returns (runtime,
    used) [Q, D] float32, used zero; the arithmetic is numpy's in float32
    (``requests.sum(0)``, then ``0.6 * demand / orgs * 1.1`` and so on)."""
    demand = requests.sum(0)
    q = 1 + orgs + orgs * teams
    runtime = np.empty((q, requests.shape[1]), np.float32)
    runtime[0] = 0.6 * demand
    runtime[1 : 1 + orgs] = 0.6 * demand / orgs * 1.1
    runtime[1 + orgs :] = 0.6 * demand / (orgs * teams) * 1.2
    return runtime, np.zeros_like(runtime)


def quota_draws(orgs: int, teams: int, n_pods: int):
    """Each pod's quota chain [P, 4] int32 (team, org, root, one open
    level) and its node constraint: ``constrained`` pods (a quarter) may
    use only the nodes of their ``zone`` (node % 4 == zone)."""
    rng = np.random.default_rng(QUOTA_SEED)
    org = rng.integers(0, orgs, n_pods)
    team = rng.integers(0, teams, n_pods)
    constrained = rng.random(n_pods) < 0.25
    zone = rng.integers(0, 4, n_pods)
    chain = np.stack(
        [1 + orgs + org * teams + team, 1 + org, np.zeros(n_pods, np.int64),
         np.full(n_pods, -1)], axis=1,
    ).astype(np.int32)
    return chain, constrained, zone


def node_mask_np(constrained, zone, n_nodes: int):
    """[P, N] bool: pod p may use node n unless it is constrained to a
    zone node n is not in."""
    return ~constrained[:, None] | ((np.arange(n_nodes)[None, :] % 4) == zone[:, None])


def quota_fixture(tree: str, nodes, pods, params):
    """The quota streams' inputs over a fixture's numpy dicts: the pods
    with their chains, the tree's (runtime, used) and the constraint
    draws (constrained, zone)."""
    orgs, teams = QUOTA_TREES[tree]
    chain, constrained, zone = quota_draws(orgs, teams, pods["requests"].shape[0])
    pods = dict(pods, quota_chain=chain)
    return nodes, pods, params, quota_tree(orgs, teams, pods["requests"]), (constrained, zone)


def zone_tables(seed: int, nodes: dict, n_pods: int):
    """NUMA zone tables over a fixture's numpy node dict, drawn to reach
    every branch of the zone arithmetic: two zones a node, four on a
    quarter of the nodes (their capacity split evenly, the zones past a
    node's count padded with zero capacity), nodes with no zones at all,
    nodes that leave memory unregistered, exhausted nodes, policies over
    all four, MostAllocated picks on half the nodes, and CPU
    amplification of 1.3 and 1.5. Returns (nodes with ``cpu_amp``
    replaced, numa dict of ``zone_free``/``zone_cap`` [N, 4, 2],
    ``policy`` [N] int8 and ``zone_most`` [N] bool, ``numa_required``
    [n_pods] bool)."""
    rng = np.random.default_rng(seed + 5)
    alloc = nodes["allocatable"]
    n = alloc.shape[0]
    count = np.where(rng.random(n) < 0.25, 4, 2)
    real = np.arange(4)[None, :] < count[:, None]                       # [N, 4]
    cap = np.where(real[:, :, None], alloc[:, None, :2] / count[:, None, None], 0.0)
    cap[rng.random(n) < 0.05] = 0.0                                      # no zones
    cap[rng.random(n) < 0.05, :, 1] = 0.0                                # memory unregistered
    use = nodes["estimated_used"][:, None, :2] / count[:, None, None]
    free = np.clip(cap - use * rng.uniform(0.5, 1.5, (n, 4, 1)), 0.0, None)
    free[rng.random(n) < 0.03] = 0.0                                     # exhausted
    numa = dict(
        zone_free=free.astype(np.float32),
        zone_cap=cap.astype(np.float32),
        policy=rng.integers(0, 4, n).astype(np.int8),
        zone_most=rng.random(n) < 0.5,
    )
    amp = rng.choice(np.asarray([1.0, 1.3, 1.5], np.float32), n, p=[0.5, 0.25, 0.25])
    return dict(nodes, cpu_amp=amp), numa, rng.random(n_pods) < 0.2


def binpack_numa(nodes: dict, pods: dict):
    """The NUMA recipe of ``bench_suite.py:bench_numa_20k`` over a
    fixture's numpy dicts: two zones a node of half its allocatable, free
    ``clip(cap - est_used / 2, 0)``, SINGLE_NUMA_NODE on every node; LSR
    QoS on pods whose CPU request is a whole core and ``numa_required`` on
    half the pods (``default_rng(7)``). Returns (pods, numa dict)."""
    alloc, est = nodes["allocatable"], nodes["estimated_used"]
    zone_cap = np.repeat((alloc / 2.0)[:, None, :], 2, axis=1).astype(np.float32)
    zone_free = np.clip(zone_cap - (est / 2.0)[:, None, :], 0.0, None).astype(np.float32)
    n = alloc.shape[0]
    p = pods["requests"].shape[0]
    rng = np.random.default_rng(7)
    pods = dict(
        pods,
        qos=np.where(pods["requests"][:, 0] % 1000.0 == 0, 3, 0).astype(np.int8),
        numa_required=rng.random(p) < 0.5,
    )
    return pods, dict(zone_free=zone_free, zone_cap=zone_cap,
                      policy=np.full(n, 3, np.int8))


def device_tables(seed: int, nodes: dict, pods: dict, g16: bool = True, rdma: bool = True,
                  batch: int = BATCH):
    """DeviceShare tables over a fixture's numpy dicts, drawn to reach
    every branch of the device arithmetic: 8-GPU nodes, 4-GPU nodes padded
    to the table's width (``cap_total`` 400), nodes without GPUs and (with
    ``g16``) a few 16-GPU nodes, so G = 16 (else 8); slots fully free,
    fully used, or partly used with whole and non-integer remainders; RDMA
    NICs on half the nodes (``rdma`` False: not tracked, None) and FPGAs on
    a tenth. Pods ask for nothing, whole 1/2/4 GPUs, shares of
    30, 50 and non-integer shares, whole+share, RDMA and FPGA; and each
    batch gets four 2-member gangs of one GPU pod and one that can never
    fit, which roll back and refund. Returns (pods with ``gpu_whole``,
    ``gpu_share``, ``rdma``, ``fpga`` and the gangs, devices dict of
    ``slot_free`` [N, G], ``rdma_free``, ``fpga_free``, ``cap_total``)."""
    rng = np.random.default_rng(seed + 9)
    n = nodes["allocatable"].shape[0]
    p = pods["requests"].shape[0]
    g = 16 if g16 else 8
    kind = rng.choice(4, n, p=[0.45, 0.25, 0.25, 0.05])
    count = np.array([8, 4, 0, 16 if g16 else 8])[kind]
    real = np.arange(g)[None, :] < count[:, None]
    u = rng.random((n, g))
    rest = np.asarray([70.0, 50.0, 66.7, 12.5, 33.3, 87.5, 20.0], np.float32)
    slots = np.where(real, 100.0, 0.0).astype(np.float32)
    slots = np.where(real & (u < 0.15), 0.0, slots)
    slots = np.where(real & (u >= 0.15) & (u < 0.45), rest[rng.integers(0, 7, (n, g))], slots)
    devices = dict(
        slot_free=slots.astype(np.float32),
        rdma_free=(np.where(rng.random(n) < 0.5, rng.integers(1, 5, n), 0).astype(np.float32)
                   if rdma else None),
        fpga_free=np.where(rng.random(n) < 0.1, rng.integers(1, 3, n), 0).astype(np.float32),
        cap_total=(count * 100.0).astype(np.float32),
    )
    r = rng.random(p)
    whole = np.where((r >= 0.35) & (r < 0.60), rng.choice([1, 2, 4], p, p=[0.5, 0.3, 0.2]), 0)
    shares = np.asarray([30.0, 50.0, 33.3, 12.5, 70.5], np.float32)
    share = np.where((r >= 0.60) & (r < 0.80), shares[rng.integers(0, 5, p)], 0.0)
    both = (r >= 0.80) & (r < 0.88)
    whole = np.where(both, rng.integers(1, 3, p), whole)
    share = np.where(both, shares[rng.integers(0, 3, p)], share)
    gpu = (whole > 0) | (share > 0)
    rdma_req = np.where((gpu & (rng.random(p) < 0.3)) | ((r >= 0.88) & (r < 0.94)),
                        rng.integers(1, 3, p), 0)
    fpga_req = np.where((gpu & (rng.random(p) < 0.05)) | (r >= 0.94), 1, 0)
    pods = dict(pods, gpu_whole=whole.astype(np.int32), gpu_share=share.astype(np.float32),
                rdma=rdma_req.astype(np.int32), fpga=fpga_req.astype(np.int32))
    # four 2-member gangs a batch (ids 8..11, past rich_fixture's): a
    # one-GPU pod and a pod of 64 GPUs, which no node holds
    gang_id = pods.get("gang_id", np.full(p, -1, np.int32)).copy()
    gang_min = pods.get("gang_min", np.zeros(p, np.int32)).copy().reshape(-1, batch)
    for b in range(p // batch if batch >= 12 else 0):
        rows = b * batch + rng.choice(batch, 8, replace=False)
        for j in range(4):
            gang_id[rows[2 * j : 2 * j + 2]] = 8 + j
            whole[rows[2 * j]], share[rows[2 * j]] = 1, 0.0
            whole[rows[2 * j + 1]] = 64
        gang_min[b, 8:12] = 2
    pods.update(gang_id=gang_id.astype(np.int32), gang_min=gang_min.reshape(-1),
                gpu_whole=whole.astype(np.int32), gpu_share=share.astype(np.float32))
    return pods, devices


def gpu_fleet(nodes: dict, pods: dict, batch: int = BATCH, rdma: bool = True):
    """The full-size device recipe over a fixture's numpy dicts, after
    ``bench_suite.py``: ``bench_device_gang_20k``'s nodes (8 GPU slots of
    100 a node, ``cap_total`` 800) and two-member gangs whose members ask
    for the same 1, 2 or 4 whole GPUs (the first quarter of each batch,
    gang ids 0..63 of the batch, minMember 2), ``_build_device_stream``'s
    mix (whole 1/2/4, shares of 50 and 30, ``default_rng(11)``) on the next
    three eighths, no GPU on the rest. RDMA: two NICs on every other node
    (``rdma`` False: not tracked), one asked for by the 4-GPU gang members;
    FPGA: one on every tenth node, asked for by 1% of the stream pods. The
    batches ask for about 600 GPUs each, so the fleet's 80,000 run out
    about two thirds of the way through the backlog, and gangs then roll
    back with refunds. Returns (pods with the gangs and device requests,
    devices dict)."""
    n = nodes["allocatable"].shape[0]
    p = pods["requests"].shape[0]
    rng = np.random.default_rng(11)
    pos = np.arange(p) % batch
    gang = pos < batch // 4
    stream = ~gang & (pos < batch // 4 + 3 * batch // 8)
    gang_id = np.where(gang, pos // 2, -1).astype(np.int32)
    gang_size = np.asarray([1, 2, 4])[rng.integers(0, 3, (p // batch, batch // 8))]
    sizes = gang_size[np.arange(p) // batch, np.minimum(pos, batch // 4 - 1) // 2]
    whole = np.where(gang, sizes, 0)
    kind = rng.integers(0, 5, p)
    whole = np.where(stream, np.asarray([4, 2, 1, 0, 0])[kind], whole)
    share = np.where(stream, np.asarray([0.0, 0.0, 0.0, 50.0, 30.0])[kind], 0.0)
    gang_min = np.zeros((p // batch, batch), np.int32)
    gang_min[:, : batch // 8] = 2
    pods = dict(
        pods,
        gang_id=gang_id,
        gang_min=gang_min.reshape(-1),
        gpu_whole=whole.astype(np.int32),
        gpu_share=share.astype(np.float32),
        rdma=np.where(gang & (whole == 4), 1, 0).astype(np.int32),
        fpga=np.where(stream & (rng.random(p) < 0.01), 1, 0).astype(np.int32),
    )
    devices = dict(
        slot_free=np.full((n, 8), 100.0, np.float32),
        rdma_free=np.where(np.arange(n) % 2 == 0, 2.0, 0.0).astype(np.float32) if rdma else None,
        fpga_free=np.where(np.arange(n) % 10 == 0, 1.0, 0.0).astype(np.float32),
        cap_total=np.full(n, 800.0, np.float32),
    )
    return pods, devices


def bigbatch_fixture(n_pods: int, n_nodes: int = BIG_NODES, seed: int = BIG_SEED):
    """One round of ``n_pods`` pods at D = 4 (cpu, memory and two more
    dims a node and a pod carry: ``rich_fixture``'s first two, then 0.5
    and 0.25 of its memory), the batch of a gang larger than the JAX
    scheduler's bucket: its first ``BIG_GANG`` pods are one Strict gang
    whose minMember equals its size, ten of them invalid (so it cannot be
    placed whole and rolls back), the next 500 one NonStrict gang of
    minMember 600 (kept as placed). Returns numpy dicts (nodes, pods,
    params)."""
    nodes, pods, params = rich_fixture(seed, n_nodes, n_pods, batch=n_pods)

    def widen(a):
        return np.concatenate([a, a[:, 1:2] * 0.5, a[:, 1:2] * 0.25], 1).astype(np.float32)

    for k in ("allocatable", "estimated_used", "prod_used"):
        nodes[k] = widen(nodes[k])
    nodes["custom_thresholds"] = np.pad(nodes["custom_thresholds"], ((0, 0), (0, 2)))
    nodes["custom_prod_thresholds"] = np.pad(nodes["custom_prod_thresholds"], ((0, 0), (0, 2)))
    for k in ("requests", "estimate"):
        pods[k] = widen(pods[k])
    gang_id = np.full(n_pods, -1, np.int32)
    gang_id[:BIG_GANG] = 0
    gang_id[BIG_GANG : BIG_GANG + 500] = 1
    gang_min = np.zeros(n_pods, np.int32)
    gang_min[:2] = (BIG_GANG, 600)
    nonstrict = np.zeros(n_pods, bool)
    nonstrict[1] = True
    valid = pods["valid"].copy()
    valid[:BIG_GANG] = True
    valid[BIG_GANG - 10 : BIG_GANG] = False
    pods.update(gang_id=gang_id, gang_min=gang_min, gang_nonstrict=nonstrict, valid=valid)
    params = dict(
        usage_thresholds=np.asarray((65.0, 95.0, 0.0, 0.0), np.float32),
        prod_thresholds=np.asarray((60.0, 0.0, 0.0, 0.0), np.float32),
        score_weights=np.ones(4, np.float32),
    )
    return nodes, pods, params


def bigbatch_quotas(pods: dict):
    """The big batch's quota tree and chains: ``quota_draws``' chains
    over the ``QUOTA_TREES["sorted"]`` tree (Q = 1,057, the sorted branch
    at D = 4) of the batch's requests. Returns (pods with the chains,
    (runtime, used))."""
    orgs, teams = QUOTA_TREES["sorted"]
    chain, _, _ = quota_draws(orgs, teams, pods["requests"].shape[0])
    return dict(pods, quota_chain=chain), quota_tree(orgs, teams, pods["requests"])


def fixture_digest(*dicts) -> str:
    h = hashlib.sha256()
    for d in dicts:
        for k in sorted(d):
            h.update(k.encode())
            h.update(np.ascontiguousarray(d[k]).tobytes())
    return h.hexdigest()


def assignments_digest(asg) -> str:
    """sha256 of a stream's assignments as little-endian int32 [C, P]."""
    return hashlib.sha256(np.ascontiguousarray(asg, dtype="<i4").tobytes()).hexdigest()


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


#: each :func:`device_ms` reading: the kernel name filter, the window's
#: calls, the matching kernels of each one-call window and of each window
#: of ``iters`` calls, the edge markers each window lost, and whether one
#: was taken
DEVICE_WINDOWS: list = []
#: the kernel of ``torch.cuda._sleep``: a profiled window opens with
#: :data:`PAD` of them and closes with one. A window has been seen to drop
#: the first few kernels it ran (up to eight; one-call windows all of
#: theirs; PERF.md section 7), and the pad takes that loss
MARKER = "spin_kernel"
PAD = 64


def device_ms(torch, fn, iters: int, name_part: "str | None"):
    """Mean device time per call of the CUDA kernels whose name contains
    ``name_part`` (all of them for None), from ``torch.profiler``.

    A profiled window can lose some of its kernel intervals (PERF.md
    section 7), and a sum over what is left reads as a faster kernel. So
    each window opens with :data:`PAD` marker kernels and closes with
    one (:data:`MARKER`), the kernels of one
    call are counted first (the most of two profiled calls), and a
    window of ``iters`` calls is taken only when it holds ``iters`` times
    as many; after three windows that do not, None (not measured). Each
    reading is logged in :data:`DEVICE_WINDOWS`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log = dict(kernels=name_part, iters=iters, per_call=[], windows=[], markers_lost=0,
               taken=False)

    def window(calls: int) -> list:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PAD):
                torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
        kept = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
        log["markers_lost"] += PAD + 1 - sum(MARKER in evt.name for evt in kept)
        return [(evt.name, evt.time_range.elapsed_us()) for evt in kept
                if MARKER not in evt.name and (name_part is None or name_part in evt.name)]

    log["per_call"] = [len(window(1)), len(window(1))]
    DEVICE_WINDOWS.append(log)
    per_call = max(log["per_call"])
    if per_call == 0:
        return None
    for _ in range(3):
        events = window(iters)
        log["windows"].append(len(events))
        if len(events) == iters * per_call:
            log["taken"] = True
            return sum(t for _, t in events) / iters / 1000.0
        log.setdefault("names", {})
        for name, _ in events:
            log["names"][name[:80]] = log["names"].get(name[:80], 0) + 1
    return None


def bound_of(nbytes: int, nops: int):
    """The least milliseconds the card could take for a call that moves
    ``nbytes`` and does ``nops`` fp32 operations, and which of the two
    bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pair_ops(d: int, pairs: int, bind_pairs: int, threshold_checks: int, feas_pairs: int) -> int:
    """fp32 operations of pricing (pod, node) pairs on these inputs (see
    PERF.md): the fit, 3D+1 a pair; the amplified-CPU fit, 5 a pair of a
    cpuset-bound pod; 7D a usage or prod threshold test of a pair on a
    fresh node; the score and jitter, 9D+10 a feasible pair."""
    return (pairs * (3 * d + 1) + bind_pairs * 5 + threshold_checks * 7 * d
            + feas_pairs * (9 * d + 3 + 7))


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
    from koordinator_tpu_torch.ops import device as device_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import quota as quota_ops
    from koordinator_tpu_torch.ops import shortlist as shortlist_ops
    from koordinator_tpu_torch.ops import solver

    def nominate_plain(*args, state=None, **kw):
        return nominate_ops.nominate_plain(*args, **kw)

    def enforce_gangs_plain_(result, pods, slot_exists=None):
        out = solver.enforce_gangs_plain(result, pods, slot_exists)
        for name in solver._GANG_FIELDS:
            if getattr(result, name) is not None:
                getattr(result, name).copy_(getattr(out, name))

    swaps = (
        (device_ops, "device_prep", device_ops.device_prep_plain),
        (nominate_ops, "nominate", nominate_plain),
        (commit_ops, "round_tail", commit_ops.round_tail_plain),
        (solver, "_enforce_gangs_", enforce_gangs_plain_),
        (shortlist_ops, "shortlist_build", shortlist_ops.shortlist_build_plain),
        (shortlist_ops, "shortlist_round", shortlist_ops.shortlist_round_plain),
        (quota_ops, "quota_gate", quota_ops.quota_gate_plain),
    )
    saved = [getattr(module, name) for module, name, _ in swaps]
    for module, name, plain in swaps:
        setattr(module, name, plain)
    try:
        yield
    finally:
        for (module, name, _), fn in zip(swaps, saved):
            setattr(module, name, fn)


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


def setup_bytes_per_batch(pods_stacked) -> int:
    """Bytes one batch of ``solve_stream`` moves outside the kernels, in
    its PyTorch ops: the gather of the pods' fields the solve reads from
    the stacked batch (read and written), the priority sort (priorities
    read, the order written as int64), the gather of the rounds' fields
    in that order (read and written) and the un-sort of the assignment
    (order and assignment read, the result written)."""
    from koordinator_tpu_torch.ops import solver

    p = pods_stacked.requests.shape[1]

    def row(fields):
        return sum(getattr(pods_stacked, f).element_size() * getattr(pods_stacked, f)[0, 0].numel()
                   for f in fields)

    return p * (2 * row(solver._SOLVE_FIELDS) + (4 + 8) + 2 * row(solver._ROUND_FIELDS)
                + (8 + 4 + 4))


def round_tail_bytes(torch, args, n: int, quota=None) -> int:
    """Bytes a round-tail launch on ``args`` (``round_tail_args``) must
    move: the nomination, the pods' columns and the loop state read once,
    each nominated node's row of the node tables read once, the winners'
    node rows and the loop state written once (winners counted by running
    the round on copies, with ``quota`` when given)."""
    from koordinator_tpu_torch.ops import commit as commit_ops

    p, k = args[0].shape
    d = args[2].shape[1]
    _, node_key = commit_ops._choose(args[0], args[1], args[15], n)
    touched = int(torch.unique(node_key[node_key < n]).numel())
    after = [t.clone() for t in args[ROUND_MUTABLE]]
    if quota is not None:
        quota = (quota[0], quota[1], quota[2].clone(), quota[3].clone())
    commit_ops.round_tail(*args[:ROUND_MUTABLE.start], *after, 0.35, quota=quota)
    won = int((after[0] != args[11]).any(dim=1).sum())
    return (p * k * 8 + p * (2 * d * 4 + 2) + p * (1 + 4) * 2 + 8 * 2
            + touched * (6 * d * 4 + 1 + 4) + won * 3 * d * 4)


def round_tail_ops(args) -> int:
    """fp32 and integer operations of a round-tail launch: the choice, the
    sort's comparators, the cumsums and the tests."""
    p, k = args[0].shape
    d = args[2].shape[1]
    sort_len = 1 << max(p - 1, 0).bit_length()
    lg = sort_len.bit_length() - 1
    return (p * (k + 4) + (sort_len // 2) * lg * (lg + 1) // 2
            + p * d * (3 * 2 + 20) + p * d * 3)


#: the arguments ``round_tail`` updates in place (tables and loop state)
ROUND_MUTABLE = slice(11, 17)


def ptxas_summary(kernels) -> dict:
    """Registers, shared memory and spills of the main path's kernels
    (nominate at D=2 with four list slots, K <= 4, with and without a node
    mask, with NUMA zones and with devices; the round tail at D=2 without
    quotas, with them and with zones, one and four rows a thread, and at
    D=4 in device memory; the shortlist kernels without and with zones and
    with devices; the device side table), from ``nvcc -Xptxas -v`` in the
    build logs, and the most registers and spill bytes over every nominate
    instantiation."""
    import re

    wanted = {
        "nominate_kernelILi2ELi4ELb0ELb0ELb0E": "nominate_kernel<2,4>",
        "nominate_kernelILi2ELi4ELb1ELb0ELb0E": "nominate_kernel<2,4,masked>",
        "nominate_kernelILi2ELi4ELb1ELb1ELb0E": "nominate_kernel<2,4,numa>",
        "nominate_kernelILi2ELi4ELb1ELb0ELb1E": "nominate_kernel<2,4,devices>",
        "nominate_kernelILi2ELi4ELb1ELb1ELb1E": "nominate_kernel<2,4,numa,devices>",
        "nominate_merge_kernelILi4E": "nominate_merge_kernel<4>",
        "round_tail_kernelILi2ELi1ELb0ELb0ELb0E": "round_tail_kernel<2,1>",
        "round_tail_kernelILi2ELi1ELb1ELb0ELb0E": "round_tail_kernel<2,1,quota>",
        "round_tail_kernelILi2ELi4ELb1ELb0ELb0E": "round_tail_kernel<2,4,quota>",
        "round_tail_kernelILi2ELi1ELb0ELb1ELb0E": "round_tail_kernel<2,1,zone>",
        "round_tail_kernelILi2ELi4ELb0ELb1ELb0E": "round_tail_kernel<2,4,zone>",
        "round_tail_kernelILi4ELi32ELb0ELb0ELb1E": "round_tail_kernel<4,32,device memory>",
        "round_tail_kernelILi4ELi32ELb1ELb0ELb1E": "round_tail_kernel<4,32,quota,device memory>",
        "round_tail_kernelILi4ELi32ELb1ELb1ELb1E":
            "round_tail_kernel<4,32,quota,zone,device memory>",
        "enforce_gangs_kernel": "enforce_gangs_kernel",
        "shortlist_build_kernelILi2ELb1ELb0ELb0E": "shortlist_build_kernel<2,stored>",
        "shortlist_build_kernelILi2ELb1ELb1ELb0E": "shortlist_build_kernel<2,stored,numa>",
        "shortlist_build_kernelILi2ELb1ELb0ELb1E": "shortlist_build_kernel<2,stored,devices>",
        "shortlist_round_kernelILi2ELi4ELb0ELb0E": "shortlist_round_kernel<2,4>",
        "shortlist_round_kernelILi2ELi4ELb1ELb0E": "shortlist_round_kernel<2,4,numa>",
        "shortlist_round_kernelILi2ELi4ELb0ELb1E": "shortlist_round_kernel<2,4,devices>",
        "quota_gate_kernel": "quota_gate_kernel",
        "device_prep_kernel": "device_prep_kernel",
    }
    out: dict = {}
    worst = {"registers": 0, "spill_bytes": 0}
    for src in ("nominate", "round", "round_zone", "round_big", "gangs", "shortlist_build",
                "shortlist_round", "quota", "device_prep"):
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


def shortlist_golden_mismatches(torch, device) -> list:
    """The port on ``device`` against the committed shortlist golden (the
    JAX package's results, ``tools/make_torch_golden.py``): the stream at
    ``shortlist_k=SHORTLIST_K`` on the golden fixture (assignments, final
    tables, rounds and fallback counts a batch) and ``assign`` at
    ``CONTENTION_K`` on the contention fixture. Returns what differs."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import to_numpy

    gold = np.load(GOLDEN_SHORTLIST)
    nodes, pods, params = rich_fixture(GOLDEN_SEED, GOLDEN_NODES, GOLDEN_PODS)
    c_nodes, c_pods, c_params = contention_fixture()
    if str(gold["fixture_sha256"]) != fixture_digest(nodes, pods, params):
        return ["the golden fixture differs from the one the golden was made from"]
    if str(gold["contention_sha256"]) != fixture_digest(c_nodes, c_pods, c_params):
        return ["the contention fixture differs from the one the golden was made from"]
    b = GOLDEN_PODS // BATCH
    rounds = torch.zeros(b, dtype=torch.int32, device=device)
    fallbacks = torch.zeros((b, 2), dtype=torch.int32, device=device)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, device)
    asg, final, _, _ = solver.solve_stream(
        pods_t, nodes_t, params_t, **SOLVE,
        shortlist_k=SHORTLIST_K, rounds_out=rounds, fallbacks_out=fallbacks,
    )
    nodes_t, pods_t, params_t = port_inputs(torch, c_nodes, c_pods, c_params, device)
    res = to_numpy(solver.assign(pods_t, nodes_t, params_t, shortlist_k=CONTENTION_K))
    got = dict(
        assignments=asg, rounds=rounds, fallbacks=fallbacks,
        requested=final.requested, estimated_used=final.estimated_used,
        prod_used=final.prod_used,
        contention_assignment=res["assignment"], contention_rounds=res["rounds_used"],
        contention_fallbacks=res["shortlist_fallbacks"],
        contention_requested=res["node_requested"],
        contention_estimated_used=res["node_estimated_used"],
        contention_prod_used=res["node_prod_used"],
    )
    return [
        name for name, value in got.items()
        if not bits_equal(value if isinstance(value, np.ndarray) else value.cpu().numpy(),
                          gold[name])
    ]


def two_cycles(torch, device, n_nodes: int, batches: int, seed: int = 3) -> dict:
    """Two scheduling cycles on resident node tables: a shortlist stream,
    then 1% of the node rows refreshed in place (``scatter_rows``: the
    first cycle's commits and halved usage on those rows, their metric
    freshness flipped), then a second stream. Returns the second stream's
    result, whether every table kept its ``data_ptr``, whether the second
    stream replayed the first one's CUDA graph, and what differs between
    it and the same solve on freshly built tables of the same contents
    (``mismatches``)."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import to_numpy

    nodes, pods, params = rich_fixture(seed, n_nodes, batches * BATCH)
    kw = dict(SOLVE, shortlist_k=SHORTLIST_K)
    resident, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, device)
    _, first, _, _ = solver.solve_stream(pods_t, resident, params_t, **kw)
    graph = solver._StreamGraph._last
    ptrs = [t.data_ptr() for t in to_tensors(resident)]
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.choice(n_nodes, n_nodes // 100, replace=False)).to(device)
    rows = solver.gather_rows(resident, idx, torch.ones(idx.shape, dtype=torch.bool, device=device))
    rows = dataclasses.replace(
        rows,
        requested=first.requested[idx],
        estimated_used=first.estimated_used[idx] * 0.5,
        metric_fresh=~rows.metric_fresh,
    )
    captured = sum(kernels.captured.values())
    solver.scatter_rows(resident, idx, rows)
    second = solver.solve_stream(pods_t, resident, params_t, **kw)
    replayed = (solver._StreamGraph._last is graph
                and sum(kernels.captured.values()) == captured)
    nodes_t, pods_t, params_t = port_inputs(torch, to_numpy(resident), stacked(pods), params,
                                            device)
    again = solver.solve_stream(pods_t, nodes_t, params_t, **kw)
    mismatches = [] if bits_equal(second[0].cpu(), again[0].cpu()) else ["assignments"]
    for f in ("requested", "estimated_used", "prod_used"):
        if not bits_equal(getattr(second[1], f).cpu(), getattr(again[1], f).cpu()):
            mismatches.append(f)
    return dict(
        second=second, replayed=replayed, mismatches=mismatches,
        same_ptrs=ptrs == [t.data_ptr() for t in to_tensors(resident)],
        refreshed=int(idx.numel()),
    )


def to_tensors(obj) -> list:
    """The tensor fields of a port dataclass, in field order."""
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None]


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
    nom_ops = pair_ops(d, p * n, bind_pods * n, (active_pods + prod_pods) * fresh_nodes,
                       feas_pairs)
    nom_bytes = n * (6 * d * 4 + 2 + 4) + p * (2 * d * 4 + 3) + d * 4 + p * 4 * 8
    rt_bytes = round_tail_bytes(torch, rt_args, n)
    rt_ops = round_tail_ops(rt_args)
    n_rolled = int(rolled.sum())
    refunded_nodes = int(torch.unique(ids_l).numel())
    gang_bytes = p * (4 * 4 + 2 * d * 4 + 2) + refunded_nodes * 3 * d * 4 * 2
    gang_ops = p * 4 + n_rolled * 3 * d + refunded_nodes * 3 * d

    # kernels a wrapper call launches: nomination adds a merge kernel when
    # the node axis is cut into chunks
    nom_chunk = nominate_ops.chunk_of(kernels.library("nominate"), p, n, d, 4, dev.index or 0)
    per_call = {"nominate": 1 if nom_chunk >= n else 2, "round_tail": 1, "enforce_gangs": 1}

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
        b_ms, b_by = bound_of(nbytes, nops)
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


def run_stream(torch, args, sync_mode="error", **kw):
    """One pass of ``solve_stream`` on ``args`` (pods, nodes, params) with
    the headline's arguments and ``kw``, under ``sync_mode``; returns
    (outputs, pods placed, wall seconds up to the caller's read of the
    placed counts)."""
    from koordinator_tpu_torch.ops import solver

    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode(sync_mode)
    try:
        out = solver.solve_stream(*args, **SOLVE, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    placed_total = int(out[2].sum())  # the caller's read: waits for the card
    return out, placed_total, time.perf_counter() - t0


def first_stream_pass(torch, args, **kw):
    """The first pass of a stream, which captures its graph: (seconds, the
    host syncs it made, each reported as a warning)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _, _, seconds = run_stream(torch, args, "warn", **kw)
    return seconds, sum(is_sync_warning(w) for w in caught)


def phase_stream(torch, dev, report, trip_inputs):
    """Phase 4: the headline stream through the kernels, one CUDA graph
    replay a batch, then once eagerly through the plain versions. Returns
    the stream's inputs, its outputs and its rounds a batch."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = headline_inputs(build_fixture(0))
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)
    args = (pods_t, nodes_t, params_t)
    n_batches = N_PODS // BATCH
    rounds = torch.zeros(n_batches, dtype=torch.int32, device=dev)

    def run(sync_mode="error", **kw):
        return run_stream(torch, args, sync_mode, **kw)

    first_seconds, first_syncs = first_stream_pass(torch, args)
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
    setup_bytes = n_batches * setup_bytes_per_batch(pods_t)
    report["stream"] = dict(
        pods=N_PODS, nodes=N_NODES, batches=n_batches, placed=placed,
        setup_bytes_per_pass=setup_bytes, setup_bound_ms=bound_of(setup_bytes, 0)[0],
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
        if row["name"] in launches:
            row["launches"] = launches[row["name"]]
    return args, out, rounds_np


def phase_golden(torch, dev):
    """Phase 5: the port on the card against the JAX package's recorded
    results: the solve_stream golden and the shortlist golden."""
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
    mismatches = shortlist_golden_mismatches(torch, dev)
    if mismatches:
        fail(f"shortlist golden: differs from the JAX package's in {mismatches}")
    print(
        f"golden: {int(placed.sum())} placed, assignments and tables equal "
        f"to the JAX package's bit for bit; the shortlist golden (K={SHORTLIST_K}, and "
        f"the contention fixture at K={CONTENTION_K}) too",
        flush=True,
    )


def phase_shortlist_kernels(torch, dev, report):
    """Phase 3, the shortlist: the build and round kernels against their
    plain versions at K=64 on the kernel check's fixture, at round 0 and
    after 15 batches, with the build's bounds and with a bound below every
    cost (every active pod unsafe); the contention fixture's rounds in
    lockstep with the plain versions on CPU copies, nomination, tables,
    loop state, words and counts equal after every trip, the fallback
    firing; then the two kernels' times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import shortlist as sl
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = rich_fixture(1, N_NODES, 16 * BATCH)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, pods, params, dev)
    pods_s = solver.tree_map(lambda a: a.reshape((-1, BATCH) + a.shape[1:]), pods_t)
    _, later, _, _ = solver.solve_stream(
        solver.tree_map(lambda a: a[:15], pods_s), nodes_t, params_t, **SOLVE
    )
    checks = {"shortlist_build": 0.0, "shortlist_round": 0.0}
    flags = []
    timing = None
    for label, state, b in (("start", nodes_t, 0), ("after 15 batches", later, 15)):
        spods, nom_args = round_inputs(solver.tree_map(lambda a: a[b], pods_s), state, params_t)
        build_args = nom_args[:4] + nom_args[5:]
        kc, kb = sl.shortlist_build(*build_args, SHORTLIST_K, 4.0)
        pc, pb = sl.shortlist_build_plain(*build_args, SHORTLIST_K, 4.0)
        torch.cuda.synchronize()
        if not (bits_equal(kc.cpu(), pc.cpu()) and bits_equal(kb.cpu(), pb.cpu())):
            fail(f"shortlist_build ({label}): differs from shortlist_build_plain")
        fin = torch.isfinite(pb).cpu().numpy()
        checks["shortlist_build"] = max(checks["shortlist_build"],
                                        max_abs(kb.cpu()[fin], pb.cpu()[fin]))
        for which, bnd in (("build bound", kb), ("below every cost", torch.full_like(kb, -1e3))):
            outs = []
            for fn in (sl.shortlist_round, sl.shortlist_round_plain):
                word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
                counts = torch.zeros(2, dtype=torch.int32, device=dev)
                st = torch.zeros(2, dtype=torch.int32, device=dev)
                top = fn(*nom_args, kc, bnd, 4, 4.0, True, word, counts, st)
                outs.append([t.cpu().numpy() for t in (*top, word[:3], counts)])
            for name, got, want in zip(("cost", "node", "word", "counts"), *outs):
                if not bits_equal(got, want):
                    fail(f"shortlist_round ({label}, {which}): {name} differs from the plain version")
            fin = np.isfinite(outs[1][0])
            checks["shortlist_round"] = max(checks["shortlist_round"],
                                            max_abs(outs[0][0][fin], outs[1][0][fin]))
            flags.append(dict(at=label, bound=which, word=outs[0][2].tolist(),
                              counts=outs[0][3].tolist()))
        if timing is None:
            timing = (nom_args, build_args, kc, kb, spods)
    if flags[1]["word"][0] != 1:
        fail("shortlist_round: a bound below every cost must make the round fall back")

    # the contention fixture, trip by trip, kernels against plain versions
    c_nodes, c_pods, c_params = contention_fixture()
    trips = 24  # assign's default max_rounds
    sides = []
    for device in (dev, torch.device("cpu")):
        n_t, p_t, par_t = port_inputs(torch, c_nodes, c_pods, c_params, device)
        _, spods_c, bind, thr, pthr = solver._round_setup(p_t, n_t, par_t)
        tables = [n_t.requested.clone(), n_t.estimated_used.clone(), n_t.prod_used.clone()]
        pod_args = (spods_c.requests, spods_c.estimate, spods_c.is_prod, bind)
        node_args = (n_t.allocatable, *tables, n_t.metric_fresh, n_t.schedulable,
                     n_t.cpu_amp, thr, pthr, par_t.score_weights)
        active = spods_c.valid.clone()
        state = torch.zeros(2, dtype=torch.int32, device=device)
        state[0] = int(not bool(active.any()))
        sides.append(dict(
            pod_args=pod_args, node_args=node_args, tables=tables, active=active, state=state,
            assigned=torch.full(active.shape, -1, dtype=torch.int32, device=device),
            plan=sl.shortlist_build(*pod_args, *node_args, CONTENTION_K, 4.0),
            words=torch.zeros((trips, sl.WORD), dtype=torch.int32, device=device),
            counts=torch.zeros(2, dtype=torch.int32, device=device),
            round_tail=(spods_c.requests, spods_c.estimate, spods_c.is_prod, bind,
                        n_t.cpu_amp, n_t.allocatable, n_t.metric_fresh, thr, pthr),
        ))
    for a, b in zip(*(side["plan"] for side in sides)):
        if not bits_equal(a.cpu(), b):
            fail("shortlist_build (contention): differs from the plain version")
    fell_back = 0
    for t in range(trips):
        # a trip after the fixed point leaves the nomination unwritten
        live = not bool(sides[1]["state"][0])
        seen = []
        for side in sides:
            top = sl.shortlist_round(
                *side["pod_args"], side["active"], *side["node_args"], *side["plan"], 4, 4.0,
                False, side["words"][t], side["counts"], side["state"],
            )
            nominate_ops.nominate(
                *side["pod_args"], side["active"], *side["node_args"], 4, 4.0, False,
                state=side["state"], trigger=side["words"][t], out=top,
            )
            nomination = [x.cpu().clone() for x in top] if live else []
            commit_ops.round_tail(*top, *side["round_tail"], *side["tables"], side["assigned"],
                                  side["active"], side["state"], 0.35)
            seen.append(nomination + [
                *side["tables"], side["assigned"], side["active"], side["state"],
                side["words"][t][:3], side["counts"],
            ])
        fell_back += int(sides[1]["words"][t][0])
        for i, (x, y) in enumerate(zip(*seen)):
            if not bits_equal(x.cpu(), y):
                fail(f"contention trip {t}: kernels and plain versions differ (item {i})")
    counts = sides[0]["counts"].cpu().tolist()
    if min(counts) <= 0:
        fail(f"contention: the shortlist must fall back on both counts, got {counts}")
    print(f"shortlist checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"flags {json.dumps(flags)}; contention: {fell_back} of "
          f"{int(sides[0]['state'][1])} rounds fell back, counts {counts}", flush=True)

    nom_args, build_args, kc, kb, spods = timing
    p, d = spods.requests.shape
    n = nom_args[5].shape[0]
    word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    st = torch.zeros(2, dtype=torch.int32, device=dev)

    def t_build():
        sl.shortlist_build(*build_args, SHORTLIST_K, 4.0)

    def t_build_plain():
        sl.shortlist_build_plain(*build_args, SHORTLIST_K, 4.0)

    def t_round():
        sl.shortlist_round(*nom_args, kc, kb, 4, 4.0, True, word, counts, st)

    def t_round_plain():
        sl.shortlist_round_plain(*nom_args, kc, kb, 4, 4.0, True, word, counts, st)

    # operations and bytes from these inputs (see PERF.md)
    gate, bind, prod = nom_args[4], nom_args[3], spods.is_prod
    fresh = nom_args[9]
    open_gates = torch.ones_like(gate)
    feas = nominate_ops.feasible_mask(*nom_args[:4], open_gates, *nom_args[5:14])
    build_ops = pair_ops(d, p * n, int(bind.sum()) * n,
                         (p + int(prod.sum())) * int(fresh.sum()), int(feas.sum()))
    node_row = 6 * d * 4 + 2 + 4
    build_bytes = n * node_row + p * (2 * d * 4 + 2) + d * 4 + p * (SHORTLIST_K + 1) * 4
    cand = kc.long()
    fresh_c = fresh[cand].sum(dim=1)
    round_feas = nominate_ops.feasible_mask(*nom_args[:14]).gather(1, cand)
    round_ops = pair_ops(d, p * SHORTLIST_K, int(bind.sum()) * SHORTLIST_K,
                         int(((gate.int() + prod.int()) * fresh_c).sum()), int(round_feas.sum()))
    touched = int(torch.unique(cand).numel())
    round_bytes = (p * (SHORTLIST_K + 1) * 4 + p * (2 * d * 4 + 3) + touched * node_row + d * 4
                   + p * 4 * 8 + (sl.WORD + 2 + 2) * 4)
    for name, source, replaces, fn, plain, kname, nbytes, nops, iters in (
        ("shortlist_build", "koordinator_tpu_torch/csrc/shortlist_build.cu",
         "koordinator_tpu/ops/solver.py:949", t_build, t_build_plain,
         "shortlist_build_kernel", build_bytes, build_ops, 100),
        ("shortlist_round", "koordinator_tpu_torch/csrc/shortlist_round.cu",
         "koordinator_tpu/ops/solver.py:1017", t_round, t_round_plain,
         "shortlist_round_kernel", round_bytes, round_ops, 200),
    ):
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            kernels_per_launch=1, max_abs_err=checks[name],
            ms=cuda_ms(torch, fn, iters), plain_ms=cuda_ms(torch, plain, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(torch, fn, min(50, iters // 4), kname),
            library_device_ms=None, bytes=nbytes, operations=nops,
        ))
    report["shortlist_flags"] = flags
    kernels.reset_launches()


def phase_shortlist_stream(torch, dev, report, headline):
    """Phase 4, the shortlist: the headline stream again with
    ``shortlist_k=SHORTLIST_K``, through the graph, 3 timed passes with no
    host sync; its assignments, final tables and rounds must be those of
    the stream without the shortlist (``headline``), and an eager pass
    through the plain versions must match."""
    from koordinator_tpu_torch import kernels

    args, out_full, rounds_full = headline
    n_batches = N_PODS // BATCH
    kw = dict(shortlist_k=SHORTLIST_K)
    rounds = torch.zeros(n_batches, dtype=torch.int32, device=dev)
    fallbacks = torch.zeros((n_batches, 2), dtype=torch.int32, device=dev)
    first_seconds, first_syncs = first_stream_pass(torch, args, **kw)
    kernels.reset_launches()
    out, placed, seconds = run_stream(torch, args, rounds_out=rounds, fallbacks_out=fallbacks, **kw)
    launches = dict(kernels.launches)
    replays = dict(kernels.replays)
    times = [seconds] + [run_stream(torch, args, **kw)[2] for _ in range(PASSES - 1)]
    for name in ("shortlist_build", "shortlist_round", "nominate", "round_tail", "enforce_gangs"):
        if launches.get(name, 0) <= 0:
            fail(f"the shortlist stream launched no {name} kernel")
    if launches["shortlist_build"] != n_batches or replays.get("solve_stream") != n_batches:
        fail(f"the shortlist stream built {launches['shortlist_build']} shortlists in "
             f"{replays} replays, not one a batch")
    rounds_np = rounds.cpu().numpy()
    if not bits_equal(out[0].cpu(), out_full[0].cpu()):
        fail("shortlist stream: assignments differ from the stream without the shortlist")
    for f in ("requested", "estimated_used", "prod_used"):
        if not bits_equal(getattr(out[1], f).cpu(), getattr(out_full[1], f).cpu()):
            fail(f"shortlist stream: final {f} differs from the stream without the shortlist")
    if not np.array_equal(rounds_np, rounds_full):
        fail("shortlist stream: rounds differ from the stream without the shortlist")
    plain_rounds = torch.zeros(n_batches, dtype=torch.int32, device=dev)
    plain_fallbacks = torch.zeros((n_batches, 2), dtype=torch.int32, device=dev)
    with plain_versions():
        p_out, _, p_seconds = run_stream(torch, args, 0, cuda_graph=False, rounds_out=plain_rounds,
                                         fallbacks_out=plain_fallbacks, **kw)
    if not (bits_equal(out[0].cpu(), p_out[0].cpu())
            and all(bits_equal(getattr(out[1], f).cpu(), getattr(p_out[1], f).cpu())
                    for f in ("requested", "estimated_used", "prod_used"))
            and np.array_equal(rounds_np, plain_rounds.cpu().numpy())
            and bits_equal(fallbacks.cpu(), plain_fallbacks.cpu())):
        fail("shortlist stream: the graph and the eager plain pass differ")
    med = sorted(times)[len(times) // 2]
    profile = stream_profile(torch, lambda: run_stream(torch, args, **kw), med)
    report["shortlist_stream"] = dict(
        shortlist_k=SHORTLIST_K, placed=placed, pods_per_s=N_PODS / med,
        pods_per_s_without=report["stream"]["pods_per_s"], pass_seconds=times,
        first_pass_seconds=first_seconds, plain_pass_seconds=p_seconds,
        rounds_used=int(rounds_np.sum()), fallbacks=fallbacks.sum(dim=0).cpu().tolist(),
        batches_with_fallback=int((fallbacks.sum(dim=1) > 0).sum()),
        builds=launches["shortlist_build"], graph_replays=replays.get("solve_stream", 0),
        launches=launches, host_syncs_per_pass=0, host_syncs_first_pass=first_syncs,
        **profile,
    )
    print(json.dumps({"shortlist_stream": report["shortlist_stream"]}), flush=True)
    for row in report["kernels"]:
        if row["name"].startswith("shortlist_"):
            row["launches"] = launches[row["name"]]



def quota_port_inputs(torch, tree: str, fixture, device, batch: int = BATCH):
    """A fixture's numpy dicts with ``tree``'s quotas and node mask as the
    port's tensors on ``device``: (stacked pods, nodes, params,
    QuotaState, the stacked [C, P, N] bool mask, built on the device)."""
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params, (runtime, used), (constrained, zone) = quota_fixture(tree, *fixture)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods, batch), params, device)
    quotas = solver.QuotaState(runtime=torch.from_numpy(runtime).to(device),
                               used=torch.from_numpy(used).to(device))
    n = nodes["allocatable"].shape[0]
    zone_t = torch.from_numpy(zone).to(device)
    in_zone = (torch.arange(n, device=device) % 4)[None, :] == zone_t[:, None]
    mask = ~torch.from_numpy(constrained).to(device)[:, None] | in_zone
    return pods_t, nodes_t, params_t, quotas, mask.reshape(-1, batch, n)


def quota_round_case(torch, pods_b, state, params_t, used, mask_b, runtime):
    """Round 0 of batch ``pods_b`` with quotas: the sorted pods, the
    nomination kernel's arguments with the gate in place of the active
    flags (``quota_gate``'s plain version), the node mask (``mask_b``
    [P, N], read through the priority order) and the round's quota
    arguments (chains, runtime, a copy of ``used``, the gate)."""
    from koordinator_tpu_torch.ops import quota as quota_ops
    from koordinator_tpu_torch.ops import solver

    order, spods, bind, thr, pthr = solver._round_setup(pods_b, state, params_t, quota=True)
    gate = torch.empty_like(spods.valid)
    quota_ops.quota_gate_plain(spods.valid, spods.requests, spods.quota_chain, runtime, used, gate)
    nom_args = (
        spods.requests, spods.estimate, spods.is_prod, bind, gate, state.allocatable,
        state.requested, state.estimated_used, state.prod_used, state.metric_fresh,
        state.schedulable, state.cpu_amp, thr, pthr, params_t.score_weights,
    )
    return spods, nom_args, (mask_b, order), (spods.quota_chain, runtime, used.clone(), gate)


def phase_quota_kernels(torch, dev, report):
    """Phase 7, quotas and node masks: the quota gate (``csrc/quota.cu``),
    the round tail's quota commit on both of ``_quota_commit``'s branches
    and its next gate (``csrc/round.cu``), and ``enforce_gangs``' quota
    refund (``csrc/gangs.cu``) against their plain versions on CPU copies
    at P=512 (round 0 of the first batch, and after ``QUOTA_LATER`` batches,
    where the quotas refuse pods the nodes accept) and P=4,096; the three pricing kernels with a node mask
    (some rows all false) against theirs; then their times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import quota as quota_ops
    from koordinator_tpu_torch.ops import shortlist as sl
    from koordinator_tpu_torch.ops import solver

    fixture = rich_fixture(1, N_NODES, 16 * BATCH)
    checks = {name: 0.0 for name in ("quota_gate", "quota_commit_onehot", "quota_commit_sorted",
                                     "quota_refund", "nominate_masked",
                                     "shortlist_build_masked", "shortlist_round_masked")}
    refused, refunds, timing = {}, [], {}

    def host(ts):
        return [None if t is None else t.cpu().clone() for t in ts]

    for tree in QUOTA_TREES:
        pods_s, nodes_t, params_t, quotas, mask = quota_port_inputs(torch, tree, fixture, dev)
        # a later state: 9 batches through the kernels, after which the
        # quotas refuse pods that the nodes accept (at P=512 and 4,096)
        _, later, _, later_q = solver.solve_stream(
            solver.tree_map(lambda a: a[:QUOTA_LATER], pods_s), nodes_t, params_t, quotas=quotas,
            **SOLVE
        )
        branch = f"quota_commit_{tree}"
        big = solver.tree_map(lambda a: a[:8].reshape((-1,) + a.shape[2:]), pods_s)
        cases = (
            ("start", solver.tree_map(lambda a: a[0], pods_s), nodes_t, quotas.used, mask[0]),
            (f"after {QUOTA_LATER} batches", solver.tree_map(lambda a: a[QUOTA_LATER], pods_s),
             later, later_q.used, mask[QUOTA_LATER]),
            # eight batches' gangs under one id each: minMember x 8, so
            # some gangs still fall short and roll back
            ("P=4096", dataclasses.replace(big, gang_min=big.gang_min * 8), later, later_q.used,
             mask[:8].reshape(8 * BATCH, -1)),
        )
        for label, pods_b, state, used, mask_b in cases:
            spods, nom_args, smask, quota = quota_round_case(
                torch, pods_b, state, params_t, used, mask_b.clone(), quotas.runtime)
            # the gate of round 0: kernel against plain
            gate = torch.empty_like(spods.valid)
            quota_ops.quota_gate(spods.valid, spods.requests, spods.quota_chain, quotas.runtime,
                                 used, gate)
            torch.cuda.synchronize()
            if not bits_equal(gate.cpu(), quota[3].cpu()):
                fail(f"quota_gate ({tree}, {label}): differs from quota_gate_plain")
            # the round tail with quotas, on the masked nomination of round 0
            top = nominate_ops.nominate(*nom_args, 4, 4.0, True, mask=smask)
            args = round_tail_args(torch, spods, nom_args, *top)
            args[15] = spods.valid.clone()
            work = [t.clone() for t in args]
            wq = [quota[0], quota[1], quota[2].clone(), quota[3].clone()]
            commit_ops.round_tail(*work, 0.35, quota=wq)
            plain = host(args)
            pq = host(quota)
            commit_ops.round_tail_plain(*plain, 0.35, quota=pq)
            nodes_only = host(args)
            commit_ops.round_tail_plain(*nodes_only, 0.35)
            torch.cuda.synchronize()
            names = ("requested", "estimated_used", "prod_used", "assigned", "active", "state")
            for name, tk, tp in zip(names + ("quota_used", "gate"),
                                    work[ROUND_MUTABLE] + wq[2:], plain[ROUND_MUTABLE] + pq[2:]):
                if not bits_equal(tk.cpu(), tp):
                    fail(f"round_tail with quotas ({tree}, {label}): {name} differs from "
                         "round_tail_plain")
                checks[branch] = max(checks[branch], max_abs(tk.cpu().numpy(), tp.numpy()))
            placed = int((plain[14] >= 0).sum())
            by_node = int((nodes_only[14] >= 0).sum())
            refused[f"{tree}, {label}"] = dict(node_accepted=by_node, placed=placed)
            if placed == 0:
                fail(f"round_tail with quotas ({tree}, {label}): the check needs a round that "
                     "places pods")
            # gang rollback with the quota refund, on the batch's solve result
            free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
            pre = solver.assign(free, state, params_t, quotas=solver.QuotaState(
                runtime=quotas.runtime, used=used), **SOLVE)
            got = solver.enforce_gangs(pre, pods_b)
            want = solver.enforce_gangs_plain(solver.tree_map(lambda a: a.cpu(), pre),
                                              solver.tree_map(lambda a: a.cpu(), pods_b))
            torch.cuda.synchronize()
            for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
                      "quota_used"):
                if not bits_equal(getattr(got, f).cpu(), getattr(want, f)):
                    fail(f"enforce_gangs with quotas ({tree}, {label}): {f} differs from "
                         "enforce_gangs_plain")
                checks["quota_refund"] = max(checks["quota_refund"], max_abs(
                    getattr(got, f).cpu().numpy(), getattr(want, f).numpy()))
            rolled = int(((pre.assignment >= 0) & (got.assignment < 0)).sum())
            changed = int((got.quota_used != pre.quota_used).any(dim=1).sum())
            if rolled == 0 or changed == 0:
                fail(f"enforce_gangs with quotas ({tree}, {label}): the check needs rollbacks "
                     f"that refund quotas; got {rolled} rollbacks, {changed} quotas refunded")
            refunds.append(dict(tree=tree, at=label, rolled_back=rolled, quotas_refunded=changed))
            if label == f"after {QUOTA_LATER} batches":
                timing[tree] = (spods, nom_args, smask, quota, args, pre, pods_b)
        if all(v["placed"] == v["node_accepted"] for k, v in refused.items() if k.startswith(tree)):
            fail(f"round_tail with quotas ({tree}): no check had a node-accepted pod refused "
                 "by its quotas")

    # the pricing kernels with a node mask, some rows all false
    spods, nom_args, (mask_b, order), _, _, _, _ = timing["onehot"]
    mask_b = mask_b.clone()
    mask_b[order[::37]] = False  # every 37th sorted pod may use no node
    smask = (mask_b, order)
    empty = torch.zeros(spods.valid.shape, dtype=torch.bool, device=dev)
    empty[::37] = True
    for approx in (False, True):
        kc, ki = nominate_ops.nominate(*nom_args, 4, 4.0, approx, mask=smask)
        pc, pi = nominate_ops.nominate_plain(*nom_args, 4, 4.0, approx, mask=smask)
        torch.cuda.synchronize()
        kc, ki, pc, pi = (t.cpu().numpy() for t in (kc, ki, pc, pi))
        fin = np.isfinite(kc)
        if not (np.array_equal(fin, np.isfinite(pc)) and bits_equal(kc[fin], pc[fin])
                and np.array_equal(ki[fin], pi[fin])):
            fail(f"nominate with a node mask (approx={approx}): differs from nominate_plain")
        if fin[empty.cpu().numpy()].any():
            fail("nominate with a node mask: a pod with an all-false row nominated a node")
        checks["nominate_masked"] = max(checks["nominate_masked"], max_abs(kc[fin], pc[fin]))
    build_args = nom_args[:4] + nom_args[5:]
    kc, kb = sl.shortlist_build(*build_args, SHORTLIST_K, 4.0, smask)
    pc, pb = sl.shortlist_build_plain(*build_args, SHORTLIST_K, 4.0, smask)
    torch.cuda.synchronize()
    if not (bits_equal(kc.cpu(), pc.cpu()) and bits_equal(kb.cpu(), pb.cpu())):
        fail("shortlist_build with a node mask: differs from shortlist_build_plain")
    if torch.isfinite(kb[empty]).any():
        fail("shortlist_build with a node mask: an all-false row has a finite bound")
    fin = torch.isfinite(pb).cpu().numpy()
    checks["shortlist_build_masked"] = max_abs(kb.cpu()[fin], pb.cpu()[fin])
    outs = []
    for fn in (sl.shortlist_round, sl.shortlist_round_plain):
        word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        st = torch.zeros(2, dtype=torch.int32, device=dev)
        top = fn(*nom_args, kc, kb, 4, 4.0, True, word, counts, st, smask)
        outs.append([t.cpu().numpy() for t in (*top, word[:3], counts)])
    for name, got, want in zip(("cost", "node", "word", "counts"), *outs):
        if not bits_equal(got, want):
            fail(f"shortlist_round with a node mask: {name} differs from the plain version")
    fin = np.isfinite(outs[1][0])
    checks["shortlist_round_masked"] = max_abs(outs[0][0][fin], outs[1][0][fin])
    print(f"quota checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"rounds {json.dumps(refused)}; rollbacks {json.dumps(refunds)}; masked shortlist "
          f"counts {outs[0][3].tolist()} with {int(empty.sum())} all-false rows", flush=True)

    # times, after QUOTA_LATER batches (the quotas bind), each timed as it is
    # set up
    def add_row(name, source, replaces, fn, plain, kname, nbytes, nops, iters):
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            kernels_per_launch=2 if name == "nominate_masked" else 1,
            max_abs_err=checks[name], ms=cuda_ms(torch, fn, iters),
            plain_ms=cuda_ms(torch, plain, 3), bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(torch, fn, min(50, iters // 4), kname),
            library_device_ms=None, bytes=nbytes, operations=nops,
        ))

    for tree in QUOTA_TREES:
        spods, nom_args_t, smask_t, quota, args, pre, pods_b = timing[tree]
        p, d = spods.requests.shape
        q_cap, levels = quota[1].shape[0], quota[0].shape[1]
        n = nom_args_t[5].shape[0]
        iters = 200
        copies = iter([([t.clone() for t in args[ROUND_MUTABLE]], quota[2].clone(),
                        quota[3].clone()) for _ in range(2 * iters + 2)])
        fixed = args[:ROUND_MUTABLE.start]

        def t_commit():
            mut, used_c, gate_c = next(copies)
            commit_ops.round_tail(*fixed, *mut, 0.35, quota=(quota[0], quota[1], used_c, gate_c))

        def t_commit_plain():
            commit_ops.round_tail_plain(
                *fixed, *[t.clone() for t in args[ROUND_MUTABLE]], 0.35,
                quota=(quota[0], quota[1], quota[2].clone(), quota[3].clone()))

        # bound: the round tail's bytes (as phase 3 counts them) plus the
        # quota phase's: chains read, each named quota row of the runtime
        # and used tables read once, the used rows and the gate written
        named = int(torch.unique(quota[0][quota[0] >= 0]).numel())
        q_bytes = p * levels * 4 + named * d * 4 * 3 + p
        commit_bytes = round_tail_bytes(torch, args, n, quota) + q_bytes
        # operations: per level a sum and a test a pod and dim, and the
        # charges; the sorted branch also sorts every level
        sort_len = 1 << max(p - 1, 0).bit_length()
        lg = sort_len.bit_length() - 1
        q_ops = levels * (p * d * 4 + (sort_len // 2) * lg * (lg + 1) // 2)
        add_row(f"quota_commit_{tree}", "koordinator_tpu_torch/csrc/round.cu",
                "koordinator_tpu/ops/solver.py:504", t_commit, t_commit_plain,
                "round_tail_kernel", commit_bytes, round_tail_ops(args) + q_ops, iters)
        if tree != "onehot":
            continue
        gate_out = torch.empty_like(spods.valid)

        def t_gate():
            quota_ops.quota_gate(spods.valid, spods.requests, quota[0], quota[1], quota[2],
                                 gate_out)

        def t_gate_plain():
            quota_ops.quota_gate_plain(spods.valid, spods.requests, quota[0], quota[1],
                                       quota[2], gate_out)

        gate_bytes = p * (1 + d * 4 + levels * 4 + 1) + named * d * 4 * 2
        gate_ops = int((quota[0] >= 0).sum()) * d * 3
        add_row("quota_gate", "koordinator_tpu_torch/csrc/quota.cu",
                "koordinator_tpu/ops/solver.py:489", t_gate, t_gate_plain,
                "quota_gate_kernel", gate_bytes, gate_ops, 200)
        gang_copies = iter([solver.tree_map(lambda a: a.clone(), pre) for _ in range(402)])

        def t_refund():
            solver._enforce_gangs_(next(gang_copies), pods_b)

        def t_refund_plain():
            solver.enforce_gangs_plain(pre, pods_b)

        after = solver.enforce_gangs(pre, pods_b)
        rolled = (pre.assignment >= 0) & (after.assignment < 0)
        n_rolled = int(rolled.sum())
        touched = int(torch.unique(pre.assignment[rolled]).numel())
        refunded = int((after.quota_used != pre.quota_used).any(dim=1).sum())
        refund_bytes = (p * (4 * 4 + 2 * d * 4 + 2) + touched * 3 * d * 4 * 2
                        + n_rolled * levels * 4 + refunded * d * 4 * 2)
        refund_ops = p * 4 + (n_rolled + touched) * 3 * d + levels * (n_rolled + refunded) * d
        add_row("quota_refund", "koordinator_tpu_torch/csrc/gangs.cu",
                "koordinator_tpu/ops/solver.py:1963", t_refund, t_refund_plain,
                "enforce_gangs_kernel", refund_bytes, refund_ops, 200)
        # the pricing kernels with the node mask: phase 3's counts plus the
        # mask, a byte a pair (the round and the build) or a candidate
        gate = nom_args_t[4]
        feas = int(nominate_ops.feasible_mask(*nom_args_t[:14], mask=smask_t).sum())
        fresh_nodes = int(nom_args_t[9].sum())
        nom_ops = pair_ops(d, p * n, int(nom_args_t[3].sum()) * n,
                           (int(gate.sum()) + int(spods.is_prod.sum())) * fresh_nodes, feas)
        node_row = 6 * d * 4 + 2 + 4
        nom_bytes = n * node_row + p * (2 * d * 4 + 3) + d * 4 + p * 4 * 8 + p * n + p * 8
        b_args = nom_args_t[:4] + nom_args_t[5:]
        plan = sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, smask_t)
        open_feas = int(nominate_ops.feasible_mask(*nom_args_t[:4], torch.ones_like(gate),
                                                   *nom_args_t[5:14], mask=smask_t).sum())
        build_ops = pair_ops(d, p * n, int(nom_args_t[3].sum()) * n,
                             (p + int(spods.is_prod.sum())) * fresh_nodes, open_feas)
        build_bytes = n * node_row + p * (2 * d * 4 + 2) + d * 4 + p * (SHORTLIST_K + 1) * 4 + p * n
        cand = plan[0].long()
        r_feas = int(nominate_ops.feasible_mask(*nom_args_t[:14], mask=smask_t).gather(1, cand).sum())
        round_ops = pair_ops(d, p * SHORTLIST_K, int(nom_args_t[3].sum()) * SHORTLIST_K,
                             int(((gate.int() + spods.is_prod.int())
                                  * nom_args_t[9][cand].sum(dim=1)).sum()), r_feas)
        round_bytes = (p * (SHORTLIST_K + 1) * 4 + p * (2 * d * 4 + 3)
                       + int(torch.unique(cand).numel()) * node_row + d * 4 + p * 4 * 8
                       + (sl.WORD + 4) * 4 + p * SHORTLIST_K)
        word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
        counts = torch.zeros(2, dtype=torch.int32, device=dev)
        st = torch.zeros(2, dtype=torch.int32, device=dev)
        add_row("nominate_masked", "koordinator_tpu_torch/csrc/nominate.cu",
                "koordinator_tpu/ops/solver.py:1121",
                lambda: nominate_ops.nominate(*nom_args_t, 4, 4.0, True, mask=smask_t),
                lambda: nominate_ops.nominate_plain(*nom_args_t, 4, 4.0, True, mask=smask_t),
                "nominate", nom_bytes, nom_ops, 200)
        add_row("shortlist_build_masked", "koordinator_tpu_torch/csrc/shortlist_build.cu",
                "koordinator_tpu/ops/solver.py:949",
                lambda: sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, smask_t),
                lambda: sl.shortlist_build_plain(*b_args, SHORTLIST_K, 4.0, smask_t),
                "shortlist_build_kernel", build_bytes, build_ops, 100)
        add_row("shortlist_round_masked", "koordinator_tpu_torch/csrc/shortlist_round.cu",
                "koordinator_tpu/ops/solver.py:1017",
                lambda: sl.shortlist_round(*nom_args_t, *plan, 4, 4.0, True, word, counts, st,
                                           smask_t),
                lambda: sl.shortlist_round_plain(*nom_args_t, *plan, 4, 4.0, True, word, counts,
                                                 st, smask_t),
                "shortlist_round_kernel", round_bytes, round_ops, 200)
    report["quota_checks"] = dict(rounds=refused, rollbacks=refunds)
    kernels.reset_launches()


def phase_quota_streams(torch, dev, report):
    """Phase 8: the scheduler's stream, ``solve_stream_full`` with quotas
    and the node mask, at full size (98,304 pods, 10,000 nodes, 192 x 512,
    bench's arguments) for each tree, with ``shortlist_k=64`` and without:
    one CUDA graph replay a chunk, a first pass (the capture) then 3
    timed passes with no host sync; counts zeroed just before the first
    timed pass and read just after it, every kernel of the path launched;
    placed pods and summed rounds equal to the JAX package's
    (``QUOTA_EXPECTED``), the assignments' sha256, placed count, rounds
    and fallback counts equal to the quota golden's; then one eager pass
    through the plain versions, equal."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver

    gold = np.load(GOLDEN_QUOTA)
    fixture = headline_inputs(build_fixture(0))
    if str(gold["full_fixture_sha256"]) != fixture_digest(*fixture):
        fail("quota streams: the fixture differs from the one the golden was made from")
    n_batches = N_PODS // BATCH
    lines = {}
    for tree in QUOTA_TREES:
        pods_t, nodes_t, params_t, quotas, mask = quota_port_inputs(torch, tree, fixture, dev)
        for k in (SHORTLIST_K, None):
            kw = dict(SOLVE, quotas=quotas, node_mask=mask, shortlist_k=k)

            def run(sync_mode="error", **more):
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode(sync_mode)
                try:
                    out = solver.solve_stream_full(pods_t, nodes_t, params_t, **kw, **more)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                placed = int((out[0] >= 0).sum())  # the caller's read
                return out, placed, time.perf_counter() - t0

            import warnings

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                first_seconds = run("warn")[2]
            first_syncs = sum(is_sync_warning(w) for w in caught)
            kernels.reset_launches()
            out, placed, seconds = run()
            launches = dict(kernels.launches)
            replays = dict(kernels.replays)
            times = [seconds] + [run()[2] for _ in range(PASSES - 1)]
            need = ["quota_gate", f"quota_commit_{tree}", "round_tail", "enforce_gangs",
                    "quota_refund", "nominate"]
            if k:
                need += ["shortlist_build", "shortlist_round"]
            for name in need:
                if launches.get(name, 0) <= 0:
                    fail(f"quota stream ({tree}, K={k}): launched no {name} kernel")
            if replays.get("solve_stream") != n_batches or launches["quota_gate"] != n_batches:
                fail(f"quota stream ({tree}, K={k}): {replays} replays and "
                     f"{launches['quota_gate']} gates, not one a chunk")
            asg, _, rounds, fallbacks = (t.cpu().numpy() for t in out)
            key = f"full_{tree}_k{k or 0}"
            want_placed, want_rounds = QUOTA_EXPECTED[tree]
            got = dict(placed=placed, rounds=int(rounds.sum()),
                       fallbacks=fallbacks.sum(axis=0).tolist(), sha256=assignments_digest(asg))
            if (got["placed"], got["rounds"]) != (want_placed, want_rounds):
                fail(f"quota stream ({tree}, K={k}): placed {got['placed']} and rounds "
                     f"{got['rounds']}, the JAX package's {want_placed} and {want_rounds}")
            if (got["sha256"] != str(gold[f"{key}_sha256"])
                    or got["placed"] != int(gold[f"{key}_placed"])
                    or got["rounds"] != int(gold[f"{key}_rounds"])
                    or got["fallbacks"] != gold[f"{key}_fallbacks"].tolist()):
                fail(f"quota stream ({tree}, K={k}): {got} differs from the golden")
            with plain_versions():
                p_out, _, p_seconds = run(0, cuda_graph=False)
            if not all(bits_equal(a.cpu(), b) for a, b in zip(p_out, (asg, out[1].cpu(),
                                                                      rounds, fallbacks))):
                fail(f"quota stream ({tree}, K={k}): the graph and the eager plain pass differ")
            med = sorted(times)[len(times) // 2]
            profile = stream_profile(torch, run, med)
            lines[f"{tree}, K={k or 'off'}"] = dict(
                quotas=int(quotas.runtime.shape[0]), placed=placed, pods_per_s=N_PODS / med,
                pass_seconds=times, first_pass_seconds=first_seconds,
                plain_pass_seconds=p_seconds, rounds_used=got["rounds"],
                fallbacks=got["fallbacks"], graph_replays=replays.get("solve_stream", 0),
                launches=launches, kernels_a_pass=sum(launches.get(n, 0) for n in (
                    "nominate", "round_tail", "enforce_gangs", "quota_gate", "shortlist_build",
                    "shortlist_round")),
                host_syncs_per_pass=0, host_syncs_first_pass=first_syncs, sha256=got["sha256"],
                **profile,
            )
            print(json.dumps({"quota_stream": {f"{tree}, K={k or 'off'}": lines[
                f"{tree}, K={k or 'off'}"]}}), flush=True)
            for row in report["kernels"]:
                name = row["name"]
                if name in (f"quota_commit_{tree}", "quota_gate", "quota_refund"):
                    row["launches"] = row["launches"] or launches.get(name)
                elif name == "nominate_masked" and not k:
                    row["launches"] = row["launches"] or launches.get("nominate")
                elif name.endswith("_masked") and k and name[:-7] in launches:
                    row["launches"] = row["launches"] or launches[name[:-7]]
            kernels.reset_launches()
        del mask
    report["quota_streams"] = lines

def phase_two_cycles(torch, dev, report):
    """Phase 6: two scheduling cycles on resident node tables at 10,000
    nodes (``two_cycles``): the in-place refresh keeps every address, the
    second stream replays the first one's graph and equals a fresh solve.
    Then ``gather_rows`` and ``_apply_commit_deltas_`` on the card against
    the same functions on CPU copies, and the times of the row functions."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import from_numpy
    from koordinator_tpu_torch.scheduler import batch_solver

    out = two_cycles(torch, dev, N_NODES, 16)
    if out["mismatches"] or not out["replayed"] or not out["same_ptrs"]:
        fail(f"two cycles: differs from a fresh solve {out['mismatches']}, graph replayed "
             f"{out['replayed']}, addresses kept {out['same_ptrs']}")
    nodes, _, _ = rich_fixture(3, N_NODES, BATCH)
    resident = from_numpy(solver.NodeState, device=dev, **nodes)
    host = solver.tree_map(lambda a: a.cpu(), resident)
    rng = np.random.default_rng(9)
    window = torch.from_numpy(rng.choice(N_NODES, 500, replace=False)).to(dev)
    valid = torch.from_numpy(rng.random(500) > 0.1).to(dev)
    got = solver.gather_rows(resident, window, valid)
    want = solver.gather_rows(host, window.cpu(), valid.cpu())
    if not all(bits_equal(a.cpu(), b) for a, b in zip(to_tensors(got), to_tensors(want))):
        fail("gather_rows on the card differs from the CPU")
    tables = [resident.requested, resident.estimated_used, resident.prod_used]
    deltas = [t * 0.25 for t in tables]
    results = [t + dt for t, dt in zip(tables, deltas)]
    cur = [t.clone() for t in tables]
    ptrs = [t.data_ptr() for t in cur]
    batch_solver._apply_commit_deltas_(*cur, *tables, *results)
    host_cur = [t.cpu() for t in tables]
    batch_solver._apply_commit_deltas_(*host_cur, *[t.cpu() for t in tables],
                                       *[t.cpu() for t in results])
    if [t.data_ptr() for t in cur] != ptrs or not all(
            bits_equal(a.cpu(), b) for a, b in zip(cur, host_cur)):
        fail("_apply_commit_deltas_ on the card differs from the CPU or moved a table")
    refresh = window[: N_NODES // 100]
    rows = solver.gather_rows(resident, refresh, torch.ones_like(refresh, dtype=torch.bool))
    times = dict(
        scatter_rows_ms=cuda_ms(torch, lambda: solver.scatter_rows(resident, refresh, rows), 200),
        gather_rows_ms=cuda_ms(torch, lambda: solver.gather_rows(resident, window, valid), 200),
        apply_commit_deltas_ms=cuda_ms(
            torch, lambda: batch_solver._apply_commit_deltas_(*cur, *tables, *results), 200),
        scatter_rows_device_ms=device_ms(
            torch, lambda: solver.scatter_rows(resident, refresh, rows), 50, None),
        gather_rows_device_ms=device_ms(
            torch, lambda: solver.gather_rows(resident, window, valid), 50, None),
        apply_commit_deltas_device_ms=device_ms(
            torch, lambda: batch_solver._apply_commit_deltas_(*cur, *tables, *results), 50, None),
    )
    # bounds: each refreshed row read from ``rows`` and written into the
    # tables once; each gathered row read and written once, with its flag
    row_bytes = sum(t.element_size() * t[0].numel() for t in to_tensors(resident))
    scatter_bytes = 2 * row_bytes * int(refresh.numel()) + 8 * int(refresh.numel())
    gather_bytes = 2 * row_bytes * int(window.numel()) + 9 * int(window.numel())
    # the commit deltas: nine [N, D] tables read, three written, two
    # operations an element
    delta_bytes = 12 * sum(t.element_size() * t.numel() for t in tables) // 3
    delta_ops = 2 * sum(t.numel() for t in tables)
    report["two_cycles"] = dict(nodes=N_NODES, batches=16, refreshed_rows=out["refreshed"],
                                window_rows=500, graph_replayed=True, addresses_kept=True,
                                scatter_rows_bytes=scatter_bytes,
                                scatter_rows_bound_ms=bound_of(scatter_bytes, 0)[0],
                                gather_rows_bytes=gather_bytes,
                                gather_rows_bound_ms=bound_of(gather_bytes, 0)[0],
                                apply_commit_deltas_bytes=delta_bytes,
                                apply_commit_deltas_bound_ms=bound_of(delta_bytes, delta_ops)[0],
                                **times)
    print(json.dumps({"two_cycles": report["two_cycles"]}), flush=True)



# ------------------------------------------------------- NUMA and large P


def numa_port_inputs(torch, device, n_pods: int = 16 * BATCH):
    """The NUMA kernel checks' inputs: ``rich_fixture(1, N_NODES,
    n_pods)`` with ``zone_tables(NUMA_SEED)``' zones, as the port's tensors
    on ``device``: (nodes, flat pods, params, NumaState)."""
    from koordinator_tpu_torch.ops.numa import NumaState

    nodes, pods, params = rich_fixture(1, N_NODES, n_pods)
    nodes, numa, required = zone_tables(NUMA_SEED, nodes, n_pods)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, dict(pods, numa_required=required),
                                            params, device)
    return nodes_t, pods_t, params_t, NumaState.create(**numa, device=device)


def numa_round_case(torch, pods_b, state, zone_free, numa_t, params_t, scoring: int):
    """Round 0 of batch ``pods_b`` with NUMA zones at node state ``state``
    and zone table ``zone_free``: the sorted pods, the nomination kernel's
    arguments, the pricing's ZoneTerms (a snapshot of the table) and the
    round tail's zone tuple (a copy of the table, no picks yet)."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.numa import ZoneTerms

    _, spods, bind, thr, pthr = solver._round_setup(pods_b, state, params_t, numa=True)
    nom_args = (
        spods.requests, spods.estimate, spods.is_prod, bind, spods.valid, state.allocatable,
        state.requested, state.estimated_used, state.prod_used, state.metric_fresh,
        state.schedulable, state.cpu_amp, thr, pthr, params_t.score_weights,
    )
    terms = ZoneTerms.batch_start(zone_free, numa_t.zone_cap, numa_t.policy,
                                  spods.numa_required, scoring)
    p = spods.requests.shape[0]
    zone = (zone_free.clone(), numa_t.zone_cap, numa_t.policy, numa_t.zone_most,
            spods.numa_required, torch.full((p,), -1, dtype=torch.int32, device=zone_free.device))
    return spods, nom_args, terms, zone


def zone_pair_ops(terms, pairs: int) -> int:
    """fp32 operations of the NUMA terms of ``pairs`` (pod, node) pairs
    given each node's side row (see PERF.md): the amplified request (4 a
    dim), each zone's fit (an add and a compare a zone and dim), the
    total's test (2 a dim); with the aligned score each zone's fit (2 a
    zone and dim) and key compare (1 a zone), the picked zone's score (10
    a dim) and the weighted floor (3)."""
    z, dn = terms.cap.shape[1:]
    ops = pairs * (dn * 4 + z * dn * 2 + dn * 2)
    if terms.scoring:
        ops += pairs * (z * dn * 2 + z + dn * 10 + 3)
    return ops


def zone_node_ops(terms, nodes: int) -> int:
    """fp32 operations of the side table of ``nodes`` nodes
    (``csrc/zone_prep.cu``): the zone sums behind dim_on and total_free
    (2 (Z-1) adds and a compare a dim), has_zones (Z (DN-1) adds and Z
    compares), each zone's capacity test (DN a zone) and key (4 a
    zone)."""
    z, dn = terms.cap.shape[1:]
    return nodes * (2 * (z - 1) * dn + dn + z * (dn - 1) + z + z * dn + z * 4)


def check_equal(what: str, pairs) -> float:
    """Fails unless every (kernel, plain) pair of tensors is bitwise equal;
    returns the largest absolute difference (0.0)."""
    worst = 0.0
    for name, got, want in pairs:
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if not bits_equal(g, w):
            fail(f"{what}: {name} differs from the plain version")
        worst = max(worst, max_abs(g, w))
    return worst


def phase_numa_kernels(torch, dev, report):
    """Phase 9, NUMA zones: the three pricing kernels with the NUMA terms
    (both scorings and none), the round tail's zone phase and
    ``enforce_gangs``' zone refund, each against its plain version on the
    same inputs (the round tail and rollback on CPU copies), at P=512 and
    4,096 over 10,000 nodes, at the start and after 3 batches; then their
    times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import numa as numa_ops
    from koordinator_tpu_torch.ops import shortlist as sl
    from koordinator_tpu_torch.ops import solver

    nodes_t, pods_t, params_t, numa_t = numa_port_inputs(torch, dev)
    checks = {k: 0.0 for k in ("nominate_numa", "shortlist_build_numa", "shortlist_round_numa",
                               "round_tail_zone", "zone_refund", "zone_prep")}
    seen, timing = [], {}
    pods_s = solver.tree_map(lambda a: a.reshape((-1, BATCH) + a.shape[1:]), pods_t)
    # a later state: three batches committed, the zone table carried
    later, zf_later = nodes_t, numa_t.zone_free
    for b in range(3):
        res = solver.assign(solver.tree_map(lambda a: a[b], pods_s), later, params_t,
                            numa=numa_t, numa_carry=zf_later, **SOLVE)
        later = dataclasses.replace(later, requested=res.node_requested,
                                    estimated_used=res.node_estimated_used,
                                    prod_used=res.node_prod_used)
        zf_later = res.node_zone_free
    cases = [("start, P=512", solver.tree_map(lambda a: a[3], pods_s), nodes_t,
              numa_t.zone_free),
             ("after 3 batches, P=512", solver.tree_map(lambda a: a[4], pods_s), later, zf_later),
             ("after 3 batches, P=4096",
              solver.tree_map(lambda a: a[8:16].reshape((-1,) + a.shape[2:]), pods_s), later,
              zf_later)]
    for label, pods_b, state, zone_free in cases:
        for scoring in (0, 1, 2):
            spods, nom_args, terms, zone = numa_round_case(torch, pods_b, state, zone_free,
                                                           numa_t, params_t, scoring)
            want = numa_ops.zone_prep_plain(zone_free, numa_t.zone_cap, numa_t.policy)
            checks["zone_prep"] = max(checks["zone_prep"], check_equal(
                f"zone_prep ({label})", [("snapshot", terms.free, want[0]),
                                         ("side", terms.side, want[1])]))
            for approx in (False, True):
                kc, ki = nominate_ops.nominate(*nom_args, 4, 4.0, approx, zones=terms)
                pc, pi = nominate_ops.nominate_plain(*nom_args, 4, 4.0, approx, zones=terms)
                torch.cuda.synchronize()
                kc, ki, pc, pi = (t.cpu().numpy() for t in (kc, ki, pc, pi))
                fin = np.isfinite(kc)
                if not (np.array_equal(fin, np.isfinite(pc)) and bits_equal(kc[fin], pc[fin])
                        and np.array_equal(ki[fin], pi[fin])):
                    fail(f"nominate with zones ({label}, scoring {scoring}, approx={approx}): "
                         "differs from nominate_plain")
                checks["nominate_numa"] = max(checks["nominate_numa"], max_abs(kc[fin], pc[fin]))
            b_args = nom_args[:4] + nom_args[5:]
            plan = sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, zones=terms)
            want = sl.shortlist_build_plain(*b_args, SHORTLIST_K, 4.0, zones=terms)
            fin = torch.isfinite(want[1])
            checks["shortlist_build_numa"] = max(checks["shortlist_build_numa"], check_equal(
                f"shortlist_build with zones ({label}, scoring {scoring})",
                [("cand", plan[0], want[0]), ("bound", plan[1][fin], want[1][fin]),
                 ("finite", torch.isfinite(plan[1]), fin)]))
            outs = []
            for fn in (sl.shortlist_round, sl.shortlist_round_plain):
                word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
                counts = torch.zeros(2, dtype=torch.int32, device=dev)
                st = torch.zeros(2, dtype=torch.int32, device=dev)
                top = fn(*nom_args, *plan, 4, 4.0, True, word, counts, st, zones=terms)
                outs.append((*top, word[:3], counts))
            fin = torch.isfinite(outs[1][0])
            checks["shortlist_round_numa"] = max(checks["shortlist_round_numa"], check_equal(
                f"shortlist_round with zones ({label}, scoring {scoring})",
                [("cost", outs[0][0][fin], outs[1][0][fin]), ("node", outs[0][1][fin],
                                                              outs[1][1][fin]),
                 ("word", outs[0][2], outs[1][2]), ("counts", outs[0][3], outs[1][3])]))
            # the round tail with the zone phase, on the kernel's nomination
            top = nominate_ops.nominate(*nom_args, 4, 4.0, True, zones=terms)
            args = round_tail_args(torch, spods, nom_args, *top)
            work = [t.clone() for t in args]
            wz = (zone[0].clone(),) + zone[1:5] + (zone[5].clone(),)
            commit_ops.round_tail(*work, 0.35, zone=wz)
            host = [t.cpu().clone() for t in args]
            hz = tuple(t.cpu().clone() for t in zone)
            commit_ops.round_tail_plain(*host, 0.35, zone=hz)
            plain_nz = [t.cpu().clone() for t in args]
            commit_ops.round_tail_plain(*plain_nz, 0.35)
            names = ("requested", "estimated_used", "prod_used", "assigned", "active", "state")
            checks["round_tail_zone"] = max(checks["round_tail_zone"], check_equal(
                f"round_tail with zones ({label}, scoring {scoring})",
                [(nm, a, b) for nm, a, b in zip(names, work[ROUND_MUTABLE], host[ROUND_MUTABLE])]
                + [("zone_free", wz[0], hz[0]), ("pod_zone", wz[5], hz[5])]))
            picked = int((hz[5] >= 0).sum())
            refused = int(((plain_nz[14] >= 0) & (host[14] < 0)).sum())
            if picked == 0:
                fail(f"round_tail with zones ({label}): the check needs zone picks")
            seen.append(dict(at=label, scoring=scoring, zone_picks=picked,
                             refused_by_zones=refused))
            if scoring == 1 and label.startswith("after") and "512" in label:
                timing["round"] = (spods, nom_args, terms, zone, args)
        # the rollback's zone refund on the batch's solve result; a third
        # of the pods that took a zone join gang 0, which falls short
        free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
        pre = solver.assign(free, state, params_t, numa=numa_t, numa_carry=zone_free, **SOLVE)
        p_b = pods_b.gang_id.shape[0]
        third = (pre.pod_zone >= 0) & (torch.arange(p_b, device=dev) % 3 == 0)
        gang_min = pods_b.gang_min.clone()
        gang_min[0] = p_b + 1
        nonstrict = pods_b.gang_nonstrict.clone()
        nonstrict[0] = False
        pods_b = dataclasses.replace(pods_b, gang_id=torch.where(third, 0, pods_b.gang_id),
                                     gang_min=gang_min, gang_nonstrict=nonstrict)
        got = solver.enforce_gangs(pre, pods_b)
        want = solver.enforce_gangs_plain(solver.tree_map(lambda a: a.cpu(), pre),
                                          solver.tree_map(lambda a: a.cpu(), pods_b))
        checks["zone_refund"] = max(checks["zone_refund"], check_equal(
            f"enforce_gangs with zones ({label})",
            [(f, getattr(got, f), getattr(want, f)) for f in (
                "assignment", "node_requested", "node_estimated_used", "node_prod_used",
                "node_zone_free", "pod_zone")]))
        rolled = (pre.assignment >= 0) & (got.assignment < 0)
        zoned = int((rolled & (pre.pod_zone >= 0)).sum())
        if zoned == 0:
            fail(f"enforce_gangs with zones ({label}): the check needs rolled-back pods "
                 "that hold a zone")
        seen.append(dict(at=label, rolled_back=int(rolled.sum()), zone_refunds=zoned))
        if label.startswith("after") and "512" in label:
            timing["gangs"] = (pre, pods_b)
    print(f"numa checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"{json.dumps(seen)}", flush=True)

    # times, after 3 batches at P=512, LeastAllocated aligned scores
    spods, nom_args, terms, zone, args = timing["round"]
    p, d = spods.requests.shape
    n = nom_args[5].shape[0]
    z, dn = terms.cap.shape[1:]
    zone_bytes = n * z * dn * 4 * 2 + n * (1 + dn + z) * 4 + p

    def add_row(name, source, replaces, fn, plain, kname, nbytes, nops, iters, per_call=1):
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            kernels_per_launch=per_call, max_abs_err=checks[name],
            ms=cuda_ms(torch, fn, iters), plain_ms=cuda_ms(torch, plain, 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(torch, fn, min(50, iters // 4), kname),
            library_device_ms=None, bytes=nbytes, operations=nops,
        ))

    feas = int(nominate_ops.feasible_mask(*nom_args[:14]).sum())
    fresh_nodes = int(nom_args[9].sum())
    bind_pods = int(nom_args[3].sum())
    node_row = 6 * d * 4 + 2 + 4
    nom_ops = pair_ops(d, p * n, bind_pods * n, (int(spods.valid.sum())
                                                + int(spods.is_prod.sum())) * fresh_nodes, feas)
    nom_bytes = n * node_row + p * (2 * d * 4 + 3) + d * 4 + p * 4 * 8 + zone_bytes
    chunk = nominate_ops.chunk_of(kernels.library("nominate"), p, n, d, 4, dev.index or 0, 2)
    add_row("nominate_numa", "koordinator_tpu_torch/csrc/nominate.cu",
            "koordinator_tpu/ops/numa.py:77", lambda: nominate_ops.nominate(
                *nom_args, 4, 4.0, True, zones=terms),
            lambda: nominate_ops.nominate_plain(*nom_args, 4, 4.0, True, zones=terms),
            "nominate", nom_bytes, nom_ops + zone_pair_ops(terms, p * n), 200,
            1 if chunk >= n else 2)
    b_args = nom_args[:4] + nom_args[5:]
    plan = sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, zones=terms)
    build_bytes = n * node_row + p * (2 * d * 4 + 2) + d * 4 + p * (SHORTLIST_K + 1) * 4 + zone_bytes
    add_row("shortlist_build_numa", "koordinator_tpu_torch/csrc/shortlist_build.cu",
            "koordinator_tpu/ops/costs.py:212",
            lambda: sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, zones=terms),
            lambda: sl.shortlist_build_plain(*b_args, SHORTLIST_K, 4.0, zones=terms),
            "shortlist_build_kernel", build_bytes, nom_ops + zone_pair_ops(terms, p * n), 100)
    word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    st = torch.zeros(2, dtype=torch.int32, device=dev)
    cand = plan[0].long()
    round_bytes = (p * (SHORTLIST_K + 1) * 4 + p * (2 * d * 4 + 3)
                   + int(torch.unique(cand).numel()) * (node_row + z * dn * 8 + 1)
                   + d * 4 + p * 4 * 8 + (sl.WORD + 4) * 4)
    add_row("shortlist_round_numa", "koordinator_tpu_torch/csrc/shortlist_round.cu",
            "koordinator_tpu/ops/solver.py:1001",
            lambda: sl.shortlist_round(*nom_args, *plan, 4, 4.0, True, word, counts, st,
                                       zones=terms),
            lambda: sl.shortlist_round_plain(*nom_args, *plan, 4, 4.0, True, word, counts, st,
                                             zones=terms),
            "shortlist_round_kernel", round_bytes,
            pair_ops(d, p * SHORTLIST_K, bind_pods * SHORTLIST_K, p * SHORTLIST_K, feas // 10)
            + zone_pair_ops(terms, p * SHORTLIST_K), 200)
    prep_in = (zone[0], numa_t.zone_cap, numa_t.policy)
    add_row("zone_prep", "koordinator_tpu_torch/csrc/zone_prep.cu",
            "koordinator_tpu/ops/numa.py:77",
            lambda: numa_ops.zone_prep(*prep_in), lambda: numa_ops.zone_prep_plain(*prep_in),
            "zone_prep_kernel", n * z * dn * 4 * 3 + n + n * (1 + dn + z) * 4,
            zone_node_ops(terms, n), 200)
    iters = 200
    copies = iter([([t.clone() for t in args[ROUND_MUTABLE]], zone[0].clone(), zone[5].clone())
                   for _ in range(2 * iters + 2)])
    fixed = args[:ROUND_MUTABLE.start]

    def t_round():
        mut, zf, pz = next(copies)
        commit_ops.round_tail(*fixed, *mut, 0.35, zone=(zf,) + zone[1:5] + (pz,))

    def t_round_plain():
        commit_ops.round_tail_plain(*fixed, *[t.clone() for t in args[ROUND_MUTABLE]], 0.35,
                                    zone=(zone[0].clone(),) + zone[1:5] + (zone[5].clone(),))

    _, node_key = commit_ops._choose(args[0], args[1], args[15], n)
    touched = int(torch.unique(node_key[node_key < n]).numel())
    zp_bytes = round_tail_bytes(torch, args, n) + touched * (z * dn * 4 * 3 + 2) + p * 5
    zp_ops = round_tail_ops(args) + p * (z * (dn * 3 + 4) + dn * 2)
    add_row("round_tail_zone", "koordinator_tpu_torch/csrc/round_zone.cu",
            "koordinator_tpu/ops/solver.py:1306", t_round, t_round_plain, "round_tail_kernel",
            zp_bytes, zp_ops, iters)
    pre, pods_b = timing["gangs"]
    gang_copies = iter([solver.tree_map(lambda a: a.clone(), pre) for _ in range(402)])
    after = solver.enforce_gangs(pre, pods_b)
    rolled = (pre.assignment >= 0) & (after.assignment < 0)
    n_rolled = int(rolled.sum())
    refunded = int(torch.unique(pre.assignment[rolled]).numel())
    zr_bytes = (p * (4 * 4 + 2 * d * 4 + 2 + 4) + refunded * (3 * d * 4 + z * dn * 4) * 2
                + n_rolled * dn * 4)
    zr_ops = p * 4 + n_rolled * (3 * d + dn) + refunded * 3 * d
    add_row("zone_refund", "koordinator_tpu_torch/csrc/gangs.cu",
            "koordinator_tpu/ops/solver.py:1941",
            lambda: solver._enforce_gangs_(next(gang_copies), pods_b),
            lambda: solver.enforce_gangs_plain(pre, pods_b), "enforce_gangs_kernel",
            zr_bytes, zr_ops, 200)
    report["numa_checks"] = seen
    kernels.reset_launches()


def big_port_inputs(torch, n_pods: int, quota: bool, device):
    """The big batch (``bigbatch_fixture``) as the port's tensors, with the
    sorted-branch quota tree when ``quota``: (pods, nodes, params,
    QuotaState or None)."""
    from koordinator_tpu_torch.ops import solver

    nodes, pods, params = bigbatch_fixture(n_pods)
    quotas = None
    if quota:
        pods, (runtime, used) = bigbatch_quotas(pods)
        quotas = solver.QuotaState(runtime=torch.from_numpy(runtime).to(device),
                                   used=torch.from_numpy(used).to(device))
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, pods, params, device)
    return pods_t, nodes_t, params_t, quotas


def phase_bigbatch(torch, dev, report):
    """Phase 10, rounds above 4,096 pods: at P=8,192, 16,384 and 32,768
    (D=4, 2,000 nodes, a Strict gang of 6,000 that rolls back), without
    quotas and with the sorted-branch tree, the round tail (round 0) and
    the gang rollback against their plain versions on CPU copies, the whole
    ``assign`` against the big-batch golden (P=8,192 and, where the golden
    holds it, 32,768) or against the plain versions on the card; then
    their times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.convert import to_numpy

    golds = {BIG_PODS: np.load(GOLDEN_BIGBATCH), 4 * BIG_PODS: np.load(GOLDEN_BIGBATCH_32K)}
    for n_pods, gold in golds.items():
        nodes, pods, params = bigbatch_fixture(n_pods)
        if str(gold["fixture_sha256"]) != fixture_digest(nodes, bigbatch_quotas(pods)[0],
                                                          params):
            fail(f"big batch: the P={n_pods} fixture differs from the one its golden was "
                 "made from")
    checks = {"round_tail_big": 0.0, "enforce_gangs_big": 0.0}
    lines, timing = [], {}
    for n_pods in (BIG_PODS, 2 * BIG_PODS, 4 * BIG_PODS):
        for quota in (False, True):
            label = f"P={n_pods}, {'quotas' if quota else 'no quotas'}"
            pods_t, nodes_t, params_t, quotas = big_port_inputs(torch, n_pods, quota, dev)
            kernels.reset_launches()
            res = solver.assign(pods_t, nodes_t, params_t, quotas=quotas, **SOLVE)
            launches = dict(kernels.launches)
            got = to_numpy(res)
            key = "quota" if quota else "plain"
            gold = golds.get(n_pods)
            if gold is not None:
                fields = [("assignment", "assignment"), ("rounds_used", "rounds"),
                          ("node_requested", "requested"),
                          ("node_estimated_used", "estimated_used"),
                          ("node_prod_used", "prod_used")]
                if quota:
                    fields.append(("quota_used", "quota_used"))
                for f, g in fields:
                    if not bits_equal(got[f], gold[f"{key}_{g}"]):
                        fail(f"big batch ({label}): {f} differs from the JAX package's")
            if n_pods != BIG_PODS:
                with plain_versions():
                    want = to_numpy(solver.assign(pods_t, nodes_t, params_t, quotas=quotas,
                                                  **SOLVE))
                for f in ("assignment", "rounds_used", "node_requested", "node_estimated_used",
                          "node_prod_used", "quota_used"):
                    if not bits_equal(got[f], want[f]):
                        fail(f"big batch ({label}): {f} differs from the plain versions'")
            if launches.get("round_tail_big", 0) == 0:
                fail(f"big batch ({label}): no round ran in the device-memory round tail")
            a = got["assignment"]
            if (a[:BIG_GANG] >= 0).any():
                fail(f"big batch ({label}): the Strict gang was not rolled back")
            # round 0 against the plain version on CPU copies
            _, spods, bind, thr, pthr = solver._round_setup(pods_t, nodes_t, params_t,
                                                            quota=quota)
            gate = spods.valid.clone()
            nom_args = (spods.requests, spods.estimate, spods.is_prod, bind, gate,
                        nodes_t.allocatable, nodes_t.requested, nodes_t.estimated_used,
                        nodes_t.prod_used, nodes_t.metric_fresh, nodes_t.schedulable,
                        nodes_t.cpu_amp, thr, pthr, params_t.score_weights)
            q = None
            if quota:
                from koordinator_tpu_torch.ops import quota as quota_ops

                quota_ops.quota_gate_plain(spods.valid, spods.requests, spods.quota_chain,
                                           quotas.runtime, quotas.used, gate)
                q = (spods.quota_chain, quotas.runtime, quotas.used.clone(), gate.clone())
            top = nominate_ops.nominate(*nom_args, 4, 4.0, True)
            args = round_tail_args(torch, spods, nom_args, *top)
            work = [t.clone() for t in args]
            wq = None if q is None else (q[0], q[1], q[2].clone(), q[3].clone())
            commit_ops.round_tail(*work, 0.35, quota=wq)
            host = [t.cpu().clone() for t in args]
            hq = None if q is None else tuple(t.cpu().clone() for t in q)
            commit_ops.round_tail_plain(*host, 0.35, quota=hq)
            names = ("requested", "estimated_used", "prod_used", "assigned", "active", "state")
            pairs = list(zip(names, work[ROUND_MUTABLE], host[ROUND_MUTABLE]))
            if q is not None:
                pairs += [("quota_used", wq[2], hq[2]), ("gate", wq[3], hq[3])]
            checks["round_tail_big"] = max(checks["round_tail_big"], check_equal(
                f"round_tail ({label})", pairs))
            free = dataclasses.replace(pods_t, gang_id=torch.full_like(pods_t.gang_id, -1))
            pre = solver.assign(free, nodes_t, params_t, quotas=quotas, **SOLVE)
            kernels.reset_launches()
            gk = solver.enforce_gangs(pre, pods_t)
            big_gangs = kernels.launches.get("enforce_gangs_big", 0)
            gp = solver.enforce_gangs_plain(solver.tree_map(lambda t: t.cpu(), pre),
                                            solver.tree_map(lambda t: t.cpu(), pods_t))
            checks["enforce_gangs_big"] = max(checks["enforce_gangs_big"], check_equal(
                f"enforce_gangs ({label})", [(f, getattr(gk, f), getattr(gp, f)) for f in (
                    "assignment", "node_requested", "node_estimated_used", "node_prod_used",
                    "quota_used")]))
            rolled = int(((pre.assignment >= 0) & (gk.assignment < 0)).sum())
            lines.append(dict(at=label, placed=int((a >= 0).sum()), rounds=int(got["rounds_used"]),
                              rolled_back=rolled, gangs_in_device_memory=bool(big_gangs),
                              launches=launches))
            timing[label] = (args, q, pre, pods_t)
    print(f"big batch: bitwise equal to the JAX package's goldens (P={BIG_PODS} and "
          f"{4 * BIG_PODS}) and to the "
          f"plain versions {json.dumps(checks)}; {json.dumps(lines)}", flush=True)
    for label in (f"P={BIG_PODS}, quotas", f"P={2 * BIG_PODS}, quotas",
                  f"P={4 * BIG_PODS}, quotas"):
        args, q, pre, pods_t = timing[label]
        p, d = args[2].shape
        n = args[7].shape[0]
        iters, dev_iters = 30, 10
        # the calls the timings make: cuda_ms' warm-up and iters, then
        # device_ms' two counting calls and up to three windows
        calls = iters + 1 + 2 + 3 * dev_iters
        copies = iter([([t.clone() for t in args[ROUND_MUTABLE]], q[2].clone(), q[3].clone())
                       for _ in range(calls)])
        fixed = args[:ROUND_MUTABLE.start]

        def t_round():
            mut, used, gate = next(copies)
            commit_ops.round_tail(*fixed, *mut, 0.35, quota=(q[0], q[1], used, gate))

        def t_round_plain():
            commit_ops.round_tail_plain(*fixed, *[t.clone() for t in args[ROUND_MUTABLE]], 0.35,
                                        quota=(q[0], q[1], q[2].clone(), q[3].clone()))

        levels = q[0].shape[1]
        nbytes = round_tail_bytes(torch, args, n, q) + p * levels * 4 * 2
        sort_len = 1 << max(p - 1, 0).bit_length()
        lg = sort_len.bit_length() - 1
        nops = round_tail_ops(args) + levels * (p * d * 4 + (sort_len // 2) * lg * (lg + 1) // 2)
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=f"round_tail_big_p{p}", route="cuda",
            source="koordinator_tpu_torch/csrc/round_big.cu",
            replaces="koordinator_tpu/ops/solver.py:1204", launches=None, kernels_per_launch=1,
            max_abs_err=checks["round_tail_big"], ms=cuda_ms(torch, t_round, iters),
            plain_ms=cuda_ms(torch, t_round_plain, 2), bound_ms=b_ms, bound_by=b_by,
            library_ms=None, device_ms=device_ms(torch, t_round, dev_iters, "round_tail_kernel"),
            library_device_ms=None, bytes=nbytes, operations=nops))
        gang_copies = iter([solver.tree_map(lambda a: a.clone(), pre) for _ in range(calls)])
        after = solver.enforce_gangs(pre, pods_t)
        rolled = (pre.assignment >= 0) & (after.assignment < 0)
        n_rolled = int(rolled.sum())
        touched = int(torch.unique(pre.assignment[rolled]).numel())
        g_bytes = (p * (4 * 4 + 2 * d * 4 + 2) + touched * 3 * d * 4 * 2
                   + n_rolled * levels * 4 + int(q[1].shape[0]) * d * 4 * 2)
        g_ops = p * 4 + (n_rolled + touched) * 3 * d + levels * n_rolled * d
        b_ms, b_by = bound_of(g_bytes, g_ops)
        report["kernels"].append(dict(
            name=f"enforce_gangs_p{p}", route="cuda",
            source="koordinator_tpu_torch/csrc/gangs.cu",
            replaces="koordinator_tpu/ops/solver.py:1858", launches=None, kernels_per_launch=1,
            max_abs_err=checks["enforce_gangs_big"],
            ms=cuda_ms(torch, lambda: solver._enforce_gangs_(next(gang_copies), pods_t), 30),
            plain_ms=cuda_ms(torch, lambda: solver.enforce_gangs_plain(pre, pods_t), 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(torch, lambda: solver._enforce_gangs_(next(gang_copies), pods_t),
                                dev_iters, "enforce_gangs_kernel"),
            library_device_ms=None, bytes=g_bytes, operations=g_ops))
        launches = next(ln["launches"] for ln in lines if ln["at"] == label)
        report["kernels"][-2]["launches"] = launches.get("round_tail_big")
        # the rollback of 8,192 pods runs in shared memory, of 16,384 in
        # device memory: either is the batch's one enforce_gangs launch
        report["kernels"][-1]["launches"] = launches.get("enforce_gangs")
    report["bigbatch"] = lines
    kernels.reset_launches()


def phase_numa_streams(torch, dev, report):
    """Phase 11: the scheduler's stream with NUMA zones at full size —
    ``solve_stream_full(numa=...)`` over the headline fixture (98,304 pods,
    10,000 nodes, 192 x 512, bench's arguments) with ``binpack_numa``'s
    zones (``bench_suite.py:bench_numa_20k``'s recipe) for each of
    ``NUMA_SCORINGS`` with ``shortlist_k=64`` and without: one CUDA graph
    replay a chunk, a first pass (the capture) then timed passes with no
    host sync (counts zeroed just before the first and read just after it,
    every kernel of the path launched); placed count, summed rounds,
    fallback counts and the sha256 of the assignments, zone picks and final
    zone table equal to the NUMA golden's; then one eager pass through the
    plain versions, equal."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.numa import NumaState

    gold = np.load(GOLDEN_NUMA)
    nodes, pods, params = headline_inputs(build_fixture(0))
    pods, numa = binpack_numa(nodes, pods)
    if str(gold["full_fixture_sha256"]) != fixture_digest(nodes, pods, numa, params):
        fail("numa streams: the fixture differs from the one the golden was made from")
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)
    numa_t = NumaState.create(**numa, device=dev)
    n_batches = N_PODS // BATCH
    lines = {}
    for scoring in NUMA_SCORINGS:
        for k in (SHORTLIST_K, None):
            kw = dict(SOLVE, numa=numa_t, numa_scoring=scoring, shortlist_k=k)
            zone_free = torch.empty_like(numa_t.zone_free)

            def run(sync_mode="error", **more):
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode(sync_mode)
                try:
                    out = solver.solve_stream_full(pods_t, nodes_t, params_t, **kw,
                                                   zone_free_out=zone_free, **more)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                placed = int((out[0] >= 0).sum())  # the caller's read
                return out, placed, time.perf_counter() - t0

            import warnings

            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                first_seconds = run("warn")[2]
            first_syncs = sum(is_sync_warning(w) for w in caught)
            kernels.reset_launches()
            out, placed, seconds = run()
            launches = dict(kernels.launches)
            replays = dict(kernels.replays)
            final_zones = zone_free.cpu().numpy()
            times = [seconds] + [run()[2] for _ in range(PASSES - 1)]
            need = ["zone_prep", "nominate", "round_tail", "zone_phase", "enforce_gangs"]
            if k:
                need += ["shortlist_build", "shortlist_round"]
            for name in need:
                if launches.get(name, 0) <= 0:
                    fail(f"numa stream ({scoring}, K={k}): launched no {name} kernel")
            if replays.get("solve_stream") != n_batches:
                fail(f"numa stream ({scoring}, K={k}): {replays} replays, not one a chunk")
            asg, zones, rounds, fallbacks = (t.cpu().numpy() for t in out)
            key = f"full_{(scoring or 'none').lower()}_k{k or 0}"
            got = dict(placed=placed, rounds=int(rounds.sum()),
                       fallbacks=fallbacks.sum(axis=0).tolist(), sha256=assignments_digest(asg),
                       zones_sha256=assignments_digest(zones),
                       zone_free_sha256=hashlib.sha256(
                           np.ascontiguousarray(final_zones, dtype="<f4").tobytes()).hexdigest())
            want = dict(placed=int(gold[f"{key}_placed"]), rounds=int(gold[f"{key}_rounds"]),
                        fallbacks=gold[f"{key}_fallbacks"].tolist(),
                        sha256=str(gold[f"{key}_sha256"]),
                        zones_sha256=str(gold[f"{key}_zones_sha256"]),
                        zone_free_sha256=str(gold[f"{key}_zone_free_sha256"]))
            if got != want:
                fail(f"numa stream ({scoring}, K={k}): {got} differs from the golden {want}")
            plain_zone_free = torch.empty_like(zone_free)
            t0 = time.perf_counter()
            with plain_versions():
                p_out = solver.solve_stream_full(pods_t, nodes_t, params_t, **kw,
                                                 zone_free_out=plain_zone_free, cuda_graph=False)
            torch.cuda.synchronize()
            p_seconds = time.perf_counter() - t0
            if not (all(bits_equal(a.cpu(), b) for a, b in zip(p_out, (asg, zones, rounds,
                                                                       fallbacks)))
                    and bits_equal(plain_zone_free.cpu(), final_zones)):
                fail(f"numa stream ({scoring}, K={k}): the graph and the eager plain pass differ")
            med = sorted(times)[len(times) // 2]
            profile = stream_profile(torch, run, med)
            name = f"{scoring or 'no scoring'}, K={k or 'off'}"
            lines[name] = dict(
                placed=placed, zoned=int((zones >= 0).sum()), pods_per_s=N_PODS / med,
                pass_seconds=times, first_pass_seconds=first_seconds,
                plain_pass_seconds=p_seconds, rounds_used=got["rounds"],
                fallbacks=got["fallbacks"], graph_replays=replays.get("solve_stream", 0),
                launches=launches, host_syncs_per_pass=0, host_syncs_first_pass=first_syncs,
                sha256=got["sha256"], zones_sha256=got["zones_sha256"],
                zone_free_sha256=got["zone_free_sha256"], **profile,
            )
            print(json.dumps({"numa_stream": {name: lines[name]}}), flush=True)
            for row in report["kernels"]:
                nm = row["name"]
                if nm == "round_tail_zone":
                    row["launches"] = row["launches"] or launches.get("zone_phase")
                elif nm in ("zone_refund", "zone_prep"):
                    row["launches"] = row["launches"] or launches.get(nm)
                elif nm == "nominate_numa" and not k:
                    row["launches"] = row["launches"] or launches.get("nominate")
                elif nm.endswith("_numa") and k and nm[:-5] in launches:
                    row["launches"] = row["launches"] or launches[nm[:-5]]
            kernels.reset_launches()
    report["numa_streams"] = lines


def device_port_inputs(torch, device, n_pods: int = 16 * BATCH, rdma: bool = True):
    """The device kernel checks' inputs: ``rich_fixture(1, N_NODES,
    n_pods)`` with ``device_tables(DEVICE_SEED)``' devices (G = 16 with
    RDMA and FPGA tracked; with ``rdma`` False G = 8 and RDMA not tracked)
    as the port's tensors on ``device``: (nodes, flat pods, params,
    DeviceState)."""
    from koordinator_tpu_torch.ops.device import DeviceState

    nodes, pods, params = rich_fixture(1, N_NODES, n_pods)
    pods, devices = device_tables(DEVICE_SEED, nodes, pods, g16=rdma, rdma=rdma)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, pods, params, device)
    return nodes_t, pods_t, params_t, DeviceState.create(**devices, device=device)


def device_round_case(torch, pods_b, state, dev_tables, dev_t, params_t, scoring: int):
    """Round 0 of batch ``pods_b`` with devices at node state ``state`` and
    dev carry ``dev_tables`` (slots, rdma, fpga): the sorted pods, the
    nomination kernel's arguments and the batch's DeviceTerms (its stats
    table from ``csrc/device_prep.cu``, tables cloned)."""
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.device import DeviceTerms

    _, spods, bind, thr, pthr = solver._round_setup(pods_b, state, params_t, devices=True)
    nom_args = (
        spods.requests, spods.estimate, spods.is_prod, bind, spods.valid, state.allocatable,
        state.requested, state.estimated_used, state.prod_used, state.metric_fresh,
        state.schedulable, state.cpu_amp, thr, pthr, params_t.score_weights,
    )
    slots, rdma, fpga = (None if t is None else t.clone() for t in dev_tables)
    terms = DeviceTerms.batch_start(slots, rdma if dev_t.rdma_free is not None else None,
                                    fpga if dev_t.fpga_free is not None else None,
                                    dev_t.cap_total, spods, scoring)
    return spods, nom_args, terms


def device_terms_copy(terms, to=None):
    """A copy of DeviceTerms (on device ``to``, or where they are) whose
    tables a round tail may charge."""
    import dataclasses as dc

    def cp(t):
        return None if t is None else (t.to(to) if to is not None else t).clone()

    return dc.replace(terms, **{f.name: cp(getattr(terms, f.name))
                                for f in dc.fields(terms) if f.name != "scoring"})


def device_pair_ops(terms, pairs: int) -> int:
    """fp32 operations of the device terms of ``pairs`` (pod, node) pairs
    (see PERF.md): the fit's compares and adds (10), RDMA and FPGA (2 each
    tracked), with a score its subtractions, product, division, floor and
    tests (8)."""
    ops = pairs * (10 + (2 if terms.rdma is not None else 0) + (2 if terms.fpga is not None
                                                                 else 0))
    return ops + (pairs * 8 if terms.scoring else 0)


def phase_device_kernels(torch, dev, report):
    """Phase 12, devices: ``csrc/device_prep.cu``, the three pricing
    kernels with the device terms under each ``device_scoring`` (and none),
    the round tail's device phase (alone, with the one-hot quota tree, with
    NUMA zones, with both) and ``enforce_gangs``' device refunds, each
    against its plain version on the same inputs (the round tail and the
    rollback on CPU copies), at P=512 and 4,096 over 10,000 nodes with
    ``device_tables``' devices (G = 16, RDMA and FPGA tracked; and G = 8
    with RDMA not tracked), at the start and after 3 batches; then their
    times."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import commit as commit_ops
    from koordinator_tpu_torch.ops import device as device_ops
    from koordinator_tpu_torch.ops import nominate as nominate_ops
    from koordinator_tpu_torch.ops import quota as quota_ops
    from koordinator_tpu_torch.ops import shortlist as sl
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.numa import NumaState

    checks = {k: 0.0 for k in ("device_prep", "nominate_device", "shortlist_build_device",
                               "shortlist_round_device", "round_tail_device", "device_refund")}
    seen, timing = [], {}
    for rdma in (True, False):
        nodes_t, pods_t, params_t, dev_t = device_port_inputs(torch, dev, rdma=rdma)
        n = nodes_t.allocatable.shape[0]
        pods_s = solver.tree_map(lambda a: a.reshape((-1, BATCH) + a.shape[1:]), pods_t)
        carry0 = solver._dev_carry0(dev_t, n)
        later, carry = nodes_t, carry0
        for b in range(3):
            res = solver.assign(solver.tree_map(lambda a: a[b], pods_s), later, params_t,
                                devices=dev_t, dev_carry=carry, device_scoring="LeastAllocated",
                                **SOLVE)
            later = dataclasses.replace(later, requested=res.node_requested,
                                        estimated_used=res.node_estimated_used,
                                        prod_used=res.node_prod_used)
            carry = (res.node_dev_slots, res.node_rdma_free, res.node_fpga_free)
        tag = "G=16" if rdma else "G=8, RDMA not tracked"
        cases = [(f"start, P=512, {tag}", solver.tree_map(lambda a: a[3], pods_s), nodes_t,
                  carry0),
                 (f"after 3 batches, P=512, {tag}", solver.tree_map(lambda a: a[4], pods_s),
                  later, carry),
                 (f"after 3 batches, P=4096, {tag}",
                  solver.tree_map(lambda a: a[8:16].reshape((-1,) + a.shape[2:]), pods_s), later,
                  carry)]
        quota_t = None
        for label, pods_b, state, tables in cases:
            p_b = pods_b.requests.shape[0]
            for scoring in (0, 1, 2):
                spods, nom_args, terms = device_round_case(torch, pods_b, state, tables, dev_t,
                                                           params_t, scoring)
                checks["device_prep"] = max(checks["device_prep"], check_equal(
                    f"device_prep ({label})",
                    [("stats", terms.stats, device_ops.device_prep_plain(terms.slots))]))
                for approx in (False, True):
                    kc, ki = nominate_ops.nominate(*nom_args, 4, 4.0, approx, devices=terms)
                    pc, pi = nominate_ops.nominate_plain(*nom_args, 4, 4.0, approx,
                                                         devices=terms)
                    torch.cuda.synchronize()
                    kc, ki, pc, pi = (t.cpu().numpy() for t in (kc, ki, pc, pi))
                    fin = np.isfinite(kc)
                    if not (np.array_equal(fin, np.isfinite(pc)) and bits_equal(kc[fin], pc[fin])
                            and np.array_equal(ki[fin], pi[fin])):
                        fail(f"nominate with devices ({label}, scoring {scoring}, "
                             f"approx={approx}): differs from nominate_plain")
                    checks["nominate_device"] = max(checks["nominate_device"],
                                                    max_abs(kc[fin], pc[fin]))
                b_args = nom_args[:4] + nom_args[5:]
                plan = sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, devices=terms)
                want = sl.shortlist_build_plain(*b_args, SHORTLIST_K, 4.0, devices=terms)
                fin = torch.isfinite(want[1])
                checks["shortlist_build_device"] = max(checks["shortlist_build_device"],
                                                       check_equal(
                    f"shortlist_build with devices ({label}, scoring {scoring})",
                    [("cand", plan[0], want[0]), ("bound", plan[1][fin], want[1][fin]),
                     ("finite", torch.isfinite(plan[1]), fin)]))
                outs = []
                for fn in (sl.shortlist_round, sl.shortlist_round_plain):
                    word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
                    counts = torch.zeros(2, dtype=torch.int32, device=dev)
                    st = torch.zeros(2, dtype=torch.int32, device=dev)
                    top = fn(*nom_args, *plan, 4, 4.0, True, word, counts, st, devices=terms)
                    outs.append((*top, word[:3], counts))
                fin = torch.isfinite(outs[1][0])
                checks["shortlist_round_device"] = max(checks["shortlist_round_device"],
                                                       check_equal(
                    f"shortlist_round with devices ({label}, scoring {scoring})",
                    [("cost", outs[0][0][fin], outs[1][0][fin]),
                     ("node", outs[0][1][fin], outs[1][1][fin]),
                     ("word", outs[0][2], outs[1][2]), ("counts", outs[0][3], outs[1][3])]))
                if scoring != 1:
                    continue
                # the round tail's device phase on the kernel's nomination:
                # alone, with quotas, with zones, with both
                top = nominate_ops.nominate(*nom_args, 4, 4.0, True, devices=terms)
                args = round_tail_args(torch, spods, nom_args, *top)
                if quota_t is None:
                    runtime, used = quota_tree(*QUOTA_TREES["onehot"],
                                               pods_t.requests.cpu().numpy())
                    chain, _, _ = quota_draws(*QUOTA_TREES["onehot"], pods_t.requests.shape[0])
                    quota_t = (torch.from_numpy(chain).to(dev),
                               torch.from_numpy(runtime * np.float32(0.3)).to(dev),
                               torch.from_numpy(used).to(dev))
                    _, numa, required = zone_tables(
                        NUMA_SEED, dict(allocatable=nodes_t.allocatable.cpu().numpy(),
                                        estimated_used=nodes_t.estimated_used.cpu().numpy()),
                        pods_t.requests.shape[0])
                    numa_t = NumaState.create(**numa, device=dev)
                for mode in ("alone", "quotas", "zones", "quotas and zones"):
                    q = z = None
                    order = solver._priority_order(pods_b)
                    if "quotas" in mode:
                        chain = quota_t[0][:p_b][order]
                        gate = torch.empty_like(spods.valid)
                        quota_ops.quota_gate_plain(spods.valid, spods.requests, chain,
                                                   quota_t[1], quota_t[2], gate)
                        q = (chain, quota_t[1], quota_t[2].clone(), gate)
                    if "zones" in mode:
                        z = (numa_t.zone_free.clone(), numa_t.zone_cap, numa_t.policy,
                             numa_t.zone_most, torch.from_numpy(required[:p_b]).to(dev)[order],
                             torch.full((p_b,), -1, dtype=torch.int32, device=dev))
                    work = [t.clone() for t in args]
                    wd = device_terms_copy(terms)
                    wq = None if q is None else (q[0], q[1], q[2].clone(), q[3].clone())
                    wz = None if z is None else (z[0].clone(),) + z[1:5] + (z[5].clone(),)
                    kernels.reset_launches()
                    commit_ops.round_tail(*work, 0.35, quota=wq, zone=wz, dev=wd)
                    if kernels.launches.get("device_phase", 0) != 1:
                        fail(f"round_tail with devices ({label}, {mode}): no device phase ran")
                    host = [t.cpu().clone() for t in args]
                    hd = device_terms_copy(terms, "cpu")
                    hq = None if q is None else tuple(t.cpu().clone() for t in q)
                    hz = None if z is None else tuple(t.cpu().clone() for t in z)
                    commit_ops.round_tail_plain(*host, 0.35, quota=hq, zone=hz, dev=hd)
                    names = ("requested", "estimated_used", "prod_used", "assigned", "active",
                             "state")
                    pairs = [(nm, a, b) for nm, a, b in zip(names, work[ROUND_MUTABLE],
                                                             host[ROUND_MUTABLE])]
                    pairs += [("slots", wd.slots, hd.slots), ("stats", wd.stats, hd.stats)]
                    pairs += [(nm, getattr(wd, nm), getattr(hd, nm)) for nm in ("rdma", "fpga")
                              if getattr(wd, nm) is not None]
                    if q is not None:
                        pairs += [("quota_used", wq[2], hq[2]), ("gate", wq[3], hq[3])]
                    if z is not None:
                        pairs += [("zone_free", wz[0], hz[0]), ("pod_zone", wz[5], hz[5])]
                    checks["round_tail_device"] = max(checks["round_tail_device"], check_equal(
                        f"round_tail with devices ({label}, {mode})", pairs))
                    # the same round without devices: which pods the devices refused
                    plain_nd = [t.cpu().clone() for t in args]
                    commit_ops.round_tail_plain(
                        *plain_nd, 0.35,
                        quota=None if q is None else tuple(t.cpu().clone() for t in q),
                        zone=None if z is None else tuple(t.cpu().clone() for t in z))
                    changed = int((hd.slots != terms.slots.cpu()).any(dim=1).sum())
                    refused = int(((plain_nd[14] >= 0) & (host[14] < 0)).sum())
                    if mode == "alone" and (changed == 0 or refused == 0):
                        fail(f"round_tail with devices ({label}): the check needs slot "
                             "commits and device refusals")
                    seen.append(dict(at=label, mode=mode, nodes_charged=changed,
                                     refused_by_devices=refused))
                    if mode == "alone" and rdma and label.startswith("after") and "512" in label:
                        timing["round"] = (spods, nom_args, terms, args)
            # the rollback's device refunds on the batch's solve result; a
            # third of the GPU pods placed join gang 0, which falls short
            free = dataclasses.replace(pods_b, gang_id=torch.full_like(pods_b.gang_id, -1))
            pre = solver.assign(free, state, params_t, devices=dev_t, dev_carry=tables,
                                device_scoring="LeastAllocated", **SOLVE)
            gpu = (pods_b.gpu_whole > 0) | (pods_b.gpu_share > 0)
            third = gpu & (pre.assignment >= 0) & (torch.arange(p_b, device=dev) % 3 == 0)
            gang_min = pods_b.gang_min.clone()
            gang_min[0] = p_b + 1
            nonstrict = pods_b.gang_nonstrict.clone()
            nonstrict[0] = False
            pods_g = dataclasses.replace(pods_b, gang_id=torch.where(third, 0, pods_b.gang_id),
                                         gang_min=gang_min, gang_nonstrict=nonstrict)
            exists = device_ops.slot_exists_of(dev_t.cap_total, dev_t.slot_free.shape[1])
            kernels.reset_launches()
            got = solver.enforce_gangs(pre, pods_g, exists)
            if kernels.launches.get("device_refund", 0) != 1:
                fail(f"enforce_gangs with devices ({label}): no device refund ran")
            want = solver.enforce_gangs_plain(solver.tree_map(lambda a: a.cpu(), pre),
                                              solver.tree_map(lambda a: a.cpu(), pods_g),
                                              exists.cpu())
            checks["device_refund"] = max(checks["device_refund"], check_equal(
                f"enforce_gangs with devices ({label})",
                [(f, getattr(got, f), getattr(want, f)) for f in (
                    "assignment", "node_requested", "node_estimated_used", "node_prod_used",
                    "node_dev_slots", "node_rdma_free", "node_fpga_free")]))
            rolled = (pre.assignment >= 0) & (got.assignment < 0)
            refunded = int((rolled & gpu).sum())
            if refunded == 0:
                fail(f"enforce_gangs with devices ({label}): the check needs rolled-back GPU "
                     "pods")
            seen.append(dict(at=label, rolled_back=int(rolled.sum()), gpu_refunds=refunded))
            if rdma and label.startswith("after") and "512" in label:
                timing["gangs"] = (pre, pods_g, exists)
    print(f"device checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"{json.dumps(seen)}", flush=True)

    # times, after 3 batches at P=512, G=16, LeastAllocated device scores
    spods, nom_args, terms, args = timing["round"]
    p, d = spods.requests.shape
    n, g = terms.slots.shape
    dev_node = n * (4 * 4 + 3 * 4)
    dev_pod = p * (4 * 4 + 4)

    def add_row(name, source, replaces, fn, plain, kname, nbytes, nops, iters, per_call=1):
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            kernels_per_launch=per_call, max_abs_err=checks.get(name, 0.0),
            ms=cuda_ms(torch, fn, iters), plain_ms=cuda_ms(torch, plain, 3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            device_ms=device_ms(torch, fn, min(50, iters // 4), kname),
            library_device_ms=None, bytes=nbytes, operations=nops,
        ))

    add_row("device_prep", "koordinator_tpu_torch/csrc/device_prep.cu",
            "koordinator_tpu/ops/device.py:58", lambda: device_ops.device_prep(terms.slots),
            lambda: device_ops.device_prep_plain(terms.slots), "device_prep_kernel",
            n * g * 4 + n * 4 * 4, n * g * 5, 200)
    feas = int(nominate_ops.feasible_mask(*nom_args[:14]).sum())
    fresh_nodes = int(nom_args[9].sum())
    bind_pods = int(nom_args[3].sum())
    node_row = 6 * d * 4 + 2 + 4
    nom_ops = pair_ops(d, p * n, bind_pods * n, (int(spods.valid.sum())
                                                + int(spods.is_prod.sum())) * fresh_nodes, feas)
    nom_bytes = n * node_row + p * (2 * d * 4 + 3) + d * 4 + p * 4 * 8 + dev_node + dev_pod
    chunk = nominate_ops.chunk_of(kernels.library("nominate"), p, n, d, 4, dev.index or 0, 3)
    add_row("nominate_device", "koordinator_tpu_torch/csrc/nominate.cu",
            "koordinator_tpu/ops/device.py:73", lambda: nominate_ops.nominate(
                *nom_args, 4, 4.0, True, devices=terms),
            lambda: nominate_ops.nominate_plain(*nom_args, 4, 4.0, True, devices=terms),
            "nominate", nom_bytes, nom_ops + device_pair_ops(terms, p * n), 200,
            1 if chunk >= n else 2)
    b_args = nom_args[:4] + nom_args[5:]
    plan = sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, devices=terms)
    build_bytes = (n * node_row + p * (2 * d * 4 + 2) + d * 4 + p * (SHORTLIST_K + 1) * 4
                   + dev_node + dev_pod)
    add_row("shortlist_build_device", "koordinator_tpu_torch/csrc/shortlist_build.cu",
            "koordinator_tpu/ops/costs.py:162",
            lambda: sl.shortlist_build(*b_args, SHORTLIST_K, 4.0, devices=terms),
            lambda: sl.shortlist_build_plain(*b_args, SHORTLIST_K, 4.0, devices=terms),
            "shortlist_build_kernel", build_bytes, nom_ops + device_pair_ops(terms, p * n), 100)
    word = torch.zeros(sl.WORD, dtype=torch.int32, device=dev)
    counts = torch.zeros(2, dtype=torch.int32, device=dev)
    st = torch.zeros(2, dtype=torch.int32, device=dev)
    cand = plan[0].long()
    round_bytes = (p * (SHORTLIST_K + 1) * 4 + p * (2 * d * 4 + 3)
                   + int(torch.unique(cand).numel()) * (node_row + 7 * 4)
                   + d * 4 + p * 4 * 8 + (sl.WORD + 4) * 4 + dev_pod)
    add_row("shortlist_round_device", "koordinator_tpu_torch/csrc/shortlist_round.cu",
            "koordinator_tpu/ops/device.py:117",
            lambda: sl.shortlist_round(*nom_args, *plan, 4, 4.0, True, word, counts, st,
                                       devices=terms),
            lambda: sl.shortlist_round_plain(*nom_args, *plan, 4, 4.0, True, word, counts, st,
                                             devices=terms),
            "shortlist_round_kernel", round_bytes,
            pair_ops(d, p * SHORTLIST_K, bind_pods * SHORTLIST_K, p * SHORTLIST_K, feas // 10)
            + device_pair_ops(terms, p * SHORTLIST_K), 200)
    iters = 200
    copies = iter([([t.clone() for t in args[ROUND_MUTABLE]], device_terms_copy(terms))
                   for _ in range(2 * iters + 2)])
    fixed = args[:ROUND_MUTABLE.start]

    def t_round():
        mut, dt = next(copies)
        commit_ops.round_tail(*fixed, *mut, 0.35, dev=dt)

    def t_round_plain():
        commit_ops.round_tail_plain(*fixed, *[t.clone() for t in args[ROUND_MUTABLE]], 0.35,
                                    dev=device_terms_copy(terms))

    _, node_key = commit_ops._choose(args[0], args[1], args[15], n)
    touched = int(torch.unique(node_key[node_key < n]).numel())
    rt_bytes = (round_tail_bytes(torch, args, n) + touched * (g * 4 * 2 + 4 * 4 * 2 + 4 * 4)
                + p * 16)
    rt_ops = round_tail_ops(args) + p * 12 + touched * g * 8
    add_row("round_tail_device", "koordinator_tpu_torch/csrc/round.cu",
            "koordinator_tpu/ops/solver.py:1246", t_round, t_round_plain, "round_tail_kernel",
            rt_bytes, rt_ops, iters)
    pre, pods_g, exists = timing["gangs"]
    gang_copies = iter([solver.tree_map(lambda a: a.clone(), pre) for _ in range(402)])
    after = solver.enforce_gangs(pre, pods_g, exists)
    rolled = (pre.assignment >= 0) & (after.assignment < 0)
    n_rolled = int(rolled.sum())
    refunded = int(torch.unique(pre.assignment[rolled]).numel())
    dr_bytes = (p * (4 * 4 + 2 * d * 4 + 2 + 16) + refunded * (3 * d * 4 + g * 4 + 8) * 2
                + n * 4)
    dr_ops = p * 4 + n_rolled * (3 * d + 4) + refunded * (3 * d + g * (g + 8))
    add_row("device_refund", "koordinator_tpu_torch/csrc/gangs.cu",
            "koordinator_tpu/ops/device.py:209",
            lambda: solver._enforce_gangs_(next(gang_copies), pods_g, exists),
            lambda: solver.enforce_gangs_plain(pre, pods_g, exists), "enforce_gangs_kernel",
            dr_bytes, dr_ops, 200)
    report["device_checks"] = seen
    kernels.reset_launches()


def phase_device_streams(torch, dev, report):
    """Phase 13: the scheduler's stream with devices at full size —
    ``solve_stream_full(devices=...)`` over the headline fixture (98,304
    pods, 10,000 nodes, 192 x 512, bench's arguments) with ``gpu_fleet``'s
    devices for each cell of ``DEVICE_CELLS`` (no scoring and
    LeastAllocated with ``shortlist_k=64`` and without; MostAllocated with
    ``shortlist_k=64``, which the reference's gate turns into the full-axis
    solve): one CUDA graph replay a chunk, a first pass (the capture) then
    timed passes with no host sync (counts zeroed just before the first and
    read just after it, every kernel of the path launched); placed count,
    summed rounds, fallback counts and the sha256 of the assignments and
    the final slot table, RDMA and FPGA counts equal to the device golden's;
    then one eager pass through the plain versions, equal."""
    import warnings

    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.device import DeviceState

    gold = np.load(GOLDEN_DEVICE)
    nodes, pods, params = headline_inputs(build_fixture(0))
    pods, devices = gpu_fleet(nodes, pods)
    if str(gold["full_fixture_sha256"]) != fixture_digest(
            nodes, pods, params, {k: v for k, v in devices.items() if v is not None}):
        fail("device streams: the fixture differs from the one the golden was made from")
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, stacked(pods), params, dev)
    dev_t = DeviceState.create(**devices, device=dev)
    n_batches = N_PODS // BATCH
    lines = {}
    for scoring, k in DEVICE_CELLS:
        kw = dict(SOLVE, devices=dev_t, device_scoring=scoring, shortlist_k=k)
        outs = (torch.empty_like(dev_t.slot_free), torch.empty_like(dev_t.rdma_free),
                torch.empty_like(dev_t.fpga_free))

        def run(sync_mode="error", **more):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode(sync_mode)
            try:
                out = solver.solve_stream_full(pods_t, nodes_t, params_t, **kw, dev_out=outs,
                                               **more)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            placed = int((out[0] >= 0).sum())  # the caller's read
            return out, placed, time.perf_counter() - t0

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            first_seconds = run("warn")[2]
        first_syncs = sum(is_sync_warning(w) for w in caught)
        kernels.reset_launches()
        out, placed, seconds = run()
        launches = dict(kernels.launches)
        replays = dict(kernels.replays)
        final = [t.cpu().numpy() for t in outs]
        times = [seconds] + [run()[2] for _ in range(PASSES - 1)]
        shortlist = solver._shortlist_on(k, SOLVE.get("topk", 4), N_NODES, scoring)
        need = ["device_prep", "nominate", "round_tail", "device_phase", "enforce_gangs",
                "device_refund"] + (["shortlist_build", "shortlist_round"] if shortlist else [])
        for name in need:
            if launches.get(name, 0) <= 0:
                fail(f"device stream ({scoring}, K={k}): launched no {name} kernel")
        if not shortlist and launches.get("shortlist_build", 0):
            fail(f"device stream ({scoring}, K={k}): the shortlist ran past the reference's gate")
        if replays.get("solve_stream") != n_batches:
            fail(f"device stream ({scoring}, K={k}): {replays} replays, not one a chunk")
        asg, _, rounds, fallbacks = (t.cpu().numpy() for t in out)
        key = f"full_{device_key(scoring, k)}"
        got = dict(placed=placed, rounds=int(rounds.sum()),
                   fallbacks=fallbacks.sum(axis=0).tolist(), sha256=assignments_digest(asg))
        for nm, a in zip(("slot_free", "rdma_free", "fpga_free"), final):
            got[f"{nm}_sha256"] = hashlib.sha256(
                np.ascontiguousarray(a, dtype="<f4").tobytes()).hexdigest()
        want = dict(placed=int(gold[f"{key}_placed"]), rounds=int(gold[f"{key}_rounds"]),
                    fallbacks=gold[f"{key}_fallbacks"].tolist(),
                    sha256=str(gold[f"{key}_sha256"]))
        for nm in ("slot_free", "rdma_free", "fpga_free"):
            want[f"{nm}_sha256"] = str(gold[f"{key}_{nm}_sha256"])
        if got != want:
            fail(f"device stream ({scoring}, K={k}): {got} differs from the golden {want}")
        plain_outs = tuple(torch.empty_like(t) for t in outs)
        t0 = time.perf_counter()
        with plain_versions():
            p_out = solver.solve_stream_full(pods_t, nodes_t, params_t, **kw,
                                             dev_out=plain_outs, cuda_graph=False)
        torch.cuda.synchronize()
        p_seconds = time.perf_counter() - t0
        if not (all(bits_equal(a.cpu(), b) for a, b in zip(p_out, (asg, None, rounds, fallbacks))
                    if b is not None)
                and all(bits_equal(a.cpu(), b) for a, b in zip(plain_outs, final))):
            fail(f"device stream ({scoring}, K={k}): the graph and the eager plain pass differ")
        med = sorted(times)[len(times) // 2]
        profile = stream_profile(torch, run, med)
        name = f"{scoring or 'no scoring'}, K={k or 'off'}"
        lines[name] = dict(
            placed=placed, pods_per_s=N_PODS / med, pass_seconds=times,
            first_pass_seconds=first_seconds, plain_pass_seconds=p_seconds,
            rounds_used=got["rounds"], fallbacks=got["fallbacks"], shortlist=shortlist,
            graph_replays=replays.get("solve_stream", 0), launches=launches,
            host_syncs_per_pass=0, host_syncs_first_pass=first_syncs, sha256=got["sha256"],
            slot_free_sha256=got["slot_free_sha256"], **profile,
        )
        print(json.dumps({"device_stream": {name: lines[name]}}), flush=True)
        for row in report["kernels"]:
            nm = row["name"]
            if nm == "round_tail_device":
                row["launches"] = row["launches"] or launches.get("device_phase")
            elif nm in ("device_refund", "device_prep"):
                row["launches"] = row["launches"] or launches.get(nm)
            elif nm == "nominate_device" and not shortlist:
                row["launches"] = row["launches"] or launches.get("nominate")
            elif nm.endswith("_device") and shortlist and nm[:-7] in launches:
                row["launches"] = row["launches"] or launches[nm[:-7]]
        kernels.reset_launches()
    report["device_streams"] = lines


SEAM_NODES = 10_000
SEAM_PODS = 20_480
#: the later cycles' waves of new pods: two chunks of the default bucket
#: (the scanned path), touching few enough nodes that the next refresh
#: scatters their rows in place
SEAM_WAVE = 4_608
#: the transformer cycle: 8,192 pods through ``_dispatch_pipelined``
SEAM_TRANSFORM_PODS = 8_192
GOLDEN_SEAM = os.path.join(ROOT, "tests", "data", "torch_golden_seam.npz")


@dataclasses.dataclass(frozen=True)
class SeamModules:
    """The modules of one package that the seam's recipe builds from, each
    under its path in the package. The caller imports them from its own
    package (:func:`port_modules` here; the golden's tool and the tests
    import the reference's), so this script never names the reference."""
    extension: object           # api/extension.py
    types: object               # api/types.py
    topology: object            # core/topology.py
    snapshot: object            # core/snapshot.py
    nodenumaresource: object    # scheduler/plugins/nodenumaresource.py
    deviceshare: object         # scheduler/plugins/deviceshare.py
    elasticquota: object        # scheduler/plugins/elasticquota.py
    reservation: object         # scheduler/plugins/reservation.py
    batch_solver: object        # scheduler/batch_solver.py


def port_modules() -> SeamModules:
    """The port's :class:`SeamModules`."""
    from koordinator_tpu_torch.api import extension, types
    from koordinator_tpu_torch.core import snapshot, topology
    from koordinator_tpu_torch.scheduler import batch_solver
    from koordinator_tpu_torch.scheduler.plugins import (
        deviceshare,
        elasticquota,
        nodenumaresource,
        reservation,
    )

    return SeamModules(extension, types, topology, snapshot, nodenumaresource, deviceshare,
                       elasticquota, reservation, batch_solver)


def production_scheduler(mods: SeamModules, n_nodes: int, n_pods: int,
                         batch_bucket: int = 4096, device=None, selectors: bool = False):
    """The JAX package's ``__graft_entry__._dryrun_production_scheduler``
    cluster built from ``mods`` (one package's :class:`SeamModules`), so
    both schedulers see the same snapshot and managers:
    ``n_nodes`` nodes of 16 CPUs and 64 GiB with a 2-socket SingleNUMANode
    topology and 4 GPUs, the ``dry-team`` quota (sized for the GPU pods
    of :func:`production_pods`' ``n_pods``) and the ``dry-resv``
    reservation, its ghost placed. ``device``
    goes to the scheduler when given (the port's); ``selectors`` labels
    the nodes ``zone=a``/``b``."""
    ext, t = mods.extension, mods.types
    topo = mods.topology.CPUTopology.uniform(
        sockets=2, numa_per_socket=1, cores_per_numa=8, threads_per_core=1)
    numa_mod = mods.nodenumaresource
    snap = mods.snapshot.ClusterSnapshot()
    numa = numa_mod.NUMAManager(snap)
    dm = mods.deviceshare.DeviceManager(snap)
    for i in range(n_nodes):
        name = f"n{i:05d}"
        labels = {"zone": "ab"[i % 2]} if selectors else {}
        snap.upsert_node(t.Node(
            meta=t.ObjectMeta(name=name, labels=labels),
            status=t.NodeStatus(allocatable={ext.RES_CPU: 16000, ext.RES_MEMORY: 65536}),
        ))
        numa.register_node(name, topo, numa_mod.NUMAPolicy.SINGLE_NUMA_NODE,
                           memory_per_zone_mib=32768)
        dm.upsert_device(t.Device(
            meta=t.ObjectMeta(name=name),
            devices=[t.DeviceInfo(dev_type="gpu", minor=g, numa_node=g // 2)
                     for g in range(4)],
        ))
    n_gpu = n_pods - 1 - (n_pods - 1) * 3 // 8
    gqm = mods.elasticquota.GroupQuotaManager(
        snap.config,
        cluster_total={ext.RES_CPU: 16000 * n_nodes, ext.RES_MEMORY: 65536 * n_nodes},
    )
    gqm.upsert_quota(t.ElasticQuota(
        meta=t.ObjectMeta(name="dry-team"),
        min={ext.RES_CPU: 4000 * n_gpu, ext.RES_MEMORY: 8192 * n_gpu},
        max={ext.RES_CPU: 8000 * n_gpu, ext.RES_MEMORY: 16384 * n_gpu},
    ))
    bs = mods.batch_solver
    kw = {} if device is None else {"device": device}
    sched = bs.BatchScheduler(snap, bs.LoadAwareArgs(), quotas=gqm, numa=numa, devices=dm,
                              batch_bucket=batch_bucket, **kw)
    sched.extender.monitor.stop_background()
    rm = mods.reservation.ReservationManager(sched)
    sched.reservations = rm
    rm.add(t.Reservation(
        meta=t.ObjectMeta(name="dry-resv"),
        requests={ext.RES_CPU: 2000, ext.RES_MEMORY: 4096},
        owners=[t.ReservationOwner(label_selector={"app": "resv-owner"})],
    ))
    if rm.schedule_pending() < 1:
        raise RuntimeError("the reservation's ghost was not placed")
    return sched


def production_pods(mods: SeamModules, n_pods: int, prefix: str = "", owner: bool = True,
                    selectors: bool = False, gang: int = 0):
    """The recipe's pods: 3/8 LSR cpuset pods (4 CPUs, priority 9500), the
    rest GPU pods under the ``dry-team`` quota (2 CPUs, 2 GPUs, priority
    9000) and, with ``owner``, the reservation's owner last (one pod of
    ``n_pods`` either way); names start with ``prefix``. ``selectors``
    gives every fifth GPU pod a ``zone=b`` node selector; ``gang`` > 0
    adds a Strict gang of that many 16-CPU pods, all required, before the
    owner."""
    ext, t = mods.extension, mods.types
    n_lsr = (n_pods - 1) * 3 // 8
    n_gpu = n_pods - int(owner) - n_lsr
    pods = []
    for i in range(n_lsr):
        pods.append(t.Pod(
            meta=t.ObjectMeta(name=f"{prefix}lsr{i:05d}", labels={ext.LABEL_POD_QOS: "LSR"}),
            spec=t.PodSpec(requests={ext.RES_CPU: 4000, ext.RES_MEMORY: 4096}, priority=9500),
        ))
    for i in range(n_gpu):
        spec = t.PodSpec(requests={ext.RES_CPU: 2000, ext.RES_MEMORY: 4096, ext.RES_GPU: 2},
                         priority=9000)
        if selectors and i % 5 == 0:
            spec.node_selector = {"zone": "b"}
        pods.append(t.Pod(
            meta=t.ObjectMeta(name=f"{prefix}gpu{i:05d}",
                              labels={ext.LABEL_QUOTA_NAME: "dry-team"}),
            spec=spec,
        ))
    for i in range(gang):
        pods.append(t.Pod(
            meta=t.ObjectMeta(name=f"{prefix}gang{i:03d}", annotations={
                ext.ANNOTATION_GANG_NAME: f"{prefix}dry-gang",
                ext.ANNOTATION_GANG_MIN_AVAILABLE: str(gang),
            }),
            spec=t.PodSpec(requests={ext.RES_CPU: 16000, ext.RES_MEMORY: 8192},
                           priority=9200),
        ))
    if owner:
        pods.append(t.Pod(
            meta=t.ObjectMeta(name=f"{prefix}owner", labels={"app": "resv-owner"}),
            spec=t.PodSpec(requests={ext.RES_CPU: 2000, ext.RES_MEMORY: 4096}, priority=9000),
        ))
    return pods


def seam_transform(cost):
    """The seam's BeforeScore transform (torch): node n costs 2 points
    more where ``n % 8 == 3`` and is vetoed (``+inf``) where
    ``n % 97 == 0``. Exact in float32 on any device: the costs are whole
    numbers, and the bias a power of two.
    ``tools/make_torch_golden.py:seam_transform_jax`` is the same in
    ``jnp``."""
    import torch

    n = torch.arange(cost.shape[1], device=cost.device)
    cost = cost + torch.where(n % 8 == 3, 2.0, 0.0)
    return torch.where((n % 97 == 0)[None, :], torch.inf, cost)


def seam_outcome(ext, out) -> dict:
    """What a scheduling cycle decided: each bound pod's node and its
    ``ANNOTATION_RESOURCE_STATUS``, ``ANNOTATION_DEVICE_ALLOCATED`` and
    ``ANNOTATION_RESERVATION_ALLOCATED``, and the unschedulable pods'
    names, sorted."""
    bound = sorted(
        (p.meta.name, node,
         p.meta.annotations.get(ext.ANNOTATION_RESOURCE_STATUS, ""),
         p.meta.annotations.get(ext.ANNOTATION_DEVICE_ALLOCATED, ""),
         p.meta.annotations.get(ext.ANNOTATION_RESERVATION_ALLOCATED, ""))
        for p, node in out.bound
    )
    return {"bound": bound, "unschedulable": sorted(p.meta.name for p in out.unschedulable)}


def seam_digest(outcome: dict) -> dict:
    """The sha256 of a cycle's bound pods with their annotations and of
    its unschedulable names, with their counts."""
    def sha(obj):
        return hashlib.sha256(json.dumps(obj).encode()).hexdigest()

    return {"bound": len(outcome["bound"]), "bound_sha256": sha(outcome["bound"]),
            "unschedulable": len(outcome["unschedulable"]),
            "unschedulable_sha256": sha(outcome["unschedulable"])}


def seam_cycles(mods: SeamModules, n_nodes: int = SEAM_NODES, n_pods: int = SEAM_PODS, waves: int = 2,
                wave: int = SEAM_WAVE, device=None, transform=None, schedule=None):
    """The seam's cycles on the scheduler of ``mods``' package: the recipe's ``n_pods``
    pods, then ``waves`` cycles each on the previous cycle's leftovers and
    ``wave`` new pods of the same mix (``w2-``, ``w3-``, ...), with
    ``transform`` registered as the BeforeScore cost transformer.
    ``schedule(sched, pods)`` runs a cycle (default ``sched.schedule``).
    Returns (scheduler, each cycle's :func:`seam_outcome`)."""
    ext = mods.extension
    sched = production_scheduler(mods, n_nodes, n_pods, device=device)
    if transform is not None:
        sched.extender.register_cost_transformer(transform)
    schedule = schedule or (lambda s, pods: s.schedule(pods))
    out = schedule(sched, production_pods(mods, n_pods))
    outcomes = [seam_outcome(ext, out)]
    for w in range(2, waves + 2):
        pods = list(out.unschedulable) + production_pods(mods, wave, prefix=f"w{w}-",
                                                         owner=False)
        out = schedule(sched, pods)
        outcomes.append(seam_outcome(ext, out))
    return sched, outcomes


def transform_port_inputs(torch, device, n_pods: int = 16 * BATCH):
    """The cost-transform kernel checks' inputs: ``rich_fixture(1,
    N_NODES, n_pods)`` with ``zone_tables(NUMA_SEED)``' zones,
    ``device_tables(DEVICE_SEED)``' devices and ``quota_draws``' node
    constraints (a quarter of the pods held to a quarter of the nodes), as
    the port's tensors on ``device``: (nodes, flat pods, params,
    NumaState, DeviceState, mask [n_pods, N] bool)."""
    from koordinator_tpu_torch.ops.device import DeviceState
    from koordinator_tpu_torch.ops.numa import NumaState

    nodes, pods, params = rich_fixture(1, N_NODES, n_pods)
    nodes, numa, required = zone_tables(NUMA_SEED, nodes, n_pods)
    pods, devices = device_tables(DEVICE_SEED, nodes, pods)
    _, constrained, zone = quota_draws(2, 2, n_pods)
    nodes_t, pods_t, params_t = port_inputs(torch, nodes, dict(pods, numa_required=required),
                                            params, device)
    mask = torch.from_numpy(node_mask_np(constrained, zone, N_NODES)).to(device)
    return (nodes_t, pods_t, params_t, NumaState.create(**numa, device=device),
            DeviceState.create(**devices, device=device), mask)


#: the cost-transform checks' transforms (torch, any device): a veto of
#: every fifth node, and a bias of a power of two on every eighth
TRANSFORMS = {
    "veto": lambda torch: lambda c: torch.where(
        (torch.arange(c.shape[1], device=c.device) % 5 == 0)[None, :], torch.inf, c),
    "bias": lambda torch: lambda c: c * 2.0 - torch.where(
        torch.arange(c.shape[1], device=c.device) % 8 == 3, 4.0, 0.0),
}
#: the pricing terms of each cost-transform check
TRANSFORM_MODES = ("plain", "mask", "numa", "devices", "numa+devices")


def phase_cost_transform_kernels(torch, dev, report):
    """Phase 14, the cost-transform route's kernels: ``csrc/cost_full.cu``
    (the materialized pre-jitter cost and the flags) and
    ``csrc/nominate_cost.cu`` (the jitter, ``+inf`` where infeasible and
    the top-k, over a transformed cost), each against its plain version on
    the same inputs, at P=512 and 4,096 over 10,000 nodes (D=2) with
    ``transform_port_inputs``' terms in each of ``TRANSFORM_MODES`` (the
    NUMA and device scores LeastAllocated), at the start and after 3
    batches, under each of ``TRANSFORMS``, with ``approx_topk`` and
    without: the cost buffer, the flags and the nomination vector bitwise
    equal. Then their times at P=4,096 with NUMA and devices (the seam's
    transformer cycle), the plain versions' and ``torch.topk``'s."""
    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import cost_full as cf
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.ops.device import DeviceTerms
    from koordinator_tpu_torch.ops.numa import ZoneTerms

    nodes_t, pods_t, params_t, numa_t, dev_t, mask_t = transform_port_inputs(torch, dev)
    n = nodes_t.allocatable.shape[0]
    pods_s = solver.tree_map(lambda a: a.reshape((-1, BATCH) + a.shape[1:]), pods_t)
    zone0 = numa_t.zone_free
    carry0 = solver._dev_carry0(dev_t, n)
    later, zone, carry = nodes_t, zone0, carry0
    for b in range(3):
        res = solver.assign(solver.tree_map(lambda a: a[b], pods_s), later, params_t,
                            numa=numa_t, numa_carry=zone, devices=dev_t, dev_carry=carry,
                            numa_scoring="LeastAllocated", device_scoring="LeastAllocated", **SOLVE)
        later = dataclasses.replace(later, requested=res.node_requested,
                                    estimated_used=res.node_estimated_used,
                                    prod_used=res.node_prod_used)
        zone, carry = res.node_zone_free, (res.node_dev_slots, res.node_rdma_free,
                                           res.node_fpga_free)
    cases = [("start, P=512", slice(3 * BATCH, 4 * BATCH), nodes_t, zone0, carry0),
             ("after 3 batches, P=512", slice(4 * BATCH, 5 * BATCH), later, zone, carry),
             ("after 3 batches, P=4096", slice(8 * BATCH, 16 * BATCH), later, zone, carry)]
    checks = {"cost_full": 0.0, "nominate_cost": 0.0}
    seen, timing = [], None
    for label, rows, state, zfree, tables in cases:
        pods_b = solver.tree_map(lambda a: a[rows], pods_t)
        order, spods, bind, thr, pthr = solver._round_setup(pods_b, state, params_t, numa=True,
                                                            devices=True)
        nom_args = (spods.requests, spods.estimate, spods.is_prod, bind, spods.valid,
                    state.allocatable, state.requested, state.estimated_used, state.prod_used,
                    state.metric_fresh, state.schedulable, state.cpu_amp, thr, pthr,
                    params_t.score_weights)
        for mode in TRANSFORM_MODES:
            kw = {}
            if mode == "mask":
                kw["mask"] = (mask_t[rows], order)
            if "numa" in mode:
                kw["zones"] = ZoneTerms.batch_start(zfree, numa_t.zone_cap, numa_t.policy,
                                                    spods.numa_required, 1)
            if "devices" in mode:
                slots, rdma, fpga = (t.clone() for t in tables)
                kw["devices"] = DeviceTerms.batch_start(slots, rdma, fpga, dev_t.cap_total,
                                                        spods, 1)
            kernels.reset_launches()
            got = cf.cost_full(*nom_args, **kw)
            if kernels.launches.get("cost_full", 0) != 1:
                fail(f"cost_full ({label}, {mode}): the kernel did not launch")
            want = cf.cost_full_plain(*nom_args, **kw)
            checks["cost_full"] = max(checks["cost_full"], check_equal(
                f"cost_full ({label}, {mode})",
                [("cost", got[0], want[0]), ("feasible", got[1], want[1])]))
            feas = int(got[1].sum())
            if feas == 0 or feas == got[1].numel():
                fail(f"cost_full ({label}, {mode}): the check needs feasible and infeasible "
                     "pairs")
            for tname, make in TRANSFORMS.items():
                cost = make(torch)(got[0]).contiguous()
                for approx in (True, False):
                    kc, ki = cf.nominate_cost(cost, got[1], 4, 4.0, approx)
                    pc, pi = cf.nominate_cost_plain(cost, got[1], 4, 4.0, approx)
                    kc, ki, pc, pi = (t.cpu().numpy() for t in (kc, ki, pc, pi))
                    if not (bits_equal(kc, pc) and np.array_equal(ki, pi)):
                        fail(f"nominate_cost ({label}, {mode}, {tname}, approx={approx}): "
                             "differs from nominate_cost_plain")
                    fin = np.isfinite(kc)
                    checks["nominate_cost"] = max(checks["nominate_cost"],
                                                  max_abs(kc[fin], pc[fin]))
            seen.append(dict(at=label, mode=mode, feasible_share=feas / got[1].numel()))
            if label.endswith("4096") and mode == "numa+devices":
                timing = (spods, nom_args, kw, bind)
    print(f"cost-transform checks: bitwise equal to the plain versions {json.dumps(checks)}; "
          f"{json.dumps(seen)}", flush=True)

    spods, nom_args, kw, bind = timing
    p, d = spods.requests.shape
    pairs = p * n
    cost, feas_buf = cf.cost_full(*nom_args, **kw)
    feas = int(feas_buf.sum())
    fresh_nodes = int(nom_args[9].sum())
    node_row = 6 * d * 4 + 2 + 4
    zones, devs = kw["zones"], kw["devices"]
    zone_bytes = n * (2 * zones.cap.shape[1] * zones.cap.shape[2] * 4
                      + (1 + zones.cap.shape[2] + zones.cap.shape[1]) * 4)
    in_bytes = (n * node_row + p * (2 * d * 4 + 4) + d * 4 + zone_bytes
                + n * (4 * 4 + 3 * 4) + p * (4 * 4 + 4))
    # every pair's score, no jitter: pair_ops less the jitter's 7 a pair
    a_ops = (pair_ops(d, pairs, int(bind.sum()) * n,
                      (int(spods.valid.sum()) + int(spods.is_prod.sum())) * fresh_nodes, pairs)
             - 7 * pairs + zone_pair_ops(zones, pairs) + device_pair_ops(devs, pairs))
    b_ops = pairs * 10
    transformed = TRANSFORMS["veto"](torch)(cost).contiguous()
    top = (torch.empty((p, 4), dtype=torch.float32, device=dev),
           torch.empty((p, 4), dtype=torch.int32, device=dev))

    def add_row(name, source, replaces, fn, plain, kname, nbytes, nops, iters, library=None):
        b_ms, b_by = bound_of(nbytes, nops)
        report["kernels"].append(dict(
            name=name, route="cuda", source=source, replaces=replaces, launches=None,
            kernels_per_launch=1, max_abs_err=checks[name],
            ms=cuda_ms(torch, fn, iters), plain_ms=cuda_ms(torch, plain, 3),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=None if library is None else cuda_ms(torch, library, iters),
            device_ms=device_ms(torch, fn, 20, kname),
            library_device_ms=None if library is None else device_ms(torch, library, 20, None),
            bytes=nbytes, operations=nops,
        ))

    add_row("cost_full", "koordinator_tpu_torch/csrc/cost_full.cu",
            "koordinator_tpu/ops/solver.py:864",
            lambda: cf.cost_full(*nom_args, **kw, out=(cost, feas_buf)),
            lambda: cf.cost_full_plain(*nom_args, **kw), "cost_full_kernel",
            pairs * 5 + in_bytes, a_ops, 50)
    add_row("nominate_cost", "koordinator_tpu_torch/csrc/nominate_cost.cu",
            "koordinator_tpu/ops/solver.py:1121",
            lambda: cf.nominate_cost(transformed, feas_buf, 4, 4.0, True, out=top),
            lambda: cf.nominate_cost_plain(transformed, feas_buf, 4, 4.0, True),
            "nominate_cost_kernel", pairs * 5 + p * 4 * 8, b_ops, 50,
            library=lambda: torch.topk(transformed, 4, dim=1, largest=False))
    # device_consumption (torch ops of each batch's device set-up) at the
    # seam's chunk: two int32/float32 reads and two float32 writes a pod,
    # three operations
    from koordinator_tpu_torch.ops.device import device_consumption

    dc_bytes, dc_ops = p * 16, p * 3
    dc = (spods.gpu_whole, spods.gpu_share)
    report["device_consumption"] = dict(
        pods=p, ms=cuda_ms(torch, lambda: device_consumption(*dc), 200),
        device_ms=device_ms(torch, lambda: device_consumption(*dc), 50, None),
        bound_ms=bound_of(dc_bytes, dc_ops)[0], bound_by=bound_of(dc_bytes, dc_ops)[1])
    print(json.dumps({"device_consumption": report["device_consumption"]}), flush=True)
    report["cost_transform_checks"] = seen
    kernels.reset_launches()


def phase_seam(torch, dev, report):
    """Phase 15, the scheduler seam at full size: the port's
    ``BatchScheduler.schedule`` on the production recipe
    (:func:`seam_cycles`: 10,000 nodes, 20,480 pods in five chunks of the
    default bucket of 4,096 through ``_dispatch_scanned`` and
    ``solve_stream_full`` at K=64, then two cycles each on the leftovers
    and a wave of 4,608), and the recipe with :func:`seam_transform`
    registered (8,192 pods through ``_dispatch_pipelined`` and
    ``assign(cost_transform=)``). Each cycle's digest of the bound pods
    with their nodes and annotations and of the unschedulable names must
    equal ``tests/data/torch_golden_seam.npz`` (the JAX scheduler's);
    ``_fallback_level`` must stay 0 and no solver failure may be noted.
    Launch counts are zeroed just before each path's first cycle and read
    just after its last, and every kernel of the path must have launched.
    For each cycle: wall time, split into host lowering, the device solve
    (the solver call, synchronized) and Reserve/commit; graph captures and
    their time; host syncs inside the solve; whether the resident node
    tables kept their addresses from the cycle before; and the busy share
    of each path's last cycle, profiled."""
    import warnings

    from koordinator_tpu_torch import kernels
    from koordinator_tpu_torch.ops import solver
    from koordinator_tpu_torch.scheduler import batch_solver as bs

    with np.load(GOLDEN_SEAM) as f:
        golden = {k: f[k].item() for k in f.files}
    stream_full, assign, graph_init = solver.solve_stream_full, bs.assign, \
        solver._StreamGraph.__init__
    captures = {"count": 0, "s": 0.0}

    def counted_init(self, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph_init(self, *a, **k)
        torch.cuda.synchronize()
        captures["count"] += 1
        captures["s"] += time.perf_counter() - t0

    def timed(fn, cur, key, solve=False):
        """``fn`` adding its seconds to ``cur[key]``; a solve is
        synchronized and its host syncs counted."""
        def run(*a, **k):
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if solve:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = fn(*a, **k)
                finally:
                    if solve:
                        torch.cuda.set_sync_debug_mode(0)
            if solve:
                torch.cuda.synchronize()
                cur["host_syncs_in_solve"] += sum(is_sync_warning(w) for w in caught)
            cur[key] += time.perf_counter() - t0
            return out
        return run

    def resident_ptrs(sched):
        state = sched._resident_nodes
        return [getattr(state, f.name).data_ptr() for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None]

    paths = {}
    for path, kw in (("scanned", {}),
                     ("transformer", dict(n_pods=SEAM_TRANSFORM_PODS, waves=0,
                                          transform=seam_transform))):
        stats, failures, ptrs = [], [], []
        last = 2 if path == "scanned" else 0

        def schedule(sched, pods):
            cur = dict(lowering_s=0.0, solve_s=0.0, commit_s=0.0, host_syncs_in_solve=0)
            for name in ("pod_batch", "node_state", "quota_state", "_constraint_states",
                         "_node_constraint_mask"):
                setattr(sched, name, timed(getattr(type(sched), name).__get__(sched), cur,
                                           "lowering_s"))
            sched._commit = timed(type(sched)._commit.__get__(sched), cur, "commit_s")

            def note(level, exc):
                failures.append(repr(exc))
                type(sched)._note_solver_failure(sched, level, exc)

            sched._note_solver_failure = note
            solver.solve_stream_full = timed(stream_full, cur, "solve_s", solve=True)
            bs.assign = timed(assign, cur, "solve_s", solve=True)
            cap0 = dict(captures)
            if not stats:
                kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prof = contextlib.nullcontext()
            if len(stats) == last:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CUDA])
            with prof as window:
                out = sched.schedule(pods)
                torch.cuda.synchronize()
            cur["wall_s"] = time.perf_counter() - t0
            cur["other_host_s"] = (cur["wall_s"] - cur["lowering_s"] - cur["solve_s"]
                                   - cur["commit_s"])
            cur["graph_captures"] = captures["count"] - cap0["count"]
            cur["capture_s"] = captures["s"] - cap0["s"]
            ptrs.append(resident_ptrs(sched))
            cur["resident_addresses_kept"] = len(ptrs) > 1 and ptrs[-1] == ptrs[-2]
            if window is not None:
                busy = profile_busy_ms(torch, window)
                cur["profiled_busy_ms"] = busy
                cur["profiled_busy_share"] = (busy / (cur["wall_s"] * 1e3)
                                              if isinstance(busy, float) else busy)
            if sched._fallback_level != 0 or sched._cycle_solver_failed or failures:
                fail(f"seam {path} cycle {len(stats) + 1}: the fallback ladder moved "
                     f"(level {sched._fallback_level}): {failures}")
            stats.append(cur)
            return out

        solver._StreamGraph.__init__ = counted_init
        try:
            t0 = time.perf_counter()
            _, outcomes = seam_cycles(port_modules(), device=dev, schedule=schedule, **kw)
            torch.cuda.synchronize()
            launches = dict(kernels.launches)
            total_s = time.perf_counter() - t0
        finally:
            solver.solve_stream_full, bs.assign = stream_full, assign
            solver._StreamGraph.__init__ = graph_init
        keys = (["transform"] if path == "transformer"
                else [f"c{c}" for c in range(1, len(outcomes) + 1)])
        for key, outcome, cur in zip(keys, outcomes, stats):
            digest = seam_digest(outcome)
            want = {k: golden[f"{key}_{k}"] for k in digest}
            if digest != want:
                fail(f"seam {path} cycle {key}: {digest} differs from the JAX golden {want}")
            cur.update(bound=digest["bound"], unschedulable=digest["unschedulable"])
        need = (("cost_full", "nominate_cost") if path == "transformer"
                else ("shortlist_build", "shortlist_round", "nominate"))
        need += ("round_tail", "enforce_gangs", "quota_gate", "zone_prep", "device_prep")
        missing = [k for k in need if launches.get(k, 0) == 0]
        if missing:
            fail(f"seam {path}: kernels of the path never launched: {missing} ({launches})")
        if path == "scanned" and not stats[-1]["resident_addresses_kept"]:
            fail("seam: the last cycle's refresh moved the resident node tables")
        paths[path] = launches
        print(f"seam_{path}: " + json.dumps(dict(
            cycles=stats, launches=launches, setup_and_cycles_s=total_s,
            golden="bitwise equal to the JAX scheduler's digests")), flush=True)
    for row in report["kernels"]:
        if row["name"] in ("cost_full", "nominate_cost"):
            row["launches"] = paths["transformer"][row["name"]]
    report["seam_launches"] = paths
    kernels.reset_launches()


def profile_busy_ms(torch, prof):
    """Device busy milliseconds of a profiled window: the sum of its CUDA
    kernel and copy intervals, or "not measured" when it shows none."""
    from torch.autograd import DeviceType

    busy = sum(evt.time_range.elapsed_us() for evt in prof.events()
               if evt.device_type == DeviceType.CUDA) / 1e3
    return busy if busy > 0 else "not measured"


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
    phase_shortlist_kernels(torch, dev, report)
    headline = phase_stream(torch, dev, report, trip_inputs)
    phase_shortlist_stream(torch, dev, report, headline)
    phase_golden(torch, dev)
    phase_two_cycles(torch, dev, report)
    phase_quota_kernels(torch, dev, report)
    phase_quota_streams(torch, dev, report)
    phase_numa_kernels(torch, dev, report)
    phase_bigbatch(torch, dev, report)
    phase_numa_streams(torch, dev, report)
    phase_device_kernels(torch, dev, report)
    phase_device_streams(torch, dev, report)
    phase_cost_transform_kernels(torch, dev, report)
    phase_seam(torch, dev, report)
    taken = sum(w["taken"] for w in DEVICE_WINDOWS)
    print(f"device_ms: {taken} of {len(DEVICE_WINDOWS)} readings whole; the others "
          f"(not measured): {json.dumps([w for w in DEVICE_WINDOWS if not w['taken']])}",
          flush=True)
    below = [(row["name"], row["device_ms"], row["bound_ms"]) for row in report["kernels"]
             if row.get("device_ms") is not None and row["device_ms"] < row["bound_ms"]]
    if below:
        fail(f"device times below their bound (name, device_ms, bound_ms): {below}")
    print(smi_line, flush=True)
    print(json.dumps({"kernels": report["kernels"]}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
