"""The port's CUDA kernels against their plain versions, on the card.

Every test needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Shapes cover the kernels' edges: one pod, fewer nodes than a node tile,
node counts off the tile and chunk sizes (1, 31, 5,003, 10,001), D = 1, 2,
3, 8 and 16 (the two tile heights), k = 1..8, round tails of 1 to 4,100
pods (one to three scan levels; more than one tile of 1,024 threads) at
D = 1 to 8 with hot nodes, negative ranks and a set ``done``, gang
rollbacks of 1 to 1,000 pods with no gangs, every gang short, NonStrict
gangs, all refunds on one node and refunds on node N-1, and the stream as
one CUDA graph replay a batch. The shortlist build at K = 1 to 200 (K + 1
= N; ties with the jitter off; keys in shared memory and, above 51,200
nodes, priced again each pass), the shortlist round at k = 1 to 8 with
real, lowered and unbounded bounds and a set ``done``, the fallback firing
on the contention fixture, the shortlist stream against the stream without
it and the shortlist golden, and two cycles on resident rows replaying one
graph. With quotas and node masks: the round-0 gate, the round tail's
quota commit on both of ``_quota_commit``'s branches (Q·D = 1,024 and
1,026 among them) at rounds of 1 to 4,096 pods, a round whose quotas
refuse every pod, the gang rollback's quota refund (Q == 1 skipped), the
three pricing kernels with a node mask (rows all false), and
``solve_stream_full`` against the quota golden. Above 4,096 pods: round
tails of 4,097 to 16,384 pods at D = 1, 4 and 8 with the one-hot, sorted
and 64-bit-key (Q = 300,000) trees, rollbacks of 8,192 to 20,000 pods in
shared and device memory, and the big-batch golden. With NUMA zones: the
three pricing kernels' NUMA instantiations at Z = 1, 2 and 4 under each
scoring, the round tail's zone phase at 1 to 8,192 pods with and without
quotas, the zone refund up to 16,384 pods, and ``solve_stream_full`` with
the zone carry against the NUMA golden; the batch-start zone snapshot and
side table at 1 to 10,000 nodes and Z = 1 to 8. With devices: the stats
table at G = 1 to 256, the three pricing kernels' device instantiations
(G = 8 and 16, slots padded to 24, RDMA tracked and not, each scoring,
with and without zones), the round tail's device phase at 1 to 8,192
pods alone and with quotas and zones, the device refunds up to 16,384
pods at G = 8 to 32, ``solve_stream_full`` with the dev carry against
the device golden, and with devices, quotas, a node mask and zones
together against the plain routes. Rounds and rollbacks of 32,768 pods,
and the 32,768-pod golden. The cost-transform route: the materialized
cost and flags at D = 1 to 16 with each term and a node mask, the
nomination over a given cost with non-finite entries, NaNs of both signs
and infeasible rows, both returning at once when ``done`` is set, and
``assign`` and ``solve_stream`` with a transform against their CPU runs.
Tolerance: none — the kernels round as the plain versions do, so results
must be bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from koordinator_tpu_torch import kernels
from koordinator_tpu_torch.ops import commit as tcommit
from koordinator_tpu_torch.ops import costs as tcosts
from koordinator_tpu_torch.ops import nominate as tnom
from koordinator_tpu_torch.ops import sequential as tseq
from koordinator_tpu_torch.ops import shortlist as tsl
from koordinator_tpu_torch.ops import solver as T
from koordinator_tpu_torch.ops.convert import from_numpy, to_numpy

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def nominate_inputs(seed, p, n, d):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 4000.0, 32_000.0, 96_000.0], (n, d), p=[0.05, 0.3, 0.35, 0.3])
    alloc = alloc.astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.8, (n, d))).astype(np.float32)
    req = rng.choice([0.0, 500.0, 1000.0, 4000.0], (p, d)).astype(np.float32)
    thr = np.where(rng.random((n, d)) < 0.6, rng.choice([50.0, 65.0, 95.0], (n, d)), 0.0)
    return [
        req,
        (req * np.float32(0.85)).astype(np.float32),
        rng.random(p) < 0.4,                      # is_prod
        rng.random(p) < 0.3,                      # cpu_bind
        rng.random(p) > 0.05,                     # gate
        alloc,
        (alloc * rng.uniform(0.0, 0.5, (n, d))).astype(np.float32),
        used,
        (used * np.float32(0.6)).astype(np.float32),
        rng.random(n) > 0.1,                      # fresh
        rng.random(n) > 0.05,                     # schedulable
        np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32),
        thr.astype(np.float32),
        np.where(rng.random((n, d)) < 0.3, 55.0, 0.0).astype(np.float32),
        rng.choice([1.0, 2.0], d).astype(np.float32),
    ]


@pytest.mark.parametrize(
    "p, n, d, k",
    [(1, 1, 1, 1), (3, 7, 2, 4), (37, 300, 3, 8), (512, 1000, 2, 4), (200, 5003, 2, 2),
     (5, 31, 1, 3), (65, 31, 8, 8), (130, 10_001, 2, 4), (512, 10_001, 3, 4),
     (64, 1, 2, 1), (70, 10_001, 8, 5), (33, 257, 16, 4)],
)
@pytest.mark.parametrize("jitter, approx", [(4.0, False), (4.0, True), (0.0, False)])
def test_nominate_kernel_matches_plain(cuda, p, n, d, k, jitter, approx):
    arrays = nominate_inputs(p * 7 + n, p, n, d)
    host = [torch.from_numpy(a) for a in arrays]
    dev = [t.to(cuda) for t in host]
    before = kernels.launches["nominate"]
    kc, ki = tnom.nominate(*dev, k, jitter, approx)
    torch.cuda.synchronize()
    assert kernels.launches["nominate"] == before + 1
    pc, pi = tnom.nominate_plain(*host, k, jitter, approx)
    np.testing.assert_array_equal(bits(kc.cpu().numpy()), bits(pc.numpy()))
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.numpy())


def round_inputs(seed, p, n, d, k=4):
    """A round tail's arguments (numpy, in ``round_tail``'s order): a
    nomination with tied costs, +inf tails and pods with no finite slot,
    inactive pods (some before the first active one, with finite slots: a
    negative rank), pods assigned earlier, near-threshold tables."""
    rng = np.random.default_rng(seed)
    cost = np.sort(rng.integers(-100, 0, (p, k)).astype(np.float32), axis=1)
    cost[np.arange(k)[None, :] >= rng.integers(0, k + 1, p)[:, None]] = np.inf
    idx = rng.integers(0, n, (p, k)).astype(np.int32)
    active = rng.random(p) > 0.1
    active[: min(3, p)] = False
    alloc = rng.choice([0.0, 32_000.0, 96_000.0], (n, d), p=[0.05, 0.5, 0.45]).astype(np.float32)
    used = (alloc * rng.uniform(0.0, 0.7, (n, d))).astype(np.float32)
    req = (rng.choice([500.0, 1000.0, 4000.0], (p, d)) * rng.uniform(0.9, 1.6, (p, 1)))
    req = req.astype(np.float32)
    return [
        cost, idx, req, (req * np.float32(0.85)).astype(np.float32),
        rng.random(p) < 0.4,                                   # is_prod
        rng.random(p) < 0.3,                                   # cpu_bind
        np.where(rng.random(n) < 0.3, 1.5, 1.0).astype(np.float32),
        alloc,
        rng.random(n) > 0.1,                                   # fresh
        np.where(rng.random((n, d)) < 0.7, 65.0, 0.0).astype(np.float32),
        np.where(rng.random((n, d)) < 0.5, 55.0, 0.0).astype(np.float32),
        (alloc * rng.uniform(0.0, 0.5, (n, d))).astype(np.float32),
        used,
        (used * np.float32(0.6)).astype(np.float32),
        np.where(active, -1, rng.integers(-1, n, p)).astype(np.int32),
        active,
        np.array([0, 3], np.int32),                            # (done, rounds)
    ]


def round_tail_both(cuda, arrays):
    """The kernel on the card and the plain version on the CPU, each on its
    own copy; returns the two lists of arguments after the call."""
    host = [torch.from_numpy(a.copy()) for a in arrays]
    dev = [torch.from_numpy(a.copy()).to(cuda) for a in arrays]
    before = kernels.launches["round_tail"]
    tcommit.round_tail(*dev, 0.35)
    torch.cuda.synchronize()
    assert kernels.launches["round_tail"] == before + 1
    tcommit.round_tail_plain(*host, 0.35)
    return dev, host


def assert_round_equal(dev, host):
    for i, (tk, tp) in enumerate(zip(dev, host)):
        np.testing.assert_array_equal(bits(tk.cpu().numpy()), bits(tp.numpy()), err_msg=str(i))


@pytest.mark.parametrize("p", [1, 5, 16, 17, 100, 512, 1000, 4100])
@pytest.mark.parametrize("d", [1, 2, 3])
def test_commit_kernel_matches_plain(cuda, p, d):
    """The round tail (the commit's successor) at rounds of 1 to 4,100
    pods."""
    dev, host = round_tail_both(cuda, round_inputs(p + d, p, max(3, p // 12), d))
    assert_round_equal(dev, host)


@pytest.mark.parametrize("p, n, d", [(512, 10_000, 2), (4096, 10_000, 2), (64, 40, 8),
                                     (512, 2, 2), (2048, 3, 1)])
def test_round_tail_kernel_matches_plain(cuda, p, n, d):
    """The main path's shapes, the JAX scheduler's batch bucket (4,096),
    D = 8, and hot nodes holding far more than 16 pods of a round."""
    arrays = round_inputs(p * 3 + d, p, n, d)
    dev, host = round_tail_both(cuda, arrays)
    assert_round_equal(dev, host)
    if n <= 3:
        _, key = tcommit._choose(*(torch.from_numpy(arrays[i]) for i in (0, 1, 15)), n)
        key = key.numpy()
        assert np.bincount(key[key < n]).max() > 16
        assert (host[14].numpy() != arrays[14]).any()


def test_round_loop_trips_after_done_change_nothing(cuda):
    """A trip after the fixed point — nomination and round tail with
    ``done`` set — leaves every tensor as it was."""
    arrays = round_inputs(5, 512, 1000, 2)
    arrays[16] = np.array([1, 4], np.int32)
    dev = [torch.from_numpy(a.copy()).to(cuda) for a in arrays]
    nom = [torch.from_numpy(a).to(cuda) for a in nominate_inputs(5, 512, 1000, 2)]
    before = [t.clone() for t in dev + nom]
    tnom.nominate(*nom, 4, 4.0, True, state=dev[16])
    tcommit.round_tail(*dev, 0.35)
    torch.cuda.synchronize()
    for a, b in zip(dev + nom, before):
        assert torch.equal(a, b)


def test_round_tail_refuses_misaligned_rows(cuda):
    """Node rows move as float2 at D = 2: a table 4 bytes off that is
    refused, not read."""
    dev = [torch.from_numpy(a).to(cuda) for a in round_inputs(2, 64, 40, 2)]
    shifted = torch.empty(dev[11].numel() + 1, device=cuda)[1:].view(dev[11].shape)
    shifted.copy_(dev[11])
    dev[11] = shifted
    with pytest.raises(RuntimeError, match="round_tail: CUDA error"):
        tcommit.round_tail(*dev, 0.35)


def test_commit_refuses_a_round_too_large_for_one_block(cuda):
    """One block takes up to 131,072 pods (128 rows a thread in device
    memory); a larger round is refused, never solved some other way."""
    dev = [torch.from_numpy(a).to(cuda) for a in round_inputs(1, 131_073, 100, 8)]
    with pytest.raises(ValueError, match="131072"):
        tcommit.round_tail(*dev, 0.35)


def gang_inputs(seed, p, n, d, kind):
    """A solved batch (numpy result fields, PodBatch fields) for one kind
    of rollback."""
    rng = np.random.default_rng(seed)
    assignment = np.where(rng.random(p) < 0.85, rng.integers(0, n, p), -1)
    if kind == "one node":
        assignment = np.where(assignment >= 0, n // 2, -1)
    if kind == "sink row":
        assignment = np.where(rng.random(p) < 0.5, n - 1, assignment)
    gangs = max(1, min(p, 8))
    gang_id = np.where(rng.random(p) < 0.6, rng.integers(0, gangs, p), -1)
    if kind == "no gangs":
        gang_id[:] = -1
    gang_min = np.zeros(p, np.int32)
    gang_min[:gangs] = rng.integers(1, 1 + max(2, p // 16), gangs)
    if kind != "nonstrict":
        gang_min[:gangs] = p + 1  # every gang short of its minMember
    nonstrict = np.zeros(p, bool)
    if kind == "nonstrict":
        nonstrict[:gangs] = rng.random(gangs) < 0.5
    req = (rng.uniform(100, 5000, (p, d)) * np.float32(0.85)).astype(np.float32)
    pods = dict(
        requests=req, estimate=(req * np.float32(0.7)).astype(np.float32),
        priority=rng.integers(5000, 9999, p).astype(np.int32),
        is_prod=rng.random(p) < 0.4, gang_id=gang_id.astype(np.int32),
        gang_min=gang_min, gang_nonstrict=nonstrict,
    )
    result = dict(
        assignment=assignment.astype(np.int32),
        **{f: rng.uniform(1e4, 1e5, (n, d)).astype(np.float32)
           for f in ("node_requested", "node_estimated_used", "node_prod_used")},
    )
    return result, pods


def solve_result(result, device):
    p, d = len(result["assignment"]), result["node_requested"].shape[1]
    return T.SolveResult(
        quota_used=torch.zeros((1, d), device=device),
        rounds_used=torch.tensor(1, dtype=torch.int32, device=device),
        pod_zone=torch.full((p,), -1, dtype=torch.int32, device=device),
        **{k: torch.from_numpy(v.copy()).to(device) for k, v in result.items()},
    )


@pytest.mark.parametrize("kind", ["no gangs", "all short", "nonstrict", "one node", "sink row"])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("p", [1, 17, 512, 1000])
def test_enforce_gangs_kernel_matches_plain(cuda, p, d, kind):
    n = max(2, p // 4)
    result, pods = gang_inputs(p * 10 + d, p, n, d, kind)
    got = solve_result(result, cuda)
    before = kernels.launches["enforce_gangs"]
    T._enforce_gangs_(got, from_numpy(T.PodBatch, device=cuda, **pods))
    torch.cuda.synchronize()
    assert kernels.launches["enforce_gangs"] == before + 1
    want = T.enforce_gangs_plain(solve_result(result, "cpu"), from_numpy(T.PodBatch, device="cpu", **pods))
    for f in ("assignment", "pod_zone", "node_requested", "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(getattr(got, f).cpu().numpy()),
                                      bits(getattr(want, f).numpy()), err_msg=f)
    rolled = (result["assignment"] >= 0) & (want.assignment.numpy() < 0)
    if kind != "no gangs" and kind != "nonstrict" and p >= 17:
        assert rolled.any()
    if kind == "no gangs":
        assert not rolled.any()


def test_enforce_gangs_refuses_a_batch_too_large_for_one_block(cuda):
    """A batch too large for one block's shared memory (20,000 pods) is no
    longer refused: its working set goes to device memory, and the result
    equals the plain version's."""
    result, pods = gang_inputs(1, 20_000, 100, 2, "all short")
    got = solve_result(result, cuda)
    before = kernels.launches["enforce_gangs_big"]
    T._enforce_gangs_(got, from_numpy(T.PodBatch, device=cuda, **pods))
    torch.cuda.synchronize()
    assert kernels.launches["enforce_gangs_big"] == before + 1
    want = T.enforce_gangs_plain(solve_result(result, "cpu"),
                                 from_numpy(T.PodBatch, device="cpu", **pods))
    for f in ("assignment", "pod_zone", "node_requested", "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(getattr(got, f).cpu().numpy()),
                                      bits(getattr(want, f).numpy()), err_msg=f)


@pytest.mark.parametrize("approx", [False, True])
def test_assign_on_card_matches_cpu(cuda, approx):
    """The whole round solver through the kernels equals its CPU run,
    with gangs, cpuset-bound pods and padded pods."""
    rng = np.random.default_rng(11)
    p, n = 256, 40
    alloc = (rng.choice([8000.0, 32_000.0], (n, 1)) * np.array([1.0, 4.0])).astype(np.float32)
    used = (alloc * rng.uniform(0.05, 0.6, (n, 1))).astype(np.float32)
    nodes = dict(
        allocatable=alloc, estimated_used=used, prod_used=(used * np.float32(0.6)),
        metric_fresh=rng.random(n) > 0.1,
        cpu_amp=np.where(rng.random(n) < 0.4, 1.5, 1.0).astype(np.float32),
    )
    cpu = rng.choice([500.0, 1000.0, 2000.0, 4000.0], p)
    req = np.stack([cpu, cpu * 4], 1).astype(np.float32)
    gmin = np.zeros(p, np.int32)
    gmin[:6] = rng.integers(2, 16, 6)
    pods = dict(
        requests=req, estimate=(req * np.float32(0.85)),
        priority=rng.integers(5000, 9999, p).astype(np.int32),
        qos=rng.choice([0, 3], p).astype(np.int8), valid=rng.random(p) > 0.05,
        gang_id=np.where(rng.random(p) < 0.4, rng.integers(0, 6, p), -1).astype(np.int32),
        gang_min=gmin, gang_nonstrict=np.arange(p) == 1,
    )
    params = dict(
        usage_thresholds=np.array([65.0, 95.0], np.float32),
        prod_thresholds=np.array([55.0, 0.0], np.float32),
        score_weights=np.ones(2, np.float32),
    )

    def run(device):
        return to_numpy(T.assign(
            from_numpy(T.PodBatch, device=device, **pods),
            from_numpy(T.NodeState, device=device, **nodes),
            from_numpy(T.SolverParams, device=device, **params),
            max_rounds=12, approx_topk=approx,
        ))

    kernels.reset_launches()
    got = run(cuda)
    assert min(kernels.launches[k] for k in ("nominate", "round_tail", "enforce_gangs")) > 0
    assert kernels.launches["round_tail"] == 12  # max_rounds trips, no host read
    want = run("cpu")
    for f in ("assignment", "rounds_used", "node_requested",
              "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(got[f]), bits(want[f]), err_msg=f)


def test_stream_graph_matches_eager_plain_and_golden(cuda):
    """``solve_stream`` as one CUDA graph replay a batch equals the eager
    run through the plain versions and the JAX package's golden result;
    a second call reuses the graph and reads nothing back to the host."""
    gold = np.load(chip_smoke.GOLDEN)
    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    args = (
        from_numpy(T.PodBatch, device=cuda, **chip_smoke.stacked(pods)),
        from_numpy(T.NodeState, device=cuda, **nodes),
        from_numpy(T.SolverParams, device=cuda, **params),
    )
    b = gold["assignments"].shape[0]
    rounds = torch.zeros(b, dtype=torch.int32, device=cuda)
    asg, final, placed, _ = T.solve_stream(*args, **chip_smoke.SOLVE, rounds_out=rounds)
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = T.solve_stream(*args, **chip_smoke.SOLVE)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    trips = b * chip_smoke.SOLVE["max_rounds"]
    assert kernels.replays["solve_stream"] == b and not kernels.captured
    assert dict(kernels.launches) == {"nominate": trips, "round_tail": trips, "enforce_gangs": b,
                                      "batch_setup": b, "batch_teardown": b,
                                      "batch_outputs": b}
    plain_rounds = torch.zeros(b, dtype=torch.int32, device=cuda)
    with chip_smoke.plain_versions():
        p_asg, p_final, p_placed, _ = T.solve_stream(
            *args, **chip_smoke.SOLVE, cuda_graph=False, rounds_out=plain_rounds
        )
    np.testing.assert_array_equal(asg.cpu().numpy(), gold["assignments"])
    for out in (again, (p_asg, p_final, p_placed, None)):
        np.testing.assert_array_equal(asg.cpu().numpy(), out[0].cpu().numpy())
        np.testing.assert_array_equal(placed.cpu().numpy(), out[2].cpu().numpy())
    np.testing.assert_array_equal(rounds.cpu().numpy(), plain_rounds.cpu().numpy())
    assert 0 < rounds.min() and rounds.max() <= chip_smoke.SOLVE["max_rounds"]
    for f in ("requested", "estimated_used", "prod_used"):
        want = bits(gold[f])
        for got in (final, again[1], p_final):
            np.testing.assert_array_equal(bits(getattr(got, f).cpu().numpy()), want, err_msg=f)


def shortlist_inputs(seed, p, n, d):
    """``nominate_inputs`` without the gate: the build's arguments."""
    arrays = nominate_inputs(seed, p, n, d)
    return arrays[:4] + arrays[5:]


@pytest.mark.parametrize(
    "p, n, d, k",
    [(1, 2, 1, 1), (3, 70, 2, 8), (37, 300, 3, 64), (512, 10_000, 2, 64), (5, 65, 2, 64),
     (64, 1000, 8, 200), (16, 60_000, 2, 64), (130, 10_001, 2, 1)],
)
@pytest.mark.parametrize("jitter", [4.0, 0.0])
def test_shortlist_build_kernel_matches_plain(cuda, p, n, d, k, jitter):
    host = [torch.from_numpy(a) for a in shortlist_inputs(p * 5 + n, p, n, d)]
    dev = [t.to(cuda) for t in host]
    before = kernels.launches["shortlist_build"]
    kc, kb = tsl.shortlist_build(*dev, k, jitter)
    torch.cuda.synchronize()
    assert kernels.launches["shortlist_build"] == before + 1
    pc, pb = tsl.shortlist_build_plain(*host, k, jitter)
    np.testing.assert_array_equal(kc.cpu().numpy(), pc.numpy())
    np.testing.assert_array_equal(bits(kb.cpu().numpy()), bits(pb.numpy()))


#: the build's edge cases: (pods, nodes, K, zones, devices)
BUILD_EDGES = {
    "K=1024": (24, 3000, 1024, False, False),
    "N=K+1 at K=1024": (7, 1025, 1024, False, False),
    "N=K+1 at K=64": (5, 65, 64, False, False),
    "512 pods over 60,000 nodes": (512, 60_000, 64, False, False),
    "infeasible and masked rows": (96, 5000, 64, False, False),
    "zones": (64, 60_000, 64, True, False),
    "devices": (64, 60_000, 64, False, True),
    "zones and devices, masked": (64, 20_000, 64, True, True),
}


@pytest.mark.parametrize("case", list(BUILD_EDGES))
@pytest.mark.parametrize("jitter", [4.0, 0.0])
def test_shortlist_build_kernel_edge_cases_match_plain(cuda, case, jitter):
    """The build's edges against its plain version: K = 1,024 (a chunk's
    list holds every node of it), N = K + 1, 512 pods over 60,000 nodes,
    rows with no feasible pair (requests no node holds: the bound +inf,
    the lowest ids) and all-false node-mask rows, and the NUMA and device
    instantiations (LeastAllocated, the device score clamped), the jitter
    on and off (ties of integer scores, every zero cost -0)."""
    p, n, k, zones, devs = BUILD_EDGES[case]
    arrays, numa, required = zone_inputs(p * 7 + n + k, p, n, 2, 2)
    arrays = arrays[:4] + arrays[5:]
    masked = "masked" in case
    if "infeasible" in case:
        arrays[0][::5] = 1e9
        masked = True
    devices, demand = device_demand(p + n, p, n, 16, True)
    rng = np.random.default_rng(p + n)
    table = rng.random((3, n)) < 0.5
    table[1] = False
    rows = rng.integers(0, 3, p).astype(np.int64)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        kw = {}
        if masked:
            kw["mask"] = (torch.from_numpy(table).to(device), torch.from_numpy(rows).to(device))
        if zones:
            kw["zones"] = tnuma.ZoneTerms.batch_start(
                torch.from_numpy(numa["zone_free"]).to(device),
                torch.from_numpy(numa["zone_cap"]).to(device),
                torch.from_numpy(numa["policy"]).to(device),
                torch.from_numpy(required).to(device), 1)
        if devs:
            kw["devices"] = device_terms(devices, demand, device, 1)
        before = kernels.launches["shortlist_build"]
        outs.append([t.cpu() for t in tsl.shortlist_build(*args, k, jitter, **kw)])
        if device == cuda:
            assert kernels.launches["shortlist_build"] == before + 1
    torch.cuda.synchronize()
    (kc, kb), (pc, pb) = outs
    np.testing.assert_array_equal(kc.numpy(), pc.numpy())
    np.testing.assert_array_equal(bits(kb.numpy()), bits(pb.numpy()))
    if masked:
        assert np.isinf(pb.numpy()).any()


def round_both(cuda, arrays, plan, k, approx, done=False, bound=None):
    """The shortlist round on the card and its plain version on the CPU;
    returns ((cost, node, word, counts) kernel, the same plain)."""
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        cand, b = (t.to(device) for t in plan)
        if bound is not None:
            b = bound(b)
        word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
        counts = torch.tensor([2, 3], dtype=torch.int32, device=device)
        state = torch.tensor([int(done), 1], dtype=torch.int32, device=device)
        top = tsl.shortlist_round(*args, cand, b, k, 4.0, approx, word, counts, state)
        outs.append((*top, word[:3], counts))
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("bound", ["plan", "lowered", "unbounded", "done"])
@pytest.mark.parametrize(
    "p, n, d, sk, k, approx",
    [(1, 9, 1, 8, 1, False), (37, 300, 3, 64, 4, True), (512, 10_000, 2, 64, 4, True),
     (100, 1000, 2, 70, 8, False), (64, 500, 8, 4, 4, False)],
)
def test_shortlist_round_kernel_matches_plain(cuda, p, n, d, sk, k, approx, bound):
    arrays = nominate_inputs(p * 3 + n, p, n, d)
    plan = tsl.shortlist_build_plain(
        *[torch.from_numpy(a) for a in arrays[:4] + arrays[5:]], sk, 4.0
    )
    change = {
        "plan": None, "done": None,
        "lowered": lambda b: b - 200.0,
        "unbounded": lambda b: torch.where(torch.arange(b.shape[0], device=b.device) % 2 == 0,
                                           torch.inf, b),
    }[bound]
    before = kernels.launches["shortlist_round"]
    (kc, ki, kw, kn), (pc, pi, pw, pn) = round_both(
        cuda, arrays, plan, k, approx, done=bound == "done", bound=change
    )
    assert kernels.launches["shortlist_round"] == before + 1
    np.testing.assert_array_equal(kw.cpu().numpy(), pw.numpy())
    np.testing.assert_array_equal(kn.cpu().numpy(), pn.numpy())
    if bound == "done":
        assert not pw.any() and pn.tolist() == [2, 3]
        return
    np.testing.assert_array_equal(bits(kc.cpu().numpy()), bits(pc.numpy()))
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.numpy())
    if bound == "lowered" and p > 1:
        assert pw[0] == 1


#: the shortlist round's geometry cases: (pods, nodes, K) — pods off the
#: block's four, K = 64 (a candidate a lane of two warps), K below 32
#: (lanes and a whole warp with no candidate) and K = 96 (two a lane)
ROUND_GEOMETRY = [(37, 3000, 64), (510, 10_000, 64), (13, 2000, 20), (130, 4000, 31),
                  (6, 500, 8), (21, 1000, 96)]


def shortlist_round_terms(p, n, terms, device, numa, required, devices, demand):
    kw = {}
    if terms in ("zones", "both"):
        kw["zones"] = tnuma.ZoneTerms.batch_start(
            torch.from_numpy(numa["zone_free"]).to(device),
            torch.from_numpy(numa["zone_cap"]).to(device),
            torch.from_numpy(numa["policy"]).to(device),
            torch.from_numpy(required).to(device), 1)
    if terms in ("devices", "both"):
        kw["devices"] = device_terms(devices, demand, device, 1)
    return kw


@pytest.mark.parametrize("terms", ["plain", "zones", "devices", "both"])
@pytest.mark.parametrize("p, n, sk", ROUND_GEOMETRY)
def test_shortlist_round_geometry_matches_plain(cuda, terms, p, n, sk):
    """The shortlist round's geometry (two warps a pod, four pods a block,
    the warps' lists merged) at k = 1..8: pods off the block's four, K = 64,
    K below 32 and above 64, with zones, devices and both; half the pods'
    bounds lowered so that the round falls back: nomination, word and
    counts equal the plain version's."""
    arrays, numa, required = zone_inputs(p * 5 + n + sk, p, n, 2, 2)
    devices, demand = device_demand(p + n + 1, p, n, 16, True)
    cpu_kw = shortlist_round_terms(p, n, terms, "cpu", numa, required, devices, demand)
    cand, bound = tsl.shortlist_build_plain(
        *[torch.from_numpy(a) for a in arrays[:4] + arrays[5:]], sk, 4.0, **cpu_kw)
    bound = torch.where(torch.arange(p) % 2 == 0, bound - 200.0, bound)
    for k in range(1, min(8, sk) + 1):
        outs = []
        for device in (cuda, "cpu"):
            args = [torch.from_numpy(a).to(device) for a in arrays]
            kw = shortlist_round_terms(p, n, terms, device, numa, required, devices, demand)
            word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
            counts = torch.tensor([2, 3], dtype=torch.int32, device=device)
            state = torch.zeros(2, dtype=torch.int32, device=device)
            top = tsl.shortlist_round(*args, cand.to(device), bound.to(device), k, 4.0, k % 2 == 0,
                                      word, counts, state, **kw)
            outs.append([t.cpu() for t in (*top, word[:3], counts)])
        torch.cuda.synchronize()
        for name, a, b in zip(("cost", "node", "word", "counts"), *outs):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()), err_msg=f"k={k} {name}")


@pytest.mark.parametrize("terms", ["plain", "zones", "devices", "both"])
def test_shortlist_round_counts_over_rounds_match_plain(cuda, terms):
    """A sequence of rounds, each with its own word and the batch's counts
    (the solver's use): rounds that fall back with a finite candidate, with
    none (requests no candidate holds), both, and none at all, then a round
    after the fixed point; after each round the word and the counts equal
    the plain version's, and each count is the rounds with its flag."""
    p, n, sk = 77, 3000, 64
    arrays, numa, required = zone_inputs(p + n, p, n, 2, 2)
    devices, demand = device_demand(p + n + 2, p, n, 16, True)
    cpu_kw = shortlist_round_terms(p, n, terms, "cpu", numa, required, devices, demand)
    cand, bound = tsl.shortlist_build_plain(
        *[torch.from_numpy(a) for a in arrays[:4] + arrays[5:]], sk, 4.0, **cpu_kw)
    odd = torch.arange(p) % 2 == 1
    rounds = [(bound, False), (bound - 500.0, False), (bound, True),
              (torch.where(odd, bound - 500.0, bound), True), (bound - 500.0, False)]
    sides = []
    for device in (cuda, "cpu"):
        kw = shortlist_round_terms(p, n, terms, device, numa, required, devices, demand)
        sides.append(dict(kw=kw, counts=torch.zeros(2, dtype=torch.int32, device=device),
                          state=torch.zeros(2, dtype=torch.int32, device=device)))
    seen = []
    for r, (b, starve) in enumerate(rounds + [(bound, False)]):
        got = []
        for device, side in zip((cuda, "cpu"), sides):
            a = [x.copy() for x in arrays]
            if starve:  # every even pod asks for more than any node holds
                a[0][::2] = 1e9
            args = [torch.from_numpy(x).to(device) for x in a]
            if r == len(rounds):
                side["state"][0] = 1  # after the fixed point: nothing counted
            word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
            tsl.shortlist_round(*args, cand.to(device), b.to(device), 4, 4.0, True, word,
                                side["counts"], side["state"], **side["kw"])
            got.append((word[:3].cpu(), side["counts"].cpu().clone()))
        torch.cuda.synchronize()
        (wk, ck), (wp, cp) = got
        np.testing.assert_array_equal(wk.numpy(), wp.numpy(), err_msg=f"round {r} word")
        np.testing.assert_array_equal(ck.numpy(), cp.numpy(), err_msg=f"round {r} counts")
        seen.append(got[1][0].tolist())
    counts = sides[1]["counts"].tolist()
    assert counts == [sum(w[1] for w in seen), sum(w[2] for w in seen)]
    assert min(counts) > 0 and seen[-1] == [0, 0, 0]


def test_shortlist_fallback_fires_on_card(cuda):
    """The contention fixture's rounds fall back on the card, as on the
    CPU, with the same decisions and counts."""
    nodes, pods, params = chip_smoke.contention_fixture()

    def run(device):
        return to_numpy(T.assign(
            from_numpy(T.PodBatch, device=device, **pods),
            from_numpy(T.NodeState, device=device, **nodes),
            from_numpy(T.SolverParams, device=device, **params),
            shortlist_k=chip_smoke.CONTENTION_K,
        ))

    kernels.reset_launches()
    got = run(cuda)
    assert kernels.launches["shortlist_build"] == 1 and kernels.launches["shortlist_round"] == 24
    want = run("cpu")
    assert (want["shortlist_fallbacks"] > 0).all()
    for f in ("assignment", "rounds_used", "shortlist_fallbacks", "node_requested",
              "node_estimated_used", "node_prod_used"):
        np.testing.assert_array_equal(bits(got[f]), bits(want[f]), err_msg=f)


def test_shortlist_stream_equals_full_stream_and_golden(cuda):
    """The shortlist stream through the graph decides what the stream
    without it decides, and reproduces the JAX package's shortlist golden;
    a second call replays with no host sync."""
    assert chip_smoke.shortlist_golden_mismatches(torch, cuda) == []
    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(
        torch, nodes, chip_smoke.stacked(pods), params, cuda
    )
    args = (pods_t, nodes_t, params_t)
    full = T.solve_stream(*args, **chip_smoke.SOLVE)
    kw = dict(chip_smoke.SOLVE, shortlist_k=chip_smoke.SHORTLIST_K)
    T.solve_stream(*args, **kw)  # captures the shortlist stream's graph
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = T.solve_stream(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b = chip_smoke.GOLDEN_PODS // chip_smoke.BATCH
    assert not kernels.captured and kernels.launches["shortlist_build"] == b
    np.testing.assert_array_equal(full[0].cpu().numpy(), again[0].cpu().numpy())
    for f in ("requested", "estimated_used", "prod_used"):
        np.testing.assert_array_equal(bits(getattr(full[1], f).cpu().numpy()),
                                      bits(getattr(again[1], f).cpu().numpy()), err_msg=f)


def test_two_cycles_replay_one_graph_on_resident_rows(cuda):
    out = chip_smoke.two_cycles(torch, cuda, 2000, 2)
    assert out["mismatches"] == [], out["mismatches"]
    assert out["replayed"] and out["same_ptrs"]


# ------------------------------------------- quotas and the node mask (slice 5)

from koordinator_tpu_torch.ops import quota as tquota  # noqa: E402


def quota_inputs(seed, p, q, d, levels=4, fill=0.85):
    """Chains over a [Q, D] tree (some levels open) whose runtime binds
    with ``fill`` of it used: (chain [P, L], runtime, used) numpy."""
    rng = np.random.default_rng(seed)
    chain = rng.integers(0, q, (p, levels)).astype(np.int32)
    chain[rng.random((p, levels)) < 0.15] = -1
    runtime = rng.uniform(1e3, 1e4 * max(1, p // max(1, q)), (q, d)).astype(np.float32)
    runtime[rng.random(q) < 0.05] = np.inf
    used = (np.where(np.isinf(runtime), 1e4, runtime)
            * rng.uniform(0.0, fill, (q, d))).astype(np.float32)
    return chain, runtime, used


@pytest.mark.parametrize("p", [1, 37, 512, 4096])
@pytest.mark.parametrize("q, d", [(21, 2), (1057, 2), (5, 3), (8, 1)])
def test_quota_gate_kernel_matches_plain(cuda, p, q, d):
    rng = np.random.default_rng(p + q)
    chain, runtime, used = quota_inputs(p * 7 + q, p, q, d)
    arrays = [rng.random(p) > 0.1, rng.uniform(100, 5000, (p, d)).astype(np.float32), chain,
              runtime, used]
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        gate = torch.zeros(p, dtype=torch.bool, device=device)
        tquota.quota_gate(*args, gate)
        outs.append(gate.cpu())
    torch.cuda.synchronize()
    assert torch.equal(*outs)


def quota_round_both(cuda, arrays, quota):
    """The round tail with quotas on the card and its plain version on
    the CPU; returns both argument lists with (used, gate) appended."""
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        chain, runtime, used = (torch.from_numpy(a.copy()).to(device) for a in quota)
        gate = torch.zeros(len(arrays[2]), dtype=torch.bool, device=device)
        fn = tcommit.round_tail if device == cuda else tcommit.round_tail_plain
        fn(*args, 0.35, quota=(chain, runtime, used, gate))
        outs.append(args + [used, gate])
    torch.cuda.synchronize()
    return outs


@pytest.mark.parametrize("p", [1, 16, 17, 300, 512, 1000, 4096])
@pytest.mark.parametrize("q, d", [(21, 2), (512, 2), (513, 2), (1057, 2), (7, 3), (300, 1)])
def test_round_tail_quota_commit_matches_plain(cuda, p, q, d):
    """Both of ``_quota_commit``'s branches (Q·D <= 1,024 one-hot, above
    sorted; 512 x 2 and 513 x 2 on either side) at rounds of 1 to 4,096
    pods: one to three scan levels, one and four rows a thread."""
    arrays = round_inputs(p * 11 + q, p, max(3, p // 8), d)
    arrays[16] = np.array([0, 2], np.int32)
    chain, runtime, used = quota_inputs(p + q * 3, p, q, d)
    before = dict(kernels.launches)
    dev, host = quota_round_both(cuda, arrays, (chain, runtime, used))
    branch = "quota_commit_onehot" if q * d <= 1024 else "quota_commit_sorted"
    assert kernels.launches[branch] == before.get(branch, 0) + 1
    assert_round_equal(dev[11:], host[11:])


def test_round_tail_quota_refuses_more_than_4096_pods(cuda):
    """A quota round of more than 4,096 pods (the JAX scheduler's batch
    bucket) is no longer refused: it runs in the device-memory round tail
    and equals the plain version."""
    arrays = round_inputs(4, 4097, 100, 2)
    arrays[16] = np.array([0, 2], np.int32)
    before = kernels.launches["round_tail_big"]
    dev, host = quota_round_both(cuda, arrays, quota_inputs(4, 4097, 21, 2))
    assert kernels.launches["round_tail_big"] == before + 1
    assert_round_equal(dev[11:], host[11:])


def test_round_tail_quota_refusing_every_pod_ends_the_loop(cuda):
    """Every node-accepted pod refused by its quota: nothing assigned, the
    loop's done set after one round, the gate closed."""
    arrays = round_inputs(3, 64, 20, 2)
    arrays[15][:] = True
    arrays[14][:] = -1
    chain = np.zeros((64, 2), np.int32)
    chain[:, 1] = -1
    runtime = np.full((1, 2), 10.0, np.float32)
    dev, host = quota_round_both(cuda, arrays, (chain, runtime, np.zeros((1, 2), np.float32)))
    assert_round_equal(dev[11:], host[11:])
    assert (host[14].numpy() == -1).all() and host[16].tolist() == [1, 4]
    assert not host[-1].any()


@pytest.mark.parametrize("q", [1, 21, 600])
@pytest.mark.parametrize("p, d", [(17, 1), (512, 2), (1000, 3)])
def test_enforce_gangs_quota_refund_matches_plain(cuda, p, d, q):
    n = max(2, p // 4)
    result, pods = gang_inputs(p * 13 + q, p, n, d, "all short")
    chain, _, used = quota_inputs(p + q, p, q, d, fill=1.0)
    pods["quota_chain"] = chain
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        got.quota_used = torch.from_numpy(np.where(np.isinf(used), 1e6, used).astype(np.float32)
                                          ).to(device)
        before = kernels.launches["quota_refund"]
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods))
        if device == cuda:
            assert kernels.launches["quota_refund"] == before + (q > 1)
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
              "quota_used"):
        np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                      bits(getattr(outs[1], f).numpy()), err_msg=f)


def masked_inputs(seed, p, n, d, rows=None):
    """``nominate_inputs`` and a node mask (table [M, N], rows [P]): some
    rows all false, a stacked table read through offset rows."""
    arrays = nominate_inputs(seed, p, n, d)
    rng = np.random.default_rng(seed + 1)
    m = 3 * p
    table = rng.random((m, n)) < 0.4
    table[:: max(1, m // 7)] = False
    order = rng.permutation(p) + (p if rows is None else rows * p)
    return arrays, table, order.astype(np.int64)


@pytest.mark.parametrize("p, n, d", [(1, 9, 1), (37, 300, 3), (512, 10_000, 2), (200, 5003, 2)])
@pytest.mark.parametrize("approx", [False, True])
def test_pricing_kernels_with_node_mask_match_plain(cuda, p, n, d, approx):
    arrays, table, rows = masked_inputs(p * 3 + n, p, n, d)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        mask = (torch.from_numpy(table).to(device), torch.from_numpy(rows).to(device))
        nom = tnom.nominate(*args, min(4, n), 4.0, approx, mask=mask)
        build_args = args[:4] + args[5:]
        k = min(64, n - 1)
        plan = tsl.shortlist_build(*build_args, k, 4.0, mask)
        word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
        counts = torch.zeros(2, dtype=torch.int32, device=device)
        state = torch.zeros(2, dtype=torch.int32, device=device)
        top = tsl.shortlist_round(*args, *plan, min(4, k), 4.0, approx, word, counts, state, mask)
        outs.append([t.cpu() for t in (*nom, *plan, *top, word[:3], counts)])
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()), err_msg=str(i))
    empty = ~table[rows].any(axis=1)
    assert np.isinf(outs[1][0].numpy()[empty]).all() and np.isinf(outs[1][3].numpy()[empty]).all()


def test_quota_stream_full_on_card_matches_plain_and_golden(cuda):
    """``solve_stream_full`` with quotas and the node mask, one graph replay
    a chunk, equals the eager plain route and the quota golden, for both
    trees, with the shortlist and without; no host sync on a replay."""
    gold = np.load(chip_smoke.GOLDEN_QUOTA)
    fixture = chip_smoke.rich_fixture(chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES,
                                      chip_smoke.GOLDEN_PODS)
    for tree in chip_smoke.QUOTA_TREES:
        pods_t, nodes_t, params_t, quotas, mask = chip_smoke.quota_port_inputs(
            torch, tree, fixture, cuda)
        for k in (chip_smoke.SHORTLIST_K, None):
            kw = dict(chip_smoke.SOLVE, quotas=quotas, node_mask=mask, shortlist_k=k)
            first = T.solve_stream_full(pods_t, nodes_t, params_t, **kw)
            kernels.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = T.solve_stream_full(pods_t, nodes_t, params_t, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert kernels.replays["solve_stream"] == 2 and kernels.launches["quota_gate"] == 2
            with chip_smoke.plain_versions():
                plain = T.solve_stream_full(pods_t, nodes_t, params_t, cuda_graph=False, **kw)
            key = f"{tree}_k{k or 0}"
            for out in (first, again, plain):
                np.testing.assert_array_equal(out[0].cpu().numpy(), gold[f"{key}_assignments"])
                np.testing.assert_array_equal(out[2].cpu().numpy(), gold[f"{key}_rounds"])
                np.testing.assert_array_equal(out[3].cpu().numpy(), gold[f"{key}_fallbacks"])


# ---------------------------------------- rounds above 4,096 pods and NUMA zones

from koordinator_tpu_torch.ops import numa as tnuma  # noqa: E402


def with_side(zone):
    """A round tail's zone tuple with the nodes' side table (``zone_prep``),
    which the kernel reads for the capacities and policies."""
    return tuple(zone) + (tnuma.zone_prep(zone[0], zone[1], zone[2])[1],)


@pytest.mark.parametrize("p", [4097, 8192, 16_384])
@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("q", [0, 21, 1057, 300_000])
def test_round_tail_above_4096_pods_matches_plain(cuda, p, d, q):
    """Rounds of up to 16,384 pods at D = 1, 4 and 8, without quotas and
    with the one-hot, sorted and 64-bit-key trees (Q = 300,000 overflows a
    32-bit level key at any P), in the device-memory round tail (or, at
    D = 1 without quotas, shared memory's 16-row kernel)."""
    arrays = round_inputs(p + d + q, p, max(3, p // 16), d)
    arrays[16] = np.array([0, 2], np.int32)
    if q == 0:
        dev, host = round_tail_both(cuda, arrays)
        assert_round_equal(dev, host)
        return
    before = kernels.launches["round_tail_big"]
    dev, host = quota_round_both(cuda, arrays, quota_inputs(p * 5 + q, p, q, d))
    assert kernels.launches["round_tail_big"] == before + 1
    assert_round_equal(dev[11:], host[11:])


@pytest.mark.parametrize("q", [1, 21, 1057])
@pytest.mark.parametrize("p", [8192, 16_384])
def test_enforce_gangs_above_4096_pods_matches_plain(cuda, p, q):
    n = p // 8
    result, pods = gang_inputs(p + q, p, n, 4, "all short")
    pods["quota_chain"] = quota_inputs(p + q, p, q, 4, fill=1.0)[0]
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        got.quota_used = torch.full((q, 4), 1e6, device=device)
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods))
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
              "quota_used"):
        np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                      bits(getattr(outs[1], f).numpy()), err_msg=f)


@pytest.mark.parametrize("quota", [False, True])
def test_bigbatch_golden_on_card(cuda, quota):
    """``assign`` on the 8,192-pod batch (D = 4, a Strict gang of 6,000
    that rolls back) equals the JAX package's golden bit for bit."""
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH)
    pods_t, nodes_t, params_t, quotas = chip_smoke.big_port_inputs(
        torch, chip_smoke.BIG_PODS, quota, cuda)
    res = to_numpy(T.assign(pods_t, nodes_t, params_t, quotas=quotas, **chip_smoke.SOLVE))
    key = "quota" if quota else "plain"
    for f, g in (("assignment", "assignment"), ("rounds_used", "rounds"),
                 ("node_requested", "requested"), ("node_estimated_used", "estimated_used"),
                 ("node_prod_used", "prod_used")) + ((("quota_used", "quota_used"),) if quota
                                                    else ()):
        np.testing.assert_array_equal(bits(res[f]), bits(gold[f"{key}_{g}"]), err_msg=f)


def zone_inputs(seed, p, n, d, zones):
    """``nominate_inputs`` and zone tables over its nodes
    (``chip_smoke.zone_tables`` cut to ``zones`` zones, DN = min(2, D)):
    (arrays, numa dict, required [P])."""
    arrays = nominate_inputs(seed, p, n, d)
    nodes = dict(allocatable=np.pad(arrays[5], ((0, 0), (0, max(0, 2 - d)))),
                 estimated_used=np.pad(arrays[7], ((0, 0), (0, max(0, 2 - d)))))
    _, numa, required = chip_smoke.zone_tables(seed, nodes, p)
    dn = min(2, d)
    for k in ("zone_free", "zone_cap"):
        numa[k] = np.ascontiguousarray(numa[k][:, :zones, :dn])
    return arrays, numa, required


@pytest.mark.parametrize("n", [1, 9, 257, 10_000])
@pytest.mark.parametrize("zones, dn", [(1, 1), (2, 2), (4, 2), (8, 4)])
def test_zone_prep_kernel_matches_plain(cuda, n, zones, dn):
    """The batch-start snapshot and side table (``csrc/zone_prep.cu``)
    against ``zone_prep_plain``: zone tables with padded zones, nodes
    without zones and every policy."""
    rng = np.random.default_rng(n + zones * 10 + dn)
    cap = rng.choice([0.0, 16_000.0, 32_000.0], (n, zones, dn), p=[0.2, 0.4, 0.4])
    free = (cap * rng.uniform(0.0, 1.0, cap.shape)).astype(np.float32)
    policy = rng.integers(0, 4, n).astype(np.int8)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.astype(dt)).to(device)
                for a, dt in ((free, np.float32), (cap, np.float32), (policy, np.int8))]
        before = kernels.launches["zone_prep"]
        outs.append(tnuma.zone_prep(*args))
        if device == cuda:
            assert kernels.launches["zone_prep"] == before + 1
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(bits(a.cpu().numpy()), bits(b.numpy()))


@pytest.mark.parametrize("p, n, d", [(1, 9, 1), (37, 300, 3), (512, 10_000, 2), (200, 5003, 8)])
@pytest.mark.parametrize("zones", [1, 2, 4])
@pytest.mark.parametrize("scoring", [0, 1, 2])
def test_pricing_kernels_with_zones_match_plain(cuda, p, n, d, zones, scoring):
    """The NUMA instantiations of nomination, the shortlist build and the
    shortlist round, against their plain versions."""
    arrays, numa, required = zone_inputs(p * 3 + n + zones, p, n, d, zones)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        z = tnuma.ZoneTerms.batch_start(torch.from_numpy(numa["zone_free"]).to(device),
                                        torch.from_numpy(numa["zone_cap"]).to(device),
                                        torch.from_numpy(numa["policy"]).to(device),
                                        torch.from_numpy(required).to(device), scoring)
        nom = tnom.nominate(*args, min(4, n), 4.0, True, zones=z)
        k = min(64, n - 1)
        plan = tsl.shortlist_build(*(args[:4] + args[5:]), k, 4.0, zones=z)
        word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
        counts = torch.zeros(2, dtype=torch.int32, device=device)
        state = torch.zeros(2, dtype=torch.int32, device=device)
        top = tsl.shortlist_round(*args, *plan, min(4, k), 4.0, True, word, counts, state,
                                  zones=z)
        outs.append([t.cpu() for t in (*nom, *plan, *top, word[:3], counts)])
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()), err_msg=str(i))


@pytest.mark.parametrize("p", [1, 17, 512, 4096, 8192])
@pytest.mark.parametrize("d, zones", [(2, 2), (2, 4), (3, 1), (4, 2), (8, 4)])
@pytest.mark.parametrize("quota", [False, True])
def test_round_tail_zone_phase_matches_plain(cuda, p, d, zones, quota):
    """The round tail's zone instantiation (shared memory up to 4,096
    pods, device memory above), with and without quotas: tables, loop
    state, the zone table and the picks. Hot nodes give a node more than
    four zone candidates a round. With quotas at 4,096 pods and more the
    round runs in device memory, 16 rows a thread: the case where a
    segment-end flag kept in a local array across the quota commit was
    overwritten (wrong tables at D = 2, an illegal address at D = 4)."""
    n = max(3, p // 8)
    arrays = round_inputs(p + d * 7 + zones, p, n, d)
    arrays[16] = np.array([0, 2], np.int32)
    nodes = dict(allocatable=np.pad(arrays[7], ((0, 0), (0, max(0, 2 - d)))),
                 estimated_used=np.pad(arrays[12], ((0, 0), (0, max(0, 2 - d)))))
    _, numa, required = chip_smoke.zone_tables(p + zones, nodes, p)
    dn = min(2, d)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        zone = (torch.from_numpy(np.ascontiguousarray(numa["zone_free"][:, :zones, :dn])).to(device),
                torch.from_numpy(np.ascontiguousarray(numa["zone_cap"][:, :zones, :dn])).to(device),
                torch.from_numpy(numa["policy"]).to(device),
                torch.from_numpy(numa["zone_most"]).to(device),
                torch.from_numpy(required).to(device),
                torch.full((p,), -1, dtype=torch.int32, device=device))
        zone = with_side(zone)
        q = None
        if quota:
            chain, runtime, used = (torch.from_numpy(a).to(device)
                                    for a in quota_inputs(p + 3, p, 21, d))
            q = (chain, runtime, used, torch.zeros(p, dtype=torch.bool, device=device))
        fn = tcommit.round_tail if device == cuda else tcommit.round_tail_plain
        fn(*args, 0.35, quota=q, zone=zone)
        outs.append(args[11:] + [zone[0], zone[5]] + ([] if q is None else list(q[2:])))
    torch.cuda.synchronize()
    assert_round_equal(*outs)


@pytest.mark.parametrize("p, d", [(17, 2), (512, 2), (1000, 3), (16_384, 4)])
@pytest.mark.parametrize("zones", [1, 2, 4])
def test_enforce_gangs_zone_refund_matches_plain(cuda, p, d, zones):
    n = max(2, p // 4)
    result, pods = gang_inputs(p * 3 + zones, p, n, d, "all short")
    rng = np.random.default_rng(p + zones)
    dn = min(2, d)
    pod_zone = np.where((result["assignment"] >= 0) & (rng.random(p) < 0.6),
                        rng.integers(0, zones, p), -1).astype(np.int32)
    charge = np.where(pod_zone[:, None] >= 0, rng.uniform(100, 3000, (p, dn)), 0.0)
    free = rng.uniform(1e4, 1e5, (n, zones, dn)).astype(np.float32)
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        got.pod_zone = torch.from_numpy(pod_zone.copy()).to(device)
        got.pod_zone_charge = torch.from_numpy(charge.astype(np.float32)).to(device)
        got.node_zone_free = torch.from_numpy(free.copy()).to(device)
        before = kernels.launches["zone_refund"]
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods))
        if device == cuda:
            assert kernels.launches["zone_refund"] == before + 1
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "pod_zone", "node_requested", "node_zone_free"):
        np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                      bits(getattr(outs[1], f).numpy()), err_msg=f)


def test_numa_stream_full_on_card_matches_plain_and_golden(cuda):
    """``solve_stream_full(numa=...)``, one graph replay a chunk with the
    zone table a static buffer, equals the eager plain route and the NUMA
    golden's small streams: assignments, zone picks, rounds, fallback
    counts and the final zone table; no host sync on a replay."""
    from tools import make_torch_golden

    gold = np.load(chip_smoke.GOLDEN_NUMA)
    nodes, pods, numa, params = make_torch_golden.numa_fixture_small()
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, chip_smoke.stacked(pods),
                                                       params, cuda)
    numa_t = tnuma.NumaState.create(**numa, device=cuda)
    for scoring in chip_smoke.NUMA_SCORINGS:
        for k in (chip_smoke.SHORTLIST_K, None):
            kw = dict(chip_smoke.SOLVE, numa=numa_t, numa_scoring=scoring, shortlist_k=k)
            zf = [torch.empty_like(numa_t.zone_free) for _ in range(3)]
            first = T.solve_stream_full(pods_t, nodes_t, params_t, zone_free_out=zf[0], **kw)
            kernels.reset_launches()
            torch.cuda.set_sync_debug_mode("error")
            try:
                again = T.solve_stream_full(pods_t, nodes_t, params_t, zone_free_out=zf[1], **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert kernels.replays["solve_stream"] == 2 and kernels.launches["zone_phase"] > 0
            with chip_smoke.plain_versions():
                plain = T.solve_stream_full(pods_t, nodes_t, params_t, cuda_graph=False,
                                            zone_free_out=zf[2], **kw)
            key = f"{(scoring or 'none').lower()}_k{k or 0}"
            for out, z in zip((first, again, plain), zf):
                for name, o in zip(("assignments", "pod_zones", "rounds", "fallbacks"), out):
                    np.testing.assert_array_equal(o.cpu().numpy(), gold[f"{key}_{name}"])
                np.testing.assert_array_equal(bits(z.cpu().numpy()),
                                              bits(gold[f"{key}_zone_free"]))


# ------------------------------------------------- devices and 32,768-pod rounds

from koordinator_tpu_torch.ops import device as tdev  # noqa: E402


def device_demand(seed, p, n, g, rdma=True, pad_to=None):
    """``chip_smoke.device_tables``' slot table (G = 16 with ``g`` 16, else
    8; padded with empty slots to ``pad_to``), RDMA and FPGA counts (RDMA
    not tracked without ``rdma``) and device requests of ``p`` pods over
    ``n`` nodes: (devices dict, pods dict of gpu_whole, gpu_share, rdma,
    fpga)."""
    nodes = dict(allocatable=np.ones((n, 2), np.float32))
    pods, devices = chip_smoke.device_tables(seed, nodes, dict(requests=np.ones((p, 2))),
                                             g16=g == 16, rdma=rdma, batch=p)
    if pad_to:
        devices["slot_free"] = np.pad(devices["slot_free"],
                                      ((0, 0), (0, pad_to - devices["slot_free"].shape[1])))
    return devices, {k: pods[k] for k in ("gpu_whole", "gpu_share", "rdma", "fpga")}


def device_terms(devices, pods, device, scoring=1):
    """DeviceTerms on ``device`` of a device_demand draw (the pods taken as
    sorted), the stats table from device_prep on that device."""
    t = {k: None if v is None else torch.from_numpy(v.copy()).to(device)
         for k, v in devices.items()}
    sp = T.PodBatch(**{f.name: None for f in dataclasses.fields(T.PodBatch)})
    for k, v in pods.items():
        setattr(sp, k, torch.from_numpy(v.copy()).to(device))
    return tdev.DeviceTerms.batch_start(t["slot_free"], t["rdma_free"], t["fpga_free"],
                                        t["cap_total"], sp, scoring,
                                        units=tdev.device_consumption(sp.gpu_whole,
                                                                      sp.gpu_share)[1])


@pytest.mark.parametrize("n", [1, 257, 10_000])
@pytest.mark.parametrize("g", [1, 8, 16, 33, 256])
def test_device_prep_kernel_matches_plain(cuda, n, g):
    """The batch's stats table (``csrc/device_prep.cu``) at G = 1 to 256
    (above 32 slots the total is summed in windows of 32)."""
    rng = np.random.default_rng(n + g)
    vals = np.asarray([100.0, 100.0, 0.0, 70.0, 66.7, 33.3, 12.5, 0.1], np.float32)
    slots = vals[rng.integers(0, vals.size, (n, g))]
    before = kernels.launches["device_prep"]
    got = tdev.device_prep(torch.from_numpy(slots).to(cuda))
    torch.cuda.synchronize()
    assert kernels.launches["device_prep"] == before + 1
    np.testing.assert_array_equal(bits(got.cpu().numpy()),
                                  bits(tdev.device_prep_plain(torch.from_numpy(slots)).numpy()))


@pytest.mark.parametrize("p, n, d", [(1, 9, 1), (37, 300, 3), (512, 10_000, 2), (200, 5003, 8)])
@pytest.mark.parametrize("g, rdma, pad", [(8, True, None), (16, True, None), (8, False, 24)])
@pytest.mark.parametrize("scoring", [0, 1, 2])
@pytest.mark.parametrize("zones", [0, 2])
def test_pricing_kernels_with_devices_match_plain(cuda, p, n, d, g, rdma, pad, scoring, zones):
    """The device instantiations of nomination (approx and exact), the
    shortlist build (the score clamped) and the shortlist round, with and
    without NUMA zones, against their plain versions."""
    arrays, numa, required = zone_inputs(p * 5 + n + g, p, n, d, max(zones, 1))
    devices, demand = device_demand(p + n + g, p, n, g, rdma, pad)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        z = None
        if zones:
            z = tnuma.ZoneTerms.batch_start(torch.from_numpy(numa["zone_free"]).to(device),
                                            torch.from_numpy(numa["zone_cap"]).to(device),
                                            torch.from_numpy(numa["policy"]).to(device),
                                            torch.from_numpy(required).to(device), 1)
        v = device_terms(devices, demand, device, scoring)
        res = []
        for approx in (False, True):
            res += list(tnom.nominate(*args, min(4, n), 4.0, approx, zones=z, devices=v))
        k = min(64, n - 1)
        if k >= 1:
            plan = tsl.shortlist_build(*(args[:4] + args[5:]), k, 4.0, zones=z, devices=v)
            word = torch.zeros(tsl.WORD, dtype=torch.int32, device=device)
            counts = torch.zeros(2, dtype=torch.int32, device=device)
            state = torch.zeros(2, dtype=torch.int32, device=device)
            top = tsl.shortlist_round(*args, *plan, min(4, k), 4.0, True, word, counts, state,
                                      zones=z, devices=v)
            res += [*plan, *top, word[:3], counts]
        outs.append([t.cpu() for t in res])
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(*outs)):
        a, b = a.numpy(), b.numpy()
        if a.dtype == np.float32:
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=str(i))
            a, b = a[fin], b[fin]
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=str(i))


@pytest.mark.parametrize("p", [1, 100, 512, 5000, 70_000])
@pytest.mark.parametrize("zones, devices", [(True, False), (False, True), (True, True)])
def test_pod_order_kernel_matches_plain(cuda, p, zones, devices):
    """The batch's pod order for the term kernels (``pod_order_kernel``,
    one block, spans of pods a thread): the stable sort of the 9-valued
    key, equal to ``pod_order_plain`` at 1 to 70,000 pods."""
    from types import SimpleNamespace

    rng = np.random.default_rng(p)
    host = dict(bind=rng.random(p) < 0.2, required=rng.random(p) < 0.2,
                whole=rng.choice([0, 0, 1, -1, 4], p).astype(np.int32),
                share=rng.choice([0.0, 0.0005, 30.0], p).astype(np.float32),
                rdma_req=rng.choice([0, 0, 1], p).astype(np.int32),
                fpga_req=rng.choice([0, 0, 0, 1], p).astype(np.int32))
    outs = []
    for device in (cuda, "cpu"):
        t = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        z = SimpleNamespace(required=t["required"]) if zones else None
        v = SimpleNamespace(**{k: t[k] for k in ("whole", "share", "rdma_req", "fpga_req")}) \
            if devices else None
        before = kernels.launches["pod_order"]
        outs.append(tnom.pod_order(t["bind"], z, v))
        if device == cuda:
            assert kernels.launches["pod_order"] == before + 1
    torch.cuda.synchronize()
    np.testing.assert_array_equal(outs[0].cpu().numpy(), outs[1].numpy())


def term_fixture(cuda, kind):
    """The kernel checks' fixtures of ``csrc/nominate_terms.cu``'s
    instantiations, on the card: (nodes, flat pods, params, NumaState or
    None, DeviceState or None)."""
    from koordinator_tpu_torch.ops.numa import NumaState

    if kind == "zones Z=2":
        nodes, pods, params = chip_smoke.rich_fixture(1, chip_smoke.N_NODES, 8 * chip_smoke.BATCH)
        pods, numa = chip_smoke.binpack_numa(nodes, pods)
        nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, cuda)
        return nodes_t, pods_t, params_t, NumaState.create(**numa, device=cuda), None
    if kind == "zones Z=4":
        return chip_smoke.numa_port_inputs(torch, cuda) + (None,)
    if kind.startswith("devices"):
        nodes_t, pods_t, params_t, dev_t = chip_smoke.device_port_inputs(
            torch, cuda, rdma="untracked" not in kind)
        return nodes_t, pods_t, params_t, None, dev_t
    return chip_smoke.dev_numa_port_inputs(torch, cuda)


@pytest.mark.parametrize("p", [512, 4096])
@pytest.mark.parametrize("kind", ["zones Z=4", "zones Z=2", "devices", "devices, RDMA untracked",
                                  "both"])
@pytest.mark.parametrize("mask", [False, True])
def test_nominate_term_instantiations_match_plain(cuda, p, kind, mask):
    """``csrc/nominate_terms.cu``'s instantiations (the terms staged with the
    node tile, the zone loops unrolled at Z = 4 and 2, the warps' votes)
    bitwise equal to ``nominate_plain`` on the kernel checks' fixtures at
    the main path's P = 512 and the JAX scheduler's bucket of 4,096, under
    each scoring, approx and exact: zones (``zone_tables``' Z = 4, and
    ``binpack_numa``'s Z = 2, the seam's two sockets), devices (G = 16,
    and G = 8 with RDMA untracked), both; with a node mask whose every
    seventh row is all false, and none; the pods in place and in the
    batch's pod order."""
    from koordinator_tpu_torch.ops.numa import ZoneTerms

    nodes_t, pods_t, params_t, numa_t, dev_t = term_fixture(cuda, kind)
    n = nodes_t.allocatable.shape[0]
    batch = T.tree_map(lambda a: a[:p], pods_t)
    order, spods, bind, thr, pthr = T._round_setup(batch, nodes_t, params_t,
                                                   numa=numa_t is not None,
                                                   devices=dev_t is not None)
    args = (spods.requests, spods.estimate, spods.is_prod, bind, spods.valid,
            nodes_t.allocatable, nodes_t.requested, nodes_t.estimated_used, nodes_t.prod_used,
            nodes_t.metric_fresh, nodes_t.schedulable, nodes_t.cpu_amp, thr, pthr,
            params_t.score_weights)
    m = None
    if mask:
        _, constrained, zone = chip_smoke.quota_draws(2, 2, p)
        table = torch.from_numpy(chip_smoke.node_mask_np(constrained, zone, n)).to(cuda)
        table[::7] = False
        m = (table, order)
    for scoring in (0, 1, 2):
        z = v = None
        if numa_t is not None:
            z = ZoneTerms.batch_start(numa_t.zone_free, numa_t.zone_cap, numa_t.policy,
                                      spods.numa_required, scoring)
        if dev_t is not None:
            v = tdev.DeviceTerms.batch_start(
                dev_t.slot_free.clone(), None if dev_t.rdma_free is None else dev_t.rdma_free.clone(),
                dev_t.fpga_free.clone(), dev_t.cap_total, spods, scoring,
                units=tdev.device_consumption(spods.gpu_whole, spods.gpu_share)[1])
        for approx in (False, True):
            # exact: the pods in place (the shortlist's fallback); approx:
            # in the batch's pod order (the full-axis route)
            (v if v is not None else z).order = tnom.pod_order(bind, z, v) if approx else None
            before = kernels.launches["nominate"]
            got = tnom.nominate(*args, 4, 4.0, approx, mask=m, zones=z, devices=v)
            want = tnom.nominate_plain(*args, 4, 4.0, approx, mask=m, zones=z, devices=v)
            torch.cuda.synchronize()
            assert kernels.launches["nominate"] == before + 1
            gc, gi, wc, wi = (t.cpu().numpy() for t in (*got, *want))
            fin = np.isfinite(wc)
            np.testing.assert_array_equal(np.isfinite(gc), fin)
            np.testing.assert_array_equal(bits(gc[fin]), bits(wc[fin]))
            np.testing.assert_array_equal(gi[fin], wi[fin])
            assert fin.mean() > 0.5


@pytest.mark.parametrize("p", [1, 17, 512, 4096, 8192])
@pytest.mark.parametrize("g, rdma", [(8, True), (16, True), (8, False)])
@pytest.mark.parametrize("quota, zones", [(False, False), (True, False), (False, True),
                                          (True, True)])
def test_round_tail_device_phase_matches_plain(cuda, p, g, rdma, quota, zones):
    """The round tail's device phase (shared memory, and device memory at
    8,192 pods and wherever the working set outgrows shared memory), alone
    and with quotas and zones: tables, loop state, the slot table, the
    stats table, RDMA and FPGA. Hot nodes give a node several share pods
    and more whole GPUs than it holds in one round."""
    d = 2
    n = max(3, p // 8)
    arrays = round_inputs(p + g + 3 * quota + 5 * zones, p, n, d)
    arrays[16] = np.array([0, 2], np.int32)
    devices, demand = device_demand(p * 3 + g, p, n, g, rdma)
    nodes = dict(allocatable=arrays[7], estimated_used=arrays[12])
    _, numa, required = chip_smoke.zone_tables(p + 2, nodes, p)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        v = device_terms(devices, demand, device)
        q = z = None
        if quota:
            chain, runtime, used = (torch.from_numpy(a).to(device)
                                    for a in quota_inputs(p + 3, p, 21, d))
            q = (chain, runtime, used, torch.ones(p, dtype=torch.bool, device=device))
        if zones:
            z = (torch.from_numpy(np.ascontiguousarray(numa["zone_free"][:, :2])).to(device),
                 torch.from_numpy(np.ascontiguousarray(numa["zone_cap"][:, :2])).to(device),
                 torch.from_numpy(numa["policy"]).to(device),
                 torch.from_numpy(numa["zone_most"]).to(device),
                 torch.from_numpy(required).to(device),
                 torch.full((p,), -1, dtype=torch.int32, device=device))
            z = with_side(z)
        if device == cuda:
            before = kernels.launches["device_phase"]
            tcommit.round_tail(*args, 0.35, quota=q, zone=z, dev=v)
            torch.cuda.synchronize()
            assert kernels.launches["device_phase"] == before + 1
        else:
            tcommit.round_tail_plain(*args, 0.35, quota=q, zone=z, dev=v)
        outs.append(args[11:] + [v.slots, v.stats] + [t for t in (v.rdma, v.fpga)
                                                      if t is not None]
                    + ([] if q is None else list(q[2:])) + ([] if z is None else [z[0], z[5]]))
    assert_round_equal(*outs)


@pytest.mark.parametrize("p, both", chip_smoke.CROWDED_ROUNDS)
def test_round_tail_device_phase_crowded_matches_plain(cuda, p, both):
    """The device phase's long segments: every pod of a round nominates one
    of four GPU nodes (``chip_smoke.crowded_round_inputs``: whole, share,
    whole+share, RDMA and FPGA pods, segments of about P / 4 rows, share
    pods refused after a segment's first, RDMA running out partway), in
    shared memory (512 and 4,096 pods) and device memory (8,192 pods with
    quotas and zones, 32,768): the kernel's tables equal the plain
    round's."""
    args, terms, q, z = chip_smoke.crowded_round_inputs(torch, cuda, p, quota=both, zones=both)
    pairs, host, _, plain_nd = chip_smoke.device_round_both(torch, args, terms, q, z)
    torch.cuda.synchronize()
    for name, a, b in pairs:
        np.testing.assert_array_equal(bits(a.cpu().numpy()), bits(b.numpy()), err_msg=name)
    assert ((plain_nd[14] >= 0) & (host[14] < 0)).any()


@pytest.mark.parametrize("quota", [False, True])
@pytest.mark.parametrize("p", chip_smoke.CROWDED_ZONE_PODS)
def test_round_tail_zone_phase_crowded_matches_plain(cuda, p, quota):
    """The zone phase's long segments: every pod of a round nominates one
    of four SINGLE_NUMA_NODE nodes (``chip_smoke.crowded_zone_inputs``:
    two and four zones, two MostAllocated, segments of about P / 4 zone
    candidates, most past the fourth, some of the first four finding no
    zone), in shared memory (512 and 4,096 pods) and device memory (8,192
    and 32,768), without and with quotas: the kernel's tables, picks and
    loop state equal the plain round's."""
    args, q, z = chip_smoke.crowded_zone_inputs(torch, cuda, p, quota=quota)
    outs = []
    for device in (cuda, "cpu"):
        work = [t.to(device).clone() for t in args]
        qq = None if q is None else (q[0].to(device), q[1].to(device), q[2].to(device).clone(),
                                     q[3].to(device).clone())
        zz = tuple(t.to(device).clone() for t in z)
        before = kernels.launches["zone_phase"]
        fn = tcommit.round_tail if device == cuda else tcommit.round_tail_plain
        fn(*work, 0.35, quota=qq, zone=zz)
        if device == cuda:
            torch.cuda.synchronize()
            assert kernels.launches["zone_phase"] == before + 1
        outs.append(work[11:] + [zz[0], zz[5]] + ([] if qq is None else list(qq[2:])))
    assert_round_equal(*outs)
    picks, assigned = outs[1][7], outs[1][3]
    # each node takes at most four zone winners; some segments fewer
    per_node = np.bincount(assigned[assigned >= 0].numpy())
    assert per_node.max() <= 4 and (picks >= 0).sum() == (assigned >= 0).sum()
    assert ((per_node > 0) & (per_node < 4)).any()


@pytest.mark.parametrize("p, both", [(512, False), (4096, False), (8192, True),
                                     (65_536, False)])
@pytest.mark.parametrize("case", chip_smoke.DOMAIN_CASES)
def test_round_tail_device_domain_matches_plain(cuda, p, both, case):
    """The device sums at the edges of their domain
    (``chip_smoke.device_domain_case`` on the crowded rounds): negative
    asks inside a segment, free RDMA and FPGA counts of 2^24 and more, and
    a segment whose RDMA and FPGA cumsums pass 2^24 ahead of the others,
    which makes the batch wide (``csrc/device_prep.cu``'s flag) and the
    round take the reference's float walk: the kernel's tables equal the
    plain round's, in shared and device memory."""
    args, terms, q, z = chip_smoke.crowded_round_inputs(torch, cuda, p, quota=both, zones=both,
                                                        domain=case)
    assert int(terms.wide[0]) == (case == "sum_2_24")
    pairs, host, _, _ = chip_smoke.device_round_both(torch, args, terms, q, z)
    torch.cuda.synchronize()
    for name, a, b in pairs:
        np.testing.assert_array_equal(bits(a.cpu().numpy()), bits(b.numpy()), err_msg=name)
    assert (host[14] >= 0).any()


@pytest.mark.parametrize("p, d, q, zones", [
    (32_769, 1, 0, False), (65_536, 4, 1057, True), (65_536, 4, 21, False),
    (65_536, 8, 0, True), (131_072, 2, 0, False)])
def test_round_tail_above_32768_pods_matches_plain(cuda, p, d, q, zones):
    """Rounds of 32,769 to 131,072 pods (a gang of 32,769 padded to 65,536
    by the JAX scheduler, and the most a round takes) in the device-memory
    round tail at 128 rows a thread (``csrc/round_huge.cu``): without
    quotas, with the sorted tree and with the one-hot one (its group
    positions past 16 bits), with and without zones."""
    assert tcommit.route(0, p, d, q, 4 if q else 0, min(2, d) if zones else 0)[0] == "round_huge"
    big_round_matches_plain(cuda, p, d, q, zones)


@pytest.mark.parametrize("q", [1, 1057])
def test_enforce_gangs_at_65536_pods_matches_plain(cuda, q):
    big_rollback_matches_plain(cuda, 65_536, q)


@pytest.mark.parametrize("p, n", [(17, 5), (512, 64), (1000, 300), (16_384, 2000)])
@pytest.mark.parametrize("g, cap", [(8, True), (16, False), (32, True)])
def test_enforce_gangs_device_refund_matches_plain(cuda, p, n, g, cap):
    """The rollback's device refunds: shares summed in pod order, the
    water-fill (ties in index order, padding slots without headroom when
    cap_total is known; above 16 slots the chunked running sum), RDMA and
    FPGA back."""
    result, pods = gang_inputs(p * 7 + g, p, n, 2, "all short")
    devices, demand = device_demand(p + g, p, n, 16 if g == 16 else 8, True,
                                    pad_to=g if g > 16 else None)
    pods.update(demand)
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        got.node_dev_slots = torch.from_numpy(devices["slot_free"].copy()).to(device)
        got.node_rdma_free = torch.from_numpy(devices["rdma_free"].copy()).to(device)
        got.node_fpga_free = torch.from_numpy(devices["fpga_free"].copy()).to(device)
        exists = (tdev.slot_exists_of(torch.from_numpy(devices["cap_total"]).to(device), g)
                  if cap else None)
        before = kernels.launches["device_refund"]
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods),
                          tdev.slot_cap_of(exists))
        if device == cuda:
            assert kernels.launches["device_refund"] == before + 1
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "node_requested", "node_dev_slots", "node_rdma_free",
              "node_fpga_free"):
        np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                      bits(getattr(outs[1], f).numpy()), err_msg=f)


@pytest.mark.parametrize("d", [1, 4, 8])
@pytest.mark.parametrize("q", [0, 1057])
@pytest.mark.parametrize("zones", [False, True])
def test_round_tail_at_32768_pods_matches_plain(cuda, d, q, zones):
    """A round of 32,768 pods (a gang larger than the JAX scheduler's
    bucket, padded) in the device-memory round tail, 32 rows a thread:
    without quotas and with the sorted tree, with and without zones."""
    big_round_matches_plain(cuda, 32_768, d, q, zones)


def big_round_matches_plain(cuda, p, d, q, zones):
    """A round of ``p`` pods (route ``round_big`` or ``round_huge``)
    against the plain round on the CPU: without quotas or with a tree of
    ``q`` quotas, with or without zones."""
    n = 4096
    arrays = round_inputs(p + d + q, p, n, d)
    arrays[16] = np.array([0, 2], np.int32)
    nodes = dict(allocatable=np.pad(arrays[7], ((0, 0), (0, max(0, 2 - d)))),
                 estimated_used=np.pad(arrays[12], ((0, 0), (0, max(0, 2 - d)))))
    _, numa, required = chip_smoke.zone_tables(p + 9, nodes, p)
    dn = min(2, d)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        qq = z = None
        if q:
            chain, runtime, used = (torch.from_numpy(a).to(device)
                                    for a in quota_inputs(p * 5 + q, p, q, d))
            qq = (chain, runtime, used, torch.zeros(p, dtype=torch.bool, device=device))
        if zones:
            z = (torch.from_numpy(np.ascontiguousarray(numa["zone_free"][:, :2, :dn])).to(device),
                 torch.from_numpy(np.ascontiguousarray(numa["zone_cap"][:, :2, :dn])).to(device),
                 torch.from_numpy(numa["policy"]).to(device),
                 torch.from_numpy(numa["zone_most"]).to(device),
                 torch.from_numpy(required).to(device),
                 torch.full((p,), -1, dtype=torch.int32, device=device))
            z = with_side(z)
        if device == cuda:
            before = kernels.launches["round_tail_big"]
            tcommit.round_tail(*args, 0.35, quota=qq, zone=z)
            torch.cuda.synchronize()
            assert kernels.launches["round_tail_big"] == before + 1
        else:
            tcommit.round_tail_plain(*args, 0.35, quota=qq, zone=z)
        outs.append(args[11:] + ([] if qq is None else list(qq[2:]))
                    + ([] if z is None else [z[0], z[5]]))
    assert_round_equal(*outs)


@pytest.mark.parametrize("q", [1, 1057])
def test_enforce_gangs_at_32768_pods_matches_plain(cuda, q):
    big_rollback_matches_plain(cuda, 32_768, q)


def big_rollback_matches_plain(cuda, p, q):
    """The rollback of ``p`` pods, every gang short, with a tree of ``q``
    quotas (1: none), in device memory, against the plain one."""
    n = 4096
    result, pods = gang_inputs(p + q, p, n, 4, "all short")
    pods["quota_chain"] = quota_inputs(p + q, p, q, 4, fill=1.0)[0]
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        got.quota_used = torch.full((q, 4), 1e6, device=device)
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods))
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "node_requested", "node_estimated_used", "node_prod_used",
              "quota_used"):
        np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                      bits(getattr(outs[1], f).numpy()), err_msg=f)


def test_device_stream_full_on_card_matches_plain_and_golden(cuda):
    """``solve_stream_full(devices=...)``, one graph replay a chunk with the
    dev carry static buffers, equals the eager plain route and the device
    golden's small streams: assignments, rounds, fallback counts and the
    final slot table, RDMA and FPGA; no host sync on a replay."""
    from tools import make_torch_golden

    gold = np.load(chip_smoke.GOLDEN_DEVICE)
    nodes, pods, devices, params = make_torch_golden.device_fixture_small()
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, chip_smoke.stacked(pods),
                                                       params, cuda)
    dev_t = tdev.DeviceState.create(**devices, device=cuda)
    for scoring, k in make_torch_golden.DEVICE_SMALL_CELLS:
        kw = dict(chip_smoke.SOLVE, devices=dev_t, device_scoring=scoring, shortlist_k=k)
        tables = [tuple(torch.empty_like(t) for t in (dev_t.slot_free, dev_t.rdma_free,
                                                       dev_t.fpga_free)) for _ in range(3)]
        first = T.solve_stream_full(pods_t, nodes_t, params_t, dev_out=tables[0], **kw)
        kernels.reset_launches()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = T.solve_stream_full(pods_t, nodes_t, params_t, dev_out=tables[1], **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert kernels.replays["solve_stream"] == 2 and kernels.launches["device_phase"] > 0
        with chip_smoke.plain_versions():
            plain = T.solve_stream_full(pods_t, nodes_t, params_t, cuda_graph=False,
                                        dev_out=tables[2], **kw)
        key = chip_smoke.device_key(scoring, k)
        for out, tabs in zip((first, again, plain), tables):
            for name, o in zip(("assignments", "pod_zones", "rounds", "fallbacks"), out):
                if name != "pod_zones":
                    np.testing.assert_array_equal(o.cpu().numpy(), gold[f"{key}_{name}"])
            for name, t in zip(("slot_free", "rdma_free", "fpga_free"), tabs):
                np.testing.assert_array_equal(bits(t.cpu().numpy()), bits(gold[f"{key}_{name}"]))


@pytest.mark.parametrize("quota", [False, True])
def test_bigbatch_65536_golden_on_card(cuda, quota):
    """``assign`` on the batch of a Strict gang of 32,769 members (65,536
    pods: the round tail in ``csrc/round_huge.cu``, the rollback in device
    memory) gives the JAX package's digests."""
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH_64K)
    pods_t, nodes_t, params_t, quotas = chip_smoke.big_port_inputs(
        torch, chip_smoke.HUGE_PODS, quota, cuda)
    res = to_numpy(T.assign(pods_t, nodes_t, params_t, quotas=quotas, **chip_smoke.SOLVE))
    key = "quota" if quota else "plain"
    assert int(res["rounds_used"]) == int(gold[f"{key}_rounds"])
    assert int((res["assignment"] >= 0).sum()) == int(gold[f"{key}_placed"])
    for f, g in (("assignment", "assignment"), ("node_requested", "requested"),
                 ("node_estimated_used", "estimated_used"), ("node_prod_used", "prod_used")) + (
            (("quota_used", "quota_used"),) if quota else ()):
        assert chip_smoke.array_digest(res[f]) == str(gold[f"{key}_{g}_sha256"]), f


def test_scheduler_with_a_gang_of_32769_matches_the_jax_scheduler(cuda):
    """``BatchScheduler.schedule`` with one Strict gang of 32,769 members
    (``make_torch_golden.GANG_CASE`` on the seam's small recipe): the gang
    is a chunk of its own, padded to 65,536 pods, whose rounds run on the
    card in ``csrc/round_huge.cu``. The cycle's digest of bindings and
    annotations equals the JAX scheduler's (``torch_golden_gang.npz``)."""
    from tools import make_torch_golden

    gold = np.load(chip_smoke.GOLDEN_GANG)
    mods = chip_smoke.port_modules()
    n_nodes, n_pods, bucket = make_torch_golden.SEAM_SMALL
    sched = chip_smoke.production_scheduler(mods, n_nodes, n_pods, bucket, device=cuda)
    kernels.reset_launches()
    out = sched.schedule(chip_smoke.production_pods(mods, n_pods, **make_torch_golden.GANG_CASE))
    assert sched._fallback_level == 0 and not sched._cycle_solver_failed
    assert kernels.launches["round_tail_big"] > 0
    got = make_torch_golden.seam_digest_arrays(
        "gang", chip_smoke.seam_digest(chip_smoke.seam_outcome(mods.extension, out)))
    assert sorted(got) == sorted(gold.files)
    for k, v in got.items():
        np.testing.assert_array_equal(gold[k], v, err_msg=k)


@pytest.mark.parametrize("quota", [False, True])
def test_bigbatch_32768_golden_on_card(cuda, quota):
    """``assign`` on the 32,768-pod batch (the device-memory round tail at
    32 rows a thread, the rollback in device memory) equals the JAX
    package's golden bit for bit."""
    gold = np.load(chip_smoke.GOLDEN_BIGBATCH_32K)
    pods_t, nodes_t, params_t, quotas = chip_smoke.big_port_inputs(
        torch, 4 * chip_smoke.BIG_PODS, quota, cuda)
    res = to_numpy(T.assign(pods_t, nodes_t, params_t, quotas=quotas, **chip_smoke.SOLVE))
    key = "quota" if quota else "plain"
    for f, g in (("assignment", "assignment"), ("rounds_used", "rounds"),
                 ("node_requested", "requested"), ("node_estimated_used", "estimated_used"),
                 ("node_prod_used", "prod_used")) + ((("quota_used", "quota_used"),) if quota
                                                    else ()):
        np.testing.assert_array_equal(bits(res[f]), bits(gold[f"{key}_{g}"]), err_msg=f)


def test_stream_full_with_every_option_matches_plain(cuda):
    """``solve_stream_full`` with devices, quotas, a node mask and NUMA
    zones together (the scheduler's full constraint set), one graph replay
    a chunk, equals the eager plain route on the card and the plain route
    on the CPU: assignments, zone picks, rounds, fallbacks and the final
    zone table, slot table, RDMA and FPGA."""
    nodes, pods, params = chip_smoke.rich_fixture(3, 2000, 4 * chip_smoke.BATCH)
    pods, devices = chip_smoke.device_tables(3, nodes, pods)
    nodes, numa, required = chip_smoke.zone_tables(3, nodes, pods["requests"].shape[0])
    pods["numa_required"] = required
    runtime, used = chip_smoke.quota_tree(2, 2, pods["requests"])
    chain, constrained, zone = chip_smoke.quota_draws(2, 2, pods["requests"].shape[0])
    pods["quota_chain"] = chain
    mask = chip_smoke.node_mask_np(constrained, zone, 2000).reshape(4, chip_smoke.BATCH, 2000)
    outs = []
    for device, graph in ((cuda, True), (cuda, False), ("cpu", False)):
        nodes_t, pods_t, params_t = chip_smoke.port_inputs(
            torch, nodes, chip_smoke.stacked(pods), params, device)
        numa_t = tnuma.NumaState.create(**numa, device=device)
        dev_t = tdev.DeviceState.create(**devices, device=device)
        quotas = T.QuotaState(runtime=torch.from_numpy(runtime).to(device),
                              used=torch.from_numpy(used).to(device))
        zf = torch.empty_like(numa_t.zone_free)
        tables = tuple(torch.empty_like(t) for t in (dev_t.slot_free, dev_t.rdma_free,
                                                      dev_t.fpga_free))
        kw = dict(chip_smoke.SOLVE, quotas=quotas, numa=numa_t, devices=dev_t,
                  node_mask=torch.from_numpy(mask).to(device), numa_scoring="LeastAllocated",
                  device_scoring="LeastAllocated", shortlist_k=chip_smoke.SHORTLIST_K,
                  cuda_graph=graph, zone_free_out=zf, dev_out=tables)
        if device == cuda and not graph:
            with chip_smoke.plain_versions():
                out = T.solve_stream_full(pods_t, nodes_t, params_t, **kw)
        else:
            out = T.solve_stream_full(pods_t, nodes_t, params_t, **kw)
        outs.append([t.cpu() for t in (*out, zf, *tables)])
    torch.cuda.synchronize()
    assert (outs[0][0] >= 0).sum() > 500 and (outs[0][1] >= 0).sum() > 0
    for other in outs[1:]:
        for i, (a, b) in enumerate(zip(outs[0], other)):
            np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()), err_msg=str(i))


from koordinator_tpu_torch.ops import cost_full as tcf  # noqa: E402


@pytest.mark.parametrize("p, n, d", [(1, 1, 1), (37, 300, 3), (512, 10_000, 2), (70, 5003, 8),
                                     (33, 257, 16)])
@pytest.mark.parametrize("zones, devices, mask", [(0, False, False), (0, False, True),
                                                  (2, False, False), (0, True, False),
                                                  (2, True, True)])
def test_cost_full_kernel_matches_plain(cuda, p, n, d, zones, devices, mask):
    """The materialized cost and flags (``csrc/cost_full.cu``) of every
    pair, infeasible pairs included, with each term and a node mask."""
    if (zones or devices) and d > 8:
        pytest.skip("NUMA zones and devices take D <= 8")
    arrays, numa, required = zone_inputs(p * 3 + n + d, p, n, d, max(zones, 1))
    dev_tables, demand = device_demand(p + n, p, n, 8)
    rows = np.random.default_rng(n).random((p, n)) < 0.7
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a).to(device) for a in arrays]
        kw = {}
        if zones:
            kw["zones"] = tnuma.ZoneTerms.batch_start(
                torch.from_numpy(numa["zone_free"]).to(device),
                torch.from_numpy(numa["zone_cap"]).to(device),
                torch.from_numpy(numa["policy"]).to(device),
                torch.from_numpy(required).to(device), 1)
        if devices:
            kw["devices"] = device_terms(dev_tables, demand, device, 2)
        if mask:
            kw["mask"] = (torch.from_numpy(rows).to(device),
                          torch.arange(p, device=device).flip(0))
        before = kernels.launches["cost_full"]
        outs.append([t.cpu() for t in tcf.cost_full(*args, **kw)])
        assert kernels.launches["cost_full"] == before + (device == cuda)
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))


@pytest.mark.parametrize("p, n, k", [(1, 1, 1), (5, 31, 3), (64, 1000, 4), (130, 10_001, 8),
                                     (4096, 10_000, 4), (9, 33, 8)])
@pytest.mark.parametrize("jitter, approx", [(4.0, True), (4.0, False), (0.0, True)])
def test_nominate_cost_kernel_matches_plain(cuda, p, n, k, jitter, approx):
    """The nomination over a given cost (``csrc/nominate_cost.cu``) on
    costs with ``+inf``, ``-inf``, ``-0.0``/``+0.0`` ties, NaNs of both
    signs, infeasible pairs and whole rows infeasible."""
    if k > n:
        pytest.skip("k <= N")
    rng = np.random.default_rng(p + n + k)
    cost = rng.integers(-50, 3, (p, n)).astype(np.float32)
    pick = rng.random((p, n))
    cost[pick < 0.02] = np.inf
    cost[(pick >= 0.02) & (pick < 0.03)] = -np.inf
    cost[(pick >= 0.03) & (pick < 0.035)] = np.nan
    cost[(pick >= 0.035) & (pick < 0.04)] = -np.nan
    cost[(pick >= 0.04) & (pick < 0.06)] = -0.0
    feas = (rng.random((p, n)) < 0.8).astype(np.uint8)
    feas[::7] = 0
    # both on the card: its adds give every NaN the canonical bits
    args = (torch.from_numpy(cost).to(cuda), torch.from_numpy(feas).to(cuda), k, jitter, approx)
    state = torch.zeros(2, dtype=torch.int32, device=cuda)
    before = kernels.launches["nominate_cost"]
    outs = [[t.cpu().numpy() for t in fn(*args, state=state)]
            for fn in (tcf.nominate_cost, tcf.nominate_cost_plain)]
    assert kernels.launches["nominate_cost"] == before + 1
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(bits(outs[0][0]), bits(outs[1][0]))


def test_cost_transform_kernels_return_at_once_when_done(cuda):
    arrays = nominate_inputs(3, 40, 100, 2)
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    state = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
    out = (torch.full((40, 100), 7.0, device=cuda),
           torch.full((40, 100), 9, dtype=torch.uint8, device=cuda))
    tcf.cost_full(*args, state=state, out=out)
    top = (torch.full((40, 4), 5.0, device=cuda), torch.full((40, 4), 3, dtype=torch.int32,
                                                             device=cuda))
    tcf.nominate_cost(out[0], out[1], 4, 4.0, True, state=state, out=top)
    torch.cuda.synchronize()
    assert (out[0] == 7.0).all() and (out[1] == 9).all()
    assert (top[0] == 5.0).all() and (top[1] == 3).all()


@pytest.mark.parametrize("approx", [False, True])
def test_assign_with_a_transform_on_card_matches_cpu(cuda, approx):
    """``assign(cost_transform=)`` through the two kernels on the card
    equals its CPU run (the plain versions), NUMA zones and devices on;
    every trip runs, the shortlist is off."""
    nodes, pods, params = chip_smoke.rich_fixture(3, 300, 512)
    nodes, numa, required = chip_smoke.zone_tables(2, nodes, 512)
    pods, devices = chip_smoke.device_tables(4, nodes, pods)
    transform = chip_smoke.TRANSFORMS["veto"](torch)

    def run(device):
        return to_numpy(T.assign(
            from_numpy(T.PodBatch, device=device, **pods, numa_required=required),
            from_numpy(T.NodeState, device=device, **nodes),
            from_numpy(T.SolverParams, device=device, **params),
            numa=tnuma.NumaState.create(**numa, device=device),
            devices=tdev.DeviceState.create(**devices, device=device),
            numa_scoring="LeastAllocated", device_scoring="LeastAllocated",
            max_rounds=12, approx_topk=approx, shortlist_k=64, cost_transform=transform,
        ))

    kernels.reset_launches()
    got = run(cuda)
    assert kernels.launches["cost_full"] == kernels.launches["nominate_cost"] == 12
    assert kernels.launches["shortlist_build"] == 0
    want = run("cpu")
    for f in ("assignment", "rounds_used", "node_requested", "node_estimated_used",
              "node_prod_used", "node_zone_free", "pod_zone", "node_dev_slots"):
        np.testing.assert_array_equal(bits(got[f]), bits(want[f]), err_msg=f)


def test_solve_stream_with_a_transform_runs_eagerly_on_card(cuda):
    """With a transform the stream captures no graph, and equals its CPU
    run."""
    nodes, pods, params = chip_smoke.rich_fixture(5, 300, 4 * 256, batch=256)
    transform = chip_smoke.TRANSFORMS["bias"](torch)
    outs = []
    for device in (cuda, "cpu"):
        kernels.reset_launches()
        asg, final, placed, _ = T.solve_stream(
            from_numpy(T.PodBatch, device=device, **chip_smoke.stacked(pods, 256)),
            from_numpy(T.NodeState, device=device, **nodes),
            from_numpy(T.SolverParams, device=device, **params), max_rounds=12,
            approx_topk=True, cost_transform=transform)
        if device == cuda:
            assert not kernels.replays and kernels.launches["cost_full"] == 4 * 12
        outs.append((asg.cpu().numpy(), final.requested.cpu().numpy(), placed.cpu().numpy()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(bits(a), bits(b))


def test_a_refused_launch_fails_the_scheduling_cycle(cuda, monkeypatch):
    """A launch the card refuses (every C entry answers
    ``cudaErrorInvalidValue``) propagates out of
    ``BatchScheduler.schedule``: the fallback ladder stays at level 0 and
    the cycle's work never moves to the host reference."""
    class Refusing:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            if name.startswith("koord_") and name != "koord_error_string":
                return lambda *_args: 1
            return getattr(self._lib, name)

    mods = chip_smoke.port_modules()
    sched = chip_smoke.production_scheduler(mods, 64, 200, 64, device=cuda)
    loaded = kernels.library
    monkeypatch.setattr(kernels, "library", lambda name: Refusing(loaded(name)))
    with pytest.raises(kernels.KernelError, match="CUDA error 1"):
        sched.schedule(chip_smoke.production_pods(mods, 200))
    assert sched._fallback_level == 0 and not sched._cycle_solver_failed
    assert sched.extender.registry.get("solver_fallback_total").value(level="1") == 0.0


# ---------------------------------------------- the exact sequential solver


def sequential_inputs(seed, p, n, d, q, k):
    """The scan's CPU tensors (in ``sequential_scan``'s order; pods taken as
    already priority-sorted): ``nominate_inputs``' pods and nodes, a tenth
    of the pods invalid; with ``q`` quotas [q, D] and chains of four levels
    (unused levels, a level past the table, a quota named twice); with
    ``k`` the build's plan from the plain build. Returns (args, quota,
    plan)."""
    a = nominate_inputs(seed, p, n, d)
    rng = np.random.default_rng(seed + 1)
    a[6] = (a[5] * rng.uniform(0.0, 0.9, (n, d))).astype(np.float32)
    args = [torch.from_numpy(x) for x in (a[0], a[1], a[2], a[4], a[3], *a[5:])]
    quota = None
    if q:
        chain = rng.integers(-1, q, (p, 4)).astype(np.int32)
        chain[::7, 3] = q + 5
        chain[::5, 1] = chain[::5, 0]
        demand = a[0].sum(0)
        runtime = np.tile(demand * np.float32(0.3), (q, 1)).astype(np.float32)
        quota = (torch.from_numpy(chain), torch.from_numpy(runtime),
                 torch.zeros((q, d), dtype=torch.float32))
    plan = None
    if k:
        plan = tseq.sequential_build_plain(*args[:4], *args[5:], k)
    return args, quota, plan


@pytest.mark.parametrize("p, n, d, k", [
    (p, n, d, k)
    for p, n, d in [(1, 1, 1), (37, 5, 3), (512, 2000, 2), (300, 1500, 8), (1000, 10_001, 2),
                    (100, 3, 2)]
    for k in (None, 1, 4, 64) if k is None or k < n])
@pytest.mark.parametrize("q", [0, 3, 1057])
def test_sequential_scan_kernel_matches_plain(cuda, p, n, d, q, k):
    """``csrc/sequential.cu`` against ``sequential_scan_plain``: the picks,
    the three node tables, the quota table and the fallback counts (the
    shortlist only where K < N, as the entry turns it on)."""
    args, quota, plan = sequential_inputs(p * 11 + n + q, p, n, d, q, k)
    dev_args = [t.to(cuda) for t in args]
    dev_quota = None if quota is None else tuple(t.to(cuda) for t in quota)
    dev_plan = None if plan is None else tuple(t.to(cuda) for t in plan)
    for i in (6, 7, 8):
        args[i] = args[i].clone()
    host_quota = None if quota is None else (quota[0], quota[1], quota[2].clone())
    before = kernels.launches["sequential"]
    ka, kf = tseq.sequential_scan(*dev_args, quota=dev_quota, plan=dev_plan)
    torch.cuda.synchronize()
    assert kernels.launches["sequential"] == before + 1
    pa, pf = tseq.sequential_scan_plain(*args, quota=host_quota, plan=plan)
    np.testing.assert_array_equal(ka.cpu().numpy(), pa.numpy())
    np.testing.assert_array_equal(kf.cpu().numpy(), pf.numpy())
    for i in (6, 7, 8):
        np.testing.assert_array_equal(bits(dev_args[i].cpu().numpy()), bits(args[i].numpy()))
    if quota is not None:
        np.testing.assert_array_equal(bits(dev_quota[2].cpu().numpy()),
                                      bits(host_quota[2].numpy()))


@pytest.mark.parametrize("p, n, d, k", [(1, 2, 1, 1), (37, 300, 3, 8), (512, 10_000, 2, 64),
                                        (64, 65, 2, 64), (200, 5003, 8, 200)])
def test_sequential_build_kernel_matches_plain(cuda, p, n, d, k):
    """The build (``shortlist_build.cu`` with the jitter off) against
    ``sequential_build_plain``: candidates and the score bound."""
    args, _, _ = sequential_inputs(p + n, p, n, d, 0, None)
    build_args = args[:4] + args[5:]
    before = kernels.launches["sequential_build"]
    kc, kb = tseq.sequential_build(*(t.to(cuda) for t in build_args), k)
    torch.cuda.synchronize()
    assert kernels.launches["sequential_build"] == before + 1
    pc, pb = tseq.sequential_build_plain(*build_args, k)
    np.testing.assert_array_equal(kc.cpu().numpy(), pc.numpy())
    np.testing.assert_array_equal(bits(kb.cpu().numpy()), bits(pb.numpy()))


@pytest.mark.parametrize("tree", [None, "onehot", "sorted"])
@pytest.mark.parametrize("k", [None, chip_smoke.SHORTLIST_K])
def test_assign_sequential_on_card_matches_golden(cuda, tree, k):
    """The port's ``assign_sequential`` on the card (build, scan, rollback)
    against the JAX package's small cases in
    ``tests/data/torch_golden_sequential.npz``."""
    nodes, pods, params, quotas = chip_smoke.sequential_inputs(
        tree, *chip_smoke.rich_fixture(chip_smoke.SEQ_SEED, *chip_smoke.SEQ_SMALL))
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, cuda)
    qt = None if quotas is None else T.QuotaState(
        *(torch.from_numpy(a).to(cuda) for a in quotas))
    kernels.reset_launches()
    res = T.assign_sequential(pods_t, nodes_t, params_t, qt, shortlist_k=k)
    torch.cuda.synchronize()
    assert kernels.launches["sequential"] == 1 and kernels.launches["enforce_gangs"] == 1
    assert kernels.launches["sequential_build"] == (1 if k else 0)
    key = chip_smoke.seq_key(tree, k)
    with np.load(chip_smoke.GOLDEN_SEQUENTIAL) as golden:
        for f in chip_smoke.SEQ_OUTPUTS:
            np.testing.assert_array_equal(bits(getattr(res, f).cpu().numpy()),
                                          bits(golden[f"{key}_{f}"]), err_msg=f)


@pytest.mark.parametrize("p, n", [(1, 1), (37, 300), (512, 10_000), (3, 70_001)])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(chip_smoke.SCORE_ARGS))
def test_score_program_kernel_matches_plain(cuda, p, n, d, name):
    fix = chip_smoke.score_fixture(p + n + d, p, n, d, 2)
    host = [torch.from_numpy(fix[a]) for a in chip_smoke.SCORE_ARGS[name]]
    before = kernels.launches[name]
    got = getattr(tcosts, name)(*(t.to(cuda) for t in host))
    torch.cuda.synchronize()
    assert kernels.launches[name] == before + 1
    want = getattr(tcosts, f"{name}_plain")(*host)
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(want.numpy()))


@pytest.mark.parametrize("p, n", [(1, 1), (37, 300), (512, 10_000)])
@pytest.mark.parametrize("z", [1, 2, 4, 8])
@pytest.mark.parametrize("dn", [1, 2, 3, 4])
@pytest.mark.parametrize("most", [False, True])
def test_numa_alignment_kernel_matches_plain(cuda, p, n, z, dn, most):
    fix = chip_smoke.score_fixture(p + n + z, p, n, 4, z, dn=dn)
    state = tnuma.NumaState.create(fix["zone_free"], fix["zone_free"],
                                   np.zeros(n, np.int8), device="cpu")
    req = torch.from_numpy(fix["pod_req"])
    before = kernels.launches["numa_alignment_cost"]
    got = tnuma.numa_alignment_cost(
        req.to(cuda), tnuma.NumaState(*(t.to(cuda) for t in (state.zone_free, state.zone_cap,
                                                             state.policy))), most)
    torch.cuda.synchronize()
    assert kernels.launches["numa_alignment_cost"] == before + 1
    want = tnuma.numa_alignment_cost_plain(req, state, most)
    np.testing.assert_array_equal(bits(got.cpu().numpy()), bits(want.numpy()))


def test_a_refused_launch_fails_the_sequential_solve_and_the_scores(cuda, monkeypatch):
    """A launch the card refuses raises ``KernelError`` out of
    ``assign_sequential`` (the build, then the scan) and out of every
    scoring program; nothing falls back to the plain twins."""
    class Refusing:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            if name.startswith("koord_") and name != "koord_error_string":
                return lambda *_args: 1
            return getattr(self._lib, name)

    nodes, pods, params = chip_smoke.rich_fixture(chip_smoke.SEQ_SEED, 300, 512)
    nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, pods, params, cuda)
    fix = chip_smoke.score_fixture(1, 8, 20, 2, 2)
    loaded = kernels.library
    monkeypatch.setattr(kernels, "library", lambda name: Refusing(loaded(name)))
    for k in (None, 8):
        with pytest.raises(kernels.KernelError, match="CUDA error 1"):
            T.assign_sequential(pods_t, nodes_t, params_t, shortlist_k=k)
    for name, args in chip_smoke.SCORE_ARGS.items():
        with pytest.raises(kernels.KernelError, match="CUDA error 1"):
            getattr(tcosts, name)(*(torch.from_numpy(fix[a]).to(cuda) for a in args))
    zf = torch.from_numpy(fix["zone_free"]).to(cuda)
    with pytest.raises(kernels.KernelError, match="CUDA error 1"):
        tnuma.numa_alignment_cost(torch.from_numpy(fix["pod_req"]).to(cuda),
                                  tnuma.NumaState(zf, zf, torch.zeros(20, dtype=torch.int8,
                                                                      device=cuda)))


# ---------------------------------------------- the quota commit's edges (slice 12)


def quota_commit_case(p, kind, d=2):
    """A round tail's arguments and ``chip_smoke.commit_case``'s quota
    tree for ``kind`` over its requests; (arrays, (chain, runtime, used))."""
    arrays = round_inputs(p * 3 + 1, p, max(3, p // 8), d)
    arrays[16] = np.array([0, 2], np.int32)
    return arrays, chip_smoke.commit_case(kind, arrays[2])


@pytest.mark.parametrize("p", [512, 4096])
@pytest.mark.parametrize("kind", chip_smoke.COMMIT_CASES)
def test_round_tail_quota_commit_edges_match_plain(cuda, p, kind):
    """The quota commit's split, chunk offsets and packed charges on
    ``chip_smoke.COMMIT_CASES``: tree chains whose root takes every pod
    (the one-hot offsets in runs of 16 chunks, one chain of charges as long
    as the round), every pod in one quota, a quota at two levels of
    different pods' chains, a level no pod reaches, and quota ids at the
    split's limit (Q + 1 = 4,096 bins) and one past it (the sort). Tables,
    loop state, quota table and gate bitwise equal to the plain round; the
    quotas refuse pods their nodes accept."""
    arrays, quota = quota_commit_case(p, kind)
    branch = "quota_commit_onehot" if quota[1].shape[0] * 2 <= 1024 else "quota_commit_sorted"
    before = kernels.launches[branch]
    dev, host = quota_round_both(cuda, arrays, quota)
    assert kernels.launches[branch] == before + 1
    assert_round_equal(dev[11:], host[11:])
    free = [torch.from_numpy(a.copy()) for a in arrays]
    tcommit.round_tail_plain(*free, 0.35)
    assert int((host[14] >= 0).sum()) < int((free[14] >= 0).sum())


@pytest.mark.parametrize("p", [512, 4096])
@pytest.mark.parametrize("kind", ["tree 4x4", "tree 32x32"])
@pytest.mark.parametrize("zones, devices", [(True, False), (False, True), (True, True)])
def test_round_tail_quota_commit_with_zones_and_devices_matches_plain(cuda, p, kind, zones,
                                                                      devices):
    """Both commit branches (the 4 x 4 tree one-hot, the 32 x 32 tree
    sorted) in the zone and device instantiations (``round_zone.cu``,
    ``round_dev.cu``, ``round_zone_dev.cu``): tables, loop state, quota
    table, gate, zone table and picks, slot and stats tables, RDMA and
    FPGA bitwise equal to the plain round."""
    d = 2
    arrays, (chain, runtime, used) = quota_commit_case(p, kind, d)
    n = arrays[7].shape[0]
    demand = device_demand(p * 5 + 1, p, n, 8) if devices else None
    nodes = dict(allocatable=arrays[7], estimated_used=arrays[12])
    _, numa, required = chip_smoke.zone_tables(p + 2, nodes, p)
    outs = []
    for device in (cuda, "cpu"):
        args = [torch.from_numpy(a.copy()).to(device) for a in arrays]
        q = tuple(torch.from_numpy(a.copy()).to(device) for a in (chain, runtime, used)) + (
            torch.zeros(p, dtype=torch.bool, device=device),)
        v = device_terms(*demand, device) if devices else None
        z = None
        if zones:
            z = (torch.from_numpy(np.ascontiguousarray(numa["zone_free"][:, :2])).to(device),
                 torch.from_numpy(np.ascontiguousarray(numa["zone_cap"][:, :2])).to(device),
                 torch.from_numpy(numa["policy"]).to(device),
                 torch.from_numpy(numa["zone_most"]).to(device),
                 torch.from_numpy(required).to(device),
                 torch.full((p,), -1, dtype=torch.int32, device=device))
            z = with_side(z)
        fn = tcommit.round_tail if device == cuda else tcommit.round_tail_plain
        fn(*args, 0.35, quota=q, zone=z, dev=v)
        outs.append(args[11:] + list(q[2:]) + ([] if z is None else [z[0], z[5]])
                    + ([] if v is None else [v.slots, v.stats] + [t for t in (v.rdma, v.fpga)
                                                                 if t is not None]))
    torch.cuda.synchronize()
    assert_round_equal(*outs)



def crowded(arrays, seed, nodes=4):
    """The round's nomination cut to ``nodes`` nodes: each node segment
    about P / nodes rows long, winners and refused pods mixed in it."""
    rng = np.random.default_rng(seed)
    n = arrays[7].shape[0]
    arrays[1] = rng.choice(rng.choice(n, nodes, replace=False), arrays[1].shape).astype(np.int32)
    return arrays


#: rounds at each width of the node sort and charges: (rows a thread, P, D)
#: — one row a thread (a block-wide sort in registers), four and 16 in
#: shared memory, 32 and 128 in device memory (above 65,536 rows the
#: split's counts are 32 bits)
SPLIT_WIDTHS = [(1, 1000, 2), (4, 4096, 2), (16, 8000, 1), (32, 20_000, 2), (128, 70_000, 2)]


@pytest.mark.parametrize("is_crowded", [False, True])
@pytest.mark.parametrize("rows, p, d", SPLIT_WIDTHS)
def test_round_tail_node_split_and_charges_match_plain(cuda, rows, p, d, is_crowded):
    """The node sort (the stable radix split above one row a thread) and
    the winners' charges (a thread a segment chain) at every width, on
    ordinary and crowded rounds, bitwise equal to the plain round."""
    arrays = round_inputs(p + rows, p, 10_000, d)
    if is_crowded:
        arrays = crowded(arrays, p + rows)
    dev, host = round_tail_both(cuda, arrays)
    assert_round_equal(dev, host)
    assert (host[14].numpy() >= 0).sum() > 0
    if is_crowded:
        _, key = tcommit._choose(*(torch.from_numpy(arrays[i]) for i in (0, 1, 15)), 10_000)
        key = key.numpy()
        assert np.bincount(key[key < 10_000]).max() > p // 8


@pytest.mark.parametrize("p", [1000, 4096, 20_000])
def test_round_tail_node_split_at_its_most_passes_matches_plain(cuda, p):
    """A node count whose key takes the split's most passes (22 bits: four
    passes of 6), bitwise equal to the plain round."""
    n = (1 << 21) + 5
    dev, host = round_tail_both(cuda, round_inputs(p + 1, p, n, 2))
    assert_round_equal(dev, host)


def long_rollback_np(seed, p, n, d, refund):
    """A solved batch whose rollback has long runs (numpy result fields,
    PodBatch fields, and for ``refund`` "devices" the slot table's
    cap_total): a quarter of the pods on node 3, all in Strict gang 0 (short
    of its minMember) with half the others; with "quota" every chain's last
    level the root quota 0 over four levels of 9 quotas (some -1 or past
    the table); with "zones" picks (some past Z = 2) and charges; with
    "devices" whole GPUs, shares, RDMA and FPGA."""
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n, p)
    assignment[rng.random(p) < 0.25] = 3
    assignment[rng.random(p) < 0.08] = -1
    gang_id = np.where((assignment == 3) | (rng.random(p) < 0.5), 0,
                       np.where(rng.random(p) < 0.5, rng.integers(1, 6, p), -1))
    gang_min = np.zeros(p, np.int32)
    gang_min[:6] = rng.integers(2, 40, 6)
    gang_min[0] = p + 1
    req = (rng.uniform(100, 5000, (p, d)) * np.float32(0.85)).astype(np.float32)
    pods = dict(requests=req, estimate=(req * np.float32(0.7)).astype(np.float32),
                priority=rng.integers(5000, 9999, p).astype(np.int32),
                is_prod=rng.random(p) < 0.4, gang_id=gang_id.astype(np.int32),
                gang_min=gang_min, gang_nonstrict=np.arange(p) == 2)
    result = dict(assignment=assignment.astype(np.int32),
                  **{f: rng.uniform(1e4, 1e5, (n, d)).astype(np.float32)
                     for f in ("node_requested", "node_estimated_used", "node_prod_used")})
    extra = {}
    if refund == "quota":
        chain = rng.integers(-1, 11, (p, 4)).astype(np.int32)
        chain[:, -1] = 0
        pods["quota_chain"] = chain
        extra["quota_used"] = rng.uniform(1e5, 1e6, (9, d)).astype(np.float32)
    if refund == "zones":
        extra["node_zone_free"] = rng.uniform(1e3, 1e4, (n, 2, 2)).astype(np.float32)
        extra["pod_zone"] = np.where((assignment >= 0) & (rng.random(p) < 0.6),
                                     rng.integers(0, 4, p), -1).astype(np.int32)
        extra["pod_zone_charge"] = rng.uniform(10, 900, (p, 2)).astype(np.float32)
    if refund == "devices":
        pods.update(gpu_whole=rng.choice([0, 0, 1, 2], p).astype(np.int32),
                    gpu_share=rng.choice([0.0, 0.0, 30.0, 50.0, 87.5], p).astype(np.float32),
                    rdma=(rng.random(p) < 0.3).astype(np.int32),
                    fpga=(rng.random(p) < 0.2).astype(np.int32))
        extra["node_dev_slots"] = rng.choice([0.0, 12.5, 50.0, 100.0], (n, 8)).astype(np.float32)
        extra["node_rdma_free"] = rng.integers(0, 4, n).astype(np.float32)
        extra["node_fpga_free"] = rng.integers(0, 3, n).astype(np.float32)
        extra["cap_total"] = (rng.integers(2, 9, n) * 100).astype(np.float32)
    return result, pods, extra


@pytest.mark.parametrize("refund", ["nodes", "quota", "zones", "devices"])
@pytest.mark.parametrize("p", [512, 4096, 8192, 16_384, 32_768, 65_536])
def test_enforce_gangs_long_runs_match_plain(cuda, p, refund):
    """The rollback's chains at their longest — one node with a quarter of
    the batch rolled back, one root quota over every rolled-back row — with
    each refund, from 512 pods to 65,536 (device memory), bitwise equal to
    the plain version."""
    result, pods, extra = long_rollback_np(p + len(refund), p, 2000, 2, refund)
    outs = []
    for device in (cuda, "cpu"):
        got = solve_result(result, device)
        for name in ("quota_used", "node_zone_free", "pod_zone", "pod_zone_charge",
                     "node_dev_slots", "node_rdma_free", "node_fpga_free"):
            if name in extra:
                setattr(got, name, torch.from_numpy(extra[name].copy()).to(device))
        exists = None
        if refund == "devices":
            exists = tdev.slot_exists_of(torch.from_numpy(extra["cap_total"]).to(device), 8)
        T._enforce_gangs_(got, from_numpy(T.PodBatch, device=device, **pods),
                          tdev.slot_cap_of(exists))
        outs.append(got)
    torch.cuda.synchronize()
    for f in ("assignment", "pod_zone", "node_requested", "node_estimated_used",
              "node_prod_used", "quota_used", "node_zone_free", "node_dev_slots",
              "node_rdma_free", "node_fpga_free"):
        if getattr(outs[1], f) is not None:
            np.testing.assert_array_equal(bits(getattr(outs[0], f).cpu().numpy()),
                                          bits(getattr(outs[1], f).numpy()), err_msg=f)
    rolled = (result["assignment"] >= 0) & (outs[1].assignment.numpy() < 0)
    assert (rolled & (result["assignment"] == 3)).sum() >= 64


#: the set-up and teardown's batch sizes: one pod, a round tail's tile
#: edges, the stream's 512, the scheduler's bucket of 4,096 and past it
#: (the sort in device memory), up to MAX_ROUND_PODS
BATCH_SIZES = [1, 511, 512, 4096, 4097, 8192, 65_536, 131_072]


def setup_outputs(setup):
    """Every tensor of a ``BatchSetup``, by name, on the host."""
    out = {}
    for f in dataclasses.fields(setup):
        value = getattr(setup, f.name)
        if isinstance(value, T.PodBatch):
            for g in dataclasses.fields(value):
                if getattr(value, g.name) is not None:
                    out[f"{f.name}.{g.name}"] = getattr(value, g.name).cpu().numpy()
        elif value is not None:
            out[f.name] = value.cpu().numpy()
    return out


@pytest.mark.parametrize("prio, on", [("ties", False), ("wide", True), ("one", True)])
@pytest.mark.parametrize("p", BATCH_SIZES)
def test_batch_setup_kernel_matches_plain(cuda, p, prio, on):
    """``csrc/batch.cu``'s set-up bitwise equal to ``batch_setup_plain``:
    the order (ties, the whole int32 range with INT32_MIN and INT32_MAX,
    one priority), the sorted fields, the cpu-bind flags and the loop
    state of a batch alone, and of batch 1 of a stacked pair with the
    rollback's fields, with ``on`` the quota chains, NUMA flags, device
    asks and units, the node mask's rows, the shortlist's words and the
    slot capacities (NaN and huge ones among them)."""
    pods = chip_smoke.batch_pods(p + len(prio), 2 * p, prio)
    cap = np.random.default_rng(p).choice(
        np.array([0.0, 250.0, 400.0, 800.0, 1e9, np.nan], np.float32), 3000)
    for index in (None, 1):
        arrays = (chip_smoke.stacked(pods, p) if index is not None
                  else {k: v[:p] for k, v in pods.items()})
        outs = []
        for device in (cuda, "cpu"):
            tp = from_numpy(T.PodBatch, device=device, **arrays)
            idx = None if index is None else torch.tensor([index], device=device)
            kw = dict(words=12 if on else 0, slots=8,
                      cap_total=torch.from_numpy(cap).to(device) if on else None)
            if index is not None:
                kw.update(mask=on)
            setup = T.batch_setup(tp, idx, on, on, on, **kw)
            outs.append(setup_outputs(setup))
        torch.cuda.synchronize()
        assert outs[0].keys() == outs[1].keys()
        for name in outs[1]:
            np.testing.assert_array_equal(bits(outs[0][name]), bits(outs[1][name]),
                                          err_msg=f"{name} (index {index})")
        assert outs[0]["order"].dtype == np.int64 and "state" in outs[0]


@pytest.mark.parametrize("n, g", [(1, 1), (1, 2), (1, 3), (3, 1)])
@pytest.mark.parametrize("p", [1, 7, 4097])
def test_batch_setup_kernel_writes_slot_cap_of_a_small_table(cuda, p, n, g):
    """A batch alone with devices on, no shortlist words and fewer than
    four slots in all, so that the real slots are the helper blocks' only
    work: the set-up's slot capacities (over buffers that held NaN) and
    every other output bitwise equal to ``batch_setup_plain``'s."""
    pods = chip_smoke.batch_pods(p + 4 * n + g, p, "wide")
    cap = np.array([250.0, 0.0, 1e9][:n], np.float32)
    outs = []
    for device in (cuda, "cpu"):
        if device == cuda:  # leave NaN in the blocks the next buffers reuse
            poison = [torch.full((n,), float("nan"), device=cuda) for _ in range(64)]
            del poison
        setup = T.batch_setup(from_numpy(T.PodBatch, device=device, **pods), None,
                              devices=True, cap_total=torch.from_numpy(cap).to(device), slots=g)
        outs.append(setup_outputs(setup))
    torch.cuda.synchronize()
    assert outs[0].keys() == outs[1].keys() and "slot_cap" in outs[0]
    for name in outs[1]:
        np.testing.assert_array_equal(bits(outs[0][name]), bits(outs[1][name]), err_msg=name)


@pytest.mark.parametrize("dn", [None, 1, 2])
@pytest.mark.parametrize("p", BATCH_SIZES)
def test_batch_teardown_kernel_matches_plain(cuda, p, dn):
    """The un-sort and the zone charges (mode 0) bitwise equal to
    ``batch_teardown_plain``, cpuset-bound pods on amplified nodes among
    them; then the stream's row writes and index advance (mode 1) equal to
    ``batch_outputs_plain``."""
    n = 777
    rng = np.random.default_rng(p + (dn or 0))
    pods = chip_smoke.batch_pods(p, p, "ties")
    assigned = np.where(rng.random(p) < 0.7, rng.integers(0, n, p), -1).astype(np.int32)
    azone = np.where((assigned >= 0) & (rng.random(p) < 0.6), rng.integers(0, 4, p),
                     -1).astype(np.int32)
    amp = rng.choice(np.array([0.5, 1.0, 1.5, 2.25], np.float32), n)
    b = 3
    outs = []
    for device in (cuda, "cpu"):
        setup = T.batch_setup(from_numpy(T.PodBatch, device=device, **pods), None,
                              numa=dn is not None)
        setup.assigned.copy_(torch.from_numpy(assigned))
        if dn is not None:
            setup.azone.copy_(torch.from_numpy(azone))
        asg, zone, charge = T.batch_teardown(setup, torch.from_numpy(amp).to(device), dn)
        rows = (torch.full((b, p), 5, dtype=torch.int32, device=device),
                torch.zeros(b, dtype=torch.int32, device=device),
                torch.zeros(b, dtype=torch.int32, device=device),
                torch.zeros((b, 2), dtype=torch.int32, device=device),
                None if dn is None else torch.full((b, p), 5, dtype=torch.int32, device=device))
        index = torch.tensor([1], device=device)
        state = torch.tensor([1, 7], dtype=torch.int32, device=device)
        T.batch_outputs(rows, index, asg, zone, state[1],
                        torch.tensor([4, 2], dtype=torch.int32, device=device))
        outs.append([t.cpu().numpy() for t in (asg, zone, charge, *rows, index)
                     if t is not None])
    torch.cuda.synchronize()
    for a, c in zip(*outs):
        np.testing.assert_array_equal(bits(a), bits(c))
    assert outs[0][-1].tolist() == [2] and (outs[0][0] >= 0).sum() > 0


def test_batch_kernels_on_every_route(cuda):
    """The set-up and teardown launch on every route of ``_assign_`` on the
    card: ``assign`` (one set-up, one un-sort), the eager stream and the
    graph (one set-up, one un-sort and one output write a batch), the
    ``cost_transform`` route, and ``_round_setup``; each route's results
    equal the plain route's."""
    nodes, pods, params = chip_smoke.rich_fixture(4, 1000, 3 * chip_smoke.BATCH)
    stacked = chip_smoke.stacked(pods)
    b = 3
    runs = {}
    for name, device in (("cuda", cuda), ("cpu", "cpu")):
        nodes_t, pods_t, params_t = chip_smoke.port_inputs(torch, nodes, stacked, params, device)
        one = T.tree_map(lambda a: a[1], pods_t)
        kernels.reset_launches()
        res = T.assign(one, nodes_t, params_t, **chip_smoke.SOLVE)
        got = {"assign": [res.assignment, res.node_requested, res.rounds_used]}
        if device == cuda:
            assert kernels.launches["batch_setup"] == 1 and kernels.launches["batch_teardown"] == 1
        for graph in (False, True):
            if graph:  # the capture's warm-up batch runs eagerly: replay a second call
                T.solve_stream(pods_t, nodes_t, params_t, **chip_smoke.SOLVE, cuda_graph=graph)
            kernels.reset_launches()
            out = T.solve_stream(pods_t, nodes_t, params_t, **chip_smoke.SOLVE, cuda_graph=graph)
            got[f"stream {graph}"] = [out[0], out[2], out[1].requested]
            if device == cuda:
                assert (kernels.launches["batch_setup"], kernels.launches["batch_teardown"],
                        kernels.launches["batch_outputs"]) == (b, b, b), graph
        kernels.reset_launches()
        out = T.solve_stream(pods_t, nodes_t, params_t, **chip_smoke.SOLVE,
                             cost_transform=lambda c: c * 1.0)
        got["transform"] = [out[0], out[2]]
        if device == cuda:
            assert kernels.launches["batch_setup"] == b and kernels.launches["cost_full"] > 0
        kernels.reset_launches()
        order, spods, bind, _, _ = T._round_setup(one, nodes_t, params_t, quota=True)
        got["round_setup"] = [order, spods.requests, spods.quota_chain, bind]
        if device == cuda:
            assert kernels.launches["batch_setup"] == 1
        runs[name] = {k: [t.cpu().numpy() for t in v] for k, v in got.items()}
    torch.cuda.synchronize()
    for key, values in runs["cpu"].items():
        for i, (a, c) in enumerate(zip(runs["cuda"][key], values)):
            np.testing.assert_array_equal(bits(a), bits(c), err_msg=f"{key} {i}")
    np.testing.assert_array_equal(runs["cuda"]["stream True"][0], runs["cuda"]["transform"][0])


def test_batch_setup_refuses_what_it_cannot_take(cuda):
    """A batch above ``MAX_ROUND_PODS`` or a field off the pods' shape is
    refused before it reaches the card; a fault raises ``KernelError``
    (nothing falls back to the torch ops)."""
    pods = chip_smoke.batch_pods(1, 8)
    tp = from_numpy(T.PodBatch, device=cuda, **pods)
    with pytest.raises(kernels.KernelArgumentError):
        T.batch_setup(dataclasses.replace(tp, requests=tp.requests[:4]))
    big = T.tree_map(lambda a: a[:1].expand((131_073,) + a.shape[1:]).contiguous(), tp)
    with pytest.raises(kernels.KernelArgumentError):
        T.batch_setup(big)
    with pytest.raises(ValueError):
        T.batch_setup(tp, None, mask=True)
