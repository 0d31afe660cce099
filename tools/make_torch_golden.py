"""Write the JAX package's results that the PyTorch port is held against:

- ``tests/data/torch_golden_loadaware.npz``: ``solve_stream`` on
  ``chip_smoke.rich_fixture(7, 2000, 1024)`` with ``bench.py``'s solver
  arguments;
- ``tests/data/torch_golden_shortlist.npz``: the same fixture and arguments
  with the candidate shortlist at ``shortlist_k=64`` (``solve_stream`` for
  the assignments and final tables, ``solve_stream_full`` for the rounds
  and the [2, 2] fallback counts), and ``assign`` with ``shortlist_k=4``
  on ``chip_smoke.contention_fixture()``, whose rounds fall back;
- ``tests/data/torch_golden_quota.npz``: the quota streams. On the same
  fixture with each of ``chip_smoke.QUOTA_TREES``' trees, its chains and
  its node mask: ``solve_stream_full`` with ``shortlist_k=64`` and
  without (assignments, rounds, fallback counts) and ``solve_stream`` with
  the quotas (final node and quota tables); and on the full-size stream
  (``chip_smoke.build_fixture(0)``, 98,304 pods, 10,000 nodes, the
  stacked [192, 512, 10,000] mask) each tree's ``solve_stream_full``,
  with and without the shortlist, kept as the sha256 of its assignments,
  its placed count, its summed rounds and its summed fallback counts;
- ``tests/data/torch_golden_bigbatch.npz``: ``assign`` on
  ``chip_smoke.bigbatch_fixture(8192)`` (one round of 8,192 pods at D = 4
  over 2,000 nodes, a Strict gang of 6,000 members that rolls back and a
  NonStrict one), without quotas and with ``chip_smoke.bigbatch_quotas``'
  tree (Q = 1,057): assignments, rounds and the final node and quota
  tables;
- ``tests/data/torch_golden_bigbatch_32768.npz``: the same at P = 32,768
  (the largest round the round tail takes);
- ``tests/data/torch_golden_numa.npz``: the NUMA streams. On
  ``rich_fixture(7, 2000, 1024)`` with ``chip_smoke.zone_tables``' zones,
  ``solve_stream_full(numa=...)`` for each of ``chip_smoke.NUMA_SCORINGS``
  with ``shortlist_k=64`` and without (assignments, zone picks, rounds,
  fallback counts and the final zone table); and on the full-size stream
  (``chip_smoke.build_fixture(0)`` with ``chip_smoke.binpack_numa``'s
  zones, the recipe of ``bench_suite.py:bench_numa_20k``) the same four
  runs, kept as their placed counts, summed rounds and fallback counts and
  the sha256 of their assignments, zone picks and final zone tables;
- ``tests/data/torch_golden_device.npz``: the device streams. On
  ``rich_fixture(7, 2000, 1024)`` with ``chip_smoke.device_tables``'
  devices, ``solve_stream_full(devices=...)`` for each device scoring
  (none, LeastAllocated, MostAllocated) with ``shortlist_k=64`` and
  without, and with RDMA not tracked (assignments, rounds, fallback counts
  and the final slot table and RDMA and FPGA counts); and on the
  full-size stream (``chip_smoke.build_fixture(0)`` with
  ``chip_smoke.gpu_fleet``'s devices, after ``bench_suite.py``'s
  ``bench_device_gang_20k`` and ``_build_device_stream``) the cells of
  ``chip_smoke.DEVICE_CELLS``, kept as their placed counts, summed rounds
  and fallback counts and the sha256 of their assignments and final
  tables.

    python tools/make_torch_golden.py              # every file
    python tools/make_torch_golden.py --quota      # the quota file only
    python tools/make_torch_golden.py --bigbatch   # the big-batch file only
    python tools/make_torch_golden.py --numa       # the NUMA file only
    python tools/make_torch_golden.py --device     # the device file only

The NUMA file's final zone tables come from a copy of
``solve_stream_full``'s scan that also returns its zone carry
(:func:`numa_stream_full`), checked against ``solve_stream_full`` itself;
the device file's final tables likewise (:func:`device_stream_full`).

The full-size streams run the JAX package on the CPU (about a minute and
a few GB of memory). ``tests/test_torch_solver.py``,
``tests/test_torch_shortlist.py``, ``tests/test_torch_stream_full.py``,
``tests/test_torch_numa_solver.py``, ``tests/test_torch_bigbatch.py`` and
``tests/test_torch_device_solver.py`` regenerate the small arrays (the
device file: one of its cells) and assert that the committed files hold
them, so the files cannot drift from the reference.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PATH = chip_smoke.GOLDEN
SHORTLIST_PATH = chip_smoke.GOLDEN_SHORTLIST


def golden_arrays() -> dict:
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import NodeState, PodBatch, SolverParams, solve_stream

    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    stacked = jax.tree.map(
        lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]),
        PodBatch.create(**pods),
    )
    asg, final, _, _ = solve_stream(
        stacked,
        NodeState.create(**nodes),
        SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        **chip_smoke.SOLVE,
    )
    return dict(
        fixture_sha256=np.array(chip_smoke.fixture_digest(nodes, pods, params)),
        assignments=np.asarray(asg),
        requested=np.asarray(final.requested),
        estimated_used=np.asarray(final.estimated_used),
        prod_used=np.asarray(final.prod_used),
    )


def shortlist_golden_arrays() -> dict:
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import (
        NodeState, PodBatch, SolverParams, assign, solve_stream, solve_stream_full,
    )

    def params_of(params):
        return SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})

    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    stacked = jax.tree.map(
        lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]),
        PodBatch.create(**pods),
    )
    kw = dict(chip_smoke.SOLVE, shortlist_k=chip_smoke.SHORTLIST_K)
    asg, final, _, _ = solve_stream(stacked, NodeState.create(**nodes), params_of(params), **kw)
    full_asg, _, rounds, fallbacks = solve_stream_full(
        stacked, NodeState.create(**nodes), params_of(params), **kw
    )
    assert np.array_equal(np.asarray(asg), np.asarray(full_asg))
    c_nodes, c_pods, c_params = chip_smoke.contention_fixture()
    res = assign(
        PodBatch.create(**c_pods), NodeState.create(**c_nodes), params_of(c_params),
        shortlist_k=chip_smoke.CONTENTION_K,
    )
    return dict(
        fixture_sha256=np.array(chip_smoke.fixture_digest(nodes, pods, params)),
        assignments=np.asarray(asg),
        requested=np.asarray(final.requested),
        estimated_used=np.asarray(final.estimated_used),
        prod_used=np.asarray(final.prod_used),
        rounds=np.asarray(rounds),
        fallbacks=np.asarray(fallbacks),
        contention_sha256=np.array(chip_smoke.fixture_digest(c_nodes, c_pods, c_params)),
        contention_assignment=np.asarray(res.assignment),
        contention_requested=np.asarray(res.node_requested),
        contention_estimated_used=np.asarray(res.node_estimated_used),
        contention_prod_used=np.asarray(res.node_prod_used),
        contention_rounds=np.asarray(res.rounds_used),
        contention_fallbacks=np.asarray(res.shortlist_fallbacks),
    )


QUOTA_PATH = chip_smoke.GOLDEN_QUOTA


def quota_stream_full(tree: str, nodes, pods, params, batch: int, shortlist_k):
    """The JAX package's ``solve_stream_full`` on a fixture's numpy dicts
    with ``tree``'s quotas and node mask, ``chip_smoke.SOLVE``'s
    arguments: (assignments [C, P], rounds [C], fallbacks [C, 2])."""
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import (
        NodeState, PodBatch, QuotaState, SolverParams, solve_stream_full,
    )

    nodes, pods, params, (runtime, used), (constrained, zone) = chip_smoke.quota_fixture(
        tree, nodes, pods, params
    )
    n = nodes["allocatable"].shape[0]
    stacked = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]),
                           PodBatch.create(**pods))
    mask = chip_smoke.node_mask_np(constrained, zone, n).reshape(-1, batch, n)
    asg, _, rounds, fallbacks = solve_stream_full(
        stacked, NodeState.create(**nodes),
        SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
        quotas=QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used)),
        node_mask=jnp.asarray(mask), shortlist_k=shortlist_k, **chip_smoke.SOLVE,
    )
    return np.asarray(asg), np.asarray(rounds), np.asarray(fallbacks)


def quota_small_arrays() -> dict:
    """The quota golden's small part: on ``rich_fixture(7, 2000, 1024)``
    (gangs that roll back, so the quota refund runs) for each tree,
    ``solve_stream_full`` at K=64 and without the shortlist, and
    ``solve_stream`` with the quotas and no mask."""
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import (
        NodeState, PodBatch, QuotaState, SolverParams, solve_stream,
    )

    fixture = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    out = dict(fixture_sha256=np.array(chip_smoke.fixture_digest(*fixture)))
    for tree in chip_smoke.QUOTA_TREES:
        for k in (chip_smoke.SHORTLIST_K, None):
            asg, rounds, fallbacks = quota_stream_full(tree, *fixture, chip_smoke.BATCH, k)
            key = f"{tree}_k{k or 0}"
            out.update({f"{key}_assignments": asg, f"{key}_rounds": rounds,
                        f"{key}_fallbacks": fallbacks})
        nodes, pods, params, (runtime, used), _ = chip_smoke.quota_fixture(tree, *fixture)
        stacked = jax.tree.map(
            lambda a: a.reshape((-1, chip_smoke.BATCH) + a.shape[1:]), PodBatch.create(**pods)
        )
        asg, final, _, fq = solve_stream(
            stacked, NodeState.create(**nodes),
            SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
            quotas=QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used)),
            **chip_smoke.SOLVE,
        )
        out.update({
            f"{tree}_stream_assignments": np.asarray(asg),
            f"{tree}_stream_requested": np.asarray(final.requested),
            f"{tree}_stream_estimated_used": np.asarray(final.estimated_used),
            f"{tree}_stream_prod_used": np.asarray(final.prod_used),
            f"{tree}_stream_quota_used": np.asarray(fq.used),
        })
    return out


def assignments_digest(asg) -> str:
    """sha256 of a stream's assignments as little-endian int32 [C, P]."""
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(asg, dtype="<i4").tobytes()).hexdigest()


def quota_full_arrays() -> dict:
    """The full-size quota streams' digests, placed counts, summed rounds
    and summed fallback counts, for each tree with K=64 and without."""
    fixture = chip_smoke.headline_inputs(chip_smoke.build_fixture(0))
    out = dict(full_fixture_sha256=np.array(chip_smoke.fixture_digest(*fixture)))
    for tree in chip_smoke.QUOTA_TREES:
        for k in (chip_smoke.SHORTLIST_K, None):
            asg, rounds, fallbacks = quota_stream_full(tree, *fixture, chip_smoke.BATCH, k)
            key = f"full_{tree}_k{k or 0}"
            out.update({
                f"{key}_sha256": np.array(assignments_digest(asg)),
                f"{key}_placed": np.array(int((asg >= 0).sum())),
                f"{key}_rounds": np.array(int(rounds.sum())),
                f"{key}_fallbacks": fallbacks.sum(axis=0),
            })
            print(f"{key}: placed {int((asg >= 0).sum())}, rounds {int(rounds.sum())}, "
                  f"fallbacks {fallbacks.sum(axis=0).tolist()}", flush=True)
    return out


BIGBATCH_PATH = chip_smoke.GOLDEN_BIGBATCH


def bigbatch_arrays(n_pods: int = chip_smoke.BIG_PODS) -> dict:
    """The JAX package's ``assign`` on the big batch (P = ``n_pods``, 8,192
    by default, D = 4, N = 2,000, bench's solver arguments) without quotas
    and with the sorted-branch tree."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import NodeState, PodBatch, QuotaState, SolverParams, assign

    nodes, pods, params = chip_smoke.bigbatch_fixture(n_pods)
    q_pods, (runtime, used) = chip_smoke.bigbatch_quotas(pods)
    out = dict(fixture_sha256=np.array(chip_smoke.fixture_digest(nodes, q_pods, params)))
    for key, batch, quotas in (
        ("plain", pods, None),
        ("quota", q_pods, QuotaState(runtime=jnp.asarray(runtime), used=jnp.asarray(used))),
    ):
        res = assign(PodBatch.create(**batch), NodeState.create(**nodes),
                     SolverParams(**{k: jnp.asarray(v) for k, v in params.items()}),
                     quotas=quotas, **chip_smoke.SOLVE)
        out.update({
            f"{key}_assignment": np.asarray(res.assignment),
            f"{key}_rounds": np.asarray(res.rounds_used),
            f"{key}_requested": np.asarray(res.node_requested),
            f"{key}_estimated_used": np.asarray(res.node_estimated_used),
            f"{key}_prod_used": np.asarray(res.node_prod_used),
        })
        if quotas is not None:
            out[f"{key}_quota_used"] = np.asarray(res.quota_used)
    return out


BIGBATCH_32K_PATH = chip_smoke.GOLDEN_BIGBATCH_32K


def bigbatch_32k_arrays() -> dict:
    """:func:`bigbatch_arrays` at P = 32,768 (a gang larger than the JAX
    scheduler's bucket, padded: the round tail's largest batch)."""
    return bigbatch_arrays(4 * chip_smoke.BIG_PODS)


NUMA_PATH = chip_smoke.GOLDEN_NUMA


def numa_stream_full(stacked, nodes, params, numa, numa_scoring, shortlist_k):
    """``solve_stream_full(numa=...)``'s scan (``ops/solver.py:1748-1855``,
    no quotas, devices or mask), returning also the final zone carry:
    (assignments [C, P], pod_zones [C, P], rounds [C], fallbacks [C, 2],
    zone_free [N, Z, DN])."""
    import functools

    import jax

    from koordinator_tpu.ops.solver import assign

    @functools.partial(jax.jit, static_argnames=("numa_scoring", "shortlist_k"))
    def run(stacked, nodes, params, numa, numa_scoring, shortlist_k):
        def step(carry, pb):
            cur, zone_free = carry
            res = assign(pb, cur, params, numa=numa, numa_carry=zone_free,
                         numa_scoring=numa_scoring, shortlist_k=shortlist_k,
                         **chip_smoke.SOLVE)
            nxt = cur.replace(requested=res.node_requested,
                              estimated_used=res.node_estimated_used,
                              prod_used=res.node_prod_used)
            return (nxt, res.node_zone_free), (res.assignment, res.pod_zone, res.rounds_used,
                                               res.shortlist_fallbacks)

        (_, zone_free), outs = jax.lax.scan(step, (nodes, numa.zone_free), stacked)
        return outs + (zone_free,)

    return tuple(np.asarray(a) for a in run(stacked, nodes, params, numa, numa_scoring,
                                            shortlist_k))


def numa_streams(nodes, pods, numa, params, batch: int):
    """Each NUMA stream of ``chip_smoke.NUMA_SCORINGS`` x (K=64, off) on a
    fixture's numpy dicts, checked against ``solve_stream_full``: key →
    (assignments, zones, rounds, fallbacks, zone_free)."""
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.numa import NumaState
    from koordinator_tpu.ops.solver import NodeState, PodBatch, SolverParams, solve_stream_full

    stacked = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]),
                           PodBatch.create(**pods))
    jn = NodeState.create(**nodes)
    jpar = SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jnuma = NumaState(**{k: jnp.asarray(v) for k, v in numa.items()})
    out = {}
    for scoring in chip_smoke.NUMA_SCORINGS:
        for k in (chip_smoke.SHORTLIST_K, None):
            got = numa_stream_full(stacked, jn, jpar, jnuma, scoring, k)
            ref = solve_stream_full(stacked, jn, jpar, numa=jnuma, numa_scoring=scoring,
                                    shortlist_k=k, **chip_smoke.SOLVE)
            for a, b in zip(got, ref):
                assert np.array_equal(a, np.asarray(b)), "numa_stream_full differs"
            out[f"{(scoring or 'none').lower()}_k{k or 0}"] = got
            print(f"numa stream {scoring} K={k}: placed {int((got[0] >= 0).sum())}, "
                  f"zoned {int((got[1] >= 0).sum())}, rounds {int(got[2].sum())}", flush=True)
    return out


def numa_fixture_small():
    """The small NUMA stream's numpy dicts: ``rich_fixture(7, 2000, 1024)``
    with ``zone_tables``' zones (nodes, pods, numa, params)."""
    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    nodes, numa, required = chip_smoke.zone_tables(chip_smoke.GOLDEN_SEED, nodes,
                                                   chip_smoke.GOLDEN_PODS)
    return nodes, dict(pods, numa_required=required), numa, params


def numa_fixture_full():
    """The full-size NUMA stream's numpy dicts: the headline fixture with
    ``binpack_numa``'s zones (nodes, pods, numa, params)."""
    nodes, pods, params = chip_smoke.headline_inputs(chip_smoke.build_fixture(0))
    pods, numa = chip_smoke.binpack_numa(nodes, pods)
    return nodes, pods, numa, params


def digest(a) -> str:
    """sha256 of an array's little-endian bytes (int32 or float32)."""
    import hashlib

    a = np.asarray(a)
    return hashlib.sha256(np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<")).tobytes()
                          ).hexdigest()


def numa_arrays() -> dict:
    small = numa_fixture_small()
    out = dict(fixture_sha256=np.array(chip_smoke.fixture_digest(*small)))
    for key, (asg, zones, rounds, fb, zone_free) in numa_streams(
            *small, chip_smoke.BATCH).items():
        out.update({f"{key}_assignments": asg, f"{key}_pod_zones": zones,
                    f"{key}_rounds": rounds, f"{key}_fallbacks": fb,
                    f"{key}_zone_free": zone_free})
    full = numa_fixture_full()
    out["full_fixture_sha256"] = np.array(chip_smoke.fixture_digest(*full))
    for key, (asg, zones, rounds, fb, zone_free) in numa_streams(
            *full, chip_smoke.BATCH).items():
        out.update({
            f"full_{key}_placed": np.array(int((asg >= 0).sum())),
            f"full_{key}_rounds": np.array(int(rounds.sum())),
            f"full_{key}_fallbacks": fb.sum(axis=0),
            f"full_{key}_sha256": np.array(digest(asg)),
            f"full_{key}_zones_sha256": np.array(digest(zones)),
            f"full_{key}_zone_free_sha256": np.array(digest(zone_free)),
        })
    return out


DEVICE_PATH = chip_smoke.GOLDEN_DEVICE


def device_stream_full(stacked, nodes, params, devices, device_scoring, shortlist_k,
                       quotas=None, numa=None, node_mask=None):
    """``solve_stream_full(devices=...)``'s scan (``ops/solver.py:1748-1855``),
    returning also the final dev carry: (assignments [C, P], pod_zones
    [C, P], rounds [C], fallbacks [C, 2], slot_free [N, G], rdma_free [N],
    fpga_free [N], zeros for a count not tracked)."""
    import functools

    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import QuotaState, assign

    @functools.partial(jax.jit, static_argnames=("device_scoring", "shortlist_k"))
    def run(stacked, nodes, params, devices, quotas, numa, node_mask, device_scoring,
            shortlist_k):
        n = nodes.allocatable.shape[0]
        zeros = jnp.zeros((n,), jnp.float32)
        dev0 = (devices.slot_free,
                zeros if devices.rdma_free is None else devices.rdma_free,
                zeros if devices.fpga_free is None else devices.fpga_free)
        qused0 = None if quotas is None else quotas.used
        zone0 = None if numa is None else numa.zone_free

        def step(carry, xs):
            pb, mask = xs if node_mask is not None else (xs, None)
            cur, qused, dev, zone = carry
            res = assign(pb, cur, params,
                         quotas=None if quotas is None else QuotaState(runtime=quotas.runtime,
                                                                       used=qused),
                         numa=numa, devices=devices, node_mask=mask, dev_carry=dev,
                         numa_carry=zone, device_scoring=device_scoring,
                         shortlist_k=shortlist_k, **chip_smoke.SOLVE)
            nxt = cur.replace(requested=res.node_requested,
                              estimated_used=res.node_estimated_used,
                              prod_used=res.node_prod_used)
            new_dev = (res.node_dev_slots, res.node_rdma_free, res.node_fpga_free)
            return ((nxt, None if quotas is None else res.quota_used, new_dev,
                     None if numa is None else res.node_zone_free),
                    (res.assignment, res.pod_zone, res.rounds_used, res.shortlist_fallbacks))

        xs = stacked if node_mask is None else (stacked, node_mask)
        (_, _, dev, _), outs = jax.lax.scan(step, (nodes, qused0, dev0, zone0), xs)
        return outs + dev

    return tuple(np.asarray(a) for a in run(stacked, nodes, params, devices, quotas, numa,
                                            node_mask, device_scoring, shortlist_k))


def jax_devices(devices: dict):
    """A ``koordinator_tpu`` DeviceState of a devices dict (None stays None)."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.device import DeviceState

    return DeviceState(**{k: None if v is None else jnp.asarray(v) for k, v in devices.items()})


def device_streams(nodes, pods, devices, params, batch: int, cells):
    """Each device stream of ``cells`` ((device_scoring, shortlist_k)
    pairs) on a fixture's numpy dicts, checked against
    ``solve_stream_full``: key → (assignments, zones, rounds, fallbacks,
    slot_free, rdma_free, fpga_free)."""
    import jax
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import NodeState, PodBatch, SolverParams, solve_stream_full

    stacked = jax.tree.map(lambda a: a.reshape((-1, batch) + a.shape[1:]),
                           PodBatch.create(**pods))
    jn = NodeState.create(**nodes)
    jpar = SolverParams(**{k: jnp.asarray(v) for k, v in params.items()})
    jdev = jax_devices(devices)
    out = {}
    for scoring, k in cells:
        got = device_stream_full(stacked, jn, jpar, jdev, scoring, k)
        ref = solve_stream_full(stacked, jn, jpar, devices=jdev, device_scoring=scoring,
                                shortlist_k=k, **chip_smoke.SOLVE)
        for a, b in zip(got, ref):
            assert np.array_equal(a, np.asarray(b)), "device_stream_full differs"
        out[chip_smoke.device_key(scoring, k)] = got
        print(f"device stream {scoring} K={k}: placed {int((got[0] >= 0).sum())}, "
              f"rounds {int(got[2].sum())}, fallbacks {got[3].sum(axis=0).tolist()}", flush=True)
    return out


def device_fixture_small(rdma: bool = True):
    """The small device stream's numpy dicts: ``rich_fixture(7, 2000,
    1024)`` with ``device_tables``' devices (nodes, pods, devices,
    params)."""
    nodes, pods, params = chip_smoke.rich_fixture(
        chip_smoke.GOLDEN_SEED, chip_smoke.GOLDEN_NODES, chip_smoke.GOLDEN_PODS
    )
    pods, devices = chip_smoke.device_tables(chip_smoke.GOLDEN_SEED, nodes, pods, rdma=rdma)
    return nodes, pods, devices, params


def device_fixture_full():
    """The full-size device stream's numpy dicts: the headline fixture with
    ``gpu_fleet``'s devices (nodes, pods, devices, params)."""
    nodes, pods, params = chip_smoke.headline_inputs(chip_smoke.build_fixture(0))
    pods, devices = chip_smoke.gpu_fleet(nodes, pods)
    return nodes, pods, devices, params


#: the small device streams: every scoring, K=64 and off
DEVICE_SMALL_CELLS = tuple((s, k) for s in (None, "LeastAllocated", "MostAllocated")
                           for k in (chip_smoke.SHORTLIST_K, None))


def device_arrays() -> dict:
    out = {}
    for tracked in (True, False):
        small = device_fixture_small(rdma=tracked)
        tag = "" if tracked else "nordma_"
        out[f"{tag}fixture_sha256"] = np.array(chip_smoke.fixture_digest(
            small[0], small[1], small[3], {k: v for k, v in small[2].items() if v is not None}))
        cells = DEVICE_SMALL_CELLS if tracked else ((None, chip_smoke.SHORTLIST_K),)
        for key, res in device_streams(*small, chip_smoke.BATCH, cells).items():
            for name, a in zip(chip_smoke.DEVICE_OUTPUTS, res):
                if name != "pod_zones":
                    out[f"{tag}{key}_{name}"] = a
    full = device_fixture_full()
    out["full_fixture_sha256"] = np.array(chip_smoke.fixture_digest(
        full[0], full[1], full[3], {k: v for k, v in full[2].items() if v is not None}))
    for key, res in device_streams(*full, chip_smoke.BATCH, chip_smoke.DEVICE_CELLS).items():
        asg, _, rounds, fb, slots, rdma, fpga = res
        out.update({
            f"full_{key}_placed": np.array(int((asg >= 0).sum())),
            f"full_{key}_rounds": np.array(int(rounds.sum())),
            f"full_{key}_fallbacks": fb.sum(axis=0),
            f"full_{key}_sha256": np.array(digest(asg)),
            f"full_{key}_slot_free_sha256": np.array(digest(slots)),
            f"full_{key}_rdma_free_sha256": np.array(digest(rdma)),
            f"full_{key}_fpga_free_sha256": np.array(digest(fpga)),
        })
    return out


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    files = [(PATH, golden_arrays), (SHORTLIST_PATH, shortlist_golden_arrays),
             (QUOTA_PATH, lambda: {**quota_small_arrays(), **quota_full_arrays()}),
             (BIGBATCH_PATH, bigbatch_arrays), (BIGBATCH_32K_PATH, bigbatch_32k_arrays),
             (NUMA_PATH, numa_arrays), (DEVICE_PATH, device_arrays)]
    only = {"--quota": [QUOTA_PATH], "--bigbatch": [BIGBATCH_PATH, BIGBATCH_32K_PATH],
            "--numa": [NUMA_PATH], "--device": [DEVICE_PATH]}
    picked = [path for a in sys.argv[1:] if a in only for path in only[a]]
    if picked:
        files = [f for f in files if f[0] in picked]
    for path, arrays in files:
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
