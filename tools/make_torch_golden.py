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
- ``tests/data/torch_golden_numa.npz``: the NUMA streams. On
  ``rich_fixture(7, 2000, 1024)`` with ``chip_smoke.zone_tables``' zones,
  ``solve_stream_full(numa=...)`` for each of ``chip_smoke.NUMA_SCORINGS``
  with ``shortlist_k=64`` and without (assignments, zone picks, rounds,
  fallback counts and the final zone table); and on the full-size stream
  (``chip_smoke.build_fixture(0)`` with ``chip_smoke.binpack_numa``'s
  zones, the recipe of ``bench_suite.py:bench_numa_20k``) the same four
  runs, kept as their placed counts, summed rounds and fallback counts and
  the sha256 of their assignments, zone picks and final zone tables.

    python tools/make_torch_golden.py              # every file
    python tools/make_torch_golden.py --quota      # the quota file only
    python tools/make_torch_golden.py --bigbatch   # the big-batch file only
    python tools/make_torch_golden.py --numa       # the NUMA file only

The NUMA file's final zone tables come from a copy of
``solve_stream_full``'s scan that also returns its zone carry
(:func:`numa_stream_full`), checked against ``solve_stream_full`` itself.

The full-size streams run the JAX package on the CPU (about a minute and
a few GB of memory). ``tests/test_torch_solver.py``,
``tests/test_torch_shortlist.py`` and ``tests/test_torch_stream_full.py``
regenerate the small arrays and assert that the committed files hold
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


def bigbatch_arrays() -> dict:
    """The JAX package's ``assign`` on the big batch (P = 8,192, D = 4,
    N = 2,000, bench's solver arguments) without quotas and with the
    sorted-branch tree."""
    import jax.numpy as jnp

    from koordinator_tpu.ops.solver import NodeState, PodBatch, QuotaState, SolverParams, assign

    nodes, pods, params = chip_smoke.bigbatch_fixture(chip_smoke.BIG_PODS)
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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    files = [(PATH, golden_arrays), (SHORTLIST_PATH, shortlist_golden_arrays),
             (QUOTA_PATH, lambda: {**quota_small_arrays(), **quota_full_arrays()}),
             (BIGBATCH_PATH, bigbatch_arrays), (NUMA_PATH, numa_arrays)]
    only = {"--quota": QUOTA_PATH, "--bigbatch": BIGBATCH_PATH, "--numa": NUMA_PATH}
    picked = [only[a] for a in sys.argv[1:] if a in only]
    if picked:
        files = [f for f in files if f[0] in picked]
    for path, arrays in files:
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
