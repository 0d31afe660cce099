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
  its placed count, its summed rounds and its summed fallback counts.

    python tools/make_torch_golden.py            # every file
    python tools/make_torch_golden.py --quota    # the quota file only

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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    files = [(PATH, golden_arrays), (SHORTLIST_PATH, shortlist_golden_arrays),
             (QUOTA_PATH, lambda: {**quota_small_arrays(), **quota_full_arrays()})]
    if "--quota" in sys.argv[1:]:
        files = files[2:]
    for path, arrays in files:
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
