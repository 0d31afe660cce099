"""Write the JAX package's results that the PyTorch port is held against:

- ``tests/data/torch_golden_loadaware.npz``: ``solve_stream`` on
  ``chip_smoke.rich_fixture(7, 2000, 1024)`` with ``bench.py``'s solver
  arguments;
- ``tests/data/torch_golden_shortlist.npz``: the same fixture and arguments
  with the candidate shortlist at ``shortlist_k=64`` (``solve_stream`` for
  the assignments and final tables, ``solve_stream_full`` for the rounds
  and the [2, 2] fallback counts), and ``assign`` with ``shortlist_k=4``
  on ``chip_smoke.contention_fixture()``, whose rounds fall back.

    python tools/make_torch_golden.py

``tests/test_torch_solver.py`` and ``tests/test_torch_shortlist.py``
regenerate the arrays and assert that the committed files hold them, so
the files cannot drift from the reference.
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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    for path, arrays in ((PATH, golden_arrays), (SHORTLIST_PATH, shortlist_golden_arrays)):
        np.savez_compressed(path, **arrays())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
