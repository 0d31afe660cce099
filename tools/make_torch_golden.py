"""Write ``tests/data/torch_golden_loadaware.npz``: the JAX package's
``solve_stream`` result on ``chip_smoke.rich_fixture(7, 2000, 1024)`` with
``bench.py``'s solver arguments, for the PyTorch port to be held against.

    python tools/make_torch_golden.py

``tests/test_torch_solver.py`` regenerates the arrays and asserts that the
committed file holds them, so the file cannot drift from the reference.
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


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez_compressed(PATH, **golden_arrays())
    print(f"wrote {PATH} ({os.path.getsize(PATH)} bytes)")


if __name__ == "__main__":
    main()
