"""The port's masks and costs against the JAX package, bit for bit.

Same numpy inputs through ``koordinator_tpu.ops.{masks,costs}`` and
``koordinator_tpu_torch.ops.{masks,costs}``; every boolean and every
float32 result must be identical (tolerance: none — the port keeps the
reference's operation order, so the bits agree).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koordinator_tpu.ops import costs as jcosts
from koordinator_tpu.ops import masks as jmasks
from koordinator_tpu_torch.ops import costs as tcosts
from koordinator_tpu_torch.ops import masks as tmasks

torch.set_num_threads(1)
torch.use_deterministic_algorithms(True)

GI = 1024.0
NODE_ALLOC = np.array([[96_000.0, 512 * GI]], np.float32)
EST = np.array([[16_000 * 0.85, 32 * GI * 0.7]], np.float32)


def same(j, t):
    a, b = np.asarray(j), t.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.dtype == np.float32:
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)
    return b


def both(fn_j, fn_t, *arrays, **kw):
    """Run the JAX and the torch function on the same numpy arrays."""
    j = fn_j(*[None if a is None else jnp.asarray(a) for a in arrays], **kw)
    t = fn_t(*[None if a is None else torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return same(j, t)


def test_usage_percent_rounds_half_away_from_zero():
    """Percents exactly on x.5 round up (Go's math.Round), not to even."""
    alloc = np.full(6, 1000.0, np.float32)
    used = np.array([645.0, 655.0, 654.0, 5.0, 0.0, 1000.0], np.float32)
    got = both(jmasks.usage_percent, tmasks.usage_percent, used, alloc)
    np.testing.assert_array_equal(got, [65.0, 66.0, 65.0, 1.0, 0.0, 100.0])
    # alloc-0 dims read 0%
    both(jmasks.usage_percent, tmasks.usage_percent,
         np.array([5.0, 0.0], np.float32), np.array([0.0, 0.0], np.float32))


@pytest.mark.parametrize(
    "used, fresh, want",
    [
        ((0.0, 0.0), True, 90.0),                       # empty node
        ((32_000.0, 10 * GI), True, 72.0),              # 52.5/93.67 -> 72
        ((0.0, 0.0), False, 0.0),                       # expired metric
        ((EST[0, 0], EST[0, 1]), True, 81.0),           # assigned estimate
        ((32_000.0 + EST[0, 0], 10 * GI + EST[0, 1]), True, 63.0),
    ],
)
def test_load_aware_score_reference_table(used, fresh, want):
    """load_aware_test.go TestScore cases through both costs."""
    cost = both(
        jcosts.load_aware_cost, tcosts.load_aware_cost,
        EST, np.array([used], np.float32), NODE_ALLOC, np.ones(2, np.float32),
        np.array([fresh]),
    )
    assert -cost[0, 0] == want


def random_nodes(seed, n=40, d=2):
    rng = np.random.default_rng(seed)
    alloc = rng.choice([0.0, 1000.0, 3000.0, 96_000.0], (n, d)).astype(np.float32)
    used = (alloc * rng.uniform(0.0, 1.1, (n, d))).astype(np.float32)
    # pin some nodes exactly onto x.5 percent boundaries
    used[:8] = (alloc[:8] * np.float32(0.645)).astype(np.float32)
    custom = np.where(rng.random((n, 1)) < 0.3, rng.choice([0.0, 50.0, 70.0], (n, d)), 0.0)
    return dict(
        alloc=alloc,
        used=used,
        prod=(used * np.float32(0.6)).astype(np.float32),
        fresh=rng.random(n) > 0.2,
        custom=custom.astype(np.float32),
    )


def random_pods(seed, p=24, d=2):
    rng = np.random.default_rng(seed + 100)
    req = rng.choice([0.0, 5.0, 500.0, 4000.0], (p, d)).astype(np.float32)
    return dict(
        req=req,
        est=(req * np.float32(0.85)).astype(np.float32),
        prod=rng.random(p) < 0.4,
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("thresholds", [(65.0, 95.0), (0.0, 80.0), (0.0, 0.0)])
def test_masks_match_reference(seed, thresholds):
    """fit, usage and prod thresholds with threshold-0 dims, stale metrics,
    custom thresholds and alloc-0 dims."""
    nd, pd = random_nodes(seed), random_pods(seed)
    thr = np.asarray(thresholds, np.float32)
    both(jmasks.fit_mask, tmasks.fit_mask, pd["req"], nd["alloc"] - nd["used"])
    both(jmasks.effective_thresholds, tmasks.effective_thresholds, thr, nd["custom"])
    both(jmasks.effective_thresholds, tmasks.effective_thresholds, thr, None)
    for custom in (nd["custom"], None):
        both(
            jmasks.usage_threshold_mask, tmasks.usage_threshold_mask,
            pd["est"], nd["used"], nd["alloc"], thr, nd["fresh"], custom,
        )
        both(
            jmasks.prod_usage_threshold_mask, tmasks.prod_usage_threshold_mask,
            pd["prod"], pd["est"], nd["prod"], nd["alloc"], thr, nd["fresh"], custom,
        )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weights", [(1.0, 1.0), (3.0, 1.0), (1.0, 0.0)])
def test_load_aware_cost_matches_reference(seed, weights):
    nd, pd = random_nodes(seed), random_pods(seed)
    w = np.asarray(weights, np.float32)
    both(jcosts._utilization_free_score, tcosts._utilization_free_score,
         nd["used"], nd["alloc"], w)
    for fresh in (nd["fresh"], None):
        both(jcosts.load_aware_cost, tcosts.load_aware_cost,
             pd["est"], nd["used"], nd["alloc"], w, fresh)
