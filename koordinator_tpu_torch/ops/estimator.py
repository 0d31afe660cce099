"""Pod usage estimation (reference ``pkg/scheduler/plugins/loadaware/estimator/
default_estimator.go:59-122``).

The reference's DefaultEstimator scales a pod's requests by per-resource
factors (CPU 85%, memory 70% by default) to estimate its post-bind usage;
priority bands below prod fall back to smaller defaults. Here it is a pure
vectorized function over the dense resource axis.

Port of ``koordinator_tpu/ops/estimator.py``: the host code
(:func:`scale_vector`, :func:`estimate_pod` and the defaults) is the
reference's, and :func:`estimate_pod_usage` (:40-55) is one torch
multiplication on the tensors' device. No solve path calls it (the
scheduler scales on the host, :func:`scale_vector`), so it has no
kernel of its own.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import numpy as np
import torch

from ..api import extension as ext

#: default scaling factors by resource name (DefaultMilliCPURequest /
#: DefaultMemoryRequest analogs use the same axis; unknown dims scale 1.0)
DEFAULT_SCALE_FACTORS: Mapping[str, float] = {
    ext.RES_CPU: 0.85,
    ext.RES_MEMORY: 0.70,
    ext.RES_BATCH_CPU: 0.85,
    ext.RES_BATCH_MEMORY: 0.70,
}


def scale_vector(
    resources: Tuple[str, ...],
    overrides: Mapping[str, float] | None = None,
) -> np.ndarray:
    """Build the [D] scale-factor vector for a snapshot's resource axis."""
    table = dict(DEFAULT_SCALE_FACTORS)
    if overrides:
        table.update(overrides)
    return np.array([table.get(r, 1.0) for r in resources], np.float32)


def estimate_pod_usage(requests: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Estimated usage of pending pods: ``requests * scale`` ([..., D]),
    on the tensors' device."""
    return requests * scale


#: zero-request floors (default_estimator.go:35-39 DefaultMilliCPURequest /
#: DefaultMemoryRequest = 200*1024*1024 bytes ≡ 200 MiB in snapshot units)
DEFAULT_MILLI_CPU_REQUEST = 250.0
DEFAULT_MEMORY_REQUEST_MIB = 200.0
_DEFAULT_FLOORS: Mapping[str, float] = {
    ext.RES_CPU: DEFAULT_MILLI_CPU_REQUEST,
    ext.RES_BATCH_CPU: DEFAULT_MILLI_CPU_REQUEST,
    ext.RES_MEMORY: DEFAULT_MEMORY_REQUEST_MIB,
    ext.RES_BATCH_MEMORY: DEFAULT_MEMORY_REQUEST_MIB,
}


def estimate_pod(config, pod, scale: np.ndarray) -> np.ndarray:
    """Reference-exact single-pod estimate (``estimatedUsedByResource``,
    ``default_estimator.go:88-123``): base = max(request, limit), scaled
    and rounded, capped at the limit; a dim with neither request nor limit
    estimates at the default floor (250m cpu / 200Mi memory) — an
    unspecified pod is never free. A pod may override individual scaling
    factors via the load-estimated-scaling-factors annotation, in percent
    (``default_estimator.go:60-64``). [D] numpy."""
    custom = ext.parse_custom_estimated_scaling_factors(
        pod.meta.annotations
    )
    if custom:
        scale = np.array(scale, np.float32, copy=True)
        for name, pct in custom.items():
            if name in config.resources:
                scale[config.resources.index(name)] = pct / 100.0
    req = config.res_vector(pod.spec.requests)
    lim = config.res_vector(pod.spec.limits)
    base = np.maximum(req, lim)
    # floor(x+0.5) = Go math.Round for non-negative values (np.round would
    # round half to even — same convention note as masks.usage_percent)
    est = np.floor(base * scale + 0.5)
    est = np.where(lim > 0, np.minimum(est, lim), est)
    # The floor covers only the pod's own tier dims — the reference
    # iterates resourceWeights (cpu, memory) with the resource name
    # translated by priority class (TranslateResourceNameByPriorityClass),
    # so a batch pod floors batch-cpu/batch-memory, everyone else cpu/memory.
    if pod.priority_class == ext.PriorityClass.BATCH:
        tier = (ext.RES_BATCH_CPU, ext.RES_BATCH_MEMORY)
    else:
        tier = (ext.RES_CPU, ext.RES_MEMORY)
    floors = np.array(
        [_DEFAULT_FLOORS.get(r, 0.0) if r in tier else 0.0 for r in config.resources],
        np.float32,
    )
    return np.where(base > 0, est, floors).astype(np.float32)
