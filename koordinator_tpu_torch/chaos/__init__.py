"""Deterministic fault injection for the solve pipeline.

A seedable, zero-overhead-when-disabled fault layer threaded through every
failure domain of the rebuild — the gRPC snapshot channel, the statehub
informers, solver dispatch, the commit path and the koordlet ticks — as
*injectable hooks*, never monkeypatches: each component takes an optional
:class:`FaultInjector` and defaults to the shared :data:`NULL_INJECTOR`,
whose ``fire()`` is a single attribute read (the same discipline as
``obs.trace``'s disabled-mode span singleton).

Gavel (arXiv:2008.09213) and Synergy (arXiv:2110.06073) both observe that
a cluster scheduler's value evaporates if a round can wedge or corrupt
shared state; this module exists to *prove* the recovery paths — the
generation-gap resync, the informer re-list, the solver fallback ladder,
the transactional Reserve journal — under a reproducible fault trace
(same seed ⇒ same trace).

See :mod:`injector` for the mechanism and ``sim.longrun.run_chaos_soak``
for the full composition.
"""

from .injector import (
    NULL_INJECTOR,
    ChaosError,
    FaultInjector,
    FaultSpec,
)

__all__ = [
    "NULL_INJECTOR",
    "ChaosError",
    "FaultInjector",
    "FaultSpec",
]
