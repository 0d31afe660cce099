"""Shadow-policy harness: alternate control policies that can never act.

The ROADMAP's learned-control-plane item requires any candidate policy
to be "always SHADOWED by the deterministic controllers and
decision-logged before it is allowed to act". This module is that
harness: a :class:`ShadowRegistry` attached to a
:class:`obs.decisions.DecisionLedger` holds at most one
:class:`ShadowPolicy` per controller name. Each time the acting
controller records a decision, the shadow is fed a deep COPY of the
SAME input snapshot, its proposal is recorded alongside the acting
decision (``shadow`` annotation on the ledger record,
``shadow_divergence_total{controller}`` on divergence) — and that is
ALL it can do. A shadow has no handle on the controller, receives no
mutable state, and an exception it raises is reported and dropped.
Bit-exactness of the acting decision trace with and without a shadow
attached is a soak assertion (see ``sim/longrun.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

#: sentinel returned by ShadowRegistry.propose when no policy is
#: registered for the controller (distinct from a None proposal, which
#: would be a real — if degenerate — policy output)
NO_PROPOSAL = object()


class ShadowPolicy:
    """Base class for non-acting candidate policies.

    Subclasses implement :meth:`propose`, a PURE function of the
    recorded input snapshot — the same dict the acting controller
    decided from. The returned action dict uses the acting controller's
    action vocabulary so divergence is a plain ``!=``.
    """

    def propose(self, inputs: dict) -> Optional[dict]:
        raise NotImplementedError


class AlwaysDivergeShadow(ShadowPolicy):
    """Trivial always-diverging policy: proposes an action no real
    controller ever emits. Soaks attach it to prove the acting decision
    trace is bit-identical with a maximally-noisy shadow present."""

    def propose(self, inputs: dict) -> dict:
        return {"op": "__shadow_diverge__"}


class MirrorShadow(ShadowPolicy):
    """Replays a pure decide function — proposes exactly what the
    deterministic controller would. Divergence from the acting decision
    is therefore a determinism bug (the live sibling of
    ``tools/decision_replay.py``'s offline check)."""

    def __init__(self, decide):
        self._decide = decide

    def propose(self, inputs: dict) -> dict:
        action, _state = self._decide(inputs)
        return action


class ShadowRegistry:
    """At most one shadow policy per controller name."""

    def __init__(self):
        self._policies: Dict[str, ShadowPolicy] = {}

    def attach(self, controller: str, policy: ShadowPolicy) -> None:
        self._policies[str(controller)] = policy

    def detach(self, controller: str) -> None:
        self._policies.pop(str(controller), None)

    def policies(self) -> Dict[str, ShadowPolicy]:
        return dict(self._policies)

    def propose(self, controller: str, inputs: dict):
        """Proposal for one controller, or NO_PROPOSAL when no policy
        is registered. Exceptions propagate — the LEDGER is the layer
        that contains shadow failures (report_exception + drop), so the
        harness stays honest under test."""
        policy = self._policies.get(str(controller))
        if policy is None:
            return NO_PROPOSAL
        return policy.propose(inputs)
