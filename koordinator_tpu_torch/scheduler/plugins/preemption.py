"""Priority-based preemption (the reservation plugin's PostFilter).

Rebuild of ``pkg/scheduler/plugins/reservation/preemption.go:105-250``:
when a pod fails scheduling, candidate nodes are evaluated by the
kube DefaultPreemption algorithm with Koordinator's non-preemptible
extension — remove ALL lower-priority preemptible pods from the node,
check the incoming pod fits, then reprieve victims most-important-first
while it still fits. Reserve (ghost) pods flow through the same path, so
reservations can preempt too, exactly like the reference delegating the
preemption evaluator through the reservation plugin. Gated by
``ReservationArgs.EnablePreemption`` (default false,
``apis/config/v1beta3/defaults.go:52``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ...api.types import Pod
from .elasticquota import is_pod_non_preemptible


def _more_important(pod: Pod) -> Tuple[int, str]:
    """Reference ``util.MoreImportantPod`` sort key: higher priority
    first; name as the stable tiebreak (creation time analog)."""
    return (-(pod.spec.priority or 0), pod.meta.uid)


class PriorityPreemptor:
    """Select minimal lower-priority victim sets per node."""

    def __init__(self, scheduler: "BatchScheduler"):
        self.scheduler = scheduler

    def select_victims(
        self, pod: Pod
    ) -> Optional[Tuple[str, List[Pod]]]:
        """(node, victims) for the cheapest feasible priority preemption,
        or None. Mirrors SelectVictimsOnNode: victims must be strictly
        lower priority AND preemptible; candidate nodes are ranked by
        fewest victims (the preemption evaluator's candidate ranking)."""
        sched = self.scheduler
        snap = sched.snapshot
        prio = pod.spec.priority or 0
        req = snap.config.res_vector(pod.spec.requests)

        by_node: Dict[str, List[Pod]] = {}
        for uid, node in sched._bound_nodes.items():
            if uid not in snap._assumed:
                continue
            victim = sched._bound_pods.get(uid)
            if victim is None:
                continue
            if (victim.spec.priority or 0) >= prio:
                continue
            if is_pod_non_preemptible(victim):
                continue
            by_node.setdefault(node, []).append(victim)

        best: Optional[Tuple[str, List[Pod]]] = None
        for node, potential in by_node.items():
            if not sched.node_allowed(pod, node):
                continue
            idx = snap.node_id(node)
            if idx is None or not snap.nodes.schedulable[idx]:
                continue
            freed = np.zeros_like(req)
            for v in potential:
                ap = snap._assumed.get(v.meta.uid)
                if ap is not None:
                    freed = freed + ap.request
            headroom = (
                snap.nodes.allocatable[idx]
                - snap.nodes.requested[idx]
                + freed
            )
            if not np.all(req <= headroom + 1e-3):
                continue  # does not fit even with every victim gone
            # reprieve as many as possible, most important first
            victims: List[Pod] = []
            room = headroom
            for v in sorted(potential, key=_more_important):
                ap = snap._assumed.get(v.meta.uid)
                charge = ap.request if ap is not None else 0.0
                if np.all(req <= room - charge + 1e-3):
                    room = room - charge  # reprieved: stays on the node
                else:
                    victims.append(v)
            if not victims:
                continue  # pod actually fits without evicting (race)
            if best is None or len(victims) < len(best[1]):
                best = (node, victims)
        return best
