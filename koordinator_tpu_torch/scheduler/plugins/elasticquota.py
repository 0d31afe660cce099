"""ElasticQuota host-side manager: hierarchical quota tree + fair sharing.

Rebuild of the reference's GroupQuotaManager
(``pkg/scheduler/plugins/elasticquota/core/group_quota_manager.go:37-95``)
and RuntimeQuotaCalculator (``core/runtime_quota_calculator.go``): quotas
form trees via the ``quota.scheduling.koordinator.sh/parent`` label; each
parent's runtime is distributed to children as

    runtime = guaranteed(min ∧ request) + weighted fair share of the
              remainder (sharedWeight), capped by max ∧ request

via iterative water-filling (children hitting their cap release surplus to
the rest — the reference's refreshRuntime loop). Admission (used + request
≤ runtime along the chain) runs vectorized inside the solver
(``ops.solver._quota_commit``); this class owns the tree, the runtime
refresh, and durable used accounting.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ...api import extension as ext
from ...api.types import ElasticQuota, Pod
from ...core.snapshot import SnapshotConfig

#: maximum quota tree depth lowered to the solver (leaf..root)
MAX_LEVELS = 4
ROOT = ""  # pseudo-parent of tree roots


def quota_name_of(pod: Pod) -> Optional[str]:
    return pod.meta.labels.get(ext.LABEL_QUOTA_NAME)


def scale_mins_over_root(
    mins: np.ndarray,
    scale_enabled: np.ndarray,
    total: np.ndarray,
) -> np.ndarray:
    """Proportionally shrink sibling min quotas when they oversubscribe the
    parent's capacity (reference
    ``core/scale_minquota_when_over_root_res.go:123-184``): on each dim where
    Σ children-min > total, scale-disabled children keep their original min
    and scale-enabled children split ``max(total - Σ disabled-min, 0)``
    proportionally to their original min.

    ``mins`` [C, D], ``scale_enabled`` [C] bool, ``total`` [D] → scaled [C, D].
    """
    mins = np.asarray(mins, np.float32)
    en = np.asarray(scale_enabled, bool)[:, None]
    need = mins.sum(axis=0) > np.asarray(total, np.float32) + 1e-6  # [D]
    if not need.any():
        return mins
    disabled_sum = np.where(en, 0.0, mins).sum(axis=0)
    enabled_sum = np.where(en, mins, 0.0).sum(axis=0)
    avail = np.maximum(total - disabled_sum, 0.0)
    factor = np.where(enabled_sum > 1e-9, avail / np.maximum(enabled_sum, 1e-9), 0.0)
    return np.where(need[None, :] & en, mins * factor, mins).astype(np.float32)


def water_fill(
    total: np.ndarray,
    guaranteed: np.ndarray,
    caps: np.ndarray,
    weights: np.ndarray,
) -> np.ndarray:
    """Distribute ``total`` [D] among C children with the reference's
    ``quotaTree.redistribution`` / ``iterationForRedistribution`` semantics
    exactly: every child starts at ``guaranteed`` [C, D] (= min(min,
    limited-request)); children still wanting more (cap > guaranteed) split
    the remainder by shared weight with each round's delta ROUNDED to an
    integer (``int64(w·total/totalW + 0.5)``); a child hitting its cap
    (= limited request, min(max, request)) returns its excess to the next
    round, which runs over the still-unsatisfied set only. Verified against
    ``runtime_quota_calculator_test.go`` IterationAdjustQuota (case 1:
    weights 40/60/50/80, requests 5/20/40/70, mins 10/15/20/15, total 100
    → 5/20/35/40 — continuous water-filling would give 35.38/39.62)."""
    c, d = guaranteed.shape
    out = np.minimum(guaranteed, caps).astype(np.float64)
    caps64 = caps.astype(np.float64)
    for dim in range(d):
        runtime = out[:, dim].copy()
        cap = caps64[:, dim]
        w = np.maximum(weights[:, dim].astype(np.float64), 0.0)
        adjust = cap > runtime
        to_part = float(total[dim]) - runtime.sum()
        while to_part > 0 and adjust.any():
            tw = w[adjust].sum()
            if tw <= 0:
                break
            delta = np.where(
                adjust, np.floor(w * to_part / tw + 0.5), 0.0
            )
            runtime = runtime + delta
            over = np.maximum(runtime - cap, 0.0)
            to_part = float(over.sum())
            runtime = np.minimum(runtime, cap)
            adjust = adjust & (runtime < cap)
        out[:, dim] = runtime
    return out.astype(np.float32)


@dataclasses.dataclass
class _QuotaNode:
    quota: ElasticQuota
    index: int
    children: List[str] = dataclasses.field(default_factory=list)


class GroupQuotaManager:
    """Quota tree with fair-share runtime refresh and used accounting."""

    def __init__(
        self,
        config: Optional[SnapshotConfig] = None,
        cluster_total: Optional[Mapping[str, float]] = None,
        tree_id: str = "",
        scale_min_enabled: bool = False,
        enable_preemption: bool = True,
        disable_default_quota_preemption: bool = True,
    ):
        self.config = config or SnapshotConfig()
        self.tree_id = tree_id
        #: gate for min-quota scaling when Σ sibling mins > parent capacity
        #: (reference group_quota_manager.go:52 scaleMinQuotaEnabled)
        self.scale_min_enabled = scale_min_enabled
        #: batch-failure PostFilter preemption (reference preempt.go); the
        #: reference plugin always registers PostFilter — the config
        #: decode can still switch it off per deployment
        self.enable_preemption = enable_preemption
        #: never victimize pods in the default quota (reference
        #: ``DisableDefaultQuotaPreemption``, defaults true in v1beta3)
        self.disable_default_quota_preemption = disable_default_quota_preemption
        self._nodes: Dict[str, _QuotaNode] = {}
        self._order: List[str] = []
        #: leaf quota name → {pod uid: Pod} of admitted pods (reference
        #: quota_info.go:550 GetPodThatIsAssigned)
        self._assigned: Dict[str, Dict[str, "Pod"]] = {}
        self._cluster_total = self.config.res_vector(cluster_total or {})
        d = self.config.dims
        self.runtime = np.zeros((1, d), np.float32)
        self.used = np.zeros((1, d), np.float32)
        self.requests = np.zeros((1, d), np.float32)
        #: uncapped Σ of children's requests per quota (the reference's
        #: ChildRequest; ``requests`` holds the max-capped propagation)
        self.child_requests = np.zeros((1, d), np.float32)
        #: non-preemptible pods' admitted usage, tracked separately: such
        #: pods must fit inside quota MIN, not runtime (reference
        #: ``quota_info.go:49-56`` + ``plugin.go:252-262`` PreFilter)
        self.nonpre_used = np.zeros((1, d), np.float32)
        #: non-preemptible pods' rolled-up requests (status stamping)
        self.nonpre_requests = np.zeros((1, d), np.float32)
        self._dirty = True
        #: bumped whenever the SOLVER-VISIBLE tables (runtime / used /
        #: nonpre_used / mins) actually change — the scheduler keys its
        #: device-resident QuotaState upload off it, so a cycle whose
        #: quota accounting didn't move re-uses the resident copy
        self.state_version = 0
        #: bumped ONLY on tree mutations (upsert/remove) — unlike
        #: ``state_version`` it is untouched by per-cycle charges, so
        #: the pipeline's speculative solves use it to prove the quota
        #: chains they lowered (leaf-to-root index paths) still describe
        #: the live tree at consume time (open-the-gates PR)
        self.tree_version = 0
        #: memoized leaf-to-root index paths; rebuilt on tree mutations
        #: (chain_of was a visible slice of the per-winner commit loop)
        self._chain_cache: Dict[str, List[int]] = {}
        #: name -> lowered [MAX_LEVELS] chain row (chains_for_names)
        self._chain_row_cache: Dict[str, np.ndarray] = {}

    # ---- tree maintenance ----

    def upsert_quota(self, eq: ElasticQuota) -> None:
        name = eq.meta.name
        # label protocol: allow-lent-resource=false pins the full min
        # (quotaNode.AllowLentResource; the typed field wins when the
        # label is absent)
        if eq.meta.labels.get(ext.LABEL_QUOTA_ALLOW_LENT) == "false":
            eq.allow_lent_resource = False
        # wire spelling of the competition weight (AnnotationSharedWeight,
        # ``elastic_quota.go:95-105`` GetSharedWeight): a valid non-zero
        # JSON resource list overrides; otherwise the typed field (and
        # ultimately max) stands
        wire_weight = ext.parse_quota_shared_weight(eq.meta.annotations)
        if wire_weight is not None:
            eq.shared_weight = wire_weight
        node = self._nodes.get(name)
        if node is None:
            node = _QuotaNode(quota=eq, index=len(self._order))
            self._nodes[name] = node
            self._order.append(name)
        else:
            old_parent = node.quota.parent
            if old_parent != eq.parent and old_parent in self._nodes:
                self._nodes[old_parent].children.remove(name)
            node.quota = eq
        parent = eq.parent or ROOT
        if parent != ROOT:
            pnode = self._nodes.get(parent)
            if pnode is not None and name not in pnode.children:
                pnode.children.append(name)
        # adopt any pre-registered children pointing at us
        for other, onode in self._nodes.items():
            if (onode.quota.parent or ROOT) == name and other not in node.children:
                node.children.append(other)
        self._dirty = True
        self.state_version += 1
        self.tree_version += 1
        self._chain_cache.clear()
        self._chain_row_cache.clear()

    def remove_quota(self, name: str) -> None:
        node = self._nodes.pop(name, None)
        if node is None:
            return
        old_index = {n: self._nodes[n].index for n in self._nodes}
        old_index[name] = node.index
        self._order.remove(name)
        q = max(len(self._order), 1)
        d = self.config.dims
        new_used = np.zeros((q, d), np.float32)
        new_req = np.zeros((q, d), np.float32)
        new_child = np.zeros((q, d), np.float32)
        new_nonpre = np.zeros((q, d), np.float32)
        new_nonpre_req = np.zeros((q, d), np.float32)
        for new_i, nm in enumerate(self._order):
            n = self._nodes[nm]
            if name in n.children:
                n.children.remove(name)
            oi = old_index[nm]
            if oi < self.used.shape[0]:
                new_used[new_i] = self.used[oi]
            if oi < self.requests.shape[0]:
                new_req[new_i] = self.requests[oi]
            if oi < self.child_requests.shape[0]:
                new_child[new_i] = self.child_requests[oi]
            if oi < self.nonpre_used.shape[0]:
                new_nonpre[new_i] = self.nonpre_used[oi]
            if oi < self.nonpre_requests.shape[0]:
                new_nonpre_req[new_i] = self.nonpre_requests[oi]
            n.index = new_i
        self._chain_cache.clear()
        self._chain_row_cache.clear()
        self.used, self.requests = new_used, new_req
        self.child_requests = new_child
        self.nonpre_used = new_nonpre
        self.nonpre_requests = new_nonpre_req
        self._dirty = True
        self.state_version += 1
        self.tree_version += 1

    def set_cluster_total(self, total: Mapping[str, float]) -> None:
        """Explicit capacity budget (the multi-tree handler gives each tree
        its slice this way). Disables snapshot auto-sync."""
        self._cluster_total = self.config.res_vector(total)
        self._explicit_total = True
        self._dirty = True

    def sync_cluster_total(self, snapshot) -> None:
        """Track the cluster's aggregate allocatable as the fair-sharing
        budget (the reference GroupQuotaManager recomputes its total from
        node add/update/delete events, ``group_quota_manager.go``). No-op
        once an explicit total was set (multi-tree budgets own it then)."""
        if getattr(self, "_explicit_total", False):
            return
        total = snapshot.nodes.allocatable.sum(axis=0).astype(np.float32)
        if not np.array_equal(total, self._cluster_total):
            self._cluster_total = total
            self._dirty = True

    def update_cluster_total(self, delta: np.ndarray) -> None:
        """Shift capacity by a delta vector (multi-tree rebalancing —
        reference quota_handler.go:324 UpdateClusterTotalResource)."""
        self._cluster_total = np.maximum(self._cluster_total + delta, 0.0).astype(
            np.float32
        )
        self._dirty = True

    @property
    def cluster_total(self) -> np.ndarray:
        return self._cluster_total

    def index_of(self, name: str) -> Optional[int]:
        node = self._nodes.get(name)
        return node.index if node else None

    def chain_of(self, name: Optional[str]) -> List[int]:
        """Leaf-to-root index path for a pod's quota label (≤ MAX_LEVELS)."""
        if not name:
            return []
        cached = self._chain_cache.get(name)
        if cached is not None:
            return cached
        chain: List[int] = []
        key = name
        while name and name in self._nodes and len(chain) < MAX_LEVELS:
            node = self._nodes[name]
            chain.append(node.index)
            name = node.quota.parent or None
        if key in self._nodes:
            self._chain_cache[key] = chain
        return chain

    @property
    def quota_count(self) -> int:
        return len(self._order)

    # ---- accounting ----

    def _ensure_capacity(self) -> None:
        q = max(self.quota_count, 1)
        d = self.config.dims
        for attr in ("used", "requests", "runtime", "child_requests", "nonpre_used", "nonpre_requests"):
            arr = getattr(self, attr)
            if arr.shape[0] < q:
                grown = np.zeros((q, d), np.float32)
                grown[: arr.shape[0]] = arr
                setattr(self, attr, grown)
                self.state_version += 1

    def headroom_in(
        self,
        quota_name: str,
        vec: np.ndarray,
        non_preemptible: bool,
        used: np.ndarray,
        nonpre: np.ndarray,
        runtime: np.ndarray,
    ) -> bool:
        """The chain-walk admission arithmetic of :meth:`has_headroom`
        against CALLER-SUPPLIED ledgers — the single source of truth
        shared by the live check and the pipeline's pure fast-path
        preview (open the last gates PR). A drift between the two would
        make predicted fast-path binds silently diverge from real ones
        (every reservation speculation discarding with no failing test),
        so there must be exactly ONE copy of this arithmetic."""
        chain = self.chain_of(quota_name)
        for idx in chain:
            if idx < used.shape[0] and np.any(
                used[idx] + vec > runtime[idx] + 1e-3
            ):
                return False
        if non_preemptible and chain:
            leaf_min = self.config.res_vector(
                self._nodes[quota_name].quota.min
            )
            if np.any(nonpre[chain[0]] + vec > leaf_min + 1e-3):
                return False
        return True

    def charge_in(
        self,
        quota_name: str,
        vec: np.ndarray,
        non_preemptible: bool,
        used: np.ndarray,
        nonpre: np.ndarray,
    ) -> bool:
        """The chain-walk charge arithmetic of :meth:`charge` against
        caller-supplied ledgers (shared with the preview — same rule as
        :meth:`headroom_in`). Returns whether anything was charged."""
        chain = self.chain_of(quota_name)
        for idx in chain:
            if idx < used.shape[0]:
                used[idx] += vec
        if non_preemptible and chain:
            # leaf-only ledger: admission checks min at the LEAF
            # (plugin.go:252-262); parents roll up at stamping time
            nonpre[chain[0]] += vec
        return bool(chain)

    def has_headroom(
        self,
        quota_name: str,
        requests: Mapping[str, float],
        non_preemptible: bool = False,
    ) -> bool:
        """used + request ≤ runtime along the whole chain (host-side mirror
        of the solver's admission for bypass paths like reservations); a
        non-preemptible pod additionally fits nonPreemptibleUsed + request
        inside the LEAF's min (plugin.go:252-262)."""
        self._ensure_capacity()
        if self._dirty:
            self.refresh_runtime()
        return self.headroom_in(
            quota_name,
            self.config.res_vector(requests),
            non_preemptible,
            self.used,
            self.nonpre_used,
            self.runtime,
        )

    def charge(
        self,
        quota_name: str,
        requests: Mapping[str, float],
        vec: Optional[np.ndarray] = None,
        non_preemptible: bool = False,
    ) -> None:
        self._ensure_capacity()
        if vec is None:
            vec = self.config.res_vector(requests)
        if self.charge_in(
            quota_name, vec, non_preemptible, self.used, self.nonpre_used
        ):
            self.state_version += 1

    def refund(
        self,
        quota_name: str,
        requests: Mapping[str, float],
        non_preemptible: bool = False,
    ) -> None:
        self._ensure_capacity()
        vec = self.config.res_vector(requests)
        chain = self.chain_of(quota_name)
        for idx in chain:
            self.used[idx] -= vec
        if non_preemptible and chain:
            self.nonpre_used[chain[0]] = np.maximum(
                self.nonpre_used[chain[0]] - vec, 0.0
            )
        if chain:
            self.state_version += 1

    def reset_usage(self) -> None:
        """Zero all used charges and assigned-pod records (full-resync
        path: the world state is being replaced wholesale)."""
        self.used[:] = 0.0
        self.nonpre_used[:] = 0.0
        self._assigned.clear()
        self._dirty = True
        self.state_version += 1

    def assign_pod(
        self,
        quota_name: str,
        pod: "Pod",
        vec: Optional[np.ndarray] = None,
    ) -> None:
        """Charge the chain and remember the pod at its leaf quota so the
        overuse-revoke controller can pick eviction victims. ``vec`` is the
        pod's already-lowered request row (skips a per-winner res_vector)."""
        self.charge(
            quota_name,
            pod.spec.requests,
            vec=vec,
            non_preemptible=is_pod_non_preemptible(pod),
        )
        self.record_assigned(quota_name, pod)

    def record_assigned(self, quota_name: str, pod: "Pod") -> None:
        """Remember a pod at its leaf without charging (the batched commit
        charges once per leaf via ``charge`` with a summed vector)."""
        self._assigned.setdefault(quota_name, {})[pod.meta.uid] = pod

    def name_of_index(self, idx: int) -> Optional[str]:
        """Quota name for a lowered chain index (inverse of index_of)."""
        return self._order[idx] if 0 <= idx < len(self._order) else None

    def charge_rows(self, chains: np.ndarray, vecs: np.ndarray) -> None:
        """Vectorized charge for a batch of pods: ``chains`` [B, L] are
        lowered leaf-to-root index paths (−1 padding), ``vecs`` [B, D]
        the request rows. One sort+reduceat scatter replaces B·L
        per-level ``used[idx] += vec`` updates (the per-pod chain walk
        was a visible slice of the quota scenario's commit)."""
        if chains.size == 0:
            return
        self._ensure_capacity()
        levels = chains.shape[1]
        flat = chains.reshape(-1)
        sel = flat >= 0
        if not sel.any():
            return
        idxs = flat[sel]
        rows = np.repeat(vecs, levels, axis=0)[sel]
        perm = np.argsort(idxs, kind="stable")
        si = idxs[perm]
        sr = rows[perm]
        starts = np.nonzero(np.r_[True, si[1:] != si[:-1]])[0]
        sums = np.add.reduceat(sr, starts, axis=0)
        heads = si[starts]
        q = self.used.shape[0]
        # shadow indices (≥ Q, from the extended solver table) route to
        # the non-preemptible ledger; real indices to used
        real = heads < q
        if real.any():
            self.used[heads[real]] += sums[real]
        if (~real).any():
            self.nonpre_used[heads[~real] - q] += sums[~real]
        self.state_version += 1

    def unassign_pod(self, quota_name: str, pod: "Pod") -> None:
        if self._assigned.get(quota_name, {}).pop(pod.meta.uid, None) is not None:
            self.refund(
                quota_name,
                pod.spec.requests,
                non_preemptible=is_pod_non_preemptible(pod),
            )

    def pods_assigned(self, quota_name: str) -> List["Pod"]:
        return list(self._assigned.get(quota_name, {}).values())

    def all_quota_names(self) -> List[str]:
        return list(self._order)

    def headroom_clears(self, pod: "Pod") -> bool:
        """Whether the pod's quota chain has headroom for its request
        (used + req ≤ runtime at every level). True also for pods with no
        (known) quota. Callers use this to tell quota-caused scheduling
        failures from node-fit ones — when a sampled node window was
        active and the chain clears, a failure is (possibly transient)
        node fit, and quota preemption would be premature
        (upstream preemption runs only after a full feasibility scan)."""
        leaf = quota_name_of(pod)
        if leaf is None or self.index_of(leaf) is None:
            return True
        self.runtime_and_used_of(leaf)  # refresh runtime if dirty
        req = self.config.res_vector(pod.spec.requests)
        for idx in self.chain_of(leaf):
            if np.any(self.used[idx] + req > self.runtime[idx] + 1e-3):
                return False
        return True

    def runtime_and_used_of(self, quota_name: str) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_capacity()
        if self._dirty:
            self.refresh_runtime()
        idx = self._nodes[quota_name].index
        return self.runtime[idx], self.used[idx]

    def set_leaf_requests(self, by_leaf: Mapping[str, np.ndarray]) -> None:
        """Aggregate desired request per quota (pending + admitted), rolled
        up the tree — drives the fair-sharing split like the reference's
        request propagation (``group_quota_manager.go:196-224``
        recursiveUpdateGroupTreeWithDeltaRequest). What travels upward is
        each quota's **limitRequest = min(request, max)**: a child
        demanding over its own max must not inflate its parent's share of
        the grandparent's pool. ``child_requests`` keeps the uncapped sum
        (the reference's ChildRequest annotation)."""
        req, child_req = self._propagate_requests(by_leaf)
        self.requests = req
        self.child_requests = child_req
        self._dirty = True

    def _propagate_requests(
        self, by_leaf: Mapping[str, np.ndarray]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The pure propagation behind :meth:`set_leaf_requests` —
        shared verbatim with the pipeline's speculative PREVIEW
        (:meth:`preview_arrays_extended`), which must reproduce the
        mutating path bit-exactly without touching manager state."""
        q = max(self.quota_count, 1)
        d = self.config.dims
        req = np.zeros((q, d), np.float32)
        child_req = np.zeros((q, d), np.float32)

        def visit(name: str) -> np.ndarray:
            node = self._nodes[name]
            idx = node.index
            # a quota's direct pod demand (the reference's SelfRequest) —
            # pods may target non-leaf quotas too, so every level reads
            # its own by_leaf entry on top of the children's propagation
            vec = by_leaf.get(name)
            cr = (
                np.asarray(vec, np.float32)
                if vec is not None
                else np.zeros(d, np.float32)
            )
            for c in node.children:
                cr = cr + visit(c)
            child_req[idx] = cr
            r = cr
            if not node.quota.allow_lent_resource:
                # request never drops below min: the unlent guarantee is
                # always demanded from the parent (reference :208-221)
                r = np.maximum(r, self.config.res_vector(node.quota.min))
            req[idx] = r
            maxv = self.config.res_vector(node.quota.max)
            maxv = np.where(maxv <= 0, np.inf, maxv)
            return np.minimum(r, maxv).astype(np.float32)

        for n in self._order:
            if (self._nodes[n].quota.parent or ROOT) == ROOT:
                visit(n)
        return req, child_req

    # ---- runtime refresh (water-filling down the tree) ----

    def refresh_runtime(self) -> np.ndarray:
        self._ensure_capacity()
        runtime = self._compute_runtime(self.requests, self._cluster_total)
        if runtime.shape != self.runtime.shape or not np.array_equal(
            runtime, self.runtime
        ):
            # only a VALUE change invalidates the device-resident quota
            # table — steady-state refreshes (same demand, same capacity)
            # keep the resident copy valid
            self.state_version += 1
        self.runtime = runtime
        self._dirty = False
        return runtime

    def _compute_runtime(
        self, requests: np.ndarray, total: np.ndarray
    ) -> np.ndarray:
        """The pure water-fill behind :meth:`refresh_runtime`, shared
        with the speculative preview (same code, same rounding — the
        preview's bit-exactness against the later real refresh is what
        lets a kept speculation claim decision identity)."""
        q = max(self.quota_count, 1)
        d = self.config.dims
        runtime = np.zeros((q, d), np.float32)
        roots = [
            n for n in self._order if (self._nodes[n].quota.parent or ROOT) == ROOT
        ]
        self._fill_level(roots, total, runtime, requests)
        return runtime

    def preview_arrays_extended(
        self, by_leaf: Mapping[str, np.ndarray], total: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """PURE preview of :meth:`quota_arrays_extended` as a future
        cycle carrying ``by_leaf`` pending demand would see it — no
        manager state is touched (open-the-gates PR: the pipeline's
        speculative dispatch runs while the PREVIOUS cycle's PostFilter
        still reads the live requests/runtime, so the real mutating
        propagation must wait for consume time). Returns
        ``(runtime_ext, used_ext)`` with the same shadow-row doubling as
        the real lowering; the consuming cycle re-runs the mutating path
        and keeps the speculation only when the tables match bit-exactly."""
        self._ensure_capacity()
        req, _child = self._propagate_requests(by_leaf)
        runtime = self._compute_runtime(req, np.asarray(total, np.float32))
        if self.quota_count == 0:
            d = self.config.dims
            return (
                np.full((1, d), np.inf, np.float32),
                np.zeros((1, d), np.float32),
            )
        return (
            np.concatenate([runtime, self.mins_array()]),
            np.concatenate([self.used, self.nonpre_used[: runtime.shape[0]]]),
        )

    def effective_cluster_total(self, snapshot) -> np.ndarray:
        """The fair-sharing budget :meth:`sync_cluster_total` WOULD adopt
        for ``snapshot`` — computed without mutating (preview side)."""
        if getattr(self, "_explicit_total", False):
            return self._cluster_total
        return snapshot.nodes.allocatable.sum(axis=0).astype(np.float32)

    def _fill_level(
        self,
        names: Sequence[str],
        total: np.ndarray,
        runtime: np.ndarray,
        requests: Optional[np.ndarray] = None,
    ) -> None:
        if not names:
            return
        idxs = [self._nodes[n].index for n in names]
        mins = np.stack(
            [self.config.res_vector(self._nodes[n].quota.min) for n in names]
        )
        maxs = np.stack(
            [self.config.res_vector(self._nodes[n].quota.max) for n in names]
        )
        maxs = np.where(maxs <= 0, np.inf, maxs)  # absent max = unbounded
        weights = np.stack(
            [
                self.config.res_vector(self._nodes[n].quota.shared_weight)
                for n in names
            ]
        )
        # absent sharedWeight defaults to max (reference getSharedWeight)
        weights = np.where(weights <= 0, np.where(np.isinf(maxs), 1.0, maxs), weights)
        if self.scale_min_enabled:
            mins = scale_mins_over_root(
                mins, np.ones(len(names), bool), total
            )
        if requests is None:
            requests = self.requests
        level_requests = requests[idxs]
        guaranteed = np.minimum(mins, level_requests)
        # allow-lent-resource=false: the quota's UNUSED min is never lent
        # to siblings — the full min stays reserved regardless of demand
        # (reference quotaNode.AllowLentResource in the redistribution)
        lent_ok = np.asarray(
            [self._nodes[n].quota.allow_lent_resource for n in names], bool
        )
        guaranteed = np.where(lent_ok[:, None], guaranteed, mins)
        caps = np.maximum(np.minimum(maxs, level_requests), guaranteed)
        shares = water_fill(total, guaranteed, caps, weights)
        for row, n in enumerate(names):
            runtime[self._nodes[n].index] = shares[row]
            kids = self._nodes[n].children
            if kids:
                self._fill_level(kids, shares[row], runtime, requests)

    # ---- solver lowering ----

    def quota_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """(runtime [Q, D], used [Q, D]) for ops.solver.QuotaState."""
        if self._dirty:
            self.refresh_runtime()
        if self.quota_count == 0:
            d = self.config.dims
            return np.full((1, d), np.inf, np.float32), np.zeros((1, d), np.float32)
        return self.runtime, self.used

    def mins_array(self) -> np.ndarray:
        """[Q, D] min vectors in index order (0 where unset)."""
        self._ensure_capacity()
        q = max(self.quota_count, 1)
        d = self.config.dims
        out = np.zeros((q, d), np.float32)
        for name in self._order:
            node = self._nodes[name]
            out[node.index] = self.config.res_vector(node.quota.min)
        return out

    def quota_arrays_extended(self) -> Tuple[np.ndarray, np.ndarray]:
        """Doubled quota table for the solver: rows 0..Q-1 are the real
        quotas (runtime/used); rows Q..2Q-1 are each quota's SHADOW whose
        runtime is the quota's MIN and whose used is the non-preemptible
        ledger. A non-preemptible pod's chain gains its leaf's shadow
        index, so the solver's ordinary cumulative chain admission
        enforces ``nonPreemptibleUsed + req ≤ min`` in-batch — the
        reference's PreFilter check (``plugin.go:252-262``) with no extra
        device pass."""
        runtime, used = self.quota_arrays()
        if self.quota_count == 0:
            return runtime, used
        return (
            np.concatenate([runtime, self.mins_array()]),
            np.concatenate([used, self.nonpre_used[: runtime.shape[0]]]),
        )

    def guaranteed_allocated(self) -> Tuple[np.ndarray, np.ndarray]:
        """Bottom-up guaranteed/allocated pass (reference
        ``elasticquota/core/quota_info.go:62-67`` +
        ``group_quota_manager.go:1350-1352``): a leaf's allocated is its
        admitted pod usage; every quota's guaranteed = max(allocated, min);
        a parent's allocated = Σ children's guaranteed."""
        self._ensure_capacity()
        if self._dirty:
            self.refresh_runtime()
        q = max(self.quota_count, 1)
        d = self.config.dims
        allocated = np.zeros((q, d), np.float32)
        guaranteed = np.zeros((q, d), np.float32)

        def visit(name: str) -> np.ndarray:
            node = self._nodes[name]
            idx = node.index
            if node.children:
                alloc = np.zeros(d, np.float32)
                child_used = np.zeros(d, np.float32)
                for child in node.children:
                    alloc = alloc + visit(child)
                    child_used += self.used[self._nodes[child].index]
                # a parent's own DIRECT pod usage (pods labeled with the
                # parent itself — this tree supports them) counts too:
                # used[parent] is the chain rollup, so self-used is the
                # difference vs the children's rolled-up used
                alloc = alloc + np.maximum(self.used[idx] - child_used, 0.0)
            else:
                alloc = self.used[idx].copy()
            allocated[idx] = alloc
            guaranteed[idx] = np.maximum(
                alloc, self.config.res_vector(node.quota.min)
            )
            return guaranteed[idx]

        for n in self._order:
            if (self._nodes[n].quota.parent or ROOT) == ROOT:
                visit(n)
        return guaranteed, allocated

    def sync_status(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """The quota controller's status sync (reference
        ``elasticquota/controller.go:160-180`` Start → syncHandler,
        updateElasticQuotaStatusIfChanged): stamps runtime / request /
        child-request / guaranteed / allocated annotations onto every
        quota object and returns {name: {"runtime": .., "request": ..,
        "used": .., ...}} for callers that publish status elsewhere."""
        import json as _json

        if self._dirty:
            self.refresh_runtime()
        res = self.config.resources
        report: Dict[str, Dict[str, Dict[str, float]]] = {}
        guaranteed, allocated = self.guaranteed_allocated()

        def table(row: np.ndarray) -> Dict[str, float]:
            return {
                res[d]: float(row[d]) for d in range(len(res)) if row[d] > 0
            }

        for name in self._order:
            node = self._nodes[name]
            idx = node.index
            # uncapped Σ of children's demand (AnnotationChildRequest) vs
            # the max-capped ``request`` — distinct when a child demands
            # over its own max
            child_req = (
                self.child_requests[idx]
                if idx < self.child_requests.shape[0]
                else self.requests[idx]
            )
            summary = {
                "runtime": table(self.runtime[idx]),
                "request": table(self.requests[idx]),
                "used": table(self.used[idx]),
                "childRequest": table(child_req),
                "guaranteed": table(guaranteed[idx]),
                "allocated": table(allocated[idx]),
            }
            report[name] = summary
            ann = node.quota.meta.annotations
            ann[ext.ANNOTATION_QUOTA_RUNTIME] = _json.dumps(
                summary["runtime"]
            )
            ann[ext.ANNOTATION_QUOTA_REQUEST] = _json.dumps(
                summary["request"]
            )
            ann[ext.ANNOTATION_QUOTA_CHILD_REQUEST] = _json.dumps(
                summary["childRequest"]
            )
            ann[ext.ANNOTATION_QUOTA_GUARANTEED] = _json.dumps(
                summary["guaranteed"]
            )
            ann[ext.ANNOTATION_QUOTA_ALLOCATED] = _json.dumps(
                summary["allocated"]
            )
            # non-preemptible ledger (AnnotationNonPreemptibleUsed /
            # ...Request, quota_info.go:49-56): leaf values are direct;
            # parents roll their subtree up
            np_used = self._rollup(self.nonpre_used, name)
            np_req = self._rollup(self.nonpre_requests, name)
            summary["nonPreemptibleUsed"] = table(np_used)
            summary["nonPreemptibleRequest"] = table(np_req)
            ann[ext.ANNOTATION_QUOTA_NON_PREEMPTIBLE_USED] = _json.dumps(
                summary["nonPreemptibleUsed"]
            )
            ann[ext.ANNOTATION_QUOTA_NON_PREEMPTIBLE_REQUEST] = _json.dumps(
                summary["nonPreemptibleRequest"]
            )
        return report

    def _rollup(self, leaf_array: np.ndarray, name: str) -> np.ndarray:
        """Subtree sum of a leaf-tracked ledger."""
        node = self._nodes[name]
        total = leaf_array[node.index].copy()
        for child in node.children:
            total += self._rollup(leaf_array, child)
        return total

    def chains_for_pods(self, pods: Sequence[Pod], p_bucket: int) -> np.ndarray:
        return self.chains_for_names(
            [quota_name_of(p) for p in pods], p_bucket
        )

    def chains_for_names(
        self, names: Sequence[Optional[str]], p_bucket: int
    ) -> np.ndarray:
        """Lowered chain rows from pre-collected quota labels. Clusters
        have few distinct quotas, so rows are built once per distinct
        name (memoized alongside the index-path cache) and scattered —
        the per-pod ``chain_of`` walk was a visible slice of large quota
        batches. Rows are MAX_LEVELS+1 wide: the extra column is ALWAYS
        free for a non-preemptible pod's shadow-leaf index, so the MIN
        bound can never silently go unenforced on a full-depth chain."""
        chains = np.full((p_bucket, MAX_LEVELS + 1), -1, np.int32)
        cache = self._chain_row_cache
        groups: Dict[str, List[int]] = {}
        for i, nm in enumerate(names):
            if nm is None:
                continue
            lst = groups.get(nm)
            if lst is None:
                groups[nm] = [i]
            else:
                lst.append(i)
        for nm, idxs in groups.items():
            row = cache.get(nm)
            if row is None:
                row = np.full((MAX_LEVELS + 1,), -1, np.int32)
                for level, idx in enumerate(self.chain_of(nm)[:MAX_LEVELS]):
                    row[level] = idx
                cache[nm] = row
            chains[idxs] = row
        return chains


# ---------------------------------------------------------------------------
# Overuse revoke (reference quota_overuse_revoke.go)
# ---------------------------------------------------------------------------


def is_pod_non_preemptible(pod: Pod) -> bool:
    """Reference ``apis/extension/elastic_quota.go:85-87`` (quota
    preemptible label) + ``preemption.go:47-56`` (the scheduling-domain
    disable-preemptible opt-out honored by every preemption path)."""
    if pod.meta.labels.get(ext.LABEL_PREEMPTIBLE) == "false":
        return True
    return not ext.is_pod_preemptible(pod)


@dataclasses.dataclass
class _OveruseMonitor:
    """Per-quota debounce: used > runtime must persist for
    ``delay_evict_time`` before eviction triggers (reference
    QuotaOverUsedGroupMonitor, quota_overuse_revoke.go:61-90)."""

    manager: GroupQuotaManager
    quota_name: str
    delay_evict_time: float
    last_under_used: float = 0.0

    def check(self, now: float) -> bool:
        if self.quota_name not in self.manager._nodes:
            return False
        runtime, used = self.manager.runtime_and_used_of(self.quota_name)
        if np.all(used <= runtime + 1e-6):
            self.last_under_used = now
            return False
        if now - self.last_under_used > self.delay_evict_time:
            self.last_under_used = now
            return True
        return False


class ElasticQuotaPreemptor:
    """PostFilter analog of the reference's cross-pod preemption
    (``pkg/scheduler/plugins/elasticquota/preempt.go``): when a batch
    leaves a quota-labeled pod unschedulable, find the minimal set of
    lower-priority pods of the *same quota* (``canPreempt``:283-304)
    whose eviction both frees node capacity for the pod and clears its
    quota headroom, using the reference's remove-all-then-reprieve flow
    (``SelectVictimsOnNode``:111-221: strip every eligible victim, check
    fit, then reprieve most-important-first while the pod still fits and
    the quota check still passes).
    """

    def __init__(
        self,
        scheduler: "BatchScheduler",
        manager: GroupQuotaManager,
    ):
        self.scheduler = scheduler
        self.manager = manager
        #: per-cycle candidate cache (one preemptor instance per cycle):
        #: leaf → [(victim, preemptible, vleaf, priority, req_vec)] — the
        #: label parsing + res_vector walk over every assigned pod was
        #: re-run per failed pod and grew with cluster occupancy.
        #: Bound-ness is NOT cached (bound_node_of is re-checked live, so
        #: immediate-mode evictions between calls stay correct).
        self._cand_cache: Dict[str, list] = {}

    def _leaf_candidates(self, leaf: str) -> list:
        cached = self._cand_cache.get(leaf)
        if cached is None:
            cfg = self.manager.config
            vec_cache: Dict[tuple, np.ndarray] = {}
            cached = []
            for v in self.manager.pods_assigned(leaf):
                key = tuple(v.spec.requests.items())
                vec = vec_cache.get(key)
                if vec is None:
                    vec = cfg.res_vector(v.spec.requests)
                    vec_cache[key] = vec
                cached.append(
                    (
                        v,
                        not is_pod_non_preemptible(v),
                        quota_name_of(v) or ext.DEFAULT_QUOTA_NAME,
                        v.spec.priority or 0,
                        vec,
                    )
                )
            self._cand_cache[leaf] = cached
        return cached

    def _devices_clear(
        self, pod: Pod, node: str, victims: List[Pod]
    ) -> bool:
        """Coarse device feasibility: the pod's GPU/RDMA demand must fit
        in the node's free devices plus everything the victims hold.
        (Fragmentation-exact allocation is re-checked at the retry's
        Reserve; this gate stops evictions that cannot possibly help.)"""
        dm = self.scheduler.devices
        whole, share = ext.parse_gpu_request(pod.spec.requests)
        rdma = ext.parse_rdma_request(pod.spec.requests)
        fpga = ext.parse_fpga_request(pod.spec.requests)
        if whole == 0 and share <= 0 and rdma == 0 and fpga == 0:
            return True
        if dm is None:
            return False
        st = dm.node(node)
        if st is None:
            return False
        from .deviceshare import FULL

        victim_uids = {v.meta.uid for v in victims}
        free_full = sum(1 for f in st.gpu_free if f >= FULL - 1e-6)
        victim_full = sum(
            1
            for uid in victim_uids
            for pick in st.owners.get(uid, [])
            if pick[1] >= FULL - 1e-6
        )
        if whole + (1 if share > 0 else 0) > free_full + victim_full:
            return False
        free_rdma = sum(1 for f in st.rdma_free if f >= FULL - 1e-6)
        victim_rdma = sum(
            len(st.rdma_owners.get(uid, [])) for uid in victim_uids
        )
        if rdma > free_rdma + victim_rdma:
            return False
        free_fpga = sum(1 for f in st.fpga_free if f >= FULL - 1e-6)
        victim_fpga = sum(
            len(st.fpga_owners.get(uid, [])) for uid in victim_uids
        )
        return fpga <= free_fpga + victim_fpga

    def select_victims(
        self, pod: Pod
    ) -> Optional[Tuple[str, List[Pod]]]:
        """(node_name, victims) for the cheapest feasible preemption, or
        None. Nodes are tried in ascending victim count (minimal
        disruption), mirroring the reference preemption evaluator's
        fewest-victims candidate ranking. Candidate nodes must pass the
        pod's own node constraints and a coarse device-feasibility gate —
        evicting running workloads must never happen when the preemptor
        cannot possibly land afterwards."""
        leaf = quota_name_of(pod)
        if leaf is None or self.manager.index_of(leaf) is None:
            return None
        snap = self.scheduler.snapshot
        cfg = self.manager.config
        req = cfg.res_vector(pod.spec.requests)

        # The chain check "used − freed + req ≤ runtime at every level"
        # collapses to ONE per-dim bound: freed ≥ max over levels of
        # (used + req − runtime). Computing it once here replaces a
        # per-victim per-level scan that dominated the latency-stream
        # cycle's PostFilter cost.
        mgr = self.manager
        mgr.runtime_and_used_of(leaf)  # refresh runtime if dirty
        chain = list(mgr.chain_of(leaf))
        if not chain:
            return None
        # (an unbounded runtime level yields −inf need — never binding)
        quota_needed = np.max(
            [mgr.used[i] + req - mgr.runtime[i] for i in chain], axis=0
        )

        pod_prio = pod.spec.priority or 0
        skip_default = (
            self.manager.disable_default_quota_preemption
        )
        by_node: Dict[str, List[Tuple[Pod, np.ndarray]]] = {}
        freed_all = np.zeros_like(req)
        for victim, preemptible, vleaf, vprio, vec in self._leaf_candidates(
            leaf
        ):
            # canPreempt: preemptible victim, strictly lower priority,
            # same quota, default-quota opt-out — over precomputed fields
            if (
                not preemptible
                or vprio >= pod_prio
                or vleaf != leaf
                or (skip_default and vleaf == ext.DEFAULT_QUOTA_NAME)
            ):
                continue
            node = self.scheduler.bound_node_of(victim.meta.uid)
            if node is None:
                continue
            by_node.setdefault(node, []).append((victim, vec))
            freed_all = freed_all + vec
        # even evicting EVERY eligible victim cannot clear the chain →
        # no node can succeed, skip the per-node scan entirely
        if by_node and np.any(freed_all < quota_needed - 1e-3):
            return None

        best: Optional[Tuple[str, List[Pod]]] = None
        na = snap.nodes
        for node in sorted(by_node, key=lambda n: len(by_node[n])):
            idx = snap.node_id(node)
            if idx is None:
                continue
            if not self.scheduler.node_allowed(pod, node):
                continue
            victims = [v for v, _vec in by_node[node]]
            if not self._devices_clear(pod, node, victims):
                continue
            vecs = [vec for _v, vec in by_node[node]]
            freed = np.sum(vecs, axis=0)
            # node fit collapses the same way: freed ≥ requested + req −
            # allocatable, per dim
            node_needed = na.requested[idx] + req - na.allocatable[idx]
            needed = np.maximum(quota_needed, node_needed)
            # step 1: all eligible victims gone — does the pod fit, and
            # does the quota chain clear?
            if np.any(freed < needed - 1e-3):
                continue
            # step 2: reprieve most-important-first while both still hold
            order = sorted(
                range(len(victims)),
                key=lambda i: (-(victims[i].spec.priority or 0), i),
            )
            final: List[Pod] = []
            for i in order:
                trial = freed - vecs[i]
                if np.all(trial >= needed - 1e-3):
                    freed = trial  # reprieved
                else:
                    final.append(victims[i])
            if final and (best is None or len(final) < len(best[1])):
                best = (node, final)
        return best


class QuotaOverUsedRevokeController:
    """Evicts pods from quotas whose used stays above runtime (fair share
    shrank under them) — reference QuotaOverUsedRevokeController
    (``quota_overuse_revoke.go:149-272``). Victim selection
    (``getToRevokePodList`` :92-147): walk assigned pods least-important
    first, skipping non-preemptible, subtracting requests until
    used ≤ runtime; then try to re-admit from most-important down, keeping
    only pods that no longer fit on the revoke list.

    Defaults mirror v1beta3: delay 120 s, cycle 1 s
    (``pkg/scheduler/apis/config/v1beta3/defaults.go:58-59``).
    """

    def __init__(
        self,
        managers_fn,
        evict_fn,
        delay_evict_time: float = 120.0,
        revoke_pod_interval: float = 1.0,
        monitor_all_quotas: bool = True,
        now_fn=None,
    ):
        import time as _time

        self._managers_fn = managers_fn
        self._evict_fn = evict_fn
        self.delay_evict_time = delay_evict_time
        self.revoke_pod_interval = revoke_pod_interval
        self.monitor_all_quotas = monitor_all_quotas
        self._now = now_fn or _time.monotonic
        self._monitors: Dict[str, _OveruseMonitor] = {}
        self._last_cycle = -float("inf")

    def sync_quotas(self) -> None:
        """Track monitor set against live quotas (syncQuota :215-240)."""
        now = self._now()
        alive = set()
        for mgr in self._managers_fn():
            for name in mgr.all_quota_names():
                if name in (ext.SYSTEM_QUOTA_NAME, ext.ROOT_QUOTA_NAME):
                    continue
                alive.add(name)
                if name not in self._monitors:
                    self._monitors[name] = _OveruseMonitor(
                        manager=mgr,
                        quota_name=name,
                        delay_evict_time=self.delay_evict_time,
                        last_under_used=now,
                    )
        for name in list(self._monitors):
            if name not in alive:
                del self._monitors[name]

    def pods_to_revoke(self, quota_name: str) -> List[Pod]:
        mon = self._monitors.get(quota_name)
        if mon is None:
            return []
        mgr = mon.manager
        runtime, used = mgr.runtime_and_used_of(quota_name)
        used = used.copy()
        cfg = mgr.config

        # least important first: lowest priority, later-assigned breaking ties
        pods = mgr.pods_assigned(quota_name)
        order = sorted(
            range(len(pods)),
            key=lambda i: ((pods[i].spec.priority or 0), -i),
        )
        try_revoke: List[Pod] = []
        for i in order:
            if np.all(used <= runtime + 1e-6):
                break
            pod = pods[i]
            if is_pod_non_preemptible(pod):
                continue
            used -= cfg.res_vector(pod.spec.requests)
            try_revoke.append(pod)

        if not np.all(used <= runtime + 1e-6):
            return try_revoke  # still over: revoke everything we could

        # re-admit from most important down (:131-141)
        revoke: List[Pod] = []
        for pod in reversed(try_revoke):
            vec = cfg.res_vector(pod.spec.requests)
            used += vec
            if not np.all(used <= runtime + 1e-6):
                used -= vec
                revoke.append(pod)
        return revoke

    def step(self) -> List[Pod]:
        """One controller cycle; returns the pods handed to the evictor."""
        if not self.monitor_all_quotas:
            return []
        now = self._now()
        if now - self._last_cycle < self.revoke_pod_interval:
            return []
        self._last_cycle = now
        self.sync_quotas()
        revoked: List[Pod] = []
        for name, mon in list(self._monitors.items()):
            if not mon.check(now):
                continue
            for pod in self.pods_to_revoke(name):
                self._evict_fn(pod)
                leaf = quota_name_of(pod) or name
                mon.manager.unassign_pod(leaf, pod)
                revoked.append(pod)
        return revoked


# ---------------------------------------------------------------------------
# Multi-tree handling (reference quota_handler.go)
# ---------------------------------------------------------------------------


class QuotaTreeHandler:
    """Routes quotas into per-tree GroupQuotaManagers keyed by the
    ``tree-id`` label (reference ``quota_handler.go:34-63``
    GetOrCreateGroupQuotaManagerForTree). A tree's root quota carries the
    tree's capacity in its total-resource annotation; registering it moves
    that capacity out of the default tree unless ignore-default-tree is set
    (``handlerQuotaWhenRoot`` :303-327)."""

    def __init__(
        self,
        config: Optional[SnapshotConfig] = None,
        cluster_total: Optional[Mapping[str, float]] = None,
        scale_min_enabled: bool = False,
    ):
        self.config = config or SnapshotConfig()
        self.scale_min_enabled = scale_min_enabled
        self.default_manager = GroupQuotaManager(
            self.config, cluster_total, scale_min_enabled=scale_min_enabled
        )
        self._tree_managers: Dict[str, GroupQuotaManager] = {}
        self._quota_to_tree: Dict[str, str] = {}
        self._tree_totals: Dict[str, np.ndarray] = {}
        #: capacity each tree ACTUALLY took from the default tree — the
        #: give-back source of truth, so clamped deductions and later
        #: ignore-default-tree / total-resource flips never mint capacity
        self._tree_deducted: Dict[str, np.ndarray] = {}

    def manager_for_tree(self, tree_id: str) -> GroupQuotaManager:
        if not tree_id:
            return self.default_manager
        mgr = self._tree_managers.get(tree_id)
        if mgr is None:
            mgr = GroupQuotaManager(
                self.config, tree_id=tree_id, scale_min_enabled=self.scale_min_enabled
            )
            self._tree_managers[tree_id] = mgr
        return mgr

    def manager_for_quota(self, quota_name: str) -> GroupQuotaManager:
        return self.manager_for_tree(self._quota_to_tree.get(quota_name, ""))

    def manager_for_pod(self, pod: Pod) -> GroupQuotaManager:
        return self.manager_for_quota(quota_name_of(pod) or "")

    def managers(self) -> List[GroupQuotaManager]:
        return [self.default_manager, *self._tree_managers.values()]

    def on_quota_upsert(self, eq: ElasticQuota) -> None:
        name = eq.meta.name
        old_tree = self._quota_to_tree.get(name)
        if old_tree is not None and old_tree != eq.tree_id:
            # the reference forbids moving a quota between trees
            # (quota_handler.go:74); be defensive and migrate cleanly instead
            # of leaving a stale double registration behind
            old_mgr = (
                self._tree_managers.get(old_tree) if old_tree else self.default_manager
            )
            if old_mgr is not None:
                old_mgr.remove_quota(name)
        mgr = self.manager_for_tree(eq.tree_id)
        self._quota_to_tree[name] = eq.tree_id
        self._handle_root(eq, mgr, is_delete=False)
        mgr.upsert_quota(eq)

    def on_quota_delete(self, eq: ElasticQuota) -> None:
        self._quota_to_tree.pop(eq.meta.name, None)
        mgr = (
            self._tree_managers.get(eq.tree_id) if eq.tree_id else self.default_manager
        )
        if mgr is None:
            return
        mgr.remove_quota(eq.meta.name)
        self._handle_root(eq, mgr, is_delete=True)

    def _take_from_default(self, tree_id: str, target: np.ndarray) -> None:
        """Reconcile the tree's default-tree deduction toward ``target``,
        bounded by what the default tree can actually give (or has actually
        taken) — capacity is conserved even when totals oversubscribe."""
        deducted = self._tree_deducted.get(
            tree_id, np.zeros(self.config.dims, np.float32)
        )
        want = target - deducted
        if not np.any(want != 0):
            return
        before = self.default_manager.cluster_total.copy()
        self.default_manager.update_cluster_total(-want)
        applied = before - self.default_manager.cluster_total
        self._tree_deducted[tree_id] = (deducted + applied).astype(np.float32)

    def _handle_root(
        self, eq: ElasticQuota, mgr: GroupQuotaManager, is_delete: bool
    ) -> None:
        if not eq.is_root or not eq.tree_id:
            return
        tree = eq.tree_id
        if is_delete:
            # give back exactly what this tree took, regardless of current
            # annotations on the delete event
            self._take_from_default(tree, np.zeros(self.config.dims, np.float32))
            self._tree_totals.pop(tree, None)
            self._tree_deducted.pop(tree, None)
            live = self._tree_managers.get(tree)
            if live is not None:
                if live.quota_count == 0:
                    self._tree_managers.pop(tree, None)
                else:
                    # children still registered: keep their accounting alive
                    # but the tree no longer has capacity to hand out
                    live.set_cluster_total({})
            return
        if not eq.total_resource:
            return
        new_total = self.config.res_vector(eq.total_resource)
        self._tree_totals[tree] = new_total
        mgr.set_cluster_total(eq.total_resource)
        target = (
            np.zeros_like(new_total) if eq.ignore_default_tree else new_total
        )
        self._take_from_default(tree, target)
