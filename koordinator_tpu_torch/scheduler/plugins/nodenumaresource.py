"""NodeNUMAResource host-side manager: zone accounting + exact cpusets.

Rebuild of the reference plugin's control plane
(``pkg/scheduler/plugins/nodenumaresource/plugin.go:60-74,251-313,579-627``
and ``resource_manager.go:194-225``): parses the pod's
``scheduling.koordinator.sh/resource-spec`` annotation (CPU bind policy),
keeps per-node zone allocations + a CPU accumulator, and at PreBind writes
``scheduling.koordinator.sh/resource-status`` with the exclusive cpuset and
chosen NUMA zone. Zone *feasibility* for all (pod, node) pairs is computed
on TPU (``ops.numa``); this class owns the per-winner exact assignment.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ...api import extension as ext
from ...api.types import Pod
from ...core.snapshot import ClusterSnapshot
from ...core.topology import (
    CPUAccumulator,
    CPUBindPolicy,
    CPUTopology,
    NUMAPolicy,
    format_cpuset_sorted,
)

#: zone resource dims lowered to the solver (prefix of the snapshot axis)
ZONE_DIMS = 2  # cpu milli, memory MiB


def parse_resource_spec(pod: Pod) -> CPUBindPolicy:
    raw = pod.meta.annotations.get(ext.ANNOTATION_RESOURCE_SPEC)
    if not raw:
        return CPUBindPolicy.DEFAULT
    try:
        spec = json.loads(raw)
        return CPUBindPolicy(spec.get("preferredCPUBindPolicy", "Default"))
    except (ValueError, KeyError, AttributeError, TypeError):
        # user-supplied annotation: any malformed shape degrades to Default
        return CPUBindPolicy.DEFAULT


def wants_numa(pod: Pod) -> bool:
    """LSR/LSE pods with integer CPU requests need exclusive, aligned CPUs
    (reference ``plugin.go:251-313`` requiredCPUBindPolicy resolution) —
    one predicate shared with the snapshot's amplified-CPU charging."""
    return ext.wants_cpu_bind(pod)


@dataclasses.dataclass
class _NodeNUMA:
    topology: CPUTopology
    policy: NUMAPolicy
    #: [Z][ZONE_DIMS] allocatable per zone (plain lists: the per-winner
    #: zone bookkeeping is pure-Python float math — numpy overhead per
    #: tiny op dominated the commit hot path)
    zone_alloc: List[List[float]]
    #: [Z][ZONE_DIMS] allocated per zone
    zone_used: List[List[float]]
    accumulator: CPUAccumulator
    #: CPU amplification ratio the zone capacities were registered with
    cpu_amp: float = 1.0
    #: physical (unamplified) zone CPU milli, for ratio re-sync
    phys_zone_cpu: List[float] = dataclasses.field(default_factory=list)
    #: pod uid -> (zone, charged vec, nominal bind cpu milli — 0 if the
    #: charge was nominal/shared)
    owners: Dict[str, Tuple[int, List[float], float]] = dataclasses.field(
        default_factory=dict
    )
    #: node-level bind-policy constraint (LabelNodeCPUBindPolicy):
    #: "FullPCPUsOnly" forces whole-core takes, "SpreadByPCPUs" spreads
    node_bind_policy: str = ""
    #: node-level zone pick strategy (LabelNodeNUMAAllocateStrategy):
    #: "" follows the plugin default — LeastAllocated (spread), flipping
    #: to MostAllocated when the scoring strategy is MostAllocated
    #: (reference GetDefaultNUMAAllocateStrategy, util.go:33-39);
    #: an explicit label overrides per node (util.go:41-47)
    numa_allocate_strategy: str = ""


class NUMAManager:
    """Per-node NUMA state; lowers zone arrays aligned to snapshot indices."""

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        max_zones: int = 4,
        scoring_strategy: Optional[str] = None,
    ):
        self.snapshot = snapshot
        self.max_zones = max_zones
        #: "LeastAllocated" | "MostAllocated" | None — NUMA-aligned Score
        #: strategy (reference NodeNUMAResourceArgs.ScoringStrategy)
        self.scoring_strategy = scoring_strategy
        self._nodes: Dict[str, _NodeNUMA] = {}
        #: policy_rows cache, invalidated on register_node / node churn
        self._policy_cache: Optional[np.ndarray] = None
        self._policy_cache_epoch = -1
        #: incremental zone-array lowering cache (see DeviceManager's
        #: ``_lowered``): full rebuild on node churn (node_epoch) or a
        #: cpu_amp change (amp vector compared each call — re-upserts
        #: don't bump the epoch); per-row refresh for allocation deltas
        self._zone_cache: Optional[Tuple[np.ndarray, ...]] = None
        self._zone_epoch = -1
        self._zone_dirty: set = set()
        self._amp_seen: Optional[np.ndarray] = None
        #: bumped whenever arrays() actually changes the lowered zone
        #: tables (full rebuild or a dirty-row flush) — the scheduler keys
        #: its device-resident NumaState upload off it
        self.lowered_version = 0
        #: snapshot row indices whose lowered rows changed since the last
        #: drain_lowered_dirty() — the scheduler scatters ONLY these into
        #: its device-resident NumaState instead of re-uploading the whole
        #: [N, Z, DN] table (ROADMAP item b); a full rebuild sets the
        #: wholesale flag instead
        self._scatter_rows: set = set()
        self._scatter_full = True

    def _mark_dirty(self, node_name: str) -> None:
        if self._zone_cache is not None:
            self._zone_dirty.add(node_name)

    def register_node(
        self,
        node_name: str,
        topology: CPUTopology,
        policy: NUMAPolicy = NUMAPolicy.NONE,
        memory_per_zone_mib: float = 0.0,
        cpu_amp: Optional[float] = None,
    ) -> None:
        """``cpu_amp`` defaults to the snapshot's node amplification ratio;
        zone CPU capacity is registered in *amplified* space (reference
        ``amplifyNUMANodeResources``, ``plugin.go:630-632``) — bound pods'
        zone charges amplify with it, the cpuset accumulator stays
        physical."""
        if cpu_amp is None:
            idx = self.snapshot.node_id(node_name)
            cpu_amp = (
                float(self.snapshot.nodes.cpu_amp[idx]) if idx is not None else 1.0
            )
        cpu_amp = max(float(cpu_amp), 1.0)
        z = topology.num_numa_nodes
        zone_alloc = [[0.0] * ZONE_DIMS for _ in range(self.max_zones)]
        phys = [0.0] * self.max_zones
        for zone in range(min(z, self.max_zones)):
            n_cpus = len(topology.cpus_in_numa(zone))
            phys[zone] = n_cpus * 1000.0
            zone_alloc[zone][0] = phys[zone] * cpu_amp
            zone_alloc[zone][1] = memory_per_zone_mib
        self._nodes[node_name] = _NodeNUMA(
            topology=topology,
            policy=policy,
            zone_alloc=zone_alloc,
            zone_used=[[0.0] * ZONE_DIMS for _ in range(self.max_zones)],
            accumulator=CPUAccumulator(topology),
            cpu_amp=cpu_amp,
            phys_zone_cpu=phys,
        )
        self._policy_cache = None
        self._mark_dirty(node_name)

    #: NodeResourceTopology.topologyPolicy string → solver policy
    _POLICY_BY_NAME = {
        "None": NUMAPolicy.NONE,
        "BestEffort": NUMAPolicy.BEST_EFFORT,
        "Restricted": NUMAPolicy.RESTRICTED,
        "SingleNUMANode": NUMAPolicy.SINGLE_NUMA_NODE,
    }

    def register_from_topology(self, report) -> None:
        """Ingest a NodeResourceTopology report (the koordlet's CR write,
        ``states_noderesourcetopology.go``) — the reference's
        NodeNUMAResource plugin consumes exactly this CRD via informer.
        Rebuilds the node's zone tables and cpuset accumulator, and
        pre-takes the kubelet-reserved CPUs so the scheduler can never
        hand them out."""
        from ...api.types import NodeResourceTopology  # noqa: F401 (doc)
        from ...core.topology import CPUInfo

        if not report.cpu_topology:
            return
        cpus = [
            CPUInfo(cpu_id=cid, core_id=core, numa_node=numa, socket=sock)
            for cid, (core, numa, sock) in sorted(
                report.cpu_topology.items()
            )
        ]
        topo = CPUTopology(cpus=cpus)
        policy = self._POLICY_BY_NAME.get(
            report.topology_policy, NUMAPolicy.NONE
        )
        mem_per_zone = 0.0
        for zone in report.zones:
            mem = float(zone.allocatable.get(ext.RES_MEMORY, 0.0))
            mem_per_zone = max(mem_per_zone, mem)
        self.register_node(
            report.meta.name,
            topo,
            policy,
            memory_per_zone_mib=mem_per_zone,
        )
        zone_of = {c.cpu_id: c.numa_node for c in cpus}
        st = self._nodes[report.meta.name]

        charged: set = set()

        def pre_take(owner: str, cpu_ids) -> None:
            # overlapping reservations (system-QoS inside the kubelet
            # reserved set is common) must charge each CPU's zone ONCE
            ids = set(int(c) for c in cpu_ids) - charged
            if not ids:
                return
            charged.update(ids)
            st.accumulator.take_reserved(owner, ids)
            # zone feasibility must see the taken cores as used too
            for cid in ids:
                zone = zone_of.get(cid)
                if zone is not None and zone < self.max_zones:
                    st.zone_used[zone][0] += 1000.0 * st.cpu_amp

        pre_take("kubelet-reserved", report.kubelet_reserved_cpus)
        ann = report.meta.annotations or {}
        # kubelet static-policy Guaranteed pods' cpusets + the kubelet
        # policy's own reservedCPUs + the exclusive SYSTEM-QoS carve-out
        # (AnnotationNodeCPUAllocs / AnnotationKubeletCPUManagerPolicy /
        # AnnotationNodeSystemQOSResource): none of these CPUs may ever
        # be handed to a cpuset-bound pod by this scheduler
        from ...core.topology import parse_cpuset

        for alloc in ext.parse_node_cpu_allocs(ann):
            owner = f"kubelet-alloc/{alloc.get('uid') or alloc.get('name', '?')}"
            pre_take(owner, parse_cpuset(str(alloc.get("cpuset", ""))))
        kubelet = ext.parse_kubelet_cpu_manager_policy(ann)
        if kubelet and kubelet.get("reservedCPUs"):
            pre_take(
                "kubelet-policy-reserved",
                parse_cpuset(str(kubelet["reservedCPUs"])),
            )
        sysqos = ext.parse_system_qos_resource(ann)
        if sysqos and sysqos.get("cpusetExclusive", True):
            pre_take("system-qos", parse_cpuset(str(sysqos["cpuset"])))
        # node-level bind-policy / NUMA allocate-strategy labels
        # (LabelNodeCPUBindPolicy / LabelNodeNUMAAllocateStrategy) ride in
        # on the report's labels when published through it
        labels = report.meta.labels or {}
        st.node_bind_policy = labels.get(ext.LABEL_NODE_CPU_BIND_POLICY, "")
        st.numa_allocate_strategy = labels.get(
            ext.LABEL_NODE_NUMA_ALLOCATE_STRATEGY, ""
        )

    def unregister_node(self, node_name: str) -> None:
        """Drop a node's topology (NodeResourceTopology deleted)."""
        self._nodes.pop(node_name, None)
        self._policy_cache = None
        # the cached zone row must zero out (node_epoch doesn't bump —
        # the Node itself may remain in the snapshot)
        self._mark_dirty(node_name)

    def _sync_amp(self, node_name: str, st: _NodeNUMA) -> None:
        """Re-base zone capacities and bound charges onto the snapshot's
        *live* amplification ratio. register_node may have run before the
        Node upsert (ratio unknown → 1.0) or the annotation may have
        changed since; the solver always amplifies with the live ratio, so
        the manager must live in the same space."""
        idx = self.snapshot.node_id(node_name)
        if idx is None:
            return
        live = max(float(self.snapshot.nodes.cpu_amp[idx]), 1.0)
        if live == st.cpu_amp:
            return
        for zone in range(self.max_zones):
            st.zone_alloc[zone][0] = st.phys_zone_cpu[zone] * live
        for uid, (zone, charged, nominal_cpu) in list(st.owners.items()):
            if nominal_cpu <= 0 or zone < 0:
                continue
            new_charge = nominal_cpu * live
            st.zone_used[zone][0] += new_charge - charged[0]
            st.owners[uid] = (zone, [new_charge] + charged[1:], nominal_cpu)
        st.cpu_amp = live

    def node(self, name: str) -> Optional[_NodeNUMA]:
        return self._nodes.get(name)

    # ---- solver lowering ----

    def _refresh_zone_row(self, name: str) -> None:
        zone_free, zone_cap, policy, most = self._zone_cache
        idx = self.snapshot.node_id(name)
        if idx is None:
            return
        st = self._nodes.get(name)
        if st is None:
            zone_free[idx] = 0.0
            zone_cap[idx] = 0.0
            policy[idx] = 0
            most[idx] = False
            return
        self._sync_amp(name, st)
        alloc = np.asarray(st.zone_alloc, np.float32)
        zone_free[idx] = alloc - np.asarray(st.zone_used, np.float32)
        zone_cap[idx] = alloc
        policy[idx] = int(st.policy)
        most[idx] = self._most_allocated(st)

    def arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(zone_free [N, Z, DN], zone_cap [N, Z, DN], policy [N]) aligned
        to snapshot rows. Unregistered nodes report zero capacity (always
        NUMA-feasible). Incrementally cached: rebuilding every row each
        scheduling cycle was the latency stream's dominant fixed cost.
        Callers must treat the returned arrays as read-only snapshots
        for immediate lowering."""
        epoch = self.snapshot.node_epoch
        n_bucket = self.snapshot.nodes.allocatable.shape[0]
        amp = self.snapshot.nodes.cpu_amp
        if (
            self._zone_cache is None
            or self._zone_epoch != epoch
            or self._zone_cache[0].shape[0] != n_bucket
        ):
            self._zone_cache = (
                np.zeros((n_bucket, self.max_zones, ZONE_DIMS), np.float32),
                np.zeros((n_bucket, self.max_zones, ZONE_DIMS), np.float32),
                np.zeros((n_bucket,), np.int8),
                np.zeros((n_bucket,), bool),
            )
            self._zone_epoch = epoch
            self._zone_dirty = set()
            for name in self._nodes:
                self._refresh_zone_row(name)
            self._amp_seen = amp.copy()
            self.lowered_version += 1
            self._scatter_full = True
            self._scatter_rows.clear()
        else:
            if self._amp_seen is None or not np.array_equal(
                self._amp_seen, amp
            ):
                # re-upserts don't bump node_epoch, but an amplification
                # change re-bases zone capacities — refresh changed rows
                changed = (
                    np.nonzero(amp != self._amp_seen)[0]
                    if self._amp_seen is not None
                    and self._amp_seen.shape == amp.shape
                    else range(min(len(amp), n_bucket))
                )
                for idx in changed:
                    try:
                        name = self.snapshot.node_name(int(idx))
                    except IndexError:
                        continue
                    if name in self._nodes:
                        self._zone_dirty.add(name)
                self._amp_seen = amp.copy()
            if self._zone_dirty:
                for name in self._zone_dirty:
                    self._refresh_zone_row(name)
                    idx = self.snapshot.node_id(name)
                    if idx is not None:
                        self._scatter_rows.add(int(idx))
                self._zone_dirty = set()
                self.lowered_version += 1
        return self._zone_cache[:3]

    def drain_lowered_dirty(self) -> Optional[np.ndarray]:
        """Snapshot row indices whose lowered zone rows changed since the
        last drain, or None for a full rebuild (see
        :func:`..plugins.drain_scatter_marks`). Call AFTER :meth:`arrays`
        (which flushes pending dirty names into the lowered cache)."""
        from . import drain_scatter_marks

        return drain_scatter_marks(self)

    def touch_lowered_rows(self, rows) -> None:
        """Mark lowered rows stale for the resident mirror WITHOUT a
        host-side change (anti-entropy scrubber heal path): the next
        resident refresh re-scatters host truth into exactly these
        rows."""
        self._scatter_rows.update(int(r) for r in rows)
        self.lowered_version += 1

    def most_allocated_rows(self) -> np.ndarray:
        """[N] bool MostAllocated zone-pick strategy per snapshot row
        (``_most_allocated`` resolution), for the solver's on-device zone
        selection; shares the zone-array cache refresh."""
        self.arrays()
        return self._zone_cache[3]

    @property
    def has_topology(self) -> bool:
        return bool(self._nodes)

    def policy_rows(self) -> np.ndarray:
        """int8 NUMA policy per snapshot row; -1 = unregistered node. The
        batched commit uses this to split winners into the vectorized
        no-NUMA path vs the per-winner exact-assignment path. Cached per
        snapshot node-epoch (rebuilt on register_node / node churn)."""
        epoch = self.snapshot.node_epoch
        if (
            self._policy_cache is not None
            and self._policy_cache_epoch == epoch
        ):
            return self._policy_cache
        n_bucket = self.snapshot.nodes.allocatable.shape[0]
        out = np.full((n_bucket,), -1, np.int8)
        for name, st in self._nodes.items():
            idx = self.snapshot.node_id(name)
            if idx is not None:
                out[idx] = int(st.policy)
        self._policy_cache = out
        self._policy_cache_epoch = epoch
        return out

    def _most_allocated(self, st: _NodeNUMA) -> bool:
        """Effective zone-pick strategy for a node: explicit label, else
        the plugin default derived from the scoring strategy
        (GetDefaultNUMAAllocateStrategy + GetNUMAAllocateStrategy)."""
        if st.numa_allocate_strategy == ext.NODE_NUMA_STRATEGY_MOST_ALLOCATED:
            return True
        if st.numa_allocate_strategy == ext.NODE_NUMA_STRATEGY_LEAST_ALLOCATED:
            return False
        return self.scoring_strategy == "MostAllocated"

    @staticmethod
    def _forced_bind_policy(st: _NodeNUMA):
        """LabelNodeCPUBindPolicy override, or None to use the pod's."""
        if st.node_bind_policy == ext.NODE_CPU_BIND_POLICY_FULL_PCPUS_ONLY:
            return CPUBindPolicy.FULL_PCPUS
        if st.node_bind_policy == ext.NODE_CPU_BIND_POLICY_SPREAD_BY_PCPUS:
            return CPUBindPolicy.SPREAD_BY_PCPUS
        return None

    # ---- per-winner exact assignment (PreBind) ----

    def allocate(self, pod: Pod, node_name: str) -> Optional[Mapping[str, str]]:
        """Commit a pod onto a node: choose a zone, take an exclusive cpuset
        if required, and return the resource-status annotation patch
        (``plugin.go:579-627``). Returns None when NUMA placement fails —
        the caller treats it like a failed Reserve."""
        requests = pod.spec.requests
        numa_spec = ext.parse_numa_topology_spec(pod.meta.annotations)
        payload = self.allocate_lowered(
            pod.meta.uid,
            pod.meta.annotations,
            node_name,
            float(requests.get(ext.RES_CPU, 0.0)),
            float(requests.get(ext.RES_MEMORY, 0.0)),
            wants_numa(pod),
            required=bool(
                numa_spec
                and numa_spec.get("numaTopologyPolicy") == "SingleNUMANode"
            ),
        )
        if payload is None:
            return None
        if not payload:
            return {}
        return {ext.ANNOTATION_RESOURCE_STATUS: payload}

    def allocate_lowered(
        self,
        uid: str,
        annotations: Mapping[str, str],
        node_name: str,
        cpu_milli: float,
        mem_mib: float,
        bind: bool,
        synced: bool = False,
        required: bool = False,
    ) -> Optional[str]:
        """Lean core of ``allocate`` for the batched commit: all request
        parsing is already lowered by the caller (BatchScheduler's chunk
        rows). Returns the resource-status JSON payload, ``""`` when there
        is nothing to record, or None on failed placement. ``synced=True``
        asserts the caller ran ``arrays()`` (which re-bases every node's
        amplification) earlier in the same single-threaded cycle, so the
        per-winner ratio re-sync is skipped."""
        st = self._nodes.get(node_name)
        if st is None:
            return ""
        if not synced:
            self._sync_amp(node_name, st)
        most_allocated = self._most_allocated(st)
        req0, req1 = cpu_milli, mem_mib
        # record the nominal bind charge for every bound pod — even at
        # ratio 1.0 — so a later annotation change can re-base it
        nominal_cpu = cpu_milli if bind else 0.0
        if bind and st.cpu_amp > 1.0:
            # zone capacities are amplified space: a bound pod's physical
            # cores charge ×ratio (AmplifyResourceList, plugin.go:636-640);
            # the accumulator below still takes the physical core count
            req0 = cpu_milli * st.cpu_amp
        zone = -1
        if st.policy == NUMAPolicy.SINGLE_NUMA_NODE or bind or required:
            # strategy-ordered fitting zone (pure-Python: Z is tiny and
            # this runs once per winner; ZONE_DIMS is fixed at 2)
            cpu_need = req0 - 1e-3
            mem_need = req1 - 1e-3
            best_util = None
            for z, alloc in enumerate(st.zone_alloc):
                used = st.zone_used[z]
                if alloc[0] - used[0] < cpu_need or alloc[1] - used[1] < mem_need:
                    continue
                util = (used[0] + 1.0) / (alloc[0] + 1.0)
                if (
                    best_util is None
                    or (util > best_util if most_allocated else util < best_util)
                ):
                    best_util = util
                    zone = z
            if zone < 0 and (
                st.policy == NUMAPolicy.SINGLE_NUMA_NODE or required
            ):
                return None

        cpuset_str = None
        if bind:
            n_cpus = int(cpu_milli // 1000)
            policy = self._forced_bind_policy(st)
            if policy is None:
                raw = annotations.get(ext.ANNOTATION_RESOURCE_SPEC)
                if raw:
                    try:
                        policy = CPUBindPolicy(
                            json.loads(raw).get("preferredCPUBindPolicy", "Default")
                        )
                    except (ValueError, KeyError, AttributeError, TypeError):
                        policy = CPUBindPolicy.DEFAULT
                else:
                    policy = CPUBindPolicy.DEFAULT
            cpuset = st.accumulator.take(
                uid,
                n_cpus,
                policy=policy,
                numa=zone if zone >= 0 else None,
            )
            if cpuset is None:
                return None
            cpuset_str = format_cpuset_sorted(sorted(cpuset))
        if zone >= 0:
            used = st.zone_used[zone]
            used[0] += req0
            used[1] += req1
            st.owners[uid] = (zone, [req0, req1], nominal_cpu)
        if zone >= 0 or cpuset_str is not None:
            self._mark_dirty(node_name)
        # hand-rendered resource-status JSON: json.dumps per winner was a
        # visible slice of the commit loop (payload shape is fixed)
        if cpuset_str is not None and zone >= 0:
            return (
                '{"cpuset": "%s", "numaNodeResources": [{"node": %d}]}'
                % (cpuset_str, zone)
            )
        if cpuset_str is not None:
            return '{"cpuset": "%s"}' % cpuset_str
        if zone >= 0:
            return '{"numaNodeResources": [{"node": %d}]}' % zone
        return ""

    def allocate_batch(
        self,
        uids: List[str],
        annotations: List[Mapping[str, str]],
        node_names: List[str],
        cpu_milli: List[float],
        mem_mib: List[float],
        bind: List[bool],
        required: Optional[List[bool]] = None,
        zones_hint: Optional[List[int]] = None,
    ) -> List[Optional[str]]:
        """Batched :meth:`allocate_lowered` over one chunk's winners in
        commit order (VERDICT r3 #1: the per-winner Python loop was the
        NUMA scenario's host wall). Winners are grouped by node — per-node
        state is independent, so only the order WITHIN a node matters and
        the input order is preserved there. Per node, the zone pick, zone
        charge and cpuset take run with node state hoisted out of the
        loop and cpusets taken through ``CPUAccumulator.take_bulk``.
        Assumes the caller ran ``arrays()`` earlier this cycle
        (``synced=True`` semantics of :meth:`allocate_lowered`).

        ``zones_hint`` (VERDICT r4 #4) carries the solver's ON-DEVICE
        zone picks (−1 = no zone): a hinted zone is fit-verified and
        used directly, skipping the strategy scan; a stale/unfit hint
        falls back to the host pick, so the hint is an accelerator,
        never a correctness dependency."""
        n = len(uids)
        results: List[Optional[str]] = [""] * n
        by_node: Dict[str, List[int]] = {}
        for i, name in enumerate(node_names):
            lst = by_node.get(name)
            if lst is None:
                by_node[name] = [i]
            else:
                lst.append(i)
        single = int(NUMAPolicy.SINGLE_NUMA_NODE)
        spec_key = ext.ANNOTATION_RESOURCE_SPEC
        default_pol = CPUBindPolicy.DEFAULT
        for name, rows_i in by_node.items():
            st = self._nodes.get(name)
            if st is None:
                continue
            self._mark_dirty(name)
            policy_single = int(st.policy) == single
            amp = st.cpu_amp
            zone_alloc = st.zone_alloc
            zone_used = st.zone_used
            owners = st.owners
            # node-level overrides (LabelNodeCPUBindPolicy /
            # LabelNodeNUMAAllocateStrategy); the unlabeled default
            # follows the scoring strategy (util.go:33-39)
            most_allocated = self._most_allocated(st)
            forced_pol = self._forced_bind_policy(st)
            # phase 1: zone pick + zone charge per winner (sequential
            # within the node — later winners see earlier charges)
            zones: List[int] = []
            reqs0: List[float] = []
            take_reqs = []
            take_rows: List[int] = []
            for i in rows_i:
                b = bind[i]
                req_single = required[i] if required is not None else False
                if not (policy_single or b or req_single):
                    zones.append(-1)
                    reqs0.append(0.0)
                    continue
                req0 = cpu_milli[i]
                if b and amp > 1.0:
                    req0 *= amp
                cpu_need = req0 - 1e-3
                mem_need = mem_mib[i] - 1e-3
                zone = None
                if zones_hint is not None:
                    hint = zones_hint[i]
                    if hint is not None and 0 <= hint < len(zone_alloc):
                        alloc_h = zone_alloc[hint]
                        used_h = zone_used[hint]
                        if (
                            alloc_h[0] - used_h[0] >= cpu_need
                            and alloc_h[1] - used_h[1] >= mem_need
                        ):
                            zone = hint
                    # hint == -1 (device saw no fitting zone) falls
                    # through to the host scan: the carried device table
                    # can be stale-pessimistic (host-rejected winners are
                    # not refunded into it mid-batch), and the hint must
                    # stay an accelerator, never a correctness dependency
                if zone is None:
                    best_util = None
                    zone = -1
                    for z, alloc in enumerate(zone_alloc):
                        used = zone_used[z]
                        if (
                            alloc[0] - used[0] < cpu_need
                            or alloc[1] - used[1] < mem_need
                        ):
                            continue
                        util = (used[0] + 1.0) / (alloc[0] + 1.0)
                        if (
                            best_util is None
                            or (
                                util > best_util
                                if most_allocated
                                else util < best_util
                            )
                        ):
                            best_util = util
                            zone = z
                if zone < 0 and (policy_single or req_single):
                    results[i] = None
                    zones.append(-2)        # rejected
                    reqs0.append(0.0)
                    continue
                zones.append(zone)
                reqs0.append(req0)
                if zone >= 0:
                    # charge now: the NEXT winner's pick must see it
                    used = zone_used[zone]
                    used[0] += req0
                    used[1] += mem_mib[i]
                if b:
                    if forced_pol is not None:
                        pol = forced_pol
                    else:
                        raw = annotations[i].get(spec_key)
                        if raw:
                            try:
                                pol = CPUBindPolicy(
                                    json.loads(raw).get(
                                        "preferredCPUBindPolicy", "Default"
                                    )
                                )
                            except (ValueError, KeyError, AttributeError, TypeError):
                                pol = default_pol
                        else:
                            pol = default_pol
                    take_reqs.append(
                        (
                            uids[i],
                            int(cpu_milli[i] // 1000),
                            pol,
                            zone if zone >= 0 else None,
                        )
                    )
                    take_rows.append(i)
            # phase 2: bulk cpuset takes for this node's bind winners
            if take_reqs:
                cpusets = st.accumulator.take_bulk(take_reqs)
            else:
                cpusets = []
            # phase 3: payloads + owner records (+ rollback of failed takes)
            k = 0
            for j, i in enumerate(rows_i):
                zone = zones[j]
                if zone == -2:
                    continue
                cpuset_str = None
                if bind[i]:
                    cpuset = cpusets[k]
                    k += 1
                    if cpuset is None:
                        # roll the zone charge back — nothing was taken
                        if zone >= 0:
                            used = zone_used[zone]
                            used[0] -= reqs0[j]
                            used[1] -= mem_mib[i]
                        results[i] = None
                        continue
                    cpuset_str = format_cpuset_sorted(sorted(cpuset))
                if zone >= 0:
                    owners[uids[i]] = (
                        zone,
                        [reqs0[j], mem_mib[i]],
                        cpu_milli[i] if bind[i] else 0.0,
                    )
                if cpuset_str is not None and zone >= 0:
                    results[i] = (
                        '{"cpuset": "%s", "numaNodeResources": [{"node": %d}]}'
                        % (cpuset_str, zone)
                    )
                elif cpuset_str is not None:
                    results[i] = '{"cpuset": "%s"}' % cpuset_str
                elif zone >= 0:
                    results[i] = '{"numaNodeResources": [{"node": %d}]}' % zone
        return results

    def reset_allocations(self) -> None:
        """Free every zone and cpuset hold (full-resync path)."""
        from ...core.topology import CPUAccumulator

        for st in self._nodes.values():
            st.zone_used = [[0.0] * ZONE_DIMS for _ in st.zone_alloc]
            st.owners.clear()
            st.accumulator = CPUAccumulator(st.topology)
        self._zone_cache = None

    def release(self, pod_uid: str, node_name: str) -> None:
        st = self._nodes.get(node_name)
        if st is None:
            return
        self._mark_dirty(node_name)
        st.accumulator.release(pod_uid)
        entry = st.owners.pop(pod_uid, None)
        if entry is not None:
            zone, req, _nominal = entry
            used = st.zone_used[zone]
            for d in range(ZONE_DIMS):
                used[d] -= req[d]

    # ---- exact-hold journal coverage (HA PR 6 satellite) ----

    def hold_of(self, pod_uid: str, node_name: str) -> Optional[dict]:
        """JSON-serializable snapshot of the pod's exact NUMA hold —
        zone charge (amplified request vector + bind-nominal CPU) and
        exclusive cpuset — for the write-ahead bind journal, so a
        takeover restores the hold bit-exactly via :meth:`restore_hold`
        instead of relying on a re-lower (which cannot recover WHICH
        zone/cpus were chosen)."""
        st = self._nodes.get(node_name)
        if st is None:
            return None
        entry = st.owners.get(pod_uid)
        cpus = st.accumulator.cpuset_of(pod_uid)
        if entry is None and not cpus:
            return None
        hold: dict = {}
        if entry is not None:
            zone, req, nominal = entry
            hold["zone"] = int(zone)
            hold["zreq"] = [float(x) for x in req]
            hold["znom"] = float(nominal)
        if cpus:
            hold["cpus"] = sorted(int(c) for c in cpus)
        return hold

    def restore_hold(self, pod_uid: str, node_name: str, hold: dict) -> None:
        """Re-install a journaled hold on a recovering instance
        (idempotent: a pod already holding on this node is left alone —
        the statehub resync may have re-registered it first)."""
        st = self._nodes.get(node_name)
        if st is None:
            return
        if pod_uid in st.owners or st.accumulator.cpuset_of(pod_uid):
            return
        self._mark_dirty(node_name)
        cpus = hold.get("cpus")
        if cpus:
            st.accumulator.take_reserved(pod_uid, {int(c) for c in cpus})
        zone = int(hold.get("zone", -1))
        if zone >= 0 and zone < len(st.zone_used):
            req = [float(x) for x in hold.get("zreq", [0.0] * ZONE_DIMS)]
            used = st.zone_used[zone]
            for d in range(min(ZONE_DIMS, len(req))):
                used[d] += req[d]
            st.owners[pod_uid] = (zone, req, float(hold.get("znom", 0.0)))
