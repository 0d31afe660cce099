"""Tensor state snapshot: host objects → dense arrays.

The rebuild's analog of the reference scheduler's in-memory state (scheduler
cache NodeInfos + ``podAssignCache`` ``pkg/scheduler/plugins/loadaware/
pod_assign_cache.go`` + ``nodeDeviceCache`` + quota tree): one mutable
host-side store of numpy arrays, lowered to device arrays per solver batch.

Design notes (TPU-first):
  * All shapes are padded to buckets (next power of two, min 128) so that
    churn in pod/node counts does not recompile the jitted solver.
  * Resources live on a canonical D axis (``SnapshotConfig.resources``);
    cpu is milli-cores, memory is MiB, extended resources native units.
  * Incremental updates (assume/forget, metric refresh) mutate numpy in
    place — the device transfer happens once per solver batch, not per event.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from ..api import extension as ext
from ..api.types import Node, NodeMetric, Pod, ResourceList


#: fallback QoS per priority band (ext.qos_for_priority, vectorized)
_QOS_BY_BAND = np.array(
    [
        int(ext.qos_for_priority(ext.PriorityClass(b)))
        for b in range(len(ext.PriorityClass))
    ],
    np.int8,
)


def bucket_size(n: int, minimum: int = 128) -> int:
    """Round up to the next power of two (>= minimum) for stable jit shapes."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class SnapshotConfig:
    resources: Tuple[str, ...] = ext.DEFAULT_RESOURCES
    min_bucket: int = 128

    @property
    def dims(self) -> int:
        return len(self.resources)

    def res_vector(self, rl: Mapping[str, float]) -> np.ndarray:
        return np.array([float(rl.get(r, 0.0)) for r in self.resources], np.float32)


@dataclasses.dataclass
class NodeArrays:
    """Dense per-node state, padded to ``n_bucket`` rows.

    Mirrors what the reference spreads across NodeInfo + NodeMetric + the
    LoadAware ``podAssignCache``:
      allocatable      — Node.status.allocatable            [N, D]
      requested        — sum of assigned pod requests       [N, D]
      usage_avg        — NodeMetric avg node usage          [N, D]
      usage_agg        — NodeMetric aggregated percentile   [N, D]
      prod_usage       — NodeMetric prod-tier usage         [N, D]
      sys_usage        — NodeMetric system-tier usage (out-of-band
                         daemons; batchresource subtracts it)            [N, D]
      assigned_pending — estimated usage of assigned-but-unreported pods
                         (reference ``load_aware.go:315-358``)            [N, D]
      assigned_pending_prod — the prod-band slice of assigned_pending
                         (prod thresholds count only prod-tier pods)      [N, D]
      metric_fresh     — NodeMetric not expired             [N] bool
      has_metric       — a NodeMetric was EVER reported for the node
                         (filterExpiredNodeMetrics distinguishes
                         stale-metric nodes, which it may reject, from
                         never-reported ones, which the reference
                         Filter always admits)                [N] bool
      schedulable      — not cordoned, padded rows False    [N] bool
      cpu_amp          — CPU amplification ratio from the node annotation
                         (``apis/extension/node_resource_amplification.go``),
                         1.0 when unset                                   [N]
      custom_thresholds / custom_prod_thresholds — per-node LoadAware
                         threshold overrides from the usage-thresholds
                         annotation (``apis/extension/load_aware.go``);
                         0 = use the plugin-args global            [N, D]
      colo_reclaim     — per-node (cpu, memory) reclaim-ratio override
                         from the colocation-strategy annotation /
                         reclaim-ratio labels (``node_colocation.go``);
                         0 = use the cluster strategy              [N, 2]
      colo_enable      — per-node colocation enable override: -1 follow
                         the cluster strategy, 0 disable, 1 enable  [N]
    """

    allocatable: np.ndarray
    requested: np.ndarray
    usage_avg: np.ndarray
    usage_agg: np.ndarray
    prod_usage: np.ndarray
    sys_usage: np.ndarray
    assigned_pending: np.ndarray
    assigned_pending_prod: np.ndarray
    metric_fresh: np.ndarray
    has_metric: np.ndarray
    schedulable: np.ndarray
    cpu_amp: np.ndarray
    custom_thresholds: np.ndarray
    custom_prod_thresholds: np.ndarray
    colo_reclaim: np.ndarray
    colo_enable: np.ndarray
    n_real: int

    @classmethod
    def empty(cls, n_bucket: int, dims: int) -> "NodeArrays":
        z = lambda: np.zeros((n_bucket, dims), np.float32)
        return cls(
            allocatable=z(),
            requested=z(),
            usage_avg=z(),
            usage_agg=z(),
            prod_usage=z(),
            sys_usage=z(),
            assigned_pending=z(),
            assigned_pending_prod=z(),
            metric_fresh=np.zeros((n_bucket,), bool),
            has_metric=np.zeros((n_bucket,), bool),
            schedulable=np.zeros((n_bucket,), bool),
            cpu_amp=np.ones((n_bucket,), np.float32),
            custom_thresholds=z(),
            custom_prod_thresholds=z(),
            colo_reclaim=np.zeros((n_bucket, 2), np.float32),
            colo_enable=np.full((n_bucket,), -1, np.int8),
            n_real=0,
        )


@dataclasses.dataclass
class PodArrays:
    """Dense per-pending-pod state, padded to ``p_bucket`` rows.

    requests    — scheduling requests                      [P, D]
    priority    — raw k8s priority (sort key)              [P] int32
    prio_class  — koord band (extension.PriorityClass)     [P] int8
    qos         — koord QoS class                          [P] int8
    gang_id     — row-group id for coscheduling, -1 = none [P] int32
    quota_id    — leaf quota index, -1 = none              [P] int32
    valid       — padded rows False                        [P] bool
    """

    requests: np.ndarray
    priority: np.ndarray
    prio_class: np.ndarray
    qos: np.ndarray
    gang_id: np.ndarray
    quota_id: np.ndarray
    valid: np.ndarray
    #: row g: minMember of gang g (0 = unconstrained), indexed by gang_id
    gang_min: np.ndarray
    #: row g: True when gang g is NonStrict (placed members survive an
    #: under-filled gang instead of rolling back), indexed by gang_id
    gang_nonstrict: np.ndarray
    #: whole GPUs / fractional GPU percent per pod (DeviceShare)
    gpu_whole: np.ndarray
    gpu_share: np.ndarray
    #: whole RDMA NICs per pod (koordinator.sh/rdma, 100-unit instances)
    rdma: np.ndarray
    #: whole FPGAs per pod
    fpga: np.ndarray
    p_real: int
    #: gang id -> "namespace/name" key, parallel to gang_min rows
    gang_keys: List[str] = dataclasses.field(default_factory=list)
    #: pod uids in row order (collected in the single lowering pass so
    #: downstream consumers skip another per-pod walk)
    uids: List[str] = dataclasses.field(default_factory=list)
    #: leaf quota label per pod (None = unlabeled), row order
    quota_names: List[Optional[str]] = dataclasses.field(default_factory=list)
    #: rows whose estimate cannot use the vectorized request×scale path
    #: (explicit estimate / limits / custom scaling-factor annotation)
    est_override: Optional[np.ndarray] = None
    #: pod REQUIRES single-NUMA placement via the numa-topology-spec
    #: annotation (AnnotationNUMATopologySpec, ``numa_aware.go:29-31``) —
    #: independent of the LSR/LSE cpu-bind predicate
    numa_required: Optional[np.ndarray] = None
    #: quota non-preemptible pods (LabelPreemptible=false): admission
    #: additionally bounds them by quota MIN (``plugin.go:252-262``)
    non_preemptible: Optional[np.ndarray] = None
    #: rows served from the caller's interned-row cache this build
    intern_hits: int = 0

    @classmethod
    def empty(cls, p_bucket: int, dims: int) -> "PodArrays":
        return cls(
            requests=np.zeros((p_bucket, dims), np.float32),
            priority=np.zeros((p_bucket,), np.int32),
            prio_class=np.zeros((p_bucket,), np.int8),
            qos=np.zeros((p_bucket,), np.int8),
            gang_id=np.full((p_bucket,), -1, np.int32),
            quota_id=np.full((p_bucket,), -1, np.int32),
            valid=np.zeros((p_bucket,), bool),
            gang_min=np.zeros((p_bucket,), np.int32),
            gang_nonstrict=np.zeros((p_bucket,), bool),
            gpu_whole=np.zeros((p_bucket,), np.int32),
            gpu_share=np.zeros((p_bucket,), np.float32),
            rdma=np.zeros((p_bucket,), np.int32),
            fpga=np.zeros((p_bucket,), np.int32),
            p_real=0,
        )


@dataclasses.dataclass(slots=True)
class InternedPodRow:
    """Lowered row data for one pending pod, cached across cycles keyed on
    (uid, spec fingerprint) — ROADMAP item (c): a retry-heavy stream
    re-lowers the same still-pending pod every cycle, and the per-pod
    parse chain (requests walk, device-resource split, QoS/gang/quota
    label+annotation reads) was the measurable slice. The fingerprint is
    three tuple-hashes (requests, labels, annotations — far cheaper than
    the parse chain it replaces) so an in-place spec edit self-invalidates
    the entry rather than resurrecting stale rows."""

    fp: tuple
    req: np.ndarray          # [D] request row (owned copy)
    priority: int
    qos_explicit: int        # -1 = no explicit label
    gang: Optional[str]      # raw gang name (annotation/label), not ns-key
    gang_min: Optional[str]  # raw min-available label value
    gang_nonstrict: bool
    gpu_whole: int
    gpu_share: float
    rdma: float
    fpga: float
    quota_name: Optional[str]
    est_override: bool
    numa_required: bool
    non_preemptible: bool


def pod_fingerprint(pod: Pod) -> tuple:
    """Cheap content fingerprint of the spec fields ``build_pods`` reads."""
    spec = pod.spec
    meta = pod.meta
    return (
        spec.priority,
        hash(tuple(spec.requests.items())),
        hash(tuple(meta.labels.items())),
        hash(tuple(meta.annotations.items())),
        bool(spec.estimated),
        bool(spec.limits),
    )


@dataclasses.dataclass(slots=True)
class _AssumedPod:
    """Bookkeeping for one assumed/bound pod (the reference's
    ``podAssignCache`` entry). ``slots=True``: tens of thousands of these
    are constructed per bulk commit — attribute-dict allocation was a
    measurable slice of ``assume_pods_bulk``."""

    node_idx: int
    request: np.ndarray
    estimate: np.ndarray
    is_prod: bool
    assume_time: float
    absorbed: bool = False  # estimate already reflected in reported usage
    #: False while the assume is an optimistic scheduler-side charge not
    #: yet confirmed by the control plane (bind / pod_assumed sync). The
    #: reference scheduler cache expires such pods (kube-scheduler
    #: durationToExpireAssumedPod) so a rejected-then-deleted nomination
    #: can't leak capacity forever; see expire_assumed().
    confirmed: bool = True
    #: nominal (physical) CPU milli of a cpuset-bound pod whose charge was
    #: amplified; 0 for shared pods. Lets an amplification-ratio change
    #: re-base the live charge (upsert_node).
    bind_nominal_cpu: float = 0.0


class ClusterSnapshot:
    """Mutable host-side mirror of cluster state with index maps.

    The write path (informer events in the reference) is `upsert_node`,
    `set_node_metric`, `assume_pod`, `forget_pod`; the read path is
    `node_arrays` / `build_pods`, which hand padded numpy blocks to the
    jitted solver.
    """

    def __init__(
        self,
        config: Optional[SnapshotConfig] = None,
        agg_type: str = "p95",
        metric_expiry_s: float = 180.0,
    ):
        self.config = config or SnapshotConfig()
        #: coarse serialization between writers (informer handler threads)
        #: and the scheduling cycle — the reference scheduler cache's lock
        #: at batch granularity. Re-entrant: the cycle itself both reads
        #: and writes under it.
        import threading as _threading

        self.lock = _threading.RLock()
        res = self.config.resources
        self._cpu_dim = res.index(ext.RES_CPU) if ext.RES_CPU in res else 0
        self._res_index = {r: j for j, r in enumerate(res)}
        #: QoS label string → int, memoized across build_pods calls
        self._qos_label_cache: Dict[str, int] = {}
        #: NodeMetric aggregation percentile / expiry used at ingest
        #: (wired from LoadAwareSchedulingArgs by BatchScheduler)
        self.agg_type = agg_type
        self.metric_expiry_s = metric_expiry_s
        self._node_index: Dict[str, int] = {}
        self._node_names: List[str] = []
        self._free_node_slots: List[int] = []
        #: bumped on any node add/remove — cheap staleness check for
        #: consumers caching node-derived views (reservation candidates)
        self.node_epoch = 0
        self.nodes = NodeArrays.empty(self.config.min_bucket, self.config.dims)
        #: bumped on EVERY node-block mutation (upsert/remove, metric
        #: ingest, assume/forget). Device-resident consumers key their
        #: caches off it and pull the touched rows via drain_dirty().
        self.version = 0
        #: node rows touched since the last drain; _dirty_all marks a
        #: structural change (bucket growth / reset) that invalidates any
        #: resident mirror wholesale
        self._dirty_rows: set = set()
        self._dirty_all = True
        self._drain_owner: Optional[int] = None
        #: [n_bucket] bool — rows currently holding a real node (freed
        #: slots keep a stale name in _node_names; masks must not match it)
        self._present = np.zeros((self.config.min_bucket,), bool)
        #: inverted label index: (key, value) -> [n_bucket] bool rows.
        #: Built lazily per queried pair, then maintained eagerly on node
        #: upsert/remove — the vectorized node-constraint mask ANDs these
        #: bitmaps instead of walking per-node label dicts (P×N loop).
        self._label_rows: Dict[Tuple[str, str], np.ndarray] = {}
        #: pod uid -> _AssumedPod for assumed/bound pods
        self._assumed: Dict[str, "_AssumedPod"] = {}
        #: node name -> labels (nodeSelector/affinity masks read these)
        self._node_labels: Dict[str, Dict[str, str]] = {}
        #: node name -> annotations (per-node strategy overrides read these)
        self._node_annotations: Dict[str, Dict[str, str]] = {}

    def reset(self) -> None:
        """Clear all state in place (full-resync path: the snapshot object
        stays shared with the scheduler, so identity must survive)."""
        self._node_index.clear()
        self._node_names.clear()
        self._free_node_slots.clear()
        self.nodes = NodeArrays.empty(self.config.min_bucket, self.config.dims)
        self._assumed.clear()
        self._node_labels.clear()
        self._node_annotations.clear()
        self._present = np.zeros((self.config.min_bucket,), bool)
        self._label_rows.clear()
        self.node_epoch += 1
        self.touch_all()

    # ---- dirty-row tracking (device-resident consumers) ----

    def _touch(self, idx: int) -> None:
        self.version += 1
        if not self._dirty_all:
            self._dirty_rows.add(int(idx))

    def touch_rows(self, idxs: Iterable[int]) -> None:
        """Mark node rows as mutated (for the rare external writers that
        poke the node arrays directly instead of going through
        upsert/assume/metric APIs)."""
        self.version += 1
        if not self._dirty_all:
            self._dirty_rows.update(int(i) for i in idxs)

    def touch_all(self) -> None:
        """Invalidate any device-resident mirror wholesale (bucket growth,
        reset, or a writer that cannot enumerate the rows it touched)."""
        self.version += 1
        self._dirty_all = True
        self._dirty_rows.clear()

    def drain_dirty(self, owner: Optional[int] = None) -> Optional[np.ndarray]:
        """Consume the dirty-row marks: returns the sorted row indices
        touched since the last drain, or None when the resident mirror
        must be rebuilt from scratch (structural change). SINGLE-CONSUMER:
        the marks are cleared on return, so exactly one resident mirror
        may incrementally maintain itself per snapshot — pass a stable
        ``owner`` token and a second drainer degrades both to full
        re-lowers instead of silently missing rows."""
        if owner is not None:
            if self._drain_owner is None:
                self._drain_owner = owner
            elif self._drain_owner != owner:
                # contested drain: neither consumer can trust partial marks
                self._drain_owner = owner
                self._dirty_all = False
                self._dirty_rows.clear()
                return None
        if self._dirty_all:
            self._dirty_all = False
            self._dirty_rows.clear()
            return None
        rows = np.fromiter(
            self._dirty_rows, np.int32, count=len(self._dirty_rows)
        )
        rows.sort()
        self._dirty_rows.clear()
        return rows

    # ---- node-constraint inverted index ----

    #: cap on cached label-pair bitmaps: high-cardinality selectors
    #: (kubernetes.io/hostname=nodeX pins — one distinct value per node)
    #: would otherwise grow the index O(N²); pairs beyond the cap are
    #: built per query without caching (the pre-index cost, paid only by
    #: the overflow tail)
    _LABEL_INDEX_CAP = 8192

    def label_rows(self, key: str, value: str) -> np.ndarray:
        """[n_bucket] bool of nodes carrying ``key=value``. Built lazily
        per queried pair (one O(N) scan), maintained eagerly afterwards.
        Callers must treat the bitmap as read-only."""
        bm = self._label_rows.get((key, value))
        if bm is None:
            bm = np.zeros((self.nodes.allocatable.shape[0],), bool)
            for name, idx in self._node_index.items():
                if self._node_labels.get(name, {}).get(key) == value:
                    bm[idx] = True
            if len(self._label_rows) < self._LABEL_INDEX_CAP:
                self._label_rows[(key, value)] = bm
        return bm

    def constraint_row(
        self,
        node_name: Optional[str] = None,
        affinity_names: Optional[Sequence[str]] = None,
        selector: Optional[Mapping[str, str]] = None,
    ) -> np.ndarray:
        """[n_bucket] bool of nodes a pod's hard node constraints admit
        (spec.nodeName / required node-affinity names / nodeSelector — the
        upstream NodeName+NodeAffinity Filter semantics), built from the
        inverted index instead of a per-node label walk. Returns a fresh
        array the caller owns."""
        if node_name:
            row = np.zeros((self.nodes.allocatable.shape[0],), bool)
            idx = self._node_index.get(node_name)
            if idx is not None:
                row[idx] = True
        elif affinity_names is not None:
            row = np.zeros((self.nodes.allocatable.shape[0],), bool)
            for nm in affinity_names:
                idx = self._node_index.get(nm)
                if idx is not None:
                    row[idx] = True
        else:
            row = self._present.copy()
        if selector:
            for k, v in selector.items():
                row = row & self.label_rows(k, v)
        return row

    # ---- node side ----

    def _grow_nodes(self, need: int) -> None:
        cur = self.nodes.allocatable.shape[0]
        if need <= cur:
            return
        new = bucket_size(need, self.config.min_bucket)
        old = self.nodes

        def pad(a: np.ndarray) -> np.ndarray:
            width = [(0, new - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
            return np.pad(a, width)

        self.nodes = NodeArrays(
            allocatable=pad(old.allocatable),
            requested=pad(old.requested),
            usage_avg=pad(old.usage_avg),
            usage_agg=pad(old.usage_agg),
            prod_usage=pad(old.prod_usage),
            sys_usage=pad(old.sys_usage),
            assigned_pending=pad(old.assigned_pending),
            assigned_pending_prod=pad(old.assigned_pending_prod),
            metric_fresh=pad(old.metric_fresh),
            has_metric=pad(old.has_metric),
            schedulable=pad(old.schedulable),
            cpu_amp=np.pad(
                old.cpu_amp, (0, new - old.cpu_amp.shape[0]), constant_values=1.0
            ),
            custom_thresholds=pad(old.custom_thresholds),
            custom_prod_thresholds=pad(old.custom_prod_thresholds),
            colo_reclaim=pad(old.colo_reclaim),
            colo_enable=np.pad(
                old.colo_enable,
                (0, new - old.colo_enable.shape[0]),
                constant_values=-1,
            ),
            n_real=old.n_real,
        )
        self._present = np.pad(self._present, (0, new - self._present.shape[0]))
        for pair, bm in self._label_rows.items():
            self._label_rows[pair] = np.pad(bm, (0, new - bm.shape[0]))
        # bucket growth changes every resident-mirror shape
        self.touch_all()

    def upsert_node(self, node: Node) -> int:
        idx = self._node_index.get(node.meta.name)
        if idx is None:
            if self._free_node_slots:
                idx = self._free_node_slots.pop()
                self._node_names[idx] = node.meta.name
            else:
                idx = len(self._node_names)
                self._node_names.append(node.meta.name)
                self._grow_nodes(idx + 1)
            self._node_index[node.meta.name] = idx
            self.nodes.n_real = max(self.nodes.n_real, idx + 1)
            self.node_epoch += 1
        alloc = self.config.res_vector(node.status.allocatable)
        resv = ext.parse_node_reservation(node.meta.annotations)
        if resv is not None and resv.get("applyPolicy") in (
            None,
            "",
            ext.NODE_RESERVATION_POLICY_DEFAULT,
        ):
            # trim allocatable by the node-level reservation
            # (util.TrimNodeAllocatableByNodeReservation): reservedCPUs
            # overrides the cpu quantity; batch tiers already account the
            # reservation at the koord-manager and keep their values
            resources = dict(resv.get("resources") or {})
            cpus_str = resv.get("reservedCPUs") or ""
            if cpus_str:
                from .topology import parse_cpuset

                try:
                    resources[ext.RES_CPU] = len(parse_cpuset(cpus_str)) * 1000.0
                except ValueError:
                    pass
            reserved = self.config.res_vector(resources)
            for batch_res in (ext.RES_BATCH_CPU, ext.RES_BATCH_MEMORY):
                if batch_res in self._res_index:
                    reserved[self._res_index[batch_res]] = 0.0
            alloc = np.maximum(alloc - reserved, 0.0)
        self.nodes.allocatable[idx] = alloc
        custom = ext.parse_custom_usage_thresholds(node.meta.annotations)
        self.nodes.custom_thresholds[idx] = 0.0
        self.nodes.custom_prod_thresholds[idx] = 0.0
        if custom is not None:
            for field, arr in (
                ("usageThresholds", self.nodes.custom_thresholds),
                ("prodUsageThresholds", self.nodes.custom_prod_thresholds),
            ):
                table = custom.get(field)
                if isinstance(table, dict):
                    arr[idx] = self.config.res_vector(
                        {
                            k: v
                            for k, v in table.items()
                            if isinstance(v, (int, float))
                            and not isinstance(v, bool)
                        }
                    )
        # per-node colocation overrides (node_colocation.go), parsed once
        # here so the manager's reconcile loop reads plain arrays
        self.nodes.colo_reclaim[idx] = 0.0
        self.nodes.colo_enable[idx] = -1
        colo = ext.parse_node_colocation_strategy(node.meta.annotations)
        if colo is not None:
            if isinstance(colo.get("enable"), bool):
                self.nodes.colo_enable[idx] = int(colo["enable"])
            rr = colo.get("reserveRatio")
            if (
                isinstance(rr, (int, float))
                and not isinstance(rr, bool)
                and 0.0 <= rr < 1.0
            ):
                self.nodes.colo_reclaim[idx] = 1.0 - float(rr)
        for col, key in (
            (0, ext.LABEL_CPU_RECLAIM_RATIO),
            (1, ext.LABEL_MEMORY_RECLAIM_RATIO),
        ):
            ratio = ext.parse_reclaim_ratio(node.meta.labels, key)
            if ratio is not None:
                self.nodes.colo_reclaim[idx, col] = ratio
        self.nodes.schedulable[idx] = not node.unschedulable
        amp = ext.parse_node_amplification(node.meta.annotations)
        new_amp = max(float(amp.get(ext.RES_CPU, 1.0)), 1.0)
        old_amp = float(self.nodes.cpu_amp[idx])
        self.nodes.cpu_amp[idx] = new_amp
        if new_amp != old_amp:
            # re-base live bound pods' amplified charges onto the new ratio
            # (NUMAManager._sync_amp does the same for zone accounting) —
            # without this the node-level requested array drifts for as
            # long as the pods live
            for ap in self._assumed.values():
                if ap.node_idx != idx or ap.bind_nominal_cpu <= 0:
                    continue
                new_charge = ap.bind_nominal_cpu * new_amp
                self.nodes.requested[idx, self._cpu_dim] += (
                    new_charge - ap.request[self._cpu_dim]
                )
                ap.request = ap.request.copy()
                ap.request[self._cpu_dim] = new_charge
        new_labels = dict(node.meta.labels)
        old_labels = self._node_labels.get(node.meta.name)
        if old_labels != new_labels:
            # keep only bitmaps that already exist current — absent pairs
            # rebuild lazily on first query
            if self._label_rows:
                for k, v in (old_labels or {}).items():
                    if new_labels.get(k) != v:
                        bm = self._label_rows.get((k, v))
                        if bm is not None:
                            bm[idx] = False
                for k, v in new_labels.items():
                    if old_labels is None or old_labels.get(k) != v:
                        bm = self._label_rows.get((k, v))
                        if bm is not None:
                            bm[idx] = True
        self._present[idx] = True
        self._node_labels[node.meta.name] = new_labels
        self._node_annotations[node.meta.name] = dict(node.meta.annotations)
        self._touch(idx)
        return idx

    def node_labels(self, name: str) -> Mapping[str, str]:
        return self._node_labels.get(name, {})

    def node_annotations(self, name: str) -> Mapping[str, str]:
        return self._node_annotations.get(name, {})

    def remove_node(self, name: str) -> None:
        idx = self._node_index.pop(name, None)
        old_labels = self._node_labels.pop(name, None)
        self._node_annotations.pop(name, None)
        if idx is None:
            return
        if old_labels and self._label_rows:
            for k, v in old_labels.items():
                bm = self._label_rows.get((k, v))
                if bm is not None:
                    bm[idx] = False
        self._present[idx] = False
        self._touch(idx)
        self.node_epoch += 1
        for arr in (
            self.nodes.allocatable,
            self.nodes.requested,
            self.nodes.usage_avg,
            self.nodes.usage_agg,
            self.nodes.prod_usage,
            self.nodes.assigned_pending,
            self.nodes.assigned_pending_prod,
        ):
            arr[idx] = 0
        self.nodes.metric_fresh[idx] = False
        self.nodes.has_metric[idx] = False
        self.nodes.schedulable[idx] = False
        self.nodes.cpu_amp[idx] = 1.0
        self.nodes.custom_thresholds[idx] = 0.0
        self.nodes.custom_prod_thresholds[idx] = 0.0
        self.nodes.colo_reclaim[idx] = 0.0
        self.nodes.colo_enable[idx] = -1
        # Drop assumed-pod bookkeeping for the dead node so a later
        # forget_pod cannot corrupt whichever node reuses this slot.
        self._assumed = {
            uid: ap for uid, ap in self._assumed.items() if ap.node_idx != idx
        }
        self._free_node_slots.append(idx)

    def node_id(self, name: str) -> Optional[int]:
        return self._node_index.get(name)

    def node_name(self, idx: int) -> str:
        return self._node_names[idx]

    @property
    def node_count(self) -> int:
        return len(self._node_index)

    def set_node_metric(
        self,
        metric: NodeMetric,
        now: Optional[float] = None,
        agg_type: Optional[str] = None,
        expiry_s: Optional[float] = None,
    ) -> None:
        """Ingest a NodeMetric report (reference LoadAware reads the CRD at
        Filter/Score time, ``load_aware.go:163-179``; we fold it into the
        node block at informer time instead).

        Pods assumed *before* the report's update_time are considered
        reflected in the reported usage and their pending estimates are
        absorbed; pods assumed after keep contributing (reference
        ``load_aware.go:315-358`` compares assign time vs metric time).
        """
        idx = self._node_index.get(metric.meta.name)
        if idx is None:
            return
        cfg = self.config
        self.nodes.usage_avg[idx] = cfg.res_vector(metric.node_usage.usage)
        agg = metric.aggregated.get(agg_type or self.agg_type)
        self.nodes.usage_agg[idx] = cfg.res_vector(
            agg.usage if agg is not None else metric.node_usage.usage
        )
        self.nodes.prod_usage[idx] = cfg.res_vector(metric.prod_usage.usage)
        self.nodes.sys_usage[idx] = cfg.res_vector(metric.sys_usage.usage)
        import time as _t

        now = now if now is not None else _t.time()
        fresh = not metric.expired(
            now, expiry_s if expiry_s is not None else self.metric_expiry_s
        )
        self.nodes.metric_fresh[idx] = fresh
        self.nodes.has_metric[idx] = True
        self._touch(idx)
        if fresh:
            for ap in self._assumed.values():
                if (
                    ap.node_idx == idx
                    and not ap.absorbed
                    and ap.assume_time <= metric.update_time
                ):
                    self.nodes.assigned_pending[idx] -= ap.estimate
                    if ap.is_prod:
                        self.nodes.assigned_pending_prod[idx] -= ap.estimate
                    ap.absorbed = True

    # ---- assume / forget (reference scheduler cache + podAssignCache) ----

    def assume_pod(
        self,
        pod: Pod,
        node_name: str,
        estimated: Optional[np.ndarray] = None,
        now: Optional[float] = None,
        confirmed: bool = True,
        request: Optional[np.ndarray] = None,
        bind_nominal_cpu: Optional[float] = None,
    ) -> bool:
        """Charge ``pod`` against ``node_name``; returns False (no-op) when
        the node is absent — an assume racing a node delete is a
        reconciliation matter for the caller, not an invariant violation
        (the reference cache tolerates AssumePod on a deleted node the same
        way: the informer's next sync repairs it)."""
        import time as _t

        idx = self._node_index.get(node_name)
        if idx is None:
            return False
        # idempotent re-assume: a commit for a pod the solver already
        # assumed (or a move to another node) replaces, never double-counts.
        # A same-node re-assume of an absorbed pod stays absorbed — its load
        # already lives in the reported usage baseline, not in pending.
        prev = self._assumed.get(pod.meta.uid)
        absorbed = prev is not None and prev.absorbed and prev.node_idx == idx
        if prev is not None:
            self.forget_pod(pod.meta.uid)
        # callers that already lowered the request vector pass it in
        req = (
            np.asarray(request, np.float32)
            if request is not None
            else self.config.res_vector(pod.spec.requests)
        )
        # the usage estimate defaults to the *physical* request — a bound
        # pod on an amplified node still only burns its physical cores
        est = np.asarray(
            estimated if estimated is not None else req, np.float32
        )
        # cpuset-bound pods consume physical cores: on an amplified node
        # their CPU charge counts ×ratio (nodenumaresource/plugin.go:430-438
        # — requested − allocated + amplify(allocated)). Charging here keeps
        # every assume/forget path symmetric, with or without a registered
        # NUMA topology.
        amp = float(self.nodes.cpu_amp[idx])
        # callers that lowered the bind predicate already (BatchScheduler's
        # per-chunk arrays) pass bind_nominal_cpu to skip the recompute
        if bind_nominal_cpu is not None:
            bind_nominal = bind_nominal_cpu
        else:
            bind_nominal = (
                float(req[self._cpu_dim]) if ext.wants_cpu_bind(pod) else 0.0
            )
        if bind_nominal > 0 and amp > 1.0:
            req = req.copy()
            req[self._cpu_dim] *= amp
        self.nodes.requested[idx] += req
        is_prod = pod.priority_class == ext.PriorityClass.PROD
        if not absorbed:
            self.nodes.assigned_pending[idx] += est
            if is_prod:
                self.nodes.assigned_pending_prod[idx] += est
        self._assumed[pod.meta.uid] = _AssumedPod(
            node_idx=idx,
            request=req,
            estimate=est,
            is_prod=is_prod,
            assume_time=now if now is not None else _t.time(),
            absorbed=absorbed,
            confirmed=confirmed,
            bind_nominal_cpu=bind_nominal,
        )
        self._touch(idx)
        return True

    def assume_pods_bulk(
        self,
        pods: Sequence[Pod],
        node_idxs: np.ndarray,
        charged_rows: np.ndarray,
        est_rows: np.ndarray,
        is_prod: np.ndarray,
        bind_nominals: np.ndarray,
        now: Optional[float] = None,
        confirmed: bool = False,
    ) -> None:
        """Vectorized assume for a batch of fresh winners (the per-winner
        ``assume_pod`` was the commit loop's hot spot). ``charged_rows``
        are the rows to charge verbatim — the caller has already applied
        the amplified-CPU surcharge for bound pods (``bind_nominals``
        records their physical CPU for ratio re-basing). Callers must
        route pods that may already be assumed through ``assume_pod``
        (this path skips the idempotent-replace check)."""
        import time as _t

        if now is None:
            now = _t.time()

        def _scatter_add(target: np.ndarray, idxs: np.ndarray, rows: np.ndarray):
            # np.add.at is an order of magnitude slower than sort+reduceat
            # for duplicate indices (the common many-pods-per-node case)
            if idxs.size == 0:
                return
            perm = np.argsort(idxs, kind="stable")
            si = idxs[perm]
            sr = rows[perm]
            starts = np.nonzero(np.r_[True, si[1:] != si[:-1]])[0]
            target[si[starts]] += np.add.reduceat(sr, starts, axis=0)

        _scatter_add(self.nodes.requested, node_idxs, charged_rows)
        _scatter_add(self.nodes.assigned_pending, node_idxs, est_rows)
        if is_prod.any():
            _scatter_add(
                self.nodes.assigned_pending_prod,
                node_idxs[is_prod],
                est_rows[is_prod],
            )
        self.touch_rows(np.unique(node_idxs))
        assumed = self._assumed
        # one tolist per column: per-element numpy scalar indexing in a
        # 10k+ iteration loop costs ~1µs each; list(matrix) materializes
        # all row views in C, and the positional ctor skips kwarg parsing
        idx_l = node_idxs.tolist()
        prod_l = is_prod.tolist()
        nom_l = np.asarray(bind_nominals, np.float64).tolist()
        req_l = list(charged_rows)
        est_l = list(est_rows)
        ctor = _AssumedPod
        for k, pod in enumerate(pods):
            assumed[pod.meta.uid] = ctor(
                idx_l[k], req_l[k], est_l[k], prod_l[k], now,
                False, confirmed, nom_l[k],
            )

    def is_assumed(self, pod_uid: str) -> bool:
        """Whether a pod currently holds an assume/bound charge — the
        liveness signal external reconcilers (reservation owner drift) key
        off, without reaching into the internal store."""
        return pod_uid in self._assumed

    def expire_assumed(self, now: float, ttl: float) -> int:
        """Forget optimistic (unconfirmed) assumes older than ``ttl``
        seconds — the reference scheduler cache's assumed-pod expiration.
        A confirmed assume (bind observed / pod_assumed sync) never
        expires; its lifecycle belongs to pod_forgotten/delete events.
        Returns the number of pods expired."""
        stale = [
            uid
            for uid, ap in self._assumed.items()
            if not ap.confirmed and now - ap.assume_time > ttl
        ]
        for uid in stale:
            self.forget_pod(uid)
        return len(stale)

    def confirm_pod(self, pod_uid: str) -> bool:
        """Promote an optimistic assume to confirmed (bind observed /
        pod_assumed sync, or a ghost hold whose lifecycle is owned by the
        ReservationManager) so ``expire_assumed`` never drops it."""
        ap = self._assumed.get(pod_uid)
        if ap is None:
            return False
        ap.confirmed = True
        return True

    def forget_pod(self, pod_uid: str) -> None:
        ap = self._assumed.pop(pod_uid, None)
        if ap is None:
            return
        self.nodes.requested[ap.node_idx] -= ap.request
        if not ap.absorbed:
            self.nodes.assigned_pending[ap.node_idx] -= ap.estimate
            if ap.is_prod:
                self.nodes.assigned_pending_prod[ap.node_idx] -= ap.estimate
        self._touch(ap.node_idx)

    def restore_assumed(self, pod_uid: str, entry: "_AssumedPod") -> None:
        """Re-install a previously captured assume entry verbatim —
        transactional-rollback support for the Reserve journal: a
        re-assumed pod whose chunk commit failed mid-flight gets its
        PRIOR charge (node, request, estimate, absorbed state) back
        bit-exactly. Any current charge for the uid is removed first;
        both paths touch the dirty-row ledger so the device-resident
        mirror reconverges on the next refresh."""
        if pod_uid in self._assumed:
            self.forget_pod(pod_uid)
        self.nodes.requested[entry.node_idx] += entry.request
        if not entry.absorbed:
            self.nodes.assigned_pending[entry.node_idx] += entry.estimate
            if entry.is_prod:
                self.nodes.assigned_pending_prod[entry.node_idx] += entry.estimate
        self._assumed[pod_uid] = entry
        self._touch(entry.node_idx)

    # ---- pod batch build ----

    def build_pods(
        self,
        pods: Sequence[Pod],
        min_member_by_gang: Optional[Mapping[str, int]] = None,
        nonstrict_by_gang: Optional[Mapping[str, bool]] = None,
        bucket: Optional[int] = None,
        row_cache: Optional[Dict[str, "InternedPodRow"]] = None,
    ) -> PodArrays:
        """Lower pending pods to dense arrays. ``bucket`` overrides the
        padded row count (the scanned multi-chunk dispatch needs every
        chunk on ONE shape); it must be ≥ the natural bucket.

        Gang minMember resolution order (reference: PodGroup CRD or the
        ``pod-group.scheduling.sigs.k8s.io/min-available`` annotation,
        ``pkg/scheduler/plugins/coscheduling/core/core.go``):
        explicit mapping > pod label > member count in this batch. The gang
        mode resolves the same way (``nonstrict_by_gang`` from the
        PodGroupManager, else the first member's mode annotation —
        gang.go:128-132 parses once at gang creation).
        """
        p_bucket = bucket_size(len(pods), self.config.min_bucket)
        if bucket is not None:
            if bucket < len(pods):
                raise ValueError(
                    f"bucket override {bucket} smaller than pod count "
                    f"{len(pods)}"
                )
            p_bucket = max(p_bucket, bucket)
        out = PodArrays.empty(p_bucket, self.config.dims)
        gang_ids: Dict[str, int] = {}
        gang_members: Dict[int, int] = {}
        gang_label_min: Dict[int, int] = {}
        gang_pod_mode: Dict[int, bool] = {}
        # Tight single-pass lowering: the per-pod res_vector / property /
        # parse_* calls were a measurable slice of the per-batch host time
        # (one dict walk over requests replaces 5 separate parses;
        # priority-band and fallback-QoS resolution vectorize after).
        res_index = self._res_index
        req_rows = out.requests
        priority = out.priority
        n = len(pods)
        explicit_qos: List[Tuple[int, int]] = []
        qos_cache: Dict[str, int] = self._qos_label_cache
        uids: List[str] = []
        quota_names: List[Optional[str]] = []
        est_override = np.zeros(p_bucket, bool)
        numa_required = np.zeros(p_bucket, bool)
        non_preemptible = np.zeros(p_bucket, bool)
        preemptible_key = ext.LABEL_PREEMPTIBLE
        disable_key = ext.LABEL_DISABLE_PREEMPTIBLE
        quota_key = ext.LABEL_QUOTA_NAME
        custom_est_key = ext.ANNOTATION_CUSTOM_ESTIMATED_SCALING_FACTORS
        numa_spec_key = ext.ANNOTATION_NUMA_TOPOLOGY_SPEC
        intern_hits = 0
        for i, pod in enumerate(pods):
            spec = pod.spec
            meta = pod.meta
            labels = meta.labels
            uids.append(meta.uid)
            ent = fp = None
            if row_cache is not None:
                fp = pod_fingerprint(pod)
                ent = row_cache.get(meta.uid)
                if ent is not None and ent.fp != fp:
                    # spec changed under the same uid: stale rows must
                    # never resurrect — fall through to a fresh parse
                    ent = None
            if ent is not None:
                # interned fast path (ROADMAP item c): restore the
                # lowered row verbatim; gang GROUPING below still runs
                # per batch (gang ids are batch-local)
                intern_hits += 1
                quota_names.append(ent.quota_name)
                non_preemptible[i] = ent.non_preemptible
                est_override[i] = ent.est_override
                numa_required[i] = ent.numa_required
                priority[i] = ent.priority
                req_rows[i] = ent.req
                out.gpu_whole[i] = ent.gpu_whole
                out.gpu_share[i] = ent.gpu_share
                out.rdma[i] = ent.rdma
                out.fpga[i] = ent.fpga
                if ent.qos_explicit >= 0:
                    explicit_qos.append((i, ent.qos_explicit))
                gang = ent.gang
                label_min = ent.gang_min
                gang_pod_nonstrict = ent.gang_nonstrict
            else:
                quota_names.append(labels.get(quota_key))
                if (
                    labels.get(preemptible_key) == "false"
                    or labels.get(disable_key) == "true"
                ):
                    non_preemptible[i] = True
                if spec.estimated or spec.limits or custom_est_key in meta.annotations:
                    est_override[i] = True
                if numa_spec_key in meta.annotations:
                    # pod-level NUMA requirement API (numa_aware.go:29-31):
                    # SingleNUMANode requires a single-zone fit for THIS pod
                    # regardless of the node's own policy label
                    numa_spec = ext.parse_numa_topology_spec(meta.annotations)
                    if (
                        numa_spec
                        and numa_spec.get("numaTopologyPolicy") == "SingleNUMANode"
                    ):
                        numa_required[i] = True
                priority[i] = spec.priority or 0
                whole = 0
                ratio_mem: Optional[float] = None
                core = 0.0
                for k, v in spec.requests.items():
                    j = res_index.get(k)
                    if j is not None:
                        req_rows[i, j] = v
                    # device parsing is NOT exclusive with the dense axis: a
                    # deployment may append device resources to
                    # SnapshotConfig.resources (DEFAULT_RESOURCES invites it)
                    # and the device manager must still see the request
                    if k == ext.RES_GPU:
                        whole = int(v)
                    elif k == ext.RES_GPU_MEMORY_RATIO:
                        ratio_mem = float(v)
                    elif k == ext.RES_GPU_CORE:
                        core = float(v)
                    elif k == ext.RES_RDMA:
                        out.rdma[i] = ext._count_request(spec.requests, k)
                    elif k == ext.RES_FPGA:
                        out.fpga[i] = ext._count_request(spec.requests, k)
                ratio = ratio_mem if ratio_mem is not None else core
                if ratio >= 100.0:
                    whole += int(ratio // 100.0)
                    ratio = ratio % 100.0
                if whole or ratio:
                    out.gpu_whole[i] = whole
                    out.gpu_share[i] = ratio
                qv = -1
                qos_label = labels.get(ext.LABEL_POD_QOS)
                if qos_label:
                    qv = qos_cache.get(qos_label)
                    if qv is None:
                        qv = int(ext.QoSClass.parse(qos_label))
                        qos_cache[qos_label] = qv
                    if qv != int(ext.QoSClass.NONE):
                        explicit_qos.append((i, qv))
                    else:
                        qv = -1
                gang = meta.annotations.get(
                    ext.ANNOTATION_GANG_NAME
                ) or labels.get(ext.LABEL_GANG_NAME)
                label_min = None
                gang_pod_nonstrict = False
                if gang:
                    label_min = meta.annotations.get(
                        ext.ANNOTATION_GANG_MIN_AVAILABLE
                    ) or labels.get(ext.LABEL_GANG_MIN_AVAILABLE)
                    gang_pod_nonstrict = (
                        meta.annotations.get(ext.ANNOTATION_GANG_MODE)
                        == ext.GANG_MODE_NONSTRICT
                    )
                if row_cache is not None:
                    row_cache[meta.uid] = InternedPodRow(
                        fp=fp,
                        req=req_rows[i].copy(),
                        priority=int(priority[i]),
                        qos_explicit=qv,
                        gang=gang,
                        gang_min=label_min,
                        gang_nonstrict=gang_pod_nonstrict,
                        gpu_whole=int(out.gpu_whole[i]),
                        gpu_share=float(out.gpu_share[i]),
                        rdma=float(out.rdma[i]),
                        fpga=float(out.fpga[i]),
                        quota_name=quota_names[-1],
                        est_override=bool(est_override[i]),
                        numa_required=bool(numa_required[i]),
                        non_preemptible=bool(non_preemptible[i]),
                    )
            if gang:
                key = f"{meta.namespace}/{gang}"
                gid = gang_ids.setdefault(key, len(gang_ids))
                out.gang_id[i] = gid
                gang_members[gid] = gang_members.get(gid, 0) + 1
                if label_min is not None:
                    try:
                        gang_label_min[gid] = int(label_min)
                    except ValueError:
                        pass
                if gid not in gang_pod_mode:
                    gang_pod_mode[gid] = gang_pod_nonstrict
        out.valid[:n] = True
        # vectorized priority-band resolution from the canonical band
        # table (priority.go:29-48; same source as from_priority)
        prio_n = priority[:n]
        out.prio_class[:n] = np.select(
            [
                (prio_n >= lo) & (prio_n <= hi)
                for lo, hi in ext.PRIORITY_BANDS.values()
            ],
            [int(band) for band in ext.PRIORITY_BANDS],
            default=int(ext.PriorityClass.NONE),
        ).astype(np.int8)
        # fallback QoS by band (qos_for_priority), explicit labels override
        out.qos[:n] = _QOS_BY_BAND[out.prio_class[:n]]
        for i, qv in explicit_qos:
            out.qos[i] = qv
        out.gang_keys = [k for k, _ in sorted(gang_ids.items(), key=lambda kv: kv[1])]
        for key, gid in gang_ids.items():
            explicit = (min_member_by_gang or {}).get(key)
            if explicit is not None:
                out.gang_min[gid] = explicit
            elif gid in gang_label_min:
                out.gang_min[gid] = gang_label_min[gid]
            else:
                out.gang_min[gid] = gang_members[gid]
            declared = (nonstrict_by_gang or {}).get(key)
            out.gang_nonstrict[gid] = (
                declared
                if declared is not None
                else gang_pod_mode.get(gid, False)
            )
        out.p_real = len(pods)
        out.uids = uids
        out.quota_names = quota_names
        out.est_override = est_override
        out.numa_required = numa_required
        out.non_preemptible = non_preemptible
        out.intern_hits = intern_hits
        return out
