"""Core API object model (the rebuild's "CRDs").

Lightweight dataclasses standing in for the reference's CRD Go types under
``apis/`` (reference: ``apis/slo/v1alpha1/nodemetric_types.go``,
``apis/scheduling/v1alpha1/reservation_types.go``, ``device_types.go:104``,
``pod_migration_job_types.go:27-40``, thirdparty ElasticQuota/PodGroup).

These objects are the *host-side* representation; the solver never sees them.
``core.snapshot.SnapshotBuilder`` lowers them into dense arrays once, and all
hot-path decisions happen on tensors.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from .extension import (
    DEFAULT_RESOURCES,
    LABEL_POD_QOS,
    PriorityClass,
    QoSClass,
    qos_for_priority,
)

ResourceList = Dict[str, float]


def _res(d: Optional[Mapping[str, float]]) -> ResourceList:
    return dict(d) if d else {}


@dataclasses.dataclass
class ObjectMeta:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: controlling workload's UID (k8s ownerReferences controller=true);
    #: "" = no controller (bare pod)
    owner_uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"


@dataclasses.dataclass
class PodSpec:
    """Flattened pod scheduling spec.

    ``requests``/``limits`` use snapshot units: cpu in milli-cores, memory in
    MiB, extended resources in their native integer unit.
    """

    requests: ResourceList = dataclasses.field(default_factory=dict)
    limits: ResourceList = dataclasses.field(default_factory=dict)
    #: explicit usage estimate overriding the estimator's request scaling
    #: (reference estimator framework, loadaware/estimator/estimator.go:
    #: the default estimator scales requests, but callers with a measured
    #: profile — e.g. the control plane's PendingPod.estimated — pass it)
    estimated: Optional[ResourceList] = None
    priority: Optional[int] = None
    scheduler_name: str = "koord-scheduler"
    node_name: Optional[str] = None
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    affinity_required_nodes: Optional[Sequence[str]] = None  # simplified nodeAffinity


class PodPhase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclasses.dataclass
class Pod:
    meta: ObjectMeta
    spec: PodSpec = dataclasses.field(default_factory=PodSpec)
    phase: PodPhase = PodPhase.PENDING

    @property
    def qos(self) -> QoSClass:
        explicit = QoSClass.parse(self.meta.labels.get(LABEL_POD_QOS))
        if explicit is not QoSClass.NONE:
            return explicit
        return qos_for_priority(self.priority_class)

    @property
    def priority_class(self) -> PriorityClass:
        return PriorityClass.from_priority(self.spec.priority)


@dataclasses.dataclass
class NodeStatus:
    allocatable: ResourceList = dataclasses.field(default_factory=dict)
    capacity: ResourceList = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Node:
    meta: ObjectMeta
    status: NodeStatus = dataclasses.field(default_factory=NodeStatus)
    unschedulable: bool = False


# --- slo.koordinator.sh/NodeMetric (nodemetric_types.go) ---

#: aggregation percentile keys reported by the node agent
AGG_P50, AGG_P90, AGG_P95, AGG_P99 = "p50", "p90", "p95", "p99"
AGG_TYPES = (AGG_P50, AGG_P90, AGG_P95, AGG_P99)


@dataclasses.dataclass
class ResourceMetric:
    usage: ResourceList = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PodMetricInfo:
    namespace: str
    name: str
    usage: ResourceList = dataclasses.field(default_factory=dict)
    priority_class: PriorityClass = PriorityClass.NONE


@dataclasses.dataclass
class NodeMetric:
    """Node + pod usage report (reference ``nodemetric_types.go``).

    ``aggregated`` maps percentile key → usage over the aggregation window;
    ``prod_usage`` mirrors the reference's SystemUsage+ProdUsage split used by
    LoadAware's prod-usage thresholds.
    """

    meta: ObjectMeta
    node_usage: ResourceMetric = dataclasses.field(default_factory=ResourceMetric)
    prod_usage: ResourceMetric = dataclasses.field(default_factory=ResourceMetric)
    sys_usage: ResourceMetric = dataclasses.field(default_factory=ResourceMetric)
    aggregated: Dict[str, ResourceMetric] = dataclasses.field(default_factory=dict)
    pod_metrics: List[PodMetricInfo] = dataclasses.field(default_factory=list)
    update_time: float = dataclasses.field(default_factory=time.time)
    report_interval_s: float = 60.0  # states_nodemetric.go:61-66
    aggregate_window_s: float = 300.0

    def expired(self, now: float, expiry_s: float = 180.0) -> bool:
        """LoadAware degrades to request-based estimation when the metric is
        stale (reference ``load_aware.go:143-149``)."""
        return (now - self.update_time) > expiry_s


# --- scheduling.koordinator.sh/Reservation (reservation_types.go) ---


class ReservationPhase(enum.Enum):
    PENDING = "Pending"
    AVAILABLE = "Available"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


@dataclasses.dataclass
class ReservationOwner:
    """Owner matching: label selector and/or controller reference."""

    label_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    namespace: Optional[str] = None


#: reservation allocate policies (reference
#: ``apis/scheduling/v1alpha1/reservation_types.go:78-97``): "" (Default,
#: deprecated — treated as Aligned) / Aligned: the pod allocates from the
#: reservation FIRST and may spill to node free capacity; Restricted:
#: resources the reservation declares may ONLY come from the reservation
#: (undeclared dims still allocate from the node)
RESERVATION_ALLOCATE_POLICY_ALIGNED = "Aligned"
RESERVATION_ALLOCATE_POLICY_RESTRICTED = "Restricted"


@dataclasses.dataclass
class Reservation:
    meta: ObjectMeta
    requests: ResourceList = dataclasses.field(default_factory=dict)
    owners: List[ReservationOwner] = dataclasses.field(default_factory=list)
    allocate_once: bool = True
    ttl_s: Optional[float] = None
    phase: ReservationPhase = ReservationPhase.PENDING
    node_name: Optional[str] = None          # set once scheduled
    allocated: ResourceList = dataclasses.field(default_factory=dict)
    current_owners: List[str] = dataclasses.field(default_factory=list)  # pod uids
    available_time: Optional[float] = None   # when it became Available (TTL base)
    #: "" | "Aligned" | "Restricted" (reservation_types.go:78-97)
    allocate_policy: str = ""


# --- scheduling.koordinator.sh/Device (device_types.go:104) ---


@dataclasses.dataclass
class DeviceInfo:
    dev_type: str               # "gpu" | "rdma"
    minor: int
    resources: ResourceList = dataclasses.field(default_factory=dict)
    numa_node: int = -1
    pcie_bus: str = ""
    #: SR-IOV virtual-function bus IDs exposed by this device (reference
    #: ``apis/extension/device_share.go:126-139`` VirtualFunctions): a NIC
    #: with VFs is shared across pods VF-by-VF, never allocated whole
    vfs: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class GPUPartition:
    """One interconnect-complete GPU group (reference
    ``apis/extension/device_share.go:217`` ``GPUPartition``): the minors
    share a link domain (NVLink analog; for TPU hosts, an ICI ring), and
    multi-device allocations should land entirely inside one partition."""

    minors: List[int]
    link_type: str = "NVLink"
    ring_bus_bandwidth: float = 0.0     # GB/s; 0 = unspecified
    allocation_score: int = 1

    @property
    def minors_mask(self) -> int:
        m = 0
        for minor in self.minors:
            m |= 1 << minor
        return m


@dataclasses.dataclass
class Device:
    """Per-node device inventory reported by the node agent."""

    meta: ObjectMeta            # name == node name
    devices: List[DeviceInfo] = dataclasses.field(default_factory=list)
    #: size -> partitions of exactly that many minors (reference
    #: ``GPUPartitionTable``, annotated on the Device CR)
    partitions: Dict[int, List[GPUPartition]] = dataclasses.field(
        default_factory=dict
    )
    #: "Honor" (partition table is binding) | "Prefer" (fall back to
    #: topology packing when no partition fits) | "" (ignore table)
    partition_policy: str = ""


@dataclasses.dataclass
class TopologyZone:
    """One NUMA zone of a node (external NodeResourceTopology CRD,
    ``k8stopologyawareschedwg``; reported by koordlet's
    ``statesinformer/impl/states_noderesourcetopology.go``)."""

    name: str                   # e.g. "node-0"
    zone_type: str = "Node"
    allocatable: ResourceList = dataclasses.field(default_factory=dict)
    capacity: ResourceList = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeResourceTopology:
    """Per-node NUMA topology + kubelet CPU-manager state report.

    ``cpu_topology`` maps logical cpu id → (core, numa node, socket);
    ``kubelet_reserved_cpus`` mirrors the kubelet cpu-manager state the
    reference reads back through annotations
    (``statesinformer/impl/states_noderesourcetopology.go``).
    """

    meta: ObjectMeta            # name == node name
    zones: List[TopologyZone] = dataclasses.field(default_factory=list)
    cpu_topology: Dict[int, Tuple[int, int, int]] = dataclasses.field(
        default_factory=dict
    )
    kubelet_reserved_cpus: List[int] = dataclasses.field(default_factory=list)
    topology_policy: str = "None"


# --- thirdparty PodGroup (gang) ---


@dataclasses.dataclass
class PodGroup:
    meta: ObjectMeta
    min_member: int = 1
    total_member: Optional[int] = None
    schedule_timeout_s: float = 600.0


# --- thirdparty ElasticQuota ---


@dataclasses.dataclass
class ElasticQuota:
    meta: ObjectMeta
    min: ResourceList = dataclasses.field(default_factory=dict)
    max: ResourceList = dataclasses.field(default_factory=dict)
    shared_weight: ResourceList = dataclasses.field(default_factory=dict)
    parent: str = ""            # quota tree edge (label quota.scheduling.../parent)
    is_parent: bool = False
    tree_id: str = ""
    #: tree-root marker (label quota.scheduling.../is-root); a root quota with a
    #: tree-id carries the tree's total capacity (annotation .../total-resource)
    is_root: bool = False
    total_resource: ResourceList = dataclasses.field(default_factory=dict)
    #: when true, a tree root's capacity is NOT deducted from the default tree
    ignore_default_tree: bool = False
    #: when False, the quota's unused min is NEVER lent to siblings — the
    #: full min stays reserved regardless of demand (reference label
    #: ``quota.scheduling.koordinator.sh/allow-lent-resource``, quotaNode
    #: AllowLentResource; default true)
    allow_lent_resource: bool = True


# --- scheduling.koordinator.sh/PodMigrationJob (pod_migration_job_types.go:27-40) ---


class MigrationPhase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class MigrationMode(enum.Enum):
    RESERVATION_FIRST = "ReservationFirst"
    EVICT_DIRECTLY = "EvictDirectly"


@dataclasses.dataclass
class PodMigrationJob:
    meta: ObjectMeta
    pod_uid: str = ""
    mode: MigrationMode = MigrationMode.RESERVATION_FIRST
    phase: MigrationPhase = MigrationPhase.PENDING
    reservation_name: Optional[str] = None
    reason: str = ""
    create_time: float = dataclasses.field(default_factory=time.time)


# --- quota.koordinator.sh/ElasticQuotaProfile ---


@dataclasses.dataclass
class ElasticQuotaProfile:
    """Quota tree generator (reference
    ``apis/quota/v1alpha1/elastic_quota_profile_types.go`` + reconciler
    ``pkg/quota-controller/profile/``): selects a set of nodes by label and
    maintains a root ElasticQuota whose min/max track the selected nodes'
    total allocatable."""

    meta: ObjectMeta
    quota_name: str = ""
    node_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    quota_labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: resource dims to sum over selected nodes; empty = all reported
    resource_keys: List[str] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if not self.quota_name:
            self.quota_name = self.meta.name


# --- analysis.koordinator.sh/Recommendation ---


@dataclasses.dataclass
class Recommendation:
    """Resource recommendation scaffold (reference
    ``apis/analysis/v1alpha1/recommendation_types.go``): target workload +
    the p95-peak resource estimate produced from prediction histograms."""

    meta: ObjectMeta
    workload_kind: str = "Deployment"
    workload_name: str = ""
    recommended: ResourceList = dataclasses.field(default_factory=dict)
    update_time: float = dataclasses.field(default_factory=time.time)


# --- config.koordinator.sh/ClusterColocationProfile ---


@dataclasses.dataclass
class ClusterColocationProfile:
    """Admission-time pod mutation profile (reference
    ``cluster_colocation_profile_types.go`` + webhook
    ``pod/mutating/cluster_colocation_profile.go``)."""

    meta: ObjectMeta
    selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    namespace_selector: Dict[str, str] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    qos_class: Optional[QoSClass] = None
    priority: Optional[int] = None
    scheduler_name: Optional[str] = None
    #: resource name rewrite map, e.g. cpu -> kubernetes.io/batch-cpu
    resource_translation: Dict[str, str] = dataclasses.field(default_factory=dict)


# --- slo.koordinator.sh/NodeSLO (nodeslo_types.go) ---


@dataclasses.dataclass
class ResourceThresholdStrategy:
    """Per-node BE suppression thresholds (reference
    ``apis/slo/v1alpha1/nodeslo_types.go`` ResourceThresholdStrategy)."""

    enable: bool = False
    cpu_suppress_threshold_percent: float = 65.0
    cpu_evict_be_usage_threshold_percent: float = 90.0
    memory_evict_threshold_percent: float = 70.0
    memory_evict_lower_percent: Optional[float] = None


@dataclasses.dataclass
class SystemStrategy:
    """Node-level kernel tuning (nodeslo_types.go SystemStrategy →
    koordlet sysreconcile strategy)."""

    enable: bool = False
    min_free_kbytes_factor: float = 100.0   # per-mille of total memory
    watermark_scale_factor: float = 150.0
    memcg_reap_background: int = 0


@dataclasses.dataclass
class ResctrlStrategy:
    """RDT L3/MB partitioning per QoS tier (nodeslo_types.go ResourceQOS
    resctrlQOS → koordlet resctrl strategy + qosmanager/resctrl)."""

    enable: bool = False
    #: percent of LLC ways each tier may use
    llc_percent: Dict[QoSClass, float] = dataclasses.field(
        default_factory=lambda: {
            QoSClass.LSR: 100.0,
            QoSClass.LS: 100.0,
            QoSClass.BE: 30.0,
        }
    )
    #: percent of memory bandwidth each tier may use
    mba_percent: Dict[QoSClass, float] = dataclasses.field(
        default_factory=lambda: {
            QoSClass.LSR: 100.0,
            QoSClass.LS: 100.0,
            QoSClass.BE: 100.0,
        }
    )


@dataclasses.dataclass
class BlkIOStrategy:
    """Block IO throttles per tier (nodeslo_types.go blkioQOS →
    qosmanager blkio strategy). Limits are bytes/s or IOs/s; 0 = no limit."""

    enable: bool = False
    be_read_bps: int = 0
    be_write_bps: int = 0
    be_read_iops: int = 0
    be_write_iops: int = 0


@dataclasses.dataclass
class CPUBurstStrategy:
    policy: str = "none"        # none|cpuBurstOnly|cfsQuotaBurstOnly|auto
    cpu_burst_percent: float = 1000.0
    cfs_quota_burst_percent: float = 300.0


@dataclasses.dataclass
class NodeSLO:
    meta: ObjectMeta            # name == node name
    threshold: ResourceThresholdStrategy = dataclasses.field(
        default_factory=ResourceThresholdStrategy
    )
    cpu_burst: CPUBurstStrategy = dataclasses.field(default_factory=CPUBurstStrategy)
    #: per-QoS-class resource QoS knobs, keyed by QoSClass
    resource_qos: Dict[QoSClass, Dict[str, float]] = dataclasses.field(
        default_factory=dict
    )
    system: SystemStrategy = dataclasses.field(
        default_factory=lambda: SystemStrategy()
    )
    resctrl: ResctrlStrategy = dataclasses.field(
        default_factory=lambda: ResctrlStrategy()
    )
    blkio: BlkIOStrategy = dataclasses.field(
        default_factory=lambda: BlkIOStrategy()
    )
    #: out-of-band host daemons: (name, cgroup dir, qos class name)
    host_applications: List[Tuple[str, str, str]] = dataclasses.field(
        default_factory=list
    )


__all__ = [
    "AGG_TYPES",
    "AGG_P50",
    "AGG_P90",
    "AGG_P95",
    "AGG_P99",
    "ClusterColocationProfile",
    "CPUBurstStrategy",
    "Device",
    "DeviceInfo",
    "ElasticQuota",
    "ElasticQuotaProfile",
    "Recommendation",
    "MigrationMode",
    "MigrationPhase",
    "Node",
    "NodeMetric",
    "NodeSLO",
    "NodeStatus",
    "ObjectMeta",
    "Pod",
    "PodGroup",
    "PodMetricInfo",
    "PodMigrationJob",
    "PodPhase",
    "PodSpec",
    "Reservation",
    "ReservationOwner",
    "ReservationPhase",
    "ResourceMetric",
    "ResourceThresholdStrategy",
    "ResourceList",
]
