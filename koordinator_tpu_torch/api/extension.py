"""Annotation/label protocol: QoS classes, priority bands, extended resources.

This is the TPU-native rebuild of the reference's ``apis/extension`` package —
the de-facto wire format between components (reference:
``apis/extension/qos.go:23-27`` for QoS classes,
``apis/extension/priority.go:29-48`` for priority bands,
``apis/extension/resource.go:26-28`` for batch/mid extended resources).

Unlike the reference (string annotations parsed per pod per plugin), the rebuild
normalizes the protocol once at snapshot build time into small integer enums so
that the solver works on dense int8/int32 tensors.
"""

from __future__ import annotations

import enum
from typing import Mapping, Optional

DOMAIN = "koordinator.sh"

# --- Labels / annotations (reference: apis/extension/constants.go) ---
LABEL_POD_QOS = f"{DOMAIN}/qosClass"
#: numeric sub-priority within a band (reference constants.go:32)
LABEL_POD_PRIORITY = f"{DOMAIN}/priority"
#: priority band NAME (reference constants.go:36 LabelPodPriorityClass)
LABEL_POD_PRIORITY_CLASS = f"{DOMAIN}/priority-class"
LABEL_QUOTA_NAME = f"quota.scheduling.{DOMAIN}/name"
LABEL_QUOTA_PARENT = f"quota.scheduling.{DOMAIN}/parent"
LABEL_QUOTA_IS_PARENT = f"quota.scheduling.{DOMAIN}/is-parent"
LABEL_QUOTA_TREE_ID = f"quota.scheduling.{DOMAIN}/tree-id"
LABEL_QUOTA_IS_ROOT = f"quota.scheduling.{DOMAIN}/is-root"
LABEL_QUOTA_IGNORE_DEFAULT_TREE = f"quota.scheduling.{DOMAIN}/ignore-default-tree"
LABEL_PREEMPTIBLE = f"quota.scheduling.{DOMAIN}/preemptible"
ANNOTATION_QUOTA_TOTAL_RESOURCE = f"quota.scheduling.{DOMAIN}/total-resource"
#: allow-lent-resource label (quotaNode.AllowLentResource; default true)
LABEL_QUOTA_ALLOW_LENT = f"quota.scheduling.{DOMAIN}/allow-lent-resource"
#: status annotations the quota controller stamps each sync (reference
#: ``elasticquota/controller.go:170-178``)
ANNOTATION_QUOTA_RUNTIME = f"quota.scheduling.{DOMAIN}/runtime"
ANNOTATION_QUOTA_REQUEST = f"quota.scheduling.{DOMAIN}/request"
ANNOTATION_QUOTA_GUARANTEED = f"quota.scheduling.{DOMAIN}/guaranteed"
#: sum of children's requests (leaf: its pod requests) — AnnotationChildRequest
ANNOTATION_QUOTA_CHILD_REQUEST = f"quota.scheduling.{DOMAIN}/child-request"
#: allocated = sum of children's guaranteed (leaf: admitted pod usage) —
#: reference ``elasticquota/core/quota_info.go:62-67``
ANNOTATION_QUOTA_ALLOCATED = f"quota.scheduling.{DOMAIN}/allocated"
#: non-preemptible pods' request/used accounted separately: they must fit
#: inside quota MIN, not runtime (``quota_info.go:49-56``)
ANNOTATION_QUOTA_NON_PREEMPTIBLE_REQUEST = (
    f"quota.scheduling.{DOMAIN}/non-preemptible-request"
)
ANNOTATION_QUOTA_NON_PREEMPTIBLE_USED = (
    f"quota.scheduling.{DOMAIN}/non-preemptible-used"
)
#: namespaces bound to this quota (pods in them default into it) —
#: AnnotationQuotaNamespaces (``elastic_quota.go:52``)
ANNOTATION_QUOTA_NAMESPACES = f"quota.scheduling.{DOMAIN}/namespaces"
#: fair-sharing competition weight as a wire annotation; absent/zero →
#: defaults to max (reference GetSharedWeight, ``elastic_quota.go:95-105``)
ANNOTATION_QUOTA_SHARED_WEIGHT = f"quota.scheduling.{DOMAIN}/shared-weight"
#: bypass the quota webhook's structural guards (LabelAllowForceUpdate)
LABEL_QUOTA_ALLOW_FORCE_UPDATE = f"quota.scheduling.{DOMAIN}/allow-force-update"
#: per-quota admission toggle + declared resource-key set
ANNOTATION_QUOTA_ADMISSION = f"quota.scheduling.{DOMAIN}/admission"
ANNOTATION_QUOTA_RESOURCE_KEYS = f"quota.scheduling.{DOMAIN}/resource-keys"
ANNOTATION_QUOTA_UNSCHEDULABLE_RESOURCE = (
    f"quota.scheduling.{DOMAIN}/unschedulable-resource"
)
ANNOTATION_QUOTA_MAX_STRICT_CHECK_RESOURCE_KEYS = (
    f"quota.scheduling.{DOMAIN}/max-strict-check-resource-keys"
)

#: well-known quota names (reference apis/extension/elastic_quota.go:29-33)
SYSTEM_QUOTA_NAME = "koordinator-system-quota"
ROOT_QUOTA_NAME = "koordinator-root-quota"
DEFAULT_QUOTA_NAME = "koordinator-default-quota"
LABEL_GANG_NAME = "pod-group.scheduling.sigs.k8s.io/name"
LABEL_GANG_MIN_AVAILABLE = "pod-group.scheduling.sigs.k8s.io/min-available"
ANNOTATION_RESOURCE_SPEC = f"scheduling.{DOMAIN}/resource-spec"
ANNOTATION_RESOURCE_STATUS = f"scheduling.{DOMAIN}/resource-status"
ANNOTATION_DEVICE_ALLOCATED = f"scheduling.{DOMAIN}/device-allocated"
#: device-plugin adapter annotations (reference
#: ``pkg/scheduler/plugins/deviceshare/device_plugin_adapter.go``):
#: bind time in unix nanos — device plugins cannot read pod manifests
#: from kubelet, so they disambiguate same-node same-time pods by it
ANNOTATION_BIND_TIMESTAMP = f"scheduling.{DOMAIN}/bind-timestamp"
#: comma-separated allocated GPU minors (env-ref override of
#: NVIDIA_VISIBLE_DEVICES-style image defaults)
ANNOTATION_GPU_MINORS = f"scheduling.{DOMAIN}/gpu-minors"
#: Huawei NPU plugin protocol (vendor-dispatched adapter)
ANNOTATION_PREDICATE_TIME = "predicate-time"
ANNOTATION_HUAWEI_NPU_CORE = "huawei.com/npu-core"
GPU_VENDOR_HUAWEI = "huawei"
LABEL_GPU_VENDOR = f"node.{DOMAIN}/gpu-vendor"
#: ClusterColocationProfile controller opt-in/opt-out
#: (``apis/extension/cluster_colocation_profile.go:24-28``): the
#: controller reconciles a profile only when ReconcileByDefault or this
#: label is "true"; a profile carrying the skip annotation suppresses
#: the webhook's resource mutation for matched pods
LABEL_CONTROLLER_MANAGED = "config.koordinator.sh/controller-managed"
ANNOTATION_SKIP_UPDATE_RESOURCES = "config.koordinator.sh/skip-update-resources"
ANNOTATION_RESERVATION_AFFINITY = f"scheduling.{DOMAIN}/reservation-affinity"
#: smaller non-zero order wins nomination outright (reference
#: ``apis/extension/reservation.go:43-46`` LabelReservationOrder)
LABEL_RESERVATION_ORDER = f"scheduling.{DOMAIN}/reservation-order"
#: "true" = the pod schedules IGNORING reservations entirely (reference
#: ``reservation.go:31-36`` LabelReservationIgnored)
LABEL_RESERVATION_IGNORED = f"scheduling.{DOMAIN}/reservation-ignored"
#: stamped on an owner pod recording WHICH reservation it allocated from
#: (``reservation.go:48-49`` AnnotationReservationAllocated, written at
#: PreBind by SetReservationAllocated)
ANNOTATION_RESERVATION_ALLOCATED = f"scheduling.{DOMAIN}/reservation-allocated"


def is_reservation_ignored(pod) -> bool:
    """reference ``reservation.go:97-99`` IsReservationIgnored."""
    return pod.meta.labels.get(LABEL_RESERVATION_IGNORED) == "true"


#: per-pod PreemptionPolicy override (reference
#: ``apis/extension/preemption.go:22-41`` LabelPodPreemptionPolicy):
#: "Never" = this pod never triggers preemption of other pods
LABEL_POD_PREEMPTION_POLICY = f"scheduling.{DOMAIN}/preemption-policy"
PREEMPTION_POLICY_NEVER = "Never"


def pod_never_preempts(pod) -> bool:
    """Whether the pod's preemption policy forbids preempting on its
    behalf (GetPodKoordPreemptionPolicy == Never)."""
    return (
        pod.meta.labels.get(LABEL_POD_PREEMPTION_POLICY)
        == PREEMPTION_POLICY_NEVER
    )


#: reservation-side options narrowing WHICH resources the Restricted
#: allocate policy binds (reference ``reservation.go:54-55,89-96``
#: AnnotationReservationRestrictedOptions; default = every reserved dim)
ANNOTATION_RESERVATION_RESTRICTED_OPTIONS = (
    f"scheduling.{DOMAIN}/reservation-restricted-options"
)


def parse_reservation_restricted_resources(
    annotations: Mapping[str, str],
) -> Optional[list]:
    """The restricted-options resources list, or None when absent/illegal
    (GetReservationRestrictedOptions)."""
    raw = annotations.get(ANNOTATION_RESERVATION_RESTRICTED_OPTIONS)
    if not raw:
        return None
    import json

    try:
        payload = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(payload, dict):
        return None
    resources = payload.get("resources")
    if not isinstance(resources, list):
        return None
    return [str(r) for r in resources]


#: pod-side spec restricting nomination to reservations whose allocatable
#: EXACTLY equals the pod's request on the listed resource names
#: (reference ``reservation.go:188-241`` AnnotationExactMatchReservationSpec)
ANNOTATION_EXACT_MATCH_RESERVATION_SPEC = (
    f"scheduling.{DOMAIN}/exact-match-reservation"
)


def parse_exact_match_reservation_spec(
    annotations: Mapping[str, str],
) -> Optional[list]:
    """The spec's resourceNames list, or None when absent/illegal
    (GetExactMatchReservationSpec)."""
    raw = annotations.get(ANNOTATION_EXACT_MATCH_RESERVATION_SPEC)
    if not raw:
        return None
    import json

    try:
        payload = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(payload, dict):
        return None
    names = payload.get("resourceNames")
    if not isinstance(names, list):
        return None
    return [str(n) for n in names]


def exact_match_reservation(
    pod_requests: Mapping[str, float],
    reservation_allocatable: Mapping[str, float],
    names: Optional[list],
) -> bool:
    """Reference ``ExactMatchReservation`` (reservation.go:222-241),
    including its quirk: a listed name absent on BOTH sides returns
    matched for the WHOLE spec immediately; absent on one side only is
    a mismatch; present on both must compare exactly equal."""
    if not names:
        return True
    for name in names:
        in_r = name in reservation_allocatable
        in_p = name in pod_requests
        if not in_r or not in_p:
            return (not in_r) and (not in_p)
        if float(reservation_allocatable[name]) != float(pod_requests[name]):
            return False
    return True


#: per-pod estimator scaling-factor override in percent per resource name
#: (reference ``apis/extension/load_aware.go:31-32``
#: AnnotationCustomEstimatedScalingFactors, e.g. '{"cpu": 100}')
ANNOTATION_CUSTOM_ESTIMATED_SCALING_FACTORS = (
    f"scheduling.{DOMAIN}/load-estimated-scaling-factors"
)


def parse_custom_estimated_scaling_factors(
    annotations: Mapping[str, str],
) -> Optional[Mapping[str, float]]:
    """{resource: percent} from the pod annotation, or None
    (``load_aware.go:74-82`` GetCustomEstimatedScalingFactors)."""
    raw = annotations.get(ANNOTATION_CUSTOM_ESTIMATED_SCALING_FACTORS)
    if not raw:
        return None
    import json

    try:
        payload = json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(payload, dict):
        return None
    out = {}
    for k, v in payload.items():
        try:
            out[str(k)] = float(v)
        except (TypeError, ValueError):
            continue
    return out or None
ANNOTATION_GANG_GROUPS = f"gang.scheduling.{DOMAIN}/groups"
#: which member states count toward gang satisfaction (reference
#: ``apis/extension/coscheduling.go:55-64``); default once-satisfied
ANNOTATION_GANG_MATCH_POLICY = f"gang.scheduling.{DOMAIN}/match-policy"
ANNOTATION_ALIAS_GANG_MATCH_POLICY = "pod-group.scheduling.sigs.k8s.io/match-policy"
GANG_MATCH_ONLY_WAITING = "only-waiting"
GANG_MATCH_WAITING_AND_RUNNING = "waiting-and-running"
GANG_MATCH_ONCE_SATISFIED = "once-satisfied"
#: gang failure handling (reference ``apis/extension/coscheduling.go:40-53``
#: AnnotationGangMode): Strict rolls back the whole gang group on a member
#: failure; NonStrict keeps successfully-placed members
ANNOTATION_GANG_MODE = f"gang.scheduling.{DOMAIN}/mode"
GANG_MODE_STRICT = "Strict"
GANG_MODE_NONSTRICT = "NonStrict"
#: the koordinator-native gang annotation protocol (AnnotationGangPrefix,
#: ``apis/extension/coscheduling.go:25-47``) — takes precedence over the
#: deprecated lightweight-coscheduling labels below it
ANNOTATION_GANG_NAME = f"gang.scheduling.{DOMAIN}/name"
ANNOTATION_GANG_MIN_AVAILABLE = f"gang.scheduling.{DOMAIN}/min-available"
ANNOTATION_GANG_TOTAL_NUM = f"gang.scheduling.{DOMAIN}/total-number"
ANNOTATION_GANG_WAIT_TIME = f"gang.scheduling.{DOMAIN}/waiting-time"
#: stamped BY the scheduler on gang members when the gang times out at
#: Permit (AnnotationGangTimeout, coscheduling.go:48-50)
ANNOTATION_GANG_TIMEOUT = f"gang.scheduling.{DOMAIN}/timeout"


def gang_name_of(pod) -> Optional[str]:
    """Gang name: native annotation first (reference GetGangName), the
    deprecated lightweight label as fallback."""
    return pod.meta.annotations.get(ANNOTATION_GANG_NAME) or pod.meta.labels.get(
        LABEL_GANG_NAME
    )


def gang_min_available_of(pod) -> Optional[int]:
    """minMember: native annotation (GetGangMinNumFromPod) first, the
    lightweight label second; None when absent/unparseable."""
    raw = pod.meta.annotations.get(
        ANNOTATION_GANG_MIN_AVAILABLE
    ) or pod.meta.labels.get(LABEL_GANG_MIN_AVAILABLE)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def parse_duration_s(raw: Optional[str]) -> Optional[float]:
    """Go time.ParseDuration subset (h/m/s/ms components, e.g. "1h30m",
    "90s"); None on absent/illegal/non-positive — callers fall back to
    their default (gang.go:148-153 waitTime handling)."""
    if not raw:
        return None
    import re

    m = re.fullmatch(
        r"(?:(\d+(?:\.\d+)?)h)?(?:(\d+(?:\.\d+)?)m)?"
        r"(?:(\d+(?:\.\d+)?)s)?(?:(\d+(?:\.\d+)?)ms)?",
        raw.strip(),
    )
    if m is None or not any(m.groups()):
        return None
    h, mi, s, ms = (float(g) if g else 0.0 for g in m.groups())
    total = h * 3600.0 + mi * 60.0 + s + ms / 1000.0
    return total if total > 0 else None


def gang_mode_of(annotations: Mapping[str, str]) -> str:
    """Gang mode from annotations; any illegal value degrades to Strict
    (reference ``coscheduling/core/gang.go:128-132``)."""
    mode = annotations.get(ANNOTATION_GANG_MODE)
    if mode == GANG_MODE_NONSTRICT:
        return GANG_MODE_NONSTRICT
    return GANG_MODE_STRICT
#: pod-side partition request (apis/extension/device_share.go:38
#: AnnotationGPUPartitionSpec): {"allocatePolicy": "Restricted"|"BestEffort",
#: "ringBusBandwidth": <GB/s>}
ANNOTATION_GPU_PARTITION_SPEC = f"scheduling.{DOMAIN}/gpu-partition-spec"
#: joint multi-device allocation directive (reference
#: ``apis/extension/device_share.go:35-36`` AnnotationDeviceJointAllocate)
ANNOTATION_DEVICE_JOINT_ALLOCATE = f"scheduling.{DOMAIN}/device-joint-allocate"
#: per-device-type allocation hints (``device_share.go:147-190``
#: DeviceAllocateHints): {"rdma": {"allocateStrategy": "ApplyForAll"|
#: "RequestsAsCount", "requiredTopologyScope": "PCIe"|"NUMANode"}}
ANNOTATION_DEVICE_ALLOCATE_HINT = f"scheduling.{DOMAIN}/device-allocate-hint"
DEVICE_ALLOCATE_STRATEGY_APPLY_FOR_ALL = "ApplyForAll"
DEVICE_ALLOCATE_STRATEGY_REQUESTS_AS_COUNT = "RequestsAsCount"


def parse_device_allocate_hints(
    annotations: Mapping[str, str],
) -> Mapping[str, Mapping[str, str]]:
    """{deviceType: hint dict} from the device-allocate-hint annotation;
    empty on absent/illegal (GetDeviceAllocateHints)."""
    raw = annotations.get(ANNOTATION_DEVICE_ALLOCATE_HINT)
    if not raw:
        return {}
    import json

    try:
        payload = json.loads(raw)
    except (ValueError, TypeError):
        return {}
    if not isinstance(payload, dict):
        return {}
    return {
        str(k): v for k, v in payload.items() if isinstance(v, dict)
    }
#: node-side partition table annotation (AnnotationGPUPartitions)
ANNOTATION_GPU_PARTITIONS = f"scheduling.{DOMAIN}/gpu-partitions"
#: node label choosing Honor/Prefer (LabelGPUPartitionPolicy)
LABEL_GPU_PARTITION_POLICY = f"node.{DOMAIN}/gpu-partition-policy"
LABEL_GPU_MODEL = f"node.{DOMAIN}/gpu-model"
ANNOTATION_NODE_CPU_TOPOLOGY = f"node.{DOMAIN}/cpu-topology"
#: LS/K8s-Burstable CPU shared pools per NUMA node, computed by the
#: koordlet from the topology minus every cpuset-bound pod's CPUs
#: (reference ``apis/extension/numa_aware.go:46-48``,
#: ``states_noderesourcetopology.go`` calCPUSharePools)
ANNOTATION_NODE_CPU_SHARED_POOLS = f"node.{DOMAIN}/cpu-shared-pools"
#: BE/K8s-BestEffort shared pools: like the LS pools but only LSE pods'
#: CPUs are carved out (BE may ride LSR cores, never LSE cores)
ANNOTATION_NODE_BE_CPU_SHARED_POOLS = f"node.{DOMAIN}/be-cpu-shared-pools"
#: kubelet cpu-manager policy/options/reservedCPUs read back from the
#: kubelet state file (AnnotationKubeletCPUManagerPolicy)
ANNOTATION_KUBELET_CPU_MANAGER_POLICY = "kubelet.koordinator.sh/cpu-manager-policy"
#: K8s Guaranteed pods' kubelet-static cpusets (AnnotationNodeCPUAllocs):
#: the scheduler must not double-allocate these CPUs
ANNOTATION_NODE_CPU_ALLOCS = f"node.{DOMAIN}/pod-cpu-allocs"
#: node-level bind-policy constraint (LabelNodeCPUBindPolicy):
#: FullPCPUsOnly forces whole physical cores for every cpuset pod
LABEL_NODE_CPU_BIND_POLICY = f"node.{DOMAIN}/cpu-bind-policy"
NODE_CPU_BIND_POLICY_FULL_PCPUS_ONLY = "FullPCPUsOnly"
NODE_CPU_BIND_POLICY_SPREAD_BY_PCPUS = "SpreadByPCPUs"
#: node-level NUMA allocate strategy (LabelNodeNUMAAllocateStrategy):
#: MostAllocated = bin-pack zones, LeastAllocated = spread (the plugin
#: default unless the scoring strategy is MostAllocated — reference
#: GetDefaultNUMAAllocateStrategy, nodenumaresource/util.go:33-39)
LABEL_NODE_NUMA_ALLOCATE_STRATEGY = f"node.{DOMAIN}/numa-allocate-strategy"
NODE_NUMA_STRATEGY_MOST_ALLOCATED = "MostAllocated"
NODE_NUMA_STRATEGY_LEAST_ALLOCATED = "LeastAllocated"
#: pod-level NUMA requirement API (AnnotationNUMATopologySpec,
#: ``numa_aware.go:29-31``): the pod's own topology policy (+ exclusive
#: preference), overriding the node's label for this pod's admission
ANNOTATION_NUMA_TOPOLOGY_SPEC = f"scheduling.{DOMAIN}/numa-topology-spec"
#: SYSTEM-QoS cpuset carve-out (AnnotationNodeSystemQOSResource)
ANNOTATION_NODE_SYSTEM_QOS_RESOURCE = f"node.{DOMAIN}/system-qos-resource"
#: total node network bandwidth in bps (AnnotationNodeBandwidth)
ANNOTATION_NODE_BANDWIDTH = f"node.{DOMAIN}/network-bandwidth"
#: batch requests/limits per container, stamped by the pod mutating
#: webhook so CRI-side consumers (runtime proxy, koordlet hooks) see the
#: original extended-resource spec (AnnotationExtendedResourceSpec,
#: ``apis/extension/resource.go:33-36``)
ANNOTATION_EXTENDED_RESOURCE_SPEC = f"node.{DOMAIN}/extended-resource-spec"
#: pods opting into in-place mutating updates (LabelPodMutatingUpdate)
LABEL_POD_MUTATING_UPDATE = f"pod.{DOMAIN}/mutating-update"
ANNOTATION_NODE_RAW_ALLOCATABLE = f"node.{DOMAIN}/raw-allocatable"
ANNOTATION_NODE_AMPLIFICATION = f"node.{DOMAIN}/resource-amplification-ratio"
ANNOTATION_NETWORK_QOS = f"{DOMAIN}/networkQOS"
ANNOTATION_NODE_CPU_NORMALIZATION = f"node.{DOMAIN}/cpu-normalization-ratio"


class QoSClass(enum.IntEnum):
    """Koordinator QoS classes (reference ``apis/extension/qos.go:23-27``).

    Encoded as small ints so pod QoS is a dense int8 column in the snapshot.
    Order encodes strictness: SYSTEM > LSE > LSR > LS > BE > NONE.
    """

    NONE = 0
    BE = 1       # best effort, runs on batch-* overcommitted resources
    LS = 2       # latency sensitive (shared cpus)
    LSR = 3      # latency sensitive reserved (exclusive cpuset)
    LSE = 4      # latency sensitive exclusive (no BE sharing at all)
    SYSTEM = 5

    @classmethod
    def parse(cls, value: Optional[str]) -> "QoSClass":
        if not value:
            return cls.NONE
        try:
            return cls[value.upper()]
        except KeyError:
            return cls.NONE


class PriorityClass(enum.IntEnum):
    """Koord priority bands (reference ``apis/extension/priority.go:29-48``)."""

    NONE = 0
    FREE = 1     # 3000-3999
    BATCH = 2    # 5000-5999
    MID = 3      # 7000-7999
    PROD = 4     # 9000-9999

    @classmethod
    def from_priority(cls, priority: Optional[int]) -> "PriorityClass":
        """Map a k8s pod priority value to a koord priority band.

        Mirrors ``apis/extension/priority.go`` ``GetPodPriorityClassByPriority``:
        inclusive band boundaries, anything outside the bands is NONE.
        """
        if priority is None:
            return cls.NONE
        if 9000 <= priority <= 9999:
            return cls.PROD
        if 7000 <= priority <= 7999:
            return cls.MID
        if 5000 <= priority <= 5999:
            return cls.BATCH
        if 3000 <= priority <= 3999:
            return cls.FREE
        return cls.NONE


PRIORITY_BANDS: Mapping[PriorityClass, tuple[int, int]] = {
    PriorityClass.PROD: (9000, 9999),
    PriorityClass.MID: (7000, 7999),
    PriorityClass.BATCH: (5000, 5999),
    PriorityClass.FREE: (3000, 3999),
}

# --- Resource names (reference: apis/extension/resource.go:26-28) ---
RES_CPU = "cpu"                      # milli-cores
RES_MEMORY = "memory"                # MiB in the snapshot (bytes on the wire)
RES_BATCH_CPU = "kubernetes.io/batch-cpu"
RES_BATCH_MEMORY = "kubernetes.io/batch-memory"
RES_MID_CPU = "kubernetes.io/mid-cpu"
RES_MID_MEMORY = "kubernetes.io/mid-memory"
RES_GPU = "nvidia.com/gpu"           # whole GPU count (integer)
RES_GPU_CORE = f"{DOMAIN}/gpu-core"
RES_GPU_MEMORY = f"{DOMAIN}/gpu-memory"
RES_GPU_MEMORY_RATIO = f"{DOMAIN}/gpu-memory-ratio"
RES_RDMA = f"{DOMAIN}/rdma"
RES_FPGA = f"{DOMAIN}/fpga"
RES_KOORD_GPU = f"{DOMAIN}/gpu"          # percentage-style whole/fractional
RES_GPU_SHARED = f"{DOMAIN}/gpu.shared"  # shared-GPU instance count

#: Canonical dense resource axis for the solver. Extended resources used by a
#: deployment append here; the solver is shape-polymorphic in D.
DEFAULT_RESOURCES = (RES_CPU, RES_MEMORY, RES_BATCH_CPU, RES_BATCH_MEMORY)


def parse_gpu_request(requests: Mapping[str, float]) -> tuple[int, float]:
    """(whole_gpus, share_percent) from a pod's resource requests.

    ``nvidia.com/gpu: k`` → k whole GPUs; ``koordinator.sh/gpu-memory-ratio``
    (or gpu-core) of r → r<100: fraction of one GPU, r≥100: r//100 whole
    plus the remainder (reference ``apis/extension/device_share.go``
    validation rules). This is the *scalar* view the solver lowers; the
    host allocator uses :func:`parse_gpu_request_vector` for independent
    per-dimension accounting.
    """
    whole = int(requests.get(RES_GPU, 0))
    ratio = float(
        requests.get(RES_GPU_MEMORY_RATIO, requests.get(RES_GPU_CORE, 0.0))
    )
    if ratio >= 100.0:
        whole += int(ratio // 100.0)
        ratio = ratio % 100.0
    return whole, ratio


def parse_gpu_request_vector(
    requests: Mapping[str, float],
) -> tuple[int, float, float, Optional[float]]:
    """(whole, core_percent, memory_ratio_percent, memory_bytes|None) —
    the reference's normalized per-dimension GPU request
    (``deviceshare/utils.go:125-200`` request-combination table):

    - ``nvidia.com/gpu: k`` → k whole (core 100 / ratio 100 each)
    - ``koordinator.sh/gpu: r`` → core=r, ratio=r (≥100 splits to whole)
    - ``gpu-core`` + ``gpu-memory-ratio`` → the two dims INDEPENDENTLY
      (a high-memory/low-core pod accounts correctly); equal multiples of
      100 split to whole devices
    - ``gpu-core`` + ``gpu-memory`` (bytes) → core percent + bytes; the
      allocator converts bytes↔ratio per device capacity
    - a single percentage dim alone charges only that dim
    """
    whole = int(requests.get(RES_GPU, 0))
    koord = float(requests.get(RES_KOORD_GPU, 0.0))
    core = float(requests.get(RES_GPU_CORE, 0.0))
    ratio = float(requests.get(RES_GPU_MEMORY_RATIO, 0.0))
    mem_bytes_raw = requests.get(RES_GPU_MEMORY)
    mem_bytes: Optional[float] = (
        float(mem_bytes_raw) if mem_bytes_raw else None
    )
    if koord > 0 and core == 0 and ratio == 0:
        core = ratio = koord
    if core >= 100.0 and core == ratio and core % 100.0 == 0.0:
        whole += int(core // 100.0)
        core = ratio = 0.0
    elif core >= 100.0 and ratio == 0.0 and mem_bytes is None:
        whole += int(core // 100.0)
        core = core % 100.0
        ratio = core
    elif ratio >= 100.0 and core == 0.0:
        whole += int(ratio // 100.0)
        ratio = ratio % 100.0
        core = ratio
    return whole, core, ratio, mem_bytes


def _count_request(requests: Mapping[str, float], key: str) -> int:
    import math

    try:
        raw = float(requests.get(key, 0.0))
    except (TypeError, ValueError):
        return 0
    return int(math.ceil(raw / 100.0)) if raw > 0 else 0


def parse_rdma_request(requests: Mapping[str, float]) -> int:
    """Whole RDMA devices from ``koordinator.sh/rdma`` (the reference
    allocates RDMA NICs in 100-unit instances, ``device_share.go:102``);
    any positive fraction rounds up to a whole device."""
    return _count_request(requests, RES_RDMA)


def parse_fpga_request(requests: Mapping[str, float]) -> int:
    """Whole FPGAs from ``koordinator.sh/fpga`` (``device_share.go:49``,
    same 100-unit instance convention as RDMA)."""
    return _count_request(requests, RES_FPGA)


def should_skip_update_resource(meta) -> bool:
    """``ShouldSkipUpdateResource``
    (``apis/extension/cluster_colocation_profile.go:31-37``): presence of
    the annotation — any value — suppresses the webhook's resource
    mutation for pods matched by this profile."""
    return ANNOTATION_SKIP_UPDATE_RESOURCES in (meta.annotations or {})


def should_reconcile_profile(meta) -> bool:
    """``ShouldReconcileProfile``
    (``cluster_colocation_profile.go:39-41``): the controller reconciles
    a profile only when this label is exactly "true" (or the global
    ReconcileByDefault is on)."""
    return (meta.labels or {}).get(LABEL_CONTROLLER_MANAGED) == "true"


def parse_gpu_partition_table(annotations: Mapping[str, str]):
    """Node-side partition table from the Device CR annotation
    (``GetGPUPartitionTable``, ``device_share.go:354-367``): ``{"<size>":
    [{"minors": [...], "gpuLinkType": ..., "ringBusBandwidth": ...,
    "allocationScore": ...}]}`` → {size: [GPUPartition]}. Returns {} for
    absent/malformed payloads (the allocator then falls back to the
    model-dispatched default table or topology packing)."""
    import json as _json

    from .types import GPUPartition

    raw = annotations.get(ANNOTATION_GPU_PARTITIONS)
    if not raw:
        return {}
    try:
        table = _json.loads(raw)
    except (ValueError, TypeError):
        return {}
    if not isinstance(table, dict):
        return {}
    out = {}
    for size_raw, parts in table.items():
        try:
            size = int(size_raw)
        except (TypeError, ValueError):
            continue
        if not isinstance(parts, list):
            continue
        entries = []
        for p in parts:
            if not isinstance(p, dict):
                continue
            minors = p.get("minors")
            if (
                not isinstance(minors, list)
                or len(minors) != size
                or not all(isinstance(m, int) and m >= 0 for m in minors)
            ):
                # negative minors would crash minors_mask; a size/len
                # mismatch would silently under-allocate
                continue
            try:
                bw = float(p.get("ringBusBandwidth", 0.0) or 0.0)
            except (TypeError, ValueError):
                bw = 0.0
            try:
                score = int(p.get("allocationScore", 1) or 1)
            except (TypeError, ValueError):
                score = 1
            entries.append(
                GPUPartition(
                    minors=minors,
                    link_type=str(p.get("gpuLinkType", "NVLink")),
                    ring_bus_bandwidth=bw,
                    allocation_score=score,
                )
            )
        if entries:
            out[size] = entries
    return out


def gpu_partition_policy(labels: Mapping[str, str]) -> str:
    """Honor iff the node/device label says so; anything else is Prefer
    (``GetGPUPartitionPolicy``, ``device_share.go:369-377``)."""
    return (
        "Honor"
        if labels.get(LABEL_GPU_PARTITION_POLICY) == "Honor"
        else "Prefer"
    )


def parse_device_joint_allocate(
    annotations: Mapping[str, str],
) -> Optional[tuple[tuple[str, ...], str]]:
    """(device_types, required_scope) from the joint-allocate annotation
    (``DeviceJointAllocate``: deviceTypes ordered primary-first;
    requiredScope "SamePCIe" makes PCIe co-location binding)."""
    import json as _json

    raw = annotations.get(ANNOTATION_DEVICE_JOINT_ALLOCATE)
    if not raw:
        return None
    try:
        spec = _json.loads(raw)
    except (ValueError, TypeError):
        return None
    if not isinstance(spec, dict):
        return None
    types = spec.get("deviceTypes")
    if not isinstance(types, list) or not all(
        isinstance(t, str) for t in types
    ):
        return None
    scope = spec.get("requiredScope")
    return tuple(types), (scope if isinstance(scope, str) else "")


def parse_reservation_affinity(
    annotations: Mapping[str, str],
) -> Optional[Mapping[str, object]]:
    """ReservationAffinity from the pod annotation (reference
    ``apis/extension/reservation.go:51-78``): ``{"name": ...}`` targets one
    reservation directly (other fields ignored); ``{"reservationSelector":
    {labels}}`` requires a matching reservation. Presence means REQUIRED —
    a pod carrying this must allocate from a matching reservation or stay
    unschedulable. A dict with NO recognized field is treated as absent
    — presence gates scheduling behavior (required affinity, preemption
    opt-out), so junk must never read as a requirement."""
    spec = _parse_dict_annotation(annotations, ANNOTATION_RESERVATION_AFFINITY)
    if spec is None:
        return None
    if not any(
        k in spec
        for k in ("name", "reservationSelector", "required", "preferred")
    ):
        return None
    return spec


def parse_gpu_partition_spec(annotations: Mapping[str, str]) -> tuple[bool, float]:
    """(restricted, ring_bus_bandwidth) from the pod's partition-spec
    annotation (``GPUPartitionSpec``: Restricted = only the best
    allocation-score tier may be used; BestEffort = walk down tiers)."""
    spec = _parse_dict_annotation(annotations, ANNOTATION_GPU_PARTITION_SPEC)
    if spec is None:
        return False, 0.0
    try:
        bandwidth = float(spec.get("ringBusBandwidth", 0.0))
    except (TypeError, ValueError):
        bandwidth = 0.0
    return spec.get("allocatePolicy") == "Restricted", bandwidth


#: node-level reserved resources (reference ``node_reservation.go``)
ANNOTATION_NODE_RESERVATION = f"node.{DOMAIN}/reservation"
NODE_RESERVATION_POLICY_DEFAULT = "Default"
NODE_RESERVATION_POLICY_RESERVED_CPUS_ONLY = "ReservedCPUsOnly"
#: per-node LoadAware threshold override (reference ``load_aware.go:30``)
ANNOTATION_CUSTOM_USAGE_THRESHOLDS = f"scheduling.{DOMAIN}/usage-thresholds"
#: per-node colocation overrides (reference ``node_colocation.go``):
#: the annotation carries a ColocationStrategy JSON; the labels override
#: the reclaim ratios with a float in (0, 1]
ANNOTATION_NODE_COLOCATION_STRATEGY = f"node.{DOMAIN}/colocation-strategy"
LABEL_CPU_RECLAIM_RATIO = f"node.{DOMAIN}/cpu-reclaim-ratio"
LABEL_MEMORY_RECLAIM_RATIO = f"node.{DOMAIN}/memory-reclaim-ratio"
#: pods operating as reservations (reference ``operating_pod.go``)
LABEL_POD_OPERATING_MODE = f"scheduling.{DOMAIN}/operating-mode"
POD_OPERATING_MODE_RUNNABLE = "Runnable"
POD_OPERATING_MODE_RESERVATION = "Reservation"
ANNOTATION_RESERVATION_OWNERS = f"scheduling.{DOMAIN}/reservation-owners"
ANNOTATION_RESERVATION_CURRENT_OWNER = (
    f"scheduling.{DOMAIN}/reservation-current-owner"
)
#: reservation-preemption opt-out (reference ``preemption.go:28``)
LABEL_DISABLE_PREEMPTIBLE = f"scheduling.{DOMAIN}/disable-preemptible"
#: descheduling protocol (reference ``apis/extension/descheduling.go``)
ANNOTATION_EVICTION_COST = f"scheduling.{DOMAIN}/eviction-cost"
ANNOTATION_SOFT_EVICTION = f"scheduling.{DOMAIN}/soft-eviction"
EVICTION_COST_MAX = (1 << 31) - 1  # math.MaxInt32 = never evict


def parse_node_reservation(annotations: Mapping[str, str]):
    """NodeReservation from the node annotation (reference
    ``node_reservation.go`` GetNodeReservation): ``{"resources": {...},
    "reservedCPUs": "0-5", "applyPolicy": "Default"}``. None when absent
    or malformed; non-numeric resource values are dropped."""
    spec = _parse_dict_annotation(annotations, ANNOTATION_NODE_RESERVATION)
    if spec is None:
        return None
    resources = spec.get("resources")
    if resources is not None:
        if not isinstance(resources, dict):
            spec = dict(spec)
            spec["resources"] = {}
        else:
            spec = dict(spec)
            spec["resources"] = {
                k: float(v)
                for k, v in resources.items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            }
    if not isinstance(spec.get("reservedCPUs", ""), str):
        spec = dict(spec)
        spec["reservedCPUs"] = ""
    return spec


def parse_custom_usage_thresholds(annotations: Mapping[str, str]):
    """CustomUsageThresholds from the node annotation (reference
    ``load_aware.go`` GetCustomUsageThresholds): per-node REPLACEMENT of
    the LoadAware plugin's usage/prod thresholds (a non-empty custom map
    supersedes the global wholesale — dims absent from it go unchecked).
    None when absent/malformed or when no recognized field is present
    (a truthy junk dict must not read as "custom thresholds exist")."""
    spec = _parse_dict_annotation(
        annotations, ANNOTATION_CUSTOM_USAGE_THRESHOLDS
    )
    if spec is None:
        return None
    if not any(
        k in spec
        for k in (
            "usageThresholds",
            "prodUsageThresholds",
            "aggregatedUsage",
            "usageAggregationType",
        )
    ):
        return None
    return spec


def _parse_json_annotation(annotations: Mapping[str, str], key: str, shape):
    """JSON annotation value of the given shape (dict/list), or None when
    absent/malformed — the shared guard for every structured protocol
    annotation."""
    import json as _json

    raw = annotations.get(key)
    if not raw:
        return None
    try:
        spec = _json.loads(raw)
    except (ValueError, TypeError):
        return None
    return spec if isinstance(spec, shape) else None


def _parse_dict_annotation(annotations: Mapping[str, str], key: str):
    return _parse_json_annotation(annotations, key, dict)


def parse_quota_shared_weight(annotations: Mapping[str, str]):
    """GetSharedWeight (``elastic_quota.go:95-105``): the quota's
    fair-sharing competition weight from its wire annotation. Returns a
    ``{resource: float}`` mapping, or None when the annotation is
    absent, malformed, or all-zero (callers then fall back to the typed
    field and ultimately to max)."""
    spec = _parse_dict_annotation(annotations, ANNOTATION_QUOTA_SHARED_WEIGHT)
    if spec is None:
        return None
    try:
        parsed = {k: float(v) for k, v in spec.items()}
    except (ValueError, TypeError):
        return None
    return parsed if any(v > 0 for v in parsed.values()) else None


def is_reservation_operating_mode(pod) -> bool:
    """IsReservationOperatingMode (``operating_pod.go:52-54``): the pod
    represents a scheduling and resource reservation unit."""
    return (
        pod.meta.labels.get(LABEL_POD_OPERATING_MODE)
        == POD_OPERATING_MODE_RESERVATION
    )


def parse_reservation_owners(annotations: Mapping[str, str]):
    """ReservationOwner list from the reservation-owners annotation
    (``operating_pod.go:70-79`` GetReservationOwners): a JSON list of
    ``{"labelSelector": {"matchLabels": {...}}, "namespace": ...}``.
    Returns [] when absent/malformed."""
    items = _parse_json_annotation(
        annotations, ANNOTATION_RESERVATION_OWNERS, list
    )
    return items if items is not None else []


def is_pod_preemptible(pod) -> bool:
    """IsPodPreemptible (``preemption.go:47-56``): the disable-preemptible
    label opts a pod out of being a preemption victim."""
    return pod.meta.labels.get(LABEL_DISABLE_PREEMPTIBLE) != "true"


def parse_node_colocation_strategy(annotations: Mapping[str, str]):
    """Per-node ColocationStrategy override from the node annotation
    (``node_colocation.go``), or None."""
    return _parse_dict_annotation(
        annotations, ANNOTATION_NODE_COLOCATION_STRATEGY
    )


def parse_reclaim_ratio(labels: Mapping[str, str], key: str):
    """Float reclaim ratio from a node label; None when absent/illegal
    (``node_colocation.go``: the illegal value will be ignored)."""
    raw = labels.get(key)
    if raw is None:
        return None
    try:
        ratio = float(raw)
    except (TypeError, ValueError):
        return None
    return ratio if 0.0 < ratio <= 1.0 else None


def parse_eviction_cost(annotations: Mapping[str, str]) -> int:
    """Eviction cost from the pod annotation (reference
    ``descheduling.go`` GetEvictionCost): implicit 0, negatives allowed,
    MaxInt32 = never evict. Values with a leading plus sign or leading
    zeros are invalid (→ 0), mirroring validFirstDigit."""
    value = annotations.get(ANNOTATION_EVICTION_COST)
    if not value:
        return 0
    first = value[0]
    if not (first == "-" or value == "0" or "1" <= first <= "9"):
        return 0
    try:
        cost = int(value)
    except ValueError:
        return 0
    if cost > EVICTION_COST_MAX or cost < -(1 << 31):
        return 0
    return cost


def parse_node_amplification(annotations: Mapping[str, str]) -> Mapping[str, float]:
    """Resource → amplification ratio from the node annotation (reference
    ``apis/extension/node_resource_amplification.go``
    ``GetNodeResourceAmplificationRatio``). Wire format is
    ``cpu=1.5,memory=1.2``; malformed entries are skipped."""
    raw = annotations.get(ANNOTATION_NODE_AMPLIFICATION, "")
    out = {}
    for part in filter(None, raw.split(",")):
        key, _, val = part.partition("=")
        if not key:
            continue
        try:
            out[key] = float(val)
        except ValueError:
            continue
    return out


#: QoS classes whose whole-core pods take exclusive cpusets — the single
#: source of truth for the bind predicate in both its scalar and
#: vectorized forms (and the solver's on-device ``_cpu_bind``)
CPU_BIND_QOS = (QoSClass.LSR, QoSClass.LSE)


def wants_cpu_bind(pod) -> bool:
    """Pod takes an exclusive cpuset: LSR/LSE QoS with a positive
    whole-core CPU request (reference ``nodenumaresource/plugin.go:251-313``
    requiredCPUBindPolicy resolution). Shared across the snapshot's
    amplified-CPU accounting and the NUMA manager."""
    if pod.qos not in CPU_BIND_QOS:
        return False
    cpu = pod.spec.requests.get(RES_CPU, 0.0)
    return cpu > 0 and cpu % 1000 == 0


def wants_cpu_bind_rows(qos_rows, cpu_milli_rows):
    """Vectorized :func:`wants_cpu_bind` over lowered arrays
    (``qos_rows`` int QoS values, ``cpu_milli_rows`` CPU requests)."""
    import numpy as _np

    bind = _np.zeros(qos_rows.shape, bool)
    for q in CPU_BIND_QOS:
        bind |= qos_rows == int(q)
    return bind & (cpu_milli_rows > 0) & (_np.mod(cpu_milli_rows, 1000.0) == 0)


def qos_for_priority(prio: PriorityClass) -> QoSClass:
    """Default QoS when unspecified, by priority band (reference
    ``apis/extension/qos.go`` ``GetPodQoSClassByName`` fallback semantics)."""
    if prio in (PriorityClass.BATCH, PriorityClass.FREE):
        return QoSClass.BE
    if prio in (PriorityClass.PROD, PriorityClass.MID):
        return QoSClass.LS
    return QoSClass.NONE


# ---- CPU shared pools / kubelet state / NUMA spec wire accessors ----
# (reference ``apis/extension/numa_aware.go`` GetNodeCPUSharePools /
# GetNodeBECPUSharePools / GetKubeletCPUManagerPolicy /
# GetNUMATopologySpec, ``system_qos.go`` GetSystemQOSResource,
# ``node_qos.go`` GetNodeTotalBandwidth, ``resource.go``
# Get/SetExtendedResourceSpec)


def parse_cpu_shared_pools(annotations: Mapping[str, str], be: bool = False):
    """[{"socket": s, "node": n, "cpuset": "0-3,8"}] — the LS (or BE)
    shared pools the koordlet computed for this node; [] when absent or
    malformed."""
    key = (
        ANNOTATION_NODE_BE_CPU_SHARED_POOLS
        if be
        else ANNOTATION_NODE_CPU_SHARED_POOLS
    )
    pools = _parse_json_annotation(annotations, key, list)
    if pools is None:
        return []
    return [p for p in pools if isinstance(p, dict)]


def format_cpu_shared_pools(pools) -> str:
    import json as _json

    return _json.dumps(pools, separators=(",", ":"))


def parse_kubelet_cpu_manager_policy(annotations: Mapping[str, str]):
    """{"policy": "none"|"static", "options": {..}, "reservedCPUs": ".."}
    (KubeletCPUManagerPolicy); None when unset/malformed."""
    return _parse_dict_annotation(
        annotations, ANNOTATION_KUBELET_CPU_MANAGER_POLICY
    )


def parse_node_cpu_allocs(annotations: Mapping[str, str]):
    """[{"namespace":.., "name":.., "uid":.., "cpuset": ".."}] — kubelet
    static-policy Guaranteed pods' exclusive cpusets (PodCPUAlloc)."""
    allocs = _parse_json_annotation(annotations, ANNOTATION_NODE_CPU_ALLOCS, list)
    if allocs is None:
        return []
    return [a for a in allocs if isinstance(a, dict) and a.get("cpuset")]


def parse_numa_topology_spec(annotations: Mapping[str, str]):
    """Pod-level NUMA requirement (NUMATopologySpec): returns
    {"numaTopologyPolicy": str, "singleNUMANodeExclusive": str} or None
    when the annotation is absent/malformed or carries no recognized
    field."""
    spec = _parse_dict_annotation(annotations, ANNOTATION_NUMA_TOPOLOGY_SPEC)
    if spec is None:
        return None
    if not any(
        k in spec
        for k in ("numaTopologyPolicy", "singleNUMANodeExclusive")
    ):
        return None
    return spec


def parse_system_qos_resource(annotations: Mapping[str, str]):
    """SystemQOSResource {"cpuset": .., "cpusetExclusive": bool}; None
    when unset. Exclusivity defaults True (system_qos.go:35-39)."""
    spec = _parse_dict_annotation(
        annotations, ANNOTATION_NODE_SYSTEM_QOS_RESOURCE
    )
    if spec is None or not spec.get("cpuset"):
        return None
    if "cpusetExclusive" not in spec:
        spec = dict(spec)
        spec["cpusetExclusive"] = True
    return spec


def parse_node_bandwidth(annotations: Mapping[str, str]) -> float:
    """Total node network bandwidth in bps (0 = unset/malformed)."""
    raw = annotations.get(ANNOTATION_NODE_BANDWIDTH)
    if not raw:
        return 0.0
    try:
        return max(float(raw), 0.0)
    except (TypeError, ValueError):
        return 0.0


def parse_extended_resource_spec(annotations: Mapping[str, str]):
    """ExtendedResourceSpec {"containers": {name: {"requests": {..},
    "limits": {..}}}} — the batch requests/limits the mutating webhook
    dumped for CRI-side consumers; {} when absent."""
    spec = _parse_dict_annotation(
        annotations, ANNOTATION_EXTENDED_RESOURCE_SPEC
    )
    if spec is None:
        return {}
    containers = spec.get("containers")
    return containers if isinstance(containers, dict) else {}


def format_extended_resource_spec(containers: Mapping[str, Mapping]) -> str:
    import json as _json

    return _json.dumps({"containers": dict(containers)}, separators=(",", ":"))
