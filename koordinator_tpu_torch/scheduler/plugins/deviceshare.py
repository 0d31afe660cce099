"""DeviceShare host-side manager: exact GPU slot (minor) assignment.

Rebuild of the reference plugin's control plane
(``pkg/scheduler/plugins/deviceshare/plugin.go:179-556``,
``device_cache.go``, ``device_allocator.go``): ingests per-node Device
inventories, lowers per-slot free state to the solver
(``ops.device.DeviceState``), and for each winner picks concrete device
minors — best-fit partial slot for fractional requests, fully-free slots
for whole-GPU requests — writing the
``scheduling.koordinator.sh/device-allocated`` annotation
(``plugin.go:556-630``).
"""

from __future__ import annotations

import dataclasses
import time as _time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ...api import extension as ext
from ...api.types import Device, Pod
from ...core.snapshot import ClusterSnapshot

FULL = 100.0


def parse_gpu_request(pod: Pod) -> Tuple[int, float]:
    """(whole_gpus, share_percent) — see api.extension.parse_gpu_request."""
    return ext.parse_gpu_request(pod.spec.requests)


@dataclasses.dataclass
class _NodeDevices:
    #: free MEMORY percent per GPU minor (the memory-ratio dimension —
    #: the authoritative "full minor" / solver-lowering view)
    gpu_free: List[float]
    #: free CORE percent per GPU minor, tracked INDEPENDENTLY (reference
    #: ``device_cache.go`` resource-vector accounting: a high-memory/
    #: low-core pod and a low-memory/high-core pod share one GPU)
    gpu_core_free: List[float] = dataclasses.field(default_factory=list)
    #: GPU memory capacity in bytes per minor (0 = not declared by the
    #: Device CR; byte-denominated requests then cannot be converted)
    gpu_mem_cap: List[float] = dataclasses.field(default_factory=list)
    #: free percent per RDMA minor (100 = idle NIC; VF-carrying NICs are
    #: shared VF-by-VF and never consumed whole)
    rdma_free: List[float] = dataclasses.field(default_factory=list)
    #: free percent per FPGA minor
    fpga_free: List[float] = dataclasses.field(default_factory=list)
    #: PCIe root per RDMA minor ("" unknown)
    rdma_pcie: List[str] = dataclasses.field(default_factory=list)
    #: NUMA node per RDMA minor (-1 unknown; topology-scope hints)
    rdma_numa: List[int] = dataclasses.field(default_factory=list)
    #: free SR-IOV virtual-function bus IDs per RDMA minor (empty list =
    #: the NIC exposes no VFs and is allocated whole)
    rdma_vfs: List[List[str]] = dataclasses.field(default_factory=list)
    #: full VF inventory per RDMA minor (distinguishes "no VFs" from
    #: "VFs exhausted"; restores on reset)
    rdma_vf_all: List[List[str]] = dataclasses.field(default_factory=list)
    #: GPU vendor from the Device CR's gpu-vendor label ("" = generic) —
    #: dispatches the device-plugin adapter (device_plugin_adapter.go)
    vendor: str = ""
    #: pod uid -> [(minor, mem_ratio_percent, core_percent)] of GPU picks
    owners: Dict[str, List[Tuple[int, float, float]]] = dataclasses.field(
        default_factory=dict
    )
    #: pod uid -> [(minor, percent, vf_bus_id|None)] of RDMA picks
    rdma_owners: Dict[str, List[Tuple[int, float, Optional[str]]]] = (
        dataclasses.field(default_factory=dict)
    )
    #: pod uid -> [(minor, percent)] of FPGA picks
    fpga_owners: Dict[str, List[Tuple[int, float]]] = dataclasses.field(
        default_factory=dict
    )
    #: size -> partitions (GPUPartitionTable); empty = no table
    partitions: Dict[int, List["GPUPartition"]] = dataclasses.field(
        default_factory=dict
    )
    #: "Honor" | "Prefer" | ""
    partition_policy: str = ""
    #: NUMA node per minor (topology fallback packing), -1 unknown
    numa_of: List[int] = dataclasses.field(default_factory=list)
    #: PCIe root per minor ("" unknown)
    pcie_of: List[str] = dataclasses.field(default_factory=list)
    #: static (numa, pcie) interconnect group id per minor — precomputed
    #: at ingest so the per-winner topology packing is plain list ops
    group_of: List[int] = dataclasses.field(default_factory=list)
    n_groups: int = 0
    #: lazily-built constant payload fragment per minor for whole-GPU
    #: allocations (shape is fixed per node; rebuilt when the node's
    #: Device CR is re-ingested since that replaces this object)
    whole_frags: Optional[List[str]] = None


#: machine models whose boards ship the NVLink-complete 1/2/4/8 partition
#: layout (reference ``allocator_gpu_helper.go:157`` model dispatch)
HOPPER_MODELS = ("H100", "H800", "H20")


def hopper_partition_table() -> Dict[int, List["GPUPartition"]]:
    """The canonical 8-GPU Hopper partition table (reference
    ``GPUPartitionIndexOfNVIDIAHopper``): singles, NVLink pairs
    (0,1)/(2,3)/(4,5)/(6,7), quads (0-3)/(4-7), and the full octet, all at
    allocation score 1."""
    from ...api.types import GPUPartition

    def parts(groups):
        return [GPUPartition(minors=list(g)) for g in groups]

    return {
        1: parts([[m] for m in range(8)]),
        2: parts([[0, 1], [2, 3], [4, 5], [6, 7]]),
        4: parts([[0, 1, 2, 3], [4, 5, 6, 7]]),
        8: parts([list(range(8))]),
    }


def partition_table_for_model(model: str) -> Dict[int, List["GPUPartition"]]:
    """Model-dispatched default table (``getGPUPartitionIndexer``); unknown
    models get no table (topology packing applies instead)."""
    if any(model.startswith(m) for m in HOPPER_MODELS):
        return hopper_partition_table()
    return {}


class DeviceManager:
    """Per-node device inventories + exact allocation (nodeDeviceCache)."""

    def __init__(
        self,
        snapshot: ClusterSnapshot,
        max_gpus: int = 8,
        scoring_strategy: Optional[str] = None,
    ):
        self.snapshot = snapshot
        self.max_gpus = max_gpus
        #: "LeastAllocated" | "MostAllocated" | None — DeviceShare Score
        #: strategy (reference DeviceShareArgs.ScoringStrategy,
        #: deviceshare/scoring.go)
        self.scoring_strategy = scoring_strategy
        self._nodes: Dict[str, _NodeDevices] = {}
        #: incremental solver-lowering cache: rebuilding the [N, G] slot
        #: table + count vectors over every node each scheduling cycle
        #: was the latency stream's dominant fixed cost — rows refresh
        #: only for nodes whose inventory/allocations changed, and the
        #: whole cache drops on snapshot node churn (node_epoch)
        self._low: Optional[Dict[str, np.ndarray]] = None
        self._low_epoch: int = -1
        self._low_g: int = 0
        self._low_dirty: set = set()
        #: bumped whenever _lowered() actually changes the cached arrays
        #: (full rebuild or a dirty-row flush) — the scheduler keys its
        #: device-resident DeviceState upload off it
        self.lowered_version = 0
        #: snapshot row indices whose lowered rows changed since the last
        #: drain_lowered_dirty() — the scheduler scatters ONLY these into
        #: its device-resident DeviceState instead of re-uploading the
        #: whole [N, G] slot table (ROADMAP item b)
        self._scatter_rows: set = set()
        self._scatter_full = True
        #: widest GPU inventory ever ingested (monotone — shrink keeps
        #: harmless zero columns) so _lowered() needn't rescan every node
        self._max_minors: int = 0

    def _mark_dirty(self, node_name: str) -> None:
        if self._low is not None:
            self._low_dirty.add(node_name)

    def _refresh_row(self, name: str) -> None:
        """Recompute one node's row across all cached arrays."""
        low = self._low
        idx = self.snapshot.node_id(name)
        if idx is None:
            return
        st = self._nodes.get(name)
        if st is None:
            low["slots"][idx] = 0.0
            low["cap"][idx] = 0.0
            low["rdma"][idx] = 0.0
            low["fpga"][idx] = 0.0
            return
        row = np.zeros((low["slots"].shape[1],), np.float32)
        core_free = st.gpu_core_free
        for minor, free in enumerate(st.gpu_free):
            c = core_free[minor] if minor < len(core_free) else free
            row[minor] = free if free < c else c
        low["slots"][idx] = row
        low["cap"][idx] = len(st.gpu_free) * 100.0
        total = 0
        for i, f in enumerate(st.rdma_free):
            if i < len(st.rdma_vf_all) and st.rdma_vf_all[i]:
                total += len(st.rdma_vfs[i])
            elif f >= FULL - 1e-6:
                total += 1
        low["rdma"][idx] = total
        low["fpga"][idx] = sum(
            1 for f in st.fpga_free if f >= FULL - 1e-6
        )

    def _lowered(self) -> Dict[str, np.ndarray]:
        """The cached (slots, cap, rdma, fpga) arrays aligned to snapshot
        rows, refreshed incrementally. Callers must treat the returned
        arrays as read-only snapshots for immediate lowering (jnp.asarray
        / fancy indexing copy them onto the device)."""
        epoch = self.snapshot.node_epoch
        n_bucket = self.snapshot.nodes.allocatable.shape[0]
        g = max(self._max_minors or self.max_gpus, 1)
        if (
            self._low is None
            or self._low_epoch != epoch
            or g > self._low_g
            or self._low["slots"].shape[0] != n_bucket
        ):
            self._low = {
                "slots": np.zeros((n_bucket, g), np.float32),
                "cap": np.zeros((n_bucket,), np.float32),
                "rdma": np.zeros((n_bucket,), np.float32),
                "fpga": np.zeros((n_bucket,), np.float32),
            }
            self._low_epoch = epoch
            self._low_g = g
            self._low_dirty = set()
            for name in self._nodes:
                self._refresh_row(name)
            self.lowered_version += 1
            self._scatter_full = True
            self._scatter_rows.clear()
        elif self._low_dirty:
            for name in self._low_dirty:
                self._refresh_row(name)
                idx = self.snapshot.node_id(name)
                if idx is not None:
                    self._scatter_rows.add(int(idx))
            self._low_dirty = set()
            self.lowered_version += 1
        return self._low

    def drain_lowered_dirty(self) -> Optional[np.ndarray]:
        """Snapshot row indices whose lowered device rows changed since
        the last drain, or None for a full rebuild (see
        :func:`..plugins.drain_scatter_marks`). Call AFTER
        :meth:`_lowered` / ``slot_array`` (which flush pending dirty
        names)."""
        from . import drain_scatter_marks

        return drain_scatter_marks(self)

    def touch_lowered_rows(self, rows) -> None:
        """Mark lowered rows stale for the resident mirror WITHOUT a
        host-side change (anti-entropy scrubber heal path): the next
        resident refresh re-scatters host truth into exactly these
        rows."""
        self._scatter_rows.update(int(r) for r in rows)
        self.lowered_version += 1

    def upsert_device(self, device: Device) -> None:
        """Ingest/refresh a node's inventory. Live allocations survive a
        re-sync: the slot table is rebuilt from capacity and every owner's
        picks are re-applied (the reference nodeDeviceCache reconciles
        allocations from pod annotations the same way)."""
        gpus = [d for d in device.devices if d.dev_type == "gpu"]
        rdma = [d for d in device.devices if d.dev_type == "rdma"]
        fpga = [d for d in device.devices if d.dev_type == "fpga"]
        # partition table resolution (reference GetGPUPartitionTable →
        # getGPUPartitionIndexer): explicit field, else the Device CR's
        # gpu-partitions annotation, else the model-dispatched default
        partitions = dict(device.partitions)
        if not partitions:
            partitions = ext.parse_gpu_partition_table(device.meta.annotations)
        if not partitions:
            model = device.meta.labels.get(ext.LABEL_GPU_MODEL, "")
            if model:
                partitions = partition_table_for_model(model)
        policy = device.partition_policy or (
            ext.gpu_partition_policy(device.meta.labels)
            if partitions
            else ""
        )
        old = self._nodes.get(device.meta.name)
        st = _NodeDevices(
            gpu_free=[FULL] * len(gpus),
            gpu_core_free=[FULL] * len(gpus),
            gpu_mem_cap=[
                float(d.resources.get(ext.RES_GPU_MEMORY, 0.0)) for d in gpus
            ],
            rdma_free=[FULL] * len(rdma),
            rdma_pcie=[d.pcie_bus for d in rdma],
            rdma_numa=[d.numa_node for d in rdma],
            rdma_vfs=[list(d.vfs) for d in rdma],
            rdma_vf_all=[list(d.vfs) for d in rdma],
            fpga_free=[FULL] * len(fpga),
            partitions=partitions,
            partition_policy=policy,
            numa_of=[d.numa_node for d in gpus],
            pcie_of=[d.pcie_bus for d in gpus],
            vendor=device.meta.labels.get(ext.LABEL_GPU_VENDOR, ""),
        )
        gids: Dict[Tuple[int, str], int] = {}
        for d in gpus:
            key = (d.numa_node, d.pcie_bus)
            st.group_of.append(gids.setdefault(key, len(gids)))
        st.n_groups = len(gids)
        if old is not None:
            for uid, picks in old.owners.items():
                kept = [p for p in picks if p[0] < len(st.gpu_free)]
                for minor, pct, core in kept:
                    st.gpu_free[minor] = max(st.gpu_free[minor] - pct, 0.0)
                    st.gpu_core_free[minor] = max(
                        st.gpu_core_free[minor] - core, 0.0
                    )
                if kept:
                    st.owners[uid] = kept
            for uid, picks in old.rdma_owners.items():
                kept = [p for p in picks if p[0] < len(st.rdma_free)]
                for minor, pct, vf in kept:
                    if vf is not None and minor < len(st.rdma_vfs):
                        if vf in st.rdma_vfs[minor]:
                            st.rdma_vfs[minor].remove(vf)
                    else:
                        st.rdma_free[minor] = max(
                            st.rdma_free[minor] - pct, 0.0
                        )
                if kept:
                    st.rdma_owners[uid] = kept
            for uid, picks in old.fpga_owners.items():
                kept = [(m, pct) for m, pct in picks if m < len(st.fpga_free)]
                for minor, pct in kept:
                    st.fpga_free[minor] = max(st.fpga_free[minor] - pct, 0.0)
                if kept:
                    st.fpga_owners[uid] = kept
        self._nodes[device.meta.name] = st
        if len(st.gpu_free) > self._max_minors:
            self._max_minors = len(st.gpu_free)
        if self._low is not None and len(st.gpu_free) > self._low_g:
            self._low = None  # wider inventory: slot table must regrow
        else:
            self._mark_dirty(device.meta.name)

    def node(self, name: str) -> Optional[_NodeDevices]:
        return self._nodes.get(name)

    def remove_device(self, node_name: str) -> None:
        """Drop a node's device inventory (Device CR deleted / node gone);
        held allocations die with it — owners release via pod lifecycle."""
        self._nodes.pop(node_name, None)
        self._mark_dirty(node_name)

    @property
    def has_devices(self) -> bool:
        return bool(self._nodes)

    @property
    def has_rdma(self) -> bool:
        """Whether ANY node carries RDMA NICs — lets the solver trace the
        RDMA feasibility/carry out entirely on GPU-only clusters."""
        return any(st.rdma_free for st in self._nodes.values())

    @property
    def has_fpga(self) -> bool:
        return any(st.fpga_free for st in self._nodes.values())

    # ---- solver lowering ----

    def slot_array(self) -> np.ndarray:
        """slot_free [N, G] aligned to snapshot rows (ops.device.DeviceState).
        G grows with the largest node inventory — no silent truncation.
        Per-slot value is min(memory%, core%) free: the solver's share
        check must hold on BOTH dims; the host allocator revalidates
        exactly per dim. Incrementally cached (see ``_lowered``)."""
        return self._lowered()["slots"]

    def cap_array(self) -> np.ndarray:
        """Total GPU percent-units per node, [N] aligned to snapshot rows."""
        return self._lowered()["cap"]

    def rdma_array(self) -> np.ndarray:
        """Free RDMA allocation capacity per node, [N] aligned to snapshot
        rows: a VF-carrying NIC contributes its free VF count (it hosts
        one pod per VF), a plain NIC contributes 1 while idle."""
        return self._lowered()["rdma"]

    def fpga_array(self) -> np.ndarray:
        """Free FPGA count per node, [N] aligned to snapshot rows."""
        return self._lowered()["fpga"]

    # ---- device-plugin adapter (PreBind annotations) ----

    def adapter_annotations(
        self, node_name: str, uid: str, now: Optional[float] = None
    ) -> Dict[str, str]:
        """Vendor device-plugin protocol annotations for a device winner
        (reference ``device_plugin_adapter.go``): the bind timestamp in
        unix nanos always (plugins can't read pod manifests from kubelet
        and disambiguate same-node pods by it); the allocated GPU minors
        as a comma list; and for Huawei-vendor inventories the NPU
        plugin's ``predicate-time`` + ``huawei.com/npu-core`` pair (the
        full-NPU path — this rebuild carries no vNPU shared-resource
        templates)."""
        # time_ns: float seconds would quantize at ~µs and collide for
        # same-round winners, which plugins disambiguate by this value
        ts = str(
            int(now * 1e9) if now is not None else _time.time_ns()
        )
        out = {ext.ANNOTATION_BIND_TIMESTAMP: ts}
        st = self._nodes.get(node_name)
        if st is None:
            return out
        picks = st.owners.get(uid)
        if picks:
            minors = ",".join(str(m) for m, _pct, _core in picks)
            out[ext.ANNOTATION_GPU_MINORS] = minors
            if st.vendor == ext.GPU_VENDOR_HUAWEI:
                out[ext.ANNOTATION_PREDICATE_TIME] = ts
                out[ext.ANNOTATION_HUAWEI_NPU_CORE] = minors
        return out

    # ---- exact assignment (Reserve/PreBind) ----

    def allocate(self, pod: Pod, node_name: str) -> Optional[Mapping[str, str]]:
        """Pick concrete minors for the winner; None = failed Reserve.

        GPU and RDMA are allocated jointly: with the joint-allocate
        annotation (``device_allocator.go:205-252`` tryJointAllocate), the
        GPU picks' PCIe roots steer the RDMA picks — preferred by default,
        binding under the SamePCIe required scope (the RDMA PCIe set must
        equal the GPU PCIe set, ``validateJointAllocation``)."""
        whole, share = parse_gpu_request(pod)
        payload = self.allocate_lowered(
            pod.meta.uid,
            pod.meta.annotations,
            node_name,
            whole,
            share,
            ext.parse_rdma_request(pod.spec.requests),
            ext.parse_fpga_request(pod.spec.requests),
            requests=pod.spec.requests,
        )
        if payload is None:
            return None
        if not payload:
            return {}
        patch = {ext.ANNOTATION_DEVICE_ALLOCATED: payload}
        patch.update(self.adapter_annotations(node_name, pod.meta.uid))
        return patch

    def allocate_lowered(
        self,
        uid: str,
        annotations: Mapping[str, str],
        node_name: str,
        whole: int,
        share: float,
        rdma_count: int,
        fpga_count: int,
        requests: Optional[Mapping[str, float]] = None,
    ) -> Optional[str]:
        """Lean core of ``allocate`` for the batched commit: requests are
        pre-lowered by the caller. Returns the device-allocated JSON
        payload, ``""`` when the pod wants no devices, None on failure.

        With ``requests``, the GPU demand is re-derived as an independent
        (core%, memory) vector (:func:`ext.parse_gpu_request_vector`) so a
        high-memory/low-core pod and a low-memory/high-core pod can share
        one GPU; without it the scalar ``share`` charges both dims
        equally (conservative)."""
        if whole == 0 and share <= 0 and rdma_count == 0 and fpga_count == 0:
            return ""
        st = self._nodes.get(node_name)
        if st is None:
            return None
        if requests is not None and (
            ext.RES_GPU_CORE in requests
            or ext.RES_GPU_MEMORY in requests
            or ext.RES_GPU_MEMORY_RATIO in requests
            or ext.RES_KOORD_GPU in requests
        ):
            whole, core, ratio, mem_bytes = ext.parse_gpu_request_vector(
                requests
            )
        else:
            # whole-GPU-only request: the lowered scalars already say it
            # all — skip the per-dim re-parse (commit hot path)
            core, ratio, mem_bytes = share, share, None
        picks: List[Tuple[int, float, float]] = []
        free = list(st.gpu_free)
        core_free = list(st.gpu_core_free)
        full_minors = [
            i
            for i, f in enumerate(free)
            if f >= FULL - 1e-6 and core_free[i] >= FULL - 1e-6
        ]
        if len(full_minors) < whole:
            return None
        if whole > 0:
            chosen = self._pick_whole_minors(
                st, full_minors, whole, annotations
            )
            if chosen is None:
                return None
            for minor in chosen:
                picks.append((minor, FULL, FULL))
                free[minor] = 0.0
                core_free[minor] = 0.0
        if core > 0 or ratio > 0 or mem_bytes is not None:
            # per-minor memory need in ratio percent: byte-denominated
            # requests convert via the minor's declared capacity
            # (device_cache.go converts memory<->ratio the same way)
            caps = st.gpu_mem_cap

            def mem_need(i: int) -> Optional[float]:
                if mem_bytes is None:
                    return ratio
                cap = caps[i] if i < len(caps) else 0.0
                if cap <= 0:
                    return None  # capacity undeclared: cannot account
                return mem_bytes / cap * 100.0

            # best-fit: tightest partial slot where BOTH dims fit, else a
            # fresh full slot (reference allocator_gpu.go scoring)
            best = None
            for i, f in enumerate(free):
                if f >= FULL - 1e-6 and core_free[i] >= FULL - 1e-6:
                    continue  # fully-free slots are the fallback
                need = mem_need(i)
                if need is None or f < need - 1e-6:
                    continue
                if core_free[i] < core - 1e-6:
                    continue
                if best is None or f < best[0]:
                    best = (f, i)
            if best is not None:
                minor = best[1]
            else:
                minor = next(
                    (
                        i
                        for i, f in enumerate(free)
                        if f >= FULL - 1e-6
                        and core_free[i] >= FULL - 1e-6
                        and mem_need(i) is not None
                        and mem_need(i) <= FULL + 1e-6
                    ),
                    None,
                )
                if minor is None:
                    return None
            need = mem_need(minor)
            picks.append((minor, need, core))
            free[minor] -= need
            core_free[minor] -= core
        # per-type allocation hints (device_share.go:147-190): the RDMA
        # strategy may rewrite the count, and a required topology scope
        # constrains which NICs may be grouped
        hints = ext.parse_device_allocate_hints(annotations)
        rdma_hint = hints.get("rdma", {})
        strategy = rdma_hint.get("allocateStrategy", "")
        if (
            strategy == ext.DEVICE_ALLOCATE_STRATEGY_REQUESTS_AS_COUNT
            and requests is not None
        ):
            # the raw request value IS the device count (not 100-units)
            try:
                rdma_count = int(float(requests.get(ext.RES_RDMA, 0.0)))
            except (TypeError, ValueError):
                pass
        elif strategy == ext.DEVICE_ALLOCATE_STRATEGY_APPLY_FOR_ALL:
            # one allocation on EVERY rdma device of the node (the
            # machine-wide NIC pattern for distributed training pods)
            rdma_count = max(rdma_count, len(st.rdma_free))
        rdma_picks: List[Tuple[int, float, Optional[str]]] = []
        if rdma_count > 0:
            gpu_pcies = {
                st.pcie_of[p[0]] for p in picks if p[0] < len(st.pcie_of)
            }
            chosen_rdma = self._pick_rdma(
                st,
                rdma_count,
                ext.parse_device_joint_allocate(annotations),
                gpu_pcies,
                topology_scope=rdma_hint.get("requiredTopologyScope", ""),
            )
            if chosen_rdma is None:
                return None
            for m in chosen_rdma:
                if st.rdma_vf_all[m] if m < len(st.rdma_vf_all) else False:
                    # VF-carrying NIC: hand out one VF, never the whole
                    # NIC (SR-IOV sharing, device_share.go:126-139)
                    if not st.rdma_vfs[m]:
                        return None
                    rdma_picks.append((m, FULL, st.rdma_vfs[m][0]))
                else:
                    rdma_picks.append((m, FULL, None))
        fpga_picks: List[Tuple[int, float]] = []
        if fpga_count > 0:
            free_fpga = [
                i for i, f in enumerate(st.fpga_free) if f >= FULL - 1e-6
            ]
            if len(free_fpga) < fpga_count:
                return None
            fpga_picks = [(m, FULL) for m in free_fpga[:fpga_count]]
        # all picks succeeded — commit atomically
        st.gpu_free = free
        st.gpu_core_free = core_free
        if picks:
            st.owners[uid] = picks
        for minor, pct, vf in rdma_picks:
            if vf is not None:
                st.rdma_vfs[minor].remove(vf)
            else:
                st.rdma_free[minor] = max(st.rdma_free[minor] - pct, 0.0)
        if rdma_picks:
            st.rdma_owners[uid] = rdma_picks
        for minor, pct in fpga_picks:
            st.fpga_free[minor] = max(st.fpga_free[minor] - pct, 0.0)
        if fpga_picks:
            st.fpga_owners[uid] = fpga_picks
        self._mark_dirty(node_name)
        # hand-rendered device-allocated JSON (shape is fixed; json.dumps
        # per winner was a visible slice of the commit hot path). GPU
        # entries carry the full per-dim vector (gpu-core / memory-ratio /
        # memory bytes when capacity is declared); RDMA entries carry the
        # assigned VF in the reference's DeviceAllocationExtension shape.
        parts: List[str] = []
        if picks:
            gpu_items = []
            for minor, pct, core_pct in picks:
                res = '"%s": %s, "%s": %s' % (
                    ext.RES_GPU_CORE,
                    core_pct,
                    ext.RES_GPU_MEMORY_RATIO,
                    pct,
                )
                cap = (
                    st.gpu_mem_cap[minor]
                    if minor < len(st.gpu_mem_cap)
                    else 0.0
                )
                if cap > 0:
                    res += ', "%s": %d' % (
                        ext.RES_GPU_MEMORY,
                        int(pct / 100.0 * cap),
                    )
                gpu_items.append(
                    '{"minor": %d, "resources": {%s}}' % (minor, res)
                )
            parts.append('"gpu": [%s]' % ", ".join(gpu_items))
        if rdma_picks:
            rdma_items = []
            for minor, pct, vf in rdma_picks:
                if vf is not None:
                    rdma_items.append(
                        '{"minor": %d, "resources": {"%s": %s}, '
                        '"extension": {"vfs": [{"busID": "%s"}]}}'
                        % (minor, ext.RES_RDMA, pct, vf)
                    )
                else:
                    rdma_items.append(
                        '{"minor": %d, "resources": {"%s": %s}}'
                        % (minor, ext.RES_RDMA, pct)
                    )
            parts.append('"rdma": [%s]' % ", ".join(rdma_items))
        if fpga_picks:
            parts.append(
                '"fpga": [%s]'
                % ", ".join(
                    '{"minor": %d, "resources": {"%s": %s}}'
                    % (minor, ext.RES_FPGA, pct)
                    for minor, pct in fpga_picks
                )
            )
        return "{%s}" % ", ".join(parts)

    def allocate_batch(
        self,
        uids: List[str],
        annotations: List[Mapping[str, str]],
        node_names: List[str],
        whole_l: List[int],
        share_l: List[float],
        rdma_l: List[int],
        fpga_l: List[int],
        requests_l: List[Optional[Mapping[str, float]]],
    ) -> List[Optional[str]]:
        """Batched :meth:`allocate_lowered` over one chunk's winners in
        commit order (VERDICT r3 #1: the per-winner device loop was the
        device-gang scenario's host wall). Winners are grouped by node;
        whole-GPU-only requests with no device annotations take a lean
        inline path (full-minor scan → topology-group pick → in-place
        charge → pre-rendered payload fragments); anything else falls
        back to :meth:`allocate_lowered` with identical semantics."""
        n = len(uids)
        results: List[Optional[str]] = [""] * n
        by_node: Dict[str, List[int]] = {}
        for i, name in enumerate(node_names):
            lst = by_node.get(name)
            if lst is None:
                by_node[name] = [i]
            else:
                lst.append(i)
        hint_key = ext.ANNOTATION_DEVICE_ALLOCATE_HINT
        joint_key = ext.ANNOTATION_DEVICE_JOINT_ALLOCATE
        part_key = ext.ANNOTATION_GPU_PARTITION_SPEC
        full_eps = FULL - 1e-6
        for name, rows_i in by_node.items():
            st = self._nodes.get(name)
            if st is None:
                for i in rows_i:
                    if (
                        whole_l[i] > 0
                        or share_l[i] > 0
                        or rdma_l[i] > 0
                        or fpga_l[i] > 0
                    ):
                        results[i] = None
                continue
            partitioned = bool(st.partitions) and st.partition_policy in (
                "Honor",
                "Prefer",
            )
            gpu_free = st.gpu_free
            core_free = st.gpu_core_free
            n_minors = len(gpu_free)
            owners = st.owners
            frags = st.whole_frags
            if frags is None:
                caps = st.gpu_mem_cap
                frags = []
                for m in range(n_minors):
                    res = '"%s": %s, "%s": %s' % (
                        ext.RES_GPU_CORE,
                        FULL,
                        ext.RES_GPU_MEMORY_RATIO,
                        FULL,
                    )
                    cap = caps[m] if m < len(caps) else 0.0
                    if cap > 0:
                        res += ', "%s": %d' % (ext.RES_GPU_MEMORY, int(cap))
                    frags.append('{"minor": %d, "resources": {%s}}' % (m, res))
                st.whole_frags = frags
            # free minors bucketed by topology group ONCE per node, drained
            # across this node's winners (rebuilding the full-minor list per
            # winner was the remaining per-pod scan in the lean path)
            group_of = st.group_of
            n_groups = max(st.n_groups, 1)
            by_group: Optional[List[List[int]]] = None
            for i in rows_i:
                whole = whole_l[i]
                ann = annotations[i]
                req = requests_l[i]
                if (
                    whole > 0
                    and share_l[i] <= 0
                    and rdma_l[i] == 0
                    and fpga_l[i] == 0
                    and not partitioned
                    and hint_key not in ann
                    and joint_key not in ann
                    and part_key not in ann
                    and (
                        req is None
                        or (
                            ext.RES_GPU_CORE not in req
                            and ext.RES_GPU_MEMORY not in req
                            and ext.RES_GPU_MEMORY_RATIO not in req
                            and ext.RES_KOORD_GPU not in req
                        )
                    )
                ):
                    if by_group is None:
                        by_group = [[] for _ in range(n_groups)]
                        for m in range(n_minors):
                            if gpu_free[m] >= full_eps and core_free[m] >= full_eps:
                                by_group[
                                    group_of[m] if m < len(group_of) else 0
                                ].append(m)
                    chosen = self._pick_grouped_free(by_group, whole)
                    if chosen is None:
                        results[i] = None
                        continue
                    for m in chosen:
                        gpu_free[m] = 0.0
                        core_free[m] = 0.0
                    owners[uids[i]] = [(m, FULL, FULL) for m in chosen]
                    self._mark_dirty(name)
                    results[i] = '{"gpu": [%s]}' % ", ".join(
                        frags[m] for m in chosen
                    )
                elif (
                    whole == 0
                    and share_l[i] <= 0
                    and rdma_l[i] == 0
                    and fpga_l[i] == 0
                ):
                    continue  # no device demand: results stays ""
                else:
                    results[i] = self.allocate_lowered(
                        uids[i],
                        ann,
                        name,
                        whole,
                        share_l[i],
                        rdma_l[i],
                        fpga_l[i],
                        requests=req,
                    )
                    # allocate_lowered commits by REBINDING st.gpu_free /
                    # st.gpu_core_free to fresh lists — re-hoist or the
                    # lean path keeps mutating the orphaned old lists
                    # (double-allocating minors and losing charges)
                    gpu_free = st.gpu_free
                    core_free = st.gpu_core_free
                    by_group = None  # free set changed: rebuild lazily
        return results

    def _pick_rdma(
        self,
        st: _NodeDevices,
        count: int,
        joint: "Optional[Tuple[Tuple[str, ...], str]]",
        gpu_pcies: set,
        topology_scope: str = "",
    ) -> Optional[List[int]]:
        """Choose RDMA minors. Joint allocation with GPUs prefers NICs on
        the GPUs' PCIe roots; the SamePCIe scope requires the chosen NICs'
        PCIe set to exactly equal the GPUs' (one per root, count bumped to
        the root count like the reference's desiredCount adjustment).
        A VF-carrying NIC is available while it has a free VF (it is
        shared, never consumed whole); a plain NIC while idle.
        ``topology_scope`` (DeviceHint.RequiredTopologyScope): "PCIe" /
        "NUMANode" restricts the chosen set to NICs sharing that scope."""
        free_minors = [
            i
            for i in range(len(st.rdma_free))
            if (
                bool(st.rdma_vfs[i])
                if i < len(st.rdma_vf_all) and st.rdma_vf_all[i]
                else st.rdma_free[i] >= FULL - 1e-6
            )
        ]
        if topology_scope in ("PCIe", "NUMANode"):
            def scope_key(m: int):
                if topology_scope == "PCIe":
                    return st.rdma_pcie[m] if m < len(st.rdma_pcie) else ""
                return st.rdma_numa[m] if m < len(st.rdma_numa) else -1

            groups: Dict[object, List[int]] = {}
            for m in free_minors:
                groups.setdefault(scope_key(m), []).append(m)
            fitting = [g for g in groups.values() if len(g) >= count]
            if not fitting:
                return None
            # tightest fitting scope group (least leftover)
            free_minors = min(fitting, key=len)
        if len(free_minors) < count:
            return None
        joint_with_gpu = (
            joint is not None and "rdma" in joint[0] and bool(gpu_pcies)
        )
        if not joint_with_gpu:
            return free_minors[:count]
        scope = joint[1]
        in_pcie = [m for m in free_minors if st.rdma_pcie[m] in gpu_pcies]
        if scope == "SamePCIe":
            per_pcie: Dict[str, List[int]] = {}
            for m in in_pcie:
                per_pcie.setdefault(st.rdma_pcie[m], []).append(m)
            if set(per_pcie) != gpu_pcies:
                return None  # some GPU PCIe root has no free NIC
            need = max(count, len(gpu_pcies))
            chosen = [per_pcie[p][0] for p in sorted(per_pcie)]
            extras = [m for p in sorted(per_pcie) for m in per_pcie[p][1:]]
            for m in extras:
                if len(chosen) >= need:
                    break
                chosen.append(m)
            return chosen if len(chosen) >= need else None
        ordered = in_pcie + [m for m in free_minors if m not in set(in_pcie)]
        return ordered[:count]

    # ---- whole-GPU selection: partition table + topology packing ----
    # Rebuild of the reference's partition allocator
    # (``allocator_gpu.go:177-299`` allocateByPartition /
    # selectPartitionByBinPack): multi-GPU allocations land inside one
    # interconnect-complete partition; among feasible partitions, prefer
    # the one that keeps the most high-value larger partitions intact.

    def _pick_whole_minors(
        self,
        st: _NodeDevices,
        full_minors: List[int],
        whole: int,
        annotations: Mapping[str, str],
    ) -> Optional[List[int]]:
        """``full_minors``: minors fully free on every dimension (the
        caller computes them over both memory and core)."""
        if st.partitions and st.partition_policy in ("Honor", "Prefer"):
            chosen = self._allocate_by_partition(
                st, full_minors, whole, annotations
            )
            if chosen is not None:
                return chosen
            if st.partition_policy == "Honor":
                # table is binding: no feasible partition = failed Reserve
                # (ErrInsufficientPartitionedDevice / unsupported size)
                return None
        return self._allocate_by_topology(st, full_minors, whole)

    def _allocate_by_partition(
        self,
        st: _NodeDevices,
        full_minors: List[int],
        whole: int,
        annotations: Mapping[str, str],
    ) -> Optional[List[int]]:
        table = st.partitions.get(whole)
        if not table:
            return None
        restricted, want_bw = ext.parse_gpu_partition_spec(annotations)
        free_mask = 0
        for m in full_minors:
            free_mask |= 1 << m
        # walk allocation-score tiers best-first; Restricted pods may only
        # use the best tier, BestEffort walks down until one is feasible
        tiers: Dict[int, List] = {}
        for part in table:
            tiers.setdefault(part.allocation_score, []).append(part)
        feasible = []
        for score in sorted(tiers, reverse=True):
            for part in tiers[score]:
                if part.minors_mask & ~free_mask:
                    continue    # some minor busy or absent
                if want_bw > 0 and part.ring_bus_bandwidth < want_bw:
                    continue
                feasible.append(part)
            if feasible or restricted:
                break
        if not feasible:
            return None
        if len(feasible) == 1:
            return list(feasible[0].minors)
        return list(self._bin_pack_partition(st, free_mask, feasible, whole).minors)

    def _bin_pack_partition(self, st, free_mask: int, feasible, whole: int):
        """Choose the partition whose allocation preserves the most intact
        larger partitions, weighted steeply by size (reference
        selectPartitionByBinPack weights {8: 10000, 4: 100, 2: 1})."""
        weight = {8: 10_000, 4: 100, 2: 1}

        def preserve_score(candidate) -> int:
            after_busy = ~free_mask | candidate.minors_mask
            score = 0
            for size, parts in st.partitions.items():
                if size < whole or size not in weight:
                    continue
                for part in parts:
                    if part.minors_mask & after_busy:
                        continue
                    score += weight[size] * part.allocation_score
            return score

        return max(feasible, key=preserve_score)

    @staticmethod
    def _pick_grouped_free(
        by_group: List[List[int]], whole: int
    ) -> Optional[List[int]]:
        """Tightest-group whole-GPU pick over live free-minor buckets,
        DRAINING the chosen minors in place (same policy as
        :meth:`_allocate_by_topology`: smallest satisfying NUMA/PCIe
        group, else spill across groups largest-first)."""
        if len(by_group) == 1:
            b = by_group[0]
            if len(b) < whole:
                return None
            chosen = b[:whole]
            del b[:whole]
            return chosen
        best: Optional[List[int]] = None
        for b in by_group:
            if len(b) >= whole and (best is None or len(b) < len(best)):
                best = b
        if best is not None:
            chosen = best[:whole]
            del best[:whole]
            return chosen
        if sum(len(b) for b in by_group) < whole:
            return None
        out: List[int] = []
        for g in sorted(by_group, key=len, reverse=True):
            need = whole - len(out)
            if need <= 0:
                break
            out.extend(g[:need])
            del g[:need]
        return out

    def _allocate_by_topology(
        self, st: _NodeDevices, full_minors: List[int], whole: int
    ) -> Optional[List[int]]:
        """No (binding) partition table: pack onto the fewest NUMA/PCIe
        domains, preferring the domain group with least leftover (the
        reference's GPUTopologyScope bin-pack, ``allocator_gpu.go:300+``).
        Group membership is static per node (``group_of``, precomputed at
        ingest), so the per-winner work is plain list bucketing."""
        if len(full_minors) < whole:
            return None
        if st.n_groups <= 1:
            return full_minors[:whole]
        group_of = st.group_of
        buckets: List[List[int]] = [[] for _ in range(st.n_groups)]
        for m in full_minors:
            buckets[group_of[m] if m < len(group_of) else 0].append(m)
        # smallest group that satisfies the request = tightest fit
        best: Optional[List[int]] = None
        for b in buckets:
            if len(b) >= whole and (best is None or len(b) < len(best)):
                best = b
        if best is not None:
            return best[:whole]
        # spill across groups, draining the largest first
        ordered = sorted(buckets, key=len, reverse=True)
        out: List[int] = []
        for g in ordered:
            out.extend(g)
            if len(out) >= whole:
                return out[:whole]
        return None

    def reset_allocations(self) -> None:
        """Free every slot and drop all owners (full-resync path)."""
        for st in self._nodes.values():
            st.gpu_free = [FULL] * len(st.gpu_free)
            st.gpu_core_free = [FULL] * len(st.gpu_core_free)
            st.rdma_free = [FULL] * len(st.rdma_free)
            st.rdma_vfs = [list(v) for v in st.rdma_vf_all]
            st.fpga_free = [FULL] * len(st.fpga_free)
            st.owners.clear()
            st.rdma_owners.clear()
            st.fpga_owners.clear()
        self._low = None

    def release(self, pod_uid: str, node_name: str) -> None:
        st = self._nodes.get(node_name)
        if st is None:
            return
        self._mark_dirty(node_name)
        for minor, pct, core in st.owners.pop(pod_uid, []):
            st.gpu_free[minor] = min(st.gpu_free[minor] + pct, FULL)
            st.gpu_core_free[minor] = min(
                st.gpu_core_free[minor] + core, FULL
            )
        for minor, pct, vf in st.rdma_owners.pop(pod_uid, []):
            if vf is not None:
                if vf not in st.rdma_vfs[minor]:
                    st.rdma_vfs[minor].append(vf)
            else:
                st.rdma_free[minor] = min(st.rdma_free[minor] + pct, FULL)
        for minor, pct in st.fpga_owners.pop(pod_uid, []):
            st.fpga_free[minor] = min(st.fpga_free[minor] + pct, FULL)

    # ---- exact-hold journal coverage (HA PR 6 satellite) ----

    def hold_of(self, pod_uid: str, node_name: str) -> Optional[dict]:
        """JSON-serializable snapshot of the pod's exact device hold —
        concrete GPU minors (+share/core pct), RDMA minors (+VF), FPGA
        minors — for the write-ahead bind journal, so a takeover
        restores the EXACT slots via :meth:`restore_hold` instead of
        re-picking (a re-pick could legally choose different minors and
        silently diverge from the annotations the kubelet already
        acted on)."""
        st = self._nodes.get(node_name)
        if st is None:
            return None
        gpu = st.owners.get(pod_uid)
        rdma = st.rdma_owners.get(pod_uid)
        fpga = st.fpga_owners.get(pod_uid)
        if not gpu and not rdma and not fpga:
            return None
        hold: dict = {}
        if gpu:
            hold["gpu"] = [[int(m), float(p), float(c)] for m, p, c in gpu]
        if rdma:
            hold["rdma"] = [[int(m), float(p), vf] for m, p, vf in rdma]
        if fpga:
            hold["fpga"] = [[int(m), float(p)] for m, p in fpga]
        return hold

    def restore_hold(self, pod_uid: str, node_name: str, hold: dict) -> None:
        """Re-install a journaled device hold on a recovering instance
        (idempotent: a pod already owning slots on this node is left
        alone — the statehub resync may have re-registered it first)."""
        st = self._nodes.get(node_name)
        if st is None:
            return
        if (
            pod_uid in st.owners
            or pod_uid in st.rdma_owners
            or pod_uid in st.fpga_owners
        ):
            return
        self._mark_dirty(node_name)
        gpu = [
            (int(m), float(p), float(c))
            for m, p, c in hold.get("gpu", ())
            if int(m) < len(st.gpu_free)
        ]
        if gpu:
            for m, p, c in gpu:
                st.gpu_free[m] = max(st.gpu_free[m] - p, 0.0)
                st.gpu_core_free[m] = max(st.gpu_core_free[m] - c, 0.0)
            st.owners[pod_uid] = gpu
        rdma = [
            (int(m), float(p), vf)
            for m, p, vf in hold.get("rdma", ())
            if int(m) < len(st.rdma_free)
        ]
        if rdma:
            for m, p, vf in rdma:
                if vf is not None:
                    try:
                        st.rdma_vfs[m].remove(vf)
                    except ValueError:
                        pass
                else:
                    st.rdma_free[m] = max(st.rdma_free[m] - p, 0.0)
            st.rdma_owners[pod_uid] = rdma
        fpga = [
            (int(m), float(p))
            for m, p in hold.get("fpga", ())
            if int(m) < len(st.fpga_free)
        ]
        if fpga:
            for m, p in fpga:
                st.fpga_free[m] = max(st.fpga_free[m] - p, 0.0)
            st.fpga_owners[pod_uid] = fpga
