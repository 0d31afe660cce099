"""Feature gates: three registries, defaulted, mutable for tests.

Rebuild of ``pkg/features/`` — the reference keeps separate gate
registries for the manager/webhook (``features.go:28-139``), koordlet
(``koordlet_features.go:33-162``) and scheduler extras
(``scheduler_features.go:32-53``). Gate names and defaults mirror the
reference; components query their registry at decision points (e.g.
``EnableQuotaAdmission`` gates the quota admission evaluator,
``BECPUSuppress`` the qosmanager strategy).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping


class FeatureGate:
    """One registry: known gates with defaults + runtime overrides."""

    def __init__(self, defaults: Mapping[str, bool]):
        self._defaults = dict(defaults)
        self._overrides: Dict[str, bool] = {}

    def enabled(self, feature: str) -> bool:
        if feature in self._overrides:
            return self._overrides[feature]
        if feature not in self._defaults:
            raise KeyError(f"unknown feature gate {feature!r}")
        return self._defaults[feature]

    def set(self, feature: str, value: bool) -> None:
        if feature not in self._defaults:
            raise KeyError(f"unknown feature gate {feature!r}")
        self._overrides[feature] = value

    def set_from_map(self, overrides: Mapping[str, bool]) -> None:
        """componentconfig ``--feature-gates`` ingestion."""
        for feature, value in overrides.items():
            self.set(feature, value)

    def known(self) -> Dict[str, bool]:
        out = dict(self._defaults)
        out.update(self._overrides)
        return out

    @contextlib.contextmanager
    def override(self, feature: str, value: bool) -> Iterator[None]:
        """Test helper (the reference's featuregatetesting.SetFeatureGateDuringTest)."""
        had = feature in self._overrides
        old = self._overrides.get(feature)
        self.set(feature, value)
        try:
            yield
        finally:
            if had:
                self._overrides[feature] = old  # type: ignore[assignment]
            else:
                del self._overrides[feature]


#: manager/webhook gates (reference features.go:28-139)
MANAGER_GATES = FeatureGate(
    {
        "PodMutatingWebhook": True,
        "PodValidatingWebhook": True,
        "ElasticMutatingWebhook": True,
        "ElasticValidatingWebhook": True,
        "NodeMutatingWebhook": False,
        "NodeValidatingWebhook": False,
        "ConfigMapValidatingWebhook": False,
        "ReservationMutatingWebhook": False,
        "ColocationProfileSkipMutatingResources": False,
        "WebhookFramework": True,
        "MultiQuotaTree": False,
        "ElasticQuotaGuaranteeUsage": False,
        "DisableDefaultQuota": False,
        "SupportParentQuotaSubmitPod": False,
        "EnableQuotaAdmission": False,
        "EnableSyncGPUSharedResource": False,
        "ColocationProfileController": False,
        "ValidatePodDeviceResource": False,
    }
)

#: koordlet gates (reference koordlet_features.go:33-162)
KOORDLET_GATES = FeatureGate(
    {
        "AuditEvents": False,
        "AuditEventsHTTPHandler": False,
        "BECPUSuppress": True,
        "BECPUManager": False,
        "BECPUEvict": False,
        "BEMemoryEvict": False,
        "CPUBurst": False,
        "SystemConfig": False,
        "RdtResctrl": True,
        "CgroupReconcile": False,
        "NodeTopologyReport": True,
        "Accelerators": False,
        "RDMADevices": False,
        "CPICollector": False,
        "PSICollector": False,
        "ResctrlCollector": False,
        "BlkIOReconcile": False,
        "ColdPageCollector": False,
        "PodResourcesProxy": False,
    }
)

#: scheduler extra gates (reference scheduler_features.go:32-53)
SCHEDULER_GATES = FeatureGate(
    {
        "MultiQuotaTree": False,
        "ElasticQuotaIgnorePodOverhead": False,
        "ElasticQuotaIgnoreTerminatingPod": False,
        "ElasticQuotaGuaranteeUsage": False,
        "DisableDefaultQuota": False,
        "SupportParentQuotaSubmitPod": False,
        "ResizePod": False,
        "LazyReservationRestore": False,
        "OmitNodeLabelsForReservation": False,
        "DisablePVCReservation": False,
        "PriorityTransformer": False,
        "PreemptionPolicyTransformer": False,
        "DevicePluginAdaption": False,
    }
)
