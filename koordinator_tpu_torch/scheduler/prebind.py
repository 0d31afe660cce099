"""DefaultPreBind: accumulated object mutations applied as one patch.

Rebuild of ``pkg/scheduler/plugins/defaultprebind/plugin.go`` +
``frameworkext/interface.go:221-224`` (ApplyPodMutation): during
Reserve/PreBind, plugins stage annotation/label mutations against a pod's
*pending patch* instead of writing the object; after Permit admits the
pod, the terminal PreBind applies everything as a single merged patch —
one apiserver PATCH in the reference, one in-place update here. Pods
rolled back by Permit never see their staged mutations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..api.types import Pod


@dataclasses.dataclass
class PodPatch:
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)

    def merge(self, other: "PodPatch") -> None:
        self.annotations.update(other.annotations)
        self.labels.update(other.labels)

    @property
    def empty(self) -> bool:
        return not self.annotations and not self.labels


class DefaultPreBind:
    """Per-cycle mutation accumulator + terminal apply."""

    def __init__(self) -> None:
        self._patches: Dict[str, PodPatch] = {}
        self.applied_total = 0

    def stage_annotations(self, pod: Pod, annotations: Dict[str, str]) -> None:
        self._patches.setdefault(pod.meta.uid, PodPatch()).annotations.update(
            annotations
        )

    def stage_labels(self, pod: Pod, labels: Dict[str, str]) -> None:
        self._patches.setdefault(pod.meta.uid, PodPatch()).labels.update(labels)

    def discard(self, pod_uid: str) -> None:
        """Permit rejected the pod: staged mutations evaporate."""
        self._patches.pop(pod_uid, None)

    def apply(self, pod: Pod) -> bool:
        """Terminal PreBind for one admitted pod: one merged patch."""
        patch = self._patches.pop(pod.meta.uid, None)
        if patch is None or patch.empty:
            return False
        pod.meta.annotations.update(patch.annotations)
        pod.meta.labels.update(patch.labels)
        self.applied_total += 1
        return True

    def pending(self) -> List[str]:
        return list(self._patches)

    @property
    def has_patches(self) -> bool:
        """Whether anything was staged this cycle — lets the commit skip
        the per-pod terminal apply entirely on patch-free chunks."""
        return bool(self._patches)
