"""Per-subsystem health aggregation behind the ``/healthz`` endpoint.

Each hardened subsystem (solver fallback ladder, cycle deadline, commit
journal, snapshot channel, informers, koordlet ticks) reports its
degraded/ok state here; the services engine serves the aggregate as
``/healthz`` — 200 when every subsystem is ok, 503 with the per-subsystem
detail when anything is degraded. Degraded is a *state*, not an event:
a subsystem sets it when it enters a fallback and clears it when the
recovery path re-promotes (so a scraper sees the current truth, not a
counter it has to rate()).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, Optional


class HealthRegistry:
    """Thread-safe subsystem → (ok, detail, since) map."""

    def __init__(self, clock=time.time):
        self._clock = clock
        self._state: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def set(self, subsystem: str, ok: bool, detail: str = "") -> None:
        with self._lock:
            cur = self._state.get(subsystem)
            if cur is not None and cur["ok"] == ok and cur["detail"] == detail:
                return  # unchanged: keep the original transition time
            self._state[subsystem] = {
                "ok": bool(ok),
                "detail": detail,
                "since": self._clock(),
            }

    def get(self, subsystem: str) -> Optional[dict]:
        with self._lock:
            st = self._state.get(subsystem)
            return dict(st) if st is not None else None

    def ok(self) -> bool:
        with self._lock:
            return all(s["ok"] for s in self._state.values())

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._state.items()}

    def render(self) -> str:
        snap = self.snapshot()
        return json.dumps(
            {
                "ok": all(s["ok"] for s in snap.values()),
                "subsystems": snap,
            },
            indent=1,
            sort_keys=True,
        )
