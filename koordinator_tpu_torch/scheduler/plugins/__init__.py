"""Scheduler plugin managers (coscheduling / elasticquota / NUMA /
deviceshare / reservation / preemption) plus small helpers they share."""

from typing import Optional

import numpy as np


def drain_scatter_marks(mgr) -> Optional[np.ndarray]:
    """Shared ``drain_lowered_dirty`` body for managers that maintain a
    device-resident lowered table (NUMAManager / DeviceManager): consume
    ``mgr._scatter_rows`` / ``mgr._scatter_full`` and return the sorted
    snapshot row indices whose lowered rows changed since the last drain,
    or None when the resident mirror must re-upload the whole table
    (full rebuild). SINGLE-CONSUMER, like ``ClusterSnapshot.drain_dirty``
    — the scheduler's resident state is the one drainer."""
    if mgr._scatter_full:
        mgr._scatter_full = False
        mgr._scatter_rows.clear()
        return None
    rows = np.fromiter(
        mgr._scatter_rows, np.int32, count=len(mgr._scatter_rows)
    )
    rows.sort()
    mgr._scatter_rows.clear()
    return rows
