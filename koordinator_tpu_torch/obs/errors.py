"""Exception accounting: every swallowed exception is logged and counted.

The package had seven ``except Exception:`` sites that degraded silently
— correct policy (a collector failure must not kill the QoS loop), wrong
observability (nobody could see the failure rate). This module gives
them one shared discipline: :func:`report_exception` logs through the
``koordinator_tpu`` logger and increments ``exceptions_total{site}`` on
the caller's component registry (scheduler/koordlet) or, for call sites
with no registry wired, on a process-wide default registry exposed via
:func:`default_error_registry`.
"""

from __future__ import annotations

import logging
from typing import Optional

from ..utils.metrics import Registry

_log = logging.getLogger("koordinator_tpu")

#: fallback registry for call sites without a component registry
_DEFAULT = Registry(namespace="koordinator")


def ensure_exceptions_counter(reg: Registry):
    """Get-or-create the ``exceptions_total{site}`` counter on ``reg``."""
    c = reg.get("exceptions_total")
    if c is None:
        c = reg.counter(
            "exceptions_total",
            "exceptions caught and degraded (not swallowed silently)",
            labels=("site",),
        )
    return c


def default_error_registry() -> Registry:
    return _DEFAULT


def report_exception(
    site: str, exc: BaseException, registry: Optional[Registry] = None
) -> None:
    """Log ``exc`` at WARNING with its site and count it into
    ``exceptions_total{site}`` — the mandatory companion of every
    degrade-don't-crash ``except`` in the package."""
    _log.warning("exception at %s: %r", site, exc)
    ensure_exceptions_counter(registry if registry is not None else _DEFAULT).labels(
        site=site
    ).inc()


def exception_count(site: str, registry: Optional[Registry] = None) -> float:
    """Test/diagnostic helper: current count for ``site``."""
    reg = registry if registry is not None else _DEFAULT
    c = reg.get("exceptions_total")
    return 0.0 if c is None else c.value(site=site)
