"""Admission primitives the engine shares with the serving scheduler.

The port's copy of ``mcpx/scheduler/admission.py``, trimmed to the one
estimator the engine reads: the service-time EWMA behind ``queue_stats``
and the locality sort's deadline slack.
"""

from __future__ import annotations


def ewma_update(prev: float, sample: float, alpha: float) -> float:
    """Seed-on-zero EWMA step: 0.0 means "no observation yet", so the
    first sample seeds rather than averaging against the optimistic zero."""
    return sample if prev == 0.0 else alpha * sample + (1.0 - alpha) * prev
