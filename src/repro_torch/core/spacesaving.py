"""Capacity sizing of the SpaceSaving± summaries.

The port's own copy of ``repro/core/spacesaving.py::capacity_for``.
"""
from __future__ import annotations

import math


def capacity_for(eps: float, alpha: float = 1.0, variant: str = "ss_pm") -> int:
    """Paper-prescribed capacities: alpha/eps (lazy, Thm 2/3) or
    2*alpha/eps (SS±, Thm 4/5)."""
    if variant in ("lazy", "spacesaving", "ss"):
        return math.ceil(alpha / eps)
    return math.ceil(2.0 * alpha / eps)


__all__ = ["capacity_for"]
