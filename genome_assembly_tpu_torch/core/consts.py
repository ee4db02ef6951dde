"""The reference's ``consts`` getters (consts.py:12-45), for code written
against that interface. New code reads ``core.config.ParamBounds`` and
``METRIC_NAMES`` directly.
"""

from __future__ import annotations

from .config import METRIC_LABELS, METRIC_NAMES, ParamBounds

_BOUNDS = ParamBounds()


def get_lower_bound_l() -> int:
    return _BOUNDS.lower_l


def get_upper_bound_l() -> int:
    return _BOUNDS.upper_l


def get_lower_bound_n() -> int:
    return _BOUNDS.lower_n


def get_upper_bound_n() -> int:
    return _BOUNDS.upper_n


def get_lower_bound_p() -> float:
    return _BOUNDS.lower_p


def get_upper_bound_p() -> float:
    return _BOUNDS.upper_p


def get_big_n() -> int:
    return _BOUNDS.big_n


def get_metrics() -> list[str]:
    return list(METRIC_NAMES)


def get_metric_labels() -> list[str]:
    return list(METRIC_LABELS)
