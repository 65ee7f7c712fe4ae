"""Deprecated alias for :mod:`repro_torch.runtime.recovery`.

``runtime/fault.py`` (retry and straggler recovery) sat one keystroke away
from ``runtime/faults.py`` (the SEU injector) and was renamed. Import
``repro_torch.runtime.recovery``, or the package root, which re-exports the
public names. This module warns once, when it is first imported, and
forwards everything.
"""

from __future__ import annotations

import warnings

from repro_torch.runtime.recovery import (  # noqa: F401
    HealthMonitor,
    StragglerDetector,
    retry_step,
)

warnings.warn(
    "repro_torch.runtime.fault was renamed to repro_torch.runtime.recovery "
    "(it kept colliding with repro_torch.runtime.faults, the SEU injector); "
    "this alias will be removed in a future release",
    DeprecationWarning,
    stacklevel=2,
)

__all__ = ["HealthMonitor", "StragglerDetector", "retry_step"]
