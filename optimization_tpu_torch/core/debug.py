"""Sanitizer-tier support, as in ``optimization_tpu/core/debug.py``.

Result traces are fixed-length and NaN-padded beyond ``num_iterations``
by contract.  Under the ``OPTTPU_DEBUG_NANS`` tier the padding is zero
instead.  The port reads the same environment variable the same way
(any non-empty value, ``"0"`` included, turns the tier on), so the two
packages always pad alike in one process.
"""

from __future__ import annotations

import os

__all__ = ["DEBUG_NANS", "pad_value"]

DEBUG_NANS = bool(os.environ.get("OPTTPU_DEBUG_NANS"))


def pad_value() -> float:
    """Fill value for contractually-unread trace padding: NaN, or 0.0
    under the OPTTPU_DEBUG_NANS sanitizer tier."""
    return 0.0 if DEBUG_NANS else float("nan")
