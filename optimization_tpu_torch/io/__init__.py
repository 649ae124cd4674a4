"""Data loading (native C++ loader built on first use, Python parser when
no compiler is present)."""

from .g2o import load_g2o, native_available

__all__ = ["load_g2o", "native_available"]
