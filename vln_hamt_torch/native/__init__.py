"""The native navsim library (C++, ctypes), the port of
``vln_hamt_tpu/native``."""

from .navsim import (NativeNavGraph, NativeSimBatch, build_library, load_library,
                     native_available, sample_panorama)

__all__ = [
    "NativeNavGraph",
    "NativeSimBatch",
    "build_library",
    "load_library",
    "native_available",
    "sample_panorama",
]
