"""The host library (``plumekit/native``): a union-find CCL with region
statistics and the uint16 / uint8 payload codecs, in C++ through
:mod:`ctypes`.

The library builds with ``g++`` at first use (:mod:`.build`). Where it
cannot be built, every entry point keeps working, with the same results:
the CCL entries on scipy and numpy, the codecs on numpy. That fallback is
logged once, at WARNING. Nothing here runs on the card.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import numpy as np

from plumekit_torch.utils import get_logger

logger = get_logger(__name__)
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOAD_LOCK = threading.Lock()


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    with _LOAD_LOCK:
        if _TRIED:
            return _LIB
        try:
            from plumekit_torch.native.build import build

            lib = ctypes.CDLL(build())
            _register(lib)
            _LIB = lib
        except Exception as e:  # noqa: BLE001 - no compiler, a failed build
            logger.warning("the native host library is unavailable (%s: %s); "
                           "the host CCL and codecs take their scipy and "
                           "numpy paths", type(e).__name__, e)
        _TRIED = True
    return _LIB


def _register(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    ptr = ctypes.POINTER
    lib.plumekit_ccl_label.restype = i32
    lib.plumekit_ccl_label.argtypes = [ptr(ctypes.c_uint8), i32, i32, i32,
                                       ptr(i32)]
    lib.plumekit_region_stats.restype = None
    lib.plumekit_region_stats.argtypes = [ptr(i32), i32, i32, i32, ptr(i64),
                                          ptr(i32), ptr(ctypes.c_double)]
    lib.plumekit_component_sizes.restype = None
    lib.plumekit_component_sizes.argtypes = [ptr(i32), i64, i32, ptr(i64)]
    lib.plumekit_quantize_uint16.restype = i32
    lib.plumekit_quantize_uint16.argtypes = [
        ptr(ctypes.c_float), i64, i32, ptr(ctypes.c_uint16),
        ptr(ctypes.c_float), ptr(ctypes.c_float)]
    lib.plumekit_quantize_mask_uint8.restype = None
    lib.plumekit_quantize_mask_uint8.argtypes = [ptr(ctypes.c_float), i64,
                                                 ptr(ctypes.c_uint8)]


def _p(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def available() -> bool:
    """True when the library is built and loaded."""
    return _load() is not None


def ccl_label(mask: np.ndarray, connectivity: int = 2
              ) -> Tuple[np.ndarray, int]:
    """Two-pass union-find CCL: ``(labels, n)``, int32 labels 1..n in
    first-encounter (raster) order, 0 for background. Without the library,
    ``scipy.ndimage.label``, whose labels are the same."""
    mask = np.ascontiguousarray(mask.astype(np.uint8))
    lib = _load()
    if lib is None:
        from scipy import ndimage

        structure = np.ones((3, 3)) if connectivity == 2 else None
        labels, n = ndimage.label(mask, structure=structure)
        return labels.astype(np.int32), int(n)
    h, w = mask.shape
    out = np.empty((h, w), np.int32)
    n = lib.plumekit_ccl_label(_p(mask, ctypes.c_uint8), h, w, connectivity,
                               _p(out, ctypes.c_int32))
    return out, int(n)


def region_stats(labels: np.ndarray, n_labels: int):
    """``(areas int64 (n,), bboxes int32 (n, 4) half-open, centroids
    float64 (n, 2))`` of labels 1..``n_labels``; an absent label has area
    0 and the bbox (H, W, 0, 0)."""
    labels = np.ascontiguousarray(labels.astype(np.int32))
    h, w = labels.shape
    areas = np.zeros(n_labels, np.int64)
    bboxes = np.zeros((n_labels, 4), np.int32)
    centroids = np.zeros((n_labels, 2), np.float64)
    lib = _load()
    if lib is None:
        for i in range(1, n_labels + 1):
            ys, xs = np.nonzero(labels == i)
            if ys.size:
                areas[i - 1] = ys.size
                bboxes[i - 1] = (ys.min(), xs.min(), ys.max() + 1,
                                 xs.max() + 1)
                centroids[i - 1] = (ys.mean(), xs.mean())
            else:
                bboxes[i - 1] = (h, w, 0, 0)
        return areas, bboxes, centroids
    lib.plumekit_region_stats(_p(labels, ctypes.c_int32), h, w, n_labels,
                              _p(areas, ctypes.c_int64),
                              _p(bboxes, ctypes.c_int32),
                              _p(centroids, ctypes.c_double))
    return areas, bboxes, centroids


def component_sizes(labels: np.ndarray, n_labels: int) -> np.ndarray:
    """Pixel counts addressed by label value, (n_labels + 1,) int64; slot 0
    counts the background."""
    labels = np.ascontiguousarray(labels.astype(np.int32))
    lib = _load()
    if lib is None:
        return np.bincount(labels.ravel(), minlength=n_labels + 1
                           )[:n_labels + 1].astype(np.int64)
    sizes = np.zeros(n_labels + 1, np.int64)
    lib.plumekit_component_sizes(_p(labels, ctypes.c_int32), labels.size,
                                 n_labels, _p(sizes, ctypes.c_int64))
    return sizes


def quantize_uint16(channels: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The single-pass affine uint16 encode over the last axis, bit for bit
    :func:`plumekit_torch.ops.quant.quantize_uint16_numpy`:
    ``(q uint16, lo (C,) float32, scale (C,) float32)``; that numpy codec
    where the library is unavailable. Raises the codec's ValueError on
    non-finite input."""
    channels = np.ascontiguousarray(channels, dtype=np.float32)
    lib = _load()
    if lib is None:
        from plumekit_torch.ops.quant import quantize_uint16_numpy

        return quantize_uint16_numpy(channels)
    c = channels.shape[-1]
    q = np.empty(channels.shape, np.uint16)
    lo = np.empty(c, np.float32)
    scale = np.empty(c, np.float32)
    rc = lib.plumekit_quantize_uint16(
        _p(channels, ctypes.c_float), channels.size // c, c,
        _p(q, ctypes.c_uint16), _p(lo, ctypes.c_float),
        _p(scale, ctypes.c_float))
    if rc != 0:
        finite = np.isfinite(channels.reshape(-1, c))
        raise ValueError(
            "quantize_uint16 requires finite input; found NaN/inf "
            f"(channel finite counts: {finite.sum(axis=0)} "
            f"of {finite.shape[0]})")
    return q, lo, scale


def quantize_mask_uint8(mask: np.ndarray) -> np.ndarray:
    """``rint(clip(mask, 0, 1) · 255)`` of the float32 mask as uint8, the
    label-mask codec of the quantized training transfers; numpy computes
    that expression where the library is unavailable."""
    mask = np.ascontiguousarray(mask, dtype=np.float32)
    lib = _load()
    if lib is None:
        return np.rint(np.clip(mask, 0.0, 1.0) * 255.0).astype(np.uint8)
    out = np.empty(mask.shape, np.uint8)
    lib.plumekit_quantize_mask_uint8(_p(mask, ctypes.c_float), mask.size,
                                     _p(out, ctypes.c_uint8))
    return out


__all__ = ["available", "ccl_label", "component_sizes", "quantize_mask_uint8",
           "quantize_uint16", "region_stats"]
