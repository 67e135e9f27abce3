"""Multi-threshold connected components: K1 and K4 (the mask opening built
in-kernel) and K2 (a stack of ready-made masks).

Replaces the Pallas TPU kernels ``multi_threshold_ccl_fused``
(``plumekit/ops/pallas/ccl_sweep.py:544``) and
``multi_threshold_ccl_banded`` (``plumekit/ops/pallas/ccl_banded.py:321``).
Both compute, for an (H, W) float32 AOD plane and T thresholds, the
(T, H, W) int32 labels of ``binary_opening_cross(aod > thresholds[t])``
under the contract of :mod:`plumekit_torch.ops.ccl`. On the TPU the two
differ only in where the label plane lives (VMEM up to ~5000², HBM
beyond); on the card it lives in device memory at every size, so one CUDA
kernel, ``plumekit_torch/csrc/ccl_sweep.cu`` (union-find over runs of
bit-packed 64 × 64 tiles, all T levels in one call of three passes), serves
both names.

K2 replaces ``multi_threshold_ccl`` (``plumekit/ops/pallas/ccl_sweep.py:468``):
(T, H, W) bool masks in, (T, H, W) int32 labels out, each level
``connected_components(masks[t])`` bit for bit. The same source holds its
kernel: K1's three passes, with each tile's foreground read from the mask
plane in place of the thresholded, opened AOD. The basic detector and the
gaussian detector's fire clustering label one mask each through it.

:func:`multi_threshold_ccl_fused` and :func:`multi_threshold_ccl` run the
plain version for a tensor on the CPU and the CUDA kernel for a tensor on
the card; they never fall back from the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from plumekit_torch.cuda_build import LAUNCH_LOCK
from plumekit_torch.ops.ccl import connected_components
from plumekit_torch.ops.morphology import binary_opening_cross

#: launches of the K1/K4 kernel since import (or since a caller reset it)
LAUNCHES = 0
#: launches of the K2 kernel (the mask-stack front end), likewise
MASK_LAUNCHES = 0


def multi_threshold_ccl_ref(aod: torch.Tensor, thresholds: torch.Tensor,
                            connectivity: int = 2) -> torch.Tensor:
    """Plain version: per level, the PyTorch opening then
    :func:`connected_components`."""
    out = torch.empty((thresholds.shape[0],) + tuple(aod.shape),
                      dtype=torch.int32, device=aod.device)
    for t in range(thresholds.shape[0]):
        opened = binary_opening_cross(aod > thresholds[t])
        out[t] = connected_components(opened, connectivity)
    return out


def multi_threshold_ccl_masks_ref(opened: torch.Tensor,
                                  connectivity: int = 2) -> torch.Tensor:
    """Plain version of K2: :func:`connected_components` per level."""
    out = torch.empty(tuple(opened.shape), dtype=torch.int32,
                      device=opened.device)
    for t in range(opened.shape[0]):
        out[t] = connected_components(opened[t], connectivity)
    return out


def _library():
    from plumekit_torch.cuda_build import load_library

    lib = load_library("ccl_sweep.cu")
    fn = lib.pk_ccl_sweep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pk_ccl_masks.argtypes = [ctypes.c_void_p] * 2 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.pk_ccl_masks.restype = ctypes.c_int
        lib.pk_ccl_error_string.argtypes = [ctypes.c_int]
        lib.pk_ccl_error_string.restype = ctypes.c_char_p
    return lib


def multi_threshold_ccl_fused(aod: torch.Tensor, thresholds: torch.Tensor,
                              connectivity: int = 2) -> torch.Tensor:
    """(T, H, W) int32 labels of ``binary_opening_cross(aod > th[t])``.

    aod: (H, W) float32; thresholds: (T,) float32 on the same device. The
    levels are labelled independently, so the thresholds need not be
    sorted here (the sweep validates its own order).
    """
    if aod.device.type == "cpu":
        return multi_threshold_ccl_ref(aod, thresholds, connectivity)
    if aod.device.type != "cuda":
        raise ValueError(f"no kernel for device {aod.device}")
    if aod.dtype != torch.float32 or aod.dim() != 2 \
            or not aod.is_contiguous():
        raise ValueError("the kernel takes a contiguous (H, W) float32 AOD "
                         f"plane, got {tuple(aod.shape)} {aod.dtype}")
    if thresholds.dtype != torch.float32 or thresholds.dim() != 1 \
            or not thresholds.is_contiguous() \
            or thresholds.device != aod.device:
        raise ValueError("thresholds must be a contiguous (T,) float32 "
                         "tensor on the AOD's device")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    h, w = aod.shape
    t_count = thresholds.shape[0]
    if h * w >= 2**31 - 1 or not 1 <= t_count <= 65535:
        raise ValueError(f"scene {h}x{w} with {t_count} levels is beyond "
                         "the kernel's int32 ids and grid")
    out = torch.empty((t_count, h, w), dtype=torch.int32, device=aod.device)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(aod.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_ccl_sweep(aod.data_ptr(), thresholds.data_ptr(),
                               out.data_ptr(), t_count, h, w, connectivity,
                               stream)
    if err != 0:
        raise RuntimeError("CCL sweep kernel launch failed: "
                           + lib.pk_ccl_error_string(err).decode())
    with LAUNCH_LOCK:
        LAUNCHES += 1
    return out


def multi_threshold_ccl(opened: torch.Tensor, connectivity: int = 2,
                        nested: bool = True) -> torch.Tensor:
    """(T, H, W) int32 labels of the (T, H, W) bool masks ``opened``, each
    level labelled on its own.

    ``nested`` is the JAX entry's promise that every mask contains the one
    before it, which lets the TPU kernel start a level from the previous
    level's labels. The levels are independent here, so the argument
    changes nothing and is kept only so that calls read as the JAX
    package's do.
    """
    del nested
    if opened.dim() != 3 or opened.dtype != torch.bool:
        raise ValueError("want (T, H, W) bool masks, got "
                         f"{tuple(opened.shape)} {opened.dtype}")
    if connectivity not in (1, 2):
        raise ValueError(f"connectivity must be 1 or 2, got {connectivity}")
    if opened.device.type == "cpu":
        return multi_threshold_ccl_masks_ref(opened, connectivity)
    if opened.device.type != "cuda":
        raise ValueError(f"no kernel for device {opened.device}")
    if not opened.is_contiguous():
        raise ValueError("the kernel takes a contiguous (T, H, W) mask stack")
    t_count, h, w = opened.shape
    if h * w >= 2**31 - 1 or not 1 <= t_count <= 65535 or h < 1 or w < 1:
        raise ValueError(f"stack {t_count}x{h}x{w} is beyond the kernel's "
                         "int32 ids and grid")
    out = torch.empty((t_count, h, w), dtype=torch.int32,
                      device=opened.device)
    lib = _library()
    global MASK_LAUNCHES
    with torch.cuda.device(opened.device):
        stream = torch.cuda.current_stream().cuda_stream
        # a bool tensor stores one byte per element, 0 or 1
        err = lib.pk_ccl_masks(opened.data_ptr(), out.data_ptr(), t_count,
                               h, w, connectivity, stream)
    if err != 0:
        raise RuntimeError("CCL mask-stack kernel launch failed: "
                           + lib.pk_ccl_error_string(err).decode())
    with LAUNCH_LOCK:
        MASK_LAUNCHES += 1
    return out


def multi_threshold_ccl_banded(aod: torch.Tensor, thresholds: torch.Tensor,
                               connectivity: int = 2) -> torch.Tensor:
    """K4 under its JAX name: the TPU's banded HBM variant exists for
    scenes beyond the VMEM gate; on the card K1's kernel already keeps its
    labels in device memory, so this is the same launch."""
    return multi_threshold_ccl_fused(aod, thresholds, connectivity)
