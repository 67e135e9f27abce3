"""Multi-threshold connected components with the mask opening built
in-kernel: K1 and K4.

Replaces the Pallas TPU kernels ``multi_threshold_ccl_fused``
(``plumekit/ops/pallas/ccl_sweep.py:544``) and
``multi_threshold_ccl_banded`` (``plumekit/ops/pallas/ccl_banded.py:321``).
Both compute, for an (H, W) float32 AOD plane and T thresholds, the
(T, H, W) int32 labels of ``binary_opening_cross(aod > thresholds[t])``
under the contract of :mod:`plumekit_torch.ops.ccl`. On the TPU the two
differ only in where the label plane lives (VMEM up to ~5000², HBM
beyond); on the card it lives in device memory at every size, so one CUDA
kernel, ``plumekit_torch/csrc/ccl_sweep.cu`` (block-based union-find, all T
levels in one launch), serves both names.

:func:`multi_threshold_ccl_fused` runs the plain version for a tensor on
the CPU and the CUDA kernel for a tensor on the card; it never falls back
from the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from plumekit_torch.ops.ccl import connected_components
from plumekit_torch.ops.morphology import binary_opening_cross

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0


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


def _library():
    from plumekit_torch.cuda_build import load_library

    lib = load_library("ccl_sweep.cu")
    fn = lib.pk_ccl_sweep
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
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
    LAUNCHES += 1
    return out


def multi_threshold_ccl_banded(aod: torch.Tensor, thresholds: torch.Tensor,
                               connectivity: int = 2) -> torch.Tensor:
    """K4 under its JAX name: the TPU's banded HBM variant exists for
    scenes beyond the VMEM gate; on the card K1's kernel already keeps its
    labels in device memory, so this is the same launch."""
    return multi_threshold_ccl_fused(aod, thresholds, connectivity)
