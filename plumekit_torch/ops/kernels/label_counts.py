"""Per-(threshold, fire) component sizes: K3.

Replaces the Pallas TPU kernel ``fire_label_counts``
(``plumekit/ops/pallas/label_counts.py:83``): ``counts[t, f] =
sum(labels[t] == labs[t, f])`` for a (T, H, W) int32 label stack and a
(T, F ≤ 128) int32 table, exact for duplicate labs and for 0. The CUDA
kernel is ``plumekit_torch/csrc/label_counts.cu`` (the distinct labs in a
shared-memory hash table, one probe per pixel, warp-aggregated counts, one
global atomic per block and lab).

:func:`fire_label_counts` runs the plain version for a tensor on the CPU
and the CUDA kernel for a tensor on the card; it never falls back from
the kernel.
"""

from __future__ import annotations

import ctypes

import torch

#: launches of the CUDA kernel since import (or since a caller reset it)
LAUNCHES = 0

#: the kernel's lab capacity (a table of 256 slots at most half full)
MAX_LABS = 128


def fire_label_counts_ref(labels: torch.Tensor, labs: torch.Tensor
                          ) -> torch.Tensor:
    """Plain version, one level at a time so that nothing (T, F, H, W) is
    ever built."""
    out = torch.empty(tuple(labs.shape), dtype=torch.int32,
                      device=labels.device)
    for t in range(labels.shape[0]):
        out[t] = (labels[t][None] == labs[t][:, None, None]).sum((1, 2))
    return out


def _library():
    from plumekit_torch.cuda_build import load_library

    lib = load_library("label_counts.cu")
    fn = lib.pk_label_counts
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pk_label_counts_error_string.argtypes = [ctypes.c_int]
        lib.pk_label_counts_error_string.restype = ctypes.c_char_p
    return lib


def fire_label_counts(labels: torch.Tensor, labs: torch.Tensor
                      ) -> torch.Tensor:
    """(T, F) int32 counts of each ``labs[t, f]`` in ``labels[t]``."""
    if labels.device.type == "cpu":
        return fire_label_counts_ref(labels, labs)
    if labels.device.type != "cuda":
        raise ValueError(f"no kernel for device {labels.device}")
    if labels.dtype != torch.int32 or labels.dim() != 3 \
            or not labels.is_contiguous():
        raise ValueError("the kernel takes a contiguous (T, H, W) int32 "
                         f"label stack, got {tuple(labels.shape)} "
                         f"{labels.dtype}")
    t_count, h, w = labels.shape
    if labs.dtype != torch.int32 or labs.dim() != 2 \
            or labs.shape[0] != t_count or not labs.is_contiguous() \
            or labs.device != labels.device:
        raise ValueError(f"labs must be a contiguous ({t_count}, F) int32 "
                         "tensor on the labels' device, got "
                         f"{tuple(labs.shape)} {labs.dtype}")
    f_count = labs.shape[1]
    if not 1 <= f_count <= MAX_LABS or not 1 <= t_count <= 65535 \
            or h * w == 0:
        raise ValueError(f"F = {f_count} outside the kernel's capacity "
                         f"1..{MAX_LABS}, or T = {t_count}, or an empty "
                         "plane")
    out = torch.zeros((t_count, f_count), dtype=torch.int32,
                      device=labels.device)
    lib = _library()
    global LAUNCHES
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pk_label_counts(labels.data_ptr(), labs.data_ptr(),
                                  out.data_ptr(), t_count, h * w, f_count,
                                  stream)
    if err != 0:
        raise RuntimeError("label-count kernel launch failed: "
                           + lib.pk_label_counts_error_string(err).decode())
    LAUNCHES += 1
    return out
