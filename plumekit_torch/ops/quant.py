"""Affine uint16 and uint8 payload codecs of ``plumekit/ops/quant.py``
for the host-to-card and card-to-host hops.

Model inputs are physical AOD in [0, ~2] and fire density in [0, 1], so
the 1/65535-of-range step of the uint16 code sits far below the bf16
precision of the forward; label masks are {0, 1} and encode exactly in
uint8. Used by the streaming inference (``--quantize``,
``--quantize-output``) and the quantized training transfers
(``quantize_transfer``).

The host encoder of C-contiguous float32 is the native single-pass codec
(:func:`plumekit_torch.native.quantize_uint16`), which equals the JAX
package's numpy path bit for bit and takes it where the library is not
built. The card takes no
uint16 arithmetic in every PyTorch build, so a uint16 payload travels as
its int16 bit pattern (:func:`uint16_bits`) and :func:`dequantize` widens
and masks it on the device.
"""

from __future__ import annotations

import numpy as np
import torch


def quantize_uint16(channels: np.ndarray):
    """Per-channel affine uint16 encoding over the LAST axis, on the host.

    Returns ``(q uint16, lo (C,) float32, scale (C,) float32)`` with
    ``value ≈ lo + q · scale`` (max error scale/2). Non-finite input is
    refused: NaN would poison ``lo``/``scale`` and cast to an arbitrary
    uint16.

    C-contiguous float32 input takes the native codec (two passes, no
    temporaries), as in the JAX package; anything else
    :func:`quantize_uint16_numpy`, which the native codec equals bit for
    bit."""
    if channels.dtype == np.float32 and channels.flags.c_contiguous:
        from plumekit_torch import native

        return native.quantize_uint16(channels)
    return quantize_uint16_numpy(channels)


def quantize_uint16_numpy(channels: np.ndarray):
    """The numpy codec of :func:`quantize_uint16` (the JAX package's)."""
    c = channels.shape[-1]
    flat = channels.reshape(-1, c)
    if not np.isfinite(flat).all():
        raise ValueError(
            "quantize_uint16 requires finite input; found NaN/inf "
            f"(channel finite counts: {np.isfinite(flat).sum(axis=0)} "
            f"of {flat.shape[0]})")
    lo = flat.min(axis=0).astype(np.float32)
    hi = flat.max(axis=0).astype(np.float32)
    scale = np.maximum(hi - lo, 1e-12).astype(np.float32) / 65535.0
    q = np.round((flat - lo) / scale).astype(np.uint16).reshape(
        channels.shape)
    return q, lo, scale


def uint16_bits(q: np.ndarray) -> np.ndarray:
    """A uint16 array as int16 holding the same bits (no copy): the form a
    uint16 payload is uploaded in."""
    return q.view(np.int16)


def dequantize(q: torch.Tensor, lo: torch.Tensor,
               scale: torch.Tensor) -> torch.Tensor:
    """``q · scale + lo`` in float32 on ``q``'s device. ``q`` is uint16, or
    int16 holding uint16 bits (:func:`uint16_bits`); it is widened to int32
    and masked on the device. ``lo``/``scale`` broadcast against ``q``
    (callers add the spatial axes)."""
    if q.dtype == torch.uint16:
        q = q.view(torch.int16)
    if q.dtype == torch.int16:
        q = q.to(torch.int32) & 0xFFFF
    return q.to(torch.float32) * scale + lo


def quantize_probs_uint8(probs: torch.Tensor) -> torch.Tensor:
    """p8 = round(p · 255), half to even as ``jnp.round``: the uint8
    probability code of the card-to-host hop (max decode error 1/510)."""
    return torch.round(probs * 255.0).to(torch.uint8)


def dequantize_probs_uint8(q: np.ndarray) -> np.ndarray:
    """Host decode of :func:`quantize_probs_uint8` payloads."""
    return q.astype(np.float32) * np.float32(1.0 / 255.0)


__all__ = ["dequantize", "dequantize_probs_uint8", "quantize_probs_uint8",
           "quantize_uint16", "quantize_uint16_numpy", "uint16_bits"]
