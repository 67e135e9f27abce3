"""Carry U-Net and UNet++ weights between the JAX package's flax variables
and the port's ``state_dict``.

Flax keeps conv kernels HWIO, the port OIHW. Flax's ``ConvTranspose``
applies its kernel flipped relative to the output patch
(``out[2i+di, 2j+dj] = x[i, j] @ k[1-di, 1-dj]``, see
``plumekit/models/fused_forward.py:58-71``), while torch's
``ConvTranspose2d`` does not, so the spatial axes are flipped on the way.
BatchNorm ``scale/bias/mean/var`` become ``weight/bias/running_mean/
running_var``. Both directions use plain numpy arrays on the flax side: a
nested dict ``{"params": ..., "batch_stats": ...}``. :func:`qvars_from_flax`
carries the int8 serving variables over, which both packages keep in the
JAX layout.
"""

from __future__ import annotations

import numpy as np
import torch

_NORM_LEAVES = {"BatchNorm_0": {"scale": "weight", "bias": "bias"},
                "GroupNorm_0": {"scale": "weight", "bias": "bias"}}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _tensor(a):
    """A float32 tensor owning a copy of ``a``."""
    return torch.from_numpy(np.array(a, np.float32))


def _conv_in(k):
    return _tensor(np.asarray(k, np.float32).transpose(3, 2, 0, 1))


def _conv_out(w):
    return w.detach().cpu().numpy().transpose(2, 3, 1, 0).copy()


def _port_prefix(name: str, unetpp: bool) -> str:
    """The port's module prefix of a flax parameter group: the U-Net's
    ``DoubleConv_k``, ``ConvTranspose_k`` and ``head`` are ``blocks.k``,
    ``ups.k`` and ``head``; the UNet++'s ``x_i_j``, ``up_i_j`` and
    ``head[_j]`` keep their names under ``nodes``, ``ups`` and ``heads``."""
    kind, _, rest = name.rpartition("_")
    if kind == "DoubleConv":
        return f"blocks.{rest}"
    if kind == "ConvTranspose":
        return f"ups.{rest}"
    if unetpp and name.startswith("x_"):
        return f"nodes.{name}"
    if unetpp and name.startswith("up_"):
        return f"ups.{name}"
    if name == "head" or (unetpp and name.startswith("head_")):
        return f"heads.{name}" if unetpp else name
    raise ValueError(f"unexpected flax parameter group {name!r}")


def _flax_name(parts) -> str:
    """Inverse of :func:`_port_prefix` on a state_dict key's parts."""
    group, sub = parts[0], parts[1]
    if group in ("nodes", "heads") or (group == "ups" and not sub.isdigit()):
        return sub
    return {"blocks": f"DoubleConv_{sub}", "ups": f"ConvTranspose_{sub}",
            "head": "head"}[group]


def from_flax(variables) -> dict:
    """flax ``UNet`` or ``UNetPP`` variables (nested dict of arrays) → port
    state_dict."""
    sd = {}
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    unetpp = any(name.startswith("x_") for name in params)
    for name, sub in params.items():
        pre = _port_prefix(name, unetpp)
        if "Conv_0" in sub:                       # a double conv
            for j in (0, 1):
                conv = sub[f"Conv_{j}"]
                sd[f"{pre}.conv.{j}.weight"] = _conv_in(conv["kernel"])
                if "bias" in conv:
                    sd[f"{pre}.conv.{j}.bias"] = _tensor(conv["bias"])
                for norm, leaves in sub.get(f"_Norm_{j}", {}).items():
                    for src, dst in _NORM_LEAVES[norm].items():
                        sd[f"{pre}.norm.{j}.{dst}"] = _tensor(leaves[src])
                bn = stats.get(name, {}).get(f"_Norm_{j}", {}).get(
                    "BatchNorm_0")
                if bn is not None:
                    for src, dst in _STAT_LEAVES.items():
                        sd[f"{pre}.norm.{j}.{dst}"] = _tensor(bn[src])
                    sd[f"{pre}.norm.{j}.num_batches_tracked"] = torch.tensor(0)
        elif pre.startswith("ups."):
            k = np.asarray(sub["kernel"], np.float32)[::-1, ::-1]
            sd[f"{pre}.weight"] = _tensor(k.transpose(2, 3, 0, 1))
            sd[f"{pre}.bias"] = _tensor(sub["bias"])
        else:                                     # a 1x1 head
            sd[f"{pre}.weight"] = _conv_in(sub["kernel"])
            sd[f"{pre}.bias"] = _tensor(sub["bias"])
    return sd


def to_flax(state_dict: dict, norm: str = "batch") -> dict:
    """Inverse of :func:`from_flax`: port state_dict → flax variables."""
    params: dict = {}
    stats: dict = {}
    norm_name = {"batch": "BatchNorm_0", "group": "GroupNorm_0"}.get(norm)
    for key, value in state_dict.items():
        parts = key.split(".")
        name = _flax_name(parts)
        v = value.detach().cpu().numpy()
        if parts[0] in ("blocks", "nodes"):
            block = params.setdefault(name, {})
            j, leaf = parts[3], parts[4]
            if parts[2] == "conv":
                conv = block.setdefault(f"Conv_{j}", {})
                conv["kernel" if leaf == "weight" else "bias"] = (
                    _conv_out(value) if leaf == "weight" else v.copy())
            elif leaf in ("weight", "bias"):
                block.setdefault(f"_Norm_{j}", {}).setdefault(
                    norm_name, {})["scale" if leaf == "weight" else "bias"] = \
                    v.copy()
            elif leaf in ("running_mean", "running_var"):
                stats.setdefault(name, {}).setdefault(
                    f"_Norm_{j}", {}).setdefault("BatchNorm_0", {})[
                    "mean" if leaf == "running_mean" else "var"] = v.copy()
        elif parts[0] == "ups":
            ct = params.setdefault(name, {})
            if parts[2] == "weight":
                ct["kernel"] = v.transpose(2, 3, 0, 1)[::-1, ::-1].copy()
            else:
                ct["bias"] = v.copy()
        else:                                     # a 1x1 head
            params.setdefault(name, {})[
                "kernel" if parts[-1] == "weight" else "bias"] = (
                _conv_out(value) if parts[-1] == "weight" else v.copy())
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    return variables


def qvars_from_flax(qvars, device="cpu") -> dict:
    """The JAX package's int8 serving variables (``quantize_unet`` of
    ``plumekit/models/quantized_forward.py``, U-Net or UNet++, as numpy
    arrays) → the port's (:func:`plumekit_torch.models.quantized_forward.
    quantize_unet`): the same structure and values, int8 weights and fp32
    vectors as tensors, scales as 0-d float32 tensors, ``None`` kept, all on
    ``device``."""
    def carry(t):
        if isinstance(t, dict):
            return {k: carry(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [carry(v) for v in t]
        if t is None:
            return None
        a = np.asarray(t)
        dtype = np.int8 if a.dtype == np.int8 else np.float32
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return carry(qvars)
