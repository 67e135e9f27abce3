"""Plain reference of int8 serving of the U-Net and UNet++, written from
their description and not from the program: plain PyTorch, no kernel, no
import of the program.

Post-training quantization of weights and activations, as the repository
documents its int8 serving:

* activations: per-tensor symmetric scales ``amax / qmax``, the amax of each
  quantization point read from a replay of the BatchNorm-folded forward in
  fp32 (TF32 off) over calibration tiles; rounding half to even, clamped
  to ``±qmax``;
* weights: per output channel, symmetric, each input channel's activation
  scale folded into the weight first (so the halves of a concat keep their
  own scales);
* a 3×3 conv sums exact integer products and ends in ``relu(acc·a + b)``
  (``a`` the weight scale times BatchNorm's scale, ``b`` its shift), then
  requantizes; max-pool runs on the integers; the 2×2 stride-2 transposed
  conv is ``acc·sw + bias`` and a requant; the 1×1 head is fp32, and under
  deep supervision the mean of the side heads.

``qmax`` is 127 for int8; the control of the benchmark's check runs the
same with 7 (int4). Whole granules are served by overlap-blended sliding
windows: the granule edge-padded onto the stride lattice, every tile's
probabilities weighted by a separable linear taper over the overlap,
summed, divided by the summed weights and cropped.

Tensors are NHWC; the weights are the harness's PyTorch-layout tensors
(:mod:`benchmark.harness.weights`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.harness.granules import calibration_tiles
from benchmark.yardstick.flops import decoder_nodes

BN_EPS = 1e-5


@contextmanager
def exact_fp32():
    """fp32 convolutions and products without TF32, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# --------------------------------------------------------------- the graph


def graph(cfg):
    """The network as a list of steps over named planes, the same for the
    fp32 replay and the integer forward. Each step is a tuple:
    ``("in",)``; ``("block", key, out, [sources], head_only)``;
    ``("pool", out, src)``; ``("up", key, out, src)``; and the heads
    ``("heads", [(head key, plane)])``. ``key`` is the module name prefix
    of the weights."""
    depth = cfg.depth
    steps: list = [("in",)]
    if cfg.arch == "unet":
        src = "in"
        for i in range(depth):
            steps.append(("block", f"blocks.{i}", f"e{i}", [src], False))
            steps.append(("pool", f"p{i}", f"e{i}"))
            src = f"p{i}"
        steps.append(("block", f"blocks.{depth}", f"e{depth}", [src], False))
        src = f"e{depth}"
        for u, i in enumerate(reversed(range(depth))):
            steps.append(("up", f"ups.{u}", f"u{u}", src))
            last = i == 0
            steps.append(("block", f"blocks.{depth + 1 + u}", f"d{u}",
                          [f"e{i}", f"u{u}"], last))
            src = f"d{u}"
        steps.append(("heads", [("head", src)]))
        return steps
    if cfg.arch != "unetpp":
        raise ValueError(f"unknown arch {cfg.arch!r}")
    src = "in"
    for i in range(depth + 1):
        if i:
            steps.append(("pool", f"p{i}", f"x{i - 1}_0"))
            src = f"p{i}"
        steps.append(("block", f"nodes.x_{i}_0", f"x{i}_0", [src], False))
    for i, j in decoder_nodes(depth):
        steps.append(("up", f"ups.up_{i}_{j}", f"up{i}_{j}",
                      f"x{i + 1}_{j - 1}"))
        head_only = (i, j) == (0, depth)
        steps.append(("block", f"nodes.x_{i}_{j}", f"x{i}_{j}",
                      [f"x{i}_{k}" for k in range(j)] + [f"up{i}_{j}"],
                      head_only))
    if cfg.deep_supervision:
        heads = [(f"heads.head_{j}", f"x0_{j}") for j in range(1, depth + 1)]
    else:
        heads = [("heads.head", f"x0_{depth}")]
    steps.append(("heads", heads))
    return steps


def _fold(w: Dict[str, torch.Tensor], key: str, k: int):
    """HWIO fp32 kernel, BatchNorm scale and shift of conv ``k`` of the
    block ``key``."""
    norm = f"{key}.norm.{k}"
    scale = w[f"{norm}.weight"] / torch.sqrt(w[f"{norm}.running_var"]
                                             + BN_EPS)
    shift = w[f"{norm}.bias"] - w[f"{norm}.running_mean"] * scale
    kernel = w[f"{key}.conv.{k}.weight"].permute(2, 3, 1, 0).float()
    return kernel, scale, shift


def _conv_fp32(x, k, a, b):
    y = F.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    return torch.relu(y.permute(0, 2, 3, 1) * a + b)


def _pool(x):
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def _up_fp32(x, k, bias):
    """The 2×2 stride-2 transposed conv of NHWC ``x`` by a PyTorch-layout
    kernel ``(cin, cout, 2, 2)``: one product and the pixel shuffle."""
    n, h, w, cin = x.shape
    cout = k.shape[1]
    y = (x.reshape(-1, cin) @ k.float().permute(0, 2, 3, 1).reshape(
        cin, 4 * cout)).reshape(n, h, w, 2, 2, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout) + bias


def _amax(x):
    return torch.clamp(x.abs().max(), min=1e-8).float()


@torch.no_grad()
def calibrate(w, cfg, tiles: torch.Tensor) -> Dict[str, torch.Tensor]:
    """amax of every quantization point from the fp32 replay of the
    BatchNorm-folded forward over ``tiles`` (N, t, t, C): ``in``, each
    block's ``<out>:mid`` and ``<out>`` (not of a head-only block), each
    upsample's output."""
    amax: Dict[str, torch.Tensor] = {}
    planes: Dict[str, torch.Tensor] = {}
    with exact_fp32():
        for step in graph(cfg):
            if step[0] == "in":
                planes["in"] = tiles.float()
                amax["in"] = _amax(planes["in"])
            elif step[0] == "pool":
                planes[step[1]] = _pool(planes[step[2]])
            elif step[0] == "up":
                _, key, out, src = step
                planes[out] = _up_fp32(planes[src], w[f"{key}.weight"],
                                       w[f"{key}.bias"])
                amax[out] = _amax(planes[out])
            elif step[0] == "block":
                _, key, out, srcs, head_only = step
                x = torch.cat([planes[s] for s in srcs], dim=-1)
                x = _conv_fp32(x, *_fold(w, key, 0))
                amax[f"{out}:mid"] = _amax(x)
                x = _conv_fp32(x, *_fold(w, key, 1))
                if not head_only:
                    amax[out] = _amax(x)
                planes[out] = x
    return amax


# ------------------------------------------------------- integer arithmetic


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _mm_int(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 ``a @ b`` of int8 matrices. On the card cuBLASLt takes
    more than 16 rows, depths and widths in multiples of 8 and ``b`` in
    column-major order: the operands are padded with zeros and cut back."""
    m, k = a.shape
    n = b.shape[1]
    if a.device.type != "cuda":
        return torch._int_mm(a.contiguous(), b.contiguous())
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    a = F.pad(a, (0, kp - k, 0, mp - m))
    b = F.pad(b, (0, np_ - n, 0, kp - k))
    return torch._int_mm(a.contiguous(), b.t().contiguous().t())[:m, :n]


def _conv_acc(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int32 sums of the SAME 3×3 conv of int8 NHWC ``xq`` with HWIO
    ``wq``: nine shifted products."""
    n, h, w, cin = xq.shape
    xp = F.pad(xq, (0, 0, 1, 1, 1, 1))
    acc = None
    for dy in range(3):
        for dx in range(3):
            tap = _mm_int(xp[:, dy:dy + h, dx:dx + w].reshape(-1, cin),
                          wq[dy, dx])
            acc = tap if acc is None else acc.add_(tap)
    return acc.reshape(n, h, w, -1)


def _quant(x, scale, qmax: int):
    return torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)


def _quant_weight(k, in_scales, qmax: int, reduce_dims):
    """Per-output-channel symmetric weights of ``k`` (output channel last)
    with the input scales folded in: (integers, their scales)."""
    kp = k.float() * in_scales
    sw = torch.clamp(kp.abs().amax(dim=reduce_dims), min=1e-12) \
        / torch.tensor(float(qmax), dtype=torch.float32, device=k.device)
    return torch.clamp(torch.round(kp / sw), -qmax, qmax).to(torch.int8), sw


def quantize(w, cfg, amax, qmax: int = 127) -> dict:
    """The integer model: activation scales and, per block and upsample,
    integer weights with their epilogue multipliers and shifts."""
    qm = torch.tensor(float(qmax), dtype=torch.float32)
    scales = {name: v / qm.to(v.device) for name, v in amax.items()}
    chans: Dict[str, int] = {"in": cfg.in_channels}
    model = {"scales": scales, "blocks": {}, "ups": {}}

    def per_channel(names):
        return torch.cat([scales[s] * torch.ones(chans[s], device=scales[s]
                                                 .device) for s in names])

    for step in graph(cfg):
        if step[0] == "pool":
            chans[step[1]] = chans[step[2]]
            scales[step[1]] = scales[step[2]]
        elif step[0] == "up":
            _, key, out, src = step
            k = w[f"{key}.weight"].float().permute(2, 3, 0, 1)  # (2,2,ci,co)
            kq, sw = _quant_weight(k, per_channel([src])[:, None], qmax,
                                   (0, 1, 2))
            chans[out] = k.shape[-1]
            model["ups"][key] = {"kq": kq, "sw": sw,
                                 "bias": w[f"{key}.bias"].float()}
        elif step[0] == "block":
            _, key, out, srcs, head_only = step
            k1, a1, b1 = _fold(w, key, 0)
            k2, a2, b2 = _fold(w, key, 1)
            wq1, sw1 = _quant_weight(k1, per_channel(srcs)[:, None], qmax,
                                     (0, 1, 2))
            chans[f"{out}:mid"] = k1.shape[-1]
            wq2, sw2 = _quant_weight(k2, per_channel([f"{out}:mid"])[:, None],
                                     qmax, (0, 1, 2))
            chans[out] = k2.shape[-1]
            model["blocks"][key] = {"wq1": wq1, "a1": sw1 * a1, "b1": b1,
                                    "wq2": wq2, "a2": sw2 * a2, "b2": b2}
    model["heads"] = {}
    for key, _ in graph(cfg)[-1][1]:
        model["heads"][key] = (w[f"{key}.weight"][:, :, 0, 0].t().float(),
                               w[f"{key}.bias"].float())
    return model


@torch.no_grad()
def forward_logits(model, cfg, x: torch.Tensor, qmax: int = 127,
                   trace: Optional[list] = None):
    """Logits (N, t, t) of the integer forward of ``x`` (N, t, t, C). With
    a list ``trace``, every integer plane is appended to it in order."""
    s = model["scales"]
    steps = graph(cfg)
    head_planes = {plane for _, plane in steps[-1][1]}
    planes: Dict[str, torch.Tensor] = {}
    fp: Dict[str, torch.Tensor] = {}
    for step in steps:
        if step[0] == "in":
            planes["in"] = _quant(x.float(), s["in"], qmax)
            new = ["in"]
        elif step[0] == "pool":
            planes[step[1]] = _pool(planes[step[2]])
            new = [step[1]]
        elif step[0] == "up":
            _, key, out, src = step
            up = model["ups"][key]
            xq = planes[src]
            n, h, wd, cin = xq.shape
            cout = up["kq"].shape[-1]
            cols = up["kq"].permute(2, 0, 1, 3).reshape(cin, 4 * cout)
            acc = _mm_int(xq.reshape(-1, cin), cols).reshape(n, h, wd, 2, 2,
                                                             cout)
            y = acc.float() * up["sw"] + up["bias"]
            y = y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * wd, cout)
            planes[out] = _quant(y, s[out], qmax)
            new = [out]
        elif step[0] == "block":
            _, key, out, srcs, head_only = step
            blk = model["blocks"][key]
            xq = torch.cat([planes[t] for t in srcs], dim=-1)
            y = torch.relu(_conv_acc(xq, blk["wq1"]).float() * blk["a1"]
                           + blk["b1"])
            mq = _quant(y, s[f"{out}:mid"], qmax)
            new = [f"{out}:mid"]
            planes[f"{out}:mid"] = mq
            del y
            y = torch.relu(_conv_acc(mq, blk["wq2"]).float() * blk["a2"]
                           + blk["b2"])
            if out in head_planes:
                fp[out] = y       # a head reads the fp32 plane
            if not head_only:
                planes[out] = _quant(y, s[out], qmax)
                new.append(out)
        else:
            outs = []
            for key, plane in step[1]:
                k, b = model["heads"][key]
                outs.append((fp[plane] @ k + b)[..., 0])
            return sum(outs) / len(outs) if len(outs) > 1 else outs[0]
        if trace is not None:
            trace += [planes[name] for name in new]
    raise AssertionError("graph without heads")


# ------------------------------------------------------------ the granule


def taper(tile: int, overlap: int) -> torch.Tensor:
    """Linear ramps (1..overlap)/(overlap+1) at both ends, 1 in the core."""
    wt = torch.ones(tile, dtype=torch.float32)
    if overlap > 0:
        ramp = torch.arange(1, overlap + 1, dtype=torch.float32) \
            / (overlap + 1)
        wt[:overlap] = torch.minimum(wt[:overlap], ramp)
        wt[-overlap:] = torch.minimum(wt[-overlap:], ramp.flip(0))
    return wt


@torch.no_grad()
def granule_probs(model, cfg, channels: torch.Tensor, tile: int,
                  overlap: int, qmax: int = 127, chunk: int = 32):
    """Blended probabilities (H, W) of one granule (H, W, C) on its
    device, tiles in chunks of ``chunk``."""
    h, w = channels.shape[:2]
    stride = tile - overlap
    if overlap > stride or h < tile or w < tile:
        raise ValueError("the reference serves granules of at least one "
                         "tile with overlap <= stride")
    h2 = tile + -(-(h - tile) // stride) * stride
    w2 = tile + -(-(w - tile) // stride) * stride
    dev = channels.device
    rows = torch.arange(h2, device=dev).clamp(max=h - 1)
    cols = torch.arange(w2, device=dev).clamp(max=w - 1)
    img = channels[rows][:, cols]
    origins = [(y, x) for y in range(0, h2 - tile + 1, stride)
               for x in range(0, w2 - tile + 1, stride)]
    t1 = taper(tile, overlap).to(dev)
    w2d = t1[:, None] * t1[None, :]
    canvas = torch.zeros((h2, w2), dtype=torch.float32, device=dev)
    weight = torch.zeros((h2, w2), dtype=torch.float32, device=dev)
    for at in range(0, len(origins), chunk):
        batch = origins[at:at + chunk]
        x = torch.stack([img[y:y + tile, x_:x_ + tile] for y, x_ in batch])
        p = torch.sigmoid(forward_logits(model, cfg, x, qmax).float())
        for k, (y, x_) in enumerate(batch):
            canvas[y:y + tile, x_:x_ + tile] += p[k] * w2d
            weight[y:y + tile, x_:x_ + tile] += w2d
    return (canvas / weight)[:h, :w]


def build(w, cfg, calib_channels: np.ndarray, tile: int, qmax: int,
          device) -> dict:
    """Calibrate on the granule ``calib_channels`` and quantize at
    ``qmax``: the integer model the reference serves."""
    tiles = torch.from_numpy(calibration_tiles(calib_channels, tile,
                                               cfg.depth)).to(device)
    return quantize(w, cfg, calibrate(w, cfg, tiles), qmax)


__all__: List[str] = ["build", "calibrate", "forward_logits", "granule_probs",
                      "graph", "quantize", "taper"]
