"""Plain reference of the U-Net's training steps, written from the
repository's description of them and not from the program: plain PyTorch,
no import of the program.

One step: a random element of the dihedral group D4 per sample (code bit
0 flips the rows, bit 1 the columns, bit 2 transposes, in that order; the
codes are ``randint(0, 8, (B,))`` of a generator on the device seeded from
``SeedSequence([seed, step])``), the train-mode forward (convolutions in
the configuration's compute precision on fp32 master weights, batch norm
in fp32 over the batch with the biased variance, ReLU, 2×2 max-pool, 2×2
stride-2 transposed convs, the fp32 1×1 head), the loss ``w·dice + (1 −
w)·BCE`` (soft dice pooled over the batch with eps 1, the numerically
stable BCE with logits), and AdamW (β 0.9, 0.999, eps 1e-8, decoupled
weight decay on every parameter) at a linear warmup from 0.

Batches are drawn from the granules as the repository's host iterator
draws them (:func:`draw_batches`). ``low`` puts every convolution's
operands through float8 e4m3 at a per-tensor scale: the control."""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.unet_int8 import graph

BN_EPS = 1e-5
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FP8_MAX = 448.0


def draw_batches(samples: List[Tuple[np.ndarray, np.ndarray]], tile: int,
                 batch: int, rng: np.random.Generator
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Endless (B, t, t, C) channel and (B, t, t, 1) mask batches: each
    tile from a uniformly drawn granule, half of them centred within ±8 px
    of a uniformly drawn plume pixel (mask above 0.5), the rest uniform."""
    plume_px = [np.nonzero(m > 0.5) for _, m in samples]
    while True:
        xs = np.empty((batch, tile, tile, samples[0][0].shape[-1]),
                      np.float32)
        ys = np.empty((batch, tile, tile, 1), np.float32)
        for b in range(batch):
            i = rng.integers(len(samples))
            ch, mask = samples[i]
            pys, pxs = plume_px[i]
            h, w = ch.shape[:2]
            if rng.random() < 0.5 and len(pys):
                k = rng.integers(len(pys))
                cy = int(np.clip(pys[k] - tile // 2 + rng.integers(-8, 9),
                                 0, h - tile))
                cx = int(np.clip(pxs[k] - tile // 2 + rng.integers(-8, 9),
                                 0, w - tile))
            else:
                cy = int(rng.integers(0, h - tile + 1))
                cx = int(rng.integers(0, w - tile + 1))
            xs[b] = ch[cy:cy + tile, cx:cx + tile]
            ys[b, ..., 0] = mask[cy:cy + tile, cx:cx + tile]
        yield xs, ys


def d4_codes(seed: int, step: int, batch: int, device) -> torch.Tensor:
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    gen = torch.Generator(device=device).manual_seed(int(state[0]))
    return torch.randint(0, 8, (batch,), generator=gen, device=device)


def apply_d4(x: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    out = []
    for sample, code in zip(x, codes.tolist()):
        if code & 1:
            sample = sample.flip(0)
        if code & 2:
            sample = sample.flip(1)
        if code & 4:
            sample = sample.transpose(0, 1)
        out.append(sample)
    return torch.stack(out)


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 at a per-tensor scale, back in its
    dtype (differentiable: the scale is held constant)."""
    scale = (t.detach().abs().amax().float() / FP8_MAX).clamp(min=1e-12)
    q = (t.float() / scale).to(torch.float8_e4m3fn).to(torch.float32)
    return (t.float() + (q * scale - t.float()).detach()).to(t.dtype)


class Reference:
    """The model's fp32 master tensors, AdamW's state and the schedule."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg, train: dict,
                 low: bool = False):
        self.cfg = cfg
        self.train = train
        self.low = low
        self.dtype = DTYPES[cfg.compute_dtype]
        self.params = {k: v.detach().clone().float().requires_grad_(True)
                       for k, v in weights.items()
                       if not k.endswith(("running_mean", "running_var",
                                          "num_batches_tracked"))}
        peak = train["learning_rate"]
        self.opt = torch.optim.AdamW(
            list(self.params.values()), lr=peak, betas=(0.9, 0.999),
            eps=1e-8, weight_decay=train["weight_decay"])
        self.step_count = 0

    def lr(self, step: int) -> float:
        t = self.train
        if step < t["warmup_steps"]:
            return t["learning_rate"] * step / t["warmup_steps"]
        raise ValueError("the reference follows the warmup only")

    def _conv(self, x, w, bias=None, **kw):
        w = w.to(self.dtype)
        if self.low:
            x, w = _fp8(x), _fp8(w)
        return F.conv2d(x, w, None if bias is None else bias.to(self.dtype),
                        **kw)

    def _block(self, key, x):
        p = self.params
        for k in range(2):
            x = self._conv(x, p[f"{key}.conv.{k}.weight"], padding=1)
            # batch statistics, the biased variance, in fp32
            y = F.batch_norm(x.float(), None, None,
                             p[f"{key}.norm.{k}.weight"],
                             p[f"{key}.norm.{k}.bias"], True, 0.0, BN_EPS)
            x = torch.relu(y.to(self.dtype))
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Train-mode logits (B, t, t, 1) of NHWC ``x``."""
        p = self.params
        planes = {"in": x.permute(0, 3, 1, 2).to(
            self.dtype, memory_format=torch.channels_last)}
        for step in graph(self.cfg):
            if step[0] == "pool":
                planes[step[1]] = F.max_pool2d(planes[step[2]], 2)
            elif step[0] == "up":
                _, key, out, src = step
                w = p[f"{key}.weight"].to(self.dtype)
                xs = planes[src]
                if self.low:
                    xs, w = _fp8(xs), _fp8(w)
                planes[out] = F.conv_transpose2d(
                    xs, w, p[f"{key}.bias"].to(self.dtype), stride=2)
            elif step[0] == "block":
                _, key, out, srcs, _ = step
                planes[out] = self._block(
                    key, torch.cat([planes[s] for s in srcs], dim=1))
            elif step[0] == "heads":
                outs = []
                for key, plane in step[1]:
                    h = planes[plane].float()
                    outs.append(F.conv2d(h, p[f"{key}.weight"],
                                         p[f"{key}.bias"]))
                logits = sum(outs) / len(outs) if len(outs) > 1 \
                    else outs[0]
                return logits.permute(0, 2, 3, 1)
        raise AssertionError("graph without heads")

    def loss(self, logits, labels):
        w = self.train["dice_weight"]
        logits, labels = logits.float(), labels.float()
        probs = torch.sigmoid(logits)
        dice = 1.0 - (2.0 * (probs * labels).sum() + 1.0) \
            / (probs.sum() + labels.sum() + 1.0)
        bce = (torch.clamp(logits, min=0) - logits * labels
               + torch.log1p(torch.exp(-logits.abs()))).mean()
        return w * dice + (1.0 - w) * bce

    def step(self, xs: torch.Tensor, ys: torch.Tensor, seed: int) -> float:
        """One step on a batch; returns its loss."""
        codes = d4_codes(seed, self.step_count, xs.shape[0], xs.device)
        if self.train["augment"]:
            xs, ys = apply_d4(xs, codes), apply_d4(ys, codes)
        loss = self.loss(self.forward(xs), ys)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.step_count)
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step()
        self.step_count += 1
        return float(loss.detach())

    def first_moments(self) -> Dict[str, torch.Tensor]:
        return {k: self.opt.state[v]["exp_avg"] for k, v in
                self.params.items()}


def follow(weights, cfg, train: dict, samples, seed: int, steps: int,
           device, low: bool = False,
           batches: Optional[list] = None) -> dict:
    """``steps`` reference steps from ``weights`` on the batches the host
    iterator draws for ``seed``: each step's loss, the first step's
    gradient per leaf and each leaf's change after the last step."""
    ref = Reference(weights, cfg, train, low)
    draws = draw_batches(samples, train["tile"], train["batch_size"],
                         np.random.default_rng((seed, 0)))
    losses, grads = [], None
    for s in range(steps):
        xs, ys = next(draws) if batches is None else batches[s]
        losses.append(ref.step(torch.from_numpy(xs).to(device),
                               torch.from_numpy(ys).to(device), seed))
        if s == 0:
            grads = {k: m / 0.1 for k, m in ref.first_moments().items()}
    change = {k: (v.detach() - weights[k].float())
              for k, v in ref.params.items()}
    return {"loss": losses, "grad": grads, "change": change}
