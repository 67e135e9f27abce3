"""Seeded SegFormer weights, made on the device from ``--seed`` in one draw.

The names and layout are Hugging Face's ``SegformerForSemanticSegmentation``
state dict (linear weights ``(out, in)``, conv weights ``(cout, cin/groups,
kh, kw)``, LayerNorm's and batch norm's vectors), which the program's
SegFormer keeps, so that the program loads them with ``load_state_dict``
and the reference reads the same tensors. Names and shapes follow from the
configuration file alone (its ``segformer`` widths and ``model`` fields);
nothing here imports the program."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

#: (name, shape, kind) of one tensor
Spec = Tuple[str, Tuple[int, ...], str]


def _linear(name: str, cin: int, cout: int, kind: str = "linear"
            ) -> List[Spec]:
    return [(f"{name}.weight", (cout, cin), kind),
            (f"{name}.bias", (cout,), "bias")]


def _norm(name: str, c: int) -> List[Spec]:
    return [(f"{name}.weight", (c,), "ln_weight"),
            (f"{name}.bias", (c,), "ln_bias")]


def param_specs(seg: dict, model: dict) -> List[Spec]:
    """Every tensor of the SegFormer of the widths ``seg`` and the model
    fields ``model`` (``in_channels``, ``out_channels``), in the program's
    state-dict order."""
    hs = seg["hidden_sizes"]
    specs: List[Spec] = []
    cin = model["in_channels"]
    for i, c in enumerate(hs):
        k = seg["patch_sizes"][i]
        p = f"segformer.encoder.patch_embeddings.{i}"
        specs += [(f"{p}.proj.weight", (c, cin, k, k), "conv"),
                  (f"{p}.proj.bias", (c,), "bias")]
        specs += _norm(f"{p}.layer_norm", c)
        cin = c
    for i, c in enumerate(hs):
        sr = seg["sr_ratios"][i]
        hidden = c * seg["mlp_ratios"][i]
        for j in range(seg["depths"][i]):
            b = f"segformer.encoder.block.{i}.{j}"
            a = f"{b}.attention.self"
            specs += _norm(f"{b}.layer_norm_1", c)
            specs += _linear(f"{a}.query", c, c, "qk")
            specs += _linear(f"{a}.key", c, c, "qk")
            specs += _linear(f"{a}.value", c, c)
            if sr > 1:
                specs += [(f"{a}.sr.weight", (c, c, sr, sr), "conv"),
                          (f"{a}.sr.bias", (c,), "bias")]
                specs += _norm(f"{a}.layer_norm", c)
            specs += _linear(f"{b}.attention.output.dense", c, c)
            specs += _norm(f"{b}.layer_norm_2", c)
            specs += _linear(f"{b}.mlp.dense1", c, hidden)
            specs += [(f"{b}.mlp.dwconv.dwconv.weight", (hidden, 1, 3, 3),
                       "dwconv"),
                      (f"{b}.mlp.dwconv.dwconv.bias", (hidden,), "bias")]
            specs += _linear(f"{b}.mlp.dense2", hidden, c)
    for i, c in enumerate(hs):
        specs += _norm(f"segformer.encoder.layer_norm.{i}", c)
    d = seg["decoder_hidden_size"]
    for i, c in enumerate(hs):
        specs += _linear(f"decode_head.linear_c.{i}.proj", c, d)
    specs.append(("decode_head.linear_fuse.weight", (d, len(hs) * d, 1, 1),
                  "fuse"))
    for field, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                        ("running_mean", "bn_mean"),
                        ("running_var", "bn_var")):
        specs.append((f"decode_head.batch_norm.{field}", (d,), kind))
    specs.append(("decode_head.batch_norm.num_batches_tracked", (), "count"))
    out = model["out_channels"]
    specs += [("decode_head.classifier.weight", (out, d, 1, 1), "head"),
              ("decode_head.classifier.bias", (out,), "head_bias")]
    return specs


def make_weights(seg: dict, model: dict, init: Dict[str, float], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The fp32 weights from one standard normal draw of a generator on
    ``device`` seeded with ``seed``. ``init`` gives each kind its scale:
    weights ``<kind>_gain / sqrt(fan_in)`` (``linear``; ``qk``, the query
    and key projections, whose gain sets how peaked attention is; ``conv``,
    ``dwconv``, ``fuse``, ``head``; a depthwise kernel's fan-in is its 9
    taps), LayerNorm's scale ``1 + ln_weight·n`` and shift ``ln_bias·n``,
    batch norm's scale ``1 + bn_weight·n``, shift and running mean ``·n``,
    running variance ``exp(bn_var·n)``, biases ``bias·n`` (the
    classifier's ``head_bias·n``)."""
    specs = param_specs(seg, model)
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device,
                       dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        z = draw[at:at + n].reshape(shape)
        at += n
        if kind in ("linear", "qk", "conv", "dwconv", "fuse", "head"):
            fan_in = math.prod(shape[1:])
            t = z * (init[f"{kind}_gain"] / math.sqrt(fan_in))
        elif kind in ("ln_weight", "bn_weight"):
            t = 1.0 + init[kind] * z
        elif kind == "bn_var":
            t = torch.exp(init["bn_var"] * z)
        elif kind == "count":
            t = torch.zeros((), dtype=torch.long, device=device)
        else:   # bias, head_bias, ln_bias, bn_bias, bn_mean
            t = init[kind] * z
        out[name] = t.contiguous()
    return out


def corner_tiles(channels, tile: int, device) -> torch.Tensor:
    """The 2×2 grid of ``tile``² tiles at the corners of a granule
    ``(H, W, C)`` (host array), on ``device``."""
    x = torch.as_tensor(channels).to(device)
    h, w = x.shape[:2]
    return torch.stack([x[y:y + tile, c:c + tile]
                        for y in (0, h - tile) for c in (0, w - tile)])


def center_logits(w: Dict[str, torch.Tensor], seg: dict, forward,
                  tiles: torch.Tensor, chunk: int = 4) -> None:
    """Shift the classifier's bias in ``w``, in place, so that the plain
    reference's logits (``forward(w, seg, tiles)``) over ``tiles`` have
    mean 0 in every label. Random weights put the head's ReLU features
    under a classifier whose weighted sum offsets every logit of a seed
    alike, by up to ±20 at the published widths, and a granule whose
    probabilities all sit at 0 or 1 holds every forward to nothing; a
    trained head's bias centres its logits in the same way."""
    total, n = None, 0
    with torch.no_grad():
        for at in range(0, len(tiles), chunk):
            y = forward(w, seg, tiles[at:at + chunk]).double()
            s = y.sum(dim=(0, 1, 2))
            total = s if total is None else total + s
            n += y.shape[0] * y.shape[1] * y.shape[2]
    bias = w["decode_head.classifier.bias"]
    bias -= (total / n).to(bias.dtype)

