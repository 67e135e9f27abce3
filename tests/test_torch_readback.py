"""The stream's readback (``plumekit_torch/infer/streaming.readback``): on
the card each granule's probabilities are copied without blocking into a
pinned host block of its own and yielded once that copy's event has passed;
elsewhere the group is read back whole by ``.cpu()``.

Both are held to the stream read back as a whole-group pageable ``.cpu()``
(``_pageable``) on the same device, bit for bit: one granule a group, four
with a ragged tail of three, the tail padded by duplicates
(``infer_is_batched``), and the uint8 code (``quantize_output``). The
granules are cropped from a padded shape, and every yielded array is kept
to the end of the stream, so a pinned block handed out again while a caller
still held it would show as changed values.

The tests marked ``cuda`` need a card and skip without one; the file
imports no JAX: ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_readback.py``."""

import numpy as np
import pytest
import torch

from plumekit_torch.config import InferConfig, UNetConfig
from plumekit_torch.infer import streaming
from plumekit_torch.infer.sliding import make_multi_granule_infer
from plumekit_torch.models import UNet
from plumekit_torch.utils import timers

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
ICFG = dict(tile_size=32, overlap=8, batch_tiles=4)
GRANULES = 7
PADDED, HW = (64, 72), (61, 70)     # the U-Net's multiple of 4, the granule
CASES = {
    "g1": dict(batch_granules=1),
    "g4_ragged": dict(batch_granules=4),
    "g4_batched": dict(batch_granules=4, infer_is_batched=True),
    "g4_uint8": dict(batch_granules=4, quantize_output=True),
}


@pytest.fixture(autouse=True)
def _recorder_off():
    timers.disable()
    timers.drain()
    yield
    timers.disable()
    timers.drain()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned copies exist only there")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = deterministic


def _pageable(probs, sizes):
    """The whole group by one pageable ``.cpu()``, then cropped: the
    readback before pinned memory."""
    host = probs.cpu().numpy()
    return [(host[i, :h, :w], None) for i, (h, w) in enumerate(sizes)]


def _served(device, case, monkeypatch, readback=None):
    """One stream of the granules with the recorder on: [(name, yielded
    array, its copy taken at the yield)], every array kept to the end, what
    ``readback`` returned group by group, and what the recorder drained."""
    returned = []
    real = readback or streaming.readback

    def recorded(probs, sizes):
        out = real(probs, sizes)
        returned.append(out)
        return out

    monkeypatch.setattr(streaming, "readback", recorded)
    rng = np.random.default_rng(11)
    pre = {f"g{i}": (f"g{i}", rng.random(PADDED + (2,), dtype=np.float32),
                     HW) for i in range(GRANULES)}
    torch.manual_seed(0)
    model = UNet(UNetConfig(**KW)).eval().to(device)
    infer = make_multi_granule_infer(lambda m, x: m(x), InferConfig(**ICFG))
    got = []
    timers.enable()
    try:
        with torch.inference_mode():
            for name, probs in streaming.stream_inference(
                    list(pre), infer, model, KW["depth"], device,
                    decode_workers=1, predecoded=pre, **CASES[case]):
                got.append((name, probs, probs.copy()))
    finally:
        timers.disable()
    return got, returned, timers.drain()


def _groups(case):
    return -(-GRANULES // CASES[case]["batch_granules"])


def _check_yields(got, want):
    assert [n for n, _, _ in got] == [n for n, _, _ in want] \
        == [f"g{i}" for i in range(GRANULES)]
    for (name, p, at_yield), (_, q, _) in zip(got, want):
        assert p.shape == HW and p.dtype == q.dtype == np.float32, name
        assert np.array_equal(p, q), name
        assert np.array_equal(p, at_yield), name    # kept, never overwritten


@pytest.mark.parametrize("case", list(CASES))
def test_off_the_card_the_group_is_one_pageable_copy(case, monkeypatch):
    """On the CPU: the yields are the whole-group ``.cpu()`` readback's bit
    for bit, no granule goes through pinned memory, and the bytes counted
    are the whole padded group's, duplicates included."""
    cpu = torch.device("cpu")
    got, returned, drained = _served(cpu, case, monkeypatch)
    want, _, _ = _served(cpu, case, monkeypatch, readback=_pageable)
    _check_yields(got, want)
    c = drained["counters"]
    assert c["stream.granules"] == GRANULES
    assert "stream.readback.pinned" not in c
    g = CASES[case]["batch_granules"]
    copied = g * _groups(case) if CASES[case].get("infer_is_batched") \
        else GRANULES
    itemsize = 1 if CASES[case].get("quantize_output") else 4
    assert c["stream.readback.bytes"] == copied * PADDED[0] * PADDED[1] \
        * itemsize
    assert all(ready is None for out in returned for _, ready in out)
    assert not [s for s in drained["spans"]
                if s["name"] == "stream.readback_wait"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_the_pinned_readback_yields_the_pageable_bytes_and_keeps_them(
        card, case, monkeypatch):
    """On the card: the same bytes as the pageable ``.cpu()`` readback;
    each granule, and no duplicate, copied into a pinned block of its own;
    every yielded array unchanged at the end of the stream; the recorder's
    counters and the waits between yields."""
    got, returned, drained = _served(card, case, monkeypatch)
    want, _, _ = _served(card, case, monkeypatch, readback=_pageable)
    _check_yields(got, want)
    arrays = [a for out in returned for a, _ in out]
    assert len(returned) == _groups(case) and len(arrays) == GRANULES
    u8 = CASES[case].get("quantize_output", False)
    for a in arrays:
        assert a.shape == HW and a.dtype == (np.uint8 if u8 else np.float32)
        assert torch.from_numpy(a).is_pinned()
    assert len({a.ctypes.data for a in arrays}) == GRANULES
    if not u8:      # the yield is the pinned block itself
        for (_, p, _), a in zip(got, arrays):
            assert p.ctypes.data == a.ctypes.data
    c = drained["counters"]
    assert c["stream.readback.pinned"] == c["stream.granules"] == GRANULES
    assert c["stream.readback.bytes"] == GRANULES * HW[0] * HW[1] \
        * (1 if u8 else 4)
    waits = [s for s in drained["spans"] if s["name"] == "stream.readback_wait"]
    assert len(waits) == GRANULES - _groups(case)
    assert all(s["attrs"]["granule"] >= 1 and s["parent"] is None
               for s in waits)
    for name in ("stream.readback", "stream.readback.copy",
                 "stream.readback.device_wait"):
        assert len([s for s in drained["spans"] if s["name"] == name]) \
            == _groups(case)
