"""plumekit_torch.io.prefetch, as ``tests/test_viz_streaming.py`` holds the
JAX package's: the decode pool's order under uneven latency and its
errors at their item's turn, the stager's order and errors, and a stager
that stops when its consumer leaves. Every wait is bounded."""

import threading
import time

import numpy as np
import pytest
import torch

from plumekit_torch.io.prefetch import (STAGER_NAME, decode_pool,
                                        default_decode_workers,
                                        device_prefetch, make_device_put)

WAIT_S = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stagers():
    return [t for t in threading.enumerate() if t.name == STAGER_NAME]


def _joined(threads):
    for t in threads:
        t.join(timeout=WAIT_S)
    return not any(t.is_alive() for t in threads)


def test_decode_pool_delivers_in_order_under_uneven_latency():
    def slow_decode(i):
        time.sleep(0.03 if i % 2 == 0 else 0.0)   # evens are slower
        return i * 10

    assert list(decode_pool(range(9), slow_decode, workers=4)) == \
        [i * 10 for i in range(9)]
    assert 1 <= default_decode_workers() <= 4


def test_decode_pool_raises_at_the_failing_items_turn():
    def maybe_fail(i):
        if i == 3:
            raise ValueError("boom")
        return i

    got = []
    with pytest.raises(ValueError, match="boom"):
        for x in decode_pool(range(6), maybe_fail, workers=3):
            got.append(x)
    assert got == [0, 1, 2]


def test_device_prefetch_keeps_order_and_moves_arrays():
    items = [(f"g{i}", (np.full((3, 2), i, np.float32),), (i, i + 1))
             for i in range(7)]
    got = list(device_prefetch(iter(items), buffer_size=2,
                               device_put=make_device_put("cpu")))
    assert [g[0] for g in got] == [f"g{i}" for i in range(7)]
    for i, (name, (x,), hw) in enumerate(got):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        assert torch.equal(x, torch.full((3, 2), float(i)))
        assert hw == (i, i + 1)


def test_device_prefetch_raises_a_source_error_after_the_earlier_items():
    def source():
        yield 0
        yield 1
        raise RuntimeError("decode failed")

    got = []
    with pytest.raises(RuntimeError, match="decode failed"):
        for x in device_prefetch(source(), device_put=lambda x: x):
            got.append(x)
    assert got == [0, 1]


def test_device_prefetch_raises_a_put_error():
    def put(x):
        if x == 2:
            raise OSError("upload failed")
        return x

    got = []
    with pytest.raises(OSError, match="upload failed"):
        for x in device_prefetch(iter(range(5)), device_put=put):
            got.append(x)
    assert got == [0, 1]


def test_an_abandoned_stream_stops_its_stager():
    def endless():
        i = 0
        while True:
            yield i
            i += 1

    before = set(_stagers())
    stream = device_prefetch(endless(), buffer_size=2,
                             device_put=lambda x: x)
    assert next(stream) == 0 and next(stream) == 1
    mine = [t for t in _stagers() if t not in before]
    assert len(mine) == 1
    stream.close()
    assert _joined(mine), "the stager outlived its consumer"


def test_cuda_put_without_a_card_is_an_error_at_the_consumer():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        next(device_prefetch(iter([np.zeros(3, np.float32)])))
