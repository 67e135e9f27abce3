"""``plumekit_torch/native`` (the host CCL and codecs, built by g++) against
``plumekit/native`` and the numpy codec on seeded inputs, bit for bit:
``ccl_label`` at both connectivities, ``region_stats``, ``component_sizes``,
``quantize_uint16`` (a constant channel; non-finite input raises) and
``quantize_mask_uint8``; the callers (``ops/quant``, the training
transfers' mask encode) on the native codec; the build's name and place;
and the numpy fallback, logged once. The native tests need g++, which this
machine has: they do not skip."""

import logging

import numpy as np
import pytest
import torch

from plumekit import native as jax_native
from plumekit.ops.quant import quantize_uint16 as jax_quantize_uint16
from plumekit_torch import cuda_build, native
from plumekit_torch.native import build
from plumekit_torch.ops import quant


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_uint16(channels):
    """The numpy codec of ``ops/quant.quantize_uint16``, restated so that
    the native codec is held against it whichever path the port takes."""
    c = channels.shape[-1]
    flat = channels.reshape(-1, c)
    lo = flat.min(axis=0).astype(np.float32)
    hi = flat.max(axis=0).astype(np.float32)
    scale = np.maximum(hi - lo, 1e-12).astype(np.float32) / 65535.0
    q = np.round((flat - lo) / scale).astype(np.uint16).reshape(
        channels.shape)
    return q, lo, scale


def _same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_the_library_builds_under_the_build_dir_by_hash():
    assert native.available() and jax_native.available()
    path = build.lib_path()
    assert path.parent == cuda_build.BUILD_DIR and path.exists()
    assert path.name.startswith("libplumekit_native-")
    assert build.build() == str(path)
    assert build.FLAGS == ["-O3", "-march=native", "-std=c++17", "-shared",
                           "-fPIC"]                 # no -ffast-math


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("p", [0.2, 0.5, 0.8])
def test_ccl_label_equals_the_jax_package(connectivity, p):
    m = np.random.default_rng(int(p * 10) + connectivity).random((73, 91)) < p
    got, n = native.ccl_label(m, connectivity)
    want, n_want = jax_native.ccl_label(m, connectivity)
    assert n == n_want
    _same((got,), (want,))


def test_ccl_label_empty_and_full():
    for m, n_want in ((np.zeros((8, 8), bool), 0), (np.ones((8, 8), bool), 1)):
        labels, n = native.ccl_label(m)
        assert n == n_want and labels.max() == n_want


def test_region_stats_and_component_sizes_equal_the_jax_package():
    m = np.random.default_rng(3).random((64, 64)) < 0.3
    labels, n = native.ccl_label(m, 2)
    # one label past the last: an absent component's row
    _same(native.region_stats(labels, n + 1),
          jax_native.region_stats(labels, n + 1))
    _same((native.component_sizes(labels, n),),
          (jax_native.component_sizes(labels, n),))
    sizes = native.component_sizes(labels, n)
    assert sizes[0] == (labels == 0).sum() and sizes.sum() == labels.size


@pytest.mark.parametrize("shape", [(57, 63, 2), (97, 131, 3), (5, 1),
                                   (33, 64)])
def test_quantize_uint16_is_the_numpy_codec_bit_for_bit(shape):
    x = (np.random.default_rng(sum(shape)).random(shape) * 2.7
         - 1.3).astype(np.float32)
    got = native.quantize_uint16(x)
    _same(got, _numpy_uint16(x))
    _same(got, jax_native.quantize_uint16(x))


def test_quantize_uint16_constant_channel():
    x = np.zeros((16, 16, 2), np.float32)
    x[..., 1] = 3.5
    _same(native.quantize_uint16(x), _numpy_uint16(x))


def test_quantize_uint16_refuses_non_finite_input():
    bad = np.ones((4, 4, 2), np.float32)
    for v in (np.nan, np.inf):
        bad[1, 1, 0] = v
        with pytest.raises(ValueError, match="finite"):
            native.quantize_uint16(bad)
        with pytest.raises(ValueError, match="finite"):
            quant.quantize_uint16(bad)


def test_quantize_mask_uint8_equals_the_jax_package():
    rng = np.random.default_rng(5)
    m = rng.random((64, 64)).astype(np.float32)
    m[0, 0], m[0, 1] = -0.5, 1.5
    got = native.quantize_mask_uint8(m)
    _same((got,), (jax_native.quantize_mask_uint8(m),))
    _same((got,), (np.rint(np.clip(m, 0, 1) * 255).astype(np.uint8),))


def test_ops_quant_dispatches_to_the_native_codec(monkeypatch):
    x = (np.random.default_rng(7).random((40, 52, 2)) * 1.8).astype(
        np.float32)
    calls = []
    real = native.quantize_uint16
    monkeypatch.setattr(native, "quantize_uint16",
                        lambda c: calls.append(c.shape) or real(c))
    got = quant.quantize_uint16(x)
    assert calls == [x.shape]
    _same(got, jax_quantize_uint16(x))
    # an array that is not C-contiguous takes the numpy path, to the same
    # bits
    _same(quant.quantize_uint16(np.asfortranarray(x)), got)
    assert calls == [x.shape]


def test_training_transfer_masks_take_the_native_codec(monkeypatch):
    from plumekit.train.data import GranuleSample as JaxSample
    from plumekit.train.data import quantize_samples as jax_quantize_samples
    from plumekit_torch.train.data import GranuleSample, quantize_samples

    rng = np.random.default_rng(9)
    channels = rng.random((48, 40, 2)).astype(np.float32)
    mask = rng.random((48, 40)).astype(np.float32)   # soft labels
    calls = []
    real = native.quantize_mask_uint8
    monkeypatch.setattr(native, "quantize_mask_uint8",
                        lambda m: calls.append(m.shape) or real(m))
    (got,) = quantize_samples([GranuleSample(channels=channels, mask=mask)])
    (want,) = jax_quantize_samples([JaxSample(channels=channels, mask=mask)])
    assert calls == [mask.shape]
    _same((got.channels, got.mask, got.lo, got.scale),
          (want.channels, want.mask, want.lo, want.scale))


def test_without_the_library_every_entry_falls_back_and_warns_once(
        monkeypatch, caplog):
    rng = np.random.default_rng(11)
    m = rng.random((40, 40)) < 0.4
    x = rng.random((30, 20, 2)).astype(np.float32)
    want_labels = native.ccl_label(m, 2)
    want_stats = native.region_stats(want_labels[0], want_labels[1])
    want_q = native.quantize_uint16(x)
    want_m8 = native.quantize_mask_uint8(x[..., 0])

    def no_compiler():
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(build, "build", no_compiler)
    with caplog.at_level(logging.WARNING, logger="plumekit_torch.native"):
        assert not native.available()
        _same(native.quantize_uint16(x), want_q)
        _same((native.quantize_mask_uint8(x[..., 0]),), (want_m8,))
        labels = native.ccl_label(m, 2)
        _same(labels[:1], want_labels[:1])
        assert labels[1] == want_labels[1]
        _same(native.region_stats(*labels), want_stats)
        _same(quant.quantize_uint16(x), want_q)
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == 1 and "unavailable" in warnings[0].getMessage()
