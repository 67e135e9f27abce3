"""The blob detectors of plumekit_torch (LoG, DoG, DoH) against the JAX
package's on the same images, and against the clean-room scipy oracle of
tests/oracle_blob.py as tests/test_identify_blob_oracle.py holds the JAX
ones.

Tolerances: the two packages must find the same blobs in the same order
(rows, columns and sigmas exact: integer positions and sigmas off one
ladder); the scale-space responses are float32 convolutions summed in
another order, so atol 1e-5.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from plumekit.config.identify import BlobIdentifyConfig as JaxBlobCfg
from plumekit.identify import blob as jax_blob
from plumekit_torch.config.identify import BlobIdentifyConfig
from plumekit_torch.identify import blob

sys.path.insert(0, os.path.dirname(__file__))
from oracle_blob import (oracle_blob_dog, oracle_blob_doh,  # noqa: E402
                         oracle_blob_log)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers sharing the host's cores
    the pool's waiting threads slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RESPONSE_ATOL = 1e-5
KW = dict(min_sigma=2.0, max_sigma=16.0, num_sigma=15, threshold_log=0.05,
          threshold_dog=0.05, threshold_doh=0.005)
CFG, JAX_CFG = BlobIdentifyConfig(**KW), JaxBlobCfg(**KW)
LADDER_STEP = (CFG.max_sigma - CFG.min_sigma) / (CFG.num_sigma - 1)
PLANTED = [(32.0, 40.0, 3.0), (36.0, 150.0, 6.0), (110.0, 60.0, 9.0),
           (150.0, 160.0, 14.0)]


def _scene(noise=0.0, seed=0):
    """The planted Gaussians of tests/test_identify_blob_oracle.py."""
    yy, xx = np.mgrid[0:200, 0:200].astype(np.float64)
    img = np.zeros((200, 200))
    for r0, c0, s in PLANTED:
        img += np.exp(-0.5 * (((yy - r0) / s) ** 2 + ((xx - c0) / s) ** 2))
    if noise:
        img += noise * np.random.default_rng(seed).standard_normal(img.shape)
    return img.astype(np.float32)


DETECTORS = {
    "log": (blob.blob_log, jax_blob.blob_log),
    "dog": (blob.blob_dog, jax_blob.blob_dog),
    "doh": (blob.blob_doh, jax_blob.blob_doh),
}


@pytest.mark.parametrize("noise", [0.0, 0.03], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_finds_the_jax_blobs(name, noise):
    ours, theirs = DETECTORS[name]
    img = _scene(noise)
    got = ours(img, CFG, device="cpu")
    want = np.asarray(theirs(img, JAX_CFG))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert len(got) >= len(PLANTED) - 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(DETECTORS))
def test_detector_matches_jax_when_the_budget_binds(name):
    """More maxima than ``max_blobs``: the strongest responses are kept,
    the same ones in both packages."""
    ours, theirs = DETECTORS[name]
    img = _scene(0.2, seed=3)
    cfg_kw = dict(KW, threshold_log=0.01, threshold_dog=0.01,
                  threshold_doh=0.0005, overlap=1.0)
    got = ours(img, BlobIdentifyConfig(**cfg_kw), max_blobs=12,
               device="cpu")
    want = np.asarray(theirs(img, JaxBlobCfg(**cfg_kw), max_blobs=12))
    assert len(got) == 12
    # equal responses may be ordered differently: compare as sets of rows
    assert sorted(map(tuple, got)) == sorted(map(tuple, want))


@pytest.mark.parametrize("sigma", [1.0, 2.5, 9.0, 40.0])
def test_blur_and_shift_match_jax(sigma):
    """The symmetric-boundary blur (a pad wider than the image at sigma
    40) and the edge-replicated shifts."""
    img = _scene(0.03)[:61, :97]
    got = blob._gaussian_blur(torch.from_numpy(img), sigma)
    want = np.asarray(jax_blob._gaussian_blur(jnp.asarray(img), sigma))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=RESPONSE_ATOL, rtol=0)
    for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1), (1, -1), (-1, 1)):
        np.testing.assert_array_equal(
            blob._shift(torch.from_numpy(img), dr, dc).numpy(),
            np.asarray(jax_blob._shift(jnp.asarray(img), dr, dc)))


def test_local_maxima_match_jax():
    rng = np.random.default_rng(1)
    stack = rng.standard_normal((4, 20, 30)).astype(np.float32)
    stack[1, 5, 5] = stack[2, 5, 5] = 7.0        # a tie across scales
    stack[0, 0, 0] = stack[3, 19, 29] = 9.0      # corners of the cube
    got = blob._local_max_3d(torch.from_numpy(stack), 0.5).numpy()
    want = np.asarray(jax_blob._local_max_3d(jnp.asarray(stack), 0.5))
    np.testing.assert_array_equal(got, want)
    assert got[1, 5, 5] and got[2, 5, 5] and got[0, 0, 0] and got[3, 19, 29]


def _unmatched(a, b, pos_tol, sigma_tol):
    """Rows of ``a`` with no partner in ``b`` within the tolerances."""
    return [tuple(x) for x in a
            if not any(np.hypot(x[0] - y[0], x[1] - y[1]) <= pos_tol
                       and abs(x[2] - y[2]) <= sigma_tol for y in b)]


ORACLES = {
    "log": (lambda img: oracle_blob_log(img, CFG.min_sigma, CFG.max_sigma,
                                        CFG.num_sigma, CFG.threshold_log,
                                        CFG.overlap),
            np.sqrt(2.0) * LADDER_STEP + 1e-3),
    "dog": (lambda img: oracle_blob_dog(img, CFG.min_sigma, CFG.max_sigma,
                                        1.6, CFG.threshold_dog, CFG.overlap),
            np.sqrt(2.0) * CFG.min_sigma * (1.6**3 - 1.6**2)),
    "doh": (lambda img: oracle_blob_doh(img, CFG.min_sigma, CFG.max_sigma,
                                        CFG.num_sigma, CFG.threshold_doh,
                                        CFG.overlap),
            LADDER_STEP + 1e-3),
}


@pytest.mark.parametrize("noise", [0.0, 0.03], ids=["clean", "noisy"])
@pytest.mark.parametrize("name", sorted(ORACLES))
def test_detector_matches_the_scipy_oracle(name, noise):
    """Every oracle blob has a match within 2 px and one ladder step and
    the other way round, up to one borderline blob a side."""
    oracle, sigma_tol = ORACLES[name]
    img = _scene(noise)
    got = DETECTORS[name][0](img, CFG, device="cpu")
    want = np.asarray(oracle(img))
    assert len(want) >= len(PLANTED) - 1
    assert len(_unmatched(want, got, 2.0, sigma_tol)) <= 1
    assert len(_unmatched(got, want, 2.0, sigma_tol)) <= 1


def test_pruning_keeps_the_larger_of_two_overlapping_blobs():
    yy, xx = np.mgrid[0:96, 0:96].astype(np.float64)
    img = (np.exp(-0.5 * (((yy - 48) / 8) ** 2 + ((xx - 48) / 8) ** 2))
           + 0.7 * np.exp(-0.5 * (((yy - 52) / 3) ** 2
                                  + ((xx - 52) / 3) ** 2))
           ).astype(np.float32)
    got = blob.blob_log(img, CFG, device="cpu")
    want = np.asarray(jax_blob.blob_log(img, JAX_CFG))
    np.testing.assert_array_equal(got, want)
    assert len(got) == 1 and got[0][2] > 6.0


def test_flat_field_has_no_blobs():
    flat = np.full((64, 64), 0.3, np.float32)
    for name in sorted(DETECTORS):
        assert DETECTORS[name][0](flat, CFG, device="cpu").shape == (0, 3)
