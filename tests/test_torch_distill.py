"""The port's offline distillation (``plumekit_torch/train/distill.py``,
``train(..., curated_dir)`` and ``train_model --curated --distill-*``)
against the JAX package's: the relabelled masks of one teacher, whose
weights are carried across (the JAX ``load_teacher`` is replaced in the
test by one that returns them), within DISTILL_ATOL at fp32 for the blend,
temperature, calibration composed with temperature, D4 averaging and a
pruned UNet++ teacher; the validation errors; and the loop's use of it."""

import json
import logging
import os

import numpy as np
import pytest
import torch

import jax

from plumekit.config.train import InferConfig as JaxInferConfig
from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import build_model as jax_build_model
from plumekit.train import distill as jdist
from plumekit.train.state import create_state as jax_create_state
from plumekit_torch import cli
from plumekit_torch.config import InferConfig, TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax, to_flax
from plumekit_torch.models import build_model
from plumekit_torch.train import checkpoint as ckpt
from plumekit_torch.train import distill as tdist
from plumekit_torch.train import loop
from plumekit_torch.train.data import GranuleSample

KW = dict(in_channels=2, base_features=4, depth=2, compute_dtype="float32")
PP_KW = dict(KW, arch="unetpp", deep_supervision=True)
DISTILL_ATOL = 1e-5       # fp32 forwards and stitching, sums in another order
INFER = dict(tile_size=32, overlap=8, batch_tiles=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n=2, shape=(64, 72), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = (rng.random(shape) < 0.2).astype(np.float32)
        out.append(GranuleSample(
            channels=(rng.random(shape + (2,)) + mask[..., None]).astype(
                np.float32), mask=mask))
    return out


def _teacher(tmp_path, kw=KW, name="teacher"):
    """A port checkpoint and the same weights as flax variables: the JAX
    trainer's initial U-Net (PRNGKey(0)), or a seeded UNet++ carried to
    flax (a flax init of the grid is slow here)."""
    d = str(tmp_path / name)
    cfg = UNetConfig(**kw)
    if cfg.arch == "unet":
        state = jax_create_state(jax.random.PRNGKey(0), JaxUNetConfig(**kw),
                                 JaxTrainConfig())
        variables = jax.tree.map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        model = build_model(cfg)
        model.load_state_dict(from_flax(variables))
    else:
        model = build_model(cfg, torch.Generator().manual_seed(3))
        variables = to_flax(model.state_dict(), cfg.norm)
    ckpt.save_model_config(d, cfg)
    ckpt.save_weights(d, model)
    return d, variables


@pytest.fixture()
def jax_teacher(monkeypatch):
    """Makes the JAX ``load_teacher`` serve given variables."""
    held = {}

    def load(ckpt_dir, prune_level=None):
        kw = held["kw"] if prune_level is None else dict(
            held["kw"], prune_level=prune_level)
        cfg = JaxUNetConfig(**kw)
        return jax_build_model(cfg).apply, held["variables"], cfg

    monkeypatch.setattr(jdist, "load_teacher", load)

    def use(kw, variables):
        held["kw"], held["variables"] = kw, variables
    return use


@pytest.mark.parametrize("opts", [
    dict(alpha=1.0), dict(alpha=0.25), dict(alpha=1.0, temperature=4.0),
    dict(alpha=0.7, calibrate_threshold=0.7, temperature=2.0),
    dict(alpha=1.0, tta=True, calibrate_threshold=0.6),
    dict(alpha=0.5, overlap=0),
], ids=["alpha1", "alpha025", "temp4", "calib07_temp2", "tta_calib",
        "overlap0"])
def test_distill_samples_match_jax(tmp_path, jax_teacher, opts):
    opts = dict(opts)
    infer = dict(INFER, overlap=opts.pop("overlap", INFER["overlap"]))
    d, variables = _teacher(tmp_path)
    jax_teacher(KW, variables)
    samples = _samples()
    got = tdist.distill_samples(samples, d, infer_cfg=InferConfig(**infer),
                                device="cpu", **opts)
    want = jdist.distill_samples(samples, d,
                                 infer_cfg=JaxInferConfig(**infer), **opts)
    for g, w, s in zip(got, want, samples):
        assert g.mask.dtype == w.mask.dtype == np.float32
        np.testing.assert_allclose(g.mask, w.mask, atol=DISTILL_ATOL, rtol=0)
        assert g.channels is s.channels
        assert 0.0 <= g.mask.min() and g.mask.max() <= 1.0


def test_distill_unetpp_teacher_at_prune_level_matches_jax(tmp_path,
                                                           jax_teacher):
    d, variables = _teacher(tmp_path, PP_KW)
    jax_teacher(PP_KW, variables)
    samples = _samples(1)
    for level in (1, None):
        got = tdist.distill_samples(samples, d, alpha=1.0, prune_level=level,
                                    infer_cfg=InferConfig(**INFER),
                                    device="cpu")
        want = jdist.distill_samples(samples, d, alpha=1.0,
                                     prune_level=level,
                                     infer_cfg=JaxInferConfig(**INFER))
        np.testing.assert_allclose(got[0].mask, want[0].mask,
                                   atol=DISTILL_ATOL, rtol=0)


def test_distill_alpha_zero_skips_the_teacher(tmp_path):
    samples = _samples()
    for fn in (tdist.distill_samples, jdist.distill_samples):
        out = fn(samples, str(tmp_path / "no_such_ckpt"), alpha=0.0)
        for o, s in zip(out, samples):
            assert o.mask is s.mask


@pytest.mark.parametrize("kwargs, match", [
    (dict(alpha=1.5), "alpha"), (dict(alpha=-0.1), "alpha"),
    (dict(temperature=0.0), "temperature"),
    (dict(calibrate_threshold=1.0), "calibrate_threshold"),
    (dict(calibrate_threshold=0.0), "calibrate_threshold"),
    (dict(alpha=0.5), "model_config"),
])
def test_distill_validation_errors_match_jax(tmp_path, kwargs, match):
    samples = _samples(1)
    nowhere = str(tmp_path / "nowhere")
    for fn, extra in ((tdist.distill_samples, {"device": "cpu"}),
                      (jdist.distill_samples, {})):
        with pytest.raises(ValueError, match=match):
            fn(samples, nowhere, **kwargs, **extra)


def test_load_teacher_sources_and_refusals(tmp_path):
    d, _v = _teacher(tmp_path)
    bad = [GranuleSample(channels=np.zeros((32, 32, 3), np.float32),
                         mask=np.zeros((32, 32), np.float32))]
    with pytest.raises(ValueError, match="channels"):
        tdist.distill_samples(bad, d, device="cpu")
    # without weights.pt the newest step checkpoint serves
    _fn, model, cfg = tdist.load_teacher(d, device="cpu")
    assert cfg == UNetConfig(**KW) and not model.training
    steps = str(tmp_path / "steps")
    state = loop.create_state(UNetConfig(**KW), TrainConfig(), "cpu")
    state.model.load_state_dict(model.state_dict())
    ckpt.save_model_config(steps, UNetConfig(**KW))
    ckpt.save_checkpoint(steps, state, 7)
    os.remove(os.path.join(steps, ckpt.WEIGHTS_BASENAME))
    _fn, from_step, _cfg = tdist.load_teacher(steps, device="cpu")
    for k, v in model.state_dict().items():
        torch.testing.assert_close(from_step.state_dict()[k], v, rtol=0,
                                   atol=0)
    empty = str(tmp_path / "empty")
    ckpt.save_model_config(empty, UNetConfig(**KW))
    with pytest.raises(ValueError, match="no checkpoints"):
        tdist.load_teacher(empty, device="cpu")
    os.makedirs(os.path.join(empty, "step_00000010"))
    with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
        tdist.load_teacher(empty, device="cpu")


def test_distill_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d, _v = _teacher(tmp_path)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdist.distill_samples(_samples(1), d)


def _model_data(root, n):
    d = os.path.join(root, "processed", "model_data")
    os.makedirs(d)
    for i, s in enumerate(_samples(n, shape=(64, 64))):
        np.savez_compressed(os.path.join(d, f"g{i}__layer0.npz"),
                            channels=s.channels, mask=s.mask)
    return d


@pytest.mark.parametrize("n", [3, 4])
def test_loop_relabels_only_the_curated_training_samples(tmp_path,
                                                         monkeypatch, n):
    """At 4 or more samples the last is the dev set; the teacher relabels
    the training samples only, with the config's settings."""
    data = _model_data(str(tmp_path), n)
    seen = {}

    def fake(samples, teacher, **kw):
        seen.update(kw, n=len(samples), teacher=teacher)
        return samples

    monkeypatch.setattr(loop, "distill_samples", fake)
    cfg = TrainConfig(batch_size=2, tile_size=32, total_steps=1,
                      warmup_steps=1, log_every=1, augment=False,
                      checkpoint_dir=str(tmp_path / "ck"),
                      distill_from="T", distill_alpha=0.3, distill_temp=2.0,
                      distill_tta=True, distill_calibrate=0.6)
    hist = loop.train(UNetConfig(**KW), cfg, device="cpu",
                      curated_dir=data)
    assert np.isfinite(hist["eval_iou"][-1])
    assert seen == dict(n=n - 1 if n >= 4 else n, teacher="T", alpha=0.3,
                        temperature=2.0, prune_level=None, infer_cfg=None,
                        tta=True, calibrate_threshold=0.6,
                        device=torch.device("cpu"))


def test_train_model_curated_distill_calibrated_from_threshold_json(
        tmp_path, caplog):
    """``--distill-calibrate`` without a value reads threshold.json; with
    none written the command exits 1 before training."""
    root = str(tmp_path / "root")
    _model_data(root, 4)
    d, _v = _teacher(tmp_path)
    argv = ["train_model", "--root", root, "--device", "cpu", "--curated",
            "--steps", "2", "--batch-size", "2", "--tile", "32",
            "--distill-from", d, "--distill-tta", "--distill-alpha", "0.8",
            "--distill-calibrate"]
    with caplog.at_level(logging.ERROR):
        assert cli.main(argv) == 1
    assert "threshold.json" in caplog.text
    os.makedirs(os.path.join(root, "models"), exist_ok=True)
    with open(os.path.join(root, "models", "threshold.json"), "w") as f:
        json.dump({"threshold": 0.65, "metric": "iou"}, f)
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert cli.main(argv) == 0
    assert "distill calibration threshold 0.65" in caplog.text
    assert "distilled 3 granules (alpha=0.80 T=1.00 tta=True " \
        "calibrate=0.65)" in caplog.text
    assert "curated dataset: 3 train / 1 eval" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO):
        assert cli.main(argv[:-1] + ["--distill-calibrate", "0.4",
                                     "--steps", "4"]) == 0
    assert "calibrate=0.4)" in caplog.text
