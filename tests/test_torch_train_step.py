"""The port's U-Net in train mode and its train step against the JAX
package's: flax's ``train=True`` forward and ``batch_stats`` update, and
one and three optimizer steps of ``plumekit.train.step.make_train_step``
from the same parameters (carried over by ``convert.from_flax``) on the
same batch, augmentation off (the two packages draw different codes).
Then the fused eval routes after an in-place optimizer step."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from plumekit.config.train import TrainConfig as JaxTrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.models import UNet as JaxUNet
from plumekit.models.losses import dice_bce_loss as jax_dice_bce
from plumekit.train.state import create_state as jax_create_state
from plumekit.train.step import make_train_step as jax_make_train_step
from plumekit_torch.config import TrainConfig, UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.models import UNet
from plumekit_torch.train.state import create_state
from plumekit_torch.train.step import make_eval_step, make_train_step

KW = dict(in_channels=2, base_features=8, depth=2, compute_dtype="float32")
# warmup 1: the first update runs at lr 0 (as in optax), the next ones at
# the peak and down the cosine, so three steps move the parameters
TCFG = dict(batch_size=4, tile_size=32, learning_rate=1e-3,
            weight_decay=1e-2, warmup_steps=1, total_steps=4, augment=False)
# fp32 on both sides, sums in another order
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4     # max|Δg| per tensor, relative to max|g| of the tensor
STAT_TOL = 1e-5     # batch statistics and running buffers, rtol and atol
# Adam normalises each gradient element, so a parameter moves by about lr
# per step whatever its gradient: max|Δp| relative to the peak lr
PARAM_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under parallel test workers torch's thread pool
    slows every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, n=4, size=32):
    rng = np.random.default_rng(seed)
    xs = rng.normal(size=(n, size, size, 2)).astype(np.float32)
    ys = (rng.random((n, size, size, 1)) < 0.3).astype(np.float32)
    return xs, ys


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _port_state(jax_state, **tcfg):
    state = create_state(UNetConfig(**KW), TrainConfig(**{**TCFG, **tcfg}),
                         "cpu")
    state.model.load_state_dict(from_flax(_numpy(
        {"params": jax_state.params, "batch_stats": jax_state.batch_stats})))
    return state


def _jax_grads(state, xs, ys, label_smooth=0.0):
    def loss_fn(params):
        logits, _ = state.apply_fn(
            {"params": params, "batch_stats": state.batch_stats}, xs,
            train=True, mutable=["batch_stats"])
        return jax_dice_bce(logits, ys, 0.5, label_smooth=label_smooth)

    return _numpy(jax.grad(loss_fn)(state.params))


def _assert_params_close(model, jax_state, lr):
    want = from_flax(_numpy({"params": jax_state.params,
                             "batch_stats": jax_state.batch_stats}))
    got = model.state_dict()
    for name, w in want.items():
        if name.endswith("num_batches_tracked"):
            continue
        g = got[name].numpy()
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g, w.numpy(), rtol=STAT_TOL,
                                       atol=STAT_TOL, err_msg=name)
        else:
            assert np.abs(g - w.numpy()).max() <= PARAM_TOL * lr, name


def _assert_grads_close(model, jax_grads):
    want = from_flax({"params": jax_grads})
    for name, p in model.named_parameters():
        w = want[name].numpy()
        err = np.abs(p.grad.numpy() - w).max()
        assert err <= GRAD_TOL * np.abs(w).max(), (name, err)


def test_bn_train_forward_and_running_stats_match_flax():
    """Two train-mode forwards: logits of each and the running mean and
    (biased) variance after both equal flax's ``mutable=["batch_stats"]``
    updates at momentum 0.99."""
    cfg = JaxUNetConfig(**KW)
    xs0, _ = _batch(0)
    xs1, _ = _batch(1)
    variables = JaxUNet(cfg).init(jax.random.PRNGKey(0), jnp.asarray(xs0),
                                  train=False)
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(_numpy(variables)))
    model.train()
    for xs in (xs0, xs1):
        logits, upd = JaxUNet(cfg).apply(variables, jnp.asarray(xs),
                                         train=True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        with torch.no_grad():
            got = model(torch.from_numpy(xs))
        np.testing.assert_allclose(got.numpy(), np.asarray(logits),
                                   rtol=1e-4, atol=1e-4)
    want = from_flax(_numpy(variables))
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=STAT_TOL, atol=STAT_TOL,
                                       err_msg=name)


def test_eval_mode_unchanged_by_train_mode_forward():
    """A train-mode forward moves the running buffers only; the eval
    forward reads them, as flax's ``train=False`` does."""
    cfg = JaxUNetConfig(**KW)
    xs, _ = _batch(2)
    variables = JaxUNet(cfg).init(jax.random.PRNGKey(1), jnp.asarray(xs),
                                  train=False)
    _, upd = JaxUNet(cfg).apply(variables, jnp.asarray(xs), train=True,
                                mutable=["batch_stats"])
    variables = {"params": variables["params"], **upd}
    want = JaxUNet(cfg).apply(variables, jnp.asarray(xs), train=False)
    model = UNet(UNetConfig(**KW))
    model.load_state_dict(from_flax(_numpy(variables)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(xs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
def test_three_steps_match_jax_train_step(label_smooth):
    """Loss, IoU, gradients (back through ``convert``), parameters and
    running buffers after each of three steps."""
    jcfg = JaxTrainConfig(**TCFG, label_smooth=label_smooth)
    jstate = jax_create_state(jax.random.PRNGKey(0), JaxUNetConfig(**KW),
                              jcfg)
    state = _port_state(jstate, label_smooth=label_smooth)
    jstep = jax_make_train_step(0.5, augment=False,
                                label_smooth=label_smooth)
    step = make_train_step(0.5, augment=False, label_smooth=label_smooth)

    for i in range(3):
        xs, ys = _batch(10 + i)
        jgrads = _jax_grads(jstate, jnp.asarray(xs), jnp.asarray(ys),
                            label_smooth)
        jstate, jm = jstep(jstate, jnp.asarray(xs), jnp.asarray(ys),
                           jax.random.PRNGKey(i))
        state, m = step(state, torch.from_numpy(xs), torch.from_numpy(ys),
                        None)
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]),
                                                 rel=LOSS_RTOL)
        assert float(m["iou"]) == pytest.approx(float(jm["iou"]), abs=1e-6)
        _assert_grads_close(state.model, jgrads)
        _assert_params_close(state.model, jstate, TCFG["learning_rate"])
    assert state.step == int(jstate.step) == 3


def test_eval_step_matches_eval_mode_forward():
    """The eval step leaves the model in train mode and returns the eval
    forward's loss and IoU at the training ``dice_weight``."""
    jstate = jax_create_state(jax.random.PRNGKey(2), JaxUNetConfig(**KW),
                              JaxTrainConfig(**TCFG))
    state = _port_state(jstate)
    xs, ys = _batch(5)
    from plumekit.train.step import make_eval_step as jax_make_eval_step

    want = jax_make_eval_step(0.3)(jstate, jnp.asarray(xs), jnp.asarray(ys))
    got = make_eval_step(0.3)(state, torch.from_numpy(xs),
                              torch.from_numpy(ys))
    assert state.model.training
    assert float(got["loss"]) == pytest.approx(float(want["loss"]),
                                               rel=LOSS_RTOL)
    assert float(got["iou"]) == pytest.approx(float(want["iou"]), abs=1e-6)


@pytest.mark.parametrize("flag", ["use_pallas", "use_mega"])
def test_fused_eval_after_a_step_reads_the_new_weights(flag):
    """The K6 and K7 routes cache folded weights per model; an in-place
    AdamW step (and the batch-norm buffers' update) must change the cache
    key, so an eval through them after a step equals the plain eval of
    the updated weights (the plain versions run here, through the same
    caches)."""
    kw = dict(KW, compute_dtype="bfloat16")
    tcfg = TrainConfig(**{**TCFG, "warmup_steps": 0, "seed": 3})
    state = create_state(UNetConfig(**kw, **{flag: True}), tcfg, "cpu")
    plain = UNet(UNetConfig(**kw))
    step = make_train_step(0.5, augment=False)
    xs, ys = (torch.from_numpy(a) for a in _batch(6))
    if flag == "use_pallas":
        from plumekit_torch.models.fused_forward import _CACHE
    else:
        from plumekit_torch.models.kernels.unet_mega import _CACHE
    for _ in range(2):
        with torch.no_grad():
            state.model.eval()(xs)           # fills the route's cache
        assert state.model in _CACHE
        state, _ = step(state, xs, ys, None)
        state.model.eval()
        plain.load_state_dict(state.model.state_dict())
        with torch.no_grad():
            got = state.model(xs)
            want = plain.eval()(xs)
        # the fused routes fold batch norm into the convs and round at
        # other points (tests/test_torch_unet.py's bf16 bound)
        assert np.abs(got.numpy() - want.numpy()).max() <= 5e-2
        assert np.corrcoef(got.numpy().ravel(),
                           want.numpy().ravel())[0, 1] > 0.999


def test_step_changes_the_route_cache_key():
    """The cache key itself moves with an optimizer step."""
    from plumekit_torch.models.kernels.fused_conv import state_key

    state = create_state(UNetConfig(**KW), TrainConfig(**TCFG, seed=4),
                         "cpu")
    xs, ys = (torch.from_numpy(a) for a in _batch(7))
    before = state_key(state.model, "cpu")
    make_train_step(0.5, augment=False)(state, xs, ys, None)
    assert state_key(state.model, "cpu") != before


def test_weight_decay_applies_to_every_parameter():
    """optax's adamw masks nothing: norm scales, shifts and biases decay."""
    state = create_state(UNetConfig(**dict(KW, norm="none")),
                         TrainConfig(**TCFG), "cpu")
    groups = state.optimizer.param_groups
    assert len(groups) == 1 and groups[0]["weight_decay"] == 1e-2
    assert len(groups[0]["params"]) == len(list(
        state.model.parameters()))
