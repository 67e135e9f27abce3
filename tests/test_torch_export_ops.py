"""The five hand-written kernels as ``torch.library`` custom ops (K5, K6,
K7, Q1, Q2): ``torch.library.opcheck`` of each at two shapes on the CPU
(schema, fake implementation against the real one, strides included, and
the op under AOT dispatch with dynamic shapes), their registration (a CPU
and a CUDA implementation and a fake one, no fallback that a CUDA tensor
could take instead of the kernel), the entries' CPU results through the ops
equal to the plain versions, and each op appearing in a ``torch.export``
graph. The CUDA implementations run in ``tests/test_torch_kernels_cuda.py``
on the card, and Q2's under ``opcheck`` here (marked ``cuda``: it skips
without a card)."""

import numpy as np
import pytest
import torch

from plumekit_torch.config import UNetConfig
from plumekit_torch.models import build_model
from plumekit_torch.models.kernels import (fused_conv, int8_conv,
                                           int8_upsample, unet_mega)

OPS = {"fused_conv3x3": fused_conv.fused_conv3x3_op,
       "fused_double_conv3x3": fused_conv.fused_double_conv3x3_op,
       "unet_mega": unet_mega.unet_mega_op,
       "int8_conv3x3": int8_conv.int8_conv3x3_op,
       "int8_upsample2x2": int8_upsample.int8_upsample2x2_op}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f32(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape))
                            .astype(np.float32))


def _i8(rng, shape):
    return torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))


def _args(name, case):
    """The op's CPU arguments at one of two shapes."""
    rng = np.random.default_rng(case)
    if name == "fused_conv3x3":
        b, h, w, cin, cout = [(2, 8, 8, 3, 5), (1, 6, 10, 8, 16)][case]
        x = _f32(rng, (b, h, w, cin)).to([torch.float32,
                                          torch.bfloat16][case])
        return (x, _f32(rng, (3, 3, cin, cout), 0.3), _f32(rng, (cout,)),
                _f32(rng, (cout,)), cout)
    if name == "fused_double_conv3x3":
        b, h, w, cin, cmid, cout = [(2, 8, 8, 2, 4, 6),
                                    (1, 12, 6, 8, 16, 8)][case]
        x = _f32(rng, (b, h, w, cin)).to([torch.float32,
                                          torch.bfloat16][case])
        return (x, _f32(rng, (3, 3, cin, cmid), 0.3), _f32(rng, (cmid,)),
                _f32(rng, (cmid,)), _f32(rng, (3, 3, cmid, cout), 0.3),
                _f32(rng, (cout,)), _f32(rng, (cout,)), cmid, cout)
    if name == "unet_mega":
        depth, base, dtype, (b, h, w) = [
            (1, 4, torch.float32, (2, 8, 8)),
            (2, 8, torch.bfloat16, (1, 16, 12))][case]
        cfg = UNetConfig(base_features=base, depth=depth)
        model = build_model(cfg, torch.Generator().manual_seed(case)).eval()
        flat = unet_mega.folded_list(unet_mega.fold_weights(model, dtype))
        return (_f32(rng, (b, h, w, 2)).to(dtype), flat, [],
                cfg.out_channels)
    if name == "int8_conv3x3":
        b, h, w, c0, c1, cout, scaled = [(2, 8, 8, 2, 0, 8, True),
                                         (1, 6, 6, 8, 4, 16, False)][case]
        x = _i8(rng, (b, h, w, c1 or c0))
        skip = _i8(rng, (b, h, w, c0)) if c1 else None
        scale = torch.tensor(0.5, dtype=torch.float32) if scaled else None
        return (x, _i8(rng, (3, 3, c0 + c1, cout)),
                _f32(rng, (cout,), 1e-3), _f32(rng, (cout,)), scale, skip,
                cout)
    b, h, w, cin, cout = [(2, 4, 4, 8, 4), (1, 3, 5, 16, 8)][case]
    return (_i8(rng, (b, h, w, cin)), _i8(rng, (2, 2, cin, cout)),
            _f32(rng, (cout,), 1e-3), _f32(rng, (cout,)),
            torch.tensor(0.25, dtype=torch.float32), cout)


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name", list(OPS))
def test_opcheck(name, case):
    torch.library.opcheck(OPS[name], _args(name, case))


@pytest.mark.parametrize("name", list(OPS))
def test_registered_for_cpu_and_cuda_with_a_fake_and_no_fallback(name):
    """A CUDA tensor reaches the kernel's implementation, never a
    composite that runs the plain version; the fake one serves tracing."""
    qual = f"plumekit::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qual, "CPU") and has(qual, "CUDA") and has(qual, "Meta")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd"):
        assert not has(qual, key)


@pytest.mark.parametrize("name", list(OPS))
def test_cpu_op_is_the_plain_version_and_fake_matches(name):
    args = _args(name, 0)
    got = OPS[name](*args)
    if name == "fused_conv3x3":
        want = fused_conv.conv3x3_bn_relu_ref(*args[:4])
    elif name == "fused_double_conv3x3":
        want = fused_conv.double_conv3x3_bn_relu_ref(*args[:7])
    elif name == "unet_mega":
        want = unet_mega.mega_forward_ref(unet_mega.folded_of(args[1]),
                                          args[0])
    elif name == "int8_conv3x3":
        x, w, a, b, scale, skip, _ = args
        want = int8_conv.int8_conv3x3_ref(x, w, a, b, scale, skip)
    else:
        want = int8_upsample.int8_upsample2x2_ref(*args[:5])
    assert torch.equal(got, want)
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else
            [t.to("meta") for t in a] if isinstance(a, list) else a
            for a in args]
    fake = OPS[name](*meta)
    assert fake.shape == got.shape and fake.dtype == got.dtype
    assert fake.stride() == got.stride()


def _is_input(v):
    return isinstance(v, torch.Tensor) or (
        isinstance(v, list) and bool(v) and isinstance(v[0], torch.Tensor))


@pytest.mark.parametrize("name", list(OPS))
def test_op_is_one_node_of_an_exported_graph(name):
    args = _args(name, 1)
    op = OPS[name]

    class Call(torch.nn.Module):
        def forward(self, *inputs):
            it = iter(inputs)
            return op(*[next(it) if _is_input(v) else v for v in args])

    inputs = tuple(v for v in args if _is_input(v))
    ep = torch.export.export(Call(), inputs, strict=False)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function"
             and str(n.target).startswith(f"plumekit.{name}")]
    assert len(nodes) == 1
    assert torch.equal(ep.module()(*inputs), op(*args))


def test_entries_refuse_devices_without_a_kernel():
    """The wrappers give no device but the CPU and the card to the ops (the
    fake implementation would answer a meta tensor with an empty one)."""
    args = _args("int8_upsample2x2", 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        int8_upsample.int8_upsample2x2(args[0].to("meta"), *args[1:5])
    args = _args("int8_conv3x3", 0)
    with pytest.raises(ValueError, match="no kernel for device"):
        int8_conv.int8_conv3x3(args[0].to("meta"), *args[1:4])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [0, 1])
def test_opcheck_of_the_int8_upsample_kernel_on_the_card(case):
    """Q2's CUDA implementation (``csrc/int8_upsample.cu``) under
    ``torch.library.opcheck`` on weights packed for it: its schema, its
    fake implementation against the kernel's output, strides included, and
    the op under AOT dispatch. Case 0 takes the kernel's TMA path (channels
    in whole chunks), case 1 its plain loads and stores."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    card = torch.device("cuda")
    rng = np.random.default_rng(20 + case)
    b, h, w, cin, cout = [(2, 5, 7, 64, 32), (1, 3, 5, 16, 8)][case]
    kq, sw, bias = (_i8(rng, (2, 2, cin, cout)).to(card),
                    _f32(rng, (cout,), 1e-3).to(card),
                    _f32(rng, (cout,)).to(card))
    packed = int8_upsample.pack_upsample(kq, sw, bias)
    x = _i8(rng, (b, h, w, cin)).to(card)
    scale = torch.tensor(0.25, dtype=torch.float32, device=card)
    torch.library.opcheck(int8_upsample.int8_upsample2x2_op,
                          (x, packed.wt, packed.a, packed.b, scale, cout))
    assert torch.equal(
        int8_upsample.int8_upsample2x2_op(x, packed.wt, packed.a, packed.b,
                                          scale, cout),
        int8_upsample.int8_upsample2x2_ref(x, kq, sw, bias, scale))
