"""The host side of the whole-forward kernel K7 (``models/kernels/
unet_mega.py``), checked where the kernel cannot run: the fp32 body's
packing and stage table, run through a plain PyTorch interpreter of the
table against the plain version ``mega_forward_ref``; the liveness of the
planes the tables reuse; the split rule of the bottleneck stage."""

import numpy as np
import pytest
import torch

from plumekit_torch.config import UNetConfig
from plumekit_torch.models import build_model
from plumekit_torch.models.kernels import unet_mega


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Plain PyTorch on these small planes gains nothing from torch's
    thread pool, and under parallel test workers the pool's waiting threads
    slow every op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed, **kw):
    cfg = UNetConfig(**{"base_features": 8, "depth": 2, **kw})
    g = torch.Generator().manual_seed(seed)
    model = build_model(cfg, g)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.weight.copy_(torch.rand(n, generator=g) + 0.5)
                m.bias.copy_(0.1 * torch.randn(n, generator=g))
                m.running_mean.copy_(0.1 * torch.randn(n, generator=g))
                m.running_var.copy_(torch.rand(n, generator=g) + 0.5)
            if isinstance(m, torch.nn.ConvTranspose2d):
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return model.eval()


def _f32_interpret(blob, plan, scratch_floats, x):
    """What the fp32 body does with ``plan``, written with PyTorch: every
    plane and weight read from the scratch and the blob at the plan's
    offsets, in the kernel's layouts."""
    blob_f = blob.view(torch.float32)
    scratch = torch.full((scratch_floats,), float("nan"))
    b = x.shape[0]
    logits = None

    def weight(off, shape):
        n = int(np.prod(shape))
        assert off % 256 == 0
        return blob_f[off // 4:off // 4 + n].reshape(shape)

    def plane(off, shape):
        n = int(np.prod(shape))
        assert off >= 0 and off % 64 == 0 and off + n <= scratch_floats
        return scratch[off:off + n].view(shape)

    def conv(inp, w_off, s_off, b_off, cn):
        cin = inp.shape[-1]
        cn8 = -(-cn // unet_mega.F32_GROUP) * unet_mega.F32_GROUP
        w = weight(w_off, (9, cin, cn8))
        assert not w[..., cn:].any()
        k = w[..., :cn].reshape(3, 3, cin, cn).permute(3, 2, 0, 1)
        y = torch.nn.functional.conv2d(inp.permute(0, 3, 1, 2), k, padding=1)
        y = y * weight(s_off, (cn8,))[:cn, None, None] \
            + weight(b_off, (cn8,))[:cn, None, None]
        return torch.relu(y).permute(0, 2, 3, 1)

    for row in plan:
        (kind, h, w, src0, c0, src1, c1, cmid, cout, w1, s1, b1, w2, s2, b2,
         mid, out, aux, upw, upb, up_cout, head_w, head_b, n_out) = \
            (int(v) for v in row)
        inp = x if src0 < 0 else plane(src0, (b, h, w, c0))
        if c1:
            inp = torch.cat([inp, plane(src1, (b, h, w, c1))], dim=-1)
        plane(mid, (b, h, w, cmid)).copy_(conv(inp, w1, s1, b1, cmid))
        y = plane(out, (b, h, w, cout))
        y.copy_(conv(plane(mid, (b, h, w, cmid)), w2, s2, b2, cout))
        if kind == 0:
            plane(aux, (b, h // 2, w // 2, cout)).copy_(
                unet_mega.max_pool_ref(y))
        elif kind == 1:
            cup8 = -(-up_cout // unet_mega.F32_GROUP) * unet_mega.F32_GROUP
            k = weight(upw, (cout, 4, cup8))[..., :up_cout]
            u = (y.reshape(-1, cout) @ k.reshape(cout, -1)).reshape(
                b, h, w, 2, 2, up_cout).permute(0, 1, 3, 2, 4, 5)
            plane(aux, (b, 2 * h, 2 * w, up_cout)).copy_(
                u.reshape(b, 2 * h, 2 * w, up_cout)
                + weight(upb, (cup8,))[:up_cout])
        else:
            hw = weight(head_w, (cout, 8))
            assert not hw[:, n_out:].any()
            logits = y @ hw[:, :n_out] + weight(head_b, (8,))[:n_out]
    return logits


@pytest.mark.parametrize("depth,base,shape", [
    (1, 8, (2, 8, 12)), (2, 12, (3, 16, 8)), (3, 8, (1, 16, 24))])
def test_fp32_packing_and_plan_run_the_plain_version(depth, base, shape):
    """The fp32 body's blob and stage table, interpreted plane by plane,
    give the plain version's logits: every weight sits where the kernel
    reads it, every plane chains to the stage that reads it, and no plane
    overlaps another (each is filled with NaN until written)."""
    model = _model(depth + base, depth=depth, base_features=base,
                   compute_dtype="float32")
    folded = unet_mega.fold_weights(model, torch.float32)
    blob, stages = unet_mega._pack_f32(folded, torch.device("cpu"))
    b, h, w = shape
    plan, scratch = unet_mega._plan_f32(stages, b, h, w)
    assert plan.shape == (2 * depth + 1, unet_mega._F32_FIELDS)
    assert [int(k) for k in plan[:, 0]] == [0] * depth + [1] * depth + [2]
    x = torch.from_numpy(np.random.default_rng(depth).normal(
        size=(b, h, w, 2)).astype(np.float32))
    got = _f32_interpret(blob, plan, scratch, x)
    want = unet_mega.mega_forward_ref(folded, x)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# plan field indices: (kind, H, W, src0, c0, src1, c1, Cout, out, aux,
# up_cout) of the bf16 table and of the fp32 body's; the fp32 one adds mid
BF16_FIELDS = (0, 1, 2, 3, 4, 6, 7, 10, 18, 19, 22)
F32_FIELDS = (0, 1, 2, 3, 4, 5, 6, 8, 16, 17, 20)


def _assert_live(plan, size, b, fields, f32):
    """Runs the table's writes and reads over the scratch, element by
    element: every plane a stage reads holds what its producer wrote (no
    other plane was written over it in between, nor in the stage that
    reads it), and the planes a stage writes do not overlap each other or
    what it reads."""
    owner = np.full(size, -1, np.int64)
    depth = (len(plan) - 1) // 2
    for i, row in enumerate(plan):
        kind, h, w, src0, c0, src1, c1, cout, out, aux, cup = \
            (int(row[j]) for j in fields)
        px = b * h * w
        reads = []
        if src0 >= 0:
            want = 2 * (2 * depth - i) if i > depth else 2 * (i - 1) + 1
            reads.append((src0, px * c0, want))
        if src1 >= 0:
            reads.append((src1, px * c1, 2 * (i - 1) + 1))
        assert (src0 < 0) == (i == 0) and (src1 >= 0) == (i > depth)
        for off, n, want in reads:
            assert off + n <= size
            assert (owner[off:off + n] == want).all(), (i, off, n, want)
        writes = []
        if out >= 0:
            writes.append((out, px * cout, 2 * i))
        if kind == 0:
            writes.append((aux, px // 4 * cout, 2 * i + 1))
        elif kind == 1:
            writes.append((aux, 4 * px * cup, 2 * i + 1))
        if f32:
            writes.append((int(row[15]), px * int(row[7]), -2))
        spans = sorted([(o, n) for o, n, _ in writes]
                       + [(o, n) for o, n, _ in reads])
        assert all(a + n <= c for (a, n), (c, _) in zip(spans, spans[1:])), i
        for off, n, tag in writes:
            assert off >= 0 and off + n <= size
            owner[off:off + n] = tag


@pytest.mark.parametrize("depth", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("b,h,w", [(1, 64, 64), (3, 128, 64), (2, 96, 160)])
def test_no_plane_is_written_while_a_later_stage_reads_it(depth, b, h, w):
    """The stage tables with planes reused, bf16 and fp32, at depths 1-5,
    several tile shapes and batches: liveness holds, and reuse takes less
    scratch than a plane per key from depth 2 on."""
    model = _model(depth, depth=depth, base_features=8)
    for dtype, pack, plan_of, fields, f32 in (
            (torch.bfloat16, unet_mega._pack, unet_mega._plan, BF16_FIELDS,
             False),
            (torch.float32, unet_mega._pack_f32, unet_mega._plan_f32,
             F32_FIELDS, True)):
        _blob, stages = pack(unet_mega.fold_weights(model, dtype),
                             torch.device("cpu"))
        plan, size = plan_of(stages, b, h, w)
        _assert_live(plan, size, b, fields, f32)
        whole, whole_size = plan_of(stages, b, h, w, reuse=False)
        _assert_live(whole, whole_size, b, fields, f32)
        assert size <= whole_size and (size < whole_size or depth == 1)


def _bf16_interpret(folded, plan, size, x):
    """What the bf16 kernel does with ``plan``, each stage's arithmetic by
    the plain version's functions: planes read and written in a NaN-filled
    scratch at the plan's offsets."""
    blocks, ups = folded["blocks"], folded["ups"]
    depth = len(ups)
    scratch = torch.full((size,), float("nan"), dtype=torch.bfloat16)
    b = x.shape[0]
    logits = None

    def plane(off, h, w, c):
        assert off >= 0 and off % 128 == 0
        return scratch[off:off + b * h * w * c].view(b, h, w, c)

    for i, row in enumerate(plan):
        kind, h, w, src0, c0, src1, c1, cout, out, aux, cup = (
            int(row[j]) for j in BF16_FIELDS)
        inp = x if src0 < 0 else plane(src0, h, w, c0)
        if src1 >= 0:
            inp = torch.cat([inp, plane(src1, h, w, c1)], dim=-1)
        y = unet_mega.double_conv_ref(inp, blocks[i], out_f32=kind == 2)
        if kind == 2:
            logits = y.float() @ folded["head_w"] + folded["head_b"]
            continue
        plane(out, h, w, cout).copy_(y)
        if kind == 0:
            plane(aux, h // 2, w // 2, cout).copy_(unet_mega.max_pool_ref(y))
        else:
            plane(aux, 2 * h, 2 * w, cup).copy_(
                unet_mega.conv_transpose_ref(y, ups[i - depth]))
    return logits, scratch


@pytest.mark.parametrize("depth,base,shape", [
    (2, 8, (2, 16, 24)), (3, 12, (1, 32, 16))])
def test_bf16_plan_runs_the_plain_version_and_the_stage_check_reads_it(
        depth, base, shape):
    """The bf16 stage table, with planes reused and without, interpreted
    plane by plane, gives the plain version's logits bit for bit; on the
    table without reuse (the debug form's) the per-stage check finds every
    stage exact, and a value changed in one plane fails that stage alone."""
    model = _model(depth * base, depth=depth, base_features=base)
    folded = unet_mega.fold_weights(model, torch.bfloat16)
    _blob, stages = unet_mega._pack(folded, torch.device("cpu"))
    b, h, w = shape
    x = torch.from_numpy(np.random.default_rng(base).normal(
        size=(b, h, w, 2)).astype(np.float32)).to(torch.bfloat16)
    want = unet_mega.mega_forward_ref(folded, x)
    for reuse in (True, False):
        plan, size = unet_mega._plan(stages, b, h, w, reuse=reuse)
        logits, scratch = _bf16_interpret(folded, plan, size, x)
        assert torch.equal(logits, want)
    weights = unet_mega.MegaWeights(folded)
    rows = unet_mega.stage_errors(weights, x, logits, scratch, plan)
    assert [r["kind"] for r in rows] == ["pool"] * depth + ["up"] * depth \
        + ["head"]
    assert all(v["ratio"] == 0.0 for r in rows for k, v in r.items()
               if isinstance(v, dict))
    # one skip value of level 1 off by 0.25: stage 1's own output fails,
    # and otherwise at most the decoder stage that reads that skip (each
    # stage is fed the planes as they are)
    off = int(plan[1, 18])
    scratch[off + 5] += 0.25
    rows = unet_mega.stage_errors(weights, x, logits, scratch, plan)
    failed = [(r["stage"], k) for r in rows for k, v in r.items()
              if isinstance(v, dict) and v["ratio"] > 1.0]
    assert failed[0] == (1, "out")
    assert {stage for stage, _ in failed} <= {1, 2 * depth - 1}


@pytest.mark.parametrize("kind,items,cout_p,cup_p,blocks,want", [
    (1, 64, 512, 256, 132, 2),     # 96² bottleneck: 64 items, 132 SMs
    (1, 384, 512, 256, 132, 1),    # 288² bottleneck: three waves already
    (1, 66, 512, 256, 132, 2),     # exactly two halves per block
    (1, 67, 512, 256, 132, 1),
    (0, 4, 256, 0, 132, 2),        # a pool stage pools its half's channels
    (0, 4, 128, 0, 132, 1),        # one pass: nothing to share
    (2, 1, 256, 0, 132, 1),        # the head sums all channels
    (1, 4, 256, 32, 132, 1),       # the upsample has one pass of columns
    (1, 64, 512, 256, None, 1)])   # no grid size known: no split
def test_split_rule(kind, items, cout_p, cup_p, blocks, want):
    st = {"kind": kind, "cout_p": cout_p, "up_cout_p": cup_p, "up_kp": 512,
          "cmid_p": 512}
    tile = unet_mega.conv_tiles.Tile("wgmma", 6, 6, 2, 0, 1.0)
    assert unet_mega.stage_split(st, tile, items, blocks) == want
    mma = unet_mega.conv_tiles.Tile("mma", 16, 16, 1, 0, 1.0)
    assert unet_mega.stage_split(st, mma, items, blocks) == 1


def test_split_stages_of_the_flagship_at_96_and_288():
    """Only the bottleneck of 128 tiles of 96² splits on a 132-SM card; its
    flags get their own room; one 96² tile splits every wgmma stage that
    has two passes."""
    model = _model(0, depth=4, base_features=32)
    folded = unet_mega.fold_weights(model, torch.bfloat16)
    _blob, stages = unet_mega._pack(folded, torch.device("cpu"))
    for (b, t), want in {(128, 96): [1, 1, 1, 1, 2, 1, 1, 1, 1],
                         (128, 288): [1] * 9,
                         (1, 96): [1, 1, 1, 2, 2, 2, 1, 1, 1]}.items():
        plan, size = unet_mega._plan(stages, b, t, t, blocks=132)
        assert [int(v) for v in plan[:, 32]] == want
        for i, row in enumerate(plan):
            if row[32] == 2 and row[0] == 1:
                # the kernel zeroes the counters when it starts: no plane of
                # stages 0 .. i may share their room
                flags = (int(row[33]), 2 * 64)
                assert 0 <= flags[0] and flags[0] + flags[1] <= size
                for prior in plan[:i + 1]:
                    kind, h, w, src0, c0, src1, c1, cout, out, aux, cup = (
                        int(v) for v in prior[list(BF16_FIELDS)])
                    px = b * h * w
                    spans = [(src0, px * c0), (src1, px * c1),
                             (out, px * cout),
                             (aux, px // 4 * cout if kind == 0
                              else 4 * px * cup)]
                    for off, n in spans:
                        if off >= 0 and n > 0:
                            assert (off + n <= flags[0]
                                    or flags[0] + flags[1] <= off)
            else:
                assert row[33] == -1
        if b == 1:                     # element by element: small scratch
            _assert_live(plan, size, b, BF16_FIELDS, False)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_stage_table_round_trips_through_ints_and_plans_by_value(dtype):
    """The op takes the stage table as ints: decoded, it gives every plan
    the packed table gives, and the plan of a batch is looked up by the
    table's value (two packings of two models share it), never by a
    tensor's address."""
    pack = unet_mega._pack if dtype == torch.bfloat16 else \
        unet_mega._pack_f32
    plan_fn = unet_mega._plan if dtype == torch.bfloat16 else \
        unet_mega._plan_f32
    tables = []
    for seed in (5, 6):
        model = _model(seed, depth=2, base_features=8)
        weights = unet_mega.MegaWeights(unet_mega.fold_weights(model, dtype))
        weights.blob, weights.stages = pack(weights.folded,
                                            torch.device("cpu"))
        tables.append(weights.ints)
    assert tables[0] == tables[1]
    stages = unet_mega.stages_of(tables[0])
    for b in (1, 4):
        kw = {"blocks": 132} if dtype == torch.bfloat16 else {}
        want, size = plan_fn(weights.stages, b, 32, 32, **kw)
        got, got_size = plan_fn(stages, b, 32, 32, **kw)
        assert size == got_size and np.array_equal(got, want)
        arr, elems, plan = unet_mega._plan_of(
            tables[1], b, 32, 32, False, dtype == torch.float32, 132)
        assert elems == size and np.array_equal(plan, want)
        assert list(arr) == want.ravel().tolist()
        assert unet_mega._plan_of(tables[0], b, 32, 32, False,
                                  dtype == torch.float32, 132)[0] is arr