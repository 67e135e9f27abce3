"""``serve`` of plumekit_torch against the JAX package's: the loop
(``scan_pending``, ``serve_loop``: worklog, settle guard, sorted order, the
four exits) on the same directories; resume, watch mode, quarantine and
int8 deferral through the CLI on the CPU (``tests/test_serve.py``'s cases);
both CLIs' ``serve --once`` on one root writing the same prediction files
and logs for the plain, ``--fused``, ``use_mega`` and ``--int8`` forwards;
a kernel's launch error stopping serve with exit 1 and quarantining nothing;
and the refusals."""

import logging
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

from plumekit.cli import main as jax_main
from plumekit.config.train import TrainConfig
from plumekit.config.train import UNetConfig as JaxUNetConfig
from plumekit.infer import serve as jax_serve
from plumekit.train.checkpoint import WorkLog as JaxWorkLog
from plumekit.train.state import create_state
from plumekit_torch import cli
from plumekit_torch.config import UNetConfig
from plumekit_torch.convert import from_flax
from plumekit_torch.infer import serve
from plumekit_torch.models import build_model
from plumekit_torch.models import fused_forward
from plumekit_torch.train.checkpoint import (WorkLog, save_model_config,
                                             save_weights)
from test_torch_cli import KW, PROB_TOL, SERVE, _granule, _root
from test_torch_int8_cli import KW as KW8
from test_torch_int8_cli import PROB_ATOL as INT8_PROB_ATOL

ONCE = ["--once", "--settle", "0", "--device", "cpu"] + SERVE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small plain-PyTorch ops gain nothing from torch's thread pool, and
    under parallel test workers its waiting threads slow them many times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- the loop

def _touch(d, name, age=60.0):
    path = os.path.join(d, name)
    with open(path, "wb") as f:
        f.write(b"granule")
    if age:
        old = time.time() - age
        os.utime(path, (old, old))
    return path


def test_scan_pending_matches_jax(tmp_path):
    """The worklog, the settle guard, the extensions and sorted order, and
    a missing directory, through both packages' scan on the same
    directory with their own logs."""
    d = str(tmp_path / "gr")
    os.makedirs(d)
    a, b = _touch(d, "b.npz"), _touch(d, "a.npz")
    _touch(d, "notes.txt")
    logs = (JaxWorkLog(str(tmp_path / "jax.txt")),
            WorkLog(str(tmp_path / "port.txt")))

    def both(settle, scan_dir=d):
        got = [scan(scan_dir, log, (".npz", ".h5"), settle_s=settle)
               for scan, log in zip((jax_serve.scan_pending,
                                     serve.scan_pending), logs)]
        assert got[0] == got[1]
        return got[1]

    assert both(2.0) == [b, a]
    for log in logs:
        log.mark("a.npz")
    assert both(2.0) == [a]
    c = _touch(d, "c.h5", age=0)          # still being written
    assert both(5.0) == [a]
    old = time.time() - 60
    os.utime(c, (old, old))
    assert both(5.0) == [a, c]
    assert both(0.0, str(tmp_path / "nope")) == []


def _stats(s):
    return (s.cycles, s.served, s.deferred_last_cycle, s.errors, s.stopped_by)


@pytest.mark.parametrize("case", ["once", "max_cycles", "idle", "stop_event",
                                  "errors"])
def test_serve_loop_matches_jax(tmp_path, case):
    """Each exit, and a processor that raises, through both loops on the
    same directory: the same batches handed to the processor and the same
    ``ServeStats``."""
    d = str(tmp_path / "gr")
    os.makedirs(d)
    if case != "idle":
        for name in ("g2.npz", "g0.npz", "g1.npz"):
            _touch(d, name)
    out = {}
    for pkg, log_cls in (("jax", JaxWorkLog), ("port", WorkLog)):
        log = log_cls(str(tmp_path / f"{pkg}.txt"))
        seen = []

        def process(paths, log=log, seen=seen):
            seen.append([os.path.basename(p) for p in paths])
            if case == "errors":
                raise OSError("disk full")
            if case == "once":
                for p in paths:
                    log.mark(os.path.basename(p))
                return len(paths)
            return 0

        kw = dict(poll_s=0.01, settle_s=0.0)
        if case == "once":
            kw["once"] = True
        elif case in ("max_cycles", "errors"):
            kw["max_cycles"] = 3
        elif case == "idle":
            kw["idle_exit"] = 2
        else:
            kw["stop_event"] = threading.Event()
            kw["stop_event"].set()
        loop = jax_serve.serve_loop if pkg == "jax" else serve.serve_loop
        out[pkg] = (_stats(loop(d, log, process, (".npz",), **kw)), seen)
    assert out["port"] == out["jax"]
    assert out["port"][0][-1] == {"errors": "max_cycles"}.get(case, case)


def test_union_log_and_stats_fields():
    a, b = {"x.npz"}, {"y.npz"}

    class Log:
        def __init__(self, items):
            self._items = items

        def items(self):
            return set(self._items)

        def done(self, item):
            return item in self._items

    for union in (serve.UnionLog(Log(a), Log(b)),
                  jax_serve.UnionLog(Log(a), Log(b))):
        assert union.items() == a | b
        assert union.done("y.npz") and not union.done("z.npz")
    assert _stats(serve.ServeStats()) == _stats(jax_serve.ServeStats())


# ------------------------------------------------------------------ the CLI

def _maiac(root):
    return os.path.join(root, "raw", "plume_identification", "maiac")


def _put(root, name, seed, null=False):
    g = _granule(seed, name)
    if null:
        g.layers["2020001A"][:] = 0.0
    from plumekit_torch.io.granule import save_granule

    save_granule(os.path.join(_maiac(root), f"{name}.npz"), g)


def _outs(root):
    out = os.path.join(root, "processed", "predictions")
    return sorted(f for f in os.listdir(out) if f.endswith("_pred.npz"))


def _predictions(root):
    out = os.path.join(root, "processed", "predictions")
    preds = {}
    for f in _outs(root):
        with np.load(os.path.join(out, f)) as d:
            preds[f] = {k: d[k] for k in d.files}
    return preds


def _log(root, name):
    path = os.path.join(root, "processed", "predictions", name)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().split()


def test_serve_once_resume_idempotent(tmp_path):
    """``--once`` serves the backlog; a second run serves only the new
    arrival, and a done granule whose output was deleted is not served
    again (the worklog is the record)."""
    root, _ckpt = _root(tmp_path)
    assert cli.main(["serve", "--root", root] + ONCE) == 0
    assert _outs(root) == ["g0_pred.npz", "g1_pred.npz"]
    assert _log(root, "served_granules.txt") == ["g0.npz", "g1.npz"]
    pred = _predictions(root)["g0_pred.npz"]
    assert pred["probs"].shape == (64, 64) and pred["mask"].dtype == bool
    os.remove(os.path.join(root, "processed", "predictions", "g0_pred.npz"))
    _put(root, "g2", 3)
    assert cli.main(["serve", "--root", root] + ONCE) == 0
    assert _outs(root) == ["g1_pred.npz", "g2_pred.npz"]
    assert _log(root, "served_granules.txt") == ["g0.npz", "g1.npz", "g2.npz"]


def test_serve_watch_picks_up_a_new_granule(tmp_path):
    """Watch mode: a granule dropped in during the run is served on a later
    scan; ``--idle-exit`` then ends the loop."""
    root, _ckpt = _root(tmp_path)
    out = os.path.join(root, "processed", "predictions")
    rc = {}

    def run():
        # 120 empty scans of 0.05 s: a loaded host may lag seconds behind
        rc["code"] = cli.main(["serve", "--root", root, "--device", "cpu",
                               "--poll", "0.05", "--idle-exit", "120",
                               "--settle", "0"] + SERVE)

    t = threading.Thread(target=run)
    t.start()
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not os.path.exists(
                os.path.join(out, "g1_pred.npz")):
            time.sleep(0.05)
        assert os.path.exists(os.path.join(out, "g1_pred.npz"))
        _put(root, "g2", 3)
        t.join(timeout=120)
        assert not t.is_alive(), "serve did not idle-exit"
    finally:
        t.join(timeout=1)
    assert rc["code"] == 0
    assert _outs(root) == ["g0_pred.npz", "g1_pred.npz", "g2_pred.npz"]


def test_serve_quarantines_a_poison_granule(tmp_path):
    """A corrupt upload fails the batched pass; per-granule isolation finds
    it, quarantines it, serves the good granules, and ``--once`` exits 1;
    the next run does not try it again."""
    root, _ckpt = _root(tmp_path)
    with open(os.path.join(_maiac(root), "a_corrupt.npz"), "wb") as f:
        f.write(b"this is not an npz archive")
    assert cli.main(["serve", "--root", root] + ONCE) == 1
    assert _outs(root) == ["g0_pred.npz", "g1_pred.npz"]
    assert _log(root, "failed_granules.txt") == ["a_corrupt.npz"]
    _put(root, "g2", 3)
    assert cli.main(["serve", "--root", root] + ONCE) == 0
    assert _outs(root) == ["g0_pred.npz", "g1_pred.npz", "g2_pred.npz"]
    assert _log(root, "failed_granules.txt") == ["a_corrupt.npz"]


def test_serve_int8_defers_until_a_granule_with_signal(tmp_path):
    """An all-null backlog under ``--int8`` serves and marks nothing (its
    scales would be degenerate); once a granule with signal lands, the
    whole backlog is served."""
    root, _ckpt = _root(tmp_path)
    for name in ("g0.npz", "g1.npz"):
        os.remove(os.path.join(_maiac(root), name))
    _put(root, "ocean", 5, null=True)
    assert cli.main(["serve", "--root", root, "--int8"] + ONCE) == 0
    assert _outs(root) == []
    assert _log(root, "served_granules.txt") == []
    assert _log(root, "failed_granules.txt") == []
    _put(root, "land", 6)
    assert cli.main(["serve", "--root", root, "--int8"] + ONCE) == 0
    assert _outs(root) == ["land_pred.npz", "ocean_pred.npz"]
    assert _log(root, "served_granules.txt") == ["land.npz", "ocean.npz"]


@pytest.mark.parametrize("forward", ["plain", "fused", "use_mega", "int8"])
def test_serve_once_matches_the_jax_cli(tmp_path, forward):
    """``plumekit serve --once`` and the port's ``serve --once --device
    cpu`` on copies of one root (a corrupt upload among the granules) on
    the JAX trainer's PRNGKey(0) initial weights: the same prediction files,
    the same ``served_granules.txt`` and ``failed_granules.txt``, exit 1
    from both, and probabilities within the port's bound for the forward."""
    kw = KW8 if forward == "int8" else KW
    root = str(tmp_path / "root")
    os.makedirs(_maiac(root))
    for i, name in enumerate(("g0", "g1", "g2")):
        _put(root, name, i + 1)
    with open(os.path.join(_maiac(root), "a_corrupt.npz"), "wb") as f:
        f.write(b"truncated upload")
    ckpt = os.path.join(root, "models", "checkpoints")
    save_model_config(ckpt, UNetConfig(**kw, use_mega=forward == "use_mega"))
    state = create_state(jax.random.PRNGKey(0), JaxUNetConfig(**kw),
                         TrainConfig())
    model = build_model(UNetConfig(**kw))
    model.load_state_dict(from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats})))
    save_weights(ckpt, model)
    flags = {"fused": ["--fused"], "int8": ["--int8"]}.get(forward, [])
    jax_root = str(tmp_path / "jax")
    shutil.copytree(root, jax_root)
    assert jax_main(["serve", "--root", jax_root, "--once", "--settle", "0"]
                    + SERVE + flags) == 1
    assert cli.main(["serve", "--root", root] + ONCE + flags) == 1
    assert _outs(root) == _outs(jax_root) == ["g0_pred.npz", "g1_pred.npz",
                                              "g2_pred.npz"]
    for log in ("served_granules.txt", "failed_granules.txt"):
        assert _log(root, log) == _log(jax_root, log)
    assert _log(root, "failed_granules.txt") == ["a_corrupt.npz"]
    got, want = _predictions(root), _predictions(jax_root)
    atol = INT8_PROB_ATOL if forward == "int8" else PROB_TOL
    for f in _outs(root):
        p, q = got[f]["probs"], want[f]["probs"]
        assert p.shape == q.shape == (64, 64) and p.dtype == np.float32
        np.testing.assert_allclose(p, q, atol=atol, rtol=0)
        sure = np.abs(q - 0.5) > atol
        np.testing.assert_array_equal(got[f]["mask"][sure],
                                      want[f]["mask"][sure])


@pytest.mark.parametrize("exc,quarantined,rc", [
    (RuntimeError("fused double-conv kernel launch failed: unspecified "
                  "launch failure"), False, 1),
    (torch.AcceleratorError("CUDA error: an illegal memory access was "
                            "encountered") if hasattr(torch,
                                                      "AcceleratorError")
     else RuntimeError("CUDA error: an illegal memory access"), False, 1),
    (torch.OutOfMemoryError("CUDA out of memory"), True, 1),
    (ValueError("no tile of a 64x64 plane fits"), True, 1)],
    ids=["launch_error", "cuda_error", "out_of_memory", "shape_refused"])
@pytest.mark.parametrize("mode", ["once", "watch"])
def test_a_device_fault_is_no_granules_fault(tmp_path, monkeypatch, caplog,
                                             exc, quarantined, rc, mode):
    """A forward that raises a kernel's launch error or a CUDA error stops
    serve with exit 1 and quarantines nothing, in ``--once`` and in watch
    mode; out of memory and a refused shape are the granule's own and
    quarantine it, as in the JAX CLI."""
    root, _ckpt = _root(tmp_path)

    def broken(*_args, **_kw):
        raise exc

    monkeypatch.setattr(fused_forward, "_double_conv", broken)
    flags = ["--once"] if mode == "once" else ["--poll", "0.05",
                                               "--idle-exit", "40"]
    with caplog.at_level(logging.ERROR):
        got = cli.main(["serve", "--root", root, "--device", "cpu",
                        "--settle", "0", "--fused"] + SERVE + flags)
    assert _outs(root) == [] and _log(root, "served_granules.txt") == []
    if quarantined:
        assert _log(root, "failed_granules.txt") == ["g0.npz", "g1.npz"]
        assert got == (rc if mode == "once" else 0)
    else:
        assert got == rc
        assert _log(root, "failed_granules.txt") == []
        assert "no granule's fault" in caplog.text


def test_serve_once_on_a_cpu_mesh_writes_the_one_device_files(tmp_path):
    """``serve --once --mesh-devices 2 --batch-granules 2`` on the CPU (two
    replicas, groups of four, a ragged tail of one): the one-device
    ``serve --once``'s prediction files and worklog (probs within 1e-5,
    masks equal), and the JAX CLI's ``--mesh-devices 2`` on its virtual CPU
    devices within the predict parity tolerance."""
    from test_torch_cli import _mesh_roots

    mesh_root, one_root, jax_root = _mesh_roots(tmp_path)
    argv = ["serve"] + ONCE + ["--batch-granules", "2"]
    assert cli.main(argv + ["--root", mesh_root, "--mesh-devices", "2"]) == 0
    assert cli.main(argv + ["--root", one_root]) == 0
    assert jax_main(["serve", "--root", jax_root, "--once", "--settle", "0",
                     "--mesh-devices", "2", "--batch-granules", "2"]
                    + SERVE) == 0
    names = [f"g{i}_pred.npz" for i in range(5)]
    assert _outs(mesh_root) == _outs(one_root) == _outs(jax_root) == names
    assert _log(mesh_root, "served_granules.txt") \
        == _log(one_root, "served_granules.txt") \
        == _log(jax_root, "served_granules.txt")
    got, one, want = (_predictions(r) for r in (mesh_root, one_root,
                                                jax_root))
    for f in names:
        np.testing.assert_allclose(got[f]["probs"], one[f]["probs"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[f]["mask"], one[f]["mask"])
        q = want[f]["probs"]
        np.testing.assert_allclose(got[f]["probs"], q, atol=PROB_TOL, rtol=0)
        sure = np.abs(q - 0.5) > PROB_TOL
        np.testing.assert_array_equal(got[f]["mask"][sure],
                                      want[f]["mask"][sure])


@pytest.mark.parametrize("flags", [["--plot"]])
def test_serve_refuses_unported_flags(tmp_path, caplog, monkeypatch, flags):
    """``--plot`` is ported; where matplotlib is absent ``serve`` exits 1
    naming matplotlib, before any granule is served."""
    root, _ckpt = _root(tmp_path)
    for mod in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with caplog.at_level(logging.ERROR):
        assert cli.main(["serve", "--root", root] + ONCE + flags) == 1
    assert "needs matplotlib" in caplog.text
    assert "not ported" not in caplog.text
    assert not os.path.exists(os.path.join(root, "processed"))


@pytest.mark.parametrize("command", ["serve", "tune"])
def test_missing_cuda_is_an_error_not_a_fallback(tmp_path, caplog, command):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, _ckpt = _root(tmp_path)
    argv = [command, "--root", root] + (
        ["--once", "--settle", "0"] if command == "serve" else
        ["--granule", "64", "--candidates", "32/0/4"])
    with caplog.at_level(logging.ERROR):
        assert cli.main(argv) == 1
    assert "CUDA is not available" in caplog.text
    assert not os.path.exists(os.path.join(root, "processed", "predictions",
                                           "served_granules.txt"))
    assert not os.path.exists(os.path.join(root, "models",
                                           "tuned_geometry.json"))
