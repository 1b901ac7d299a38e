"""The train step and ``profile_attention``'s timed call as captured CUDA
graphs (``serving.graphs.CapturedFn``, the counterpart of the reference's
``@jax.jit step_fn`` and jitted ``decode_attn``).

On the CPU: ``adamw_update`` advances the step counter in place (a graph
replays over the tensors it was captured on) with the reference's values,
and the capture path runs through a stand-in for the card's graphs
(``test_torch_graphs.RecordingGraphs``; here its capture also puts back
every tensor it was handed, since a real capture runs nothing): captured
training equals eager training bit for bit, launch counts included, a
restore captures anew, and ``profile_attention`` captures each grid point
once and replays it.  ``tests/test_torch_cuda.py`` captures the same
calls on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_graphs import RecordingGraphs
from repro.training import optimizer as jopt
from repro_torch.configs import smoke_config
from repro_torch.core import profiler
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.serving import graphs
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop
from repro_torch.training.data import DataConfig
from repro_torch.training.train_loop import TrainConfig, train
from repro_torch.training.tree import flatten
from repro_torch.weights import init_params


def test_adamw_advances_the_step_in_place_with_the_reference_values():
    """Three updates of a two-leaf tree: ``opt["step"]`` stays the same
    tensor and counts 1, 2, 3; parameters and moments equal the
    reference's to fp32 rounding."""
    rng = np.random.default_rng(1)
    p_np = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32)}}
    jp = jax.tree.map(jnp.asarray, p_np)
    p = jax.tree.map(lambda a: torch.from_numpy(a.copy()), p_np)
    jst, st = jopt.adamw_init(jp), opt.adamw_init(p)
    counter = st["step"]
    for i in range(3):
        g_np = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), p_np)
        jp, jst, _ = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                       jst, lr=1e-2)
        p, st, _ = opt.adamw_update(p, jax.tree.map(torch.from_numpy, g_np),
                                    st, lr=1e-2)
        assert st["step"] is counter and int(counter) == int(jst["step"]) \
            == i + 1
    for tree, jtree in ((p, jp), (st["m"], jst["m"]), (st["v"], jst["v"])):
        for a, b in zip(flatten(tree)[0], jax.tree.leaves(jtree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


class StandIn(RecordingGraphs):
    """``RecordingGraphs`` whose capture leaves every tensor it was handed
    as it found it: a real capture runs no kernel, so the captured step
    must not train the model a second time."""

    def capture(self, fn, args):
        saved = [t.detach().clone() for t in graphs._leaves(args)]
        try:
            return super().capture(fn, args)
        finally:
            with torch.no_grad():
                for t, s in zip(graphs._leaves(args), saved):
                    t.copy_(s)


CFG = dataclasses.replace(smoke_config("qwen3-14b"), n_layers=2)
DCFG = DataConfig(CFG.vocab_size, seq_len=24, global_batch=2)


@pytest.fixture
def counted(monkeypatch):
    """B3's wrapper counting its calls on CPU tensors as it counts its
    launches on the card, the launch counts from 0."""
    kernel = fa_ops.flash_attention

    def counting(*a, **kw):
        fa_ops.LAUNCHES["flash_attention"] += 1
        return kernel(*a, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    saved = dict(fa_ops.LAUNCHES)
    for k in fa_ops.LAUNCHES:
        fa_ops.LAUNCHES[k] = 0
    yield fa_ops.LAUNCHES
    fa_ops.LAUNCHES.update(saved)


def run(steps, stand_in=None, **tcfg):
    """``train`` on the CPU, on the stand-in's graphs when given."""
    if stand_in is not None:
        train_loop.CudaGraphs = lambda dev: stand_in
    try:
        return train(CFG, DCFG, TrainConfig(steps=steps, lr=1e-3,
                                            device="cpu", **tcfg),
                     params=init_params(CFG, 0, device="cpu"))
    finally:
        train_loop.CudaGraphs = graphs.CudaGraphs


def test_captured_training_equals_eager_training(counted):
    """Four steps: the first runs and is captured, the other three
    replay; losses and parameters bit-equal to the eager run's, and the
    launch counts of the replays added."""
    stand_in = StandIn()
    got = run(4, stand_in)
    launches = dict(counted)
    for k in counted:
        counted[k] = 0
    with graphs.disable_capture():
        want = run(4, StandIn())
    assert stand_in.log == ["run", "capture", "replay", "replay", "replay"]
    assert got["graphs"]["graphs"] == 1 and got["graphs"]["replays"] == 3
    assert want["graphs"] == {"graphs": 0, "replays": 0, "capture_s": []}
    assert got["losses"] == want["losses"]
    assert launches == dict(counted) \
        and launches["flash_attention"] == 4 * CFG.n_layers
    assert int(got["opt"]["step"]) == 4
    for a, b in zip(flatten(got["params"])[0], flatten(want["params"])[0]):
        assert torch.equal(a, b)


def test_a_restore_captures_anew(tmp_path, counted):
    """3 steps and a checkpoint, then a second ``train`` call restoring it
    for 3 more: that call captures its own graph on the restored tensors,
    and the 6 losses equal 6 straight steps'."""
    first = StandIn()
    a = run(3, first, ckpt_dir=str(tmp_path), ckpt_every=3)
    second = StandIn()
    b = run(6, second, ckpt_dir=str(tmp_path), ckpt_every=3)
    straight = run(6, StandIn())
    assert second.log == ["run", "capture", "replay", "replay"]
    assert b["graphs"]["graphs"] == 1 and b["graphs"]["replays"] == 2
    assert a["losses"] + b["losses"] == straight["losses"]


def test_profile_attention_captures_each_grid_point_once(monkeypatch):
    """Each (h, ctx) point: two warm calls (run and capture, then the
    graph's first launch), then ``repeats`` replays; inside
    ``disable_capture()`` nothing is captured.  The samples keep their
    meaning either way."""
    stand_in = StandIn()
    monkeypatch.setattr(graphs, "CudaGraphs", lambda dev: stand_in)
    kw = dict(head_dim=16, head_grid=(1, 2), ctx_grid=(8, 16, 32),
              repeats=2, device="cpu")
    got = profiler.profile_attention(**kw)
    once = ["run", "capture", "replay", "replay", "replay"]
    assert stand_in.log == once * 6
    with graphs.disable_capture():
        eager = profiler.profile_attention(**kw)
    assert stand_in.log == once * 6
    assert [s[:2] for s in got] == [s[:2] for s in eager] == [
        (4.0 * h, 2.0 * 4 * h * c * 16 * 4) for h in (1, 2)
        for c in (8, 16, 32)]
    assert all(t > 0 for *_, t in got + eager)
