"""Training on the port (``repro_torch.training``, ``transformer.loss_fn``)
against the JAX package on the CPU.

Inputs are made with numpy from a seed and weights go across with
``from_jax_params``.  Tolerances: the loss within 1e-5 and every gradient
leaf within 1e-4 of its largest magnitude (fp32 sums in another order
through a whole model); AdamW within 1e-6 relative (fp32, one step) and
one bf16 unit where moments are bf16; 5 lockstep steps within the
reference's own restart tolerance (``tests/test_training.py``: rtol 1e-4,
atol 1e-5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jax_smoke_config
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import SyntheticLM as JSyntheticLM
from repro_torch.configs import smoke_config
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.train_loop import (TrainConfig, train, train_step,
                                             trainable)
from repro_torch.training.tree import flatten, unflatten
from repro_torch.weights import from_jax_params

KEY = jax.random.PRNGKey(0)
RESTART_TOL = dict(rtol=1e-4, atol=1e-5)


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def both_params(arch, cfg=None):
    """The reference's init and the port's copy of it (trainable, CPU)."""
    jcfg = jax_smoke_config(arch)
    cfg = cfg or smoke_config(arch)
    jp = JT.init_params(jcfg, KEY)
    return jcfg, cfg, jp, trainable(from_jax_params(
        cfg, jax.tree.map(np.asarray, jp), device="cpu"))


def make_batch(cfg, seed, B=2, S=24):
    """A numpy batch of the config's frontend: tokens (or audio frames,
    or image embeddings and tokens) and labels with some -1."""
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.frontend == "audio_stub":
        batch["frames"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size,
                                       (B, S)).astype(np.int32)
        if cfg.frontend == "vision_stub":    # 4 image positions in front
            batch["image_embeds"] = rng.standard_normal(
                (B, 4, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    batch["labels"] = labels
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("seed,step,host,hosts", [
    (0, 0, 0, 1), (1, 5, 0, 1), (3, 17, 1, 2), (3, 17, 0, 2), (7, 2, 3, 4)])
def test_synthetic_batches_equal_the_reference(seed, step, host, hosts):
    args = dict(vocab_size=300, seq_len=40, global_batch=8, seed=seed,
                noise=0.25, host_id=host, num_hosts=hosts)
    got = SyntheticLM(DataConfig(**args)).batch_at(step)
    want = JSyntheticLM(JDataConfig(**args)).batch_at(step)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------- loss and grads
# the ten architectures of tests/test_models.py less the duplicates (the
# other main-path dense configs are qwen1.5's and qwen3's kind)
LOSS_ARCHS = ["qwen1.5-0.5b", "qwen3-14b", "dbrx-132b", "hymba-1.5b",
              "deepseek-v3-671b", "xlstm-350m", "internvl2-1b",
              "hubert-xlarge"]


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_gradients_match_the_reference(arch):
    """``loss_fn`` and autograd against ``jax.value_and_grad`` of the
    reference's ``loss_fn`` (jitted, as its trainer runs it): MoE aux (dbrx, deepseek), windows and the SSM
    (hymba), MLA (plain on the CPU), xLSTM, a vlm's text labels and an
    encoder's frame labels."""
    jcfg, cfg, jp, params = both_params(arch)
    batch = make_batch(cfg, LOSS_ARCHS.index(arch))
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, to_jax(batch)), has_aux=True))(jp)
    loss, met = T.loss_fn(cfg, params, to_torch(batch))
    leaves = flatten(params)[0]
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    jleaves = jax.tree.leaves(jgrads)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    for key in ("nll", "aux", "tokens"):
        assert abs(met[key].item() - float(jmet[key])) <= 1e-5, key
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        assert g.shape == jg.shape
        assert rel_err(g.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "internvl2-1b"])
def test_loss_over_several_chunks_matches_the_reference(arch):
    """41 labelled positions in chunks of 16 (the last one padded with
    label -1), each layer under remat, as at full width (4096 positions
    in chunks of 512): loss, label count and gradients against the
    reference's (a vlm's image prefix cut off first)."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), loss_chunk=16)
    cfg = dataclasses.replace(smoke_config(arch), loss_chunk=16, remat=True)
    _, _, jp, params = both_params(arch, cfg)
    batch = make_batch(cfg, 7, S=41)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, to_jax(batch)), has_aux=True))(jp)
    loss, met = T.loss_fn(cfg, params, to_torch(batch))
    grads = torch.autograd.grad(loss, flatten(params)[0],
                                materialize_grads=True)
    assert abs(loss.item() - float(jloss)) <= 1e-5
    assert met["tokens"].item() == float(jmet["tokens"]) == 2 * 41 - 3
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        assert rel_err(g.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "dbrx-132b"])
def test_remat_gives_the_same_gradients(arch):
    """Each layer under activation checkpointing (the MoE aux loss
    included) gives the gradients of the plain graph."""
    _, cfg, _, params = both_params(arch)
    batch = to_torch(make_batch(cfg, 3))
    leaves = flatten(params)[0]

    def grads(remat):
        c = dataclasses.replace(cfg, remat=remat)
        loss, _ = T.loss_fn(c, params, batch)
        return loss, torch.autograd.grad(loss, leaves,
                                         materialize_grads=True)
    (l0, g0), (l1, g1) = grads(False), grads(True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- AdamW
def random_tree(rng, dtype=torch.float32):
    shapes = {"groups": [{"w": (3, 4, 5), "norm": (3, 4)}], "embed": (7, 4),
              "final_norm": (4,)}
    arrs = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    return arrs


@pytest.mark.parametrize("moment", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_adamw_matches_the_reference(moment, clip):
    """Three updates of a random tree (an fp32 and a bf16 leaf), the clip
    active (1.0 against a gradient norm of ~10) and inactive."""
    rng = np.random.default_rng(0)
    p_np = random_tree(rng)
    jp = jax.tree.map(jnp.asarray, p_np)
    jp["embed"] = jp["embed"].astype(jnp.bfloat16)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p_np)
    p["embed"] = p["embed"].to(torch.bfloat16)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[moment]
    jst = jopt.adamw_init(jp, jdt)
    st = opt.adamw_init(p, tdt)
    kw = dict(lr=1e-2, grad_clip=clip)
    for i in range(3):
        g_np = jax.tree.map(lambda a: 3 * rng.standard_normal(
            a.shape).astype(np.float32), p_np)
        jp, jst, jn = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                        jst, **kw)
        p, st, n = opt.adamw_update(
            p, jax.tree.map(torch.from_numpy, g_np), st, **kw)
        assert (float(n) > clip) == (clip == 1.0)
        assert rel_err(float(n), float(jn)) <= 1e-6
        assert int(st["step"]) == int(jst["step"]) == i + 1
        assert st["step"].dtype == torch.int32
    for tree, jtree, bf16_tol in ((p, jp, 2 ** -8), (st["m"], jst["m"], None),
                                  (st["v"], jst["v"], None)):
        for a, b in zip(flatten(tree)[0], jax.tree.leaves(jtree)):
            assert str(a.dtype).split(".")[1] == str(b.dtype)
            tol = 2 ** -8 if a.dtype == torch.bfloat16 else 1e-6
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32), rtol=tol,
                                       atol=tol * 1e-3)


def test_train_step_in_lockstep_with_the_reference():
    """Five ``train_step`` calls against the reference's own step (its
    ``loss_fn`` and ``adamw_update`` under ``jax.jit``) from the same
    weights on the same batches: losses within the restart tolerance;
    parameters after, per leaf, within 1e-5 relative L2 and every element
    within 0.05 lr.  (AdamW divides each element's moment by its own
    root mean square, so an element whose gradient is near the two
    frameworks' fp32 sum noise moves by a different fraction of lr: one
    of 16384 such elements is 1.4e-5 off after 5 steps, at relative L2
    1e-6.)"""
    jcfg, cfg, jp, params = both_params("qwen3-14b")
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                noise=0.1)
    data = SyntheticLM(DataConfig(**dcfg))

    @jax.jit
    def jstep(p, o, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: JT.loss_fn(jcfg, q, batch), has_aux=True)(p)
        p, o, _ = jopt.adamw_update(p, grads, o, lr=1e-3)
        return p, o, loss

    jo, o = jopt.adamw_init(jp), opt.adamw_init(params)
    for step in range(5):
        b = data.batch_at(step)
        jp, jo, jloss = jstep(jp, jo, to_jax(b))
        params, o, loss, _ = train_step(
            cfg, params, o, {k: torch.from_numpy(v).long()
                             for k, v in b.items()}, 1e-3)
        np.testing.assert_allclose(float(loss), float(jloss), **RESTART_TOL)
    for a, b in zip(flatten(params)[0], jax.tree.leaves(jp)):
        a, b = a.detach().numpy(), np.asarray(b)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
        assert np.abs(a - b).max() <= 0.05 * 1e-3


# ------------------------------------- the reference's tests, on the port
def test_loss_decreases():
    cfg = smoke_config("qwen1.5-0.5b")
    dcfg = DataConfig(cfg.vocab_size, seq_len=32, global_batch=8, noise=0.1)
    out = train(cfg, dcfg, TrainConfig(steps=25, lr=2e-3, device="cpu"))
    assert out["losses"][-1] < out["losses"][0] - 0.1


def test_checkpoint_restart_equivalence(tmp_path):
    cfg = smoke_config("qwen1.5-0.5b")
    dcfg = DataConfig(cfg.vocab_size, seq_len=16, global_batch=4, noise=0.1)
    full = train(cfg, dcfg, TrainConfig(steps=10, lr=1e-3, device="cpu"))
    d1 = tmp_path / "ck"
    first = train(cfg, dcfg, TrainConfig(steps=5, lr=1e-3, ckpt_dir=str(d1),
                                         ckpt_every=5, device="cpu"))
    resumed = train(cfg, dcfg, TrainConfig(steps=10, lr=1e-3,
                                           ckpt_dir=str(d1), ckpt_every=5,
                                           device="cpu"))
    np.testing.assert_allclose(full["losses"][5:], resumed["losses"],
                               **RESTART_TOL)
    # deterministic on one machine: the same bits
    assert first["losses"] + resumed["losses"] == full["losses"]
    for a, b in zip(flatten(full["params"])[0],
                    flatten(resumed["params"])[0]):
        assert torch.equal(a, b)


def test_checkpoint_atomicity(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    assert ckpt.latest_step(str(tmp_path)) == 2
    bad = tmp_path / "step_00000099"          # partial: ignored
    bad.mkdir()
    assert ckpt.latest_step(str(tmp_path)) == 2
    restored = ckpt.restore(str(tmp_path), 2, tree)
    assert torch.equal(restored["a"], tree["a"])
    assert not list(tmp_path.glob(".tmp_*"))


def test_checkpoint_gc(tmp_path):
    tree = {"x": torch.zeros(4)}
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, tree, keep_last=2)
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [4, 5]


# ------------------------------------------- checkpoints across packages
def state_trees(rng):
    """The same (params, opt)-shaped fp32 tree for both packages: dict keys
    out of order and a list, so the leaf order matters."""
    arrs = {"params": {"groups": [{"z": rng.standard_normal((2, 3)),
                                   "a": rng.standard_normal((4,))}],
                       "embed": rng.standard_normal((5, 2)),
                       "final_norm": rng.standard_normal((2,))},
            "opt": {"step": np.array(7, np.int32)}}
    arrs = jax.tree.map(lambda a: a.astype(np.float32)
                        if a.dtype == np.float64 else a, arrs)
    return (jax.tree.map(jnp.asarray, arrs),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), arrs))


def test_fp32_checkpoints_restore_across_packages(tmp_path):
    jtree, ttree = state_trees(np.random.default_rng(0))
    jckpt.save(str(tmp_path / "j"), 3, jtree)
    got = ckpt.restore(str(tmp_path / "j"), 3, jax.tree.map(
        torch.zeros_like, ttree))
    ckpt.save(str(tmp_path / "t"), 4, ttree)
    back = jckpt.restore(str(tmp_path / "t"), 4, jax.tree.map(
        jnp.zeros_like, jtree))
    for a, b, c in zip(flatten(got)[0], jax.tree.leaves(jtree),
                       jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(c), np.asarray(b))
    assert got["opt"]["step"].dtype == torch.int32


def test_bf16_leaves_round_trip_in_the_port_but_not_the_reference(tmp_path):
    """ROADMAP Queue C: the reference writes a bf16 leaf as 2-byte V2
    records and its ``restore`` cannot cast them back, so a full-width
    (bf16) checkpoint does not restore.  The port writes the same records
    and reads them back as the bf16 bits; it also restores the
    reference's."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    t = {"w": torch.from_numpy(x).to(torch.bfloat16)}
    ckpt.save(str(tmp_path / "t"), 1, t)
    got = ckpt.restore(str(tmp_path / "t"), 1, {"w": torch.zeros(
        6, 5, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
    j = {"w": jnp.asarray(x, jnp.bfloat16)}
    jckpt.save(str(tmp_path / "j"), 1, j)
    stored = np.load(tmp_path / "j" / "step_00000001" / "shard_0.npz")
    assert stored["leaf_0"].dtype.kind == "V"
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore(str(tmp_path / "j"), 1, j)
    from_ref = ckpt.restore(str(tmp_path / "j"), 1, {"w": torch.zeros(
        6, 5, dtype=torch.bfloat16)})
    assert torch.equal(from_ref["w"], t["w"])


def test_the_launcher_trains_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch import train as launch
    launch.main(["--device", "cpu", "--steps", "5", "--ckpt",
                 str(tmp_path / "ck")])
    out = capsys.readouterr().out
    assert out.startswith("steps=5 first_loss=")
    assert ckpt.latest_step(str(tmp_path / "ck")) == 5


def test_entry_points_default_to_the_card():
    cfg = smoke_config("qwen1.5-0.5b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg, DataConfig(cfg.vocab_size, 8, 2), TrainConfig(steps=1))


# ------------------------------------------- attention's CPU gradient
# (B, Hq, Hkv, Sq, Sk, dh, causal, window): causal MHA, GQA r = 5, a
# window, non-causal, Sq > Sk (causal: every row sees a key)
ATTN_CASES = {
    "causal": (1, 2, 2, 40, 40, 32, True, 0),
    "gqa_r5": (2, 10, 2, 24, 24, 32, True, 0),
    "window": (1, 4, 2, 40, 40, 32, True, 8),
    "noncausal": (1, 2, 2, 30, 30, 32, False, 0),
    "sq_gt_sk": (1, 4, 2, 40, 25, 32, True, 0),
}


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_flash_gradients_on_the_cpu_match_chunked_attention(name):
    """``flash_attention`` on CPU tensors with requires_grad: autograd of
    the plain version gives the gradients XLA takes of the reference's
    ``common.chunked_attention`` (the training path's attention), fp32
    2e-5 of each gradient's largest magnitude.  Query chunks of 8, a
    divisor of every windowed case's length (ROADMAP Queue C: the
    reference's windowed strip misreads a partial last chunk)."""
    B, Hq, Hkv, Sq, Sk, dh, causal, window = ATTN_CASES[name]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    q, k, v, g = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, Sq, Hq, dh), (B, Sk, Hkv, dh), (B, Sk, Hkv, dh),
        (B, Sq, Hq, dh)))
    _, vjp = jax.vjp(lambda a, b, c: jcommon.chunked_attention(
        a, b, c, causal=causal, window=window, chunk=8), q, k, v)
    want = vjp(jnp.asarray(g))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fa_ops.flash_attention(*qkv, causal=causal, window=window,
                                 layout="BSHD")
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), b) <= 2e-5


def test_tree_flatten_is_the_reference_order():
    tree = {"groups": [{"z": 1, "a": 2}], "embed": 3, "final_norm": 4}
    leaves, spec = flatten(tree)
    assert leaves == jax.tree.flatten(tree)[0] == [3, 4, 2, 1]
    assert unflatten(spec, leaves) == tree
