"""The launch tooling of the port (``repro_torch.configs``' cell grid,
``distributed.sharding``, ``launch.steps``, ``launch.hlo_analysis``,
``launch.dryrun``) against the JAX package on the CPU.

The grid, the microbatch and moment rules and every abstract input are
held equal to the reference's (meta tensors against
``ShapeDtypeStruct``s).  The steps run in lockstep with the reference's
``steps.build`` bundles under plain ``jax.jit`` on a (1, 1) mesh of Auto
axes (``make_debug_mesh`` gives Explicit axes in this JAX, which the
reference's ``with_sharding_constraint`` refuses), from the same weights
(``from_jax_params``) and numpy inputs.  Tolerances: the loss within
1e-5, the parameters within 1e-5 relative L2 (as in
``test_torch_training.py``), logits within 1e-4 of their largest
magnitude (fp32 sums in another order through a reduced model)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.launch import hlo_analysis as jhlo
from repro.launch import steps as jsteps
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun, hlo_analysis, steps
from repro_torch.models import transformer as T
from repro_torch.training import optimizer as opt
from repro_torch.training.train_loop import trainable
from repro_torch.training.tree import flatten
from repro_torch.weights import from_jax_params

KEY = jax.random.PRNGKey(0)
APPLICABLE = [(a, s) for a, s, ok, _ in configs.cells(include_skipped=True)
              if ok]


def mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ------------------------------------------------------------ the grid
def test_cells_and_shapes_equal_the_reference():
    assert configs.cells(include_skipped=True) \
        == jconfigs.cells(include_skipped=True)
    assert configs.cells() == jconfigs.cells()
    assert len(configs.cells(include_skipped=True)) == 40
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert sorted(configs.all_configs()) == sorted(jconfigs.all_configs())


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_step_rules_equal_the_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert str(steps.moment_dtype(cfg)).replace("torch.", "") \
        == jnp.dtype(jsteps.moment_dtype(jcfg)).name
    for name in configs.SHAPES:
        shape, jshape = configs.SHAPES[name], jconfigs.SHAPES[name]
        assert configs.shape_applicable(cfg, shape) \
            == jconfigs.shape_applicable(jcfg, jshape)
        assert steps.num_microbatches(cfg, shape) \
            == jsteps.num_microbatches(jcfg, jshape)


def test_per_device_share_of_the_pod_mesh():
    """One device of the (16, 16) mesh: the global batch over the data
    axis where it divides; train_4k's 16 rows split into the reference's
    microbatches (qwen1.5 2 of 8, deepseek-v3 16 of 1)."""
    assert {n: steps.per_device_batch(s) for n, s in configs.SHAPES.items()} \
        == {"train_4k": 16, "prefill_32k": 2, "decode_32k": 8,
            "long_500k": 1}
    train = configs.SHAPES["train_4k"]
    for arch, n_micro in (("qwen1.5-0.5b", 2), ("deepseek-v3-671b", 16)):
        bundle = steps.build(configs.get_config(arch), train, "meta")
        assert (bundle.batch, bundle.n_micro) == (16, n_micro)
        assert bundle.static_desc == f"train n_micro={n_micro}"
        assert flatten(bundle.args[2])[0][0].shape == (16, 4096)


def _leaves(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in flatten(tree)[0]]


@functools.lru_cache(maxsize=None)
def _jax_specs(arch, shape_name):
    specs = jsteps.input_specs(jconfigs.get_config(arch),
                               jconfigs.SHAPES[shape_name])
    return {k: [(tuple(x.shape), jnp.dtype(x.dtype).name)
                for x in jax.tree.leaves(v)] for k, v in specs.items()}


@pytest.mark.parametrize("arch,shape_name", APPLICABLE)
def test_input_specs_equal_the_reference(arch, shape_name):
    """Every abstract input of every applicable cell at full width: the
    same leaves, in the same order, shapes and dtypes (meta tensors
    against ``jax.eval_shape``'s ``ShapeDtypeStruct``s)."""
    got = steps.input_specs(configs.get_config(arch),
                            configs.SHAPES[shape_name])
    assert all(x.device.type == "meta"
               for v in got.values() for x in flatten(v)[0])
    assert {k: _leaves(v) for k, v in got.items()} \
        == _jax_specs(arch, shape_name)


def test_sharding_rules_are_the_reference_names_and_an_identity():
    from repro.distributed import sharding as jsharding
    for split in (True, False):
        for multi_pod in (True, False):
            ours = sharding.make_rules(kv_head_split=split,
                                       multi_pod=multi_pod)
            ref = jsharding.make_rules(mesh(), kv_head_split=split,
                                       multi_pod=multi_pod)
            assert ours.rules == ref.rules and ours.mesh is None
            names = ("batch", None, "kv_heads", "vocab")
            # the reference's PartitionSpec writes a 1-tuple as its axis
            assert [a[0] if isinstance(a, tuple) and len(a) == 1 else a
                    for a in ours.spec(*names)] == list(ref.spec(*names))
    x = torch.ones(2, 3)
    assert sharding.current_rules() is None
    assert sharding.logical_spec("batch") is None
    with sharding.axis_rules(ours) as r:
        assert sharding.current_rules() is r
        assert sharding.logical_spec("batch", "mlp") == (("data",), "model")
        assert sharding.logical(x, "batch", "embed") is x
    assert sharding.current_rules() is None


def test_roofline_terms_take_the_h100_peaks():
    t = hlo_analysis.roofline_terms(989e12, 3.35e12)
    assert t == {"compute_s": 1.0, "memory_s": 1.0, "collective_s": 0.0}
    assert set(t) == set(jhlo.roofline_terms(1.0, 1.0, 1.0))


# ------------------------------------------------- the steps in lockstep
def _both_params(arch):
    jcfg = jconfigs.smoke_config(arch)
    cfg = configs.smoke_config(arch)
    jp = JT.init_params(jcfg, KEY)
    return jcfg, cfg, jp, from_jax_params(
        cfg, jax.tree.map(np.asarray, jp), device="cpu")


def test_train_bundle_in_lockstep_with_the_reference():
    """One step of reduced fp32 qwen3 (2 layers, d_model 64: n_micro 2 by
    the reference's rule) over 4 rows of 16, both bundles from the same
    weights and batch: loss and grad norm within 1e-5, the parameters
    and both moments within 1e-5 relative L2, the step counted."""
    jcfg, cfg, jp, params = _both_params("qwen3-14b")
    shape = configs.ShapeSpec("train_tiny", 16, 4, "train")
    jshape = jconfigs.ShapeSpec("train_tiny", 16, 4, "train")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    batch["labels"][0, :3] = -1
    m = mesh()
    jb = jsteps.build(jcfg, jshape, m, False)
    assert jb.static_desc == "train n_micro=2"
    with m:
        jp, jo, jmet = jax.jit(jb.fn)(
            jp, jopt.adamw_init(jp, jsteps.moment_dtype(jcfg)),
            to_jax(batch))
    bundle = steps.build(cfg, shape, "cpu", per_device=False)
    assert (bundle.static_desc, bundle.batch, bundle.n_micro) \
        == (jb.static_desc, 4, 2)
    assert _leaves(steps.shaped(params)) == _leaves(bundle.args[0])
    assert all(x.device.type == "meta"
               for x in flatten(steps.shaped(params))[0])
    params, o, met = bundle.fn(params, opt.adamw_init(
        params, steps.moment_dtype(cfg)), to_torch(batch))
    for k in ("loss", "grad_norm"):
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-5 * abs(
            float(jmet[k])), k
    assert int(o["step"]) == int(jo["step"]) == 1
    for ours, ref in ((params, jp), (o["m"], jo["m"]), (o["v"], jo["v"])):
        a = np.concatenate([x.detach().numpy().ravel()
                            for x in flatten(ours)[0]])
        b = np.concatenate([np.asarray(x).ravel()
                            for x in jax.tree.leaves(ref)])
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)


def test_microbatches_are_contiguous_rows():
    """``accumulate_grads`` over 2 microbatches equals the mean of the two
    single-microbatch gradients of rows [0, 2) and [2, 4)."""
    _jcfg, cfg, _jp, params = _both_params("qwen1.5-0.5b")
    params = trainable(params)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 12)))
             for k in ("tokens", "labels")}
    acc, loss = steps.accumulate_grads(cfg, params, batch, 2)
    halves = [steps.accumulate_grads(cfg, params,
                                     {k: v[i:i + 2]
                                      for k, v in batch.items()}, 1)
              for i in (0, 2)]
    assert torch.allclose(loss, (halves[0][1] + halves[1][1]) / 2,
                          rtol=1e-6)
    for a, g0, g1 in zip(flatten(acc)[0], flatten(halves[0][0])[0],
                         flatten(halves[1][0])[0]):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, (g0 + g1) / 2, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v3-671b"])
def test_prefill_and_decode_bundles_match_the_reference(arch):
    """Reduced fp32 models: the prefill bundle's last-token logits, then
    4 decode-bundle steps from the prefill's cache (the decode cells'
    shape, 2 rows of 32 positions), the tokens equal and the final
    caches within 1e-4 of their largest magnitude."""
    jcfg, cfg, jp, params = _both_params(arch)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (2, 32)).astype(np.int32)}
    m = mesh()
    pre = configs.ShapeSpec("prefill_tiny", 32, 2, "prefill")
    jpre = jconfigs.ShapeSpec("prefill_tiny", 32, 2, "prefill")
    with m:
        jlogits, _ = jax.jit(jsteps.build(jcfg, jpre, m, False).fn)(
            jp, to_jax(batch))
    logits, _ = steps.build(cfg, pre, "cpu", per_device=False).fn(
        params, to_torch(batch))
    ref = np.asarray(jlogits)
    assert np.abs(logits.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()

    # decode from a 24-token prefill's cache of 32 positions
    short = {"tokens": batch["tokens"][:, :24]}
    _, jcache = JT.prefill(jcfg, jp, to_jax(short), max_seq=32)
    _, cache = T.prefill(cfg, params, to_torch(short), 32)
    dec = configs.ShapeSpec("decode_tiny", 32, 2, "decode")
    jdec = jconfigs.ShapeSpec("decode_tiny", 32, 2, "decode")
    jfn = jax.jit(jsteps.build(jcfg, jdec, m, False).fn)
    fn = steps.build(cfg, dec, "cpu", per_device=False).fn
    jtok = jnp.asarray(batch["tokens"][:, 24:25])
    tok = torch.from_numpy(batch["tokens"][:, 24:25].copy())
    for _ in range(4):
        with m:
            jtok, jcache = jfn(jp, jcache, jtok)
        tok, cache = fn(params, cache, tok)
        assert tok.dtype == torch.int32
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    for a, b in zip(flatten(cache)[0], jax.tree.leaves(jcache)):
        b = np.asarray(b, np.float64)
        assert np.abs(a.double().numpy() - b).max() \
            <= 1e-4 * max(np.abs(b).max(), 1.0)


def test_encoder_prefill_bundle_matches_the_reference():
    """hubert (encoder-only): the prefill bundle's last-frame fp32
    logits."""
    jcfg, cfg, jp, params = _both_params("hubert-xlarge")
    frames = np.random.default_rng(3).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    m = mesh()
    jb = jsteps.build(jcfg, jconfigs.ShapeSpec("p", 20, 2, "prefill"), m,
                      False)
    with m:
        ref = np.asarray(jax.jit(jb.fn)(jp, {"frames": jnp.asarray(frames)}))
    bundle = steps.build(cfg, configs.ShapeSpec("p", 20, 2, "prefill"),
                         "cpu", per_device=False)
    assert bundle.static_desc == jb.static_desc == "prefill(encoder)"
    got = bundle.fn(params, {"frames": torch.from_numpy(frames)})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_a_step_refuses_parameters_on_another_device():
    cfg = configs.smoke_config("qwen3-14b")
    bundle = steps.build(cfg, configs.SHAPES["decode_32k"], "meta")
    with pytest.raises(ValueError, match="built for meta"):
        bundle.fn({"embed": torch.zeros(1)}, None, None)


# -------------------------------------------------------------- dry-run
def test_dryrun_cell_gives_the_reference_model_flops():
    """qwen1.5-0.5b's train_4k on the meta device: the model FLOPs per
    device are the reference's formula on the reference's config
    (dryrun.py:88-100, 256 chips); the card's share is its 16 rows; the
    arguments fit; the counted FLOPs (forward, remat forward and
    backward of one microbatch, times 2) exceed the model FLOPs, whose
    share of them is logged."""
    rec = dryrun.run_cell("qwen1p5_0p5b", "train_4k", save=False)
    assert rec["status"] == "ok", rec
    n = jconfigs.get_config("qwen1p5_0p5b").profile().total_active_params()
    assert rec["model_flops_per_device"] == 6.0 * n * 256 * 4096 / 256
    assert rec["model_flops_card"] == 6.0 * n * 16 * 4096
    assert rec["fits"] and rec["cut_layers"] is None
    ref = jsteps.input_specs(jconfigs.get_config("qwen1p5_0p5b"),
                             jconfigs.SHAPES["train_4k"])
    assert rec["arg_bytes"]["params"] == sum(
        x.size * jnp.dtype(x.dtype).itemsize
        for x in jax.tree.leaves(ref["params"]))
    assert rec["counted_flops"] > rec["model_flops_card"]
    print(f"qwen1.5-0.5b train_4k: model FLOPs {rec['model_flops_card']:.4g}"
          f" of counted {rec['counted_flops']:.4g} (ratio "
          f"{rec['useful_flops_ratio']:.3f})")


def test_dryrun_cuts_a_cell_that_does_not_fit():
    """dbrx-132b's train_4k (bf16 moments) does not fit one card; the cut
    is the deepest whose arguments do, and one layer more does not."""
    cfg = configs.get_config("dbrx-132b")
    shape = configs.SHAPES["train_4k"]
    assert sum(dryrun.arg_bytes(cfg, shape, 16).values()) > dryrun.CARD_BYTES
    cut = dryrun.deepest_fit(cfg, shape, 16)
    size = lambda n: sum(dryrun.arg_bytes(
        dataclasses.replace(cfg, n_layers=n), shape, 16).values())
    assert 0 < cut < cfg.n_layers
    assert size(cut) <= dryrun.CARD_BYTES < size(cut + 1)


def test_dryrun_cli_records_a_skipped_cell(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    assert dryrun.main(["--arch", "qwen3-14b", "--shape", "long_500k"]) == 0
    rec = (tmp_path / "qwen3_14b_long_500k.json").read_text()
    assert '"status": "skipped"' in rec and "500k" in rec
    assert "skipped=1" in capsys.readouterr().out
