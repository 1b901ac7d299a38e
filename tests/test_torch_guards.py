"""Boundaries of the port: it imports neither JAX nor the reference
package, its entry points default to CUDA and refuse to run on the CPU
unasked, configurations it has not ported raise instead of quietly taking
another path, and its copies of the reference's framework-free pieces
(configs, cost model, profiler models, telemetry) agree with the
originals."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config
from repro.core.cluster import DEVICE_CLASSES as JCLASSES
from repro.core.costmodel import dense_flops_layer as jdense_flops
from repro.core.profiler import analytic_attention_model as jattn_model
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.cluster import ClusterSpec, DEVICE_CLASSES
from repro_torch.core.costmodel import dense_flops_layer
from repro_torch.core.profiler import analytic_attention_model
from repro_torch.serving import EngineConfig, InferenceEngine
from repro_torch.telemetry import MetricsRegistry, Tracer, count_recompiles
from repro_torch.weights import init_params

SRC = Path(__file__).resolve().parents[1] / "src"

IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len([k for k in sys.modules if k.startswith("repro_torch")]))
"""


def test_port_imports_no_jax_and_no_reference_module():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 20      # every submodule was imported


def test_entry_points_default_to_cuda_and_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    cfg = smoke_config("qwen3-14b")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg, 0)
    params = init_params(cfg, 0, device="cpu")
    cluster = ClusterSpec.build([("A100", 1), ("3090", 1)])
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(cfg, params, cluster, primary_ids=[0], pool_ids=[1])
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--requests", "1"])


@pytest.mark.parametrize("ecfg", [
    dict(step_mode="split", decode_mode="dense"),
    dict(decode_mode="dense"),
    dict(prefill_mode="dense"),
])
def test_dense_modes_build_with_the_reference_schedule(ecfg):
    """The dense oracle modes are ported: the engine builds, and a dense
    mode turns the fused step off (split schedule) as in the reference."""
    import jax
    from repro.core.cluster import ClusterSpec as JCluster
    from repro.models import transformer as JT
    from repro.serving import EngineConfig as JEngineConfig
    from repro.serving import InferenceEngine as JEngine
    cfg = smoke_config("qwen3-14b")
    jcfg = jget_config("qwen3-14b").reduced()
    eng = InferenceEngine(cfg, init_params(cfg, 0, device="cpu"),
                          ClusterSpec.build([("A100", 1), ("3090", 1)]),
                          primary_ids=[0], pool_ids=[1],
                          engine_cfg=EngineConfig(**ecfg), device="cpu")
    jeng = JEngine(jcfg, JT.init_params(jcfg, jax.random.PRNGKey(0)),
                   JCluster.build([("A100", 1), ("3090", 1)]),
                   primary_ids=[0], pool_ids=[1],
                   engine_cfg=JEngineConfig(**ecfg))
    flags = (eng.use_paged, eng.use_paged_prefill, eng.use_fused)
    assert flags == (jeng.use_paged, jeng.use_paged_prefill, jeng.use_fused)
    assert not eng.use_fused


def test_split_schedule_is_ported_and_unknown_modes_refused():
    cfg = smoke_config("qwen3-14b")
    params = init_params(cfg, 0, device="cpu")
    cluster = ClusterSpec.build([("A100", 1), ("3090", 1)])
    eng = InferenceEngine(cfg, params, cluster, primary_ids=[0],
                          pool_ids=[1],
                          engine_cfg=EngineConfig(step_mode="split"),
                          device="cpu")
    assert (eng.use_fused, eng.use_paged, eng.use_paged_prefill) \
        == (False, True, True)
    with pytest.raises(ValueError, match="step_mode"):
        InferenceEngine(cfg, params, cluster, primary_ids=[0], pool_ids=[1],
                        engine_cfg=EngineConfig(step_mode="fuse"),
                        device="cpu")


@pytest.mark.parametrize("override", [
    dict(sliding_window=16, global_layers=(0,)),
    dict(attn_type="mla", q_lora_rank=32, kv_lora_rank=16,
         qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
         head_dim=24),
    dict(frontend="vision_stub")])
def test_unported_model_families_raise(override):
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), **override)
    cluster = ClusterSpec.build([("A100", 1), ("3090", 1)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(cfg, {}, cluster, primary_ids=[0], pool_ids=[1],
                        device="cpu")


def test_config_copies_match_reference():
    assert dataclasses.asdict(get_config("qwen3-14b")) \
        == dataclasses.asdict(jget_config("qwen3-14b"))
    assert dataclasses.asdict(smoke_config("qwen3-14b")) \
        == dataclasses.asdict(jget_config("qwen3-14b").reduced())
    assert dataclasses.asdict(get_config("qwen3-14b").profile()) \
        == dataclasses.asdict(jget_config("qwen3-14b").profile())
    assert dataclasses.asdict(get_config("deepseek-v3-671b")) \
        == dataclasses.asdict(jget_config("deepseek-v3-671b"))


def test_cost_and_profiler_copies_match_reference():
    cfg, jcfg = get_config("qwen3-14b"), jget_config("qwen3-14b")
    assert {k: dataclasses.asdict(v) for k, v in DEVICE_CLASSES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JCLASSES.items()}
    for tokens in (1, 80, 2048):
        assert dense_flops_layer(cfg.profile(), tokens) \
            == jdense_flops(jcfg.profile(), tokens)
    for name in ("A100", "3090", "H100"):
        assert dataclasses.asdict(analytic_attention_model(
            DEVICE_CLASSES[name], cfg.profile())) \
            == dataclasses.asdict(jattn_model(JCLASSES[name],
                                              jcfg.profile()))


def test_shape_counter_counts_distinct_bucket_shapes():
    reg = MetricsRegistry()
    fn = count_recompiles(lambda *a: len(a), reg.counter("jit/recompiles"))
    for shape in [(2, 4), (2, 4), (4, 4), (2, 4), (4, 8)]:
        fn({"params": 0}, torch.zeros(shape), np.zeros(3))
    assert fn._cache_size() == 3
    assert reg.snapshot()["jit/recompiles"] == 3.0


def test_shape_counter_keys_nested_tensor_leaves():
    """The dense calls pass dicts (``_prefill_fn(params, {"tokens": t})``,
    ``_decode_fn(params, cache, toks)``): a new leaf shape anywhere in
    them is a new shape, as for jit; the same shapes are not."""
    reg = MetricsRegistry()
    fn = count_recompiles(lambda *a: None, reg.counter("jit/recompiles"))
    params = {"groups": [{"w": torch.zeros(2, 3)}], "embed": torch.zeros(5)}
    for n in (7, 7, 9, 7):
        fn(params, {"tokens": torch.zeros(1, n, dtype=torch.int32)})
    assert fn._cache_size() == 2
    cache = lambda S: {"groups": [{"k": torch.zeros(2, 1, S), "v":
                                   torch.zeros(2, 1, S)}],
                       "pos": torch.zeros(1)}
    for S in (4, 4, 8):
        fn(params, cache(S), torch.zeros(1, 1))
    assert fn._cache_size() == 4
    fn(params, [cache(8)], torch.zeros(1, 1))         # another nesting
    assert fn._cache_size() == 5
    assert reg.snapshot()["jit/recompiles"] == 5.0


def test_tracer_sync_on_cpu_tensors():
    tr = Tracer(enabled=True)
    with tr.span("step"):
        tr.sync(torch.ones(3))
    assert tr.count("step") == 1
    Tracer(enabled=False).sync(torch.ones(3))
