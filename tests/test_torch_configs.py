"""The configs in the port: the main path's five architectures and the
five of the other families equal the reference's field by field
(published, reduced and as cost profiles), and the features the main
path's configs bring to the engine (GELU, qkv-bias with tied embeddings,
MHA at dh 96, fp8 KV pools) serve the reference's tokens.

Engines run in lockstep (``_torch_engine_pair``): after every step the
token streams, the queues, the counters (``h2d_bytes`` among them), the
pool tables and the clock must be identical.  The GELU
MLP is held to fp32 1e-5, as ``test_torch_modules.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_engine_pair import serve_in_lockstep
from repro.configs import get_config as jget_config
from repro.models import mlp as jmlp
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import mlp as tmlp
from repro_torch.models.config import ModelConfig as TConfig

MAIN_PATH = ["qwen3-14b", "qwen1.5-0.5b", "phi3-mini-3.8b", "minitron-8b",
             "dbrx-132b"]
BASE = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
            dtype="float32")
# one jit per config, not one per eager op
jax_init_params = jax.jit(JT.init_params, static_argnums=0)


@pytest.mark.parametrize("name", MAIN_PATH)
def test_main_path_configs_match_reference(name):
    cfg, jcfg = get_config(name), jget_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(smoke_config(name)) \
        == dataclasses.asdict(jcfg.reduced())
    assert dataclasses.asdict(cfg.profile()) \
        == dataclasses.asdict(jcfg.profile())
    assert get_config(cfg.name) is cfg


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "hymba-1.5b",
                                  "xlstm-350m", "hubert-xlarge",
                                  "internvl2-1b"])
def test_families_off_the_main_path_match_reference(name):
    """MLA, SSM hybrid with windows, xLSTM and the stub frontends: the
    port's copies equal the reference's field by field (published,
    reduced and as cost profiles)."""
    test_main_path_configs_match_reference(name)


def test_gelu_mlp_matches_reference():
    cfg = JConfig(**dict(BASE, act="gelu"))
    p = jax.tree.map(np.array, jmlp.mlp_init(cfg, jax.random.PRNGKey(2)))
    assert "wg" not in p
    x = np.random.default_rng(2).standard_normal((3, 4, 64)).astype(
        np.float32) * 3
    want = np.asarray(jmlp.mlp_apply(cfg, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x)))
    got = tmlp.mlp_apply(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# the small siblings of each main-path feature (``reduced`` folds every
# config to 4/2 heads at dh 16, so MHA and dh 96 are spelled out)
FEATURES = {
    # minitron: GQA r = 4 with GELU
    "gelu": dict(n_heads=8, act="gelu"),
    # qwen1.5: MHA with qkv biases (made nonzero) and tied embeddings
    "qkv_bias_tied": dict(n_kv_heads=4, qkv_bias=True, tie_embeddings=True),
    # phi3-mini: MHA at dh 96
    "mha_dh96": dict(n_heads=2, n_kv_heads=2, head_dim=96),
    # fp8 KV pools under bf16 activations
    "fp8_pools": dict(dtype="bfloat16", kv_cache_dtype="float8_e4m3fn"),
}


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_main_path_features_serve_the_reference_tokens(feature):
    spec = dict(BASE, **FEATURES[feature])
    jcfg, tcfg = JConfig(**spec), TConfig(**spec)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(np.array, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    for name in ("bq", "bk", "bv"):
        b = jp["groups"][0]["attn"].get(name)
        if b is not None:
            b[...] = rng.standard_normal(b.shape).astype(b.dtype)
    t = serve_in_lockstep(jcfg, tcfg, jp, dict(max_batch=8, max_seq=64,
                                               page_size=8, prefill_chunk=8),
                          n=3, lo=5, hi=30, max_new=5, seed=4)
    assert t.use_fused and t.metrics["h2d_bytes"] > 0
    assert t.kv.dtype == (torch.float8_e4m3fn if "kv_cache_dtype" in spec
                          else t.params["embed"].dtype)
