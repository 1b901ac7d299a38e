"""The port's Mixture-of-Experts layer against the reference's: the rank of
each assignment within its expert, ``moe_apply`` on the same numpy inputs
and bridged weights (dropless and capped passes, capacity drops, shared
experts, tied router rows, bf16), the parameter trees of a MoE stack, and
the dense model over two layer groups (a dense layer, then MoE layers).

Tolerances: fp32 outputs 2e-5 and bf16 2e-2, as the reference's kernel
tests; the load-balance loss to fp32 rounding (rel 1e-6: the two
frameworks sum the mean router probability in another order); logits
1e-4 and caches 1e-5, as ``test_torch_dense.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import mlp as jmlp
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import mlp as tmlp
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.weights import from_jax_params, init_params

MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
           n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=128, head_dim=16,
           n_experts=4, top_k=2, moe_d_ff=64, dtype="float32")
# two layer groups: one dense layer, then MoE layers with a shared expert
TWO_GROUPS = dict(MOE, n_layers=3, first_dense_layers=1, n_shared_experts=1)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


# one compiled call per case, not one per eager op
jax_moe_apply = jax.jit(jmlp.moe_apply, static_argnums=0)
jax_init_params = jax.jit(JT.init_params, static_argnums=0)


def to_torch(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_np(x):
    return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()


def jax_routing(cfg, p, x):
    """The reference's routing of ``x`` (B, S, d), spelled out from its
    ``moe_apply``: (top-k expert ids (T, K), the keep mask (T * K,))."""
    xt = jnp.asarray(x).reshape(-1, cfg.d_model).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ jnp.asarray(p["router"]), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    T = xt.shape[0]
    flat_e = idx.reshape(-1)
    pos = jmlp._position_in_expert(flat_e, cfg.n_experts)
    cap = T if T <= 64 else max(int(T * cfg.top_k / cfg.n_experts
                                    * cfg.capacity_factor), 8)
    return np.asarray(idx), np.asarray(pos < cap)


@pytest.mark.parametrize("n, E, seed", [(8, 4, 0), (64, 4, 1), (257, 16, 2),
                                        (40, 3, 3)])
def test_position_in_expert(n, E, seed):
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, E, n).astype(np.int32)
    flat_e[: n // 4] = flat_e[0]                   # a long run of repeats
    want = np.asarray(jmlp._position_in_expert(jnp.asarray(flat_e), E))
    got = tmlp._position_in_expert(torch.from_numpy(flat_e), E)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (spec overrides, (B, S), rows made identical, rows of zeros)
CASES = {
    "dropless": (dict(), (2, 8), 0, 0),
    # T = 128 > 64: cap 80 of 256 assignments; 64 identical tokens load
    # their two experts past it
    "capped": (dict(), (4, 32), 64, 0),
    "shared": (dict(n_shared_experts=1), (4, 32), 64, 0),
    "gelu": (dict(act="gelu"), (2, 8), 0, 0),
    "bf16": (dict(dtype="bfloat16"), (4, 32), 64, 0),
    "bf16_shared": (dict(dtype="bfloat16", n_shared_experts=1), (2, 8), 0,
                    0),
    # all-equal router logits: ties to the lower expert index
    "tied_rows": (dict(), (4, 32), 0, 48),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(name):
    over, (B, S), same, zeros = CASES[name]
    spec = dict(MOE, **over)
    jcfg, tcfg = JConfig(**spec), TConfig(**spec)
    p = jax.tree.map(np.asarray, jmlp.moe_init(jcfg, jax.random.PRNGKey(7)))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B * S, 64)).astype(np.float32)
    if same:
        x[-same:] = x[0]
    if zeros:
        x[-zeros:] = 0.0
    x = np.asarray(jnp.asarray(x.reshape(B, S, 64), dtype=jcfg.dtype))
    want, want_aux = jax_moe_apply(jcfg, p, jnp.asarray(x))
    got, got_aux = tmlp.moe_apply(tcfg, jax.tree.map(to_torch, p),
                                  to_torch(x))
    assert got.dtype == to_torch(np.asarray(want)).dtype
    assert got_aux.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), np.asarray(want, np.float32),
                               **TOL[spec["dtype"]])
    assert float(got_aux) == pytest.approx(float(want_aux), rel=1e-6)

    idx, keep = jax_routing(jcfg, p, x)
    if B * S > 64 and same:
        assert not keep.all()                      # the capped path drops
    if zeros:
        assert (idx[-zeros:] == np.arange(tcfg.top_k)).all()
        _, _, tidx = tmlp.route(tcfg, to_torch(p["router"]),
                                to_torch(x).reshape(-1, 64))
        np.testing.assert_array_equal(tidx.numpy(), idx)


def test_tied_router_logits_pick_the_lower_experts():
    """Tokens whose router logits are all equal but whose inputs are not
    zero: the experts the tie picks show in the output."""
    jcfg, tcfg = JConfig(**MOE), TConfig(**MOE)
    p = jax.tree.map(np.array, jmlp.moe_init(jcfg, jax.random.PRNGKey(8)))
    p["router"][:8] = p["router"][:8, :1]          # rows 0-7 equal per expert
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    x[1, :, 8:] = 0.0                              # row 1: tied logits
    want, _ = jax_moe_apply(jcfg, p, jnp.asarray(x))
    got, _ = tmlp.moe_apply(tcfg, jax.tree.map(to_torch, p), to_torch(x))
    idx, _ = jax_routing(jcfg, p, x)
    assert (idx[16:] == [0, 1]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])
    # the same tokens through experts 2 and 3 would differ
    assert np.abs(np.asarray(want)[1]).max() > 1e-3


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_params_trees_match_reference(dtype):
    """``init_params`` draws the reference's tree for a two-group MoE
    stack (keys, shapes, dtypes; the router fp32 whatever the dtype, the
    expert weights at fan-in scale), and the bridge carries such a tree
    unchanged."""
    spec = dict(TWO_GROUPS, dtype=dtype)
    jcfg, tcfg = JConfig(**spec), TConfig(**spec)
    shapes = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    want = {k: (v.shape, str(v.dtype)) for k, v in leaves(shapes).items()}
    assert [sorted(g["mlp"]) for g in shapes["groups"]] \
        == [["wg", "wi", "wo"], ["router", "shared", "wg", "wi", "wo"]]
    assert want["/groups/1/mlp/router"] == ((2, 64, 4), "float32")
    assert want["/groups/1/mlp/wi"] == ((2, 4, 64, 64), dtype)
    assert want["/groups/1/mlp/shared/wi"] == ((2, 64, 64), dtype)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda v: rng.standard_normal(v.shape).astype(v.dtype),
                      shapes)
    bridged = from_jax_params(tcfg, jp, device="cpu")
    for tp in (init_params(tcfg, 0, device="cpu"), bridged):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in leaves(tp).items()}
        assert got == want
    for k, v in leaves(jp).items():
        np.testing.assert_array_equal(to_np(leaves(bridged)[k]),
                                      v.astype(np.float32))
    # the port's own draws: experts at fan-in scale, cut at 2 std
    wi = init_params(tcfg, 0, device="cpu")["groups"][1]["mlp"]["wi"].float()
    assert abs(float(wi.std()) * 8.0 - 0.88) < 0.05    # trunc_normal(2) std
    assert float(wi.abs().max()) <= 2.0 / 8.0 + 1e-3


@pytest.fixture(scope="module")
def two_groups():
    jcfg, tcfg = JConfig(**TWO_GROUPS), TConfig(**TWO_GROUPS)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(3))
    tp = from_jax_params(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


LOGITS = dict(rtol=1e-4, atol=1e-4)
CACHE = dict(rtol=1e-5, atol=1e-5)


def assert_caches(tc, jc):
    assert len(tc["groups"]) == len(jc["groups"]) == 2
    for tg, jg in zip(tc["groups"], jc["groups"]):
        for key in ("k", "v"):
            np.testing.assert_allclose(tg[key].numpy(), np.asarray(jg[key]),
                                       **CACHE)


@pytest.mark.parametrize("impl", ["carry", "stacked"])
def test_two_group_dense_model_matches_reference(two_groups, impl):
    """``prefill`` (S = 80 > 64: the capped MoE pass) and ``decode_step``
    over a dense group and a MoE group with a shared expert."""
    jcfg, tcfg, jp, tp = two_groups
    jcfg = dataclasses.replace(jcfg, decode_impl=impl)
    tcfg = dataclasses.replace(tcfg, decode_impl=impl)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 128, (1, 80)).astype(np.int32)
    jl, jc = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=88)
    tl, tc = TT.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                        max_seq=88)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
    assert_caches(tc, jc)
    for _ in range(2):
        new = rng.integers(0, 128, (1, 1)).astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jp, jc, jnp.asarray(new))
        tl, tc = TT.decode_step(tcfg, tp, tc, torch.from_numpy(new))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGITS)
        assert_caches(tc, jc)
