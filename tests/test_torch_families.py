"""The model families off the engine's path in the port — hymba's SSM
hybrid with sliding windows, deepseek-v3's MLA (dense and MoE layers),
xLSTM, and the vision and audio stub frontends — against the reference on
the same numpy inputs and bridged weights.

Per module, fp32 within 2e-5 (the recurrent states within 1e-5): the
selective SSM (sequences shorter than the conv, within one scan chunk and
across chunks) and its decode step, MLA's prefill and both absorbed
decodes, mLSTM and sLSTM and their decode steps, both stub frontends,
and the flash-attention kernel's plain version at the families' new
shapes (MLA's q/k 192 with v 128 against the reference's chunked
attention; hubert's dh 80 non-causal and a sliding window against the
Pallas kernel in interpret mode; the window against the reference's
strip-sliced attention, whose last strip is wrong when the query count
is not a whole number of chunks).  Per family at reduced size:
``prefill`` logits within 1e-4 and 8 greedy tokens identical through
``decode_step``, carry and stacked; ``forward_hidden`` for hubert and
deepseek; the reference's identity that decoding token t equals a forward
over t + 1 tokens; each kind's cache layout; and the reference's xLSTM
padding steps, kept for parity."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke
from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro.models import transformer as JT
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as txlstm
from repro_torch.weights import from_jax_params

FAMILIES = ["hymba-1.5b", "deepseek-v3-671b", "xlstm-350m", "internvl2-1b",
            "hubert-xlarge"]
TOL = dict(rtol=2e-5, atol=2e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
# one jit per config and shape, not one per eager op
jprefill = jax.jit(JT.prefill, static_argnums=(0, 3))
jdecode = jax.jit(JT.decode_step, static_argnums=0)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def assert_tree_close(got, want, **tol):
    """Port tree (torch leaves) against a reference tree, key by key."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            assert_tree_close(got[k], want[k], **tol)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def layer_params(name, init, seed=0):
    """One layer's reference parameters of the reduced ``name``, by
    ``init`` (a reference init function), as numpy."""
    return np_tree(init(jsmoke(name), jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------- SSM
@pytest.mark.parametrize("S", [2, 10, 40])
def test_ssm_forward_and_decode(S):
    """S = 2 < conv - 1 (the conv state's left padding), 10 within one
    scan chunk (ssm_chunk 16), 40 across three; then two decode steps
    from the returned state."""
    cfg = smoke_config("hymba-1.5b")
    jcfg = jsmoke("hymba-1.5b")
    p = layer_params("hymba-1.5b", jssm.ssm_init)
    rng = np.random.default_rng(S)
    x = rand(rng, 2, S, cfg.d_model)
    want, wstate = jssm.ssm_forward(jcfg, p, jnp.asarray(x))
    tp = t_tree(p)
    got, state = tssm.ssm_forward(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close(state, wstate, **STATE_TOL)
    for step in range(2):
        xt = rand(rng, 2, 1, cfg.d_model)
        want, wstate = jssm.ssm_decode(jcfg, p, jnp.asarray(xt), wstate)
        got, state = tssm.ssm_decode(cfg, tp, torch.from_numpy(xt), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_tree_close(state, wstate, **STATE_TOL)


# ---------------------------------------------------------------- MLA
def test_mla_full_and_decodes():
    """The non-absorbed prefill (its cache entries too), then the
    absorbed decode against one layer's latent cache and the in-place
    decode against the stacked caches, from the prefill's latent."""
    name = "deepseek-v3-671b"
    cfg, jcfg = smoke_config(name), jsmoke(name)
    p = layer_params(name, jattn.mla_init)
    tp = t_tree(p)
    rng = np.random.default_rng(1)
    B, S, max_seq = 2, 20, 24
    x = rand(rng, B, S, cfg.d_model)
    pos = np.arange(S)[None, :]
    want, wc = jattn.mla_full(jcfg, p, jnp.asarray(x), jnp.asarray(pos))
    got, c = tattn.mla_full(cfg, tp, torch.from_numpy(x),
                            torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close(c, wc, **TOL)

    pad = lambda a: np.pad(np.asarray(a), ((0, 0), (0, max_seq - S), (0, 0)))
    jcache = {k: jnp.asarray(pad(v)) for k, v in wc.items()}
    lens = np.array([S, 13], np.int32)
    xt = rand(rng, B, 1, cfg.d_model)
    want, wnew = jattn.mla_decode(jcfg, p, jnp.asarray(xt), jcache,
                                  jnp.asarray(lens))
    tcache = {k: torch.from_numpy(pad(v)) for k, v in wc.items()}
    got, new = tattn.mla_decode(cfg, tp, torch.from_numpy(xt), tcache,
                                torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close(new, wnew, **TOL)
    assert torch.equal(tcache["ckv"], torch.from_numpy(pad(wc["ckv"])))

    full = {k: torch.stack([v, v]) for k, v in tcache.items()}
    got, ckv, krope = tattn.mla_decode_carry(
        cfg, tp, torch.from_numpy(xt), full["ckv"], full["krope"], 1,
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ckv is full["ckv"]
    np.testing.assert_allclose(ckv[1].numpy(), np.asarray(wnew["ckv"]),
                               **TOL)
    np.testing.assert_allclose(krope[1].numpy(), np.asarray(wnew["krope"]),
                               **TOL)
    assert torch.equal(ckv[0], tcache["ckv"])


# ---------------------------------------------------------------- xLSTM
@pytest.mark.parametrize("block", ["mlstm", "slstm"])
def test_xlstm_blocks_and_decodes(block):
    """40 tokens (across the reference's 16-token scan chunks), then two
    decode steps from the returned state; -inf stabilizers at the start."""
    name = "xlstm-350m"
    cfg, jcfg = smoke_config(name), jsmoke(name)
    init = getattr(jxlstm, f"{block}_init")
    p = layer_params(name, init)
    tp = t_tree(p)
    jfwd, jdec = (getattr(jxlstm, f"{block}_{s}") for s in ("forward",
                                                          "decode"))
    tfwd, tdec = (getattr(txlstm, f"{block}_{s}") for s in ("forward",
                                                          "decode"))
    rng = np.random.default_rng(2)
    x = rand(rng, 2, 40, cfg.d_model)
    want, wstate = jfwd(jcfg, p, jnp.asarray(x))
    got, state = tfwd(cfg, tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_tree_close(state, wstate, **STATE_TOL)
    for _ in range(2):
        xt = rand(rng, 2, 1, cfg.d_model)
        want, wstate = jdec(jcfg, p, jnp.asarray(xt), wstate)
        got, state = tdec(cfg, tp, torch.from_numpy(xt), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert_tree_close(state, wstate, **STATE_TOL)


# ---------------------------------------------------------------- frontends
@pytest.mark.parametrize("name", ["internvl2-1b", "hubert-xlarge"])
def test_stub_frontends(name):
    """Vision: the projected image embeddings before the token
    embeddings; audio: projected frames plus learned positions."""
    cfg, jcfg = smoke_config(name), jsmoke(name)
    params, jparams, _ = family(name)
    rng = np.random.default_rng(3)
    jb, tb = inputs(cfg, rng, 2, 12)
    want = JT.embed_inputs(jcfg, jparams, jb)
    got = TT.embed_inputs(cfg, params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    P = cfg.n_prefix_embeds
    assert got.shape == (2, 12 + P, cfg.d_model)


# ---------------------------------------------------- B3's plain version
def test_flash_plain_at_mla_widths_vs_chunked_attention():
    """q/k 192, v 128 (deepseek's MLA prefill; the Pallas kernel takes
    only k.shape == v.shape): against the reference's chunked attention,
    in one chunk and in three."""
    rng = np.random.default_rng(4)
    q, k = rand(rng, 2, 40, 4, 192), rand(rng, 2, 40, 4, 192)
    v = rand(rng, 2, 40, 4, 128)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, layout="BSHD")
    assert got.shape == (2, 40, 4, 128)
    for chunk in (64, 16):
        want = jcommon.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True,
                                         chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,dh", [(False, 0, 80),
                                              (True, 8, 64),
                                              (True, 8, 80)])
def test_flash_plain_new_shapes_vs_pallas(causal, window, dh):
    """hubert's dh 80 non-causal, and a window of 8 over S = 40: the
    plain version against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    q = rand(rng, 1, 4, 40, dh)
    k, v = rand(rng, 1, 2, 40, dh), rand(rng, 1, 2, 40, dh)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, window=window)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, window=window, block_q=16, block_k=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [48, 40])
def test_flash_plain_window_vs_strip_sliced(S):
    """The reference's chunked attention with a static window slices K/V
    to the strip a 16-row query chunk can see (what the kernel does by
    skipping key tiles outside the window).  With whole chunks (S = 48)
    it agrees with the plain version.  With S = 40 its last strip runs
    past the keys, ``dynamic_slice`` moves it back, and the last chunk's
    rows (32-39) read the wrong keys: a fault of the reference kept out
    of the port (ROADMAP Queue C; hymba's prefill hits it when S is not a
    multiple of 1024), while the Pallas kernel agrees with the port."""
    rng = np.random.default_rng(11)
    q = rand(rng, 1, S, 4, 64)
    k, v = rand(rng, 1, S, 2, 64), rand(rng, 1, S, 2, 64)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=True, window=8, layout="BSHD").numpy()
    strip = np.asarray(jcommon.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=8, chunk=16))
    whole = S // 16 * 16
    np.testing.assert_allclose(got[:, :whole], strip[:, :whole], **TOL)
    if S > whole:
        assert np.abs(got[:, whole:] - strip[:, whole:]).min(-1).max() > 0
        assert np.abs(got[:, whole:] - strip[:, whole:]).max() > 0.1
        pallas = jflash(*(jnp.asarray(a).transpose(0, 2, 1, 3)
                          for a in (q, k, v)), causal=True, window=8,
                        block_q=16, block_k=16)
        np.testing.assert_allclose(
            got, np.asarray(pallas).transpose(0, 2, 1, 3), **TOL)


# ------------------------------------------------------------ families
@functools.lru_cache(maxsize=None)
def family(name):
    """(port params, reference params, reference config) of the reduced
    ``name``, on the same weights."""
    jcfg = jsmoke(name)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(0))
    params = from_jax_params(smoke_config(name), np_tree(jparams),
                             device="cpu")
    return params, jparams, jcfg


def inputs(cfg, rng, B, S):
    """The same batch for both packages: tokens, with image embeddings
    (vision stub) or frames (audio stub) where the frontend takes them."""
    if cfg.frontend == "audio_stub":
        arrs = {"frames": rand(rng, B, S, cfg.d_model)}
    else:
        arrs = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.frontend == "vision_stub":
            arrs["image_embeds"] = rand(rng, B, cfg.n_prefix_embeds,
                                        cfg.d_model)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


@pytest.mark.parametrize("impl", ["carry", "stacked"])
@pytest.mark.parametrize("name", ["hymba-1.5b", "deepseek-v3-671b",
                                  "xlstm-350m", "internvl2-1b"])
def test_family_prefill_and_greedy_decode(name, impl):
    """Right-padded rows (lengths 20 and 13 of 20 positions past any
    prefix), so hymba's window of 16 cuts in prefill and decode: prefill
    logits within 1e-4, then 8 greedy tokens identical and every step's
    logits within 1e-4."""
    params, jparams, jcfg = family(name)
    jcfg = dataclasses.replace(jcfg, decode_impl=impl)
    cfg = dataclasses.replace(smoke_config(name), decode_impl=impl)
    rng = np.random.default_rng(6)
    B, S = 2, 20
    jb, tb = inputs(cfg, rng, B, S)
    P = cfg.n_prefix_embeds
    lens = np.array([S + P, 13 + P], np.int32)
    max_seq = S + P + 8
    wlog, wcache = jprefill(jcfg, jparams, jb, max_seq, jnp.asarray(lens))
    log, cache = TT.prefill(cfg, params, tb, max_seq,
                            torch.from_numpy(lens))
    np.testing.assert_allclose(log.numpy(), np.asarray(wlog), rtol=1e-4,
                               atol=1e-4)
    wtok = np.asarray(jnp.argmax(wlog, -1))
    tok = log.argmax(-1).numpy()
    for step in range(8):
        assert (tok == wtok).all(), (step, tok, wtok)
        if step == 7:
            break
        wlog, wcache = jdecode(jcfg, jparams, wcache,
                               jnp.asarray(wtok[:, None], jnp.int32))
        log, cache = TT.decode_step(cfg, params, cache,
                                    torch.from_numpy(tok[:, None]))
        np.testing.assert_allclose(log.numpy(), np.asarray(wlog),
                                   rtol=1e-4, atol=1e-4)
        wtok, tok = np.asarray(jnp.argmax(wlog, -1)), log.argmax(-1).numpy()
    assert (cache["pos"].numpy() == lens + 7).all()


def test_hubert_forward_hidden_and_no_decode():
    """The encoder's entry point (non-causal, learned positions) within
    1e-4; its decode step refuses."""
    name = "hubert-xlarge"
    params, jparams, jcfg = family(name)
    cfg = smoke_config(name)
    rng = np.random.default_rng(7)
    jb, tb = inputs(cfg, rng, 2, 24)
    want, waux = JT.forward_hidden(jcfg, jparams, jb, remat=False)
    got, aux = TT.forward_hidden(cfg, params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) == float(waux) == 0.0
    with pytest.raises(ValueError, match="encoder-only"):
        TT.decode_step(cfg, params, {"groups": [], "pos": None},
                       torch.zeros((2, 1), dtype=torch.int32))


def test_deepseek_forward_hidden_and_moe_loss():
    """``forward_hidden`` over dense and MoE MLA layers: hidden states and
    the summed load-balance loss against the reference's."""
    name = "deepseek-v3-671b"
    params, jparams, jcfg = family(name)
    rng = np.random.default_rng(8)
    jb, tb = inputs(smoke_config(name), rng, 2, 16)
    want, waux = JT.forward_hidden(jcfg, jparams, jb, remat=False)
    got, aux = TT.forward_hidden(smoke_config(name), params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("name", ["hymba-1.5b", "deepseek-v3-671b",
                                  "xlstm-350m"])
def test_decode_matches_forward(name):
    """The reference's own identity (tests/test_models.py), in the port:
    prefill of 16 tokens then decoding token 16 gives the logits of a
    forward over all 17 (every cache path: windows and the SSM state,
    the MLA latent, the xLSTM states)."""
    params, _, _ = family(name)
    cfg = smoke_config(name)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)))
    _, cache = TT.prefill(cfg, params, {"tokens": tokens}, max_seq=20)
    tok = torch.zeros((2, 1), dtype=torch.int64)
    logits_d, _ = TT.decode_step(cfg, params, cache, tok)
    h, _ = TT.forward_hidden(cfg, params,
                             {"tokens": torch.cat([tokens, tok], dim=1)})
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits_f = (h[:, -1] @ head).float()
    np.testing.assert_allclose(logits_d.numpy(), logits_f.numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_family_caches_by_kind(name):
    """``init_cache`` builds each group's cache by kind, in the shapes and
    dtypes of the reference's ``init_cache``."""
    cfg, jcfg = smoke_config(name), jsmoke(name)
    want = jax.eval_shape(lambda: JT.init_cache(jcfg, 3, 10))
    got = TT.init_cache(cfg, 3, 10, device="cpu")

    def check(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                check(g[k], w[k])
        elif isinstance(w, list):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                check(a, b)
        else:
            assert tuple(g.shape) == w.shape
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    check(got, want)
    assert get_config(name).name == name


def test_slstm_state_takes_the_reference_padding_steps():
    """A fault of the reference kept for parity (ROADMAP Queue C): its
    chunked scan pads 40 tokens to 48 with zero inputs and returns the
    state after those 8 extra steps.  With the forget gates open (the
    init's bias 3) the stabilizer m grows by about 3 a token and the
    extra steps change nothing that fp32 holds; with them closed (bias
    -10) m stays near the input gates, below 0 for some units, and each
    extra step adds about 1 to n there.  The port's forward gives the
    reference's state, not the one 40 single-token steps give, while
    the 40 outputs agree."""
    name = "xlstm-350m"
    cfg, jcfg = smoke_config(name), jsmoke(name)
    p = dict(layer_params(name, jxlstm.slstm_init))
    p["f_bias"] = np.full_like(p["f_bias"], -10.0)
    tp = t_tree(p)
    x = torch.from_numpy(rand(np.random.default_rng(10), 2, 40,
                              cfg.d_model))
    out, state = txlstm.slstm_forward(cfg, tp, x)
    steps = txlstm.slstm_cache_init(cfg, 2, "cpu")
    outs = []
    for t in range(40):
        o, steps = txlstm.slstm_decode(cfg, tp, x[:, t:t + 1], steps)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), out.numpy(),
                               **TOL)
    _, want = jxlstm.slstm_forward(jcfg, p, jnp.asarray(x.numpy()))
    assert_tree_close(state, want, **STATE_TOL)
    assert (state["n"] - steps["n"]).abs().max() > 0.5
