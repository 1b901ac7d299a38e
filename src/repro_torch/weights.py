"""Model parameters of the port.

The layout mirrors the reference's pytree (``repro.models.transformer.
init_params``): ``{"groups": [one dict per layer group, every leaf
stacked on a leading layer axis], "embed", "final_norm", "lm_head"}``
(the audio stub has ``in_proj`` and ``pos_embed`` instead of ``embed``,
the vision stub ``img_proj`` beside it), weight matrices ``(in, out)`` so
``x @ W`` matches ``x @ W`` there; MLA's ``wuk``/``wuv`` are (c, H, d)
and the SSM's ``conv_w`` (d_inner, conv), as there.

  * :func:`from_jax_params` copies the reference's parameters, handed
    over as numpy arrays — the bridge the parity tests run both packages
    on.
  * :func:`init_params` is the port's own seeded initialisation (same
    distributions, different random numbers), for machines without JAX.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.models.common import cdtype
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import layer_groups

Params = Dict[str, Any]


def _to_torch(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                          # an owned, writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_tree(v, fn) for v in x]
    return fn(x)


def from_jax_params(cfg: ModelConfig, params_np: Params,
                    device="cuda") -> Params:
    """The reference's ``init_params`` pytree (leaves as numpy arrays) as
    the port's parameters on ``device``: same keys, same layouts, same
    values."""
    dev = resolve(device)
    out = {"groups": [_tree(g, lambda a: _to_torch(a, dev))
                      for g in params_np["groups"]]}
    for key in ("embed", "final_norm", "lm_head", "in_proj", "pos_embed",
                "img_proj"):
        if key in params_np:
            out[key] = _to_torch(params_np[key], dev)
    return out


def _dense(gen: torch.Generator, L: int, in_dim: int, out_dim: int,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(L, in, out) truncated-normal fan-in init, std 1/sqrt(in), cut at
    ±2 std, drawn in fp32 one layer at a time."""
    w = torch.empty((L, in_dim, out_dim), dtype=dtype, device=device)
    std = 1.0 / math.sqrt(in_dim)
    for i in range(L):
        t = torch.empty((in_dim, out_dim), dtype=torch.float32,
                        device=device)
        torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=gen)
        w[i] = t
    return w


def _mlp(gen: torch.Generator, cfg: ModelConfig, L: int, ff: int,
         dt: torch.dtype, dev: torch.device) -> Params:
    d = cfg.d_model
    m = {"wi": _dense(gen, L, d, ff, dt, dev),
         "wo": _dense(gen, L, ff, d, dt, dev)}
    if cfg.act == "swiglu":
        m["wg"] = _dense(gen, L, d, ff, dt, dev)
    return m


def _moe(gen: torch.Generator, cfg: ModelConfig, L: int, dt: torch.dtype,
         dev: torch.device) -> Params:
    """The reference's ``moe_init`` layout: the router in fp32 whatever
    the config's dtype, expert weights (L, E, d, ff) and (L, E, ff, d),
    shared experts as one dense MLP of their combined width."""
    d, E = cfg.d_model, cfg.n_experts
    ff = cfg.moe_d_ff or cfg.d_ff
    # one (in, out) expert matrix drawn at a time: a whole layer in fp32
    # would not fit beside dbrx's weights
    experts = lambda i, o: _dense(gen, L * E, i, o, dt, dev).view(L, E, i, o)
    m = {"router": _dense(gen, L, d, E, torch.float32, dev),
         "wi": experts(d, ff), "wo": experts(ff, d)}
    if cfg.act == "swiglu":
        m["wg"] = experts(d, ff)
    if cfg.n_shared_experts:
        m["shared"] = _mlp(gen, cfg, L, ff * cfg.n_shared_experts, dt, dev)
    return m


def _ones(dev: torch.device, *shape) -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=dev)


def _gqa(gen: torch.Generator, cfg: ModelConfig, L: int, dt: torch.dtype,
         dev: torch.device) -> Params:
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a = {"wq": _dense(gen, L, d, H * dh, dt, dev),
         "wk": _dense(gen, L, d, Hkv * dh, dt, dev),
         "wv": _dense(gen, L, d, Hkv * dh, dt, dev),
         "wo": _dense(gen, L, H * dh, d, dt, dev)}
    if cfg.qkv_bias:
        for name, width in (("bq", H * dh), ("bk", Hkv * dh),
                            ("bv", Hkv * dh)):
            a[name] = torch.zeros((L, width), dtype=dt, device=dev)
    if cfg.qk_norm:
        a["q_norm"] = _ones(dev, L, dh)
        a["k_norm"] = _ones(dev, L, dh)
    return a


def _mla(gen: torch.Generator, cfg: ModelConfig, L: int, dt: torch.dtype,
         dev: torch.device) -> Params:
    """The reference's ``mla_init``: the up-projections ``wuk``/``wuv``
    drawn as (c, H * d) with fan-in c and kept as (c, H, d)."""
    d, H, c = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wdq": _dense(gen, L, d, cfg.q_lora_rank, dt, dev),
            "q_norm": _ones(dev, L, cfg.q_lora_rank),
            "wuq": _dense(gen, L, cfg.q_lora_rank, H * (dn + dr), dt, dev),
            "wdkv": _dense(gen, L, d, c + dr, dt, dev),
            "kv_norm": _ones(dev, L, c),
            "wuk": _dense(gen, L, c, H * dn, dt, dev).view(L, c, H, dn),
            "wuv": _dense(gen, L, c, H * dv, dt, dev).view(L, c, H, dv),
            "wo": _dense(gen, L, H * dv, d, dt, dev)}


def _ssm(gen: torch.Generator, cfg: ModelConfig, L: int, dt: torch.dtype,
         dev: torch.device) -> Params:
    """The reference's ``ssm_init``: ``conv_w`` N(0, 1) / sqrt(conv),
    ``dt_bias`` the inverse softplus of 0.01, S4D-real ``A_log`` =
    log(1..n), ``D`` ones (the last three in fp32)."""
    d, di, n, r, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                      cfg.ssm_dt_rank, cfg.ssm_conv)
    f32 = dict(dtype=torch.float32, device=dev)
    conv_w = torch.randn((L, di, k), generator=gen, **f32) / math.sqrt(k)
    a_init = torch.arange(1, n + 1, **f32).expand(L, di, n)
    return {"in_proj": _dense(gen, L, d, 2 * di, dt, dev),
            "conv_w": conv_w.to(dt),
            "conv_b": torch.zeros((L, di), dtype=dt, device=dev),
            "x_proj": _dense(gen, L, di, r + 2 * n, dt, dev),
            "dt_proj": _dense(gen, L, r, di, dt, dev),
            "dt_bias": torch.full((L, di), math.log(math.expm1(0.01)),
                                  **f32),
            "A_log": torch.log(a_init),
            "D": _ones(dev, L, di),
            "out_proj": _dense(gen, L, di, d, dt, dev)}


def _xlstm_pair(gen: torch.Generator, cfg: ModelConfig, L: int,
                dt: torch.dtype, dev: torch.device) -> Params:
    """The reference's ``mlstm_init`` and ``slstm_init``: gate weights in
    fp32, forget biases 3 (the forget gate open), the sLSTM's diagonal
    recurrence 0."""
    d, H, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    full = lambda width, v: torch.full((L, width), v, dtype=f32, device=dev)
    m = {"wq": _dense(gen, L, d, H * dh, dt, dev),
         "wk": _dense(gen, L, d, H * dh, dt, dev),
         "wv": _dense(gen, L, d, H * dh, dt, dev),
         "wi": _dense(gen, L, d, H, f32, dev),
         "wf": _dense(gen, L, d, H, f32, dev),
         "f_bias": full(H, 3.0),
         "wo_gate": _dense(gen, L, d, H * dh, dt, dev),
         "out_proj": _dense(gen, L, H * dh, d, dt, dev)}
    s = {"wz": _dense(gen, L, d, d, dt, dev),
         "wi": _dense(gen, L, d, d, f32, dev),
         "wf": _dense(gen, L, d, d, f32, dev),
         "wo_gate": _dense(gen, L, d, d, dt, dev),
         "f_bias": full(d, 3.0),
         "r_diag": full(d, 0.0),
         "out_proj": _dense(gen, L, d, d, dt, dev)}
    return {"m_norm": _ones(dev, L, d), "mlstm": m,
            "s_norm": _ones(dev, L, d), "slstm": s}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Seeded parameters of every layer kind and frontend, initialised as
    the reference initialises them: truncated-normal fan-in weights,
    embeddings (and learned positions) N(0, 1) * 0.02, unit norm scales,
    zero biases, and the SSM's and xLSTM's own constants.  On the
    ``meta`` device the tree has its shapes and dtypes and no values (the
    abstract inputs of ``launch.steps``)."""
    dev = resolve(device)
    dt = cdtype(cfg)
    gen = (None if dev.type == "meta"
           else torch.Generator(device=dev).manual_seed(seed))
    d = cfg.d_model
    groups = []
    for kind, L, _win in layer_groups(cfg):
        if kind == "xlstm_pair":
            groups.append(_xlstm_pair(gen, cfg, L, dt, dev))
            continue
        a = (_mla if kind.startswith("mla") else _gqa)(gen, cfg, L, dt, dev)
        g = {"attn_norm": _ones(dev, L, d), "attn": a}
        if kind == "hybrid":
            g.update(ssm=_ssm(gen, cfg, L, dt, dev),
                     attn_out_norm=_ones(dev, L, d),
                     ssm_out_norm=_ones(dev, L, d))
        g["mlp_norm"] = _ones(dev, L, d)
        if kind.endswith("moe"):
            g["mlp"] = _moe(gen, cfg, L, dt, dev)
        elif cfg.d_ff:
            g["mlp"] = _mlp(gen, cfg, L, cfg.d_ff, dt, dev)
        groups.append(g)
    normal = lambda *s: (torch.randn(s, generator=gen, dtype=torch.float32,
                                     device=dev) * 0.02).to(dt)
    params = {"groups": groups}
    if cfg.frontend == "audio_stub":
        params["in_proj"] = _dense(gen, 1, d, d, dt, dev)[0]
        if cfg.max_pos_embed:
            params["pos_embed"] = normal(cfg.max_pos_embed, d)
    else:
        params["embed"] = normal(cfg.vocab_size, d)
        if cfg.frontend == "vision_stub":
            params["img_proj"] = _dense(gen, 1, d, d, dt, dev)[0]
    params["final_norm"] = _ones(dev, d)
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, 1, d, cfg.vocab_size, dt, dev)[0]
    return params
