"""Model parameters of the port.

The layout mirrors the reference's pytree (``repro.models.transformer.
init_params``): ``{"groups": [one dict per layer group, every leaf
stacked on a leading layer axis], "embed", "final_norm", "lm_head"}``,
weight matrices ``(in, out)`` so ``x @ W`` matches ``x @ W`` there.

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
                      for g in params_np["groups"]],
           "embed": _to_torch(params_np["embed"], dev),
           "final_norm": _to_torch(params_np["final_norm"], dev)}
    if not cfg.tie_embeddings:
        out["lm_head"] = _to_torch(params_np["lm_head"], dev)
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


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> Params:
    """Seeded parameters of the fused serving path's dense GQA stack:
    truncated-normal fan-in weights, embeddings N(0, 1) * 0.02, unit norm
    scales and zero qkv biases, as the reference initialises them."""
    dev = resolve(device)
    dt = cdtype(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)
    groups = []
    for kind, L, _win in layer_groups(cfg):
        if kind != "gqa_mlp":
            raise NotImplementedError(
                f"layer kind {kind!r} is not ported (ROADMAP Queue A, "
                f"item 2: moe_apply; item 10: other model families)")
        a = {"wq": _dense(gen, L, d, H * dh, dt, dev),
             "wk": _dense(gen, L, d, Hkv * dh, dt, dev),
             "wv": _dense(gen, L, d, Hkv * dh, dt, dev),
             "wo": _dense(gen, L, H * dh, d, dt, dev)}
        if cfg.qkv_bias:
            for name, width in (("bq", H * dh), ("bk", Hkv * dh),
                                ("bv", Hkv * dh)):
                a[name] = torch.zeros((L, width), dtype=dt, device=dev)
        if cfg.qk_norm:
            a["q_norm"] = ones(L, dh)
            a["k_norm"] = ones(L, dh)
        g = {"attn_norm": ones(L, d), "attn": a, "mlp_norm": ones(L, d)}
        if cfg.d_ff:
            m = {"wi": _dense(gen, L, d, cfg.d_ff, dt, dev),
                 "wo": _dense(gen, L, cfg.d_ff, d, dt, dev)}
            if cfg.act == "swiglu":
                m["wg"] = _dense(gen, L, d, cfg.d_ff, dt, dev)
            g["mlp"] = m
        groups.append(g)
    embed = (torch.randn((cfg.vocab_size, d), generator=gen,
                         dtype=torch.float32, device=dev) * 0.02).to(dt)
    params = {"groups": groups, "embed": embed,
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = _dense(gen, 1, d, cfg.vocab_size, dt, dev)[0]
    return params
