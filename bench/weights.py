"""Seeded weights in the port's parameter layout, made on the device.

The layout is ``repro_torch.weights.init_params``'s for a stack of
GQA layers with a dense SwiGLU MLP or a top-k MoE FFN (one layer group,
every leaf stacked on a leading layer axis; weights ``(in, out)``; the
router and the norm scales in float32).  Every leaf is one ``normal_``
call of a ``torch.Generator`` on the device, in the type it is served
in: fan-in scaled weights, embeddings N(0, 0.02), norm scales 1 + N(0,
0.1) (not all ones, so a scale applied wrongly shows).  The same tensors
are handed to the program and to the reference.
"""

from __future__ import annotations

from typing import Dict

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_params(cfg: Dict, seed: int, device, into: Dict = None) -> Dict:
    """The weights of ``seed``; with ``into`` (a tree this function made)
    drawn in place into its tensors, so a captured graph that reads them
    stays valid."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed & (2 ** 64 - 1))
    dt = DTYPES[cfg["dtype"]]
    old = iter(_leaves(into)) if into is not None else None

    def normal(shape, std, dtype=dt):
        t = (torch.empty(shape, dtype=dtype, device=dev) if old is None
             else next(old))
        return t.normal_(0.0, std, generator=gen)

    def scale(*shape):
        return normal(shape, 0.1, torch.float32).add_(1.0)

    L, d, V = cfg["n_layers"], cfg["d_model"], cfg["vocab_size"]
    H, Hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    attn = {"wq": normal((L, d, H * dh), d ** -0.5),
            "wk": normal((L, d, Hkv * dh), d ** -0.5),
            "wv": normal((L, d, Hkv * dh), d ** -0.5),
            "wo": normal((L, H * dh, d), (H * dh) ** -0.5)}
    if cfg["qk_norm"]:
        attn["q_norm"] = scale(L, dh)
        attn["k_norm"] = scale(L, dh)
    E = cfg.get("n_experts", 0)
    if E:
        ff = cfg["moe_d_ff"]
        mlp = {"router": normal((L, d, E), d ** -0.5, torch.float32),
               "wi": normal((L, E, d, ff), d ** -0.5),
               "wg": normal((L, E, d, ff), d ** -0.5),
               "wo": normal((L, E, ff, d), ff ** -0.5)}
    else:
        ff = cfg["d_ff"]
        mlp = {"wi": normal((L, d, ff), d ** -0.5),
               "wg": normal((L, d, ff), d ** -0.5),
               "wo": normal((L, ff, d), ff ** -0.5)}
    group = {"attn_norm": scale(L, d), "attn": attn,
             "mlp_norm": scale(L, d), "mlp": mlp}
    return {"groups": [group], "embed": normal((V, d), 0.02),
            "final_norm": scale(d), "lm_head": normal((d, V), d ** -0.5)}


def _leaves(tree):
    """The tree's tensors in the order ``make_params`` draws them."""
    g = tree["groups"][0]
    a, m = g["attn"], g["mlp"]
    out = [a["wq"], a["wk"], a["wv"], a["wo"]]
    out += [a[k] for k in ("q_norm", "k_norm") if k in a]
    out += [m[k] for k in ("router", "wi", "wg", "wo") if k in m]
    out += [g["attn_norm"], g["mlp_norm"], tree["embed"],
            tree["final_norm"], tree["lm_head"]]
    return out
