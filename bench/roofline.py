"""The yardstick's arithmetic: the card's peaks, the least time of B1's
paged chunk attention, and the model FLOPs of a fused step's real tokens.

``b1_bound`` is a frozen copy of ``chip_smoke.py::bound`` and
``roofline``: each input byte read once, the output written once,
4 * dh FLOPs a visible (query row, key) pair.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

# published H100 SXM peaks (NVIDIA data sheet, dense): bf16 FLOP/s and
# HBM bytes/s.  A card set below 700 W runs slower: its power limit is
# logged beside every run.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BPS = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def roofline(nbytes: float, flops: float, dtype: str) -> Tuple[float, str]:
    """(least seconds, what bounds it): the larger of bytes over HBM
    bandwidth and operations over the peak rate of the input type."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def b1_bound(B: int, Hkv: int, C: int, r: int, dh: int, page: int,
             lengths: Sequence[int], starts: Sequence[int], dtype: str
             ) -> Tuple[float, str, float, float]:
    """(least seconds, bound by, bytes, FLOPs) of one B1 launch on a
    (B, Hkv, C, r, dh) query block: rows past ``len(lengths)`` are padded
    (length 0).  Reads lengths and starts; for rows with a length, q, the
    table entries of the pages below the length and the K/V of the keys
    below it; writes the whole output.  4 * dh FLOPs per (query row,
    visible key), a query at position p seeing min(length, p + 1) keys."""
    isz = ITEMSIZE[dtype]
    lens = np.zeros(B, np.int64)
    sts = np.zeros(B, np.int64)
    lens[:len(lengths)] = lengths
    sts[:len(starts)] = starts
    live = int((lens > 0).sum())
    nbytes = B * Hkv * C * r * dh * isz                    # out, every row
    nbytes += live * Hkv * C * r * dh * isz                # q of live rows
    nbytes += int(lens.sum()) * Hkv * dh * 2 * isz         # K and V
    nbytes += int(((lens + page - 1) // page).sum()) * Hkv * 4  # tables
    nbytes += 2 * B * 4                                    # lengths, starts
    qpos = sts[:, None] + np.arange(C)[None, :]
    visible = np.clip(np.minimum(lens[:, None], qpos + 1), 0, None)
    flops = 4.0 * dh * float(visible.sum()) * r * Hkv
    t, by = roofline(nbytes, flops, dtype)
    return t, by, float(nbytes), flops


def layer_params(cfg: Dict) -> Dict[str, float]:
    """Parameters of one layer: ``attention`` (q, k, v, o projections),
    ``ffn_active`` (the MLP, or the router and top-k experts a token
    goes through) and ``ffn`` (every expert); and the LM head's."""
    d, H, Hkv, dh = (cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"],
                     cfg["head_dim"])
    attn = d * H * dh * 2 + d * Hkv * dh * 2
    E = cfg.get("n_experts", 0)
    if E:
        expert = 3 * d * cfg["moe_d_ff"]
        active = cfg["top_k"] * expert + d * E
        ffn = E * expert + d * E
    else:
        active = ffn = 3 * d * cfg["d_ff"]
    return {"attention": float(attn), "ffn_active": float(active),
            "ffn": float(ffn), "lm_head": float(d * cfg["vocab_size"])}


def model_params(cfg: Dict) -> float:
    """Every parameter: the layers, the embedding and the LM head (norm
    scales left out)."""
    p = layer_params(cfg)
    return (cfg["n_layers"] * (p["attention"] + p["ffn"])
            + 2 * p["lm_head"])


def row_flops(cfg: Dict, start: int, n: int, logits: bool) -> float:
    """Model FLOPs of ``n`` real tokens at positions start .. start + n
    - 1 of one sequence: 2 FLOPs a multiply-add of every active weight
    per token, 4 * dh per (query head, visible key) per layer (a token at
    position p sees p + 1 keys), and the LM head where the row's logits
    are taken.  Padded rows and positions count nothing."""
    p = layer_params(cfg)
    visible = n * start + n * (n + 1) / 2
    per_layer = (2.0 * n * (p["attention"] + p["ffn_active"])
                 + 4.0 * cfg["head_dim"] * cfg["n_heads"] * visible)
    return cfg["n_layers"] * per_layer + (2.0 * p["lm_head"]
                                          if logits else 0.0)
