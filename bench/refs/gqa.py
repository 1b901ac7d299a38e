"""Plain PyTorch reference of a decoder of GQA layers: RMSNorm, q/k/v
projections, per-head RMSNorm of q and k (qk-norm, where the config has
it), rotary embeddings on the rotate-half split, causal softmax attention
with each kv head shared by n_heads / n_kv_heads query heads, then a
SwiGLU MLP, or a top-k mixture of SwiGLU experts whose router softmax is
renormalised over the k chosen (every token reaches its k experts), each
with a residual; a final RMSNorm and the LM head.

Float32 throughout with TF32 off, one layer at a time, the weights read
from the parameter tree in the port's layout and upcast per layer (per
expert).  With ``fp8`` every product of weights and activations is
computed from float8 e4m3 values (weights scaled per output channel,
activations per token): the control, one precision below the configs'
bfloat16.  Imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

F8_MAX = 448.0


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its absolute max at the format's largest value)."""
    s = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / F8_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _weight(w: torch.Tensor, fp8: bool) -> torch.Tensor:
    """A weight (in, out) in float32, or its float8 values."""
    w = w.float()
    return _fp8(w, 0) if fp8 else w


def _matmul(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    return (_fp8(x, -1) if fp8 else x) @ _weight(w, fp8)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, dh) at positions 0 .. S - 1."""
    S, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, block: int) -> torch.Tensor:
    """Causal GQA: q (S, H, dh), k and v (S, Hkv, dh); query blocks of
    ``block`` rows."""
    S, H, dh = q.shape
    Hkv = k.shape[1]
    r = H // Hkv
    kt, vt = k.permute(1, 0, 2), v.permute(1, 0, 2)      # (Hkv, S, dh)
    out = torch.empty_like(q)
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        qb = q[s0:s1].reshape(s1 - s0, Hkv, r, dh).permute(1, 2, 0, 3)
        scores = qb @ kt[:, None, :s1].transpose(-1, -2) / math.sqrt(dh)
        pos = torch.arange(s0, s1, device=q.device)[:, None]
        mask = torch.arange(s1, device=q.device)[None, :] > pos
        scores.masked_fill_(mask, float("-inf"))
        o = torch.softmax(scores, dim=-1) @ vt[:, None, :s1]
        out[s0:s1] = o.permute(2, 0, 1, 3).reshape(s1 - s0, H, dh)
    return out


def _swiglu(x, wi, wg, wo, fp8: bool) -> torch.Tensor:
    h = torch.nn.functional.silu(_matmul(x, wg, fp8)) * _matmul(x, wi, fp8)
    return _matmul(h, wo, fp8)


def _moe(cfg: Dict, p: Dict, layer: int, x: torch.Tensor, fp8: bool
         ) -> torch.Tensor:
    """Every token through its top-k experts by router probability (ties
    to the lower expert), weighted by the probabilities renormalised over
    the k; no token dropped."""
    probs = torch.softmax(_matmul(x, p["router"][layer], fp8), dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg["top_k"]
    gates, experts = gates[:, :k], experts[:, :k]
    gates = gates / gates.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(x[tok], p["wi"][layer, e], p["wg"][layer, e],
                    p["wo"][layer, e], fp8)
        out.index_add_(0, tok, y * gates[tok, slot, None])
    return out


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, first: int,
           fp8: bool = False, block: int = 1024) -> torch.Tensor:
    """Float32 logits (S - first, vocab) at positions first .. S - 1 of
    the token sequence ``tokens`` (S,) on the parameters' device."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits(cfg, params, tokens, first, fp8, block)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def _logits(cfg, params, tokens, first, fp8, block):
    eps = cfg["norm_eps"]
    H, Hkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    g = params["groups"][0]
    a, m = g["attn"], g["mlp"]
    S = tokens.shape[0]
    x = params["embed"][tokens.long()].float()
    for li in range(cfg["n_layers"]):
        xn = _rms(x, g["attn_norm"][li], eps)
        q = _matmul(xn, a["wq"][li], fp8).view(S, H, dh)
        k = _matmul(xn, a["wk"][li], fp8).view(S, Hkv, dh)
        v = _matmul(xn, a["wv"][li], fp8).view(S, Hkv, dh)
        if cfg["qk_norm"]:
            q = _rms(q, a["q_norm"][li], eps)
            k = _rms(k, a["k_norm"][li], eps)
        q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
        o = _attention(q, k, v, block).reshape(S, H * dh)
        x = x + _matmul(o, a["wo"][li], fp8)
        xn = _rms(x, g["mlp_norm"][li], eps)
        if cfg.get("n_experts", 0):
            x = x + _moe(cfg, m, li, xn, fp8)
        else:
            x = x + _swiglu(xn, m["wi"][li], m["wg"][li], m["wo"][li], fp8)
    h = _rms(x[first:], params["final_norm"], eps)
    head = _weight(params["lm_head"], fp8)
    out = torch.empty((S - first, head.shape[1]), dtype=torch.float32,
                      device=x.device)
    for s0 in range(0, S - first, block):
        hb = h[s0:s0 + block]
        out[s0:s0 + block] = (_fp8(hb, -1) if fp8 else hb) @ head
    return out
