"""Shared model building blocks: norms, RoPE and the dense decode
attention.

Plain functions on tensors.  Compute follows the reference's
mixed-precision discipline: matmuls in the config dtype (bf16 at full
size), norm statistics and rotary angles in fp32.
"""

from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def cdtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                          device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to
    (..., seq).  Rotate-half split (not interleaved pairs)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].float() * freqs            # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, scale: float) -> torch.Tensor:
    """q: (B, Sq, Hq, dh); k, v: (B, Sk, Hkv, d*); ``bias`` (fp32,
    additive) broadcast to (B, Hkv, r, Sq, Sk).  GQA by folding
    Hq = Hkv * r.  Scores and softmax in fp32, the weights rounded to v's
    dtype before the PV product (fp32 sums, one rounding of the output),
    as the reference's einsums with fp32 accumulation."""
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    r = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, r, dh)
    scores = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) \
        * scale
    w = torch.softmax(scores + bias, dim=-1).to(v.dtype)
    out = torch.einsum("bhrqk,bkhd->bqhrd", w.float(), v.float())
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(v.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One-token decode: q (B, 1, Hq, dh); caches (B, S, Hkv, d*);
    kv_len (B,).  Masks positions >= kv_len (and < kv_len - window when
    ``window`` > 0).  The dense oracle's attention: plain PyTorch, as the
    reference's is plain jnp."""
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    k_pos = torch.arange(S, device=q.device)[None, :]
    lens = kv_len.long()[:, None]
    valid = k_pos < lens
    if window > 0:
        valid &= k_pos >= lens - window
    bias = torch.where(valid, 0.0, NEG_INF).float()[:, None, None, None, :]
    return attention_core(q, k_cache, v_cache, bias, scale)
