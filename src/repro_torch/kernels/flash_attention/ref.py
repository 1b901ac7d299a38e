"""Plain PyTorch version of the dense flash-attention kernel: exact masked
softmax attention over the whole key axis.  The CPU path of
``ops.flash_attention`` and the oracle the CUDA kernel is held against on
the card."""

from __future__ import annotations

import math

import torch


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """q: (B, Hq, Sq, dh); k: (B, Hkv, Sk, dh); v: (B, Hkv, Sk, dv).  GQA
    by head folding (query head h reads kv head h // (Hq / Hkv)); scale
    1/sqrt(dh).  ``window`` > 0 keeps the keys with q_pos - k_pos <
    window.  Rows that see no key are 0.  returns (B, Hq, Sq, dv) in q's
    dtype."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    r = Hq // Hkv
    qg = q.reshape(B, Hkv, r, Sq, dh)
    s = torch.einsum("bhrqd,bhkd->bhrqk", qg.float(), k.float()) \
        / math.sqrt(dh)
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos >= k_pos
    if window and window > 0:
        ok &= (q_pos - k_pos) < window
    s = s.masked_fill(~ok, float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)        # rows that see no key
    out = torch.einsum("bhrqk,bhkd->bhrqd", w, v.float())
    return out.reshape(B, Hq, Sq, v.shape[3]).to(q.dtype)
