"""Dense MLP (SwiGLU / GELU).  Weights are ``(in, out)``: ``x @ W``.

The Mixture-of-Experts FFN waits for a later slice (ROADMAP Queue A,
item 2: ``moe_apply``).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def mlp_apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    h = x @ p["wi"]
    if cfg.act == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"]
