"""Dense MLP (SwiGLU / GELU) and the Mixture-of-Experts FFN.  Weights are
``(in, out)``: ``x @ W``.

The MoE layer is the reference's capacity-based dispatch: top-k routing
in fp32, a sort-based rank of each assignment within its expert, a
scatter into an (experts, capacity, d) buffer, batched expert products,
and a gate-weighted gather back.  Every shape is fixed by the token count
T, top-k K and the expert count E, and nothing reads the device from the
host, so the layer never waits on the card.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def _act(cfg, h: torch.Tensor, g: torch.Tensor = None) -> torch.Tensor:
    """SwiGLU's ``silu(g) * h``, else GELU of ``h`` (``jax.nn.gelu``
    defaults to the tanh approximation)."""
    if cfg.act == "swiglu":
        return F.silu(g) * h
    return F.gelu(h, approximate="tanh")


def mlp_apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
    g = x @ p["wg"] if cfg.act == "swiglu" else None
    return _act(cfg, x @ p["wi"], g) @ p["wo"]


def _position_in_expert(flat_e: torch.Tensor, n_experts: int
                        ) -> torch.Tensor:
    """Rank of each assignment within its expert, in assignment order
    (a stable sort, as ``jnp.argsort``; no (N, E) one-hot)."""
    n = flat_e.shape[0]
    idx = flat_e.long()
    order = torch.argsort(idx, stable=True)
    counts = torch.zeros(n_experts, dtype=torch.long, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(n, device=idx.device) - starts[idx[order]]
    pos = torch.empty_like(idx).scatter_(0, order, ranks)
    return pos.to(torch.int32)


def moe_capacity(cfg, T: int) -> int:
    """Rows per expert for a pass over T tokens: T (dropless: top-k
    experts are distinct per token) up to 64 tokens, else the
    capacity-factor-scaled mean load with a floor of 8."""
    if T <= 64:
        return T
    return max(int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor), 8)


def route(cfg, router: torch.Tensor, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of T tokens ``xt`` (T, d), in fp32: (probs (T, E), gate
    values (T, K) renormalised over the top k, expert ids (T, K) in
    descending order of probability)."""
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    # a stable descending sort breaks ties to the lower expert, as
    # jax.lax.top_k does (torch.topk promises no order)
    gate_vals, topk_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, topk_idx = gate_vals[:, :cfg.top_k], topk_idx[:, :cfg.top_k]
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True), topk_idx


def moe_apply(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d).  Returns (out (B, S, d), the Switch-style
    load-balance loss, an fp32 scalar)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dt = x.dtype
    xt = x.reshape(T, d)
    probs, gate_vals, topk_idx = route(cfg, p["router"], xt)

    # E * sum_e f_e * p_e; the top-1 counts by scatter (bincount and
    # one_hot's checks read the device)
    top1 = torch.zeros(E, dtype=torch.float32, device=x.device)
    top1.scatter_add_(0, topk_idx[:, 0], torch.ones_like(probs[:, 0]))
    aux = E * torch.sum(top1 / T * probs.mean(0))

    N = T * K
    flat_e = topk_idx.reshape(N)
    pos = _position_in_expert(flat_e, E).long()
    cap = moe_capacity(cfg, T)
    keep = pos < cap

    # token-major repeat (jnp.repeat); a dropped assignment adds zero to
    # its expert's row 0, and every kept one owns its row, so the
    # accumulating scatter is exact in any order
    x_rep = xt[:, None].expand(T, K, d).reshape(N, d)
    rows = flat_e * cap + torch.where(keep, pos, 0)
    buf = torch.zeros((E * cap, d), dtype=dt, device=x.device)
    buf.index_add_(0, rows, torch.where(keep[:, None], x_rep, 0))
    buf = buf.view(E, cap, d)

    g = torch.bmm(buf, p["wg"]) if cfg.act == "swiglu" else None
    h = _act(cfg, torch.bmm(buf, p["wi"]), g)
    out_buf = torch.bmm(h, p["wo"]).view(E * cap, d)

    gathered = out_buf.index_select(0, rows)                  # (N, d)
    gathered = gathered * (gate_vals.reshape(N, 1).to(dt)
                           * keep[:, None].to(dt))
    out = gathered.view(T, K, d).sum(1)

    if cfg.n_shared_experts:
        out = out + mlp_apply(cfg, p["shared"], xt)
    return out.view(B, S, d), aux
