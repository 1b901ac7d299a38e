"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory), both with exponential gating and the max-stabilizer, as
the reference writes them (sLSTM with a diagonal recurrent connection).

The reference scans the recurrences over tokens in chunks of
``min(ssm_chunk, S)``, which bounds its rematerialisation; here each is a
plain loop over tokens with the same step.  The initial stabilizer ``m``
is -inf, and each step takes ``max`` before ``exp`` in the reference's
order, so the first step (where the forget term is dropped) gives the
same values.

One difference of chunking is kept: the reference pads the sequence with
zero inputs to a whole number of chunks and scans over the padding too,
so the state it returns has taken those extra steps (zero gates; for the
sLSTM, n grows at each).  The outputs of real tokens are unaffected.  The
port takes the same steps (``_padding_steps``), so a decode after its
prefill emits the reference's tokens; ROADMAP Queue C records the fault.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

State = Dict[str, torch.Tensor]


# ---------------------------------------------------------------- mLSTM
def mlstm_cache_init(cfg, batch: int, device) -> State:
    H, dh = cfg.n_heads, cfg.head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, dh, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H), -math.inf, **f32)}


def _mlstm_step(C, n, m, q, k, v, i_t, f_t):
    """One token: q/k/v (B, H, dh), gates (B, H); the state (C, n, m).
    Returns (C, n, m, h (B, H, dh) fp32)."""
    m_new = torch.maximum(f_t + m, i_t)
    # where m == -inf (no token yet) the forget term is 0
    f_p = torch.exp(torch.where(torch.isinf(m), -math.inf, f_t + m - m_new))
    i_p = torch.exp(i_t - m_new)
    kf, vf = k.float(), v.float()
    C = f_p[..., None, None] * C + i_p[..., None, None] * (
        kf[..., :, None] * vf[..., None, :])
    n = f_p[..., None] * n + i_p[..., None] * kf
    qf = q.float()
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhd,bhd->bh", n, qf)), min=1.0)
    return C, n, m_new, num / den[..., None]


def _gates_qkv(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor):
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    # sqrt(dh) in x's dtype, as the reference rounds it
    scale = float(torch.tensor(math.sqrt(dh), dtype=x.dtype))
    q = (x @ p["wq"]).reshape(B, S, H, dh) / scale
    k = (x @ p["wk"]).reshape(B, S, H, dh) / scale
    v = (x @ p["wv"]).reshape(B, S, H, dh)
    i_t = x.float() @ p["wi"]
    f_t = (x.float() @ p["wf"]) + p["f_bias"]
    return q, k, v, i_t, f_t


def _mlstm_out(cfg, p, x, h):
    """Output gate and projection of h (B, S, H, dh) fp32."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    o = torch.sigmoid((x @ p["wo_gate"]).reshape(B, S, H, dh).float())
    return (h * o).to(x.dtype).reshape(B, S, H * dh) @ p["out_proj"]


def _padding_steps(cfg, S: int) -> int:
    """Zero-input steps the reference's chunked scan appends to S tokens."""
    return -S % min(cfg.ssm_chunk, S)


def _mlstm_scan(cfg, state: State, q, k, v, i_t, f_t
                ) -> Tuple[State, torch.Tensor]:
    """The recurrence over the S tokens of q/k/v (B, S, H, dh) and the
    gates (B, S, H), then the reference's padding steps: (state, h
    (B, S, H, dh) fp32)."""
    C, n, m = state["C"], state["n"], state["m"]
    hs = []
    for t in range(q.shape[1]):
        C, n, m, h = _mlstm_step(C, n, m, q[:, t], k[:, t], v[:, t],
                                 i_t[:, t], f_t[:, t])
        hs.append(h)
    zq, zi = torch.zeros_like(q[:, 0]), torch.zeros_like(i_t[:, 0])
    for _ in range(_padding_steps(cfg, q.shape[1])):
        C, n, m, _h = _mlstm_step(C, n, m, zq, zq, zq, zi, zi)
    return {"C": C, "n": n, "m": m}, torch.stack(hs, dim=1)


def mlstm_forward(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> Tuple[torch.Tensor, State]:
    """x: (B, S, d) -> (out (B, S, d), the state after the last token and
    the reference's padding steps)."""
    state, h = _mlstm_scan(cfg, mlstm_cache_init(cfg, x.shape[0], x.device),
                           *_gates_qkv(cfg, p, x))
    return _mlstm_out(cfg, p, x, h), state


def mlstm_decode(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cache: State) -> Tuple[torch.Tensor, State]:
    """x: (B, 1, d); returns (out (B, 1, d), the new state)."""
    q, k, v, i_t, f_t = _gates_qkv(cfg, p, x)
    C, n, m, h = _mlstm_step(cache["C"], cache["n"], cache["m"], q[:, 0],
                             k[:, 0], v[:, 0], i_t[:, 0], f_t[:, 0])
    return _mlstm_out(cfg, p, x, h[:, None]), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------- sLSTM
def slstm_cache_init(cfg, batch: int, device) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    d = cfg.d_model
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), -math.inf, **f32)}


def _slstm_step(r, c, n, h_prev, m, z_in, i_in, f_in, o_in):
    """One token: inputs (B, d) each, the state (c, n, h, m), the diagonal
    recurrence r (d,).  Returns the new (c, n, h, m)."""
    z_t = torch.tanh(z_in.float() + r * h_prev)
    i_t = i_in + r * h_prev
    f_t = f_in + r * h_prev
    m_new = torch.maximum(f_t + m, i_t)
    f_p = torch.exp(torch.where(torch.isinf(m), -math.inf, f_t + m - m_new))
    i_p = torch.exp(i_t - m_new)
    c = f_p * c + i_p * z_t
    n = f_p * n + i_p
    h = torch.sigmoid(o_in.float()) * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def _slstm_inputs(p: Dict[str, torch.Tensor], x: torch.Tensor):
    return (x @ p["wz"], x.float() @ p["wi"],
            (x.float() @ p["wf"]) + p["f_bias"], x @ p["wo_gate"])


def _slstm_scan(cfg, r: torch.Tensor, state: State, z_in, i_in, f_in,
                o_in) -> Tuple[State, torch.Tensor]:
    """The recurrence over the S tokens of the inputs (B, S, d), then the
    reference's padding steps: (state, h (B, S, d) fp32)."""
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    hs = []
    for t in range(z_in.shape[1]):
        c, n, h, m = _slstm_step(r, c, n, h, m, z_in[:, t], i_in[:, t],
                                 f_in[:, t], o_in[:, t])
        hs.append(h)
    out = torch.stack(hs, dim=1)
    zx, zf = torch.zeros_like(z_in[:, 0]), torch.zeros_like(i_in[:, 0])
    for _ in range(_padding_steps(cfg, z_in.shape[1])):
        c, n, h, m = _slstm_step(r, c, n, h, m, zx, zf, zf, zx)
    return {"c": c, "n": n, "h": h, "m": m}, out


def slstm_forward(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
                  ) -> Tuple[torch.Tensor, State]:
    """x: (B, S, d) -> (out (B, S, d), the state after the last token and
    the reference's padding steps)."""
    state, h = _slstm_scan(cfg, p["r_diag"],
                           slstm_cache_init(cfg, x.shape[0], x.device),
                           *_slstm_inputs(p, x))
    return h.to(x.dtype) @ p["out_proj"], state


def slstm_decode(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 cache: State) -> Tuple[torch.Tensor, State]:
    """x: (B, 1, d); returns (out (B, 1, d), the new state)."""
    z_in, i_in, f_in, o_in = _slstm_inputs(p, x[:, 0])
    c, n, h, m = _slstm_step(p["r_diag"], cache["c"], cache["n"],
                             cache["h"], cache["m"], z_in, i_in, f_in, o_in)
    out = (h.to(x.dtype) @ p["out_proj"])[:, None]
    return out, {"c": c, "n": n, "h": h, "m": m}
