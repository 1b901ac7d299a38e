"""Mamba-style selective SSM block: the SSM path of hymba's hybrid heads.

The reference runs the recurrence as a ``lax.scan`` over tokens in fp32
(chunked only to bound its rematerialisation).  Here it is a plain loop
over tokens with the same arithmetic: ``dA = exp(dt * A)``, ``dBx`` in
fp32, ``h = dA * h + dBx``, ``y = h . C``; the elementwise factors of a
chunk of ``ssm_chunk`` tokens are formed at once before its loop.  No TPU
kernel lies under the scan, so none is ported.  Decode is one step of the
same recurrence against a carried (conv_state, ssm_state).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import cdtype


def ssm_cache_init(cfg, batch: int, device) -> Dict[str, torch.Tensor]:
    """One layer's recurrent state: the conv window (batch, d_inner,
    conv - 1) in the compute dtype and the SSM state (batch, d_inner,
    n) in fp32, zeros."""
    return {
        "conv": torch.zeros((batch, cfg.d_inner, cfg.ssm_conv - 1),
                            dtype=cdtype(cfg), device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def _ssm_inputs(cfg, p: Dict[str, torch.Tensor], x_conv: torch.Tensor):
    """From the post-conv activation: (dt, Bmat, Cmat)."""
    n, r = cfg.ssm_state, cfg.ssm_dt_rank
    dbc = x_conv @ p["x_proj"]
    dt_lowrank, Bm, Cm = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(dt_lowrank @ p["dt_proj"] + p["dt_bias"].to(dbc.dtype))
    return dt, Bm, Cm


def _scan(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
          Bm: torch.Tensor, Cm: torch.Tensor, A: torch.Tensor, chunk: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan over the S tokens of x, dt (B, S, di), Bm, Cm
    (B, S, n) from state h (B, di, n) fp32: (final h, y (B, S, di) fp32)."""
    S = x.shape[1]
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        dtc = dt[:, sl]
        dA = torch.exp(dtc.float()[..., None] * A)           # (B, c, di, n)
        dBx = (dtc * x[:, sl]).float()[..., None] \
            * Bm[:, sl].float()[:, :, None, :]
        Cc = Cm[:, sl].float()
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            ys.append(torch.einsum("bdn,bn->bd", h, Cc[:, t]))
    return h, torch.stack(ys, dim=1)


def ssm_forward(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence selective scan.  x: (B, S, d) -> (out (B, S, d),
    the state after the last token: conv (B, di, k - 1), ssm (B, di, n))."""
    B, S, _ = x.shape
    di, n, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    x_in, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)

    # causal depthwise conv over the sequence, on the left-padded input
    xc = F.pad(x_in.transpose(1, 2), (k - 1, 0))              # (B, di, S+k-1)
    x_conv = F.conv1d(xc, p["conv_w"][:, None, :].to(xc.dtype),
                      groups=di).transpose(1, 2)
    x_conv = F.silu(x_conv + p["conv_b"].to(x_conv.dtype))

    dt, Bm, Cm = _ssm_inputs(cfg, p, x_conv)
    A = -torch.exp(p["A_log"])                                # (di, n)
    h0 = torch.zeros((B, di, n), dtype=torch.float32, device=x.device)
    h, y = _scan(h0, x_conv, dt, Bm, Cm, A, min(cfg.ssm_chunk, S))
    y = y.to(x.dtype) + x_conv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    # the last k - 1 inputs of the conv, left-padded when S < k - 1
    conv = xc[:, :, -(k - 1):] if k > 1 else xc[:, :, :0]
    return out, {"conv": conv.contiguous(), "ssm": h}


def ssm_decode(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token step.  x: (B, 1, d); returns (out (B, 1, d), the new
    state — new tensors, the given ones are left as they were)."""
    x_in, z = torch.chunk(x[:, 0] @ p["in_proj"], 2, dim=-1)  # (B, di)
    conv_buf = torch.cat([cache["conv"], x_in[:, :, None]], dim=-1)
    x_conv = (conv_buf.float() * p["conv_w"].float()).sum(-1)
    x_conv = F.silu(x_conv + p["conv_b"].float()).to(x.dtype)

    dt, Bm, Cm = _ssm_inputs(cfg, p, x_conv)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt.float()[..., None] * A)
    dBx = (dt * x_conv).float()[..., None] * Bm.float()[:, None, :]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm.float()).to(x.dtype)
    y = y + x_conv * p["D"].to(x.dtype)
    y = y * F.silu(z)
    out = (y @ p["out_proj"])[:, None, :]
    return out, {"conv": conv_buf[:, :, 1:], "ssm": h}
