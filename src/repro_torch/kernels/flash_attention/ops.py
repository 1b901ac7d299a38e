"""Public wrapper of the dense flash-attention kernel
(``csrc/flash_attention.cu``; the dense prefill's attention,
``attention.gqa_full``, and every attention layer of the training
forward) and of its backward (``csrc/flash_attention_bwd.cu``).

On CUDA tensors it launches the hand-written Hopper kernels (built at
first use); on CPU tensors it runs the plain PyTorch version, the role
``interpret=True`` plays for the reference's Pallas kernel off the TPU,
and autograd differentiates that.  There is no fallback from one to the
other: a CUDA call the kernels cannot take raises.  When grad mode is on
and q, k or v requires grad, a CUDA call goes through
:class:`FlashAttention`: the forward also writes each row's log-sum-exp
and the backward launches the three backward kernels (D, dK/dV, dQ).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

CSRC = Path(__file__).resolve().parent / "csrc"
# (library name, source) of every kernel here, for build.build_all
SOURCES = (("flash_attention", CSRC / "flash_attention.cu"),
           ("flash_attention_bwd", CSRC / "flash_attention_bwd.cu"))
# (q/k head dim, v head dim) pairs the kernel is built for: the served
# configs' widths, MLA's (192, 128) among them
HEAD_DIMS = ((64, 64), (80, 80), (96, 96), (128, 128), (192, 128))
# the pairs the backward is built for: every config's training attention,
# MLA's (192, 128) among them
BWD_HEAD_DIMS = ((64, 64), (80, 80), (96, 96), (128, 128), (192, 128))
FOLDED_ROWS = 64               # fp32: (position, query head) rows per block
STATS_PAD = 64                 # the backward's statistics: rows per pad
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches so far (a run resets them to 0 and reads them back to
# show that its path went through the kernels)
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd_dot": 0,
            "flash_attention_bwd_dkdv": 0, "flash_attention_bwd_dq": 0}
BWD_KERNELS = ("flash_attention_bwd_dot", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")

_P = ctypes.c_void_p
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# C signatures.  forward: q, k, v, out, lse, strides; B, Hq, Hkv, Sq, Sk,
# dh, dv, causal, window; scale, dtype, stream.  D pass: out, dout, lse,
# stats, strides; B, Hq, Sq, dv, dtype; stream.  dK/dV and dQ passes: q,
# k, v, dout, stats, dq, dk, dv, strides; B, Hq, Hkv, Sq, Sk, dh, dv,
# causal, window; scale, dtype, stream.
_ARGTYPES = {
    "flash_attention": ([_P] * 5 + [_STRIDES] + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_int, _P]),
    "flash_attention_bwd_dot": ([_P] * 4 + [_STRIDES] + [ctypes.c_int] * 5
                                + [_P]),
    "flash_attention_bwd_dkdv": ([_P] * 8 + [_STRIDES] + [ctypes.c_int] * 9
                                 + [ctypes.c_float, ctypes.c_int, _P]),
}
_ARGTYPES["flash_attention_bwd_dq"] = _ARGTYPES["flash_attention_bwd_dkdv"]
_LIBRARY_OF = {"flash_attention": "flash_attention",
               **{k: "flash_attention_bwd" for k in BWD_KERNELS}}


def _library(name: str = "flash_attention") -> ctypes.CDLL:
    """The built library ``name`` (a key of ``SOURCES``), its C functions'
    signatures set."""
    lib = build.load(name, dict(SOURCES)[name])
    for fn_name, lib_name in _LIBRARY_OF.items():
        if lib_name != name:
            continue
        fn = getattr(lib, fn_name)         # the same object on every call
        if fn.argtypes is None:
            fn.argtypes = _ARGTYPES[fn_name]
            fn.restype = ctypes.c_int
    return lib


def _rows_aligned(t: torch.Tensor) -> bool:
    """Head dim contiguous, every row on a 16-byte boundary."""
    vec = 16 // t.element_size()
    st = t.stride()
    return (st[3] == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s, n in zip(st[:3], t.shape) if n > 1))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernel takes: (B, H, S, d) views of one device and dtype
    (float32 or bfloat16), (q/k's dh, v's dv) in HEAD_DIMS, Hq a multiple
    of Hkv, the head dim contiguous and every row starting on a 16-byte
    boundary."""
    B, Hq, Sq, dh = q.shape
    if (k.shape[:3] != v.shape[:3] or k.shape[0] != B
            or k.shape[3] != dh):
        raise ValueError(f"k and v must be ({B}, Hkv, Sk, {dh}) and ({B}, "
                         f"Hkv, Sk, dv), got {tuple(k.shape)}/"
                         f"{tuple(v.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{k.shape[1]} kv heads")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"k/v on {k.device}/{v.device}, q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, "
                        f"bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"k and v must have q's dtype {q.dtype}, got "
                        f"{k.dtype}/{v.dtype}")
    if (dh, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (q/k {dh}, v {v.shape[3]}) not "
                         f"supported ({HEAD_DIMS})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t)
    # grids: fp32 (Hkv, B, query tiles of FOLDED_ROWS folded rows); bf16
    # the backward's dQ (position blocks, B * Hq) and dK/dV (key blocks,
    # B * Hkv), the forward's 1-D grid more
    if q.dtype == torch.float32:
        too_large = (B > 65535 or k.shape[1] > 65535
                     or -(-Sq * (Hq // k.shape[1]) // FOLDED_ROWS) > 65535)
    else:
        too_large = B * Hq > 65535
    if too_large:
        raise ValueError(f"grid too large: batch {B}, {k.shape[1]} kv "
                         f"heads, {Sq} queries of {Hq} heads")


def _check_rows(name: str, t: torch.Tensor) -> None:
    if t.stride()[3] != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    if not _rows_aligned(t):
        raise ValueError(f"{name}'s rows must start on 16-byte boundaries")


def _check_grad(dout: torch.Tensor, out: torch.Tensor) -> None:
    """What the backward takes besides the forward's inputs: dO of the
    output's shape, dtype and device, head dim contiguous and rows on
    16-byte boundaries."""
    if dout.shape != out.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have the output's "
                         f"shape {tuple(out.shape)}")
    if dout.dtype != out.dtype or dout.device != out.device:
        raise TypeError(f"dout ({dout.dtype}, {dout.device}) must have the "
                        f"output's dtype and device ({out.dtype}, "
                        f"{out.device})")
    _check_rows("dout", dout)


def _bhsd(layout: str, *ts):
    """(B, H, S, d) views of tensors in ``layout``."""
    return [t.transpose(1, 2) if layout == "BSHD" else t for t in ts]


def _empty_like_layout(t: torch.Tensor, layout: str, d: int = None):
    """A fresh tensor of BHSD view ``t``'s shape (head dim ``d``), stored
    in ``layout``; returns (the layout's tensor, its BHSD view)."""
    B, H, S, dt = t.shape
    d = dt if d is None else d
    if layout == "BSHD":
        x = torch.empty((B, S, H, d), dtype=t.dtype, device=t.device)
        return x, x.transpose(1, 2)
    x = torch.empty((B, H, S, d), dtype=t.dtype, device=t.device)
    return x, x


def _forward(q, k, v, causal, window, layout, want_lse):
    """Launch B3 on BHSD views q, k, v; the output is stored in
    ``layout``.  Returns (output in the layout, its BHSD view, lse
    (B, Hq, Sq) fp32 or None)."""
    _check(q, k, v)
    B, Hq, Sq, dh = q.shape
    dv = v.shape[3]
    out_l, out = _empty_like_layout(q, layout, dv)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])
    with torch.cuda.device(q.device):
        err = _library().flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, strides, B, Hq,
            k.shape[1], Sq, k.shape[2], dh, dv, int(causal), int(window),
            1.0 / math.sqrt(dh), _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES["flash_attention"] += 1
    return out_l, out, lse


def _no_backward(dh: int, dv: int) -> None:
    if (dh, dv) not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash attention backward at head dims (q/k {dh}, v {dv}) is "
            f"not built; it takes {BWD_HEAD_DIMS}")


def _backward_passes(q, k, v, out, lse, dout, causal, window, layout):
    """The three backward kernels on BHSD views (q, k, v, the forward's
    output and lse, dout), not yet launched: ((dq, dk, dv) in ``layout``,
    fresh, {kernel name: launch}), the launches in ``BWD_KERNELS`` order,
    each raising if its kernel is refused and run with q's device
    current.  The D pass writes each row's statistics, (lse in log2
    units, D) as fp32 pairs (B, Hq, Sq rounded up to 64), which the dK/dV
    and dQ passes read; bf16 reads q, k, v and dout by TMA, whose bases
    and strides ``_check`` holds to 16 bytes."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    _no_backward(dh, dv)
    _check(q, k, v)
    _check_grad(dout, out)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _DTYPE_CODE[q.dtype]
    stats = torch.empty((B, Hq, -(-Sq // STATS_PAD) * STATS_PAD, 2),
                        dtype=torch.float32, device=q.device)
    dq_l, dq = _empty_like_layout(q, layout)
    dk_l, dk = _empty_like_layout(k, layout)
    dv_l, dvt = _empty_like_layout(v, layout)
    strides = (ctypes.c_longlong * 21)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *dout.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
        *dvt.stride()[:3])
    dot_strides = (ctypes.c_longlong * 6)(*out.stride()[:3],
                                          *dout.stride()[:3])
    lib = _library("flash_attention_bwd")

    passes = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
              stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvt.data_ptr(),
              strides, B, Hq, Hkv, Sq, Sk, dh, dv, int(causal), int(window),
              1.0 / math.sqrt(dh), code, stream)
    args = {"flash_attention_bwd_dot": (
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
        dot_strides, B, Hq, Sq, dv, code, stream),
        "flash_attention_bwd_dkdv": passes, "flash_attention_bwd_dq": passes}

    def launcher(name):                 # on q's device, made current
        fn = getattr(lib, name)

        def launch():
            err = fn(*args[name])
            if err != 0:
                raise RuntimeError(f"{name} launch failed: CUDA error {err}")
            LAUNCHES[name] += 1
        return launch
    return (dq_l, dk_l, dv_l), {name: launcher(name) for name in BWD_KERNELS}


def _backward(q, k, v, out, lse, dout, causal, window, layout):
    """The three backward kernels on BHSD views (q, k, v, the forward's
    output and lse, dout); the gradients are stored in ``layout``.
    Returns (dq, dk, dv) in the layout."""
    grads, launches = _backward_passes(q, k, v, out, lse, dout, causal,
                                       window, layout)
    with torch.cuda.device(q.device):
        for launch in launches.values():
            launch()
    return grads


class FlashAttention(torch.autograd.Function):
    """B3 with its hand-written backward, on CUDA tensors in ``layout``
    ("BHSD" or "BSHD"): the forward keeps q, k, v, the output and each
    row's log-sum-exp; the backward launches the D, dK/dV and dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, layout):
        qb, kb, vb = _bhsd(layout, q, k, v)
        out_l, _out, lse = _forward(qb, kb, vb, causal, window, layout,
                                    want_lse=True)
        ctx.save_for_backward(q, k, v, out_l, lse)
        ctx.causal, ctx.window, ctx.layout = causal, window, layout
        return out_l

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout_l):
        q, k, v, out_l, lse = ctx.saved_tensors
        layout = ctx.layout
        qb, kb, vb, out, dout = _bhsd(layout, q, k, v, out_l, dout_l)
        if not _rows_aligned(dout):              # e.g. a broadcast gradient
            dout = _bhsd(layout, dout_l.contiguous())[0]
        dq, dk, dv = _backward(qb, kb, vb, out, lse, dout, ctx.causal,
                               ctx.window, layout)
        return dq, dk, dv, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` (BHSD)
    for the output's gradient ``dout``, given the forward's output ``out``
    and log-sum-exp ``lse`` (``flash_attention_fwd``).  On CUDA tensors
    the three backward kernels; on CPU tensors autograd through the plain
    version (``out`` and ``lse`` unused)."""
    if not q.is_cuda:
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = flash_attention_ref(*qkv, causal=causal, window=window)
            return torch.autograd.grad(o, qkv, dout)
    return _backward(q, k, v, out, lse, dout, causal, window, "BHSD")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0):
    """B3's forward as the backward needs it, on BHSD CUDA tensors:
    (output, lse (B, Hq, Sq) fp32)."""
    out, _, lse = _forward(q, k, v, causal, window, "BHSD", want_lse=True)
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: int = 128, block_k: int = 128,
                    layout: str = "BHSD") -> torch.Tensor:
    """Dense flash attention.  layout "BHSD": q (B, Hq, Sq, dh), k
    (B, Hkv, Sk, dh), v (B, Hkv, Sk, dv); "BSHD" (the model's): q
    (B, Sq, Hq, dh), k (B, Sk, Hkv, dh), v (B, Sk, Hkv, dv); the output
    has q's layout, dtype and leading dims, and v's head dim dv (MLA's
    prefill: dh 192, dv 128; elsewhere dv == dh).

    GQA (query head h reads kv head h // (Hq / Hkv)), causal and/or
    sliding-window mask (``window`` > 0 keeps q_pos - k_pos < window),
    scale 1/sqrt(dh), rows that see no key are 0.  ``block_q`` and
    ``block_k`` are the Pallas kernel's tiling knobs, kept for the
    reference's signature: the CUDA kernel tiles by its own constants and
    needs no padding.

    On CUDA tensors bf16 runs both products as ``wgmma`` on K/V tiles fed
    by TMA and fp32 on the CUDA cores (never TF32), chosen by dtype alone;
    bf16 reads q, k and v through tensor maps of their own strides, so
    bases and strides keep to 16 bytes (``_check``).  With grad mode
    on and q, k or v requiring grad, a CUDA call goes through
    :class:`FlashAttention` (head dims in ``BWD_HEAD_DIMS``; others raise
    ``NotImplementedError``); on CPU tensors autograd differentiates the
    plain version.
    """
    if layout not in ("BHSD", "BSHD"):
        raise ValueError(f"layout {layout!r}: 'BHSD' or 'BSHD'")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"bad ranks: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.is_cuda:
        qb, kb, vb = _bhsd(layout, q, k, v)
        out = flash_attention_ref(qb, kb, vb, causal=causal, window=window)
        return out.transpose(1, 2) if layout == "BSHD" else out
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        _no_backward(q.shape[3], v.shape[3])
        return FlashAttention.apply(q, k, v, causal, window, layout)
    qb, kb, vb = _bhsd(layout, q, k, v)
    return _forward(qb, kb, vb, causal, window, layout, want_lse=False)[0]
