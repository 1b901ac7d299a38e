#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out PATH]

Phases, in order; any failure exits nonzero:

  1. card:    the card's name and power limit (nvidia-smi); TF32 off.
  2. build:   both paged-attention kernels compiled from
              src/repro_torch/kernels/paged_attention/csrc/, one nvcc
              process per source, all started together.
  3. kernels: each kernel against its plain PyTorch version, timed with
              CUDA events beside its bound and F.scaled_dot_product_attention
              over pre-gathered K/V.  B1 (chunked prefill) at the serving
              shapes of qwen3-14b (Hkv 8, r 5, dh 128, page 16; decode-only,
              prefill-only and mixed row batches in bf16, one fp32 batch);
              B2 (decode) on 16 decode rows with ragged contexts < 2048 at
              qwen3-14b's shapes in bf16 and fp32, an MHA r = 1 batch at dh
              64 and one at dh 96, a batch with padded rows (lengths 0) and
              one with out-of-range table entries.
  4. small:   a reduced fp32 engine on the GPU (kernels) against the same
              engine on the CPU (plain attention), under the fused step and
              under the split schedule: identical tokens, and split tokens
              == fused tokens.
  5. engine:  the port's InferenceEngine serving qwen3-14b at full width
              and depth with seeded random weights, on a simulated
              A100 + 3090 cluster whose two pool shards both live on this
              GPU, twice on the same weights and requests: under the fused
              step (one call per step, B1) and under the split schedule
              (a prefill-chunk call through B1 and a decode call through
              B2 per step).  Counts each kernel's launches over each run
              and re-runs two of its calls with plain attention to hold
              their logits against the kernel's (beside two more re-runs:
              P rounded, the noise floor; a page dropped, a fault the
              limit must catch).  With --profile the steps after the
              checked ones are traced (device activity only) and their busy
              and idle shares printed.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# FLOP/s per input type
HBM_BPS = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel vs plain: fp32 2e-5 (no TF32; sums in another order); bf16 2e-2
# (the kernel rounds P to bf16 before PV, the plain version does not)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# full-width call logits, kernel vs plain re-run, relative L2: near the
# geometric mean of the bf16 noise floor (plain with P rounded vs plain:
# 0.0145 and 0.0184 for the fused step on an H100) and a fault (plain with
# one page dropped vs plain: 0.72 and 1.38); PERF.md gives the readings
LOGITS_LIMIT = 0.1
NAMES = {"B1": "paged_prefill_attention", "B2": "paged_attention"}


def log(msg: str) -> None:
    print(msg, flush=True)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


# --------------------------------------------------------------- timing
def time_ms(fn, iters: int, flush) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each preceded by
    an L2 flush outside the timed window (the main path reads each layer's
    pages cold)."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def roofline(nbytes, flops, dname):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over the peak rate of the input type."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_kernel(name, got, ref, padded, dname):
    """Elementwise kernel-vs-plain gate; padded rows must be exactly 0."""
    err = (got.float() - ref.float()).abs()
    max_err = float(err.max())
    ok = bool((err <= TOL[dname] * (1 + ref.float().abs())).all())
    if not (ok and torch.isfinite(got).all()
            and bool((got[padded] == 0).all())):
        raise AssertionError(f"kernel disagrees with plain ({name}): "
                             f"max abs err {max_err}")
    return max_err


def report(kernel, name, shape, dname, max_err, ms, plain, lib, b_ms, b_by,
           nbytes, flops):
    log(f"{kernel} {name}: q {shape} {dname} max_abs_err {max_err:.3g} (tol "
        f"{TOL[dname]}) | kernel_ms {ms:.4f} plain_ms {plain:.4f} "
        f"library_ms {lib:.4f} bound_ms {b_ms:.4f} ({b_by}: {nbytes} B, "
        f"{flops:.4g} FLOP) roofline {b_ms / ms:.3f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                shape=shape, dtype=dname)


def ragged_contexts():
    rng = torch.Generator().manual_seed(1)
    return [int(x) for x in torch.randint(100, 2048, (16,), generator=rng)]


# ----------------------------------------------------------- B1 (prefill)
def make_rows(dev, dtype, rows, C, Hkv=8, r=5, dh=128, page=16,
              max_pages=128, seed=0):
    """Kernel inputs for ``rows`` of (start, n): n == 1 is a decode row,
    n > 1 a prefill chunk, n == 0 a padded row (lengths 0).  Each row
    owns its own random pages of a shared pool."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(rows)
    slots = B * Hkv * max_pages + 1
    tables = torch.randperm(slots - 1, generator=g, device=dev)[
        :B * Hkv * max_pages].reshape(B, Hkv, max_pages).to(torch.int32)
    starts = torch.tensor([s for s, _ in rows], dtype=torch.int32,
                          device=dev)
    lengths = torch.tensor([s + n if n else 0 for s, n in rows],
                           dtype=torch.int32, device=dev)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return (rnd(B, Hkv, C, r, dh), rnd(slots, page, dh),
            rnd(slots, page, dh), tables, lengths, starts)


def bound(args, dname):
    """(bound_ms, bound_by, bytes, flops): each byte the function needs
    read once and the output written once.  Reads: lengths and starts;
    for rows with lengths > 0 only, q, the table entries of the pages
    below the length and the K/V of the keys below it (a padded row's
    output is 0 whatever its q and tables hold).  4 * dh FLOPs per
    (query row, visible key)."""
    q, kpool, _, tables, lengths, starts = args
    B, Hkv, C, r, dh = q.shape
    page = kpool.shape[1]
    isz = q.element_size()
    lens = lengths.long().cpu()
    sts = starts.long().cpu()
    live = int((lens > 0).sum())
    nbytes = q.numel() * isz                               # out, every row
    nbytes += live * Hkv * C * r * dh * isz                # q of live rows
    nbytes += int(lens.sum()) * Hkv * dh * 2 * isz         # K and V
    nbytes += int(((lens + page - 1) // page).sum()) * Hkv * 4  # tables
    nbytes += 2 * B * 4                                    # lengths, starts
    qpos = sts[:, None] + torch.arange(C)[None, :]          # (B, C)
    visible = torch.minimum(lens[:, None], qpos + 1).clamp(min=0)
    flops = 4.0 * dh * float(visible.sum()) * r * Hkv
    return roofline(nbytes, flops, dname) + (nbytes, flops)


def sdpa_ms(args, flush):
    """One PyTorch call computing the same function: SDPA over K/V
    gathered to dense beforehand (outside the timing), with the causal +
    length mask."""
    import torch.nn.functional as F
    q, kpool, vpool, tables, lengths, starts = args
    B, Hkv, C, r, dh = q.shape
    page = kpool.shape[1]
    S = tables.shape[-1] * page
    bt = tables.long()
    K = kpool[bt].reshape(B, Hkv, S, dh)
    V = vpool[bt].reshape(B, Hkv, S, dh)
    qf = q.reshape(B, Hkv, C * r, dh)
    k_pos = torch.arange(S, device=q.device)
    q_pos = starts.long()[:, None] \
        + torch.arange(C * r, device=q.device)[None] // r
    mask = (k_pos[None, None] <= q_pos[:, :, None]) \
        & (k_pos[None, None] < lengths.long()[:, None, None])
    mask = mask[:, None]                                    # (B, 1, M, S)
    return time_ms(lambda: F.scaled_dot_product_attention(
        qf, K, V, attn_mask=mask), 10, flush)


def prefill_kernel_phase(dev, flush):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    ragged = ragged_contexts()
    cases = {
        "decode": (torch.bfloat16, 1, [(c - 1, 1) for c in ragged]),
        "prefill": (torch.bfloat16, 64,
                    [(0, 64), (256, 64), (512, 64), (1024, 64)]),
        # a fused step's row batch: 16 decode rows, a full and a partial
        # prefill chunk starting on page boundaries, padded rows (lengths
        # 0) up to the pow2 batch bucket
        "mixed": (torch.bfloat16, 64,
                  [(c - 1, 1) for c in ragged] + [(512, 64), (0, 16)]
                  + [(0, 0)] * 14),
        "mixed_fp32": (torch.float32, 64,
                       [(c - 1, 1) for c in ragged] + [(512, 64), (0, 16)]
                       + [(0, 0)] * 14),
    }
    results = {}
    for name, (dtype, C, rows) in cases.items():
        dname = dtype_name(dtype)
        args = make_rows(dev, dtype, rows, C)
        got = ops.paged_prefill_attention(*args)
        torch.cuda.synchronize()
        ref = paged_prefill_attention_ref(*args)
        max_err = check_kernel(name, got, ref, args[4] == 0, dname)
        ms = time_ms(lambda: ops.paged_prefill_attention(*args), 20, flush)
        plain = time_ms(lambda: paged_prefill_attention_ref(*args), 3,
                        flush)
        lib = sdpa_ms(args, flush)
        results[name] = report("B1", name, list(args[0].shape), dname,
                               max_err, ms, plain, lib, *bound(args, dname))
        del args, got, ref
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ B2 (decode)
def make_decode_rows(dev, dtype, lengths, Hkv=8, r=5, dh=128, page=16,
                     max_pages=128, bad_tables=False, seed=0):
    """Decode-kernel inputs: one new token per row with ``lengths`` keys
    stored (0 makes a padded row); each row owns its own random pages.
    ``bad_tables`` puts out-of-range ids (negative and past the pool) in
    every entry past each row's length, which the wrapper must clip."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lengths)
    slots = B * Hkv * max_pages + 1
    tables = torch.randperm(slots - 1, generator=g, device=dev)[
        :B * Hkv * max_pages].reshape(B, Hkv, max_pages).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    if bad_tables:
        need = (lens + page - 1) // page
        past = torch.arange(max_pages, device=dev)[None, None] \
            >= need[:, None, None]
        junk = torch.where(torch.rand(tables.shape, generator=g, device=dev)
                           < 0.5, -7, slots + 5).to(torch.int32)
        tables = torch.where(past, junk, tables)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return (rnd(B, Hkv, r, dh), rnd(slots, page, dh), rnd(slots, page, dh),
            tables, lens)


def bound_decode(args, dname):
    """(bound_ms, bound_by, bytes, flops) of decode attention: the output
    written once; lengths read; for rows with lengths > 0 only, q, the
    table entries of the pages below the length and the K/V of the keys
    below it.  4 * dh FLOPs per (query row, visible key)."""
    q, kpool, _, tables, lengths = args
    B, Hkv, r, dh = q.shape
    page = kpool.shape[1]
    isz = q.element_size()
    lens = lengths.long().cpu().clamp(0, tables.shape[-1] * page)
    live = int((lens > 0).sum())
    nbytes = q.numel() * isz                               # out, every row
    nbytes += live * Hkv * r * dh * isz                    # q of live rows
    nbytes += int(lens.sum()) * Hkv * dh * 2 * isz         # K and V
    nbytes += int(((lens + page - 1) // page).sum()) * Hkv * 4  # tables
    nbytes += B * 4                                        # lengths
    flops = 4.0 * dh * r * Hkv * float(lens.sum())
    return roofline(nbytes, flops, dname) + (nbytes, flops)


def sdpa_decode_ms(args, flush):
    """SDPA over K/V gathered to dense beforehand (outside the timing),
    with the length mask: the r query rows of a kv head as its queries."""
    import torch.nn.functional as F
    q, kpool, vpool, tables, lengths = args
    B, Hkv, r, dh = q.shape
    page = kpool.shape[1]
    S = tables.shape[-1] * page
    bt = tables.clamp(0, kpool.shape[0] - 1).long()
    K = kpool[bt].reshape(B, Hkv, S, dh)
    V = vpool[bt].reshape(B, Hkv, S, dh)
    mask = (torch.arange(S, device=q.device)[None]
            < lengths.long()[:, None])[:, None, None, :]   # (B, 1, 1, S)
    return time_ms(lambda: F.scaled_dot_product_attention(
        q, K, V, attn_mask=mask), 10, flush)


def decode_kernel_phase(dev, flush):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    ragged = ragged_contexts()
    qwen = dict(Hkv=8, r=5, dh=128)
    cases = {
        # a split decode call's batch at qwen3-14b's shapes
        "decode": (torch.bfloat16, qwen, ragged, False),
        "decode_fp32": (torch.float32, qwen, ragged, False),
        # MHA (r = 1) at qwen1.5-0.5b's and phi3-mini's head widths
        "mha_dh64": (torch.bfloat16, dict(Hkv=16, r=1, dh=64), ragged,
                     False),
        "mha_dh96": (torch.bfloat16, dict(Hkv=32, r=1, dh=96), ragged,
                     False),
        # 12 live rows padded to the 16-row bucket
        "padded": (torch.bfloat16, qwen, ragged[:12] + [0] * 4, False),
        "bad_tables": (torch.bfloat16, qwen, ragged, True),
    }
    results = {}
    for name, (dtype, widths, lengths, bad) in cases.items():
        dname = dtype_name(dtype)
        args = make_decode_rows(dev, dtype, lengths, bad_tables=bad,
                                **widths)
        q, kpool, vpool, tables, lens = args
        clipped = (q, kpool, vpool, tables.clamp(0, kpool.shape[0] - 1),
                   lens)
        got = ops.paged_attention(*args)
        torch.cuda.synchronize()
        ref = paged_attention_ref(*clipped)
        max_err = check_kernel(name, got, ref, lens == 0, dname)
        ms = time_ms(lambda: ops.paged_attention(*args), 20, flush)
        plain = time_ms(lambda: paged_attention_ref(*clipped), 3, flush)
        lib = sdpa_decode_ms(args, flush)
        results[name] = report("B2", name, list(q.shape), dname, max_err, ms,
                               plain, lib, *bound_decode(args, dname))
        del args, clipped, q, kpool, vpool, got, ref
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------- plain re-run variants
def plain_attention(round_p=False, wrong_page=False):
    """B1's plain version as the wrapper calls it (tables clipped).
    ``round_p`` rounds P to V's type before PV with the sum l taken
    unrounded, as the kernels and the Pallas reference do: a second exact
    implementation, whose distance from the plain one is the bf16 noise
    floor of a call's logits.  ``wrong_page`` reads each row's page 0 from
    page 1's slot: a fault (one page dropped) that the logits check must
    catch."""
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref

    def fn(q, kpool, vpool, bt, lengths, starts):
        bt = bt.clamp(0, kpool.shape[0] - 1)
        if wrong_page:
            bt = torch.cat([bt[..., 1:2], bt[..., 1:]], dim=-1)
        if not round_p:
            return paged_prefill_attention_ref(q, kpool, vpool, bt, lengths,
                                               starts)
        B, Hkv, C, r, dh = q.shape
        S = bt.shape[-1] * kpool.shape[1]
        K = kpool[bt.long()].reshape(B, Hkv, S, dh).float()
        V = vpool[bt.long()].reshape(B, Hkv, S, dh)
        s = torch.einsum("bhcrd,bhkd->bhcrk", q.float(), K) / math.sqrt(dh)
        k_pos = torch.arange(S, device=q.device)
        q_pos = starts.long()[:, None] \
            + torch.arange(C, device=q.device)[None]
        ok = (k_pos[None, None] <= q_pos[:, :, None]) \
            & (k_pos[None, None] < lengths.long()[:, None, None])
        s = s.masked_fill(~ok[:, None, :, None, :], float("-inf"))
        m = s.amax(-1, keepdim=True)
        pr = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
        l = pr.sum(-1, keepdim=True)
        o = torch.einsum("bhcrk,bhkd->bhcrd", pr.to(V.dtype).float(),
                         V.float())
        return torch.where(l > 0, o / l.clamp(min=1e-30), 0.0).to(q.dtype)
    return fn


def plain_decode(round_p=False, wrong_page=False):
    """B2's plain version as the wrapper calls it (tables clipped), and its
    ``round_p`` / ``wrong_page`` variants: decode is the one-token chunk
    at start = length - 1, so those reuse ``plain_attention``'s."""
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref

    def fn(q, kpool, vpool, bt, lengths):
        if not (round_p or wrong_page):
            return paged_attention_ref(q, kpool, vpool,
                                       bt.clamp(0, kpool.shape[0] - 1),
                                       lengths)
        starts = (lengths.long() - 1).clamp(min=0)
        return plain_attention(round_p, wrong_page)(
            q[:, :, None], kpool, vpool, bt, lengths, starts)[:, :, 0]
    return fn


# ------------------------------------------------------------- small engine
def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def small_engine_phase(dev):
    """Reduced fp32 qwen3 family (dh 64, so the kernels take it): under
    each schedule the engine on the GPU must emit the CPU engine's tokens,
    and the split schedule the fused step's."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    cpu_params = init_params(cfg, 0, device="cpu")
    outs = {}
    for mode in ("fused", "split"):
        for device in ("cpu", dev):
            eng = InferenceEngine(
                cfg, to_device(cpu_params, device),
                ClusterSpec.build([("A100", 1), ("3090", 1)]),
                primary_ids=[0], pool_ids=[1],
                engine_cfg=EngineConfig(max_batch=8, max_seq=128,
                                        page_size=16, prefill_chunk=16,
                                        step_mode=mode), device=device)
            rng = np.random.default_rng(0)
            for i in range(6):
                eng.submit(Request(rid=i, prompt=[
                    int(x) for x in rng.integers(0, cfg.vocab_size,
                                                 int(rng.integers(5, 60)))],
                    max_new_tokens=8))
            assert eng.run_until_drained(500)
            outs[mode, str(device)] = {r.rid: r.output for r in eng.finished}
        if outs[mode, "cpu"] != outs[mode, str(dev)]:
            raise AssertionError(
                f"small engine ({mode}): GPU tokens {outs[mode, str(dev)]} "
                f"!= CPU tokens {outs[mode, 'cpu']}")
        log(f"small engine ({mode}): 6 requests, GPU == CPU token streams "
            f"({sum(len(v) for v in outs[mode, 'cpu'].values())} tokens)")
    if outs["split", "cpu"] != outs["fused", "cpu"]:
        raise AssertionError("small engine: split tokens != fused tokens")
    log("small engine: split == fused token streams")


# ------------------------------------------------------------- engine phase
def fused_kinds(idx):
    """Which checks a fused step's operands call for: a step mixing decode
    and prefill rows, a step staging remote pages."""
    gd, ln, st = idx[0], idx[7], idx[8]
    n_tok = ln - st
    kinds = []
    if bool(((n_tok == 1) & (ln > 0)).any()) and bool((n_tok > 1).any()):
        kinds.append("mixed")
    if gd.shape[0] > 0:
        kinds.append("remote")
    return kinds


def decode_kinds(idx):
    """Which checks a decode call's operands call for: >= 2 real rows of
    different lengths, remote pages staged."""
    gd, ln = idx[0], idx[7]
    kinds = []
    if int((ln > 0).sum()) >= 2 and len(set(ln[ln > 0].tolist())) >= 2:
        kinds.append("ragged")
    if gd.shape[0] > 0:
        kinds.append("remote")
    return kinds


def rows_of(idx, mode):
    """(decode rows, prefill rows, exchange lanes) of a checked call."""
    if mode == "split":
        return int((idx[7] > 0).sum()), 0, int(idx[0].shape[0])
    ln, st = idx[7], idx[8]
    n_tok = ln - st
    return (int(((n_tok == 1) & (ln > 0)).sum()), int((n_tok > 1).sum()),
            int(idx[0].shape[0]))


def engine_phase(dev, profile, cfg, params, mode, seed=0):
    """Serve 16 requests through the full-width engine under ``mode``
    ("fused" or "split") and hold two of its calls against plain re-runs.
    The kernel launch counts are set to 0 just before the run and read
    just after it."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, InferenceEngine, Request

    eng = InferenceEngine(
        cfg, params, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True,
                                step_mode=mode),
        device=dev)
    rng = np.random.default_rng(seed)
    n_req, new_tokens = 16, 32
    prompt_lens = rng.integers(128, 1025, n_req)
    for i, n in enumerate(prompt_lens):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            0, cfg.vocab_size, int(n))], max_new_tokens=new_tokens))

    # the checked call: the fused step, or the split schedule's decode call
    if mode == "fused":
        wrapped, kernel, step_fn, span = ("_fused_fn", NAMES["B1"],
                                          T.sharded_fused_step, "fused_step")
        kinds_of, plain = fused_kinds, plain_attention
    else:
        wrapped, kernel, step_fn, span = ("_paged_fn", NAMES["B2"],
                                          T.sharded_decode_step,
                                          "paged_decode")
        kinds_of, plain = decode_kinds, plain_decode
    want_kinds = {"fused": {"mixed", "remote"}, "split": {"ragged", "remote"}}
    # hold the first call of each kind against re-runs of the same call
    # with plain attention
    checks = {}
    checked_calls = set()                  # their call times are left out
    check_s = [0.0]                        # wall seconds the checks add
    call_fn = getattr(eng, wrapped).fn
    kernel_fn = getattr(ops, kernel)

    def rerun(p, before_k, before_v, idx, attn_fn):
        """The call's logits re-run from the pre-call pools with
        ``attn_fn`` in place of the kernel."""
        wk = {d: t.clone() for d, t in before_k.items()}
        wv = {d: t.clone() for d, t in before_v.items()}
        setattr(ops, kernel, attn_fn)
        try:
            logits, _, _ = step_fn(cfg, p, wk, wv, eng.kv.anchor,
                                   eng.kv.sink, *idx)
        finally:
            setattr(ops, kernel, kernel_fn)
        return logits

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def checked(p, kps, vps, *idx):
        if set(checks) == want_kinds[mode]:
            return call_fn(p, kps, vps, *idx)
        kinds = [k for k in kinds_of(idx) if k not in checks]
        if not kinds:
            return call_fn(p, kps, vps, *idx)
        torch.cuda.synchronize()
        t = time.perf_counter()
        before_k = {d: t_.clone() for d, t_ in kps.items()}
        before_v = {d: t_.clone() for d, t_ in vps.items()}
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        layer0 = []                        # layer 0's inputs and output

        def capture(*a):
            o = kernel_fn(*a)
            if not layer0:
                # the layer-0 pool views stay as the kernel read them:
                # later layers and the exchange-out write other memory
                layer0.append(list(a) + [o])
            return o

        setattr(ops, kernel, capture)
        try:
            out = call_fn(p, kps, vps, *idx)
        finally:
            setattr(ops, kernel, kernel_fn)
        torch.cuda.synchronize()
        t = time.perf_counter()
        launches = dict(ops.LAUNCHES)
        # the main path's own layer-0 launch against the plain version on
        # the same inputs: no amplification through later layers
        *a0, o0 = layer0[0]
        r0 = plain()(*a0).float()
        e0 = (o0.float() - r0).abs()
        logits = out[0]
        ref = rerun(p, before_k, before_v, idx, plain())
        floor = rerun(p, before_k, before_v, idx, plain(round_p=True))
        fault = rerun(p, before_k, before_v, idx, plain(wrong_page=True))
        assert ops.LAUNCHES == launches
        n_dec, n_pre, lanes = rows_of(idx, mode)
        res = dict(rel_l2=rel_l2(logits, ref),
                   floor_rel_l2=rel_l2(floor, ref),
                   fault_rel_l2=rel_l2(fault, ref),
                   max_abs=float((logits - ref).abs().max()),
                   argmax_agree=float((logits.argmax(-1) == ref.argmax(-1))
                                      .float().mean()),
                   decode_rows=n_dec, prefill_rows=n_pre, lanes=lanes,
                   finite=bool(torch.isfinite(logits).all()),
                   shape=list(logits.shape),
                   layer0_max_abs=float(e0.max()),
                   layer0_ok=bool((e0 <= TOL["bfloat16"]
                                   * (1 + r0.abs())).all()))
        for k in kinds:
            checks[k] = res
        checked_calls.add(eng.tracer.count(span))
        del before_k, before_v, ref, floor, fault, layer0, a0, o0, r0, e0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        return out

    getattr(eng, wrapped).fn = checked
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:                 # the main path's run starts here
        ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    # the checked calls come early; the window after them is all plain
    # serving, and --profile traces exactly that window
    while len(checks) < 2 and (eng.queue or eng.running or eng.prefilling):
        eng.step()
    torch.cuda.synchronize()
    win_step0 = int(eng.metrics["steps"])
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    with prof:
        tw = time.perf_counter()
        drained = eng.run_until_drained(5000)
        torch.cuda.synchronize()
        win_wall = time.perf_counter() - tw
    launches = dict(ops.LAUNCHES)          # ... and ends here
    getattr(eng, wrapped).fn = call_fn     # no cycle keeps the pools alive
    # serving wall time: the run less the checks' own work (pool copies,
    # the layer-0 plain call and the plain re-runs); every step's tokens
    # stay counted
    wall = time.perf_counter() - t0 - check_s[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = int(eng.metrics["steps"])
    gen = n_req * new_tokens
    n_prompt = int(prompt_lens.sum())

    def ms_stats(name, skip=()):
        durs = [sp.dur * 1e3 for i, sp in enumerate(eng.tracer.spans(name))
                if i not in skip]
        return durs, statistics.median(durs), sorted(durs)[
            int(0.9 * len(durs))]

    out = dict(mode=mode, launches=launches, steps=steps, wall_s=wall,
               check_s=check_s[0], tokens_per_s=gen / wall,
               tokens_per_s_with_prompts=(gen + n_prompt) / wall,
               checks=checks, peak_gb=peak_gb, window_steps=[
                   win_step0 + 1, steps], window_wall_s=win_wall,
               tokens={r.rid: r.output for r in eng.finished})
    log(f"engine ({mode}): {n_req} requests, prompts {n_prompt} tokens, "
        f"generated {gen}; {steps} steps, {int(eng.metrics['model_calls'])} "
        f"model calls in {wall:.2f} s wall ({check_s[0]:.2f} s of checks "
        f"left out{'; with the profiler window' if profile else ''}); "
        f"{gen / wall:.2f} generated tokens/s; "
        f"{(gen + n_prompt) / wall:.1f} tokens/s incl. prompts; peak memory "
        f"{peak_gb:.1f} GB")
    if mode == "fused":
        durs, med, p90 = ms_stats("fused_step", checked_calls)
        args = [sp.args for sp in eng.tracer.spans("fused_step")]
        real = sum(a["decode_rows"] + a["prefill_tokens"] for a in args)
        padded = sum(a["batch"] * a["chunk"] for a in args)
        log(f"engine (fused): fused-step ms median {med:.2f} p90 {p90:.2f}; "
            f"row batches carry {real} real tokens in {padded} computed "
            f"token rows ({real / padded:.3f}); batch buckets "
            f"{sorted(collections.Counter(a['batch'] for a in args).items())}"
            f", chunk buckets "
            f"{sorted(collections.Counter(a['chunk'] for a in args).items())}")
        log(f"engine (fused): kernel launches B1 {launches[NAMES['B1']]} == "
            f"{cfg.n_layers} layers x {steps} steps, B2 "
            f"{launches[NAMES['B2']]}; redispatches "
            f"{int(eng.metrics['redispatches'])}, evictions "
            f"{int(eng.metrics['evictions'])}, staged d2d "
            f"{eng.snapshot()['fastpath/gather_d2d_bytes'] / 1e9:.2f} GB, "
            f"distinct step shapes {eng.fused_compile_count()}")
        out.update(step_ms_median=med, step_ms=durs, real_tokens=real,
                   computed_token_rows=padded)
        assert eng.metrics["model_calls"] == steps
        assert eng.metrics["fused_steps"] == steps
        assert launches[NAMES["B1"]] == cfg.n_layers * steps, \
            (launches, cfg.n_layers, steps)
        assert launches[NAMES["B2"]] == 0, launches
    else:
        n_dec = eng.tracer.count("paged_decode")
        n_pre = eng.tracer.count("prefill_chunk")
        ddurs, dmed, dp90 = ms_stats("paged_decode", checked_calls)
        pdurs, pmed, pp90 = ms_stats("prefill_chunk")
        dargs = [sp.args for sp in eng.tracer.spans("paged_decode")]
        log(f"engine (split): decode-call ms median {dmed:.2f} p90 "
            f"{dp90:.2f} ({n_dec} calls); prefill-call ms median {pmed:.2f} "
            f"p90 {pp90:.2f} ({n_pre} calls); decode batch buckets "
            f"{sorted(collections.Counter(a['batch'] for a in dargs).items())}"
            f", pages buckets "
            f"{sorted(collections.Counter(a['pages'] for a in dargs).items())}")
        log(f"engine (split): kernel launches B2 {launches[NAMES['B2']]} == "
            f"{cfg.n_layers} layers x {n_dec} decode calls, B1 "
            f"{launches[NAMES['B1']]} == {cfg.n_layers} layers x {n_pre} "
            f"prefill calls; redispatches "
            f"{int(eng.metrics['redispatches'])}, evictions "
            f"{int(eng.metrics['evictions'])}, staged d2d "
            f"{eng.snapshot()['fastpath/gather_d2d_bytes'] / 1e9:.2f} GB, "
            f"distinct shapes decode {eng.decode_compile_count()} prefill "
            f"{eng.prefill_compile_count()}")
        out.update(decode_calls=n_dec, prefill_calls=n_pre,
                   decode_ms_median=dmed, decode_ms_p90=dp90,
                   prefill_ms_median=pmed, prefill_ms_p90=pp90,
                   decode_ms=ddurs, prefill_ms=pdurs)
        assert eng.metrics["fused_steps"] == 0
        assert eng.metrics["model_calls"] == n_dec + n_pre > steps
        assert eng.metrics["prefill_chunks"] == n_pre
        assert launches[NAMES["B2"]] == cfg.n_layers * n_dec > 0, \
            (launches, cfg.n_layers, n_dec)
        assert launches[NAMES["B1"]] == cfg.n_layers * n_pre > 0, \
            (launches, cfg.n_layers, n_pre)
    for kind, res in checks.items():
        log(f"engine ({mode}): {kind} call ({res['decode_rows']} decode + "
            f"{res['prefill_rows']} prefill rows, {res['lanes']} exchange "
            f"lanes) kernel vs plain: layer-0 attention max abs err "
            f"{res['layer0_max_abs']:.3g} (tol {TOL['bfloat16']}); re-run "
            f"logits rel L2 {res['rel_l2']:.4g} (limit {LOGITS_LIMIT}; "
            f"plain with P rounded {res['floor_rel_l2']:.4g}, plain with a "
            f"page dropped {res['fault_rel_l2']:.4g}), max abs "
            f"{res['max_abs']:.3g}, argmax agreement "
            f"{res['argmax_agree']:.3f}")
    log(f"engine ({mode}): window after the checks: steps {win_step0 + 1}-"
        f"{steps}, {win_wall:.3f} s wall"
        f"{' under the profiler' if profile else ''}")

    assert drained and len(eng.finished) == n_req, "not every request done"
    assert all(len(r.output) == new_tokens for r in eng.finished)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.output)
    eng.kv.check_invariants()
    assert set(checks) == want_kinds[mode], \
        f"calls checked against the plain re-run: {sorted(checks)}"
    for kind, res in checks.items():
        if not (res["finite"] and res["layer0_ok"]
                and res["rel_l2"] <= LOGITS_LIMIT):
            raise AssertionError(f"{kind} call logits disagree with the "
                                 f"plain re-run: {res}")
        # the limit must tell a dropped page from rounding
        assert res["fault_rel_l2"] > LOGITS_LIMIT, res
    if profile:
        out.update(profile_summary(prof, steps - win_step0, win_step0,
                                   steps, win_wall, mode))
    return out


def profile_summary(prof, n_win, win_step0, steps, win_wall, mode):
    avg = prof.key_averages()
    events = [(e.key, e.self_device_time_total) for e in avg
              if e.self_device_time_total > 0]
    assert events, "the profiler recorded no device activity"
    dev_us = sum(us for _, us in events)
    n_ops = sum(e.count for e in avg if e.self_device_time_total > 0)
    b1_us = sum(us for k, us in events if "paged_prefill_kernel" in k)
    b2_us = sum(us for k, us in events if "paged_decode_" in k)
    log(f"profile ({mode}): steps {win_step0 + 1}-{steps} ({n_win} steps), "
        f"device busy (kernels and copies) {dev_us / 1e3:.1f} ms of "
        f"{win_wall * 1e3:.1f} ms wall of the same steps: busy share "
        f"{dev_us / 1e6 / win_wall:.3f}, idle share "
        f"{1 - dev_us / 1e6 / win_wall:.3f}; "
        f"{dev_us / 1e3 / n_win:.2f} ms busy per step in "
        f"{n_ops / n_win:.0f} device operations; B1 "
        f"{b1_us / 1e3 / n_win:.2f} ms per step ({b1_us / dev_us:.3f} of "
        f"busy time), B2 {b2_us / 1e3 / n_win:.2f} ms per step "
        f"({b2_us / dev_us:.3f})")
    for k, us in sorted(events, key=lambda e: -e[1])[:15]:
        log(f"profile ({mode}): {us / 1e3:10.2f} ms  {k[:100]}")
    return dict(profile_busy_us=dev_us, profile_ops=n_ops,
                profile_b1_us=b1_us,
                profile_b2_us=b2_us, profile_events=dict(events))


def full_width_params(dev, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config("qwen3-14b")
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    log(f"engine: qwen3-14b d_model {cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} dh {cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} layers {cfg.n_layers} {cfg.dtype}: "
        f"{n_params / 1e9:.2f}e9 params, init "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, params


def kernel_entry(kid, case, launches):
    src = "src/repro_torch/kernels/paged_attention/csrc/"
    line = {"B1": 132, "B2": 179}[kid]
    return {"name": NAMES[kid], "route": "cuda",
            "source": f"{src}{NAMES[kid]}.cu",
            "replaces": f"src/repro/kernels/paged_attention/kernel.py:{line}",
            "launches": launches, "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="trace the engine steps after the checked ones and "
                    "print device busy time and kernel times")
    ap.add_argument("--out", default=None,
                    help="also write every measurement as JSON here")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; allow_tf32: "
        f"matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32}")

    from repro_torch.kernels import build
    from repro_torch.kernels.paged_attention import ops
    t0 = time.perf_counter()
    build.build_all(ops.SOURCES)
    for name, _ in ops.SOURCES:
        ops._library(name)
    log(f"build: {', '.join(n for n, _ in ops.SOURCES)} built in parallel "
        f"and loaded in {time.perf_counter() - t0:.1f} s")
    for name, _ in ops.SOURCES:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    b1 = prefill_kernel_phase(dev, flush)
    b2 = decode_kernel_phase(dev, flush)
    del flush
    small_engine_phase(dev)
    # both engine phases serve the same weights; the fused engine's pools
    # are freed before the split engine allocates its own
    cfg, params = full_width_params(dev)
    fused = engine_phase(dev, args.profile, cfg, params, "fused")
    gc.collect()                           # the fused engine and its pools
    torch.cuda.empty_cache()
    log(f"engine: fused engine freed, {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB still allocated (the weights)")
    split = engine_phase(dev, args.profile, cfg, params, "split")
    same = sum(a == b for rid, toks in fused["tokens"].items()
               for a, b in zip(toks, split["tokens"][rid]))
    total = sum(len(t) for t in fused["tokens"].values())
    log(f"engine: split vs fused tokens agree at {same} of {total} "
        f"positions (bf16; B2 and B1 round differently)")
    del params
    torch.cuda.empty_cache()

    b1_launches = fused["launches"][NAMES["B1"]] \
        + split["launches"][NAMES["B1"]]
    entries = [kernel_entry("B1", b1["mixed"], b1_launches),
               kernel_entry("B2", b2["decode"],
                            split["launches"][NAMES["B2"]])]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "b1_cases": b1, "b2_cases": b2,
             "engine_fused": fused, "engine_split": split,
             "split_fused_token_agreement": [same, total]}, indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
