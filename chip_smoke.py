#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out PATH]

Phases, in order (12 runs right after 7, on phase 5's weights; 13 after
11); any failure exits nonzero:

  1. card:    the card's name and power limit (nvidia-smi); TF32 off.
  2. build:   the four kernel sources compiled from
              src/repro_torch/kernels/{paged_attention,flash_attention}/csrc/
              (B1, B2, B3 and B3's backward), one nvcc process per source,
              all started together; each bf16 wgmma instance's registers,
              spills and any wgmma serialisation from ptxas's report (B3's
              forward and backward, B1's chunked prefill), and a failure if
              one of them spills or one of B1's serialises.
  3. kernels: each kernel against its plain PyTorch version, timed with
              CUDA events beside its bound and F.scaled_dot_product_attention
              over pre-gathered K/V.  B1 (chunked prefill) at the serving
              shapes of qwen3-14b (Hkv 8, r 5, dh 128, page 16; decode-only,
              prefill-only and mixed row batches in bf16, one fp32 batch,
              16 decode rows at 2048 keys) and the mixed batch at MHA dh 96;
              B2 (decode) on 16 decode rows with ragged contexts < 2048 at
              qwen3-14b's shapes in bf16 and fp32, an MHA r = 1 batch at dh
              64 and one at dh 96, a batch with padded rows (lengths 0) and
              one with out-of-range table entries.  B3 (dense flash
              attention) at qwen3-14b's full prefill (40 over 8 heads, dh
              128, S 1024, causal) in bf16 and fp32, at the engine's
              shortest prompt (S 128), a sliding-window case, a non-causal
              case with S not a tile multiple, and MHA cases at dh 64 and
              96; and at the families' shapes, each in bf16 and fp32:
              deepseek-v3's MLA (128 MHA heads, q/k 192, v 128, S 1024,
              causal), hubert's dh 80 (16 MHA heads, S 1600, non-causal)
              and hymba's window (25 over 5 heads, dh 64, window 1024, S
              2048); qwen1.5-0.5b's training forward (8 x 16 MHA heads, dh
              64, S 4096) and MLA at deepseek-v3's train_4k microbatch (S
              4096), checked against the plain version a few heads at a
              time; beside F.scaled_dot_product_attention.  Every case also
              reads the wrapper's host time per call; with --profile the
              kernel table's cases (B1 mixed and decode-only, B2 decode, B3
              prefill), B1's prefill-only and MHA dh 96 batches, B3 at S
              128, MLA (S 1024 and 4096) and the training
              forward also read kernel and SDPA time from the profiler's
              device trace, which holds no host time.  B3's
              backward (the D, dK/dV and dQ kernels, through
              FlashAttention) against autograd of the plain version at
              qwen1.5-0.5b's training shape (8 x 16 heads, dh 64, S 4096,
              causal) in bf16 and fp32, qwen3-14b's GQA at dh 128, dh 96,
              hubert's dh 80 non-causal, hymba's window, S 1000, a case
              whose late rows see no key, and deepseek-v3's MLA (128 MHA
              heads, q/k 192, v 128, causal) at its train_4k microbatch
              (S 4096) in bf16 and at S 1024 in fp32 (under --profile the
              training and MLA cases' device times too): each gradient's
              error relative to
              its largest magnitude under the tolerance, between a floor
              (bf16: P rounded; fp32: the plain gradient in float64) and a
              fault (a key tile dropped) read in the same run; timed beside
              its bound and SDPA's backward, and each of its three kernels
              (D, dK/dV, dQ) timed alone.
  4. small:   a reduced fp32 engine on the GPU (kernels, its paged calls
              captured: one CUDA graph per bucket shape, replayed) against
              the same engine on the CPU (plain attention, eager), under the
              fused step, the split schedule and the three dense mode
              combinations: identical tokens, and every mode's tokens == the
              fused step's; then with a window of 16 on both layers under
              the default modes and dense/dense (the dense route: B3 with
              the window, dense decode; prompts of 5-60 tokens cross it):
              GPU tokens == CPU tokens.  Then the
              reduced dbrx (MoE) the same way under the fused step and the
              split schedule, its row batches past 64 token rows (the capped
              MoE pass, which drops assignments), every MoE call on the GPU
              run under torch.cuda.set_sync_debug_mode("error").  Then the
              reduced fp32 families off the engine's path (hymba, deepseek,
              xlstm, internvl2; head dims the flash kernel is built for)
              through prefill and 8 greedy decode_step tokens on the GPU
              and the CPU, carry and stacked: identical tokens; hubert's
              forward_hidden on both within 1e-4.  Then reduced fp32
              qwen3 (GQA), qwen1.5 and dbrx (MoE aux loss) at dh 64 train
              5 steps on the GPU (B3 and its backward) and the CPU from
              the same weights: losses within 1e-5, parameters within 1e-5
              relative L2, exact launches.
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
              limit must catch).  The paged calls are captured, one CUDA
              graph per bucket shape (repro_torch.serving.graphs), and
              replayed; a checked call runs eagerly, and the first replay
              of each checked kind is held against an eager re-run of the
              same call from the same pools: logits and written pool
              memory (the sinks aside) bit for bit.  The graphs stay
              within the bucket counts; launch counts are exact with the
              replays.  Then the same requests again with every paged
              call eager (graphs.disable_capture()): the same tokens, and
              its call median, host ms a step outside the calls and peak
              beside the captured run's.  With --profile the steps after
              the checked ones are traced (device activity only) and their
              busy and idle shares, device operations and host calls into
              the CUDA runtime a step printed (the eager run traced whole).
              Each run logs the pool shards that held pages, each device's
              most heads after a step and its heads after the run, the
              remote pages staged per call, the graphs captured against
              the bucket bound with their warm-up and capture ms, the
              replays, and the host ms a step outside the model calls.
  6. probe:   phase 5's two runs again on the same weights and requests
              under the per-module probe (EngineConfig(trace_modules=True):
              the traced twins, one device-synchronised span per embed,
              attention, mlp and lm_head), with phase 5's gates and checks.
              Exact span counts, the (h, g) annotation on every attention
              span, the measured calibration loop's outputs (attention
              gauges of every loaded device, calib per device, the dense
              roofline efficiency, the measured h2d rate) and the tau(h, g)
              fit over the live attention spans; each module's median ms
              and their sum against the call median; the probe's call
              median against phase 5's; its tokens equal phase 5's at every
              position when every call packed the same rows (else the
              agreement is logged, with where the rows part).  Then
              profile_attention on the card over the reference's 8 x 8
              grid at dh 128 in bf16 and fp32, each captured (every grid
              point's timed calls replay a CUDA graph, as the reference
              times a jitted call) and eagerly, with the fit of each; then
              three grid points captured anew and replayed 8 times one at a
              time (the wall and the device time of each replay), the last
              replay's output against the eager call's, bit for bit.
  7. dense:   the same weights and requests under prefill_mode="dense": one
              serial dense prefill per request (B3 in every layer), then
              split decode calls through B2 (the decode calls captured,
              the dense prefill calls eager).  Exact launch counts, the first
              prefill call's layer-0 B3 launch against the plain version and
              its logits against a plain-attention re-run (beside a P-rounded
              and a dropped-key-tile re-run).  Then eagerly, as in phase 5
              (tokens logged, not gated).  Then the same weights with a
              sliding window of 512 on every layer under the default
              EngineConfig, which the engine serves by the dense route (a
              dense prefill per request through B3 with the window, then
              dense decode, which copies every request's dense cache
              through the host on every step): the first 4 requests, 8 new
              tokens each; exact B3 launches (none of B1 or B2) and the
              first prefill call held as above.
  8. dbrx:    phase 5's engine, requests and gates on dbrx-132b (16 experts,
              top 4) at its published widths and 8 of its 40 layers, under
              the fused step, phase 6's probe on the fused step (the MoE
              layer inside the mlp spans), and the split schedule; the
              token-row counts the MoE layer saw are logged, and with
              --profile the MoE layer's share of device busy time (marker
              kernels around each call bound it in the trace; the probe
              runs are not traced); the MoE calls counted with the replays
              (the MoE layers x the model calls); each captured run then
              eagerly, as in phase 5 (tokens logged, not gated).
  9. dense configs: phase 5's fused run on qwen1.5-0.5b, phi3-mini-3.8b and
              minitron-8b at full width and depth, and on qwen1.5-0.5b with
              fp8 (e4m3) KV pools, each captured and then eagerly.
 10. families: the model families the engine does not serve, through the
              model functions at their published widths with seeded bf16
              weights, one after another: hymba-1.5b (32 layers; 4
              right-padded prompts of 1100-2048 tokens, so its 1024 window
              cuts), deepseek-v3-671b (its 3 dense and first 2 MoE layers of
              61; prompts of 128-1024), internvl2-1b (24; 256 image
              embeddings before 128-512 tokens) and xlstm-350m (24;
              128-512): one prefill and 16 greedy tokens each (15
              decode_step calls, carry); hubert-xlarge (48):
              forward_hidden on 2 clips of 1000-1600 frames.  Exact B3
              launches (attention layers x prefill calls, none in decode),
              the first call's layer-0 B3 launch against the plain version,
              its last-token logits (hubert: hidden states) against a
              plain-attention re-run under the 0.1 limit with the P-rounded
              floor and a dropped-key-tile fault read in the same run;
              finite logits and 16 tokens per request.  Prefill ms, ms per
              decode token, generated tokens/s, peak memory, and from an
              instrumented re-run B3's device time (CUDA events around
              each launch, queued behind a spin kernel) over the prefill's
              wall and the token scans' share (hymba's SSM, xLSTM's
              blocks; synchronised wall time).

 11. train:   qwen1.5-0.5b at its published widths and all 24 layers
              (bf16, remat), trained through repro_torch.training on
              SyntheticLM at seq 4096, global batch 8, lr 3e-4: the first
              step's loss and every leaf's gradient against plain-attention
              re-runs (relative L2 under 0.1, floor: P rounded, fault: a
              key tile dropped in layer 0's backward), exact B3 launches
              per step (48 forward, 24 of each backward kernel), 20 steps
              that learn, served captured (the step one CUDA graph: the
              first step run and captured, 19 replays) and then eagerly,
              their losses equal bit for bit, and 5 steps + a checkpoint +
              5 more from it (captured anew) against 10 straight.  ms per
              step, tokens/s, peak memory, the model FLOP share, replays,
              warm-up and capture seconds of each run; with --profile B3's
              forward and backward device time per step.
 12. plan:    the paper's planning stack over phase 5's traffic: the port's
              sigma* search (repro_torch.core.parallelizer) plans
              qwen3-14b on the paper testbed (4 A100, 2 + 2 3090 on two
              hosts, 4 P100; batch 16, the prompts' mean length, 32 new
              tokens) and logs the plan and its host search time; phase
              5's requests are served on phase 5's weights with the
              plan's primary workers and attention pool as the engine's
              roles (12 pool shards on this card, 11 of them remote to
              the anchor, staged through the exchange), under the fused
              step and the split schedule, captured, with phase 5's gates
              and logs, and more than two shards must hold pages; the
              elastic controller fails the anchor primary (the new plan
              must leave it out) and rejoins it (the primary count must
              come back); the three simulated systems (Hetis, HexGen,
              Splitwise) serve tests/test_sim.py's sharegpt trace with
              llama-70b on the paper testbed, each request that can be
              admitted served before the horizon.  The planner's cost
              and the simulator's clock are the cost model's, for its
              A100/3090/P100 classes, not measurements of this card.
 13. steps:   repro_torch.launch.steps.build(...).fn, the reference's step
              functions, at the per-device share of its (16, 16) pod mesh
              (global batch / 16 rows): qwen1.5-0.5b train_4k at full width
              and depth (16 x 4096 in 2 microbatches of phase 11's 8 rows;
              the accumulated gradient equals the mean of phase 11's
              train_step gradients of the two within fp32 rounding);
              deepseek-v3-671b train_4k at its published widths and its 3
              dense layers of 61 (16 x 4096 in 16 microbatches of one row,
              bf16 AdamW moments; the first microbatch's gradients against
              plain-attention re-runs under 0.1 between floor and fault,
              MLA's (192, 128) backward on every layer); 3 steps each with
              exact B3 launches, finite losses, ms per step, tokens/s and
              peak memory; qwen3-14b prefill_32k (2 x 32768: a B3 launch a
              layer, row 0's logits against chunked plain re-runs under
              0.1 between floor and fault) and decode_32k (8 rows against
              a seeded dense cache of 32768 positions; ms per token).

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
# one page dropped vs plain: 0.72 and 1.38), which holds for every served
# config (dbrx's MoE routing included); PERF.md gives the readings.  Every
# run asserts floor < limit < fault.
LOGITS_LIMIT = 0.1
# dbrx-132b at 8 of its 40 layers: its published widths, on one card
DBRX_LAYERS = 8
NAMES = {"B1": "paged_prefill_attention", "B2": "paged_attention",
         "B3": "flash_attention"}


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


def device_ms(fn, iters: int, flush) -> float:
    """Mean device ms per call of the kernels ``fn`` launches, read from
    the profiler's device trace over ``iters`` calls, each after the same
    L2 flush as in ``time_ms`` (the flush's own kernels left out).  Unlike
    ``time_ms`` it holds none of the wrapper's host time."""
    from torch.profiler import ProfilerActivity, profile

    def trace(body):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                body()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0}
    fn()
    torch.cuda.synchronize()
    flush_keys = set(trace(flush.zero_))

    def body():
        flush.zero_()
        fn()
    us = trace(body)
    assert set(us) - flush_keys, "the profiler recorded no kernel of fn"
    return sum(t for k, t in us.items() if k not in flush_keys) / iters / 1e3


def host_ms(fn, iters: int) -> float:
    """Mean host ms of one call of ``fn`` (its Python work and launches);
    nothing synchronises inside the loop, so the card runs behind."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


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
           nbytes, flops, tol=None):
    tol = TOL[dname] if tol is None else tol
    log(f"{kernel} {name}: q {shape} {dname} max_abs_err {max_err:.3g} (tol "
        f"{tol}) | kernel_ms {ms:.4f} plain_ms {plain:.4f} "
        f"library_ms {lib:.4f} bound_ms {b_ms:.4f} ({b_by}: {nbytes} B, "
        f"{flops:.4g} FLOP) roofline {b_ms / ms:.3f}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops,
                shape=shape, dtype=dname)


# the cases whose kernel and SDPA times are also read from the device
# trace (``device_ms``) under --profile: the kernel table's rows, B1's
# other wgmma cases, the decode tile's other cases (B1 at 2048 keys and at
# the MHA models' decode rows, B2's MHA batches), B3 at S = 128 and at MLA's and training's shapes.  Only
# then: once the profiler has run in a process, every later launch costs
# more host time (a plain run's tokens/s fell 10-20 % in
# PERF.md's runs), so a plain run keeps its end-to-end numbers clean.
DEVICE_TIMED = {"B1": ("mixed", "decode", "prefill", "mha_dh96",
                       "decode_2048", "decode_mha_dh96", "decode_mha_dh64"),
                "B2": ("decode", "mha_dh64", "mha_dh96"),
                "B3": ("prefill", "prefill_128", "mla", "train_fwd",
                       "mla_4k")}


def log_device_ms(kernel, name, result, fn, sdpa, flush):
    result["device_ms"] = device_ms(fn, 20, flush)
    result["library_device_ms"] = device_ms(sdpa, 10, flush)
    log(f"{kernel} {name}: device_ms {result['device_ms']:.4f} (SDPA "
        f"{result['library_device_ms']:.4f}), from the device trace")


def ragged_contexts():
    rng = torch.Generator().manual_seed(1)
    return [int(x) for x in torch.randint(100, 2048, (16,), generator=rng)]


# ----------------------------------------------------------- B1 (prefill)
def tile_smem_bytes(size, dh, warps, dv=None):
    """Dynamic shared memory per block of the kernels' shared tile, from
    its sizes (``Layout`` in src/repro_torch/kernels/csrc/attention_tile.cuh):
    a Q tile of 16 rows per warp and two stages of K tiles (rows dh wide)
    and V tiles (dv, default dh; 32 keys in fp32 and in one-warp split
    tiles, else 64), rows padded by 16 B, and in fp32 a P tile.  The tile
    carries B1's split tile (one warp: decode rows), its fp32 path and its
    bf16 launches at a page outside ``ops.WGMMA_PAGES`` (4 warps), B2, and
    B3's fp32 path; B1's bf16 launches past 16 rows take the wgmma
    kernel."""
    dv = dh if dv is None else dv
    keys = 32 if warps == 1 or size == 4 else 64
    pad = 16 // size
    nbytes = ((16 * warps + 2 * keys) * (dh + pad)
              + 2 * keys * (dv + pad)) * size
    return nbytes + (warps * 16 * (keys + 4) * 4 if size == 4 else 0)


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


def sdpa_call(args):
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
    return lambda: F.scaled_dot_product_attention(qf, K, V, attn_mask=mask)


def b1_cases():
    """B1's kernel-phase cases: name -> (dtype, C, rows of (start, n)[,
    widths for make_rows])."""
    ragged = ragged_contexts()
    return {
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
        # 16 decode rows at the engine's longest context (2048 keys)
        "decode_2048": (torch.bfloat16, 1, [(2047, 1)] * 16),
        # the decode rows of an MHA model's fused step (r = 1), which run
        # the split tile: phi3-mini's widths (32 kv heads, dh 96) and
        # qwen1.5-0.5b's (16 kv heads, dh 64)
        "decode_mha_dh96": (torch.bfloat16, 1, [(c - 1, 1) for c in ragged],
                            dict(Hkv=32, r=1, dh=96)),
        "decode_mha_dh64": (torch.bfloat16, 1, [(c - 1, 1) for c in ragged],
                            dict(Hkv=16, r=1, dh=64)),
        # the mixed batch at phi3-mini's MHA widths (32 kv heads, dh 96)
        "mha_dh96": (torch.bfloat16, 64,
                     [(c - 1, 1) for c in ragged] + [(512, 64), (0, 16)]
                     + [(0, 0)] * 14, dict(Hkv=32, r=1, dh=96)),
    }


def prefill_kernel_phase(dev, flush, profile):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    results = {}
    for name, (dtype, C, rows, *widths) in b1_cases().items():
        dname = dtype_name(dtype)
        args = make_rows(dev, dtype, rows, C, **(widths[0] if widths else {}))
        B, Hkv, C, r, dh = args[0].shape
        tile = ops.launch_tile(dtype, C, r, args[1].shape[1])
        got = ops.paged_prefill_attention(*args)
        torch.cuda.synchronize()
        ref = paged_prefill_attention_ref(*args)
        max_err = check_kernel(name, got, ref, args[4] == 0, dname)
        ms = time_ms(lambda: ops.paged_prefill_attention(*args), 20, flush)
        plain = time_ms(lambda: paged_prefill_attention_ref(*args), 3,
                        flush)
        sdpa = sdpa_call(args)
        lib = time_ms(sdpa, 10, flush)
        results[name] = report("B1", name, list(args[0].shape), dname,
                               max_err, ms, plain, lib, *bound(args, dname))
        results[name]["tile"] = tile
        log(f"B1 {name}: the {tile} tile")
        if profile and name in DEVICE_TIMED["B1"]:
            log_device_ms("B1", name, results[name],
                          lambda: ops.paged_prefill_attention(*args), sdpa,
                          flush)
        # the wrapper's host time with q in the model's layout (the
        # transposed view gqa_prefill_paged passes)
        qv = args[0].transpose(1, 2).contiguous().transpose(1, 2)
        host = host_ms(lambda: ops.paged_prefill_attention(qv, *args[1:]),
                       20)
        results[name]["host_ms"] = host
        log(f"B1 {name}: wrapper host_ms {host:.4f} per call (q as the "
            f"model's transposed view)")
        del qv
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


def sdpa_decode_call(args):
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
    return lambda: F.scaled_dot_product_attention(q, K, V, attn_mask=mask)


def b2_cases():
    """B2's kernel-phase cases: name -> (dtype, widths for
    make_decode_rows, lengths, out-of-range table entries)."""
    ragged = ragged_contexts()
    qwen = dict(Hkv=8, r=5, dh=128)
    return {
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


def decode_kernel_phase(dev, flush, profile):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    results = {}
    for name, (dtype, widths, lengths, bad) in b2_cases().items():
        dname = dtype_name(dtype)
        args = make_decode_rows(dev, dtype, lengths, bad_tables=bad,
                                **widths)
        q, kpool, vpool, tables, lens = args
        clipped = (q, kpool, vpool, tables.clamp(0, kpool.shape[0] - 1),
                   lens)
        tile = ops.decode_tile(dtype, kpool.shape[1], q.shape[2])
        got = ops.paged_attention(*args)
        torch.cuda.synchronize()
        ref = paged_attention_ref(*clipped)
        max_err = check_kernel(name, got, ref, lens == 0, dname)
        ms = time_ms(lambda: ops.paged_attention(*args), 20, flush)
        plain = time_ms(lambda: paged_attention_ref(*clipped), 3, flush)
        sdpa = sdpa_decode_call(args)
        lib = time_ms(sdpa, 10, flush)
        results[name] = report("B2", name, list(q.shape), dname, max_err, ms,
                               plain, lib, *bound_decode(args, dname))
        results[name]["tile"] = tile
        log(f"B2 {name}: the {tile} tile")
        host = host_ms(lambda: ops.paged_attention(*args), 20)
        results[name]["host_ms"] = host
        log(f"B2 {name}: wrapper host_ms {host:.4f} per call")
        if profile and name in DEVICE_TIMED["B2"]:
            log_device_ms("B2", name, results[name],
                          lambda: ops.paged_attention(*args), sdpa, flush)
        del args, clipped, q, kpool, vpool, got, ref
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------ B3 (dense flash)
def visible_pairs(Sq, Sk, causal, window):
    """(query row, key) pairs the mask keeps: what the work depends on."""
    qp = torch.arange(Sq)[:, None]
    kp = torch.arange(Sk)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= qp - kp < window
    return int(ok.sum())


def bound_flash(q, k, causal, window, dname, dv=None):
    """(bound_ms, bound_by, bytes, flops): q, k and v read once, the output
    written once; 2 * (dh + dv) FLOPs per (query row, visible key)."""
    B, Hq, Sq, dh = q.shape
    dv = dh if dv is None else dv
    nbytes = (q.numel() + k.numel() + (k.numel() + q.numel()) // dh * dv) \
        * q.element_size()
    flops = 2.0 * (dh + dv) * B * Hq * visible_pairs(Sq, k.shape[2], causal,
                                                     window)
    return roofline(nbytes, flops, dname) + (nbytes, flops)


def sdpa_flash_call(q, k, v, causal, window):
    """F.scaled_dot_product_attention on the same inputs (GQA by
    enable_gqa; the window as a boolean mask)."""
    import torch.nn.functional as F
    if window > 0:
        qp = torch.arange(q.shape[2], device=q.device)[:, None]
        kp = torch.arange(k.shape[2], device=q.device)[None, :]
        mask = (qp - kp < window) & ((qp >= kp) if causal else True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=True)


# B3 at the families' prefill shapes (kernel phase name -> widths, S,
# causal, window)
FAMILY_FLASH = {
    # deepseek-v3's MLA: 128 MHA heads, q/k 192 (nope 128 + rope 64), v 128
    "mla": (dict(Hq=128, Hkv=128, dh=192, dv=128), 1024, True, 0),
    # hubert-xlarge: 16 MHA heads at dh 80, non-causal, its longest clip
    "dh80_noncausal": (dict(Hq=16, Hkv=16, dh=80), 1600, False, 0),
    # hymba-1.5b's windowed layers: 25 over 5 heads, dh 64, window 1024
    "window_1024": (dict(Hq=25, Hkv=5, dh=64), 2048, True, 1024),
}


def plain_parts(q, k, v, causal, window, max_scores=1 << 28):
    """The plain version (``flash_attention_ref``) one batch row and as
    many kv heads (with their query heads) at a time as keep a score
    tensor within ``max_scores`` elements (1 GB of fp32): yields (batch
    row, query-head slice, the slice's plain output)."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    r = Hq // Hkv
    hk = max(1, min(Hkv, max_scores // (r * Sq * Sk)))
    for b in range(B):
        for h0 in range(0, Hkv, hk):
            h1 = min(h0 + hk, Hkv)
            yield b, slice(h0 * r, h1 * r), flash_attention_ref(
                q[b:b + 1, h0 * r:h1 * r], k[b:b + 1, h0:h1],
                v[b:b + 1, h0:h1], causal=causal, window=window)


def flash_kernel_phase(dev, flush, profile):
    from repro_torch.kernels.flash_attention import ops
    qwen = dict(Hq=40, Hkv=8, dh=128)
    cases = {
        # qwen3-14b's dense prefill of a 1024-token prompt
        "prefill": (torch.bfloat16, qwen, 1024, True, 0),
        # the engine's shortest prompt: 8 kv heads x 640 folded rows
        "prefill_128": (torch.bfloat16, qwen, 128, True, 0),
        "prefill_fp32": (torch.float32, qwen, 1024, True, 0),
        "window": (torch.bfloat16, qwen, 1024, True, 256),
        # S not a multiple of the 64-row / 64-key tiles
        "noncausal": (torch.bfloat16, qwen, 1000, False, 0),
        # MHA at qwen1.5-0.5b's and phi3-mini's head widths
        "mha_dh64": (torch.bfloat16, dict(Hq=16, Hkv=16, dh=64), 1024, True,
                     0),
        "mha_dh96": (torch.bfloat16, dict(Hq=32, Hkv=32, dh=96), 1024, True,
                     0),
        # qwen1.5-0.5b's training forward (phase 11): 8 rows x 16 MHA
        # heads, dh 64, S 4096
        "train_fwd": (torch.bfloat16, dict(B=8, Hq=16, Hkv=16, dh=64), 4096,
                      True, 0),
        # deepseek-v3's MLA at its train_4k microbatch: 128 heads, S 4096
        "mla_4k": (torch.bfloat16, dict(Hq=128, Hkv=128, dh=192, dv=128),
                   4096, True, 0),
    }
    # the families' shapes, each in both types
    for name, (w, S, causal, window) in FAMILY_FLASH.items():
        cases[name] = (torch.bfloat16, w, S, causal, window)
        cases[name + "_fp32"] = (torch.float32, w, S, causal, window)
    results = {}
    for name, (dtype, w, S, causal, window) in cases.items():
        dname = dtype_name(dtype)
        dv = w.get("dv", w["dh"])
        g = torch.Generator(device=dev).manual_seed(3)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
        B = w.get("B", 1)
        q = rnd(B, w["Hq"], S, w["dh"])
        k, v = rnd(B, w["Hkv"], S, w["dh"]), rnd(B, w["Hkv"], S, dv)
        call = lambda: ops.flash_attention(q, k, v, causal=causal,
                                           window=window)
        got = call()
        torch.cuda.synchronize()
        max_err = 0.
        for b, heads, ref in plain_parts(q, k, v, causal, window):
            blind = (ref == 0).all(-1)        # rows that see no key: none
            max_err = max(max_err, check_kernel(
                name, got[b:b + 1, heads], ref, blind, dname))
            del ref
        ms = time_ms(call, 20, flush)
        plain = time_ms(lambda: [None for _ in plain_parts(
            q, k, v, causal, window)], 3, flush)
        sdpa = sdpa_flash_call(q, k, v, causal, window)
        lib = time_ms(sdpa, 10, flush)
        results[name] = report(
            "B3", name, list(q.shape), dname, max_err, ms, plain, lib,
            *bound_flash(q, k, causal, window, dname, dv))
        results[name].update(kv_shape=list(k.shape), dv=dv, causal=causal,
                             window=window)
        host = host_ms(call, 20)
        results[name]["host_ms"] = host
        log(f"B3 {name}: wrapper host_ms {host:.4f} per call")
        if profile and name in DEVICE_TIMED["B3"]:
            log_device_ms("B3", name, results[name], call, sdpa, flush)
        del q, k, v, got
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------- B3's backward
def plain_flash_grads(q, k, v, dout, causal, window, *, round_p=False,
                      drop_tile=False, dtype=torch.float32, chunk=512):
    """Plain attention and its analytic gradient in ``dtype`` arithmetic,
    over chunks of ``chunk`` query positions (the score tensor of a whole
    (8, 16, 4096, 4096) training call would not fit beside a model): (out,
    dq, dk, dv) in ``dtype``, BHSD, GQA by repeating K/V over the r query
    heads of each kv head and summing their gradients back.  ``round_p``
    rounds P to bf16 where it meets a product (PV and P^T dO): a second
    exact implementation, the bf16 noise floor; ``drop_tile`` leaves keys
    64-127 out of the backward (P and dS zero there), or with ``dout``
    None out of the forward's softmax: a fault, one key tile dropped.  With
    ``dout`` None only the output is computed.  A chunk's products run
    over the keys its rows can see only (causal, window)."""
    B, Hq, Sq, dh = q.shape
    Hkv, Sk, dv = k.shape[1], k.shape[2], v.shape[3]
    r = Hq // Hkv
    K = k.to(dtype).repeat_interleave(r, 1)
    V = v.to(dtype).repeat_interleave(r, 1)
    scale = 1.0 / math.sqrt(dh)
    out = torch.empty((B, Hq, Sq, dv), dtype=dtype, device=q.device)
    if dout is not None:
        dq = torch.empty((B, Hq, Sq, dh), dtype=dtype, device=q.device)
        dK = torch.zeros((B, Hq, Sk, dh), dtype=dtype, device=q.device)
        dV = torch.zeros((B, Hq, Sk, dv), dtype=dtype, device=q.device)
    rnd = (lambda x: x.to(torch.bfloat16).to(dtype)) if round_p \
        else (lambda x: x)
    for i0 in range(0, Sq, chunk):
        i1 = min(i0 + chunk, Sq)
        # the keys a row of the chunk can see: [lo, hi)
        lo = max(0, i0 - window + 1) if window > 0 else 0
        hi = max(lo, min(Sk, i1) if causal else Sk)
        Kc, Vc = K[:, :, lo:hi], V[:, :, lo:hi]
        kp = torch.arange(lo, hi, device=q.device)[None, :]
        dropped = (kp >= 64) & (kp < 128)
        qc = q[:, :, i0:i1].to(dtype)
        g = None if dout is None else dout[:, :, i0:i1].to(dtype)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        ok = (qp >= kp) if causal else torch.ones_like(qp >= kp)
        if window > 0:
            ok &= qp - kp < window
        if drop_tile and dout is None:
            ok &= ~dropped
        s = (qc @ Kc.transpose(-1, -2) * scale).masked_fill(~ok,
                                                            float("-inf"))
        p = torch.softmax(s, dim=-1).nan_to_num(0.0)   # no key: 0
        del s
        o = rnd(p) @ Vc
        out[:, :, i0:i1] = o
        if dout is None:
            continue
        D = (g * o).sum(-1, keepdim=True)
        if drop_tile:
            p = p.masked_fill(dropped, 0.0)
        dV[:, :, lo:hi] += rnd(p).transpose(-1, -2) @ g
        ds = p * (g @ Vc.transpose(-1, -2) - D)
        del p
        dq[:, :, i0:i1] = ds @ Kc * scale
        dK[:, :, lo:hi] += ds.transpose(-1, -2) @ qc * scale
        del ds
    if dout is None:
        return (out,)
    dk = dK.view(B, Hkv, r, Sk, dh).sum(2)
    dvv = dV.view(B, Hkv, r, Sk, dv).sum(2)
    return out, dq, dk, dvv


def ref_grads(q, k, v, dout, causal, window, max_scores=1 << 28):
    """Autograd of the plain version (``flash_attention_ref``), one batch
    row and as many kv heads (with their query heads) at a time as keep
    a score tensor within ``max_scores`` elements (1 GB of fp32): (dq, dk,
    dv) in the inputs' dtype."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, Hq, Sq, _ = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    r = Hq // Hkv
    hk = max(1, min(Hkv, max_scores // (r * Sq * Sk)))
    rows = []
    for b in range(B):
        parts = []
        for h0 in range(0, Hkv, hk):
            h1 = min(h0 + hk, Hkv)
            qkv = [t[b:b + 1, a:z].detach().requires_grad_()
                   for t, a, z in ((q, h0 * r, h1 * r), (k, h0, h1),
                                   (v, h0, h1))]
            o = flash_attention_ref(*qkv, causal=causal, window=window)
            parts.append(torch.autograd.grad(
                o, qkv, dout[b:b + 1, h0 * r:h1 * r]))
            del o, qkv
        rows.append([torch.cat(gs, 1) for gs in zip(*parts)])
    return [torch.cat(gs) for gs in zip(*rows)]


def grad_err(got, want):
    """max |got - want| / max |want| of each gradient, and the largest."""
    errs = [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max()) for a, b in zip(got, want)]
    return errs, max(errs)


def bound_flash_bwd(q, k, v, causal, window, dname):
    """(bound_ms, bound_by, bytes, flops) of the backward: five products
    per (query row, visible key) and head, S and dQ and dK over q/k's dh,
    dP and dV over v's dv (2.5 times the forward's FLOPs where dh == dv);
    q, k, v, o, dO, lse and D read once, dq, dk and dv written once."""
    B, Hq, Sq, dh = q.shape
    dv = v.shape[3]
    size = q.element_size()
    rows = B * Hq * Sq
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel()
              + 2 * rows * dv) * size + 2 * rows * 4
    flops = 2.0 * (3 * dh + 2 * dv) * B * Hq * visible_pairs(
        Sq, k.shape[2], causal, window)
    return roofline(nbytes, flops, dname) + (nbytes, flops)


# (dtype, widths, Sq, Sk, causal, window)
FLASH_BWD_CASES = {
    # qwen1.5-0.5b's training attention: 8 rows x 16 MHA heads, dh 64
    "train": (torch.bfloat16, dict(B=8, Hq=16, Hkv=16, dh=64), 4096, 4096,
              True, 0),
    "train_fp32": (torch.float32, dict(B=8, Hq=16, Hkv=16, dh=64), 4096,
                   4096, True, 0),
    # qwen3-14b's GQA (40 over 8 heads, dh 128)
    "gqa_dh128": (torch.bfloat16, dict(B=1, Hq=40, Hkv=8, dh=128), 1024,
                  1024, True, 0),
    # phi3-mini's dh 96, MHA
    "mha_dh96": (torch.bfloat16, dict(B=1, Hq=32, Hkv=32, dh=96), 1024,
                 1024, True, 0),
    # hubert-xlarge: dh 80, non-causal, its longest clip
    "dh80_noncausal": (torch.bfloat16, dict(B=1, Hq=16, Hkv=16, dh=80), 1600,
                       1600, False, 0),
    # hymba-1.5b's windowed layers
    "window_1024": (torch.bfloat16, dict(B=1, Hq=25, Hkv=5, dh=64), 2048,
                    2048, True, 1024),
    # not a whole number of tiles
    "s1000": (torch.bfloat16, dict(B=1, Hq=16, Hkv=16, dh=64), 1000, 1000,
              True, 0),
    # Sq > Sk + window: rows at positions >= 767 see no key
    "blind_rows": (torch.bfloat16, dict(B=1, Hq=10, Hkv=2, dh=64), 1024, 512,
                   True, 256),
    # deepseek-v3's MLA at its train_4k microbatch: 128 MHA heads, q/k 192,
    # v 128, one row of 4096 (phase 13's shape); fp32 at 1024 positions
    "mla": (torch.bfloat16, dict(B=1, Hq=128, Hkv=128, dh=192, dv=128), 4096,
            4096, True, 0),
    "mla_fp32": (torch.float32, dict(B=1, Hq=128, Hkv=128, dh=192, dv=128),
                 1024, 1024, True, 0),
}
# the backward cases timed from the device trace too under --profile
DEVICE_TIMED_BWD = ("train", "mla")


def flash_bwd_kernel_phase(dev, flush, profile):
    """B3's backward (the D, dK/dV and dQ kernels) against autograd of the
    plain version at FLASH_BWD_CASES, through ``FlashAttention``: the
    largest gradient error over dq, dk, dv relative to each gradient's
    largest magnitude under TOL, with the floor (bf16: plain with P
    rounded; fp32: the plain gradient in float64) and the fault (one key
    tile dropped) read in the same run, floor < limit < fault; rows that
    see no key get exactly 0.  Times: the three kernels (CUDA events,
    after the L2 flush), the plain gradient, SDPA's backward
    (``autograd.grad`` of F.scaled_dot_product_attention) on the same
    tensors, and the bound; under ``profile`` the DEVICE_TIMED_BWD
    cases' device times too."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    results = {}
    for name, (dtype, w, Sq, Sk, causal, window) in FLASH_BWD_CASES.items():
        dname = dtype_name(dtype)
        g = torch.Generator(device=dev).manual_seed(5)
        rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
        dv = w.get("dv", w["dh"])
        q, dout = rnd(w["B"], w["Hq"], Sq, w["dh"]), \
            rnd(w["B"], w["Hq"], Sq, dv)
        k, v = rnd(w["B"], w["Hkv"], Sk, w["dh"]), \
            rnd(w["B"], w["Hkv"], Sk, dv)
        qkv = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(ops.LAUNCHES)
        out = ops.flash_attention(*qkv, causal=causal, window=window)
        got = torch.autograd.grad(out, qkv, dout)
        torch.cuda.synchronize()
        assert out.grad_fn is not None
        assert {n: ops.LAUNCHES[n] - before[n] for n in ops.BWD_KERNELS} \
            == {n: 1 for n in ops.BWD_KERNELS}
        want = ref_grads(q, k, v, dout, causal, window)
        errs, err = grad_err(got, want)
        if dtype == torch.bfloat16:
            floor = grad_err(plain_flash_grads(q, k, v, dout, causal, window,
                                               round_p=True)[1:], want)[1]
        else:
            floor = grad_err(plain_flash_grads(q, k, v, dout, causal, window,
                                               dtype=torch.float64)[1:],
                             want)[1]
        fault = grad_err(plain_flash_grads(q, k, v, dout, causal, window,
                                           drop_tile=True)[1:], want)[1]
        blind = (flash_attention_ref(q[:1], k[:1], v[:1], causal=causal,
                                     window=window) == 0).all(-1)
        ok = (err <= TOL[dname] and floor < TOL[dname] < fault
              and all(torch.isfinite(t).all() for t in got)
              and bool((got[0][:1][blind] == 0).all()))
        log(f"B3 backward {name}: q {list(q.shape)} kv {list(k.shape)} "
            f"{dname} causal {causal} window {window}: error dq/dk/dv "
            f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} of max |grad| "
            f"(limit {TOL[dname]}; floor {floor:.3g}, fault {fault:.3g}); "
            f"rows that see no key {int(blind.sum())}")
        if not ok:
            raise AssertionError(f"B3 backward disagrees with plain ({name})")
        if name == "s1000":                  # the train phase's plain grads
            f32 = [t.float() for t in (q, k, v, dout)]
            own = grad_err(plain_flash_grads(*f32, causal, window)[1:],
                           ref_grads(*f32, causal, window))[1]
            log(f"B3 backward {name}: the chunked plain gradient (the train "
                f"phase's re-run) vs autograd of the plain version, fp32: "
                f"{own:.3g} (limit {TOL['float32']})")
            assert own <= TOL["float32"], own
        fwd_out, lse = ops.flash_attention_fwd(q, k, v, causal=causal,
                                               window=window)
        call = lambda: ops.flash_attention_bwd(q, k, v, fwd_out, lse, dout,
                                               causal=causal, window=window)
        ms = time_ms(call, 10, flush)
        # each kernel alone, on the D pass's statistics (these launches
        # count in LAUNCHES like any other; the train phase reads its own)
        _, launches = ops._backward_passes(q, k, v, fwd_out, lse, dout,
                                           causal, window, "BHSD")
        launches["flash_attention_bwd_dot"]()
        per_kernel = {n: time_ms(fn, 10, flush) for n, fn in launches.items()}
        plain = time_ms(lambda: ref_grads(q, k, v, dout, causal, window), 2,
                        flush)
        sq = [t.clone().requires_grad_() for t in (q, k, v)]
        if window > 0:
            qp = torch.arange(Sq, device=dev)[:, None]
            kp = torch.arange(Sk, device=dev)[None, :]
            mask = (qp - kp < window) & (qp >= kp)
            so = F.scaled_dot_product_attention(*sq, attn_mask=mask,
                                                enable_gqa=True)
        else:              # SDPA takes MLA's v width of its own too
            so = F.scaled_dot_product_attention(*sq, is_causal=causal,
                                                enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(so, sq, dout,
                                               retain_graph=True)
        lib = time_ms(sdpa_bwd, 5, flush)
        max_abs = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(got, want))
        results[name] = report(
            "B3 backward", name, list(q.shape), dname, max_abs, ms, plain,
            lib, *bound_flash_bwd(q, k, v, causal, window, dname),
            tol=f"{TOL[dname]} of each gradient's max |value|")
        if profile and name in DEVICE_TIMED_BWD:
            results[name]["device_ms"] = device_ms(call, 10, flush)
            results[name]["library_device_ms"] = device_ms(sdpa_bwd, 5,
                                                           flush)
            log(f"B3 backward {name}: device_ms "
                f"{results[name]['device_ms']:.4f} (SDPA "
                f"{results[name]['library_device_ms']:.4f}), from the "
                f"device trace")
        del so, sq
        results[name].update(kv_shape=list(k.shape), causal=causal,
                             window=window, errors=errs, floor=floor,
                             fault=fault, rows_without_keys=int(blind.sum()),
                             dot_ms=per_kernel["flash_attention_bwd_dot"],
                             dkdv_ms=per_kernel["flash_attention_bwd_dkdv"],
                             dq_ms=per_kernel["flash_attention_bwd_dq"])
        log(f"B3 backward {name}: per kernel D {results[name]['dot_ms']:.4f}"
            f" dK/dV {results[name]['dkdv_ms']:.4f} dQ "
            f"{results[name]['dq_ms']:.4f} ms (each alone, L2 flushed)")
        del q, k, v, dout, qkv, out, got, want, fwd_out, lse, launches
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


def plain_flash(round_p=False, drop_tile=False):
    """B3's plain version with the wrapper's signature, and its variants:
    ``round_p`` rounds P to V's type before PV with l summed unrounded (a
    second exact implementation: the bf16 noise floor of a call's
    logits); ``drop_tile`` masks keys 64-127 for every row (a fault: one
    64-key tile dropped, which the logits check must catch), or, an int,
    the 64 keys from that one."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    def fn(q, k, v, *, causal=True, window=0, layout="BHSD", **_):
        if layout == "BSHD":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        if not (round_p or drop_tile):
            o = flash_attention_ref(q, k, v, causal=causal, window=window)
        else:
            B, Hq, Sq, dh = q.shape
            Hkv, Sk = k.shape[1], k.shape[2]
            qg = q.reshape(B, Hkv, Hq // Hkv, Sq, dh).float()
            s = torch.einsum("bhrqd,bhkd->bhrqk", qg, k.float()) \
                / math.sqrt(dh)
            qp = torch.arange(Sq, device=q.device)[:, None]
            kp = torch.arange(Sk, device=q.device)[None, :]
            ok = (qp >= kp) if causal else torch.ones_like(qp >= kp)
            if window > 0:
                ok &= qp - kp < window
            if drop_tile:
                lo = 64 if drop_tile is True else drop_tile
                ok &= (kp < lo) | (kp >= lo + 64)
            s = s.masked_fill(~ok, float("-inf"))
            m = s.amax(-1, keepdim=True)
            pr = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
            l = pr.sum(-1, keepdim=True)
            pv = pr.to(v.dtype).float() if round_p else pr
            o = torch.einsum("bhrqk,bhkd->bhrqd", pv, v.float())
            o = torch.where(l > 0, o / l.clamp(min=1e-30), 0.0)
            o = o.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)
        return o.transpose(1, 2) if layout == "BSHD" else o
    return fn


# ------------------------------------------------------------- MoE layer
MARKER = "spin_kernel"                     # torch.cuda._sleep's kernel


class MoeWatch:
    """Wraps the model's MoE layer (``mlp.moe_apply``) while a phase runs:
    ``calls`` counts the calls by their token-row count T (T: calls).  It
    is one of ``graphs.TALLIES`` while the watch is on, so a captured
    step's MoE calls count on each of its replays and not at its capture.
    ``no_sync`` runs each call on a CUDA tensor under
    ``torch.cuda.set_sync_debug_mode("error")``; ``markers`` launches a
    marker kernel before and after each call, so the profiler's trace can
    bound the layer's device work (``marked_device_us``)."""

    def __init__(self, no_sync=False, markers=False):
        from repro_torch.models import mlp
        from repro_torch.serving import graphs
        self.mlp, self.fn, self.graphs = mlp, mlp.moe_apply, graphs
        self.no_sync, self.markers = no_sync, markers
        self.calls = collections.Counter()

    def _call(self, cfg, p, x):
        self.calls[x.shape[0] * x.shape[1]] += 1
        if self.markers:
            torch.cuda._sleep(0)
        if self.no_sync and x.is_cuda:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = self.fn(cfg, p, x)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        else:
            out = self.fn(cfg, p, x)
        if self.markers:
            torch.cuda._sleep(0)
        return out

    def __enter__(self):
        self.mlp.moe_apply = self._call
        self.graphs.TALLIES.append(self.calls)
        return self

    def __exit__(self, *exc):
        self.mlp.moe_apply = self.fn
        self.graphs.TALLIES.remove(self.calls)

    def total(self):
        return sum(self.calls.values())

    def summary(self):
        """(sorted (T, calls), calls over 64 token rows: the capped
        pass)."""
        return (sorted(self.calls.items()),
                sum(n for T, n in self.calls.items() if T > 64))


def marked_device_us(prof):
    """(device us between marker pairs, pairs) of a profiler trace: the
    device work (kernels, copies, memsets) launched between each pair of
    ``MARKER`` kernels."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    inside, us, pairs = False, 0.0, 0
    for e in evs:
        if MARKER in e.name:
            inside = not inside
            pairs += not inside
        elif inside:
            us += e.time_range.elapsed_us()
    return us, pairs


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


SMALL_WINDOW = 16
SMALL_MODES = {
    "fused": dict(step_mode="fused"),
    "split": dict(step_mode="split"),
    "dense prefill": dict(prefill_mode="dense"),
    "dense decode": dict(decode_mode="dense"),
    "dense both": dict(prefill_mode="dense", decode_mode="dense"),
}


def small_engine(cfg, cpu_params, device, modes):
    """The small phase's engine on ``device`` serving its 6 requests:
    (tokens by request id, the MoE layer's token-row counts)."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    eng = InferenceEngine(
        cfg, to_device(cpu_params, device),
        ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=8, max_seq=128, page_size=16,
                                prefill_chunk=16, **modes), device=device)
    rng = np.random.default_rng(0)
    for i in range(6):
        eng.submit(Request(rid=i, prompt=[
            int(x) for x in rng.integers(0, cfg.vocab_size,
                                         int(rng.integers(5, 60)))],
            max_new_tokens=8))
    with MoeWatch(no_sync=True) as moe:
        assert eng.run_until_drained(500)
    return {r.rid: r.output for r in eng.finished}, moe.calls, \
        graph_stats(eng)


def small_engine_phase(dev):
    """Reduced fp32 qwen3 family (dh 64, so the kernels take it): under
    each schedule and mode combination the engine on the GPU must emit the
    CPU engine's tokens, and every mode the fused step's; so must the same
    config with a window of SMALL_WINDOW on both layers (the dense route)
    under the default modes and dense/dense.  Then the
    reduced dbrx (dh 64) under the fused step and the split schedule, GPU
    against CPU: 8 rows x 16 tokens = 128 token rows pass 64, so the MoE
    layer takes its capped pass, and on the GPU it never synchronises."""
    from repro_torch.configs import smoke_config
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    cpu_params = init_params(cfg, 0, device="cpu")
    outs = {}
    for mode, modes in SMALL_MODES.items():
        outs[mode, "cpu"] = small_engine(cfg, cpu_params, "cpu", modes)[0]
        outs[mode, str(dev)], _, stats = small_engine(cfg, cpu_params, dev,
                                                      modes)
        if outs[mode, "cpu"] != outs[mode, str(dev)]:
            raise AssertionError(
                f"small engine ({mode}): GPU tokens {outs[mode, str(dev)]} "
                f"!= CPU tokens {outs[mode, 'cpu']}")
        log(f"small engine ({mode}): 6 requests, GPU == CPU token streams "
            f"({sum(len(v) for v in outs[mode, 'cpu'].values())} tokens); "
            f"captured paged calls on the GPU " + (", ".join(
                f"{k} {v['graphs']} graphs, {v['replays']} replays"
                for k, v in stats.items()) or "none (dense modes)"))
    for mode in SMALL_MODES:
        if outs[mode, "cpu"] != outs["fused", "cpu"]:
            raise AssertionError(f"small engine: {mode} tokens != fused "
                                 f"tokens")
    log(f"small engine: {', '.join(SMALL_MODES)}: identical token streams")
    # one window on every layer: the dense route under every mode; prompts
    # of 5-60 tokens and their contexts cross the window
    from repro_torch.kernels.flash_attention import ops as fa_ops
    wcfg = dataclasses.replace(cfg, sliding_window=SMALL_WINDOW)
    for mode, modes in (("default", {}),
                        ("dense both", SMALL_MODES["dense both"])):
        want = small_engine(wcfg, cpu_params, "cpu", modes)[0]
        before = fa_ops.LAUNCHES["flash_attention"]
        got, _, stats = small_engine(wcfg, cpu_params, dev, modes)
        b3 = fa_ops.LAUNCHES["flash_attention"] - before
        if got != want:
            raise AssertionError(f"small engine (window {SMALL_WINDOW}, "
                                 f"{mode}): GPU tokens {got} != CPU tokens "
                                 f"{want}")
        assert not stats and b3 >= 6 * wcfg.n_layers, (stats, b3)
        log(f"small engine (window {SMALL_WINDOW}, {mode} modes): 6 "
            f"requests, GPU == CPU token streams "
            f"({sum(len(v) for v in want.values())} tokens); dense prefill "
            f"(B3 launches {b3}) and dense decode, no paged call")

    cfg = dataclasses.replace(smoke_config("dbrx-132b"), head_dim=64)
    cpu_params = init_params(cfg, 0, device="cpu")
    for mode in ("fused", "split"):
        modes = SMALL_MODES[mode]
        want, _, _ = small_engine(cfg, cpu_params, "cpu", modes)
        got, calls, _ = small_engine(cfg, cpu_params, dev, modes)
        if got != want:
            raise AssertionError(f"small dbrx ({mode}): GPU tokens {got} != "
                                 f"CPU tokens {want}")
        capped = sum(n for T, n in calls.items() if T > 64)
        assert capped > 0, sorted(calls)
        log(f"small dbrx ({mode}): 6 requests, GPU == CPU token streams "
            f"({sum(len(v) for v in want.values())} tokens); MoE calls on "
            f"the GPU {sum(calls.values())} (replays of captured steps "
            f"included), {capped} of them capped (T > 64; T seen "
            f"{sorted(calls)}), none synchronised with the host")


# the reduced families at head dims the flash kernel is built for
FAMILY_GPU = {
    "hymba-1.5b": dict(head_dim=64),
    "deepseek-v3-671b": dict(qk_nope_head_dim=128, qk_rope_head_dim=64,
                             v_head_dim=128, head_dim=192),
    "xlstm-350m": {},
    "internvl2-1b": dict(head_dim=64),
    "hubert-xlarge": dict(head_dim=80),
}


def family_batch(cfg, dev, lens, seed, dtype=None):
    """Right-padded inputs of ``len(lens)`` rows: random tokens (0 past
    each row's length), 256 (reduced: 4) image embeddings before them for
    the vision stub, frames for the audio stub (one clip a row, equal
    lengths).  Returns (batch, lengths counting any prefix)."""
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    B, S = len(lens), int(max(lens))
    dtype = dtype or torch.float32
    if cfg.frontend == "audio_stub":
        frames = torch.randn((B, S, cfg.d_model), generator=g, device=dev)
        return {"frames": frames.to(dtype)}, None
    toks = np.zeros((B, S), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, cfg.vocab_size, int(n))
    batch = {"tokens": torch.from_numpy(toks).to(dev)}
    P = cfg.n_prefix_embeds
    if cfg.frontend == "vision_stub":
        batch["image_embeds"] = torch.randn(
            (B, P, cfg.d_model), generator=g, device=dev).to(dtype)
    lengths = torch.tensor([int(n) + P for n in lens], dtype=torch.int32,
                           device=dev)
    return batch, lengths


def greedy(cfg, params, batch, lengths, new_tokens, max_seq):
    """prefill, then ``new_tokens`` greedy tokens (the first from the
    prefill's logits, the rest from ``decode_step``): (tokens (B, n),
    every step's logits)."""
    from repro_torch.models import transformer as T
    logits, cache = T.prefill(cfg, params, batch, max_seq, lengths)
    toks, outs = [logits.argmax(-1)], [logits]
    for _ in range(new_tokens - 1):
        logits, cache = T.decode_step(cfg, params, cache, toks[-1][:, None])
        toks.append(logits.argmax(-1))
        outs.append(logits)
    return torch.stack(toks, 1), outs


def small_family_phase(dev):
    """The reduced fp32 families off the engine's path (their head dims
    set to ones the flash kernel is built for) on the GPU against the
    CPU: prefill of 3 right-padded rows and 8 greedy tokens, carry and
    stacked, identical; hubert's forward_hidden within 1e-4.  Exact B3
    launches on the GPU: one per attention layer and prefill."""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T
    from repro_torch.weights import init_params
    for name, override in FAMILY_GPU.items():
        base = dataclasses.replace(smoke_config(name), **override)
        cpu_params = init_params(base, 0, device="cpu")
        gpu_params = to_device(cpu_params, dev)
        attn_layers = 0 if base.xlstm_pattern else base.n_layers
        if base.is_encoder_only:
            batch, _ = family_batch(base, "cpu", [150, 150], 0)
            want, _ = T.forward_hidden(base, cpu_params, batch)
            fa_ops.LAUNCHES["flash_attention"] = 0
            got, _ = T.forward_hidden(base, gpu_params,
                                      to_device(batch, dev))
            torch.cuda.synchronize()
            err = float((got.cpu() - want).abs().max())
            assert fa_ops.LAUNCHES["flash_attention"] == attn_layers
            assert err <= 1e-4, (name, err)
            log(f"small families: {name} (dh {base.head_dim}, non-causal) "
                f"forward_hidden GPU vs CPU max abs {err:.3g} (limit 1e-4); "
                f"B3 launches {attn_layers}")
            continue
        for impl in ("carry", "stacked"):
            cfg = dataclasses.replace(base, decode_impl=impl)
            batch, lengths = family_batch(cfg, "cpu", [40, 31, 17], 0)
            max_seq = int(lengths.max()) + 8
            want, _ = greedy(cfg, cpu_params, batch, lengths, 8, max_seq)
            fa_ops.LAUNCHES["flash_attention"] = 0
            got, _ = greedy(cfg, gpu_params, to_device(batch, dev),
                            lengths.to(dev), 8, max_seq)
            torch.cuda.synchronize()
            launches = fa_ops.LAUNCHES["flash_attention"]
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"small {name} ({impl}): GPU tokens "
                                     f"{got.tolist()} != CPU {want.tolist()}")
            assert launches == attn_layers, (name, launches)
            log(f"small families: {name} ({impl}; {T.layer_groups(cfg)}) "
                f"3 rows x 8 tokens GPU == CPU; B3 launches {launches}")


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


N_REQ, NEW_TOKENS = 16, 32


def prompt_lengths(rng):
    """The engine phases' prompt lengths: N_REQ draws of 128-1024
    tokens, the first draws of ``submit_requests``' generator."""
    return rng.integers(128, 1025, N_REQ)


def submit_requests(eng, cfg, seed):
    """The engine phases' 16 requests: prompts of 128-1024 tokens drawn
    from ``seed``, 32 new tokens each.  Returns (n_req, new_tokens,
    prompt lengths)."""
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    n_req, new_tokens = N_REQ, NEW_TOKENS
    prompt_lens = prompt_lengths(rng)
    for i, n in enumerate(prompt_lens):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            0, cfg.vocab_size, int(n))], max_new_tokens=new_tokens))
    return n_req, new_tokens, prompt_lens


class Intercepted:
    """``hook`` in place of a captured wrapper's calls; every other
    attribute is the wrapper's (``replays``, ``entries``, ...)."""

    def __init__(self, wrapper, hook):
        self.wrapper, self.hook = wrapper, hook

    def __call__(self, *args):
        return self.hook(*args)

    def __getattr__(self, name):
        return getattr(self.wrapper, name)


def graph_stats(eng):
    """The engine's captured paged calls, per kind: graphs captured,
    distinct shapes seen (a shape only a checked, eager call saw has no
    graph), the bucket bound, replays, and the first calls' warm-up and
    capture ms summed."""
    out = {}
    for name, fn, bound in (
            ("fused", eng._fused_fn, eng.fused_bucket_count()),
            ("prefill", eng._chunk_fn, eng.prefill_bucket_count()),
            ("decode", eng._paged_fn, eng.bucket_count())):
        if fn._cache_size():
            out[name] = dict(
                graphs=len(fn.entries), shapes=fn._cache_size(),
                bound=bound, replays=fn.replays,
                warmup_ms=1e3 * sum(w for w, _ in fn.capture_s),
                capture_ms=1e3 * sum(c for _, c in fn.capture_s))
    return out


def outside_ms(eng, skip=()):
    """Per step, in ms: the step span's wall less its model-call spans'
    (admission, the step plan, packing, sampling, the dispatcher: the
    host's work around the calls); steps holding a call of ``skip``
    ((span name, index): the checked calls) are left out."""
    calls, seen = [], collections.Counter()
    for sp in eng.tracer.spans(track="main"):
        if sp.name in CALLS or sp.name == "prefill":
            calls.append((sp.ts, sp.dur, (sp.name, seen[sp.name])))
            seen[sp.name] += 1
    out = []
    for st in eng.tracer.spans("step"):
        inner = [(d, k) for ts, d, k in calls
                 if st.ts <= ts < st.ts + st.dur]
        if inner and not any(k in skip for _, k in inner):
            out.append((st.dur - sum(d for d, _ in inner)) * 1e3)
    return out


def span_ms(eng, name, skip=()):
    """(durations, median, p90) in ms of the tracer's ``name`` spans, less
    the calls in ``skip`` (the checked ones)."""
    durs = [sp.dur * 1e3 for i, sp in enumerate(eng.tracer.spans(name))
            if i not in skip]
    return durs, statistics.median(durs), sorted(durs)[int(0.9 * len(durs))]


def engine_phase(dev, profile, cfg, params, mode, seed=0, probe=False,
                 cluster=None, roles=([0], [1])):
    """Serve 16 requests through the full-width engine under ``mode``
    ("fused" or "split") and hold two of its calls against plain re-runs;
    with ``probe``, under the per-module probe (``trace_modules=True``:
    the paged calls through their traced twins).  ``cluster`` (default:
    an A100 and a 3090) and ``roles`` ((primary ids, pool ids)) are the
    engine's simulated cluster and its workers.  The kernel launch
    counts are set to 0 just before the run and read just after it."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, InferenceEngine, graphs

    planned = cluster is not None
    cluster = cluster or ClusterSpec.build([("A100", 1), ("3090", 1)])
    eng = InferenceEngine(
        cfg, params, cluster, primary_ids=list(roles[0]),
        pool_ids=list(roles[1]),
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True,
                                trace_modules=probe, step_mode=mode),
        device=dev)
    n_req, new_tokens, prompt_lens = submit_requests(eng, cfg, seed)

    # the checked call: the fused step, or the split schedule's decode call
    if mode == "fused":
        wrapped, kernel, step_fn, span = ("_fused_fn", NAMES["B1"],
                                          T.sharded_fused_step, "fused_step")
        traced, kinds_of, plain = ("sharded_fused_step_traced", fused_kinds,
                                   plain_attention)
    else:
        wrapped, kernel, step_fn, span = ("_paged_fn", NAMES["B2"],
                                          T.sharded_decode_step,
                                          "paged_decode")
        traced, kinds_of, plain = ("sharded_decode_step_traced",
                                   decode_kinds, plain_decode)
    want_kinds = {"fused": {"mixed", "remote"}, "split": {"ragged", "remote"}}
    # hold the first call of each kind against re-runs of the same call
    # with plain attention
    checks = {}
    moe = MoeWatch(markers=profile)        # the MoE layer's calls, if any
    checked_calls = set()                  # their call times are left out
    check_s = [0.0]                        # wall seconds the checks add
    kernel_fn = getattr(ops, kernel)
    # the paged calls are captured (one graph per shape, replayed) unless
    # the probe runs them through their traced twins; the first replay of
    # each kind is then held against an eager re-run of the same call
    captured = not probe
    replay_checks = {}
    if probe:
        # the engine calls the traced twin from the transformer module
        traced_fn = getattr(T, traced)

        def call_fn(p, kps, vps, *idx, **kw):
            return traced_fn(cfg, p, kps, vps, eng.kv.anchor, eng.kv.sink,
                             *idx, **kw)

        def install(fn):
            setattr(T, traced, traced_fn if fn is call_fn else (
                lambda _c, p, kps, vps, _a, _s, *idx, **kw:
                fn(p, kps, vps, *idx, **kw)))
    else:
        # the engine's captured wrapper, which takes the host arrays
        call_fn = wrapper = getattr(eng, wrapped)

        def install(fn):
            setattr(eng, wrapped,
                    wrapper if fn is call_fn else Intercepted(wrapper, fn))

    anchor = eng.kv.anchor

    def on_device(idx):
        return tuple(torch.from_numpy(a).to(dev)
                     if isinstance(a, np.ndarray) else a for a in idx)

    def written(kps, vps, idx):
        """Copies of the pool memory a call can write: the anchor's pools
        whole (scatters, staging) and, in every other shard, the pages
        its writeback lanes name and its sink.  The rest of the shards
        stays as it is, so nothing else is copied."""
        w_dev, w_dst = idx[3], idx[5]
        out = {}
        for d in kps:
            if d == anchor:
                s = slice(None)
            else:
                sink = torch.full((1,), kps[d].shape[1] - 1,
                                  dtype=torch.long, device=w_dst.device)
                s = torch.cat([w_dst[w_dev == d].long(), sink])
            out[d] = (s, kps[d][:, s].clone(), vps[d][:, s].clone())
        return out

    def put(kps, vps, saved):
        for d, (s, k, v) in saved.items():
            kps[d][:, s] = k
            vps[d][:, s] = v

    def differ(kps, vps, saved):
        """Elements of the pool memory ``saved`` (``written``) whose bits
        the pools no longer hold, each pool's sink slot aside: padded
        rows' duplicate writes race there, and no length reaches it."""
        n = 0
        for d, (s, k, v) in saved.items():
            sink = eng.kv.sink if d == anchor else kps[d].shape[1] - 1
            for pool, old in ((kps[d], k), (vps[d], v)):
                for layer in range(pool.shape[0]):
                    now = pool[layer][s]
                    keep = (torch.arange(now.shape[0], device=now.device)
                            if isinstance(s, slice) else s) != sink
                    n += int((now[keep] != old[layer][keep]).sum())
        return n

    def rerun(p, kps, vps, before, idx, attn_fn):
        """The call's logits re-run with ``attn_fn`` in place of the
        kernel from the pools as they were before the call: the memory
        the call wrote is put back to ``before`` for the re-run, and the
        kernel run's contents are restored after it."""
        after = written(kps, vps, idx)
        put(kps, vps, before)
        setattr(ops, kernel, attn_fn)
        try:
            logits, _, _ = step_fn(cfg, p, kps, vps, anchor, eng.kv.sink,
                                   *idx)
        finally:
            setattr(ops, kernel, kernel_fn)
            put(kps, vps, after)
        return logits

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def replay_check(kinds, p, kps, vps, idx):
        """Serve a call that replays its shape's graph, then re-run it
        eagerly from the pools as they were before it: the logits and the
        pool memory it wrote must have the same bits."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        didx = on_device(idx)
        before = written(kps, vps, didx)
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        n_replays = wrapper.replays
        out = wrapper(p, kps, vps, *idx)
        assert wrapper.replays == n_replays + 1
        torch.cuda.synchronize()
        t = time.perf_counter()
        got = out[0].clone()
        after = written(kps, vps, didx)
        marks = [(c, dict(c)) for c in graphs.TALLIES]
        put(kps, vps, before)
        want = wrapper.fn(p, kps, vps, *didx)[0]   # eager, not served
        for c, m in marks:
            c.clear()
            c.update(m)
        res = dict(logits_differ=int((got != want).sum()),
                   logits_max_abs=float((got - want).abs().max()),
                   pool_elems_differ=differ(kps, vps, after),
                   shape=list(got.shape), rows=rows_of(idx, mode))
        put(kps, vps, after)
        for k in kinds:
            replay_checks[k] = res
        checked_calls.add(eng.tracer.count(span))
        del before, after, got, want
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        return out

    replayed = []                          # per call: whether it replayed

    def checked(p, kps, vps, *idx, **kw):
        if not captured:
            return checked_call(p, kps, vps, *idx, **kw)
        n = wrapper.replays
        out = checked_call(p, kps, vps, *idx, **kw)
        replayed.append(wrapper.replays > n)
        return out

    def checked_call(p, kps, vps, *idx, **kw):
        if set(checks) == want_kinds[mode] and (
                not captured or set(replay_checks) == want_kinds[mode]):
            return call_fn(p, kps, vps, *idx, **kw)
        kinds = kinds_of(idx)
        new = [k for k in kinds if k not in checks]
        if not new:
            again = [k for k in kinds if k not in replay_checks]
            if captured and again and wrapper.replays_call(p, kps, vps,
                                                           *idx):
                return replay_check(again, p, kps, vps, idx)
            return call_fn(p, kps, vps, *idx, **kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        didx = on_device(idx)
        before = written(kps, vps, didx)
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

        # a checked call runs eagerly: it is never captured
        setattr(ops, kernel, capture)
        try:
            with graphs.disable_capture():
                out = call_fn(p, kps, vps, *idx, **kw)
        finally:
            setattr(ops, kernel, kernel_fn)
        torch.cuda.synchronize()
        t = time.perf_counter()
        launches = dict(ops.LAUNCHES)
        n_moe = dict(moe.calls)            # the re-runs' MoE calls: not served
        # the main path's own layer-0 launch against the plain version on
        # the same inputs: no amplification through later layers
        *a0, o0 = layer0[0]
        r0 = plain()(*a0).float()
        e0 = (o0.float() - r0).abs()
        logits, kps, vps = out
        ref = rerun(p, kps, vps, before, didx, plain())
        floor = rerun(p, kps, vps, before, didx, plain(round_p=True))
        fault = rerun(p, kps, vps, before, didx, plain(wrong_page=True))
        assert ops.LAUNCHES == launches
        moe.calls.clear()
        moe.calls.update(n_moe)
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
        for k in new:
            checks[k] = res
        checked_calls.add(eng.tracer.count(span))
        del before, ref, floor, fault, layer0, a0, o0, r0, e0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        return out

    install(checked)
    # the rows each call packs (its lengths, and its starts or decode
    # positions) and the remote pages it stages (the exchange's gather
    # lanes: how many, from which shards), the devices that ever held
    # heads and their most heads after a step, the shards that ever held
    # pages, and per step each loaded device's measured attention over
    # its analytic time (the calib before its clamp to [0.25, 4])
    rows, staged, loaded, ratios = [], [], set(), collections.defaultdict(
        list)
    held, heads_peak = set(), collections.defaultdict(float)
    upload, step = eng._upload, eng.step

    def recorded_upload(host, nbytes=0):
        rows.append((len(host), host[7].tolist(),
                     host[8 if len(host) == 13 else 11].tolist()))
        g_dev = host[0][host[0] >= 0]
        staged.append((int(g_dev.size), len(set(g_dev.tolist()))))
        return upload(host, nbytes)

    def recorded_step():
        out = step()
        loaded.update(w.device_id for w in eng.workers if w.heads > 0)
        held.update(d for d, part in eng.kv.partitions.items() if part.used)
        for w in eng.workers:
            heads_peak[w.device_id] = max(heads_peak[w.device_id], w.heads)
        if probe and eng.attn_reqs:
            r0 = next(iter(eng.attn_reqs.values()))
            snap = eng.snapshot("attn/device/")
            for w in eng.workers:
                meas = snap.get(f"attn/device/{w.device_id}")
                if w.heads > 0 and meas:
                    ratios[w.device_id].append(meas * w.calib / w.f_time(
                        r0.group_ratio, r0.head_dim, r0.dtype_bytes))
        return out

    eng._upload, eng.step = recorded_upload, recorded_step
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    for k in ops.LAUNCHES:                 # the main path's run starts here
        ops.LAUNCHES[k] = 0
    for k in ops.PREFILL_TILE_LAUNCHES:
        ops.PREFILL_TILE_LAUNCHES[k] = 0
    t0 = time.perf_counter()
    with moe:
        # the checked calls (and the replays held against eager re-runs)
        # come early; the window after them is all plain serving, and
        # --profile traces exactly that window
        while (len(checks) < 2 or captured and len(replay_checks) < 2) \
                and (eng.queue or eng.running or eng.prefilling):
            eng.step()
        torch.cuda.synchronize()
        win_step0 = int(eng.metrics["steps"])
        # the window's own peak: no check's pool copies in it
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with prof:
            tw = time.perf_counter()
            drained = eng.run_until_drained(5000)
            torch.cuda.synchronize()
            win_wall = time.perf_counter() - tw
        launches = dict(ops.LAUNCHES)      # ... and ends here
        b1_tiles = dict(ops.PREFILL_TILE_LAUNCHES)
    install(call_fn)                       # no cycle keeps the pools alive
    del eng._upload, eng.step
    # serving wall time: the run less the checks' own work (pool copies,
    # the layer-0 plain call and the plain re-runs); every step's tokens
    # stay counted
    wall = time.perf_counter() - t0 - check_s[0]
    window_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_gb = max(peak_gb, window_peak_gb)
    stats = graph_stats(eng)
    host_ms = outside_ms(eng, {(span, i) for i in checked_calls})
    # the checked kind's calls that replayed a graph (no first call of a
    # shape: its warm-up and capture are in its span)
    replay_ms = [sp.dur * 1e3 for i, sp in enumerate(eng.tracer.spans(span))
                 if i < len(replayed) and replayed[i]
                 and i not in checked_calls]

    steps = int(eng.metrics["steps"])
    gen = n_req * new_tokens
    n_prompt = int(prompt_lens.sum())

    tag = (f"{cfg.name} {cfg.n_layers}L, {cfg.kv_dtype} pools, {mode}"
           if cfg.kv_cache_dtype else f"{cfg.name} {cfg.n_layers}L, {mode}")
    tag += ", probe" if probe else ""
    tag += (f", planned roles {len(roles[0])} primaries + {len(roles[1])} "
            f"pool" if planned else "")
    n_staged = [n for n, _ in staged]
    moe_T, moe_capped = moe.summary()
    out = dict(config=cfg.name, layers=cfg.n_layers,
               kv_dtype=cfg.kv_dtype, mode=mode, launches=launches,
               b1_tiles=b1_tiles, steps=steps, wall_s=wall,
               moe_calls=moe.total(), moe_T=moe_T,
               moe_capped_calls=moe_capped, graphs=stats,
               window_peak_gb=window_peak_gb, replay_ms=replay_ms,
               replay_ms_median=(statistics.median(replay_ms) if replay_ms
                                 else None),
               replay_checks=replay_checks, host_ms=host_ms,
               host_ms_median=statistics.median(host_ms),
               check_s=check_s[0], tokens_per_s=gen / wall,
               tokens_per_s_with_prompts=(gen + n_prompt) / wall,
               checks=checks, peak_gb=peak_gb, window_steps=[
                   win_step0 + 1, steps], window_wall_s=win_wall,
               redispatches=int(eng.metrics["redispatches"]),
               evictions=int(eng.metrics["evictions"]), rows=rows,
               shards=len(eng.kv.partitions), shards_held=sorted(held),
               heads_peak=dict(heads_peak),
               heads_after={w.device_id: w.heads for w in eng.workers},
               staged_pages=n_staged,
               staged_shards_max=max(m for _, m in staged),
               tokens={r.rid: r.output for r in eng.finished})
    log(f"engine ({tag}): {n_req} requests, prompts {n_prompt} tokens, "
        f"generated {gen}; {steps} steps, {int(eng.metrics['model_calls'])} "
        f"model calls in {wall:.2f} s wall ({check_s[0]:.2f} s of checks "
        f"left out{'; with the profiler window' if profile else ''}); "
        f"{gen / wall:.2f} generated tokens/s; "
        f"{(gen + n_prompt) / wall:.1f} tokens/s incl. prompts; peak memory "
        f"{peak_gb:.1f} GB")
    log(f"engine ({tag}): pool shards holding pages {len(held)} of "
        f"{len(eng.kv.partitions)} {sorted(held)}; most heads per device "
        f"after a step {dict(heads_peak)}, after the run "
        f"{out['heads_after']}; remote pages staged per call median "
        f"{statistics.median(n_staged):g} max {max(n_staged)}, from up to "
        f"{out['staged_shards_max']} shards")
    if moe.calls:
        log(f"engine ({tag}): MoE calls {moe.total()} (replays included) "
            f"== {cfg.n_layers - cfg.first_dense_layers} MoE layers x "
            f"{int(eng.metrics['model_calls'])} model calls, {moe_capped} "
            f"capped (T > 64); token rows T seen (T: calls) {moe_T}")
        assert moe.total() == (cfg.n_layers - cfg.first_dense_layers) \
            * eng.metrics["model_calls"], (moe.total(), moe_T)
    log(f"engine ({tag}): host ms a step outside the model calls median "
        f"{statistics.median(host_ms):.2f} p90 "
        f"{sorted(host_ms)[int(0.9 * len(host_ms))]:.2f} over "
        f"{len(host_ms)} steps (admission, step plan, packing, sampling, "
        f"dispatcher)")
    if captured:
        log(f"engine ({tag}): {span} ms median over the calls that "
            f"replayed a graph {statistics.median(replay_ms):.2f} ("
            f"{len(replay_ms)} calls; the first call of a shape holds its "
            f"warm-up and capture); peak memory after the checks "
            f"{window_peak_gb:.1f} GB")
        log(f"engine ({tag}): captured paged calls " + "; ".join(
            f"{k}: {v['graphs']} graphs of {v['shapes']} shapes seen "
            f"(bound {v['bound']}), {v['replays']} replays, first calls' "
            f"warm-up {v['warmup_ms']:.0f} ms + capture "
            f"{v['capture_ms']:.0f} ms" for k, v in stats.items()))
        for kind, res in replay_checks.items():
            log(f"engine ({tag}): {kind} call's first replay (rows "
                f"{res['rows']}) vs an eager re-run from the same pools: "
                f"{res['logits_differ']} of {math.prod(res['shape'])} "
                f"logits and {res['pool_elems_differ']} written pool "
                f"elements differ (max abs {res['logits_max_abs']:.3g})")
    if mode == "fused":
        durs, med, p90 = span_ms(eng, "fused_step", checked_calls)
        args = [sp.args for sp in eng.tracer.spans("fused_step")]
        real = sum(a["decode_rows"] + a["prefill_tokens"] for a in args)
        padded = sum(a["batch"] * a["chunk"] for a in args)
        log(f"engine ({tag}): fused-step ms median {med:.2f} p90 {p90:.2f}; "
            f"row batches carry {real} real tokens in {padded} computed "
            f"token rows ({real / padded:.3f}); batch buckets "
            f"{sorted(collections.Counter(a['batch'] for a in args).items())}"
            f", chunk buckets "
            f"{sorted(collections.Counter(a['chunk'] for a in args).items())}")
        log(f"engine ({tag}): kernel launches B1 {launches[NAMES['B1']]} == "
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
        ddurs, dmed, dp90 = span_ms(eng, "paged_decode", checked_calls)
        pdurs, pmed, pp90 = span_ms(eng, "prefill_chunk")
        dargs = [sp.args for sp in eng.tracer.spans("paged_decode")]
        log(f"engine ({tag}): decode-call ms median {dmed:.2f} p90 "
            f"{dp90:.2f} ({n_dec} calls); prefill-call ms median {pmed:.2f} "
            f"p90 {pp90:.2f} ({n_pre} calls); decode batch buckets "
            f"{sorted(collections.Counter(a['batch'] for a in dargs).items())}"
            f", pages buckets "
            f"{sorted(collections.Counter(a['pages'] for a in dargs).items())}")
        log(f"engine ({tag}): kernel launches B2 {launches[NAMES['B2']]} == "
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
    log(f"engine ({tag}): B1 launches by tile {b1_tiles} (the decode tile "
        f"'tma' where a GQA step packs no prefill chunk, the split tile "
        f"'warp' where an MHA one does)")
    assert sum(b1_tiles.values()) == launches[NAMES["B1"]], b1_tiles
    for kind, res in checks.items():
        log(f"engine ({tag}): {kind} call ({res['decode_rows']} decode + "
            f"{res['prefill_rows']} prefill rows, {res['lanes']} exchange "
            f"lanes) kernel vs plain: layer-0 attention max abs err "
            f"{res['layer0_max_abs']:.3g} (tol {TOL['bfloat16']}); re-run "
            f"logits rel L2 {res['rel_l2']:.4g} (limit {LOGITS_LIMIT}; "
            f"plain with P rounded {res['floor_rel_l2']:.4g}, plain with a "
            f"page dropped {res['fault_rel_l2']:.4g}), max abs "
            f"{res['max_abs']:.3g}, argmax agreement "
            f"{res['argmax_agree']:.3f}")
    log(f"engine ({tag}): window after the checks: steps {win_step0 + 1}-"
        f"{steps}, {win_wall:.3f} s wall"
        f"{' under the profiler' if profile else ''}")

    assert drained and len(eng.finished) == n_req, "not every request done"
    assert all(len(r.output) == new_tokens for r in eng.finished)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.output)
    eng.kv.check_invariants()
    assert set(checks) == want_kinds[mode], \
        f"calls checked against the plain re-run: {sorted(checks)}"
    if captured:
        assert set(replay_checks) == want_kinds[mode], \
            f"replays held against an eager re-run: {sorted(replay_checks)}"
        for kind, res in replay_checks.items():
            assert res["logits_differ"] == res["pool_elems_differ"] == 0, \
                (kind, res)
        for kind, v in stats.items():
            assert 0 < v["graphs"] <= v["shapes"] <= v["bound"], (kind, v)
        assert getattr(eng, wrapped).replays > 0, stats
    for kind, res in checks.items():
        if not (res["finite"] and res["layer0_ok"]
                and res["rel_l2"] <= LOGITS_LIMIT):
            raise AssertionError(f"{kind} call logits disagree with the "
                                 f"plain re-run: {res}")
        # the limit must tell a dropped page from rounding
        assert res["floor_rel_l2"] < LOGITS_LIMIT < res["fault_rel_l2"], res
    if profile:
        out.update(profile_summary(prof, steps - win_step0, win_step0,
                                   steps, win_wall, tag,
                                   moe=bool(moe.calls)))
    if probe:
        out.update(probe_summary(eng, tag, mode, checked_calls, loaded,
                                 ratios))
    return out


def eager_phase(dev, profile, cfg, params, base, gate=False, **modes):
    """The engine phases' requests again on the same weights with every
    paged call eager (``graphs.disable_capture()``) and no check: its call
    median, host ms a step outside the calls, tokens/s and peak beside the
    captured run ``base``'s, and (``--profile``) its device busy time over
    the whole run.  Its tokens against ``base``'s: with ``gate`` they must
    be equal.  ``modes``: the EngineConfig's mode fields."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, graphs
    eng = InferenceEngine(
        cfg, params, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True, **modes),
        device=dev)
    n_req, new_tokens, _ = submit_requests(eng, cfg, 0)
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with graphs.disable_capture(), MoeWatch(markers=profile) as moe, prof:
        drained = eng.run_until_drained(5000)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert drained and len(eng.finished) == n_req, "not every request done"
    assert not any(f.entries for f in (eng._fused_fn, eng._chunk_fn,
                                       eng._paged_fn))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = {r.rid: r.output for r in eng.finished}
    same = sum(a == b for rid, toks in base["tokens"].items()
               for a, b in zip(toks, tokens[rid]))
    total = sum(len(t) for t in base["tokens"].values())
    steps = int(eng.metrics["steps"])
    span = "fused_step" if eng.use_fused else "paged_decode"
    _, med, p90 = span_ms(eng, span)
    host_ms = outside_ms(eng)
    tag = f"{cfg.name} {cfg.n_layers}L, {cfg.kv_dtype} pools, " + (
        "fused" if eng.use_fused else "split") + (
        ", dense prefill" if not eng.use_paged_prefill else "")
    key = "step_ms_median" if eng.use_fused else "decode_ms_median"
    replay = (f", {base['replay_ms_median']:.2f} over its replays"
              if base.get("replay_ms_median") else "")
    log(f"eager ({tag}): every paged call eager: {span} ms median "
        f"{med:.2f} p90 {p90:.2f} against {base[key]:.2f} captured"
        f"{replay}; host ms a step outside the calls "
        f"median {statistics.median(host_ms):.2f} (captured "
        f"{base['host_ms_median']:.2f}); {n_req * new_tokens / wall:.2f} "
        f"generated tokens/s in {wall:.2f} s wall, {steps} steps (captured "
        f"{base['tokens_per_s']:.2f}, checks left out); peak memory "
        f"{peak_gb:.1f} GB (captured "
        f"{base.get('window_peak_gb', base['peak_gb']):.1f} after its "
        f"checks); tokens agree "
        f"with the captured run at {same} of {total} positions")
    out = dict(call_ms_median=med, call_ms_p90=p90, host_ms=host_ms,
               host_ms_median=statistics.median(host_ms), wall_s=wall,
               steps=steps, tokens_per_s=n_req * new_tokens / wall,
               peak_gb=peak_gb, token_agreement=[same, total],
               moe_calls=moe.total())
    if gate:
        assert tokens == base["tokens"], \
            f"eager tokens != captured tokens ({same} of {total} agree)"
    if profile:
        out.update(profile_summary(prof, steps, 0, steps, wall,
                                   tag + ", eager", moe=bool(moe.calls)))
    return out


# -------------------------------------------------------------- probe phase
MODULES = ("embed", "attention", "mlp", "lm_head")
CALLS = ("fused_step", "prefill_chunk", "paged_decode")


def probe_summary(eng, tag, mode, checked_calls, loaded, ratios):
    """The module probe's gates and readings over one engine run: exact
    span counts, the (h, g) annotation, the calibration loop's outputs
    (``ratios``: per device, measured over analytic attention time after
    each step) and the tau(h, g) fit over the live attention spans."""
    from repro_torch.core.dispatcher import ATTN_SNAPSHOT_PREFIX
    from repro_torch.core.profiler import fit_attention_model_from_tracer
    tr, L = eng.tracer, eng.cfg.n_layers
    calls = int(eng.metrics["model_calls"])
    counts = {m: tr.count(m) for m in MODULES}
    assert counts == {"embed": calls, "attention": L * calls,
                      "mlp": L * calls, "lm_head": calls}, (counts, calls)
    assert all(sp.args and {"heads", "cache_bytes"} <= set(sp.args)
               for sp in tr.spans("attention"))
    # per call: its wall ms and the sum of its module spans (a call's
    # module spans close before the call's own span)
    per_module = {m: [] for m in MODULES}
    per_call = collections.defaultdict(list)
    acc = 0.0
    for sp in tr.spans(track="main"):
        if sp.name in MODULES:
            per_module[sp.name].append(sp.dur * 1e3)
            acc += sp.dur * 1e3
        elif sp.name in CALLS:
            per_call[sp.name].append((sp.dur * 1e3, acc))
            acc = 0.0
    med = {m: statistics.median(v) for m, v in per_module.items()}
    call_span = "fused_step" if mode == "fused" else "paged_decode"
    sums = {}
    for name, pairs in per_call.items():
        kept = [pc for i, pc in enumerate(pairs)
                if name != call_span or i not in checked_calls]
        sums[name] = (statistics.median(c for c, _ in kept),
                      statistics.median(m for _, m in kept))
    log(f"probe ({tag}): module ms median embed {med['embed']:.3f}, "
        f"attention {med['attention']:.3f} (x{L}), mlp {med['mlp']:.3f} "
        f"(x{L}), lm_head {med['lm_head']:.3f}; " + "; ".join(
            f"{name}: modules sum median {m:.2f} of call median {c:.2f} ms "
            f"({m / c:.3f})" for name, (c, m) in sorted(sums.items())))
    snap = eng.snapshot()
    gauges = {k: v for k, v in snap.items()
              if k.startswith(ATTN_SNAPSHOT_PREFIX)}
    missing = [d for d in sorted(loaded)
               if f"{ATTN_SNAPSHOT_PREFIX}{d}" not in gauges]
    assert not missing, f"no measured attention for loaded devices {missing}"
    gbps = snap["xfer/h2d_gbps"]
    assert gbps > 0.0 and eng._dense_eff != 0.5, (gbps, eng._dense_eff)
    fit = fit_attention_model_from_tracer(tr)
    assert fit is not None, "no tau(h, g) fit from the live spans"
    model, r2 = fit
    calib = {w.device_id: w.calib for w in eng.workers}
    n_attn = len(tr.spans("attention"))
    log(f"probe ({tag}): tau(h, g) = a*h + b*g + c over {n_attn} live "
        f"attention spans: a {model.a:.4g} s/head, b {model.b:.4g} s/byte, "
        f"c {model.c:.4g} s, R^2 {r2:.4f}")
    log(f"probe ({tag}): loaded devices {sorted(loaded)}; measured "
        f"attention per device " + ", ".join(
            f"{k[len(ATTN_SNAPSHOT_PREFIX):]} {v * 1e3:.3f} ms"
            for k, v in sorted(gauges.items())) +
        f"; calib per device {calib} (measured / analytic before the "
        f"clamp, median over steps: " + ", ".join(
            f"{d} {statistics.median(v):.4g}" for d, v in
            sorted(ratios.items())) +
        f"); dense_eff 0.5 -> {eng._dense_eff:.4g}; measured h2d "
        f"{gbps:.4g} GB/s (EWMA)")
    return dict(module_ms_median=med, module_counts=counts,
                call_vs_modules_ms=sums, fit=dict(a=model.a, b=model.b,
                                                  c=model.c, r2=r2),
                attn_gauges=gauges, calib=calib, dense_eff=eng._dense_eff,
                calib_unclamped_median={d: statistics.median(v)
                                        for d, v in ratios.items()},
                h2d_gbps=gbps, loaded=sorted(loaded))


def probe_phase(dev, cfg, params, mode, base):
    """Phase 5's run (``base``) again under the per-module probe, on the
    same weights and requests; its tokens against ``base``'s."""
    run = engine_phase(dev, False, cfg, params, mode, probe=True)
    tag = f"{cfg.name} {cfg.n_layers}L, {mode}, probe"
    key = "step_ms_median" if mode == "fused" else "decode_ms_median"
    log(f"probe ({tag}): {key.replace('_', ' ')} {run[key]:.2f} against "
        f"{base[key]:.2f} untraced ({run[key] / base[key]:.3f}x); "
        f"redispatches {run['redispatches']} (untraced "
        f"{base['redispatches']}), evictions {run['evictions']} (untraced "
        f"{base['evictions']})")
    same = sum(a == b for rid, toks in base["tokens"].items()
               for a, b in zip(toks, run["tokens"][rid]))
    total = sum(len(t) for t in base["tokens"].values())
    run["untraced_token_agreement"] = [same, total]
    if run["rows"] == base["rows"]:
        log(f"probe ({tag}): every one of the {len(run['rows'])} calls "
            f"packed the untraced run's rows; tokens agree at {same} of "
            f"{total} positions")
        assert same == total, "the probe changed the tokens"
    else:
        first = next((i for i, (a, b) in enumerate(zip(base["rows"],
                                                       run["rows"]))
                      if a != b), min(len(base["rows"]), len(run["rows"])))
        log(f"probe ({tag}): the rows packed differ from call {first} on "
            f"({len(run['rows'])} calls, untraced {len(base['rows'])}; "
            f"evictions {run['evictions']} vs {base['evictions']}): tokens "
            f"agree at {same} of {total} positions")
    return run


def profile_attention_phase(dev):
    """``profile_attention`` on the card over the reference's default
    grid (8 head counts x 8 contexts, batch 4, 3 repeats) at dh 128, in
    bf16 and fp32, each captured (each grid point's call a CUDA graph,
    replayed in the timed loop) and eagerly (``graphs.disable_capture()``),
    and the tau(h, g) fit over each.  Then three grid points (the grid's
    least, its most and h 8, ctx 512) captured anew and replayed 8 times
    one at a time: each replay's wall (replay and sync) and device time,
    and the last replay's output against the eager call's: equal bit for
    bit."""
    from repro_torch.core.profiler import (decode_attn, fit_attention_model,
                                           profile_attention)
    from repro_torch.serving import graphs
    from repro_torch.telemetry.metrics import Counter
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for how in ("captured", "eager"):
            t0 = time.perf_counter()
            with (graphs.disable_capture() if how == "eager"
                  else contextlib.nullcontext()):
                s = profile_attention(head_dim=128, dtype=dtype, device=dev)
            wall = time.perf_counter() - t0
            assert len(s) == 64 and all(t > 0.0 for _, _, t in s), s
            model, r2 = fit_attention_model(s)
            ms = [t * 1e3 for _, _, t in s]
            log(f"profile_attention ({dtype_name(dtype)}, {how}, dh 128, 8 x "
                f"8 grid, batch 4, 3 repeats): {min(ms):.4f}-{max(ms):.4f} "
                f"ms per call over {s[0][1] / 1e6:.3f}-{s[-1][1] / 1e6:.1f} "
                f"MB of K/V; tau = a*h + b*g + c with a {model.a:.4g} "
                f"s/head, b {model.b:.4g} s/byte, c {model.c:.4g} s, R^2 "
                f"{r2:.4f} ({wall:.1f} s)")
            log(f"profile_attention ({dtype_name(dtype)}, {how}): ms per call "
                f"by heads (rows, batch x h) and contexts 64-1536 "
                f"(columns): " + "; ".join(
                    f"{int(s[i][0])}: " + " ".join(
                        f"{t * 1e3:.4f}" for _, _, t in s[i:i + 8])
                    for i in range(0, 64, 8)))
            out[f"{dtype_name(dtype)} {how}"] = dict(
                a=model.a, b=model.b, c=model.c, r2=r2, samples=s)
        for h, ctx in ((8, 512), (1, 64), (24, 1536)):
            g = torch.Generator(device=dev).manual_seed(h * 131 + ctx)
            q, k, v = (torch.randn(shape, generator=g, dtype=dtype,
                                   device=dev)
                       for shape in ((4, h, 1, 128), (4, h, ctx, 128),
                                     (4, h, ctx, 128)))
            call = graphs.CapturedFn(decode_attn, Counter("profile"),
                                     graphs.CudaGraphs(dev))
            call(q, k, v)
            # replays one at a time: the wall of each (replay and sync) and
            # its device time (events around it)
            walls, devs = [], []
            for _ in range(8):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                replayed = call(q, k, v)
                e1.record()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                devs.append(e0.elapsed_time(e1))
            eager = decode_attn(q, k, v)
            assert call.replays == 8, call.replays
            if not torch.equal(replayed, eager):
                raise AssertionError(
                    f"profile_attention ({dtype_name(dtype)}): the replayed "
                    f"call at h {h}, ctx {ctx} differs from the eager one by "
                    f"{float((replayed.float() - eager.float()).abs().max())}")
            log(f"profile_attention ({dtype_name(dtype)}): grid point h {h}, "
                f"ctx {ctx}: 8 replays one at a time, wall ms "
                f"{[round(w, 4) for w in walls]}, device ms (events) "
                f"{[round(d, 4) for d in devs]}; the last replay's output "
                f"equals the eager call's bit for bit")
            out[f"{dtype_name(dtype)} replays h {h} ctx {ctx}"] = dict(
                wall_ms=walls, device_ms=devs)
    return out


def prefill_checker(eng, check, check_s, after=None):
    """The engine's dense prefill call (``eng._prefill_fn.fn``) with its
    first call held against plain re-runs: that call's layer-0 B3 launch
    against the plain version, and its logits against ``transformer.
    prefill`` with plain attention (the re-run), with P rounded to bf16
    (the floor) and with a key tile dropped (the fault: keys 64-127; with
    a window shorter than the prompt, the first whole 64-key tile of the
    last row's window, which that row reads directly), none launching a
    kernel.  Fills ``check``, adds the check's wall seconds to
    ``check_s[0]`` and calls ``after()`` as it ends; later calls run
    unchecked."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import transformer as T
    cfg = eng.cfg
    call_fn = eng._prefill_fn.fn
    kernel_fn = fa_ops.flash_attention

    def rerun(p, batch, attn_fn):
        fa_ops.flash_attention = attn_fn
        try:
            return T.prefill(cfg, p, batch, max_seq=eng.ecfg.max_seq)[0]
        finally:
            fa_ops.flash_attention = kernel_fn

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def checked(p, batch):
        if check:
            return call_fn(p, batch)
        layer0 = []                        # layer 0's inputs and output

        def capture(*a, **kw):
            o = kernel_fn(*a, **kw)
            if not layer0:
                layer0.append((a, kw, o))
            return o

        fa_ops.flash_attention = capture
        try:
            out = call_fn(p, batch)
        finally:
            fa_ops.flash_attention = kernel_fn
        torch.cuda.synchronize()
        t = time.perf_counter()
        launches = dict(fa_ops.LAUNCHES)
        a0, kw0, o0 = layer0[0]
        r0 = plain_flash()(*a0, **kw0).float()
        e0 = (o0.float() - r0).abs()
        logits = out[0]
        ctx, win = int(batch["tokens"].shape[1]), cfg.sliding_window
        lo = -(-(ctx - win) // 64) * 64 if 0 < win < ctx else 64
        ref = rerun(p, batch, plain_flash())
        floor = rerun(p, batch, plain_flash(round_p=True))
        fault = rerun(p, batch, plain_flash(drop_tile=lo))
        assert fa_ops.LAUNCHES == launches
        check.update(ctx=ctx, window=int(kw0.get("window", 0)),
                     dropped=[lo, lo + 64],
                     rel_l2=rel_l2(logits, ref),
                     floor_rel_l2=rel_l2(floor, ref),
                     fault_rel_l2=rel_l2(fault, ref),
                     max_abs=float((logits - ref).abs().max()),
                     argmax_agree=bool(logits.argmax() == ref.argmax()),
                     finite=bool(torch.isfinite(logits).all()),
                     layer0_max_abs=float(e0.max()),
                     layer0_ok=bool((e0 <= TOL["bfloat16"]
                                     * (1 + r0.abs())).all()))
        del layer0, a0, o0, r0, e0, ref, floor, fault
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        if after is not None:
            after()
        return out
    return checked


def gate_prefill_check(tag, check):
    """Log the checked prefill call and fail unless its layer-0 launch is
    within the bf16 tolerance and its logits within LOGITS_LIMIT of the
    plain re-run, between the floor and the fault."""
    lo = check["dropped"][0]
    log(f"{tag}: checked prefill call ({check['ctx']} tokens, window "
        f"{check['window']}) kernel vs plain: layer-0 attention max abs err "
        f"{check['layer0_max_abs']:.3g} (tol {TOL['bfloat16']}); re-run "
        f"logits rel L2 {check['rel_l2']:.4g} (limit {LOGITS_LIMIT}; plain "
        f"with P rounded {check['floor_rel_l2']:.4g}, plain with keys "
        f"{lo}-{lo + 63} dropped {check['fault_rel_l2']:.4g}), max abs "
        f"{check['max_abs']:.3g}, same argmax {check['argmax_agree']}")
    if not (check["finite"] and check["layer0_ok"]
            and check["rel_l2"] <= LOGITS_LIMIT):
        raise AssertionError(f"{tag}: prefill call logits disagree with the "
                             f"plain re-run: {check}")
    assert check["floor_rel_l2"] < LOGITS_LIMIT < check["fault_rel_l2"], check


def dense_prefill_phase(dev, profile, cfg, params, seed=0):
    """Serve the engine phases' 16 requests under prefill_mode="dense":
    each admitted request gets one serial dense ``transformer.prefill``
    (B3 in every layer), its K/V stored into the pools, then the split
    schedule's decode calls (B2).  The first prefill call is held against
    plain re-runs; with ``profile`` the device is traced from the end of
    that check to the end of the run (the other 15 prefill calls and every
    decode call).  The launch counts are set to 0 just before the run and
    read just after it."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serving import EngineConfig, InferenceEngine

    eng = InferenceEngine(
        cfg, params, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True,
                                prefill_mode="dense"),
        device=dev)
    assert (eng.use_fused, eng.use_paged, eng.use_paged_prefill) \
        == (False, True, False)
    n_req, new_tokens, prompt_lens = submit_requests(eng, cfg, seed)
    call_fn = eng._prefill_fn.fn
    check = {}
    check_s = [0.0]                        # wall seconds the check adds
    win_t0 = []                            # start of the traced window
    if profile:
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as tprofile
        prof = tprofile(activities=[ProfilerActivity.CUDA])

    def after_check():
        if profile:
            prof.start()
        win_t0.append(time.perf_counter())

    checked = prefill_checker(eng, check, check_s, after_check)
    eng._prefill_fn.fn = checked
    torch.cuda.reset_peak_memory_stats()
    for ops in (fa_ops, pa_ops):           # the main path's run starts here
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    drained = eng.run_until_drained(5000)
    torch.cuda.synchronize()
    win_wall = time.perf_counter() - win_t0[0]
    if profile:
        prof.stop()
    launches = {**pa_ops.LAUNCHES, **fa_ops.LAUNCHES}   # ... and ends here
    eng._prefill_fn.fn = call_fn
    wall = time.perf_counter() - t0 - check_s[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = graph_stats(eng)
    host_ms = outside_ms(eng, {("prefill", 0)})
    steps = int(eng.metrics["steps"])
    gen = n_req * new_tokens
    n_prompt = int(prompt_lens.sum())
    n_pre = eng.tracer.count("prefill")
    n_dec = eng.tracer.count("paged_decode")
    pdurs, pmed, pp90 = span_ms(eng, "prefill", {0})
    ddurs, dmed, dp90 = span_ms(eng, "paged_decode")
    out = dict(mode="dense_prefill", launches=launches, steps=steps,
               wall_s=wall, check_s=check_s[0], tokens_per_s=gen / wall,
               tokens_per_s_with_prompts=(gen + n_prompt) / wall,
               checks={"prefill": check}, peak_gb=peak_gb,
               prefill_calls=n_pre, decode_calls=n_dec,
               prefill_ms_median=pmed, prefill_ms_p90=pp90,
               decode_ms_median=dmed, decode_ms_p90=dp90,
               prefill_ms=pdurs, decode_ms=ddurs, graphs=stats,
               host_ms=host_ms, host_ms_median=statistics.median(host_ms),
               tokens={r.rid: r.output for r in eng.finished})
    log(f"engine (dense prefill): {n_req} requests, prompts {n_prompt} "
        f"tokens, generated {gen}; {steps} steps, {n_pre} prefill + {n_dec} "
        f"decode calls in {wall:.2f} s wall ({check_s[0]:.2f} s of checks "
        f"left out); {gen / wall:.2f} generated tokens/s; "
        f"{(gen + n_prompt) / wall:.1f} tokens/s incl. prompts; peak memory "
        f"{peak_gb:.1f} GB")
    log(f"engine (dense prefill): prefill-call ms median {pmed:.2f} p90 "
        f"{pp90:.2f} (the checked first call left out); decode-call ms "
        f"median {dmed:.2f} p90 {dp90:.2f}")
    log(f"engine (dense prefill): host ms a step outside the model calls "
        f"median {statistics.median(host_ms):.2f}; captured decode calls: "
        f"{stats['decode']['graphs']} graphs of {stats['decode']['shapes']} "
        f"shapes (bound {stats['decode']['bound']}), "
        f"{stats['decode']['replays']} replays, warm-up "
        f"{stats['decode']['warmup_ms']:.0f} ms + capture "
        f"{stats['decode']['capture_ms']:.0f} ms; the dense prefill calls "
        f"eager")
    log(f"engine (dense prefill): kernel launches B3 {launches[NAMES['B3']]}"
        f" == {cfg.n_layers} layers x {n_pre} prefill calls, B2 "
        f"{launches[NAMES['B2']]} == {cfg.n_layers} layers x {n_dec} decode "
        f"calls, B1 {launches[NAMES['B1']]}; redispatches "
        f"{int(eng.metrics['redispatches'])}, evictions "
        f"{int(eng.metrics['evictions'])}")
    gate_prefill_check("engine (dense prefill)", check)
    assert drained and len(eng.finished) == n_req, "not every request done"
    assert all(len(r.output) == new_tokens for r in eng.finished)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.output)
    eng.kv.check_invariants()
    assert eng.metrics["model_calls"] == n_pre + n_dec
    assert eng.metrics["prefill_chunks"] == 0 and n_pre >= n_req
    assert launches[NAMES["B3"]] == cfg.n_layers * n_pre, launches
    assert launches[NAMES["B2"]] == cfg.n_layers * n_dec > 0, launches
    assert launches[NAMES["B1"]] == 0, launches
    assert set(stats) == {"decode"} and stats["decode"]["replays"] > 0 \
        and 0 < stats["decode"]["graphs"] <= stats["decode"]["bound"], stats
    log(f"engine (dense prefill): window after the check: prefill calls "
        f"2-{n_pre} and every decode call, {win_wall:.3f} s wall"
        f"{' under the profiler' if profile else ''}")
    out.update(window_wall_s=win_wall)
    if profile:
        out.update(profile_summary(prof, steps, 0, steps, win_wall,
                                   "dense prefill"))
    return out


# the full-width windowed cell: qwen3-14b's weights with one window on
# every layer, served by the dense route (prefill through B3 with the
# window, dense decode); 4 of the engine phases' requests, 8 new tokens
WINDOW_FULL, WINDOW_REQ, WINDOW_NEW = 512, 4, 8


def window_phase(dev, cfg, params, seed=0):
    """``cfg`` with ``sliding_window`` WINDOW_FULL on the same weights (a
    window changes no parameter shape), served under the default
    EngineConfig: the paged paths take no window, so the engine runs the
    split schedule with a dense prefill per request (``transformer.
    prefill``: B3 with the window in every layer) and dense decode
    (``decode_step``, the window in its mask; no kernel).  Its first
    WINDOW_REQ requests of 128-1024 tokens, WINDOW_NEW new tokens each:
    prompts and contexts pass the window.  Gates: B3 launches exact
    (layers x prefill calls, no B1 or B2), the first prefill call's
    layer-0 launch and logits against plain re-runs (``prefill_checker``).
    The launch counts are set to 0 just before the run and read just
    after it."""
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    wcfg = dataclasses.replace(cfg, sliding_window=WINDOW_FULL)
    eng = InferenceEngine(
        wcfg, params, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True),
        device=dev)
    assert (eng.use_fused, eng.use_paged, eng.use_paged_prefill) \
        == (False, False, False)
    rng = np.random.default_rng(seed)      # submit_requests' draws
    lens = prompt_lengths(rng)[:WINDOW_REQ]
    for i, n in enumerate(lens):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            0, cfg.vocab_size, int(n))], max_new_tokens=WINDOW_NEW))
    check, check_s = {}, [0.0]
    call_fn = eng._prefill_fn.fn
    eng._prefill_fn.fn = prefill_checker(eng, check, check_s)
    torch.cuda.reset_peak_memory_stats()
    for ops in (fa_ops, pa_ops):           # the main path's run starts here
        for k in ops.LAUNCHES:
            ops.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    drained = eng.run_until_drained(1000)
    torch.cuda.synchronize()
    launches = {**pa_ops.LAUNCHES, **fa_ops.LAUNCHES}   # ... and ends here
    eng._prefill_fn.fn = call_fn
    wall = time.perf_counter() - t0 - check_s[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_pre = eng.tracer.count("prefill")
    n_dec = eng.tracer.count("dense_decode")
    _, pmed, _ = span_ms(eng, "prefill", {0})
    _, dmed, dp90 = span_ms(eng, "dense_decode")
    gen = WINDOW_REQ * WINDOW_NEW
    tag = f"engine (window {WINDOW_FULL})"
    log(f"{tag}: {cfg.name} {cfg.n_layers}L, window {WINDOW_FULL} on every "
        f"layer, default modes -> dense prefill + dense decode (split); "
        f"{WINDOW_REQ} requests, prompts {[int(n) for n in lens]}, "
        f"{WINDOW_NEW} new tokens each: {n_pre} prefill + {n_dec} decode "
        f"calls in {wall:.2f} s wall ({check_s[0]:.2f} s of checks left "
        f"out), {gen / wall:.2f} generated tokens/s; prefill-call ms "
        f"median {pmed:.1f} (the checked call left out), decode-call ms "
        f"median {dmed:.1f} p90 {dp90:.1f}; peak {peak_gb:.1f} GB; "
        f"launches B3 {launches[NAMES['B3']]} == {cfg.n_layers} layers x "
        f"{n_pre} prefill calls, B1 {launches[NAMES['B1']]}, B2 "
        f"{launches[NAMES['B2']]}")
    gate_prefill_check(tag, check)
    assert check["window"] == WINDOW_FULL < check["ctx"], check
    assert drained and len(eng.finished) == WINDOW_REQ
    assert all(len(r.output) == WINDOW_NEW for r in eng.finished)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.output)
    eng.kv.check_invariants()
    assert n_pre == WINDOW_REQ and n_dec > 0
    assert launches[NAMES["B3"]] == cfg.n_layers * n_pre, launches
    assert launches[NAMES["B1"]] == launches[NAMES["B2"]] == 0, launches
    return dict(window=WINDOW_FULL, launches=launches, wall_s=wall,
                check_s=check_s[0], checks={"prefill": check},
                tokens_per_s=gen / wall, prefill_ms_median=pmed,
                decode_ms_median=dmed, decode_ms_p90=dp90, peak_gb=peak_gb,
                prefill_calls=n_pre, decode_calls=n_dec,
                tokens={r.rid: r.output for r in eng.finished})


def profile_summary(prof, n_win, win_step0, steps, win_wall, mode,
                    moe=False):
    """Device busy time of the traced window and its kernels; with
    ``moe``, also the MoE layer's device time between its markers."""
    avg = prof.key_averages()
    events = [(e.key, e.self_device_time_total) for e in avg
              if e.self_device_time_total > 0]
    assert events, "the profiler recorded no device activity"
    dev_us = sum(us for _, us in events)
    n_ops = sum(e.count for e in avg if e.self_device_time_total > 0)
    # the host's calls into CUDA (cuda* and cu* entry points: launches,
    # graph launches, copies, syncs): events without device time
    host_calls = {e.key: e.count for e in avg
                  if e.self_device_time_total == 0
                  and e.key.startswith(("cuda", "cu"))}
    n_host = sum(host_calls.values())
    b1_us = sum(us for k, us in events if "paged_prefill_" in k)
    b2_us = sum(us for k, us in events if "paged_decode_" in k)
    # B3's forward: the bf16 wgmma kernel or the fp32 tile
    b3_us = sum(us for k, us in events
                if "fwd_wgmma" in k or "flash_kernel" in k)
    log(f"profile ({mode}): steps {win_step0 + 1}-{steps} ({n_win} steps), "
        f"device busy (kernels and copies) {dev_us / 1e3:.1f} ms of "
        f"{win_wall * 1e3:.1f} ms wall of the same steps: busy share "
        f"{dev_us / 1e6 / win_wall:.3f}, idle share "
        f"{1 - dev_us / 1e6 / win_wall:.3f}; "
        f"{dev_us / 1e3 / n_win:.2f} ms busy per step in "
        f"{n_ops / n_win:.0f} device operations; B1 "
        f"{b1_us / 1e3 / n_win:.2f} ms per step ({b1_us / dev_us:.3f} of "
        f"busy time), B2 {b2_us / 1e3 / n_win:.2f} ms per step "
        f"({b2_us / dev_us:.3f}), B3 {b3_us / 1e3 / n_win:.2f} ms per step "
        f"({b3_us / dev_us:.3f})")
    log(f"profile ({mode}): {n_ops / n_win:.0f} device operations "
        f"(kernels, copies, memsets) and "
        + (f"{n_host / n_win:.0f} host calls into the CUDA runtime a step "
           f"(most: " + ", ".join(f"{k} {n / n_win:.1f}" for k, n in sorted(
               host_calls.items(), key=lambda kv: -kv[1])[:6]) + ")"
           if n_host else "host calls a step not measured (the trace holds "
           "no runtime events)"))
    for k, us in sorted(events, key=lambda e: -e[1])[:15]:
        log(f"profile ({mode}): {us / 1e3:10.2f} ms  {k[:100]}")
    out = dict(profile_busy_us=dev_us, profile_ops=n_ops,
               profile_host_calls=n_host, profile_host_call_kinds=host_calls,
               profile_b1_us=b1_us,
               profile_b2_us=b2_us, profile_b3_us=b3_us,
               profile_events=dict(events))
    if moe:
        moe_us, calls = marked_device_us(prof)
        assert calls > 0, "the trace holds no MoE call between markers"
        marker_us = sum(us for k, us in events if MARKER in k)
        log(f"profile ({mode}): MoE layer (router, dispatch, expert GEMMs, "
            f"combine) {moe_us / 1e3 / n_win:.2f} ms per step over {calls} "
            f"calls: {moe_us / dev_us:.3f} of busy time (markers "
            f"{marker_us / 1e3:.2f} ms in all)")
        out.update(profile_moe_us=moe_us, profile_moe_calls=calls)
    return out


# -------------------------------------------------------------- plan phase
# the simulator's run: tests/test_sim.py's trace and model on the paper
# testbed (the cost model's clock, not this card's)
SIM_TRACE = dict(workload="sharegpt", rate=1.5, duration=30, seed=0)
SIM_HORIZON_S = 300.0


def plan_phase(dev, profile, cfg, params):
    """Phase 12: the port's sigma* search plans qwen3-14b on the paper
    testbed for phase 5's traffic; phase 5's requests are served on the
    same weights with the planned primary and attention-pool roles under
    the fused step and the split schedule (phase 5's gates, and more than
    two pool shards holding pages); the elastic controller fails the
    anchor primary and re-plans; the three simulated systems serve one
    trace."""
    from repro_torch import sim
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.core.costmodel import LLAMA_70B
    from repro_torch.core.parallelizer import RequestDistribution, search
    from repro_torch.distributed import ElasticController

    t_phase = time.perf_counter()
    cluster = ClusterSpec.paper_testbed()
    prefill = int(round(float(prompt_lengths(np.random.default_rng(0))
                              .mean())))
    r = RequestDistribution(batch=N_REQ, prefill_len=prefill,
                            decode_ctx=prefill + NEW_TOKENS // 2,
                            avg_output_len=NEW_TOKENS)
    plan = search(cluster, cfg.profile(), r)
    primary = [d.device_id for d in plan.primary_workers]
    pool = [d.device_id for d in plan.attention_workers]
    for line in plan.summary().splitlines():
        log(f"plan: {line}")
    log(f"plan: {r}; primaries {primary}, attention pool {pool}; search "
        f"{plan.search_seconds * 1e3:.2f} ms of host time; the modeled "
        f"cost is the cost model's, for its A100/3090/P100 classes, not a "
        f"measurement of this card")
    assert pool and primary and not set(primary) & set(pool), plan.summary()

    runs = {}
    for mode in ("fused", "split"):
        runs[mode] = engine_phase(dev, profile, cfg, params, mode,
                                  cluster=cluster, roles=(primary, pool))
        free(f"the planned {mode} engine and its pools")
        held = runs[mode]["shards_held"]
        assert len(held) > 2, f"{mode}: pool shards holding pages {held}"

    # a primary fails: the controller re-plans over the survivors; it
    # rejoins: the plan is whole again (host only: the engine is not
    # restarted on the new plan, nor is the reference's)
    t0 = time.perf_counter()
    ec = ElasticController(cluster, cfg.profile(), r)
    assert [d.device_id for d in ec.plan.primary_workers] == primary
    anchor = primary[0]
    failed = [d.device_id for d in ec.fail(anchor).primary_workers]
    failed_pool = [d.device_id for d in ec.plan.attention_workers]
    rejoined = [d.device_id for d in ec.join(anchor).primary_workers]
    elastic_s = time.perf_counter() - t0
    log(f"plan: anchor primary {anchor} failed: primaries {failed}, pool "
        f"{failed_pool}; rejoined: primaries {rejoined}; events "
        f"{[(e.kind, e.device_id, e.detail) for e in ec.events]}; "
        f"{elastic_s * 1e3:.1f} ms of host time")
    assert anchor not in failed, failed
    assert len(rejoined) == len(primary), (rejoined, primary)

    # the three systems the paper compares, on the cost model's clock
    t0 = time.perf_counter()
    trace = sim.make_trace(**SIM_TRACE)
    simulated = {}
    for system in (sim.HetisSystem, sim.HexgenSystem, sim.SplitwiseSystem):
        res = sim.simulate(system(LLAMA_70B, ClusterSpec.paper_testbed()),
                           trace, SIM_TRACE["workload"], SIM_TRACE["rate"],
                           max_sim_seconds=SIM_HORIZON_S)
        simulated[res.system] = dict(
            requests=len(trace), finished=len(res.finished),
            served=len(res.served), duration_s=res.duration,
            throughput=res.throughput(),
            normalized_latency=res.normalized_latency(),
            p95_ttft=res.p95_ttft(), p95_tpot=res.p95_tpot())
        log(f"plan: simulated {res.system} ({LLAMA_70B.name}, paper testbed,"
            f" {SIM_TRACE['workload']} at {SIM_TRACE['rate']} req/s for "
            f"{SIM_TRACE['duration']} s; simulated clock of the cost "
            f"model's A100/3090/P100 classes, not a measurement of this "
            f"card): served {len(res.served)} of {len(trace)} in "
            f"{res.duration:.2f} s, {res.throughput():.4f} req/s, "
            f"normalised latency {res.normalized_latency():.4f} s/token, "
            f"p95 TTFT {res.p95_ttft():.4f} s, p95 TPOT "
            f"{res.p95_tpot():.4f} s")
        assert res.duration < SIM_HORIZON_S, simulated[res.system]
        assert len(res.served) == len(res.finished) == len(trace), \
            simulated[res.system]
    sim_s = time.perf_counter() - t0
    wall = time.perf_counter() - t_phase
    log(f"plan: simulation {sim_s:.2f} s of host time; phase 12 "
        f"{wall:.1f} s wall")
    return dict(plan=plan.summary(), primary=primary, pool=pool,
                request_distribution=dataclasses.asdict(r),
                search_s=plan.search_seconds, runs=runs,
                elastic=dict(failed=failed, failed_pool=failed_pool,
                             rejoined=rejoined, host_s=elastic_s),
                simulated=simulated, sim_host_s=sim_s, wall_s=wall)


# the families phase: published widths; depth (0: all layers), the rows'
# lengths (tokens, or hubert's frames), the row count
FAMILIES = {
    "hymba-1.5b": dict(lens=(1100, 2048)),
    # the 3 dense and the first 2 MoE layers of 61 (~53 GB in bf16)
    "deepseek-v3-671b": dict(layers=5, lens=(128, 1024)),
    "internvl2-1b": dict(lens=(128, 512)),
    "hubert-xlarge": dict(lens=(1000, 1600), rows=2),
    "xlstm-350m": dict(lens=(128, 512)),
}
FAMILY_NEW_TOKENS = 16
# where a family's floor and fault must bracket LOGITS_LIMIT: its output,
# except hubert's, whose final hidden states a dropped key tile (64 of
# 1600 keys, non-causal, under 48 layers of residual stream) moves by
# 0.027 only, against a 0.014 floor (PERF.md §6): there the layer-0
# attention output, where the same fault moves the output itself
BRACKET_AT_LAYER0 = ("hubert-xlarge",)


# spin-kernel cycles queued before a timed launch (~0.1 ms at the H100's
# clocks, more than a wrapper's host time), so the start event fires only
# after the launch is queued and the events hold the kernel's device time
SPIN_CYCLES = 200_000


class EventTimer:
    """Wraps ``fn`` (a module attribute) while a run goes: with
    ``device``, CUDA events around each call, after a spin kernel that
    keeps the card busy while the host launches (the events hold the
    call's device time only); else the wall time of each call between two
    synchronisations."""

    def __init__(self, module, attr, device):
        self.module, self.attr, self.device = module, attr, device
        self.fn = getattr(module, attr)
        self.pairs, self.wall = [], 0.0

    def _call(self, *a, **kw):
        if self.device:
            s, e = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
            torch.cuda._sleep(SPIN_CYCLES)
            s.record()
            out = self.fn(*a, **kw)
            e.record()
            self.pairs.append((s, e))
            return out
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = self.fn(*a, **kw)
        torch.cuda.synchronize()
        self.wall += time.perf_counter() - t
        self.pairs.append(None)
        return out

    def __enter__(self):
        setattr(self.module, self.attr, self._call)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.fn)

    def ms(self):
        if self.device:
            return sum(s.elapsed_time(e) for s, e in self.pairs)
        return self.wall * 1e3


def family_phase(dev, name):
    """One family at its published widths (``FAMILIES``): its main run
    (prefill and 15 carry decode_step calls, or hubert's forward_hidden
    per clip) with the B3 launch count set to 0 just before and read just
    after; the first call's layer-0 B3 launch against the plain version;
    that call's last-token logits (hubert: hidden states) against plain
    re-runs; then an instrumented prefill for B3's and the scans' shares.
    Returns the phase's numbers."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as T
    from repro_torch.models import xlstm as xlstm_mod
    spec = FAMILIES[name]
    cfg, params = full_width_params(dev, name, spec.get("layers", 0))
    rng = np.random.default_rng(1)
    lo, hi = spec["lens"]
    lens = rng.integers(lo, hi + 1, spec.get("rows", 4))
    lens[0] = hi                          # the longest row at the top
    attn_layers = 0 if cfg.xlstm_pattern else cfg.n_layers
    new = FAMILY_NEW_TOKENS
    encoder = cfg.is_encoder_only
    if encoder:                           # one clip per call
        clips = [family_batch(cfg, dev, [int(n)], i, torch.bfloat16)[0]
                 for i, n in enumerate(lens)]
        first = lambda: T.forward_hidden(cfg, params, clips[0])[0]
        max_seq = 0
    else:
        batch, lengths = family_batch(cfg, dev, lens, 0, torch.bfloat16)
        max_seq = int(lengths.max()) + new
        first = lambda: T.prefill(cfg, params, batch, max_seq, lengths)[0]
    kernel_fn = fa_ops.flash_attention
    layer0 = []                            # layer 0's inputs and output

    def capture(*a, **kw):
        o = kernel_fn(*a, **kw)
        if not layer0:
            layer0.append((a, kw, o))
        return o

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES["flash_attention"] = 0  # the main run starts here
    fa_ops.flash_attention = capture
    try:
        t0 = time.perf_counter()
        if encoder:
            outs = []
            for c in clips:
                outs.append(T.forward_hidden(cfg, params, c)[0])
                torch.cuda.synchronize()
                t_first = t_first if len(outs) > 1 else time.perf_counter()
            t1 = time.perf_counter()
            checked, toks, steps = outs[0], None, []
        else:
            logits, cache = T.prefill(cfg, params, batch, max_seq, lengths)
            torch.cuda.synchronize()
            t1 = t_first = time.perf_counter()
            checked, toks, steps = logits, [logits.argmax(-1)], [logits]
            for _ in range(new - 1):
                logits, cache = T.decode_step(cfg, params, cache,
                                              toks[-1][:, None])
                toks.append(logits.argmax(-1))
                steps.append(logits)
            torch.cuda.synchronize()
            toks = torch.stack(toks, 1).cpu()
            del cache
    finally:
        fa_ops.flash_attention = kernel_fn
    t2 = time.perf_counter()
    launches = fa_ops.LAUNCHES["flash_attention"]   # ... and ends here
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    calls = len(lens) if encoder else 1
    out = dict(layers=cfg.n_layers, groups=T.layer_groups(cfg),
               rows=[int(n) for n in lens],
               launches={NAMES["B3"]: launches}, prefill_calls=calls,
               prefill_ms=(t1 - t0) * 1e3 / calls,
               first_call_ms=(t_first - t0) * 1e3, peak_gb=peak_gb,
               finite=bool(all(torch.isfinite(x).all() for x in steps
                               + [checked])))
    if not encoder:
        out.update(decode_ms_per_token=(t2 - t1) * 1e3 / (new - 1),
                   tokens_per_s=len(lens) * new / (t2 - t0),
                   tokens=toks.tolist())

    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def rerun(attn_fn):
        fa_ops.flash_attention = attn_fn
        try:
            return first()
        finally:
            fa_ops.flash_attention = kernel_fn

    if attn_layers:
        a0, kw0, o0 = layer0[0]
        r0 = plain_flash()(*a0, **kw0).float()
        e0 = (o0.float() - r0).abs()
        ref = rerun(plain_flash())
        out.update(layer0_shape=[list(t.shape) for t in a0],
                   layer0_max_abs=float(e0.max()),
                   layer0_ok=bool((e0 <= TOL["bfloat16"]
                                   * (1 + r0.abs())).all()),
                   layer0_rel_l2=rel_l2(o0, r0),
                   layer0_floor_rel_l2=rel_l2(
                       plain_flash(round_p=True)(*a0, **kw0), r0),
                   layer0_fault_rel_l2=rel_l2(
                       plain_flash(drop_tile=True)(*a0, **kw0), r0),
                   rel_l2=rel_l2(checked, ref),
                   floor_rel_l2=rel_l2(rerun(plain_flash(round_p=True)),
                                       ref),
                   fault_rel_l2=rel_l2(rerun(plain_flash(drop_tile=True)),
                                       ref))
        if not encoder:
            out["argmax_agree"] = float(
                (checked.argmax(-1) == ref.argmax(-1)).float().mean())
        del a0, kw0, o0, r0, e0, ref
    layer0.clear()
    torch.cuda.empty_cache()

    # the instrumented re-run of the first call (hubert: its first clip):
    # B3 by events, the token scans by synchronised wall time
    scans = [(ssm_mod, "_scan")] if cfg.ssm_state else \
        [(xlstm_mod, "_mlstm_scan"), (xlstm_mod, "_slstm_scan")] \
        if cfg.xlstm_pattern else []
    with contextlib.ExitStack() as stack:
        b3 = stack.enter_context(EventTimer(fa_ops, "flash_attention", True))
        timers = [stack.enter_context(EventTimer(m, a, False))
                  for m, a in scans]
        torch.cuda.synchronize()
        t = time.perf_counter()
        first()
        torch.cuda.synchronize()
        inst_ms = (time.perf_counter() - t) * 1e3
    out.update(instrumented_prefill_ms=inst_ms, b3_ms=b3.ms(),
               b3_share=b3.ms() / out["first_call_ms"],
               scan_ms=sum(tm.ms() for tm in timers),
               scan_share=sum(tm.ms() for tm in timers) / inst_ms)

    what = (f"forward_hidden on clips of {out['rows']} frames" if encoder
            else f"prefill of rows of {out['rows']} tokens")
    if cfg.n_prefix_embeds:
        what += f" after {cfg.n_prefix_embeds} image embeddings"
    log(f"family {name}: {cfg.n_layers} layers {out['groups']}; {what}")
    log(f"family {name}: prefill {out['prefill_ms']:.1f} ms per call"
        + ("" if encoder else
           f", decode {out['decode_ms_per_token']:.2f} ms per token, "
           f"{out['tokens_per_s']:.2f} generated tokens/s ({len(lens)} x "
           f"{new})") + f"; peak memory {peak_gb:.1f} GB")
    log(f"family {name}: instrumented prefill {inst_ms:.1f} ms: B3 "
        f"{out['b3_ms']:.2f} ms of device time in {len(b3.pairs)} launches "
        f"(events behind a spin kernel; {out['b3_share']:.3f} of the "
        f"first call's wall, {out['first_call_ms']:.1f} ms), token scans "
        f"{out['scan_ms']:.1f} ms "
        f"({out['scan_share']:.3f} of the instrumented prefill; "
        f"synchronised wall)")
    log(f"family {name}: B3 launches {launches} == {attn_layers} attention "
        f"layers x {calls} prefill calls")
    assert launches == attn_layers * calls, (launches, attn_layers, calls)
    assert len(b3.pairs) == attn_layers
    assert out["finite"], "non-finite logits"
    if not encoder:
        assert toks.shape == (len(lens), new)
        assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    if attn_layers:
        log(f"family {name}: layer-0 B3 {out['layer0_shape']} vs plain max "
            f"abs err {out['layer0_max_abs']:.3g} (tol {TOL['bfloat16']}), "
            f"rel L2 {out['layer0_rel_l2']:.4g} (P rounded "
            f"{out['layer0_floor_rel_l2']:.4g}, keys 64-127 dropped "
            f"{out['layer0_fault_rel_l2']:.4g}); "
            f"{'hidden states' if encoder else 'last-token logits'} vs a "
            f"plain-attention re-run rel L2 {out['rel_l2']:.4g} (limit "
            f"{LOGITS_LIMIT}; P rounded {out['floor_rel_l2']:.4g}, keys "
            f"64-127 dropped {out['fault_rel_l2']:.4g})"
            + ("" if encoder else
               f", same argmax {out['argmax_agree']:.3f}"))
        if not (out["layer0_ok"] and out["rel_l2"] <= LOGITS_LIMIT):
            raise AssertionError(f"{name}: kernel disagrees with the plain "
                                 f"re-run: {out}")
        at = "layer0_" if name in BRACKET_AT_LAYER0 else ""
        assert out[at + "floor_rel_l2"] < LOGITS_LIMIT \
            < out[at + "fault_rel_l2"], out
        assert out["layer0_rel_l2"] <= LOGITS_LIMIT, out
    return out


# ------------------------------------------------------------ training
# the train phase's gradient gate: relative L2 of every leaf's gradient
# (and of the loss), kernel against a plain-attention re-run, between the
# floor (plain with P rounded to bf16) and a fault (one key tile dropped
# in layer 0's attention backward), both read in the same run; predicted
# before the first run, as LOGITS_LIMIT was
GRAD_LIMIT = 0.1
TRAIN_ARCH = "qwen1.5-0.5b"
# lr: TrainConfig's default (the reference's train loop's).  The
# launcher's 1e-3, its default for the reduced configs, does not learn in
# 20 steps at full width: Adam's first steps move every weight by lr, and
# the loss rose after step 5 (PERF.md, section 6)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR = 4096, 8, 3e-4
TRAIN_STEPS = 20


class PlainFlash(torch.autograd.Function):
    """Plain attention in place of B3's forward and backward (the train
    phase's re-runs), on BHSD views: the forward of ``plain_flash_grads``
    and, in the backward, its analytic gradient, both in query chunks."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, round_p, drop_tile):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, round_p, drop_tile)
        return plain_flash_grads(q, k, v, None, causal, window,
                                 round_p=round_p)[0].to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, window, round_p, drop_tile = ctx.args
        _, dq, dk, dv = plain_flash_grads(q, k, v, dout, causal, window,
                                          round_p=round_p,
                                          drop_tile=drop_tile)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def plain_train_attention(n_layers, round_p=False, drop_layer0=False):
    """``ops.flash_attention``'s signature over ``PlainFlash``.  Under
    remat a step calls attention 2 * n_layers times: the layers in order,
    then their recomputes in reverse order (the backward's), so call i is
    layer i, or 2 n - 1 - i; ``drop_layer0`` drops a key tile from layer
    0's backward."""
    calls = [0]

    def fn(q, k, v, *, causal=True, window=0, layout="BHSD", **_):
        i = calls[0] % (2 * n_layers)
        calls[0] += 1
        layer = i if i < n_layers else 2 * n_layers - 1 - i
        if layout == "BSHD":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        o = PlainFlash.apply(q, k, v, causal, window, round_p,
                             drop_layer0 and layer == 0)
        return o.transpose(1, 2) if layout == "BSHD" else o
    return fn


def _paths(tree, path):
    if isinstance(tree, dict):
        return {k: _paths(v, f"{path}.{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{path}[{i}]") for i, v in enumerate(tree)]
    return path


def leaf_names(tree):
    """The leaves' paths (``groups[0].attn.wq``), in flatten order."""
    from repro_torch.training.tree import flatten
    return flatten(_paths(tree, ""))[0]


def step_grads(cfg, params, batch):
    """(loss, the gradient of every leaf in flatten order) of one step."""
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import flatten
    loss, _ = T.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, flatten(params)[0],
                                materialize_grads=True)
    return loss.detach(), grads


def rel_l2(a, b):
    return float(torch.linalg.vector_norm((a.float() - b.float()))
                 / torch.linalg.vector_norm(b.float()).clamp(min=1e-30))


def grad_gate(tag, cfg, params, batch, kernel):
    """The training phases' gradient gate on one batch: ``kernel`` is the
    kernel step's (loss, gradients in flatten order); the same step again
    with plain attention in place of B3 (``plain_train_attention``: the
    plain re-run, the floor with P rounded to bf16, the fault with a key
    tile dropped from layer 0's backward), none launching a kernel; each
    leaf's relative L2 and the loss's against the plain re-run.  Fails
    unless floor < GRAD_LIMIT < fault and the kernel step is under the
    limit.  Returns (peak GB, the distances)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    L = cfg.n_layers
    names = leaf_names(params)
    kernel_fn = fa_ops.flash_attention

    def rerun(fn):
        fa_ops.flash_attention = fn
        before = dict(fa_ops.LAUNCHES)
        try:
            res = step_grads(cfg, params, batch)
            torch.cuda.synchronize()
        finally:
            fa_ops.flash_attention = kernel_fn
        assert fa_ops.LAUNCHES == before, "a kernel ran in a re-run"
        return res

    loss_p, g_p = rerun(plain_train_attention(L))
    dist = {}
    for t, fn in (("kernel", None),
                  ("floor", plain_train_attention(L, round_p=True)),
                  ("fault", plain_train_attention(L, drop_layer0=True))):
        loss, grads = kernel if fn is None else rerun(fn)
        per_leaf = {n: rel_l2(a, b) for n, a, b in zip(names, grads, g_p)}
        worst = max(per_leaf, key=per_leaf.get)
        dist[t] = {"loss": abs(float(loss) - float(loss_p))
                   / abs(float(loss_p)), "leaves": per_leaf,
                   "worst_leaf": worst, "worst": per_leaf[worst]}
        log(f"{tag}: {t} vs plain re-run: loss rel {dist[t]['loss']:.3g}"
            f", gradient rel L2 worst {per_leaf[worst]:.3g} ({worst}), "
            + ", ".join(f"{n} {e:.3g}" for n, e in per_leaf.items()))
        del grads
    peak = torch.cuda.max_memory_allocated() / 1e9
    floor = max(dist["floor"]["worst"], dist["floor"]["loss"])
    fault = dist["fault"]["worst"]
    if not (floor < GRAD_LIMIT < fault):
        raise AssertionError(f"{tag}: floor {floor:.3g} < limit "
                             f"{GRAD_LIMIT} < fault {fault:.3g} fails")
    if (dist["kernel"]["worst"] > GRAD_LIMIT
            or dist["kernel"]["loss"] > GRAD_LIMIT):
        raise AssertionError(f"{tag}: kernel step vs plain re-run over "
                             f"the limit: {dist['kernel']['worst']:.3g} "
                             f"({dist['kernel']['worst_leaf']})")
    return peak, dist


def train_flops(cfg, n_params, tokens, layers_params):
    """Model FLOPs of one remat training step: 6 N per token (forward and
    backward of every weight), 2 N_layers per token again for the remat
    forward of the layers, and the attention's products: 4 dh per visible
    (query row, key) pair and head in each of the two forwards, 2.5 times
    that in the backward."""
    pairs = visible_pairs(TRAIN_SEQ, TRAIN_SEQ, cfg.causal, 0)
    attn_fwd = 4.0 * cfg.head_dim * pairs * cfg.n_heads * TRAIN_BATCH \
        * cfg.n_layers
    return (6.0 * n_params * tokens + 2.0 * layers_params * tokens
            + 4.5 * attn_fwd), attn_fwd


def train_phase(dev, profile):
    """qwen1.5-0.5b at its published widths and all 24 layers, trained
    through ``repro_torch.training`` with every attention layer's forward
    and backward through B3's kernels (bf16 weights from ``init_params``,
    ``SyntheticLM`` at seq 4096 and global batch 8, lr 3e-4, remat on).
    Gates: (1) the first step's loss and every leaf's gradient against a
    plain-attention re-run, relative L2 under GRAD_LIMIT between the
    floor and the fault read in the same run; (2) exact B3 launches in
    that step: 2 forwards per layer (remat) and one of each backward
    kernel; (3) 20 steps with finite losses whose last 5 average below
    the first, served captured (``train`` on the card: the first step
    run and captured, 19 replays of its CUDA graph) and then eagerly
    (``graphs.disable_capture()``): the two runs' losses equal bit for
    bit, the launches exact in each; (4) restart, captured: 5 steps, a
    checkpoint, 5 more in a fresh ``train`` call from it (which captures
    anew on the restored tensors), equal to the 20-step run's first 10
    losses within rtol 1e-4, atol 1e-5, and the checkpoint's bf16 leaves
    bit-exact.  Records for each 20-step run ms per step (median, p90),
    tokens/s, peak memory, the model FLOP share, replays and the warm-up
    and capture seconds; with ``profile``, B3's device time per step from
    the profiler's trace."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import (TrainConfig, train,
                                                 trainable)
    from repro_torch.training.tree import flatten
    from repro_torch.weights import init_params
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    assert cfg.remat and cfg.dtype == "bfloat16"
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH)
    tokens = TRAIN_SEQ * TRAIN_BATCH
    out = {"arch": TRAIN_ARCH, "seq": TRAIN_SEQ, "batch": TRAIN_BATCH,
           "lr": TRAIN_LR, "layers": L}

    # (1) + (2): the first step against plain re-runs
    params = trainable(init_params(cfg, 0, dev))
    n_params = sum(p.numel() for p in flatten(params)[0])
    layers_params = sum(p.numel() for p in flatten(params["groups"])[0])
    out["params"] = n_params
    batch = {k: torch.from_numpy(v).to(dev, torch.int64)
             for k, v in SyntheticLM(dcfg).batch_at(0).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in fa_ops.LAUNCHES:
        fa_ops.LAUNCHES[key] = 0             # the phase's run starts here
    t0 = time.perf_counter()
    loss_k, g_k = step_grads(cfg, params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = dict(fa_ops.LAUNCHES)         # the checked step's
    out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches_per_step"] = launches
    log(f"train: {TRAIN_ARCH} {n_params / 1e9:.3f}e9 params ({L} layers, "
        f"remat), batch {TRAIN_BATCH} x {TRAIN_SEQ}: first step "
        f"{first_s:.2f} s, loss {float(loss_k):.4f}, peak "
        f"{out['step_peak_gb']:.1f} GB; launches {launches}")
    want = {"flash_attention": 2 * L, **{n: L for n in fa_ops.BWD_KERNELS}}
    if launches != want:
        raise AssertionError(f"train: B3 launches {launches} != {want}")
    out["rerun_peak_gb"], dist = grad_gate("train", cfg, params, batch,
                                           (loss_k, g_k))
    out.update(grad_distance=dist, limit=GRAD_LIMIT)
    del params, g_k, batch
    free("the checked step")

    # (3): 20 steps captured (the step one CUDA graph, replayed), then the
    # same 20 steps eagerly; (4): restart from a checkpoint after 5
    from repro_torch.serving import graphs
    flops, attn_fwd = train_flops(cfg, n_params, tokens, layers_params)
    runs = {}
    for how in ("captured", "eager"):
        torch.cuda.reset_peak_memory_stats()
        before = dict(fa_ops.LAUNCHES)
        with (graphs.disable_capture() if how == "eager"
              else contextlib.nullcontext()):
            run = train(cfg, dcfg, TrainConfig(steps=TRAIN_STEPS,
                                               lr=TRAIN_LR, device=str(dev)))
        got = {k: v - before.get(k, 0) for k, v in fa_ops.LAUNCHES.items()}
        steady = sorted(run["times"][1:])
        med = statistics.median(steady)
        p90 = steady[min(len(steady) - 1, int(0.9 * len(steady)))]
        g = run["graphs"]
        runs[how] = r = dict(
            losses=run["losses"], step_s=run["times"],
            step_ms_median=med * 1e3, step_ms_p90=p90 * 1e3,
            tokens_per_s=tokens / med,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
            flop_share=flops / med / PEAK_FLOPS["bfloat16"],
            graphs=g["graphs"], replays=g["replays"],
            warmup_s=sum(w for w, _ in g["capture_s"]),
            capture_s=sum(c for _, c in g["capture_s"]),
            launches_per_step={k: v / TRAIN_STEPS for k, v in got.items()
                               if v})
        del run
        free(f"the {how} 20-step run")
        losses = r["losses"]
        log(f"train ({how}): {TRAIN_STEPS} steps, loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f} (last 5 mean "
            f"{statistics.mean(losses[-5:]):.4f}); {r['graphs']} graph, "
            f"{r['replays']} replays, warm-up {r['warmup_s']:.2f} s + "
            f"capture {r['capture_s']:.2f} s; step ms median "
            f"{r['step_ms_median']:.1f} p90 {r['step_ms_p90']:.1f} (first "
            f"{r['step_s'][0] * 1e3:.1f}), {r['tokens_per_s']:.0f} training "
            f"tokens/s, {r['flop_share']:.3f} of 989 TFLOP/s; peak "
            f"{r['peak_gb']:.1f} GB; B3 launches a step "
            f"{r['launches_per_step']}")
        if got != {k: TRAIN_STEPS * want.get(k, 0) for k in got}:
            raise AssertionError(f"train ({how}): B3 launches {got} over "
                                 f"{TRAIN_STEPS} steps, not {want} a step")
        if not (all(math.isfinite(x) for x in losses)
                and statistics.mean(losses[-5:]) < losses[0]):
            raise AssertionError(f"train ({how}): the loss did not learn: "
                                 f"{losses}")
    cap = runs["captured"]
    assert (cap["graphs"], cap["replays"]) == (1, TRAIN_STEPS - 1), cap
    assert runs["eager"]["graphs"] == 0, runs["eager"]
    n_equal = sum(a == b for a, b in zip(cap["losses"],
                                         runs["eager"]["losses"]))
    log(f"train: captured vs eager losses equal at {n_equal} of "
        f"{TRAIN_STEPS} "
        f"steps; step ms median {cap['step_ms_median']:.1f} against "
        f"{runs['eager']['step_ms_median']:.1f}, peak "
        f"{cap['peak_gb']:.1f} GB against {runs['eager']['peak_gb']:.1f}")
    if n_equal != TRAIN_STEPS:
        raise AssertionError(f"train: captured losses {cap['losses']} != "
                             f"eager losses {runs['eager']['losses']}")
    losses, times = cap["losses"], cap["step_s"]
    med = cap["step_ms_median"] / 1e3
    out.update(losses=losses, step_s=times, step_ms_median=med * 1e3,
               step_ms_p90=cap["step_ms_p90"], tokens_per_s=tokens / med,
               peak_gb=cap["peak_gb"], model_flops=flops,
               attention_fwd_flops=attn_fwd,
               flop_share=flops / med / PEAK_FLOPS["bfloat16"],
               captured=cap, eager=runs["eager"])
    log(f"train: model FLOPs {flops:.3g} per step = "
        f"{flops / med / 1e12:.1f} TFLOP/s captured")
    ck = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        first = train(cfg, dcfg, TrainConfig(steps=5, lr=TRAIN_LR,
                                             ckpt_dir=str(ck), ckpt_every=5,
                                             device=str(dev)))
        saved = ckpt.restore(str(ck), 5, {"params": first["params"],
                                          "opt": first["opt"]})
        same = [torch.equal(a.view(torch.int16), b.view(torch.int16))
                if a.dtype == torch.bfloat16 else torch.equal(a, b)
                for a, b in zip(flatten({"params": first["params"],
                                         "opt": first["opt"]})[0],
                                flatten(saved)[0])]
        n_bf16 = sum(p.dtype == torch.bfloat16
                     for p in flatten(first["params"])[0])
        first_losses = first["losses"]
        del first, saved
        free("the first half")
        resumed = train(cfg, dcfg, TrainConfig(steps=10, lr=TRAIN_LR,
                                               ckpt_dir=str(ck), ckpt_every=5,
                                               device=str(dev)))["losses"]
        restart_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    both = first_losses + resumed
    np.testing.assert_allclose(both, losses[:10], rtol=1e-4, atol=1e-5)
    if not all(same):
        raise AssertionError("train: a checkpoint leaf did not restore "
                             "bit-exact")
    bit_equal = both == losses[:10]
    out.update(restart_losses=both, restart_bit_equal=bit_equal,
               restart_s=restart_s)
    out["launches"] = dict(fa_ops.LAUNCHES)  # ... and ends here
    log(f"train: B3 launches over the phase's {1 + 2 * TRAIN_STEPS + 10} "
        f"steps: {out['launches']}")
    log(f"train: restart 5 + checkpoint + 5 (each part captured anew) == "
        f"10 straight within rtol 1e-4, atol 1e-5; bit-equal: {bit_equal}; "
        f"{len(same)} checkpoint "
        f"leaves ({n_bf16} bf16) restored bit-exact; 15 steps with two "
        f"saves and a restore in {restart_s:.1f} s")
    free("the restart runs")

    if profile:
        out["profile"] = train_profile(cfg, dcfg)
        free("the profiled steps")
    return out


def train_profile(cfg, dcfg):
    """Two traced steps (after one untraced): B3's forward and backward
    kernels' device time per step and their shares of device busy time."""
    from repro_torch.training.data import SyntheticLM
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import train_step, trainable
    from repro_torch.weights import init_params
    params = trainable(init_params(cfg, 0, "cuda"))
    opt = adamw_init(params)
    data = SyntheticLM(dcfg)
    batch_at = lambda i: {k: torch.from_numpy(v).to("cuda", torch.int64)
                          for k, v in data.batch_at(i).items()}
    state = {"params": params, "opt": opt}

    def step(batch):
        state["params"], state["opt"], loss, _ = train_step(
            cfg, state["params"], state["opt"], batch, TRAIN_LR)
        return loss
    float(step(batch_at(0)))
    return profile_steps("train --profile", step,
                         [batch_at(i) for i in (1, 2)])


def profile_steps(tag, step, batches):
    """``step(batch)`` for each batch under the profiler (device activity
    only; ``step`` returns a scalar read at the end): device busy ms per
    step, B3's forward and backward kernels' device ms and shares of
    busy, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    n = len(batches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for b in batches:
            loss = step(b)
        float(loss)
    us = {e.key: e.self_device_time_total for e in prof.key_averages()
          if e.self_device_time_total > 0}
    busy = sum(us.values()) / n / 1e3
    pick = lambda *parts: sum(t for k, t in us.items()
                              if any(part in k for part in parts)) / n / 1e3
    # B3's forward and the backward's passes: the bf16 wgmma kernels or
    # the fp32 ones
    fwd, dkdv, dq, dot = (pick("fwd_wgmma", "flash_kernel"),
                          pick("dkdv_wgmma", "dkdv_kernel"),
                          pick("dq_wgmma", "dq_kernel"), pick("dot_kernel"))
    bwd = dkdv + dq + dot
    top = sorted(us.items(), key=lambda kv: -kv[1])[:8]
    log(f"{tag}: device busy {busy:.1f} ms per step; B3 forward "
        f"{fwd:.2f} ms ({fwd / busy:.3f} of busy), backward {bwd:.2f} ms "
        f"({bwd / busy:.3f}; dK/dV {dkdv:.2f}, dQ {dq:.2f}, D {dot:.2f}); "
        f"top kernels: " + "; ".join(f"{k[:60]} {t / n / 1e3:.2f} ms"
                                     for k, t in top))
    return {"busy_ms": busy, "b3_fwd_ms": fwd, "b3_bwd_ms": bwd,
            "dkdv_ms": dkdv, "dq_ms": dq, "dot_ms": dot,
            "fwd_share": fwd / busy, "bwd_share": bwd / busy,
            "top": [(k, t / n / 1e3) for k, t in top]}


def small_train_phase(dev):
    """Reduced fp32 qwen3 (GQA), qwen1.5 and dbrx (MoE: the aux loss) at
    dh 64, 5 training steps on the GPU (B3 forward and backward, no TF32)
    against the CPU (plain attention, autograd of it) from the same
    weights: losses within 1e-5 and the parameters within 1e-5 relative
    L2 over all leaves; exact B3 launches.  (AdamW moves each element by
    about lr whatever its gradient's size, so a leaf whose gradient is
    near the sum-order noise, or whose values are only a few lr, as
    qwen1.5's zero-initialised q/k biases after 5 steps, moves apart by
    more than 1e-5 of its own norm: 3.4e-5 on the CPU alone when only the
    attention's sums are reordered.  The worst leaf is logged.)"""
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.training.data import DataConfig
    from repro_torch.training.train_loop import TrainConfig, train
    from repro_torch.training.tree import flatten
    from repro_torch.weights import init_params
    for name in ("qwen3-14b", "qwen1.5-0.5b", "dbrx-132b"):
        cfg = dataclasses.replace(smoke_config(name), head_dim=64)
        params = init_params(cfg, 0, device="cpu")
        dcfg = DataConfig(cfg.vocab_size, seq_len=96, global_batch=4)
        runs = {}
        for device in ("cpu", dev):
            for key in fa_ops.LAUNCHES:
                fa_ops.LAUNCHES[key] = 0
            runs[str(device)] = train(cfg, dcfg, TrainConfig(
                steps=5, lr=1e-3, device=str(device)), params=params)
        launches = dict(fa_ops.LAUNCHES)
        cpu, gpu = runs["cpu"], runs[str(dev)]
        loss_err = max(abs(a - b) for a, b in zip(gpu["losses"],
                                                  cpu["losses"]))
        pairs = [(a.detach().cpu().float(), b.detach().float())
                 for a, b in zip(flatten(gpu["params"])[0],
                                 flatten(cpu["params"])[0])]
        param_err = rel_l2(torch.cat([a.reshape(-1) for a, _ in pairs]),
                           torch.cat([b.reshape(-1) for _, b in pairs]))
        leaf_err = max(rel_l2(a, b) for a, b in pairs)
        want = {"flash_attention": 5 * cfg.n_layers,
                **{n: 5 * cfg.n_layers for n in fa_ops.BWD_KERNELS}}
        log(f"small train: {name} (dh 64, fp32) 5 steps GPU vs CPU: losses "
            f"{[round(x, 5) for x in gpu['losses']]}, max loss diff "
            f"{loss_err:.3g}, parameters rel L2 {param_err:.3g} (limits "
            f"1e-5; worst leaf {leaf_err:.3g}); B3 launches {launches}")
        if loss_err > 1e-5 or param_err > 1e-5 or launches != want:
            raise AssertionError(f"small train ({name}): GPU != CPU")


# ------------------------------------------------------- launch steps
# phase 13: ``launch.steps.build(...).fn`` at the per-device share of the
# reference's (16, 16) pod mesh.  deepseek-v3 keeps its 3 dense layers
# (first_dense_layers): one MoE layer at full width holds 11.3e9
# parameters, and parameters, gradients and moments of one would not fit
STEPS_DEEPSEEK_LAYERS = 3
STEPS_TRAIN_STEPS = 3
STEPS_DECODE_STEPS = 4
# the prefill's logits gate: plain re-runs of row 0 only, in query chunks
# of 256 positions (5.4 GB of fp32 scores a chunk)
STEPS_PREFILL_CHUNK = 256


def chunked_plain_flash(round_p=False, drop_tile=False, chunk=256):
    """B3's plain version with the wrapper's signature, in query chunks
    (``plain_flash_grads``'s forward; a 32k call's whole score tensor
    would not fit), and its floor (``round_p``) and fault (``drop_tile``:
    keys 64-127 dropped from every row's softmax)."""
    def fn(q, k, v, *, causal=True, window=0, layout="BHSD", **_):
        if layout == "BSHD":
            q, k, v = (x.transpose(1, 2) for x in (q, k, v))
        o = plain_flash_grads(q, k, v, None, causal, window, round_p=round_p,
                              drop_tile=drop_tile, chunk=chunk)[0].to(q.dtype)
        return o.transpose(1, 2) if layout == "BSHD" else o
    return fn


def steps_launches_want(cfg, n_micro):
    """B3's launches in one train step: per microbatch each layer's
    forward twice under remat (the recompute) and each backward kernel
    once."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    L = cfg.n_layers
    return {"flash_attention": n_micro * L * (2 if cfg.remat else 1),
            **{n: n_micro * L for n in fa_ops.BWD_KERNELS}}


def steps_train_cell(dev, name, n_layers=0):
    """``train_4k`` through the train bundle: 16 rows of 4096 in the
    bundle's microbatches, AdamW moments of ``moment_dtype`` of the
    published config (the cut is of depth only), weights from
    ``init_params``, ``SyntheticLM`` batches.  Gates, besides those the
    caller adds on the first batch: exact B3 launches in every step,
    finite losses and gradient norms.  Returns (cfg, bundle, params,
    first batch, the cell's numbers); each step resets the launch counts
    just before it and reads them just after."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import steps
    from repro_torch.training.data import DataConfig, SyntheticLM
    from repro_torch.training.train_loop import trainable
    from repro_torch.training.tree import flatten
    from repro_torch.weights import init_params
    published = get_config(name)
    cfg = (dataclasses.replace(published, n_layers=n_layers) if n_layers
           else published)
    shape = SHAPES["train_4k"]
    bundle = steps.build(cfg, shape, dev)
    params = trainable(init_params(cfg, 0, dev))
    n_params = sum(p.numel() for p in flatten(params)[0])
    data = SyntheticLM(DataConfig(cfg.vocab_size, shape.seq_len,
                                  bundle.batch))
    batch_at = lambda i: {k: torch.from_numpy(v).to(dev)
                          for k, v in data.batch_at(i).items()}
    out = dict(arch=name, layers=cfg.n_layers,
               layers_published=published.n_layers, rows=bundle.batch,
               seq=shape.seq_len, n_micro=bundle.n_micro, params=n_params,
               moment_dtype=dtype_name(steps.moment_dtype(published)),
               desc=bundle.static_desc)
    log(f"steps: {name} train_4k, {cfg.n_layers} of {published.n_layers} "
        f"layers, {n_params / 1e9:.3f}e9 params, {bundle.batch} x "
        f"{shape.seq_len} rows in {bundle.static_desc}, "
        f"{out['moment_dtype']} moments")
    return cfg, published, bundle, params, batch_at, out


def steps_train_run(dev, cfg, published, bundle, params, batch_at, out,
                    profile):
    """``STEPS_TRAIN_STEPS`` steps of the bundle from fresh moments: each
    step's B3 launches exact, losses and gradient norms finite; ms per
    step, training tokens/s and peak memory; with ``profile`` one more
    step traced (``profile_steps``)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.tree import flatten
    tag = f"steps: {out['arch']} train_4k"
    opt = adamw_init(params, steps.moment_dtype(published))
    assert all(m.dtype == steps.moment_dtype(published)
               for m in flatten(opt["m"])[0])
    want = steps_launches_want(cfg, bundle.n_micro)
    losses, gnorms, times, launches = [], [], [], {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(STEPS_TRAIN_STEPS):
        batch = batch_at(i)
        torch.cuda.synchronize()
        for key in fa_ops.LAUNCHES:
            fa_ops.LAUNCHES[key] = 0         # the step's run starts here
        t0 = time.perf_counter()
        params, opt, met = bundle.fn(params, opt, batch)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
        times.append(time.perf_counter() - t0)
        got = dict(fa_ops.LAUNCHES)          # ... and ends here
        for key, n in got.items():
            launches[key] = launches.get(key, 0) + n
        if got != want:
            raise AssertionError(f"{tag}: B3 launches {got} != {want}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag}: losses {losses}, norms {gnorms}")
    tokens = out["rows"] * out["seq"]
    med = statistics.median(times[1:])
    out.update(losses=losses, grad_norms=gnorms, step_s=times,
               step_ms_median=med * 1e3, tokens_per_s=tokens / med,
               peak_gb=peak, launches=launches, launches_per_step=want)
    log(f"{tag}: {STEPS_TRAIN_STEPS} steps, losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in gnorms]}; step ms "
        f"{[round(t * 1e3, 1) for t in times]} (median of the last "
        f"{len(times) - 1}: {med * 1e3:.1f}), {tokens / med:.0f} training "
        f"tokens/s, peak {peak:.1f} GB; B3 launches per step {want}")
    if profile:
        state = {"params": params, "opt": opt}

        def step(batch):
            state["params"], state["opt"], met = bundle.fn(
                state["params"], state["opt"], batch)
            return met["loss"]
        out["profile"] = profile_steps(f"{tag} --profile", step,
                                       [batch_at(STEPS_TRAIN_STEPS)])
        params, opt = state["params"], state["opt"]
    return params, opt


def steps_qwen_cell(dev, profile):
    """qwen1.5-0.5b's train_4k at full width and depth: n_micro 2 of 8
    rows, each phase 11's batch.  Gate: one accumulated gradient
    (``steps.accumulate_grads``) equals the mean of phase 11's
    ``train_step`` gradients (``step_grads``) of rows [0, 8) and [8, 16)
    within fp32 rounding (relative L2 1e-6 per leaf; B3's backward and
    the step are deterministic), and its loss their mean; the bundle's
    first step gives that loss again."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.training.tree import flatten
    cfg, published, bundle, params, batch_at, out = steps_train_cell(
        dev, "qwen1.5-0.5b")
    tag = "steps: qwen1.5-0.5b train_4k"
    batch = batch_at(0)
    n, mb = bundle.n_micro, bundle.batch // bundle.n_micro
    for key in fa_ops.LAUNCHES:
        fa_ops.LAUNCHES[key] = 0
    acc, loss = steps.accumulate_grads(cfg, params, batch, n)
    torch.cuda.synchronize()
    got = dict(fa_ops.LAUNCHES)
    if got != steps_launches_want(cfg, n):
        raise AssertionError(f"{tag}: accumulate launches {got}")
    acc = flatten(acc)[0]
    per = [step_grads(cfg, params, {k: v[i * mb:(i + 1) * mb]
                                    for k, v in batch.items()})
           for i in range(n)]
    mean_loss = sum(float(l) for l, _ in per) / n
    worst = 0.0
    for j, a in enumerate(acc):
        want = per[0][1][j].float()
        for _, g in per[1:]:
            want = want + g[j].float()
        worst = max(worst, rel_l2(a, want / n))
    del per, acc
    loss_err = abs(float(loss) - mean_loss) / abs(mean_loss)
    out.update(accumulate_vs_steps_rel_l2=worst,
               accumulate_loss_rel=loss_err)
    log(f"{tag}: accumulated gradient vs the mean of phase 11's "
        f"train_step gradients over the {n} microbatches of {mb} rows: "
        f"worst leaf rel L2 {worst:.3g}, loss {float(loss):.6f} vs "
        f"{mean_loss:.6f} (limits 1e-6)")
    if worst > 1e-6 or loss_err > 1e-6:
        raise AssertionError(f"{tag}: accumulation != phase 11's steps")
    first = float(loss)
    params, opt = steps_train_run(dev, cfg, published, bundle, params,
                                  batch_at, out, profile)
    if abs(out["losses"][0] - first) > 1e-6 * abs(first):
        raise AssertionError(f"{tag}: the first step's loss "
                             f"{out['losses'][0]} != {first}")
    del params, opt
    return out


def steps_deepseek_cell(dev, profile):
    """deepseek-v3-671b's train_4k at its published widths and 3 dense
    layers: n_micro 16 of one row, bf16 moments.  Gate: the first
    microbatch's gradients (``step_grads`` on row 0) against plain
    re-runs (``grad_gate``: floor < GRAD_LIMIT < fault); the plain
    attention runs in query chunks of 512 positions over all 128 heads
    (1.07 GB of fp32 scores a chunk)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    cfg, published, bundle, params, batch_at, out = steps_train_cell(
        dev, "deepseek-v3-671b", STEPS_DEEPSEEK_LAYERS)
    mb = bundle.batch // bundle.n_micro
    first = {k: v[:mb] for k, v in batch_at(0).items()}
    for key in fa_ops.LAUNCHES:
        fa_ops.LAUNCHES[key] = 0
    kernel = step_grads(cfg, params, first)
    torch.cuda.synchronize()
    got = dict(fa_ops.LAUNCHES)
    if got != steps_launches_want(cfg, 1):
        raise AssertionError(f"steps: deepseek first microbatch launches "
                             f"{got}")
    out["gate_peak_gb"], dist = grad_gate(
        "steps: deepseek-v3-671b train_4k", cfg, params, first, kernel)
    out.update(grad_distance=dist, limit=GRAD_LIMIT)
    del kernel, first
    free("the checked microbatch")
    params, opt = steps_train_run(dev, cfg, published, bundle, params,
                                  batch_at, out, profile)
    del params, opt
    return out


def steps_prefill_cell(dev, cfg, params):
    """qwen3-14b's prefill_32k through the prefill bundle: 2 rows of
    32768 (B3's first 32k shape).  Gates: one B3 launch a layer; finite
    last-token logits; row 0's logits against chunked plain re-runs of
    row 0 (floor < LOGITS_LIMIT < fault).  ms and peak memory."""
    from repro_torch.configs import SHAPES
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    shape = SHAPES["prefill_32k"]
    bundle = steps.build(cfg, shape, dev)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (bundle.batch, shape.seq_len),
        dtype=np.int32)).to(dev)
    tag = "steps: qwen3-14b prefill_32k"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.LAUNCHES["flash_attention"] = 0   # the run starts here
    t0 = time.perf_counter()
    logits, cache = bundle.fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = fa_ops.LAUNCHES["flash_attention"]   # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    del cache
    if launches != cfg.n_layers or not torch.isfinite(logits).all():
        raise AssertionError(f"{tag}: launches {launches}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    kernel_fn = fa_ops.flash_attention

    def rerun(**kw):
        fa_ops.flash_attention = chunked_plain_flash(
            chunk=STEPS_PREFILL_CHUNK, **kw)
        try:
            return bundle.fn(params, {"tokens": tokens[:1]})[0]
        finally:
            fa_ops.flash_attention = kernel_fn
    t1 = time.perf_counter()
    ref = rerun()
    dist = dict(rel_l2=rel_l2(logits[:1], ref),
                floor_rel_l2=rel_l2(rerun(round_p=True), ref),
                fault_rel_l2=rel_l2(rerun(drop_tile=True), ref))
    rerun_s = time.perf_counter() - t1
    agree = bool(logits[0].argmax() == ref[0].argmax())
    out = dict(rows=bundle.batch, seq=shape.seq_len, ms=ms, peak_gb=peak,
               launches={NAMES["B3"]: launches}, argmax_agree=agree,
               rerun_s=rerun_s, **dist)
    log(f"{tag}: {bundle.batch} x {shape.seq_len} in {ms:.1f} ms, peak "
        f"{peak:.1f} GB, B3 launches {launches}; row 0's logits vs the "
        f"plain re-run rel L2 {dist['rel_l2']:.4f} (floor "
        f"{dist['floor_rel_l2']:.4f} < {LOGITS_LIMIT} < fault "
        f"{dist['fault_rel_l2']:.4f}; argmax agrees {agree}; three re-runs "
        f"of row 0 in {rerun_s:.1f} s)")
    if not (dist["floor_rel_l2"] < LOGITS_LIMIT < dist["fault_rel_l2"]
            and dist["rel_l2"] <= LOGITS_LIMIT):
        raise AssertionError(f"{tag}: logits gate fails: {dist}")
    return out


def steps_decode_cell(dev, cfg, params):
    """qwen3-14b's decode_32k through the decode bundle: 8 rows against a
    dense cache of 32768 positions filled with seeded values, each row
    at position 32768 - 5, one untimed and STEPS_DECODE_STEPS timed
    steps.  The context is cut (to whole 1024s) only if the cache would
    not fit beside the weights with 6 GB to spare.  Gates: tokens in the
    vocabulary, positions advanced.  ms per step (one token a row)."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.training.tree import flatten
    shape = SHAPES["decode_32k"]
    bundle = steps.build(cfg, shape, dev)
    rows = bundle.batch
    per_pos = sum(t.numel() * t.element_size() // t.shape[2] for t in
                  flatten(T.init_cache(cfg, rows, 1, "meta")["groups"])[0])
    free_b = torch.cuda.mem_get_info()[0]
    ctx = min(shape.seq_len, (free_b - 6e9) // per_pos // 1024 * 1024)
    tag = "steps: qwen3-14b decode_32k"
    if ctx < shape.seq_len:
        log(f"{tag}: the cache of {shape.seq_len} positions "
            f"({per_pos * shape.seq_len / 1e9:.1f} GB) does not fit beside "
            f"the weights; context cut to {ctx}")
    cache = T.init_cache(cfg, rows, int(ctx), dev)
    g = torch.Generator(device=dev).manual_seed(6)
    for t in flatten(cache["groups"])[0]:
        for layer in t:
            layer.normal_(generator=g)
    n = STEPS_DECODE_STEPS + 1
    cache["pos"].fill_(int(ctx) - n)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (rows, 1), dtype=np.int32)).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        tokens, cache = bundle.fn(params, cache, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    ok = (bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all())
          and bool((cache["pos"] == ctx).all()))
    med = statistics.median(times[1:])
    out = dict(rows=rows, context=int(ctx), cache_gb=per_pos * ctx / 1e9,
               step_ms=[t * 1e3 for t in times], ms_per_token=med * 1e3,
               tokens_per_s=rows / med, peak_gb=peak)
    log(f"{tag}: {rows} rows at context {ctx} (cache "
        f"{out['cache_gb']:.1f} GB): ms per step (one token a row) "
        f"{[round(t * 1e3, 2) for t in times]}, median of the timed "
        f"{med * 1e3:.2f} ms, {rows / med:.1f} tokens/s, peak "
        f"{peak:.1f} GB")
    del cache
    if not ok:
        raise AssertionError(f"{tag}: tokens out of range or positions "
                             f"not advanced")
    return out


def steps_phase(dev, profile):
    """Phase 13: the launch step functions on the card (see the cells'
    docstrings; with ``profile`` each train cell traces one more step).
    Returns the cells' numbers and the B3 launches of the timed steps and
    the prefill (what the kernels line counts)."""
    t0 = time.perf_counter()
    out = {"qwen1.5-0.5b train_4k": steps_qwen_cell(dev, profile)}
    free("the qwen1.5-0.5b train cell")
    out["deepseek-v3-671b train_4k"] = steps_deepseek_cell(dev, profile)
    free("the deepseek-v3 train cell")
    cfg, params = full_width_params(dev, "qwen3-14b")
    out["qwen3-14b prefill_32k"] = steps_prefill_cell(dev, cfg, params)
    free("the prefill cell")
    out["qwen3-14b decode_32k"] = steps_decode_cell(dev, cfg, params)
    del params
    free("qwen3-14b")
    launches = collections.Counter()
    for cell in ("qwen1.5-0.5b train_4k", "deepseek-v3-671b train_4k"):
        launches.update(out[cell]["launches"])
    launches[NAMES["B3"]] += out["qwen3-14b prefill_32k"]["launches"][
        NAMES["B3"]]
    out["launches"] = dict(launches)
    out["wall_s"] = time.perf_counter() - t0
    log(f"steps: phase 13 in {out['wall_s']:.1f} s; B3 launches "
        f"{out['launches']}")
    return out


def full_width_params(dev, name, n_layers=0, seed=0):
    """The published config ``name`` (its first ``n_layers`` layers, where
    given) and seeded weights for it on the card."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config(name)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    params = init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in leaves(params))
    experts = (f" experts {cfg.n_experts} top {cfg.top_k} expert d_ff "
               f"{cfg.moe_d_ff}" if cfg.n_experts else "")
    log(f"engine: {name} d_model {cfg.d_model} heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} dh {cfg.head_dim} d_ff {cfg.d_ff}{experts} vocab "
        f"{cfg.vocab_size} layers {cfg.n_layers} of "
        f"{get_config(name).n_layers} {cfg.dtype}: "
        f"{n_params / 1e9:.2f}e9 params, init "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    return cfg, params


def free(what):
    """Collect the engines and weights just dropped and return their
    memory to the card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"engine: {what} freed, {torch.cuda.memory_allocated() / 1e9:.1f} GB "
        f"still allocated")


def kernel_entry(kid, case, launches):
    pkg = "flash_attention" if kid == "B3" else "paged_attention"
    line = {"B1": 132, "B2": 179, "B3": 90}[kid]
    return {"name": NAMES[kid], "route": "cuda",
            "source": f"src/repro_torch/kernels/{pkg}/csrc/{NAMES[kid]}.cu",
            "replaces": f"src/repro/kernels/{pkg}/kernel.py:{line}",
            "launches": launches, "max_abs_err": case["max_abs_err"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "library_ms": case["library_ms"]}


# B1's decode-row cases in the kernels line: qwen3-14b's widths (GQA, the
# decode tile), at 2048 keys, and the MHA models' (r = 1, the split tile):
# phi3-mini's and qwen1.5-0.5b's
DECODE_ROWS = ("decode", "decode_2048", "decode_mha_dh96", "decode_mha_dh64")


def decode_tile_entry(cases, launches):
    """B1's launches of at most 16 folded rows a (row, kv head) on the
    decode tile in the kernels line (``csrc/paged_decode_tma.cuh``, which
    B2's bf16 launches at r > 1 run too): its numbers at B1's ``decode``
    case and, under "cases", each of DECODE_ROWS with the tile it ran; its
    launches those of the engine runs' GQA steps that packed no prefill
    chunk."""
    entry = kernel_entry("B1", cases[DECODE_ROWS[0]], launches)
    entry.update(name=NAMES["B1"] + " (decode tile)",
                 source="src/repro_torch/kernels/paged_attention/csrc/"
                        "paged_decode_tma.cuh",
                 cases={n: {k: cases[n][k] for k in (
                     "tile", "shape", "max_abs_err", "ms", "bound_ms",
                     "library_ms")} for n in DECODE_ROWS})
    return entry


def backward_entry(case, mla, launches):
    """B3's backward in the kernels line: its numbers at the train phase's
    shape (``case``; MLA's (192, 128) instance at deepseek-v3's
    microbatch under "mla"), its launches the backward calls of the train
    phase and of phase 13's train steps (each launches the D, dK/dV and
    dQ kernels once; ``launches_by_kernel`` gives each)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    by_kernel = {n: launches[n] for n in fa_ops.BWD_KERNELS}
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:90",
            "launches": min(by_kernel.values()),
            "launches_by_kernel": by_kernel,
            "max_abs_err": case["max_abs_err"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "dot_ms": case["dot_ms"], "dkdv_ms": case["dkdv_ms"],
            "dq_ms": case["dq_ms"],
            "mla": {k: mla[k] for k in (
                "shape", "dtype", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "dot_ms", "dkdv_ms",
                "dq_ms")}}


def wgmma_report(log_text):
    """Per bf16 TMA-fed instance in ptxas's report: B3's forward and
    backward (templated on q/k's and v's head dims and the consumer
    groups), B1's chunked prefill (on the head dim and the consumer
    groups) and the decode tile (on the head dim, in B2's library or B1's):
    {kernel: (registers, spill store bytes, spill load bytes,
    serialised)}."""
    import re
    pattern = (r"(?:(fwd|dkdv|dq|prefill)_wgmmaILi(\d+)ELi(\d+)E"
               r"(?:Li(\d+)E)?(?:Li(\d+)E)?"
               r"|paged_decode_tmaILi(\d+)ELb([01])E)")

    def key(m):
        if m.group(6):                # the decode tile (dh, decode)
            lib = "B2" if m.group(7) == "1" else "B1"
            return f"{lib} decode tile dh {m.group(6)} (mma.sync, TMA ring)"
        if m.group(1) == "prefill":  # (dh, groups, P in registers, heads)
            where = "registers" if m.group(4) == "1" else "shared memory"
            heads = ", a kv head each" if m.group(5) != "1" else ""
            return (f"B1 prefill dh {m.group(2)} ({m.group(3)} groups{heads}"
                    f", P in {where})")
        return (f"B3 {m.group(1)} dh {m.group(2)} dv {m.group(3)} "
                f"({m.group(4)} groups)")
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '\S*?" + pattern, line)
        if m:
            name = key(m)
            out[name] = [0, 0, 0, False]
            continue
        if re.search(r"C75\d\d.*serialized", line):  # wgmma serialised
            m = re.search(pattern, line)
            if m:
                out.setdefault(key(m), [0, 0, 0, False])[3] = True
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:3] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
            name = None
    return {k: tuple(v) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="read the kernel table's cases from the device "
                    "trace, and trace the engine steps after the checked ones "
                    "and print device busy time and kernel times")
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
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.paged_attention import ops
    sources = ops.SOURCES + fa_ops.SOURCES
    t0 = time.perf_counter()
    build.build_all(sources)
    for name, _ in ops.SOURCES:
        ops._library(name)
    for name, _ in fa_ops.SOURCES:
        fa_ops._library(name)
    log(f"build: {', '.join(n for n, _ in sources)} built in parallel "
        f"and loaded in {time.perf_counter() - t0:.1f} s")
    for name, _ in sources:
        for line in build.BUILD_LOG.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                log(f"build: {name}: {line.strip()}")
    report = wgmma_report("".join(build.BUILD_LOG.get(name, "")
                                  for name, _ in sources))
    for kname, (regs, st, ld, serial) in sorted(report.items()):
        log(f"build: bf16 {kname}: {regs} registers, spill "
            f"stores {st} B, loads {ld} B, wgmma "
            f"{'serialised' if serial else 'pipelined'}")
    # B3's forward and backward instances; B1's row-group kernel (C * r >
    # 64) and two-head kernel (C * r <= 64) at each head dim, and its
    # two-group kernel for grids that three groups leave short of the SMs
    # at dh 64 and 128; the decode tile at each head dim in B1's library
    # and in B2's
    assert len(report) == (len(fa_ops.HEAD_DIMS)
                           + 2 * len(fa_ops.BWD_HEAD_DIMS)
                           + 2 * len(ops.HEAD_DIMS)
                           + sum(dh != 96 for dh in ops.HEAD_DIMS)
                           + 2 * len(ops.HEAD_DIMS)), report
    spilled = {k: v for k, v in report.items() if v[1] or v[2]}
    if spilled:
        raise AssertionError(f"bf16 TMA-fed instances spill: {spilled}")
    serialised = {k: v for k, v in report.items()
                  if k.startswith("B1") and v[3]}
    if serialised:
        raise AssertionError(f"B1's wgmma instances serialise their "
                             f"products: {serialised}")
    for kid, warps in (("B1", (1, 4)), ("B2", (1,))):
        log(f"build: {NAMES[kid]}: dynamic shared memory per block " +
            ", ".join(f"{dt} dh {dh} {w} warp(s) "
                      f"{tile_smem_bytes(size, dh, w)} B"
                      for dt, size in (("fp32", 4), ("bf16", 2))
                      for dh in ops.HEAD_DIMS for w in warps))
    log(f"build: {NAMES['B3']}: fp32 dynamic shared memory per block (4 "
        f"warps) " + ", ".join(f"dh {dh} dv {dv} "
                               f"{tile_smem_bytes(4, dh, 4, dv)} B"
                               for dh, dv in fa_ops.HEAD_DIMS))

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    b1 = prefill_kernel_phase(dev, flush, args.profile)
    b2 = decode_kernel_phase(dev, flush, args.profile)
    b3 = flash_kernel_phase(dev, flush, args.profile)
    b3_bwd = flash_bwd_kernel_phase(dev, flush, args.profile)
    del flush
    small_engine_phase(dev)
    small_family_phase(dev)
    small_train_phase(dev)
    # the engine phases serve the same weights; each engine's pools are
    # freed before the next engine allocates its own
    cfg, params = full_width_params(dev, "qwen3-14b")
    # each captured engine run, then the same requests with every paged
    # call eager (phase 5: the same tokens, or the run fails)
    eager = {}
    fused = engine_phase(dev, args.profile, cfg, params, "fused")
    free("the fused engine and its pools")
    eager["qwen3-14b fused"] = eager_phase(dev, args.profile, cfg, params,
                                           fused, gate=True,
                                           step_mode="fused")
    free("the eager fused engine and its pools")
    split = engine_phase(dev, args.profile, cfg, params, "split")
    free("the split engine and its pools")
    eager["qwen3-14b split"] = eager_phase(dev, args.profile, cfg, params,
                                           split, gate=True,
                                           step_mode="split")
    same = sum(a == b for rid, toks in fused["tokens"].items()
               for a, b in zip(toks, split["tokens"][rid]))
    total = sum(len(t) for t in fused["tokens"].values())
    log(f"engine: split vs fused tokens agree at {same} of {total} "
        f"positions (bf16; B2 and B1 round differently)")
    free("the eager split engine and its pools")
    probe = {"fused": probe_phase(dev, cfg, params, "fused", fused)}
    free("the probed fused engine and its pools")
    probe["split"] = probe_phase(dev, cfg, params, "split", split)
    free("the probed split engine and its pools")
    tau = profile_attention_phase(dev)
    dense = dense_prefill_phase(dev, args.profile, cfg, params)
    same_dense = sum(a == b for rid, toks in split["tokens"].items()
                     for a, b in zip(toks, dense["tokens"][rid]))
    log(f"engine: dense-prefill vs split tokens agree at {same_dense} of "
        f"{total} positions (bf16; B3 and B1 round differently)")
    free("the dense-prefill engine")
    eager["qwen3-14b dense prefill"] = eager_phase(
        dev, args.profile, cfg, params, dense, prefill_mode="dense")
    free("the eager dense-prefill engine")
    # the same weights with a sliding window on every layer: the dense route
    windowed = window_phase(dev, cfg, params)
    free("the windowed engine")
    # phase 12 on the same weights: the planned roles
    plan = plan_phase(dev, args.profile, cfg, params)
    del params
    free("qwen3-14b")

    # dbrx: the published widths at 8 of 40 layers (40 layers are 263 GB
    # in bf16), fused then split on the same weights
    cfg, params = full_width_params(dev, "dbrx-132b", DBRX_LAYERS)
    dbrx = {"fused": engine_phase(dev, args.profile, cfg, params, "fused")}
    free("the fused engine and its pools")
    eager["dbrx-132b fused"] = eager_phase(dev, args.profile, cfg, params,
                                           dbrx["fused"], step_mode="fused")
    free("the eager fused engine and its pools")
    # the probe's mlp spans around MoE layers
    probe["dbrx fused"] = probe_phase(dev, cfg, params, "fused",
                                      dbrx["fused"])
    free("the probed fused engine and its pools")
    dbrx["split"] = engine_phase(dev, args.profile, cfg, params, "split")
    free("the split engine and its pools")
    eager["dbrx-132b split"] = eager_phase(dev, args.profile, cfg, params,
                                           dbrx["split"], step_mode="split")
    same_dbrx = sum(a == b for rid, toks in dbrx["fused"]["tokens"].items()
                    for a, b in zip(toks, dbrx["split"]["tokens"][rid]))
    log(f"engine: dbrx split vs fused tokens agree at {same_dbrx} of "
        f"{total} positions (bf16; other kernels, and capacity drops "
        f"depend on each call's token rows)")
    del params
    free("dbrx-132b")

    # the other dense configs of the main path at full width and depth,
    # and qwen1.5-0.5b again with fp8 KV pools
    dense_cfgs = {}
    for name in ("qwen1.5-0.5b", "phi3-mini-3.8b", "minitron-8b"):
        cfg, params = full_width_params(dev, name)
        dense_cfgs[name] = engine_phase(dev, args.profile, cfg, params,
                                        "fused")
        free("the engine and its pools")
        eager[name] = eager_phase(dev, args.profile, cfg, params,
                                  dense_cfgs[name], step_mode="fused")
        if name == "qwen1.5-0.5b":
            free("the eager engine and its pools")
            fp8 = dataclasses.replace(cfg, kv_cache_dtype="float8_e4m3fn")
            dense_cfgs[name + " fp8"] = engine_phase(dev, args.profile, fp8,
                                                     params, "fused")
            free("the engine and its pools")
            eager[name + " fp8"] = eager_phase(
                dev, args.profile, fp8, params, dense_cfgs[name + " fp8"],
                step_mode="fused")
        del params
        free(name)

    # the families the engine does not serve, through the model functions
    families = {}
    for name in FAMILIES:
        families[name] = family_phase(dev, name)
        free(name)

    # training at full width, every attention layer through B3 and its
    # backward
    training = train_phase(dev, args.profile)
    # the launch step functions: train_4k (qwen1.5, deepseek-v3 with MLA's
    # backward), prefill_32k and decode_32k
    launch_steps = steps_phase(dev, args.profile)

    runs = (fused, split, dense, windowed, *plan["runs"].values(),
            *dbrx.values(),
            *dense_cfgs.values(), *probe.values(), *families.values(),
            training, launch_steps)
    entries = [kernel_entry(kid, case, sum(r["launches"].get(NAMES[kid], 0)
                                           for r in runs))
               for kid, case in (("B1", b1["mixed"]), ("B2", b2["decode"]),
                                 ("B3", b3["prefill"]))]
    entries.insert(1, decode_tile_entry(
        b1, sum(r.get("b1_tiles", {}).get("tma", 0)
                          for r in runs)))
    assert all(e["launches"] > 0 for e in entries), entries
    entries.append(backward_entry(
        b3_bwd["train"], b3_bwd["mla"],
        collections.Counter(training["launches"])
        + collections.Counter(launch_steps["launches"])))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "b1_cases": b1, "b2_cases": b2, "b3_cases": b3,
             "engine_fused": fused, "engine_split": split,
             "engine_dense_prefill": dense, "engine_window": windowed,
             "engine_dbrx": dbrx,
             "engine_dense_configs": dense_cfgs, "engine_probe": probe,
             "engine_eager": eager,
             "plan": plan,
             "families": families, "b3_backward_cases": b3_bwd,
             "train": training, "steps": launch_steps,
             "profile_attention": tau,
             "split_fused_token_agreement": [same, total],
             "dense_split_token_agreement": [same_dense, total],
             "dbrx_split_fused_token_agreement": [same_dbrx, total]},
            indent=1))
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
