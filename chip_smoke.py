#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--out PATH]

Phases, in order; any failure exits nonzero:

  1. card:    the card's name and power limit (nvidia-smi); TF32 off.
  2. build:   the chunked paged-prefill kernel compiled from
              src/repro_torch/kernels/paged_attention/csrc/ with nvcc.
  3. kernel:  the kernel against its plain PyTorch version at the serving
              shapes of qwen3-14b (Hkv 8, r 5, dh 128, page 16, bf16 pools;
              decode-only, prefill-only and mixed row batches, and one
              fp32 batch), timed with CUDA events beside its bound and
              F.scaled_dot_product_attention over pre-gathered K/V.
  4. small:   a reduced fp32 engine on the GPU (kernel) against the same
              engine on the CPU (plain attention): identical tokens.
  5. engine:  the port's InferenceEngine serving qwen3-14b at full width
              and depth with seeded random weights, on a simulated
              A100 + 3090 cluster whose two pool shards both live on this
              GPU.  Counts the kernel's launches over the run and re-runs
              one mixed step and one step with remote pages with the plain
              attention to hold their logits against the kernel's (beside
              two more re-runs: P rounded, the noise floor; a page
              dropped, a fault the limit must catch).  With --profile the
              steps after the checked ones are traced (device activity
              only) and their busy and idle shares printed.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device it exits
nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
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
# full-width step logits, kernel vs plain re-run, relative L2: near the
# geometric mean of the bf16 noise floor (plain with P rounded vs plain:
# 0.0145 and 0.0184 on an H100) and a fault (plain with one page dropped
# vs plain: 0.72 and 1.38); PERF.md gives the readings
LOGITS_LIMIT = 0.1


def log(msg: str) -> None:
    print(msg, flush=True)


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


# ------------------------------------------------------------- kernel phase
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


def bound(args, dtype_name):
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
    t_bytes, t_ops = nbytes / HBM_BPS, flops / PEAK_FLOPS[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


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


def kernel_phase(dev, flush):
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import \
        paged_prefill_attention_ref
    rng = torch.Generator().manual_seed(1)
    ragged = [int(x) for x in torch.randint(100, 2048, (16,),
                                            generator=rng)]
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
        dname = str(dtype).replace("torch.", "")
        args = make_rows(dev, dtype, rows, C)
        got = ops.paged_prefill_attention(*args)
        torch.cuda.synchronize()
        ref = paged_prefill_attention_ref(*args)
        err = (got.float() - ref.float()).abs()
        max_err = float(err.max())
        ok = bool((err <= TOL[dname] * (1 + ref.float().abs())).all())
        padded = args[4] == 0
        if not (ok and torch.isfinite(got).all()
                and bool((got[padded] == 0).all())):
            raise AssertionError(f"kernel disagrees with plain ({name}): "
                                 f"max abs err {max_err}")
        ms = time_ms(lambda: ops.paged_prefill_attention(*args), 20, flush)
        plain = time_ms(lambda: paged_prefill_attention_ref(*args), 3,
                        flush)
        lib = sdpa_ms(args, flush)
        b_ms, b_by, nbytes, flops = bound(args, dname)
        results[name] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain,
                             library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                             bytes=nbytes, flops=flops,
                             shape=list(args[0].shape), dtype=dname)
        log(f"kernel {name}: q {list(args[0].shape)} {dname} "
            f"max_abs_err {max_err:.3g} (tol {TOL[dname]}) | kernel_ms "
            f"{ms:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} bound_ms "
            f"{b_ms:.4f} ({b_by}: {nbytes} B, {flops:.4g} FLOP) roofline "
            f"{b_ms / ms:.3f}")
        del args, got, ref, err
        torch.cuda.empty_cache()
    return results


def plain_attention(round_p=False, wrong_page=False):
    """The kernel's plain version as the wrapper calls it (tables
    clipped).  ``round_p`` rounds P to V's type before PV with the sum l
    taken unrounded, as the kernel and the Pallas reference do: a second
    exact implementation, whose distance from the plain one is the bf16
    noise floor of a step's logits.  ``wrong_page`` reads each row's page
    0 from page 1's slot: a fault (one page dropped) that the logits check
    must catch."""
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
    """Reduced fp32 qwen3 family (dh 64, so the kernel takes it): the
    engine on the GPU must emit the CPU engine's tokens."""
    from repro_torch.configs import smoke_config
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(smoke_config("qwen3-14b"), head_dim=64)
    cpu_params = init_params(cfg, 0, device="cpu")
    outs = {}
    for device in ("cpu", dev):
        eng = InferenceEngine(
            cfg, to_device(cpu_params, device),
            ClusterSpec.build([("A100", 1), ("3090", 1)]),
            primary_ids=[0], pool_ids=[1],
            engine_cfg=EngineConfig(max_batch=8, max_seq=128, page_size=16,
                                    prefill_chunk=16), device=device)
        rng = np.random.default_rng(0)
        for i in range(6):
            eng.submit(Request(rid=i, prompt=[
                int(x) for x in rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(5, 60)))],
                max_new_tokens=8))
        assert eng.run_until_drained(500)
        outs[str(device)] = {r.rid: r.output for r in eng.finished}
    if outs["cpu"] != outs[str(dev)]:
        raise AssertionError(f"small engine: GPU tokens {outs[str(dev)]} "
                             f"!= CPU tokens {outs['cpu']}")
    log(f"small engine: 6 requests, GPU == CPU token streams "
        f"({sum(len(v) for v in outs['cpu'].values())} tokens)")


# ------------------------------------------------------------- engine phase
def engine_phase(dev, profile, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.core.cluster import ClusterSpec
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving import EngineConfig, InferenceEngine, Request
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
    eng = InferenceEngine(
        cfg, params, ClusterSpec.build([("A100", 1), ("3090", 1)]),
        primary_ids=[0], pool_ids=[1],
        engine_cfg=EngineConfig(max_batch=16, max_seq=2048,
                                prefill_chunk=64, telemetry=True),
        device=dev)
    rng = np.random.default_rng(seed)
    n_req, new_tokens = 16, 32
    prompt_lens = rng.integers(128, 1025, n_req)
    for i, n in enumerate(prompt_lens):
        eng.submit(Request(rid=i, prompt=[int(x) for x in rng.integers(
            0, cfg.vocab_size, int(n))], max_new_tokens=new_tokens))

    # hold the first mixed step (decode + prefill rows) and the first
    # step with remote pages staged in against re-runs of the same steps
    # with plain attention
    checks = {}
    checked_steps = set()                  # their step times are left out
    check_s = [0.0]                        # wall seconds the checks add
    fused_fn = eng._fused_fn.fn
    kernel_fn = ops.paged_prefill_attention

    def rerun(p, before_k, before_v, idx, attn_fn):
        """The step's logits re-run from the pre-step pools with
        ``attn_fn`` in place of the kernel."""
        wk = {d: t.clone() for d, t in before_k.items()}
        wv = {d: t.clone() for d, t in before_v.items()}
        ops.paged_prefill_attention = attn_fn
        try:
            logits, _, _ = T.sharded_fused_step(
                cfg, p, wk, wv, eng.kv.anchor, eng.kv.sink, *idx)
        finally:
            ops.paged_prefill_attention = kernel_fn
        return logits

    def rel_l2(a, b):
        return float((a - b).norm() / b.norm())

    def checked(p, kps, vps, *idx):
        gd, ln, st = idx[0], idx[7], idx[8]
        n_tok = ln - st
        kinds = []
        if bool(((n_tok == 1) & (ln > 0)).any()) and bool((n_tok > 1).any()):
            kinds.append("mixed")
        if gd.shape[0] > 0:
            kinds.append("remote")
        kinds = [k for k in kinds if k not in checks]
        if not kinds:
            return fused_fn(p, kps, vps, *idx)
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

        ops.paged_prefill_attention = capture
        try:
            out = fused_fn(p, kps, vps, *idx)
        finally:
            ops.paged_prefill_attention = kernel_fn
        torch.cuda.synchronize()
        t = time.perf_counter()
        launches = ops.LAUNCHES
        # the main path's own layer-0 launch against the plain version on
        # the same inputs: no amplification through later layers
        *a0, o0 = layer0[0]
        r0 = plain_attention()(*a0).float()
        e0 = (o0.float() - r0).abs()
        logits = out[0]
        plain = rerun(p, before_k, before_v, idx, plain_attention())
        floor = rerun(p, before_k, before_v, idx,
                      plain_attention(round_p=True))
        fault = rerun(p, before_k, before_v, idx,
                      plain_attention(wrong_page=True))
        assert ops.LAUNCHES == launches
        res = dict(rel_l2=rel_l2(logits, plain),
                   floor_rel_l2=rel_l2(floor, plain),
                   fault_rel_l2=rel_l2(fault, plain),
                   max_abs=float((logits - plain).abs().max()),
                   argmax_agree=float((logits.argmax(-1) == plain.argmax(-1))
                                      .float().mean()),
                   decode_rows=int(((n_tok == 1) & (ln > 0)).sum()),
                   prefill_rows=int((n_tok > 1).sum()),
                   lanes=int(gd.shape[0]),
                   finite=bool(torch.isfinite(logits).all()),
                   shape=list(logits.shape),
                   layer0_max_abs=float(e0.max()),
                   layer0_ok=bool((e0 <= TOL["bfloat16"]
                                   * (1 + r0.abs())).all()))
        for k in kinds:
            checks[k] = res
        checked_steps.add(int(eng.metrics["fused_steps"]))
        del before_k, before_v, plain, floor, fault, layer0, a0, o0, r0, e0
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        check_s[0] += time.perf_counter() - t
        return out

    eng._fused_fn.fn = checked
    torch.cuda.reset_peak_memory_stats()
    ops.LAUNCHES = 0                       # the main path's run starts here
    t0 = time.perf_counter()
    # the checked steps come early; the window after them is all plain
    # serving, and --profile traces exactly that window
    while len(checks) < 2 and (eng.queue or eng.running or eng.prefilling):
        eng.step()
    torch.cuda.synchronize()
    win_step0 = int(eng.metrics["fused_steps"])
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
    launches = ops.LAUNCHES                # ... and ends here
    # serving wall time: the run less the checks' own work (pool copies,
    # the layer-0 plain call and the plain re-runs); every step's tokens
    # stay counted
    wall = time.perf_counter() - t0 - check_s[0]

    steps = int(eng.metrics["fused_steps"])
    spans = eng.tracer.spans("fused_step")
    durs = [sp.dur for i, sp in enumerate(spans) if i not in checked_steps]
    gen = n_req * new_tokens
    log(f"engine: {n_req} requests, prompts {int(prompt_lens.sum())} "
        f"tokens, generated {gen}; {steps} fused steps in {wall:.2f} s "
        f"wall ({check_s[0]:.2f} s of checks left out"
        f"{'; with the profiler window' if profile else ''}); "
        f"{gen / wall:.2f} generated tokens/s; "
        f"{(gen + int(prompt_lens.sum())) / wall:.1f} tokens/s incl. "
        f"prompts; fused-step ms median "
        f"{statistics.median(durs) * 1e3:.2f} p90 "
        f"{sorted(durs)[int(0.9 * len(durs))] * 1e3:.2f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    args = [sp.args for sp in spans]
    real = sum(a["decode_rows"] + a["prefill_tokens"] for a in args)
    padded = sum(a["batch"] * a["chunk"] for a in args)
    log(f"engine: row batches carry {real} real tokens in {padded} "
        f"computed token rows ({real / padded:.3f}); batch buckets "
        f"{sorted(collections.Counter(a['batch'] for a in args).items())}, "
        f"chunk buckets "
        f"{sorted(collections.Counter(a['chunk'] for a in args).items())}")
    log(f"engine: kernel launches {launches} == {cfg.n_layers} layers x "
        f"{steps} steps; redispatches {int(eng.metrics['redispatches'])}, "
        f"evictions {int(eng.metrics['evictions'])}, staged d2d "
        f"{eng.snapshot()['fastpath/gather_d2d_bytes'] / 1e9:.2f} GB, "
        f"distinct step shapes {eng.fused_compile_count()}")
    for kind, res in checks.items():
        log(f"engine: {kind} step ({res['decode_rows']} decode + "
            f"{res['prefill_rows']} prefill rows, {res['lanes']} exchange "
            f"lanes) kernel vs plain: layer-0 attention max abs err "
            f"{res['layer0_max_abs']:.3g} (tol {TOL['bfloat16']}); re-run "
            f"logits rel L2 {res['rel_l2']:.4g} (limit {LOGITS_LIMIT}; "
            f"plain with P rounded {res['floor_rel_l2']:.4g}, plain with a "
            f"page dropped {res['fault_rel_l2']:.4g}), max abs "
            f"{res['max_abs']:.3g}, argmax agreement "
            f"{res['argmax_agree']:.3f}")
    log(f"engine: window after the checks: steps {win_step0 + 1}-{steps}, "
        f"{win_wall:.3f} s wall{' under the profiler' if profile else ''}")

    assert drained and len(eng.finished) == n_req, "not every request done"
    assert all(len(r.output) == new_tokens for r in eng.finished)
    assert all(0 <= t < cfg.vocab_size for r in eng.finished
               for t in r.output)
    assert eng.metrics["model_calls"] == steps
    assert launches == cfg.n_layers * steps, (launches, cfg.n_layers, steps)
    eng.kv.check_invariants()
    assert set(checks) == {"mixed", "remote"}, \
        f"steps checked against the plain re-run: {sorted(checks)}"
    for kind, res in checks.items():
        if not (res["finite"] and res["layer0_ok"]
                and res["rel_l2"] <= LOGITS_LIMIT):
            raise AssertionError(f"{kind} step logits disagree with the "
                                 f"plain re-run: {res}")
        # the limit must tell a dropped page from rounding
        assert res["fault_rel_l2"] > LOGITS_LIMIT, res
    out = dict(launches=launches, steps=steps, wall_s=wall,
               check_s=check_s[0], tokens_per_s=gen / wall, checks=checks,
               real_tokens=real, computed_token_rows=padded,
               step_ms_median=statistics.median(durs) * 1e3,
               step_ms=[d * 1e3 for d in durs], window_steps=[
                   win_step0 + 1, steps], window_wall_s=win_wall)
    if profile:
        avg = prof.key_averages()
        events = [(e.key, e.self_device_time_total) for e in avg
                  if e.self_device_time_total > 0]
        assert events, "the profiler recorded no device activity"
        dev_us = sum(us for _, us in events)
        attn_us = sum(us for k, us in events if "paged_prefill_kernel" in k)
        n_win = steps - win_step0
        log(f"profile: steps {win_step0 + 1}-{steps} ({n_win} steps), "
            f"device busy (kernels and copies) {dev_us / 1e3:.1f} ms of "
            f"{win_wall * 1e3:.1f} ms wall of the same steps: busy share "
            f"{dev_us / 1e6 / win_wall:.3f}, idle share "
            f"{1 - dev_us / 1e6 / win_wall:.3f}; "
            f"{dev_us / 1e3 / n_win:.2f} ms busy per step; B1 "
            f"{attn_us / 1e3 / n_win:.2f} ms per step "
            f"({attn_us / dev_us:.3f} of busy time)")
        for k, us in sorted(events, key=lambda e: -e[1])[:15]:
            log(f"profile: {us / 1e3:10.2f} ms  {k[:100]}")
        out.update(profile_busy_us=dev_us, profile_attention_us=attn_us,
                   profile_events=dict(events))
    return out


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
    ops._library()
    log(f"build: paged_prefill_attention built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG.get("paged_prefill_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"build: {line.strip()}")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device=dev)
    kern = kernel_phase(dev, flush)
    del flush
    small_engine_phase(dev)
    eng = engine_phase(dev, args.profile)

    m = kern["mixed"]
    entry = {"name": "paged_prefill_attention", "route": "cuda",
             "source": "src/repro_torch/kernels/paged_attention/csrc/"
                       "paged_prefill_attention.cu",
             "replaces": "src/repro/kernels/paged_attention/kernel.py:132",
             "launches": eng["launches"], "max_abs_err": m["max_abs_err"],
             "ms": m["ms"], "plain_ms": m["plain_ms"],
             "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
             "library_ms": m["library_ms"]}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernel_cases": kern, "engine": eng}, indent=1))
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
