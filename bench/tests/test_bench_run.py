"""The harness's whole run at a tiny size on the CPU (its look for a card
left out): a sound run is correct and reads its metrics; with the timed
path broken underneath, ``correct`` comes out false for each fault a
served cell can have; the control reads far above the program; and a
run loads no module of JAX or of the JAX package."""

import subprocess
import sys

import pytest
import torch

from bench.tests import _tiny

E2E = ("ttft_p50_ms", "itl_p99_ms", "out_tok_s", "setup_s")
PER_LAYER = ("ttft_p50_ms.online", "host_ms_step.online", "row_fill.online",
             "captures_in_window.online", "staged_mb_step.online",
             "mfu.online")


def test_a_sound_run_is_correct():
    out = _tiny.run(_tiny.cell(e2e=E2E))
    assert out["correct"] is True
    assert set(out["metrics"]) == set(E2E)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_a_sound_backlog_run_is_correct():
    out = _tiny.run(_tiny.cell(config=_tiny.MOE, arrivals="backlog",
                               e2e=("out_tok_s", "setup_s")))
    assert out["correct"] is True
    assert out["metrics"]["out_tok_s"]["value"] > 0


def test_a_traced_run_reads_the_per_layer_metrics():
    out = _tiny.run(_tiny.cell(per_layer=PER_LAYER), trace=True)
    assert out["correct"] is True
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == set(PER_LAYER)
    assert 0 < m["row_fill.online"] <= 100
    assert m["staged_mb_step.online"] > 0       # the exchange is live


def _keep_pools(orig):
    """The step's K/V written into copies: the pools keep their state."""
    def fault(cfg, p, x, kpool, vpool, *a):
        return orig(cfg, p, x, kpool.clone(), vpool.clone(), *a)
    return fault


def _half_batch(orig):
    """The second half of the call's real rows (those with a length) left
    out: their logits zero."""
    def fault(cfg, params, kpool, vpool, tables, lengths, *a):
        logits, kp, vp = orig(cfg, params, kpool, vpool, tables, lengths,
                              *a)
        n = int((lengths > 0).sum())
        logits = logits.clone()
        logits[n // 2:n] = 0.0
        return logits, kp, vp
    return fault


def _no_exchange(orig):
    """The pool shard's pages never staged into the anchor's region."""
    def fault(kpools, vpools, anchor, *a):
        return kpools[anchor], vpools[anchor]
    return fault


def _altered_token(orig):
    """The first row's logits moved by one token before sampling."""
    def fault(*a):
        logits, kp, vp = orig(*a)
        logits = logits.clone()
        logits[0] = torch.roll(logits[0], 1)
        return logits, kp, vp
    return fault


@pytest.mark.parametrize("module, name, make", [
    ("repro_torch.models.attention", "gqa_prefill_paged", _keep_pools),
    ("repro_torch.models.transformer", "paged_fused_step", _half_batch),
    ("repro_torch.models.transformer", "_pool_exchange_in", _no_exchange),
    ("repro_torch.models.transformer", "sharded_fused_step", _altered_token),
], ids=["state_unchanged", "half_batch", "no_exchange", "altered_token"])
def test_a_broken_step_is_not_correct(monkeypatch, module, name, make):
    mod = sys.modules.get(module) or __import__(module, fromlist=["_"])
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    out = _tiny.run(_tiny.cell())
    assert out["correct"] is False, out["checks"]


def test_the_control_reads_far_above_the_program():
    from bench import control
    cell = _tiny.cell()
    # a sample of 64 served tokens or more: on fewer, the float8
    # reference can put the same token first everywhere
    cell.spec = dict(cell.spec, check=dict(cell.spec["check"], min_tokens=64,
                                           min_requests=4))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rows = control.readings(cell, [5, 6, 7], {5, 6, 7}, 1.5, "cpu")
    finally:
        torch.set_num_threads(threads)
    limit = _tiny.SPEC["check"]["gap_max"]
    assert all(r["tokens"] >= 64 for r in rows)
    assert all(r["program_gap_max"] <= limit for r in rows)
    assert min(r["control_gap_max"] for r in rows) > 3 * max(
        limit, max(r["program_gap_max"] for r in rows))


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from bench.tests import _tiny\n"
            "from bench import harness\n"
            "out = _tiny.run(_tiny.cell(), seconds=0.5)\n"
            "print(harness.forbidden_modules(), out['correct'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"
