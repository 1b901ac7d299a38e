"""The port's per-module probe (``EngineConfig(telemetry=True,
trace_modules=True)``) and its measured calibration loop against the JAX
package's on the CPU, at reduced size (2 layers, narrow widths; weights
from the reference through the bridge): the tokens, the span structure,
and — fed the same scripted module durations and upload times — every
value the loop derives from them.  Then the profiler's fits and
``profile_attention``, the Chrome-trace validator and its CLI, and the
serve CLI's ``--trace-modules``.  Durations measured by the two packages
are never compared with each other: they time two frameworks."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serving.engine as jengine
import repro_torch.serving.engine as tengine
from _torch_engine_pair import (HOSTS, assert_same, engine_pair,
                                submit_requests)
from repro.configs import get_config as jget_config
from repro.core import profiler as jprof
from repro.models import transformer as JT
from repro.telemetry import Tracer as JTracer
from repro.telemetry import export as jexport
from repro_torch.configs import get_config
from repro_torch.core import profiler as tprof
from repro_torch.core.cluster import ClusterSpec as TCluster
from repro_torch.serving import EngineConfig as TEngineConfig
from repro_torch.serving import InferenceEngine as TEngine
from repro_torch.telemetry import Tracer as TTracer
from repro_torch.telemetry import export as texport
from repro_torch.weights import from_jax_params

SRC = Path(__file__).resolve().parents[1] / "src"
# one compiled call, not one per eager op
jax_init_params = jax.jit(JT.init_params, static_argnums=0)

# 4 requests of 10-27 prompt tokens, 5 new tokens each: every prompt fits
# one 32-token chunk and the token budget takes them all in the first
# step, so each call kind meets one or two bucket shapes (the reference's
# eager probe compiles every operation once per shape)
ECFG = dict(max_batch=8, max_seq=64, page_size=16, prefill_chunk=32,
            token_budget=128, telemetry=True, trace_modules=True)
CASES = {"qwen3 fused": ("qwen3-14b", "fused"),
         "qwen3 split": ("qwen3-14b", "split"),
         "dbrx fused": ("dbrx-132b", "fused")}
N_REQ, NEW = 4, 5


class FakeClock:
    """``time`` stand-in for both engine modules: every ``perf_counter``
    reading is one second after the last, so each timed upload takes
    exactly 1 s in both packages."""

    def __init__(self):
        self.n = 0

    def perf_counter(self):
        self.n += 1
        return float(self.n)


def script_probe(eng):
    """Replace ``eng._probe_totals`` by a script: the k-th reading adds
    1e-4 * (1 + k % 7) s of attention and 4e-3 * (1 + k % 3) s of dense
    modules to the running totals, so both packages' probes measure the
    same module durations call by call."""
    k, tot = [0], [0.0, 0.0]

    def totals():
        k[0] += 1
        tot[0] += 1e-4 * (1 + k[0] % 7)
        tot[1] += 4e-3 * (1 + k[0] % 3)
        return tot[0], tot[1]
    eng._probe_totals = totals


def loop_state(eng):
    """Every value the measured calibration loop derives, flattened."""
    snap = eng.snapshot()
    link = eng.hauler.link(0, 1)
    out = {k: v for k, v in snap.items()
           if k.startswith(("attn/device/", "xfer/", "attn_module_s/",
                            "dense_module_s/"))}
    out.update({f"calib/{w.device_id}": w.calib for w in eng.workers})
    out.update(dense_eff=eng._dense_eff, link_gamma=link.gamma,
               link_beta=link.beta, clock=eng.clock,
               redispatches=eng.metrics["redispatches"],
               migrated_bytes=eng.metrics["migrated_bytes"])
    return out


def meter_uploads(eng):
    """Record the bytes of each paged call's upload past its six
    staging-exchange arrays (the lanes follow the placement)."""
    sizes, upload = [], eng._upload

    def metered(host, nbytes=0):
        sizes.append(sum(a.nbytes for a in host[6:]))
        return upload(host, nbytes)
    eng._upload = metered
    return sizes


def span_rows(tracer):
    """(name, depth, track, args, parent name) of every recorded span, in
    recording order; a main-track span's parent is the first span of one
    depth less recorded after it (spans are recorded when they close)."""
    spans = list(tracer.spans())
    rows = []
    for i, sp in enumerate(spans):
        parent = None
        if sp.track == "main" and sp.depth > 0:
            parent = next(p.name for p in spans[i + 1:]
                          if p.track == "main" and p.depth == sp.depth - 1)
        rows.append((sp.name, sp.depth, sp.track, sp.args, parent))
    return rows


@pytest.fixture(scope="module", params=sorted(CASES))
def served(request):
    """One case served three ways: the reference's engine and the port's
    with the probe, in lockstep, both fed the scripted durations and the
    fake clock; and the port's without the probe.  Returns the engines
    and the loop state of the probed pair after every step."""
    name, mode = CASES[request.param]
    jcfg = jget_config(name).reduced(vocab_size=128)
    tcfg = get_config(name).reduced(vocab_size=128)
    params = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(0)))
    ecfg = dict(ECFG, step_mode=mode)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "time", FakeClock())
        mp.setattr(tengine, "time", FakeClock())
        j, t = engine_pair(jcfg, tcfg, params, ecfg)
        script_probe(j)
        script_probe(t)
        t_sizes = meter_uploads(t)
        submit_requests((j, t), tcfg.vocab_size, N_REQ, 10, 28, NEW,
                        seed=11)
        states = []
        for _ in range(50):
            if not (j.queue or j.running or j.prefilling):
                break
            j.step()
            t.step()
            assert_same(j, t)
            states.append((loop_state(j), loop_state(t)))
    u = TEngine(tcfg, from_jax_params(tcfg, params, device="cpu"),
                TCluster.build(HOSTS), primary_ids=[0], pool_ids=[1],
                engine_cfg=TEngineConfig(**dict(ecfg, telemetry=False,
                                                trace_modules=False)),
                device="cpu")
    u_sizes = meter_uploads(u)
    submit_requests((u,), tcfg.vocab_size, N_REQ, 10, 28, NEW, seed=11)
    assert u.run_until_drained(50)
    return dict(j=j, t=t, u=u, states=states, cfg=tcfg, mode=mode,
                sizes=(t_sizes, u_sizes))


# ----------------------------------------------------------- (a) tokens
def test_probe_emits_the_untraced_and_reference_tokens(served):
    j, t, u = served["j"], served["t"], served["u"]
    assert t._trace_modules and not u._trace_modules
    tokens = {r.rid: r.output for r in t.finished}
    assert len(tokens) == N_REQ
    assert all(len(v) == NEW for v in tokens.values())
    assert tokens == {r.rid: r.output for r in j.finished}
    assert tokens == {r.rid: r.output for r in u.finished}
    for k in ("d2h_bytes", "model_calls", "steps"):
        assert t.metrics[k] == j.metrics[k] == u.metrics[k], k
    assert t.metrics["h2d_bytes"] == j.metrics["h2d_bytes"]
    # without the probe the same calls upload the same operands; only the
    # staging lanes may differ, because the probe's calibration moves
    # heads (its first measurement lands on the one loaded device)
    t_sizes, u_sizes = served["sizes"]
    assert t_sizes == u_sizes and len(t_sizes) == t.metrics["model_calls"]
    t.kv.check_invariants()


# --------------------------------------------------- (b) span structure
def reference_rows(served):
    """(the port's span rows less its own leaf spans, the reference's
    less its ``fused/<phase>`` spans, the port's extra span names): the
    port records the reference's spans and beside them leaf spans that
    never enclose one of the reference's (``tengine.HOST_SPANS``; under
    the probe no call is captured, so no ``graph/*``), and drops the
    reference's token-share split of the fused call."""
    t_rows = span_rows(served["t"].tracer)
    j_rows = span_rows(served["j"].tracer)
    extra = {r[0] for r in t_rows} - {r[0] for r in j_rows}
    return ([r for r in t_rows if r[0] not in extra],
            [r for r in j_rows if not r[0].startswith("fused/")], extra)


def test_probe_span_structure_matches_the_reference(served):
    j, t = served["j"], served["t"]
    rows, j_rows, extra = reference_rows(served)
    assert rows == j_rows
    assert extra == set(tengine.HOST_SPANS) - {"graph/replay",
                                                "graph/capture"}
    # the reference's fused/<phase> spans are gone from the port
    dropped = {r[0] for r in span_rows(j.tracer)} - {r[0] for r in rows}
    assert dropped == ({"fused/decode", "fused/prefill"}
                       if served["mode"] == "fused" else set())
    cfg = t.cfg
    calls = t.metrics["model_calls"]
    for name, per_call in (("embed", 1), ("lm_head", 1),
                           ("attention", cfg.n_layers),
                           ("mlp", cfg.n_layers)):
        assert t.tracer.count(name) == j.tracer.count(name) \
            == per_call * calls, name
    calls = ({"fused_step"} if served["mode"] == "fused"
             else {"prefill_chunk", "paged_decode"})
    for name, _depth, track, args, parent in rows:
        if name in ("embed", "attention", "mlp", "lm_head"):
            assert track == "main" and parent in calls, (name, parent)
        if name == "attention":
            assert set(args) == {"heads", "cache_bytes"}
    assert [r for r in rows if r[2] == "sim"]
    assert {r[0] for r in rows if r[2] == "sim"} \
        == {"attention_model", "dense_model"}
    # the profiler fits tau(h, g) from the port's own live spans
    model, r2 = tprof.fit_attention_model_from_tracer(t.tracer)
    assert np.isfinite([model.a, model.b, model.c, r2]).all()


# ------------------------------------------- (c) lockstep calibration
def test_calibration_loop_in_lockstep_with_the_reference(served):
    j, t = served["j"], served["t"]
    for step, (sj, st) in enumerate(served["states"]):
        assert sorted(st) == sorted(sj), step
        assert st == pytest.approx(sj, rel=1e-12), step
    final = served["states"][-1][1]
    # the loop ran: both devices measured, calibration moved off the
    # analytic prior, the hauler follows the measured link, and a
    # redispatch happened under the measured snapshot
    assert t._measured_attn and j._measured_attn
    assert {"attn/device/0", "attn/device/1"} <= set(final)
    assert any(final[f"calib/{d}"] != 1.0 for d in (0, 1))
    assert final["dense_eff"] != 0.5
    assert final["xfer/h2d_gbps"] > 0.0
    assert final["link_gamma"] == pytest.approx(
        1.0 / (final["xfer/h2d_gbps"] * 1e9))
    assert final["redispatches"] > 0


def test_probe_needs_telemetry_as_in_the_reference():
    cfg = get_config("qwen3-14b").reduced(vocab_size=128)
    jcfg = jget_config("qwen3-14b").reduced(vocab_size=128)
    params = jax.tree.map(np.asarray,
                          jax_init_params(jcfg, jax.random.PRNGKey(0)))
    j, t = engine_pair(jcfg, cfg, params, dict(trace_modules=True))
    assert not t._trace_modules and not j._trace_modules
    assert not t.tracer.enabled


# ---------------------------------------------------------------- (d) fits
def samples(n, seed, noise=1e-6):
    rng = np.random.default_rng(seed)
    h = rng.integers(1, 96, n).astype(float)
    g = rng.uniform(1e5, 5e8, n)
    tau = 2e-6 * h + 3e-12 * g + 1e-5 + rng.normal(0.0, noise, n)
    return [(float(a), float(b), float(c)) for a, b, c in zip(h, g, tau)]


@pytest.mark.parametrize("n, noise", [(3, 1e-6), (5, 1e-6), (64, 1e-6),
                                      (64, 0.0), (64, 1e-3)])
def test_fit_attention_model_matches_the_reference(n, noise):
    s = samples(n, seed=n, noise=noise)
    (tm, tr2), (jm, jr2) = tprof.fit_attention_model(s), \
        jprof.fit_attention_model(s)
    assert [tm.a, tm.b, tm.c, tr2] == pytest.approx([jm.a, jm.b, jm.c, jr2],
                                                    rel=1e-9)


@pytest.mark.parametrize("n", [2, 8, 64])
def test_fit_transfer_model_matches_the_reference(n):
    rng = np.random.default_rng(n)
    d = rng.uniform(1e3, 1e9, n)
    s = [(float(x), float(4e-11 * x + 2e-5 + rng.normal(0, 1e-6)))
         for x in d]
    (tm, tr2), (jm, jr2) = tprof.fit_transfer_model(s), \
        jprof.fit_transfer_model(s)
    assert [tm.gamma, tm.beta, tr2] == pytest.approx(
        [jm.gamma, jm.beta, jr2], rel=1e-9)


@pytest.mark.parametrize("n_heads", [0, 2, 3, 12])
def test_attention_samples_from_tracer_match_the_reference(n_heads):
    """Spans with (h, g) args, without args, with args but no heads, with
    heads but no cache_bytes, and spans of another name: the same samples,
    and no fit below 3 of them."""
    tracers = JTracer(enabled=True), TTracer(enabled=True)
    s = samples(max(n_heads, 1), seed=7)
    for tr in tracers:
        tr.add_span("attention", 0.0, 1e-3)
        tr.add_span("attention", 1.0, 2e-3, args={"cache_bytes": 5.0})
        tr.add_span("mlp", 2.0, 3e-3, args={"heads": 4.0})
        for i, (h, g, tau) in enumerate(s[:n_heads]):
            args = {"heads": h} if i == 1 else {"heads": h,
                                                "cache_bytes": g}
            tr.add_span("attention", 3.0 + i, tau, args=args)
    got, want = (tprof.attention_samples_from_tracer(tracers[1]),
                 jprof.attention_samples_from_tracer(tracers[0]))
    assert got == want and len(got) == n_heads
    tfit, jfit = (tprof.fit_attention_model_from_tracer(tracers[1]),
                  jprof.fit_attention_model_from_tracer(tracers[0]))
    if n_heads < 3:
        assert tfit is None and jfit is None
    else:
        (tm, tr2), (jm, jr2) = tfit, jfit
        assert [tm.a, tm.b, tm.c, tr2] == pytest.approx(
            [jm.a, jm.b, jm.c, jr2], rel=1e-9)


@pytest.mark.parametrize("seed", [None, 5])
def test_perturbed_models_match_the_reference(seed):
    rng = (lambda: None) if seed is None else \
        (lambda: np.random.default_rng(seed))
    ta, ja = (tprof.AttentionModel(1e-6, 2e-12, 3e-5).perturbed(0.2, rng()),
              jprof.AttentionModel(1e-6, 2e-12, 3e-5).perturbed(0.2, rng()))
    assert (ta.a, ta.b, ta.c) == (ja.a, ja.b, ja.c)
    tt, jt = (tprof.TransferModel(1e-10, 3e-5).perturbed(0.2, rng()),
              jprof.TransferModel(1e-10, 3e-5).perturbed(0.2, rng()))
    assert (tt.gamma, tt.beta) == (jt.gamma, jt.beta)


# ------------------------------------------------- (e) profile_attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_attention_grid_matches_the_reference(dtype):
    grid = dict(head_dim=16, head_grid=(1, 3), ctx_grid=(16, 48), batch=2,
                repeats=1)
    got = tprof.profile_attention(**grid, dtype=getattr(torch, dtype),
                                  device="cpu")
    want = jprof.profile_attention(**grid,
                                   dtype=getattr(jax.numpy, dtype))
    assert [s[:2] for s in got] == [s[:2] for s in want]
    assert [s[:2] for s in got] == [
        (2.0 * h, 2.0 * 2 * h * c * 16 * (4 if dtype == "float32" else 2))
        for h in (1, 3) for c in (16, 48)]
    assert all(s[2] > 0.0 for s in got)


def test_profile_attention_runs_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tprof.profile_attention(head_grid=(1,), ctx_grid=(16,))


# ------------------------------------------------------- (f) validator
EV = {"name": "a", "ph": "X", "ts": 0, "dur": 1.5, "pid": 1, "tid": 0}
META = {"name": "process_name", "ph": "M", "ts": 0, "pid": 1, "tid": 0}
TRACES = {
    "good": {"traceEvents": [EV]},
    "good with metadata": {"traceEvents": [META, EV, dict(EV, ts=2)]},
    "not an object": [EV],
    "no traceEvents": {},
    "empty": {"traceEvents": []},
    "events not a list": {"traceEvents": {"a": EV}},
    "event not an object": {"traceEvents": [EV, 3]},
    "missing pid": {"traceEvents": [{k: v for k, v in EV.items()
                                     if k != "pid"}]},
    "name not a string": {"traceEvents": [dict(EV, name=1)]},
    "ts not a number": {"traceEvents": [dict(EV, ts="0")]},
    "negative dur": {"traceEvents": [dict(EV, dur=-1)]},
    "X without dur": {"traceEvents": [{k: v for k, v in EV.items()
                                       if k != "dur"}]},
    "metadata only": {"traceEvents": [META]},
}


def verdict(validate, obj):
    try:
        return "ok", validate(obj)
    except ValueError as e:
        return "invalid", str(e)


@pytest.mark.parametrize("case", sorted(TRACES))
def test_validator_verdicts_match_the_reference(case):
    got = verdict(texport.validate_chrome_trace, TRACES[case])
    assert got == verdict(jexport.validate_chrome_trace, TRACES[case])
    assert got[0] == ("ok" if case.startswith("good") else "invalid")


FILES = {"good": json.dumps(TRACES["good"]),
         "invalid schema": json.dumps(TRACES["empty"]),
         "not json": "{traceEvents: ",
         "missing": None}


@pytest.mark.parametrize("case", sorted(FILES) + ["no argument",
                                                  "two arguments"])
def test_validator_cli_exit_codes_match_the_reference(case, tmp_path,
                                                      capsys):
    path = tmp_path / "trace.json"
    if FILES.get(case) is not None:
        path.write_text(FILES[case])
    argv = {"no argument": [], "two arguments": [str(path)] * 2}.get(
        case, [str(path)])
    rc = texport.main(argv)
    out = capsys.readouterr()
    assert rc == jexport.main(argv)
    jout = capsys.readouterr()
    assert rc == {"good": 0, "no argument": 2, "two arguments": 2}.get(
        case, 1)
    assert out.out == jout.out
    assert out.err.split(":")[0] == jout.err.split(":")[0]


def test_engine_trace_validates(served, tmp_path):
    """The port engine's exported Chrome trace passes both validators,
    with the reference's event count for the same spans: the reference's
    less its ``fused/<phase>`` spans, plus the port's own leaf spans."""
    path = tmp_path / "trace.json"
    t, j = served["t"].tracer, served["j"].tracer
    n = t.write_chrome(str(path))
    _, _, extra = reference_rows(served)
    assert n == (len(j.export_chrome()["traceEvents"])
                 - j.count("fused/decode") - j.count("fused/prefill")
                 + sum(t.count(name) for name in extra))
    spans = texport.validate_file(str(path))
    assert spans == jexport.validate_file(str(path)) == len(
        served["t"].tracer)


# ----------------------------------------------------------- (g) serve CLI
def test_serve_cli_traces_modules_on_the_cpu(tmp_path):
    path = tmp_path / "serve.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--requests", "3", "--max-new-tokens", "4",
         "--trace-modules", "--trace-out", str(path)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 3 requests" in out.stdout
    assert texport.main([str(path)]) == 0
    events = json.loads(path.read_text())["traceEvents"]
    attn = [e for e in events if e["name"] == "attention"]
    assert attn and all({"heads", "cache_bytes"} <= set(e["args"])
                        for e in attn)
    assert {"embed", "mlp", "lm_head"} <= {e["name"] for e in events}
