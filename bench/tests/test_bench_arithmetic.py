"""The yardstick's arithmetic: percentiles with censored requests, window
rates, the frozen B1 bound, and the FLOP count of the MFU."""

import json
import types

import pytest

from bench import roofline, stats
from bench.harness import ROOT, reader
from bench.tests import _tiny  # noqa: F401


def window(**kw):
    base = dict(t0=10.0, close=20.0, due=[], gaps=[], tokens=0, steps=[],
                spans=[], counters={}, device=None, traced_steps=[],
                setup_s=1.0)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_censored_wait_enters_at_the_close():
    assert stats.censored(12.5, 12.0, 20.0) == 0.5
    assert stats.censored(None, 15.0, 20.0) == 5.0
    assert stats.censored(25.0, 15.0, 20.0) == 5.0


def test_ttft_p50_counts_the_requests_still_waiting():
    due = [(11.0 + i, 11.1 + i) for i in range(3)] + [(12.0, None),
                                                      (19.0, None),
                                                      (13.0, 13.3)]
    # waits: three of 0.1 s, 8 s, 1 s and 0.3 s: the median is 0.2 s;
    # with the waiting ones left out it would be 0.1 s
    assert reader("ttft_p50_ms").read(window(due=due)) == \
        pytest.approx(200.0)


def test_itl_p99_and_the_token_rate():
    gaps = [(11.0 + i * 0.01, 0.05) for i in range(99)] + [(19.0, 0.5)]
    w = window(gaps=gaps, tokens=400)
    # numpy's linear 99th percentile of 99 x 0.05 and 0.5
    assert reader("itl_p99_ms").read(w) == pytest.approx(
        1e3 * (0.05 + 0.01 * 0.45))
    assert reader("out_tok_s").read(w) == pytest.approx(40.0)


def test_b1_bound_at_one_case():
    # two live rows (a decode row at 100 keys, a 3-token chunk from 16)
    # and one padded row; Hkv 2, C 4, r 2, dh 64, pages of 16, bf16
    t, by, nbytes, flops = roofline.b1_bound(3, 2, 4, 2, 64, 16,
                                             [100, 19], [99, 16], "bfloat16")
    out = 3 * 2 * 4 * 2 * 64 * 2
    q = 2 * 2 * 4 * 2 * 64 * 2
    kv = 119 * 2 * 64 * 2 * 2
    tables = (7 + 2) * 2 * 4
    assert nbytes == out + q + kv + tables + 2 * 3 * 4
    # visible keys: the decode row 4 x 100; the chunk 17, 18, 19, 19
    assert flops == 4.0 * 64 * (400 + 73) * 2 * 2
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_b1_bound_is_chip_smokes():
    import torch
    import chip_smoke
    rows = [(99, 1), (16, 3), (0, 0)]
    args = chip_smoke.make_rows("cpu", torch.bfloat16, rows, 4, Hkv=2, r=2,
                                dh=64, page=16, max_pages=8)
    want = chip_smoke.bound(args, "bfloat16")
    got = roofline.b1_bound(3, 2, 4, 2, 64, 16, [100, 19], [99, 16],
                            "bfloat16")
    assert got[1:] == (want[1], want[2], want[3])
    assert got[0] * 1e3 == pytest.approx(want[0])


@pytest.mark.parametrize("name, params", [("qwen3-14b", 14.76788224e9),
                                          ("dbrx-132b-8l", 27.305705472e9)])
def test_parameter_counts(name, params):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    assert roofline.model_params(cfg) == params


def test_mfu_flops_of_one_token():
    cfg = json.loads((ROOT / "bench" / "configs" / "qwen3-14b.json")
                     .read_text())
    p = roofline.layer_params(cfg)
    # a dense model's token goes through every layer weight
    assert 40 * (p["attention"] + p["ffn_active"]) + 2 * p["lm_head"] == \
        roofline.model_params(cfg)
    one = roofline.row_flops(cfg, 0, 1, True)
    assert one == 2 * roofline.model_params(cfg) - 2 * p["lm_head"] \
        + 40 * 4 * 128 * 40
    # dbrx: attention, the router and four of sixteen experts a token
    cfg = json.loads((ROOT / "bench" / "configs" / "dbrx-132b-8l.json")
                     .read_text())
    p = roofline.layer_params(cfg)
    assert p["ffn_active"] == 4 * 3 * 6144 * 10752 + 6144 * 16
    assert roofline.row_flops(cfg, 10, 2, False) == 8 * (
        2 * 2 * (p["attention"] + p["ffn_active"]) + 4 * 128 * 48 * 23)
