"""The port's analytic cost model against the reference's: every function
of ``core/costmodel.py`` on a grid of the four paper profiles and the ten
configs' ``profile()``, every device class, tokens / batch / context 1,
64, 256 and 4096 and tp 1, 2 and 4.  Both packages run the same float
arithmetic in the same order, so the values must be EQUAL, not close.
Then the reference's own property checks (tests/test_costmodel.py) run
against the port."""

import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.core import cluster as jcl
from repro.core import costmodel as jcm
from repro_torch.configs import get_config as tget_config
from repro_torch.core import cluster as tcl
from repro_torch.core import costmodel as tcm

SIZES = (1, 64, 256, 4096)
TPS = (1, 2, 4)
CLASSES = sorted(jcl.DEVICE_CLASSES)
PROFILES = sorted(jcm.PAPER_MODELS) + sorted(ARCH_NAMES)


def profiles(name):
    """(reference's, port's) ModelProfile of ``name``."""
    if name in jcm.PAPER_MODELS:
        return jcm.PAPER_MODELS[name], tcm.PAPER_MODELS[name]
    return jget_config(name).profile(), tget_config(name).profile()


def test_constants_and_paper_profiles_equal():
    for name in ("BYTES", "DENSE_EFF", "DENSE_EFF_LARGE_BOOST", "HBM_EFF",
                 "ATTN_VEC_EFF", "ALPHA_INTRA_S", "ALPHA_INTER_S"):
        assert getattr(tcm, name) == getattr(jcm, name), name
    assert sorted(tcm.PAPER_MODELS) == sorted(jcm.PAPER_MODELS)
    for name in ("OPT_2_7B", "LLAMA_13B", "OPT_30B", "LLAMA_70B"):
        assert dataclasses.asdict(getattr(tcm, name)) \
            == dataclasses.asdict(getattr(jcm, name))


@pytest.mark.parametrize("name", PROFILES)
def test_profile_sizes_equal(name):
    jp, tp = profiles(name)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    for attr in ("dtype_bytes", "gqa_ratio"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    for m in ("mlp_mats", "total_params", "total_active_params",
              "kv_bytes_per_token_layer", "kv_bytes_per_token"):
        assert getattr(tp, m)() == getattr(jp, m)(), m
    for i in range(-1, jp.n_layers):
        assert tp.layer_dense_params(i) == jp.layer_dense_params(i)
        assert tp.layer_active_params(i) == jp.layer_active_params(i)


@pytest.mark.parametrize("name", PROFILES)
def test_counts_and_module_times_equal(name):
    jp, tp = profiles(name)
    layers = sorted({-1, 0, jp.first_dense_layers, jp.n_layers - 1})
    for n in SIZES:
        for i in layers:
            assert tcm.dense_flops_layer(tp, n, i) \
                == jcm.dense_flops_layer(jp, n, i)
            assert tcm.dense_weight_bytes_layer(tp, n, i) \
                == jcm.dense_weight_bytes_layer(jp, n, i)
        assert tcm.activation_bytes(tp, n) == jcm.activation_bytes(jp, n)
        for ctx in SIZES:
            for f in ("attn_flops_prefill_layer", "attn_flops_decode_layer",
                      "attn_cache_bytes_decode_layer"):
                assert getattr(tcm, f)(tp, n, ctx) \
                    == getattr(jcm, f)(jp, n, ctx), f
    for cname in CLASSES:
        jc, tc = jcl.DEVICE_CLASSES[cname], tcl.DEVICE_CLASSES[cname]
        for n in SIZES:
            assert tcm._dense_eff(tc, n) == jcm._dense_eff(jc, n)
            assert tcm._roofline_s(tc, 1e9 * n, 1e6 * n, n) \
                == jcm._roofline_s(jc, 1e9 * n, 1e6 * n, n)
            for tp_ in TPS:
                assert tcm.logits_time(tc, tp, n, tp_) \
                    == jcm.logits_time(jc, jp, n, tp_)
                for phase in ("decode", "prefill"):
                    for L in (None, 1):
                        assert tcm.dense_module_time(tc, tp, n, tp_, L,
                                                     phase) \
                            == jcm.dense_module_time(jc, jp, n, tp_, L,
                                                     phase)
                        for ctx in SIZES:
                            assert tcm.attn_module_time(tc, tp, n, ctx, tp_,
                                                        L, phase) \
                                == jcm.attn_module_time(jc, jp, n, ctx, tp_,
                                                        L, phase)


def test_calibrate_efficiency_equal():
    for prev in (0.02, 0.5, 1.0):
        for a in (0.0, 1e-4, 3e-3):
            for m in (0.0, 1e-5, 2e-3, 1.0):
                for alpha in (0.25, 0.9):
                    assert tcm.calibrate_efficiency(prev, a, m, alpha) \
                        == jcm.calibrate_efficiency(prev, a, m, alpha)


def stage_grid(pkg_cl, pkg_cm):
    """Stages over the paper testbed's device sets: each class at tp 1, 2
    and 4, and two and three-stage chains, in the given package."""
    cl = pkg_cl.ClusterSpec.paper_testbed()
    by = cl.by_class()
    chains = []
    for cname in ("A100", "3090", "P100"):
        for tp_ in TPS:
            chains.append([pkg_cm.StageConfig(tuple(by[cname][:tp_]), 10)])
    chains.append([pkg_cm.StageConfig(tuple(by["A100"]), 30),
                   pkg_cm.StageConfig(tuple(by["3090"]), 10)])
    chains.append([pkg_cm.StageConfig(tuple(by["A100"][:2]), 20),
                   pkg_cm.StageConfig(tuple(by["3090"][1:3]), 12),
                   pkg_cm.StageConfig((by["P100"][0],), 8)])
    return cl, chains


@pytest.mark.parametrize("name", PROFILES)
def test_link_stage_and_pipeline_times_equal(name):
    jp, tp = profiles(name)
    jc, jchains = stage_grid(jcl, jcm)
    tc, tchains = stage_grid(tcl, tcm)
    jd, td = jc.devices, tc.devices
    for nbytes in (0.0, 1.0, 1e6, 4096.0 * 5120):
        for ids in ((0,), (0, 1), (0, 1, 2, 3), (3, 4), (4, 5, 6, 7),
                    (0, 4, 8), tuple(range(12))):
            assert tcm.allreduce_time([td[i] for i in ids], nbytes, tc) \
                == jcm.allreduce_time([jd[i] for i in ids], nbytes, jc)
        for a, b in ((0, 0), (0, 1), (0, 4), (4, 5), (5, 6), (7, 8)):
            assert tcm.p2p_time(td[a], td[b], nbytes, tc) \
                == jcm.p2p_time(jd[a], jd[b], nbytes, jc)
    for js, ts in zip(jchains, tchains):
        assert [s.tp for s in ts] == [s.tp for s in js]
        assert [s.cls.name for s in ts] == [s.cls.name for s in js]
        for batch in SIZES:
            for ctx in SIZES:
                for phase, tpr in (("decode", 1.0), ("prefill", ctx)):
                    assert tcm.stage_time(ts[0], tp, tc, batch, tpr, ctx,
                                          phase) \
                        == jcm.stage_time(js[0], jp, jc, batch, tpr, ctx,
                                          phase)
                    for logits in (True, False):
                        assert tcm.pipeline_iteration_time(
                            ts, tp, tc, batch, tpr, ctx, phase, logits) \
                            == jcm.pipeline_iteration_time(
                                js, jp, jc, batch, tpr, ctx, phase, logits)


# ---- the reference's property checks (tests/test_costmodel.py) ---------
def prefill_gap_ordering(cm, cl):
    times = {c: cm.dense_module_time(cl.DEVICE_CLASSES[c], cm.OPT_2_7B,
                                     tokens=1536, phase="prefill")
             for c in ("A100", "3090", "P100")}
    assert times["A100"] < times["3090"] < times["P100"]
    assert times["P100"] / times["A100"] > 10.0


def decode_gap_smaller_than_prefill_gap(cm, cl):
    def gap(phase, tokens):
        return (cm.dense_module_time(cl.DEVICE_CLASSES["P100"], cm.OPT_2_7B,
                                     tokens, phase=phase)
                / cm.dense_module_time(cl.DEVICE_CLASSES["A100"],
                                       cm.OPT_2_7B, tokens, phase=phase))
    assert gap("decode", 25) < gap("prefill", 1536)


def attention_gap_narrower_than_mlp_gap(cm, cl):
    a, p = cl.DEVICE_CLASSES["A100"], cl.DEVICE_CLASSES["P100"]
    mlp_gap = (cm.dense_module_time(p, cm.LLAMA_70B, 25, n_layers=1)
               / cm.dense_module_time(a, cm.LLAMA_70B, 25, n_layers=1))
    attn_gap = (cm.attn_module_time(p, cm.LLAMA_70B, 25, 1000, n_layers=1)
                / cm.attn_module_time(a, cm.LLAMA_70B, 25, 1000, n_layers=1))
    assert mlp_gap > 5 * attn_gap
    assert mlp_gap > 20.0


def comm_models(cm, cl):
    c = cl.ClusterSpec.paper_testbed()
    devs = c.devices
    assert cm.allreduce_time(devs[:4], 1e6, c) \
        > cm.allreduce_time(devs[:2], 1e6, c) > 0
    assert cm.p2p_time(devs[0], devs[0], 1e9, c) == 0.0
    assert cm.p2p_time(devs[0], devs[4], 1e6, c) \
        > cm.p2p_time(devs[0], devs[1], 1e6, c) * 0.5


def pipeline_time_monotone_in_batch(cm, cl):
    c = cl.ClusterSpec.paper_testbed()
    stages = [cm.StageConfig(tuple(c.by_class()["A100"]),
                             cm.LLAMA_70B.n_layers)]
    assert cm.pipeline_iteration_time(stages, cm.LLAMA_70B, c, 64, 1.0, 512,
                                      "decode") \
        >= cm.pipeline_iteration_time(stages, cm.LLAMA_70B, c, 8, 1.0, 512,
                                      "decode")


def kv_bytes(cm, cl):
    assert cm.LLAMA_70B.kv_bytes_per_token_layer() == 4096
    assert cm.LLAMA_70B.gqa_ratio == 8


CHECKS = {f.__name__: f for f in (
    prefill_gap_ordering, decode_gap_smaller_than_prefill_gap,
    attention_gap_narrower_than_mlp_gap, comm_models,
    pipeline_time_monotone_in_batch, kv_bytes)}


@pytest.mark.parametrize("check", sorted(CHECKS))
def test_reference_property_holds_in_the_port(check):
    CHECKS[check](tcm, tcl)
