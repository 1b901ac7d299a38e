"""The frozen ShareGPT generator: a copy of the port's, repeated by seed,
the same work on every seed."""

import numpy as np

from bench import traffic
from bench.tests import _tiny  # noqa: F401  (puts src/ on the path)

MIX = traffic.load_mix("sharegpt-pair")


def test_lognormal_is_the_ports_draw():
    from repro_torch.sim import workloads
    a = traffic._lognormal_with_mean(np.random.default_rng(7), 310, 0.9, 50)
    b = workloads._lognormal_with_mean(np.random.default_rng(7), 310, 0.9,
                                       50)
    assert np.array_equal(a, b)


def test_sharegpt_spec_is_the_ports():
    from repro_torch.sim.workloads import WORKLOADS
    s, ln = WORKLOADS["sharegpt"], MIX["lengths"]
    assert (ln["in_mean"], ln["in_sigma"], ln["in_max"], ln["out_mean"],
            ln["out_sigma"], ln["out_max"]) == (
        s.in_mean, s.in_sigma, s.in_max, s.out_mean, s.out_sigma, s.out_max)


def test_open_loop_repeats_by_seed():
    a = traffic.open_loop(MIX, 2.0, 40, 2 ** 31 + 5, traffic.WINDOW, 151936)
    b = traffic.open_loop(MIX, 2.0, 40, 2 ** 31 + 5, traffic.WINDOW, 151936)
    assert [(j.arrival, j.prompt, j.max_new) for j in a] == \
        [(j.arrival, j.prompt, j.max_new) for j in b]
    assert all(0 <= t < 151936 for j in a for t in j.prompt)


def test_every_seed_replays_the_same_schedule_with_its_own_tokens():
    runs = [traffic.open_loop(MIX, 2.0, 40, s, traffic.WINDOW, 1000)
            for s in (1, 2)]
    sched = [[(j.arrival, len(j.prompt), j.max_new) for j in r]
             for r in runs]
    assert len(runs[0]) == 80 and sched[0] == sched[1]
    assert [j.prompt for j in runs[0]] != [j.prompt for j in runs[1]]
    # the mix's lengths: lognormal means near 310 and 220, clipped
    ins, outs = traffic.base_lengths(MIX, 4000)
    assert 250 < ins.mean() < 330 and 180 < outs.mean() < 230
    assert ins.max() <= 2048 and outs.max() <= 1024


def test_the_warm_up_stream_is_not_the_windows():
    a = traffic.open_loop(MIX, 2.0, 10, 3, traffic.WINDOW, 1000)
    b = traffic.open_loop(MIX, 2.0, 10, 3, traffic.WARM, 1000)
    assert [j.prompt for j in a] != [j.prompt for j in b]


def test_backlog_cycles_the_pool():
    mix = traffic.load_mix("sharegpt-backlog")
    it = traffic.backlog(mix, 11, traffic.WINDOW, 1000)
    jobs = [next(it) for _ in range(2 * mix["pool"])]
    n = mix["pool"]
    assert [(len(j.prompt), j.max_new) for j in jobs[:n]] == \
        [(len(j.prompt), j.max_new) for j in jobs[n:]]
    assert jobs[0].prompt != jobs[n].prompt
