"""Requests from a traffic mix (``bench/traffic/<mix>.json``) and a seed.

The lengths are a frozen copy of the ShareGPT stand-in of
``repro_torch/sim/workloads.py`` (``make_trace`` and its ``"sharegpt"``
spec): lognormal prompt and output lengths with the given means and
sigmas, clipped.  Poisson arrivals have exponential gaps.

So that every seed gets the same work, the lengths and the gaps are drawn
once from the mix's ``base_seed``, in a fixed order: every run replays
the same schedule of sizes and arrivals, and the run's seed draws the
token ids, uniformly from the vocabulary.  A mix's
``arrivals`` is ``"poisson"`` (an open loop at the cell's rate) or
``"backlog"`` (a closed queue refilled as requests finish).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional

import numpy as np

MIXES = Path(__file__).resolve().parent / "traffic"
# a stream is the window's requests (0) or the warm-up's (1): the same
# seed never gives both the same requests
WINDOW, WARM = 0, 1


@dataclasses.dataclass
class Job:
    index: int
    arrival: Optional[float]     # seconds after the stream's start; None in
    prompt: List[int]            # a backlog
    max_new: int


def load_mix(name: str) -> Dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def _lognormal_with_mean(rng, mean: float, sigma: float, n: int
                         ) -> np.ndarray:
    mu = np.log(mean) - sigma ** 2 / 2.0
    return rng.lognormal(mu, sigma, n)


def base_lengths(mix: Dict, n: int):
    """(prompt lengths, output lengths) of ``n`` requests, from the mix's
    base seed alone: the clipped lognormals of ``make_trace``."""
    ln = mix["lengths"]
    rng = np.random.default_rng(mix["base_seed"])
    ins = np.clip(_lognormal_with_mean(rng, ln["in_mean"], ln["in_sigma"], n),
                  ln["in_min"], ln["in_max"]).astype(int)
    outs = np.clip(_lognormal_with_mean(rng, ln["out_mean"], ln["out_sigma"],
                                        n), ln["out_min"],
                   ln["out_max"]).astype(int)
    return ins, outs


def base_gaps(mix: Dict, n: int, rate: float) -> np.ndarray:
    """Gaps between ``n`` Poisson arrivals at ``rate`` a second, from the
    mix's base seed alone (a stream of its own beside the lengths')."""
    rng = np.random.default_rng([mix["base_seed"], 1])
    return rng.exponential(1.0 / rate, n)


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2 ** 64 - 1), stream])


def open_loop(mix: Dict, rate: float, seconds: float, seed: int,
              stream: int, vocab: int) -> List[Job]:
    """The requests due in ``seconds`` at ``rate`` a second: the base
    draw of ``round(rate * seconds)`` lengths and gaps, the same on every
    seed; the seed's stream draws their tokens."""
    n = max(1, int(round(rate * seconds)))
    ins, outs = base_lengths(mix, n)
    arrivals = np.cumsum(base_gaps(mix, n, rate))
    rng = _rng(seed, stream)
    return [Job(i, float(arrivals[i]),
                rng.integers(0, vocab, int(ins[i])).tolist(), int(outs[i]))
            for i in range(n)]


def backlog(mix: Dict, seed: int, stream: int, vocab: int) -> Iterator[Job]:
    """An endless queue: the mix's ``pool`` base lengths, over and over in
    the same order; the seed's stream draws their tokens."""
    n = int(mix["pool"])
    ins, outs = base_lengths(mix, n)
    rng = _rng(seed, stream)
    i = 0
    while True:
        for j in range(n):
            yield Job(i, None, rng.integers(0, vocab, int(ins[j])).tolist(),
                      int(outs[j]))
            i += 1
