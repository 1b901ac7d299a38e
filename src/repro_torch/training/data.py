"""Deterministic synthetic token pipeline (training substrate): a copy of
the reference's NumPy-only pipeline, so both packages train on the same
arrays.

Structured synthetic language: token t+1 depends on t through a seeded
permutation mixed with noise, so a model CAN learn it (loss decreases) and
runs are exactly reproducible.  Sharded by (host, num_hosts) the way a real
multi-host input pipeline would shard files; swap ``SyntheticLM`` for a real
tokenized dataset by implementing the same iterator protocol.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.3           # fraction of random next-tokens
    host_id: int = 0
    num_hosts: int = 1


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.num_hosts == 0
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)
        self.step = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given step (restart-safe)."""
        cfg = self.cfg
        local_b = cfg.global_batch // cfg.num_hosts
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id))
        toks = np.empty((local_b, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, local_b)
        noise = rng.random((local_b, cfg.seq_len)) < cfg.noise
        rand_next = rng.integers(0, cfg.vocab_size,
                                 (local_b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand_next[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self.step)
        self.step += 1
        return b
