"""Hauler: head-granular KV-cache migration planning (paper §6, §5.3).

Responsibilities:

  * compute the minimal migration plan between two head placements of a
    request — heads that stay on the same device are *reused*, only the
    difference moves (paper: "partial cache transmission" via head overlap);
  * schedule migrations into the dense-compute window so they never contend
    with the inference-critical collectives (the paper uses low-priority CUDA
    streams; on TPU we model the same effect by budgeting migration bytes
    into compute-overlap slots).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.profiler import TransferModel


@dataclasses.dataclass
class MigrationTask:
    rid: int
    src_device: int
    dst_device: int
    heads: int
    nbytes: float
    done_bytes: float = 0.0

    @property
    def remaining(self) -> float:
        return max(0.0, self.nbytes - self.done_bytes)


def plan_migration(rid: int, old: Dict[int, int], new: Dict[int, int],
                   kv_bytes_per_head: float) -> List[MigrationTask]:
    """Head-overlap-aware diff between placements.

    Devices keep ``min(old, new)`` heads in place; surplus heads on shrinking
    devices are matched to deficits on growing devices (greedy, largest
    first) so the number of P2P transfers is minimal.
    """
    surplus: List[Tuple[int, int]] = []   # (device, heads to give away)
    deficit: List[Tuple[int, int]] = []   # (device, heads needed)
    for dev in set(old) | set(new):
        o, n = old.get(dev, 0), new.get(dev, 0)
        if o > n:
            surplus.append((dev, o - n))
        elif n > o:
            deficit.append((dev, n - o))
    surplus.sort(key=lambda t: -t[1])
    deficit.sort(key=lambda t: -t[1])

    tasks: List[MigrationTask] = []
    si = 0
    for dst, need in deficit:
        while need > 0 and si < len(surplus):
            src, have = surplus[si]
            take = min(need, have)
            tasks.append(MigrationTask(rid, src, dst, take,
                                       take * kv_bytes_per_head))
            need -= take
            have -= take
            if have == 0:
                si += 1
            else:
                surplus[si] = (src, have)
    return tasks


def migration_bytes(tasks: Sequence[MigrationTask]) -> float:
    return sum(t.nbytes for t in tasks)


class MigrationScheduler:
    """Budgeted, interference-free migration.

    Each engine step exposes an *overlap window* — the dense-module compute
    time during which the interconnect is otherwise idle for these links.
    Migrations consume window bandwidth; unfinished tasks carry over.  This
    is the TPU-schedule analogue of the paper's low-priority streams.
    """

    XFER_SNAPSHOT_KEY = "xfer/h2d_gbps"

    def __init__(self, links: Dict[Tuple[int, int], TransferModel]):
        self._links = links
        self._queue: List[MigrationTask] = []
        # measured fallback link model from the telemetry snapshot; None
        # until calibrate_from_snapshot sees a measured bandwidth gauge
        self._measured_default: Optional[TransferModel] = None

    def submit(self, tasks: Sequence[MigrationTask]) -> None:
        self._queue.extend(tasks)

    @property
    def pending(self) -> List[MigrationTask]:
        return list(self._queue)

    def calibrate_from_snapshot(self, snapshot: Dict[str, float]) -> None:
        """Adopt the engine's *measured* host<->device bandwidth (EWMA
        gauge ``xfer/h2d_gbps``) as the default link model, so migration
        window budgeting reflects the observed interconnect rather than
        the 10 GB/s analytic default."""
        gbps = snapshot.get(self.XFER_SNAPSHOT_KEY, 0.0)
        if gbps and gbps > 0.0:
            self._measured_default = TransferModel(gamma=1.0 / (gbps * 1e9),
                                                   beta=30e-6)

    def link(self, src: int, dst: int) -> TransferModel:
        tm = self._links.get((src, dst)) or self._links.get((dst, src))
        return tm or self._measured_default \
            or TransferModel(gamma=1.0 / 10e9, beta=30e-6)

    def advance(self, window_s: float) -> List[MigrationTask]:
        """Run migrations inside an overlap window of ``window_s`` seconds.
        Returns the tasks completed during this window."""
        done: List[MigrationTask] = []
        remaining_s = window_s
        q: List[MigrationTask] = []
        for t in self._queue:
            if remaining_s <= 0:
                q.append(t)
                continue
            tm = self.link(t.src_device, t.dst_device)
            need_s = tm.time_s(t.remaining)
            if need_s <= remaining_s:
                remaining_s -= need_s
                t.done_bytes = t.nbytes
                done.append(t)
            else:
                # partial progress at link rate
                moved = max(0.0, (remaining_s - tm.beta)) / tm.gamma
                t.done_bytes += max(0.0, moved)
                remaining_s = 0.0
                q.append(t)
        self._queue = q
        return done

    def drain_seconds(self) -> float:
        """Time to finish everything with no overlap budget (blocking)."""
        return sum(self.link(t.src_device, t.dst_device).time_s(t.remaining)
                   for t in self._queue)
