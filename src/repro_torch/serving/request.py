"""Request lifecycle for the serving engine."""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    state: RequestState = RequestState.QUEUED
    output: List[int] = dataclasses.field(default_factory=list)
    # head placement: device_id -> query heads (Dispatcher-owned)
    placement: Dict[int, int] = dataclasses.field(default_factory=dict)
    # engine bookkeeping
    slot: int = -1                  # batch slot in the dense compute view
    # tokens of prompt+output already written to the paged pool by the
    # chunked prefill scheduler (reset to 0 on preemption — replay)
    prefill_pos: int = 0
    ttft: Optional[float] = None
    finish_time: Optional[float] = None
    prefill_start: Optional[float] = None

    @property
    def ctx_len(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new_tokens

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.ttft is None or not self.output:
            return None
        if len(self.output) <= 1:
            return 0.0
        return (self.finish_time - (self.arrival + self.ttft)) \
            / (len(self.output) - 1)
