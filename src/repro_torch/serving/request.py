"""Request-Job-Task model (§2.1) and SLA targets (§7.2)."""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

_req_ids = itertools.count()


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    TRANSFERRING = "transferring"   # PD-disagg KV transfer in flight
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"


@dataclasses.dataclass
class SLA:
    """Production targets (§7.2): TTFT < 2 s, TPOT ≤ 35 ms typical."""
    ttft_s: float = 2.0
    tpot_s: float = 0.035


@dataclasses.dataclass
class Request:
    prompt: str = ""
    prompt_tokens: Optional[List[int]] = None
    max_new_tokens: int = 64
    temperature: float = 0.0
    ignore_eos: bool = False
    eos_token: int = 1
    sla: SLA = dataclasses.field(default_factory=SLA)
    # callbacks (output shortcutting §4.2: streamed straight to frontend)
    on_token: Optional[Callable[[int], None]] = None

    # runtime state
    req_id: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    state: RequestState = RequestState.QUEUED
    # chunked-prefill cursor (§4.3 token-budget admission): tokens of the
    # prompt already COVERED by emitted chunk work items. Advanced by the
    # PrefillScheduler when it emits a chunk (and jumped forward by the
    # executor on a radix prefix-cache hit, which cancels the
    # fully-cached chunks). prompt_len - prefill_pos is the work left.
    prefill_pos: int = 0
    n_prefill_chunks: int = 0
    # tokens served from the radix prefix cache (longest cached block
    # prefix at prefill start): the executor seeds this many positions
    # of KV from stored blocks and advances prefill_pos past
    # fully-cached chunks, so only the un-cached suffix runs
    prefix_hit_tokens: int = 0
    output_tokens: List[int] = dataclasses.field(default_factory=list)
    # tokens handed to the output path, counted synchronously by the DP
    # group (output_tokens is appended by the async output-shortcutting
    # worker, so its length must not drive scheduling decisions)
    n_emitted: int = 0
    t_arrival: float = dataclasses.field(default_factory=time.monotonic)
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    prefill_te: Optional[int] = None
    # session-migration marker (sim workload): this turn re-lands away
    # from the TE holding its session prefix, so only a pod-pooled
    # prefix cache can serve it without recompute
    migrate: bool = False
    decode_te: Optional[int] = None
    dp_group: Optional[int] = None
    slot: Optional[int] = None
    error: Optional[str] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt_tokens or ())

    @property
    def prefill_remaining(self) -> int:
        """Prompt tokens not yet covered by a scheduled prefill chunk."""
        return max(self.prompt_len - self.prefill_pos, 0)

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def tpot(self) -> Optional[float]:
        if self.t_finished is None or len(self.output_tokens) < 2:
            return None
        return ((self.t_finished - (self.t_first_token or self.t_arrival))
                / max(len(self.output_tokens) - 1, 1))

    def emit(self, token: int) -> None:
        if self.t_first_token is None:
            self.t_first_token = time.monotonic()
        self.output_tokens.append(token)
        if self.on_token is not None:
            self.on_token(token)


@dataclasses.dataclass
class Job:
    """A job groups requests of one workload (the serverless
    request-job-task model of DeepServe [10])."""
    job_id: int
    kind: str = "inference"         # inference | finetune | agent
    requests: List[Request] = dataclasses.field(default_factory=list)
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
