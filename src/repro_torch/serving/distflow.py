"""DistFlow: the KV-transfer orchestration layer (§5.1 steps 3-8).

Responsibilities per the paper: deferred (pull-triggered) transfers,
SEND/RECV handshakes, ordering, TP-rank synchronization, semantic pairing
of non-self-describing KV blocks, per-TE-pair isolated instances that may
share XCCL buffers, completion queues, and backpressure when the decode
side lacks KV capacity.

Chunked prefill adds CHUNK STREAMS: instead of one post-hoc bulk
transfer after the whole prompt prefills, each finished chunk's KV
layers ship immediately (``stream_chunk``), overlapped with the next
chunk's compute on the prefill side; the decode side assembles the
stream (``pop_stream``) once the final chunk lands and then admits.

The byte movement itself is ``xccl.pd_transfer``; fabric choice (UB vs
RoCE vs VPC for 910B-prefill → 910C-decode heterogeneity) is a parameter
that prices the plans on the paper's link model. ``dst`` is where the KV
lands (``execute_transfer``'s destination, as the reference's
``dst_shardings``): None hands it off in place, a device moves it there,
a :class:`~repro_torch.xccl.pd_transfer.KVLayout` reshards it onto a
decode group's ranks (on a rank of the prefill group the landed KV is
then None). A stream's chunks land under the layout one by one and
concatenate along the sequence, so its layout must keep that dim whole.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional

from repro_torch.xccl.pd_transfer import (KVLayout, TransferPlan,
                                          assemble_chunks, execute_transfer,
                                          plan_transfer)

PyTree = Any
_task_ids = itertools.count()


class TransferState(enum.Enum):
    REGISTERED = "registered"      # metadata only (§5.1 step 3)
    TRIGGERED = "triggered"        # decode-side RECV submitted (step 6)
    DEFERRED = "deferred"          # backpressure: no KV capacity yet
    COMPLETE = "complete"
    FAILED = "failed"


@dataclasses.dataclass
class TransferTask:
    req_id: int
    kv_ref: PyTree                      # prefill-side KV blocks (by ref)
    meta: Dict[str, Any]
    plan: TransferPlan
    state: TransferState = TransferState.REGISTERED
    task_id: int = dataclasses.field(default_factory=lambda: next(_task_ids))
    event_id: int = 0
    result: Optional[PyTree] = None
    t_registered: float = dataclasses.field(default_factory=time.monotonic)
    t_complete: Optional[float] = None


@dataclasses.dataclass
class ChunkStream:
    """A per-request streamed PD transfer: chunk payloads arrive in
    order as prefill chunks finish; ``complete`` flips with the final
    chunk, after which :meth:`DistFlowInstance.pop_stream` assembles."""
    req_id: int
    meta: Dict[str, Any]
    chunks: List[PyTree] = dataclasses.field(default_factory=list)
    chunk_bytes: List[int] = dataclasses.field(default_factory=list)
    complete: bool = False

    @property
    def total_bytes(self) -> int:
        return sum(self.chunk_bytes)


class DistFlowInstance:
    """One isolated instance per (prefill TE, decode TE) pair — a failure
    domain boundary (§5.1 step 7)."""

    def __init__(self, pair: str, fabric: str = "ub",
                 dst: Optional[Any] = None):
        self.pair = pair
        self.fabric = fabric
        self.dst = dst
        self.tasks: Dict[int, TransferTask] = {}
        self.streams: Dict[int, ChunkStream] = {}
        self.completion_queue: Deque[int] = deque()
        self._event = itertools.count(1)
        self.healthy = True
        self.bytes_moved = 0
        self.chunks_streamed = 0

    # -- prefill side -------------------------------------------------------
    def register(self, req_id: int, kv: PyTree,
                 meta: Optional[Dict[str, Any]] = None) -> TransferTask:
        """Step 3: metadata-only registration; data stays on prefill NPUs
        until the decode side triggers the pull."""
        task = TransferTask(req_id=req_id, kv_ref=kv, meta=meta or {},
                            plan=plan_transfer(kv, self.fabric))
        self.tasks[task.task_id] = task
        return task

    # -- prefill side: chunk streaming --------------------------------------
    def open_stream(self, req_id: int,
                    meta: Optional[Dict[str, Any]] = None) -> ChunkStream:
        """Open a streamed transfer for one request (first chunk about
        to finish). Chunks then ship eagerly — the overlap with the next
        chunk's compute is the point — rather than deferring to a
        decode-side pull like the bulk path."""
        if isinstance(self.dst, KVLayout) and self.dst.cuts_sequence():
            raise ValueError(f"DistFlow {self.pair}: a stream's layout "
                             f"must keep the sequence dim whole")
        stream = ChunkStream(req_id=req_id, meta=meta or {})
        self.streams[req_id] = stream
        return stream

    def stream_chunk(self, req_id: int, kv_chunk: PyTree,
                     last: bool = False) -> TransferPlan:
        """Ship one finished chunk's KV layers (async SEND; on the paper's
        hardware the MTE/SDMA engines move it while the NPU computes the
        next chunk). Returns the chunk's transfer plan for accounting."""
        if not self.healthy:
            raise RuntimeError(f"DistFlow {self.pair} unhealthy")
        stream = self.streams[req_id]
        plan = plan_transfer(kv_chunk, self.fabric)
        moved = execute_transfer(kv_chunk, self.dst)
        stream.chunks.append(moved)
        stream.chunk_bytes.append(plan.total_bytes)
        self.bytes_moved += plan.total_bytes
        self.chunks_streamed += 1
        if last:
            stream.complete = True
        return plan

    def pop_stream(self, req_id: int) -> Optional[PyTree]:
        """Decode side: assemble and take a COMPLETE stream's cache
        (None while chunks are still in flight, and on a prefill-group
        rank that a layout across the group axis left no block)."""
        stream = self.streams.get(req_id)
        if stream is None or not stream.complete:
            return None
        del self.streams[req_id]
        if any(c is None for c in stream.chunks):
            return None
        return assemble_chunks(stream.chunks)

    # -- decode side --------------------------------------------------------
    def trigger(self, task_id: int, can_receive: Callable[[], bool]) -> bool:
        """Step 6: decode submits an async RECV; if KV capacity is missing
        the transfer is deferred (backpressure upstream)."""
        task = self.tasks[task_id]
        if not self.healthy:
            task.state = TransferState.FAILED
            return False
        if not can_receive():
            task.state = TransferState.DEFERRED
            return False
        task.state = TransferState.TRIGGERED
        task.event_id = next(self._event)
        # step 7: the actual movement (handshake/ordering inside)
        task.result = execute_transfer(task.kv_ref, self.dst)
        task.state = TransferState.COMPLETE
        task.t_complete = time.monotonic()
        self.bytes_moved += task.plan.total_bytes
        self.completion_queue.append(task.task_id)
        return True

    def retry_deferred(self, can_receive: Callable[[], bool]) -> int:
        n = 0
        for t in list(self.tasks.values()):
            if t.state == TransferState.DEFERRED:
                if self.trigger(t.task_id, can_receive):
                    n += 1
        return n

    # -- both sides ---------------------------------------------------------
    def poll_completions(self) -> List[TransferTask]:
        """Step 8: each DP polls its completion queue; on completion the
        prefill side releases KV blocks and decode enqueues the request."""
        done = []
        while self.completion_queue:
            tid = self.completion_queue.popleft()
            task = self.tasks.pop(tid)
            task.kv_ref = None          # prefill releases its blocks
            done.append(task)
        return done
