"""XCCL point-to-point primitives (§3.1).

Two layers:

1. **Protocol layer** (host-level, hardware-faithful): the distributed
   ring-buffer memory protocol of Fig. 4 — metadata fields (eventID,
   chunkID, tailPtr), managed-data ring buffers per NPU pair, chunked
   transfer through bounded unified buffers, acknowledgment, and an async
   mode. It is implemented as an explicit state machine over simulated
   NPU memories so its invariants (FIFO delivery, no loss, backpressure
   when the ring is full, eventID sanity) are unit/property-testable.
   FlowServe's DistFlow KV-transfer path drives this layer.

2. **Device layer**: the bytes move with ``Tensor.to`` (between devices,
   PD disaggregation: ``pd_transfer.py``) or the mesh context's
   ``ppermute`` (between ranks: ``models/mesh_ctx.py``).

Pure host code over numpy; ``UNIFIED_BUFFER_BYTES`` and
``mte_transfer_time`` come from the port's ``xccl/topology.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.xccl.topology import UNIFIED_BUFFER_BYTES, mte_transfer_time


# ---------------------------------------------------------------------------
# Simulated NPU memory areas (§3.1 "Data structure")
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MetadataField:
    """One 32-byte metadata field (per peer, per AIV-core pair)."""
    event_id: int = -1
    chunk_id: int = -1
    tail_ptr: int = 0
    ack_event: int = -1


@dataclasses.dataclass
class RingBuffer:
    """Managed-data ring buffer for one (src, dst) NPU pair."""
    n_slots: int
    slot_bytes: int
    slots: List[Optional[bytes]] = None
    head: int = 0     # consumer position
    tail: int = 0     # producer position (mirrors metadata tailPtr)

    def __post_init__(self):
        if self.slots is None:
            self.slots = [None] * self.n_slots

    @property
    def free(self) -> int:
        return self.n_slots - (self.tail - self.head)

    def push(self, payload: bytes) -> bool:
        if self.free == 0:
            return False                      # backpressure
        self.slots[self.tail % self.n_slots] = payload
        self.tail += 1
        return True

    def pop(self) -> Optional[bytes]:
        if self.head == self.tail:
            return None
        out = self.slots[self.head % self.n_slots]
        self.slots[self.head % self.n_slots] = None
        self.head += 1
        return out


class NPUMemory:
    """App data area + metadata area + managed data area for one NPU die."""

    def __init__(self, npu_id: int, n_peers: int, ring_slots: int = 16,
                 slot_bytes: int = 64 * 1024):
        self.npu_id = npu_id
        self.app_data: Dict[str, Any] = {}
        self.meta: Dict[int, MetadataField] = {
            p: MetadataField() for p in range(n_peers)}
        self.rings: Dict[int, RingBuffer] = {
            p: RingBuffer(ring_slots, slot_bytes) for p in range(n_peers)}


class XCCLError(RuntimeError):
    pass


class P2PChannel:
    """The §3.1 send/receive protocol between two simulated NPUs.

    Synchronous mode: ``send`` chunks the payload through the (bounded)
    unified buffer into the receiver's ring, updates the receiver-side
    tailPtr metadata, and busy-polls for the ack; ``recv`` polls metadata,
    drains the ring, and acks. The async mode enqueues work items instead
    of polling (used by DistFlow's completion queues).
    """

    def __init__(self, sender: NPUMemory, receiver: NPUMemory,
                 n_aiv_cores: int = 8, fabric: str = "ub"):
        self.sender = sender
        self.receiver = receiver
        self.n_aiv_cores = n_aiv_cores
        self.fabric = fabric
        self.elapsed = 0.0          # modeled wall time
        self._pending: Dict[int, List[bytes]] = {}

    # -- step 1-4: sender side -------------------------------------------
    def send(self, payload: bytes, event_id: int) -> float:
        ring = self.receiver.rings[self.sender.npu_id]
        # chunk = one unified-buffer fill, bounded by the ring slot size
        chunk = min(UNIFIED_BUFFER_BYTES, ring.slot_bytes)
        chunks = [payload[i:i + chunk]
                  for i in range(0, max(len(payload), 1), chunk)]
        meta = self.receiver.meta[self.sender.npu_id]
        if meta.event_id >= event_id:
            raise XCCLError(
                f"eventID sanity check failed: {event_id} already seen")
        for cid, c in enumerate(chunks):
            while not ring.push(c):
                # busy-poll: receiver must drain (backpressure, §5.1 step 6)
                raise XCCLError("ring full: receiver applied backpressure")
            meta.chunk_id = cid
            meta.tail_ptr = ring.tail
        meta.event_id = event_id
        t = mte_transfer_time(len(payload), self.n_aiv_cores, self.fabric)
        self.elapsed += t
        return t

    # -- step 5-7: receiver side -----------------------------------------
    def recv(self, event_id: int) -> bytes:
        meta = self.receiver.meta[self.sender.npu_id]
        if meta.event_id != event_id:
            raise XCCLError(
                f"recv polling: expected event {event_id}, "
                f"metadata has {meta.event_id}")
        ring = self.receiver.rings[self.sender.npu_id]
        out = []
        while True:
            c = ring.pop()
            if c is None:
                break
            out.append(c)
        # step 7: ack back to the sender's metadata area
        self.sender.meta[self.receiver.npu_id].ack_event = event_id
        return b"".join(out)

    # -- async mode (§3.1 last ¶) ------------------------------------------
    def send_async(self, payload: bytes, event_id: int) -> None:
        self._pending.setdefault(event_id, []).append(payload)

    def poll_async(self, event_id: int) -> Optional[bytes]:
        msgs = self._pending.pop(event_id, None)
        if msgs is None:
            return None
        t = sum(self.send(m, event_id) for m in msgs)
        del t
        return self.recv(event_id)

    def acked(self, event_id: int) -> bool:
        return self.sender.meta[self.receiver.npu_id].ack_event >= event_id


def make_pair(ring_slots: int = 16) -> Tuple[NPUMemory, NPUMemory,
                                             P2PChannel]:
    a, b = NPUMemory(0, 2, ring_slots), NPUMemory(1, 2, ring_slots)
    return a, b, P2PChannel(a, b)
