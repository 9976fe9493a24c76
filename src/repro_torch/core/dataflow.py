"""Dataflow serving vision (§5.3): no global synchronization in the data
path.

The paper's end-state: tensors flow asynchronously between modular
components; no A2E/E2A barrier can stall the world. This module provides
a small executable dataflow runtime over the Transformerless units:

* nodes = stage functions with explicit input/output ports,
* edges = bounded queues (latency-variation tolerance: a slow producer
  backs up its own queue instead of stalling the global step),
* a decentralized, event-driven scheduler: a node fires whenever all its
  input ports hold data and its output queue has space,
* consistency: tokens carry (request, iteration) tags so partial results
  and delayed inputs are matched correctly (the §5.3 challenge list).

A stage function on CUDA tensors queues its kernels on the stream and
returns without a host sync, so "firing" a node does not block the
host; the runtime only synchronizes where a sink's consumer reads a
payload back.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

PyTree = Any
_seq = itertools.count()


@dataclasses.dataclass(frozen=True)
class Tag:
    """Correctness under asynchrony: every payload is (request, iter)
    tagged; joins only fire on matching tags."""
    req_id: int
    iteration: int


@dataclasses.dataclass
class Packet:
    tag: Tag
    payload: PyTree
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))


class Port:
    def __init__(self, capacity: int = 8):
        self.q: Deque[Packet] = deque()
        self.capacity = capacity

    @property
    def full(self) -> bool:
        return len(self.q) >= self.capacity

    def push(self, p: Packet) -> bool:
        if self.full:
            return False
        self.q.append(p)
        return True

    def peek_tag(self) -> Optional[Tag]:
        return self.q[0].tag if self.q else None

    def pop(self) -> Packet:
        return self.q.popleft()


class Node:
    def __init__(self, name: str, fn: Callable[..., PyTree],
                 n_inputs: int = 1, out_capacity: int = 8):
        self.name = name
        self.fn = fn
        self.inputs = [Port() for _ in range(n_inputs)]
        self.out = Port(out_capacity)
        self.fired = 0

    def ready(self) -> Optional[Tag]:
        """Fire condition: all inputs hold a packet with the SAME tag and
        the output has space (event-driven, no global barrier)."""
        if self.out.full:
            return None
        tags = [p.peek_tag() for p in self.inputs]
        if any(t is None for t in tags):
            return None
        if len(set(tags)) != 1:
            # tag mismatch at a join: drop nothing, wait for alignment —
            # packets are FIFO per edge so alignment is eventual
            return None
        return tags[0]

    def fire(self) -> bool:
        tag = self.ready()
        if tag is None:
            return False
        args = [p.pop().payload for p in self.inputs]
        out = self.fn(*args)
        self.out.push(Packet(tag=Tag(tag.req_id, tag.iteration + 1)
                             if self.name.endswith("!") else tag,
                             payload=out))
        self.fired += 1
        return True


class DataflowGraph:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Tuple[str, str, int]] = []
        self.sinks: Dict[str, List[Packet]] = {}

    def add(self, node: Node) -> Node:
        self.nodes[node.name] = node
        return node

    def connect(self, src: str, dst: str, port: int = 0) -> None:
        self.edges.append((src, dst, port))

    def mark_sink(self, name: str) -> None:
        self.sinks[name] = []

    def inject(self, name: str, packet: Packet, port: int = 0) -> None:
        self.nodes[name].inputs[port].push(packet)

    def run(self, max_rounds: int = 10_000) -> int:
        """Event loop: keep firing ready nodes; move outputs along edges.
        Returns number of firings. A straggler node only delays its own
        consumers (bounded queues absorb the variance)."""
        fired_total = 0
        for _ in range(max_rounds):
            progress = False
            for node in self.nodes.values():
                if node.fire():
                    progress = True
                    fired_total += 1
            for src, dst, port in self.edges:
                s = self.nodes[src]
                while s.out.q and not self.nodes[dst].inputs[port].full:
                    self.nodes[dst].inputs[port].push(s.out.pop())
                    progress = True
            for name in self.sinks:
                s = self.nodes[name]
                while s.out.q:
                    self.sinks[name].append(s.out.pop())
                    progress = True
            if not progress:
                break
        return fired_total
