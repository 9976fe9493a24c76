"""Reliability (§6): detection + staged recovery.

Detection: multi-tier heartbeats (control-plane → TE shell → DP masters;
decoupled intervals; a DP master's single-threaded event loop only answers
when live, so a hung executor is detected as a missed reply) and link
probing for silent KV-transfer stalls (dummy payloads distinguish
decode-side saturation — dummy delayed but delivered — from link faults —
everything blocked).

Recovery: the three-stage evolution — restart-the-world, P/D separate
failover (kill-P-to-preserve-D, later EP vertical scaling), fine-grained
token recomputation + memory-fault masking.

Everything runs on an injectable clock so tests are deterministic.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional, Sequence


class Clock:
    """Virtual clock for deterministic tests."""

    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# §6.1 multi-tier heartbeats
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class HeartbeatPeer:
    name: str
    last_reply: float = 0.0
    alive: bool = True
    # the peer's event loop: returns True iff it can answer (a hung
    # executor blocks its DP master's loop → no reply)
    responder: Callable[[], bool] = lambda: True


class HeartbeatMonitor:
    def __init__(self, clock: Clock, interval: float, timeout: float,
                 peers: Sequence[HeartbeatPeer]):
        self.clock = clock
        self.interval = interval
        self.timeout = timeout
        self.peers = list(peers)
        self._last_sent = -1e18
        self.failures: List[str] = []

    def tick(self) -> List[str]:
        """Advancing the control loop; returns newly-failed peer names."""
        now = self.clock.now()
        if now - self._last_sent >= self.interval:
            self._last_sent = now
            for p in self.peers:
                if p.alive and p.responder():
                    p.last_reply = now
        newly = []
        for p in self.peers:
            if p.alive and now - p.last_reply > self.timeout:
                p.alive = False
                newly.append(p.name)
                self.failures.append(p.name)
        return newly


class TieredHeartbeat:
    """Control plane → TE shell → DP masters with decoupled intervals."""

    def __init__(self, clock: Clock, dp_peers: Sequence[HeartbeatPeer],
                 shell_interval: float = 1.0, dp_interval: float = 0.2,
                 timeout_mult: float = 3.0):
        self.shell = HeartbeatPeer("te-shell")
        self.l1 = HeartbeatMonitor(clock, shell_interval,
                                   shell_interval * timeout_mult,
                                   [self.shell])
        self.l2 = HeartbeatMonitor(clock, dp_interval,
                                   dp_interval * timeout_mult, dp_peers)

    def tick(self) -> Dict[str, List[str]]:
        return {"shell": self.l1.tick(), "dp": self.l2.tick()}


# ---------------------------------------------------------------------------
# §6.1 link probing
# ---------------------------------------------------------------------------
class ProbeVerdict(enum.Enum):
    HEALTHY = "healthy"
    SATURATED = "decode-side saturation"
    LINK_FAULT = "link fault"


class LinkProber:
    """Distinguishes silent KV-transfer stalls: inject a dummy payload;
    saturation delays it (but it completes), a link fault blocks it."""

    def __init__(self, send_dummy: Callable[[], Optional[float]],
                 delay_threshold: float = 0.05):
        self.send_dummy = send_dummy
        self.delay_threshold = delay_threshold

    def probe(self, kv_transfer_stalled: bool) -> ProbeVerdict:
        if not kv_transfer_stalled:
            return ProbeVerdict.HEALTHY
        latency = self.send_dummy()
        if latency is None:
            return ProbeVerdict.LINK_FAULT
        if latency > self.delay_threshold:
            return ProbeVerdict.SATURATED
        # dummy fine but KV stalled → resource issue on the KV path
        return ProbeVerdict.SATURATED


# ---------------------------------------------------------------------------
# §6.2 staged recovery policies
# ---------------------------------------------------------------------------
class RecoveryStage(enum.Enum):
    RESTART_THE_WORLD = 1
    PD_SEPARATE_FAILOVER = 2
    FINE_GRAINED = 3


@dataclasses.dataclass
class ClusterState:
    prefill_instances: List[str]
    decode_instances: List[str]
    tainted_nodes: List[str] = dataclasses.field(default_factory=list)
    ep_ranks: int = 16
    dp_groups: int = 4
    min_ep_ranks: int = 4


class RecoveryPlanner:
    """Emits a recovery plan for a failure event under each stage."""

    def __init__(self, stage: RecoveryStage = RecoveryStage.FINE_GRAINED):
        self.stage = stage

    def plan(self, state: ClusterState, failed: str,
             transient: bool = False) -> List[str]:
        actions: List[str] = []
        if self.stage == RecoveryStage.RESTART_THE_WORLD:
            actions.append(f"taint:{failed}")
            # decode restarted before prefill (spans multiple nodes)
            actions += [f"restart:decode:{d}"
                        for d in state.decode_instances]
            actions += [f"restart:prefill:{p}"
                        for p in state.prefill_instances]
            return actions
        if self.stage == RecoveryStage.PD_SEPARATE_FAILOVER:
            actions.append(f"taint:{failed}")
            if failed in state.decode_instances:
                # kill-P-to-preserve-D: free prefill nodes for decode
                victim = state.prefill_instances[0] \
                    if state.prefill_instances else None
                if victim:
                    actions.append(f"kill:prefill:{victim}")
                actions.append(f"restart:decode:{failed}")
            else:
                actions.append(f"restart:prefill:{failed}")
            return actions
        # fine-grained
        if transient:
            # §6.2 stage 3: token recomputation — rollback one iteration,
            # a dedicated thread broadcasts to all (busy-waiting) DP groups
            actions.append("broadcast:rollback-previous-iteration")
            actions.append("reexecute:iteration")
            return actions
        if failed in state.decode_instances:
            # EP vertical scaling: shrink DP groups / EP ranks, keep ≥1
            # replica per expert, drop excess replicas gracefully
            new_ep = max(state.min_ep_ranks, state.ep_ranks // 2)
            actions.append(f"taint:{failed}")
            actions.append(f"ep-scale:{state.ep_ranks}->{new_ep}")
            actions.append("eplb:drop-excess-replicas")
        else:
            actions.append(f"taint:{failed}")
            actions.append(f"restart:prefill:{failed}")
        return actions


def mask_memory_fault(cache_blocks: Dict[int, bool],
                      faulty_block: int) -> List[int]:
    """On-chip memory fault (§6.2): remap/mask the faulty region; the KV
    blocks on it are lost and their requests fail, everything else keeps
    serving. Returns the failed block ids."""
    failed = [b for b in cache_blocks if b == faulty_block]
    for b in failed:
        cache_blocks[b] = False
    return failed
