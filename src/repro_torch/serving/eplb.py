"""Expert Placement Load Balancing (§4.5): the collect → select → place
→ migrate → execute dataflow.

The pipeline turns raw routing statistics into a *device-resident data
plane* that the decode forward path executes every iteration:

1. **Collect** — :class:`ExpertLoadCollector` accumulates per-layer
   token counts per time slice (the Collect kernel's output: the MoE
   layer counts its logical top-k ids per expert inside route-pack's
   launch, ``kernels/csrc/collect.cuh``, and reports them as
   ``expert_counts``). The slice window is a bounded deque — memory
   never grows past ``max_slices``.

2. **Select** — greedy hottest-expert replication per layer
   (:func:`select_redundant_experts`): for a redundancy budget R,
   repeatedly pick the candidate expert whose replica split minimizes
   the simulated total load  L_ℓ = Σ_t max_e count[ℓ][e][t].

3. **Place** — :func:`place_replicas` assigns replicas (sorted by load,
   heaviest first) to the least-loaded NPU with a free redundancy slot;
   :func:`build_expert_map` wraps selection + placement into one
   per-layer :class:`ExpertMap` (the host-side control-plane view).

4. **Migrate** — :class:`ExpertReconfigurator` drives the phased,
   non-blocking weight migration: *prefetch* (replica weights staged
   toward their target NPUs), *shadow-load* (weights land in spare HBM
   slots while the OLD placement keeps serving — nothing is disabled),
   then *swap* between two decode iterations via the
   ``ExecutionBackend.apply_placement`` contract (the donated-cache
   decode loop is never interrupted mid-step; see
   ``serving/dp_group.py``). :func:`migration_plan` prices the move:
   which (layer, expert, npu) replica loads change and how many weight
   bytes cross the fabric.

5. **Execute** — :class:`PlacementTable` stacks every layer's
   logical→physical mapping into ``[n_layers, ...]`` device arrays the
   forward path consumes directly: ``models/ffn.moe_apply`` routes each
   token assignment to a *physical replica slot* (round-robin of token
   position across the logical expert's replicas — a pure gather, no
   cross-NPU coordination, §4.5 step 4 / Fig. 12), so redundant experts
   genuinely split load inside the decode step. With budget 0
   the table is the identity and placement routing is bit-identical to
   logical routing (guarded by tests).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Step 1: collection
# ---------------------------------------------------------------------------
class ExpertLoadCollector:
    """Accumulates token_count[layer][expert][slice].

    The closed slices live in a ``deque(maxlen=max_slices)`` so the
    window is memory-bounded by construction: appending slice
    ``max_slices + 1`` evicts the oldest one.
    """

    def __init__(self, n_layers: int, n_experts: int, max_slices: int = 64):
        self.n_layers = n_layers
        self.n_experts = n_experts
        self.max_slices = max_slices
        self._slices: "collections.deque[np.ndarray]" = \
            collections.deque(maxlen=max_slices)
        self._current = np.zeros((n_layers, n_experts), np.int64)

    def record(self, layer_counts: np.ndarray) -> None:
        """layer_counts: [n_layers, n_experts] token counts of one step."""
        self._current += layer_counts.astype(np.int64)

    def end_slice(self) -> None:
        self._slices.append(self._current)
        self._current = np.zeros_like(self._current)

    @property
    def n_slices(self) -> int:
        return len(self._slices)

    @property
    def token_count(self) -> np.ndarray:
        """[n_layers, n_experts, n_slices]"""
        if not self._slices:
            return np.zeros((self.n_layers, self.n_experts, 1), np.int64)
        return np.stack(list(self._slices), axis=-1)


# ---------------------------------------------------------------------------
# Step 2: EPLB selection + placement
# ---------------------------------------------------------------------------
def _split_load(counts: np.ndarray, replicas: np.ndarray) -> float:
    """L_ℓ of float64 counts [E, T] under per-expert replica counts
    [E] (float64)."""
    return float((counts / replicas[:, None]).max(axis=0).sum())


def simulated_layer_load(counts: np.ndarray,
                         replicas: Dict[int, int]) -> float:
    """L_ℓ with each expert's per-slice count split over its replicas.
    counts: [E, T]; replicas: expert → replica count (≥1)."""
    r = np.ones(counts.shape[0], np.float64)
    if replicas:
        r[list(replicas)] = list(replicas.values())
    return _split_load(counts.astype(np.float64), r)


def select_redundant_experts(counts: np.ndarray, budget: int)\
        -> List[int]:
    """Greedy §4.5 selection for ONE layer. counts: [E, T]. Returns the
    redundancy list (an expert may appear multiple times = more replicas).
    Each trial adds one replica to a hot candidate and prices the layer
    with :func:`simulated_layer_load`'s arithmetic."""
    E, T = counts.shape
    cf = counts.astype(np.float64)
    replicas = np.ones(E, np.float64)
    hot_candidates = sorted(set(int(np.argmax(counts[:, t]))
                                for t in range(T)))
    chosen: List[int] = []
    for _ in range(budget):
        base = _split_load(cf, replicas)
        best_e, best_load = None, base
        for c in hot_candidates:
            replicas[c] += 1
            load = _split_load(cf, replicas)
            replicas[c] -= 1
            if load < best_load - 1e-9:
                best_e, best_load = c, load
        if best_e is None:
            break
        replicas[best_e] += 1
        chosen.append(best_e)
    return chosen


def place_replicas(chosen: Sequence[int], counts: np.ndarray,
                   n_npus: int, slots_per_npu: int,
                   base_expert_npu: Optional[np.ndarray] = None)\
        -> List[Tuple[int, int]]:
    """Assign replicas (expert, npu): heaviest replica first onto the
    least-loaded NPU with free slots. counts: [E, T]."""
    E = counts.shape[0]
    if base_expert_npu is None:
        # default layout: expert e lives on npu e % n_npus
        base_expert_npu = np.arange(E) % n_npus
    npu_load = np.zeros(n_npus, np.float64)
    total = counts.sum(axis=1).astype(np.float64)
    for e in range(E):
        npu_load[base_expert_npu[e]] += total[e]
    free_slots = np.full(n_npus, slots_per_npu, np.int64)
    order = sorted(chosen, key=lambda e: -total[e])
    placement: List[Tuple[int, int]] = []
    for e in order:
        cands = np.where(free_slots > 0)[0]
        if len(cands) == 0:
            break
        npu = int(cands[np.argmin(npu_load[cands])])
        free_slots[npu] -= 1
        # the replica takes (roughly) an even share of the expert's load
        share = total[e] / (2 + sum(1 for x, _ in placement if x == e))
        npu_load[npu] += share
        npu_load[base_expert_npu[e]] -= share
        placement.append((e, npu))
    return placement


# ---------------------------------------------------------------------------
# Step 3: host-side mapping (one layer) + rotation
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ExpertMap:
    """Logical→physical expert mapping with rotation-based balancing.

    Physical slots: [0, E) are the primary experts; [E, E + n_redundant)
    are redundant slots. ``table[pos % P, logical]`` gives the physical
    slot for a token at batch position ``pos`` — replicas are visited
    round-robin by position, which needs no communication (§4.5 step 4,
    Fig. 12's rotated columns).

    This is the host-side, per-layer control-plane view; the stacked
    device-resident form the forward path executes is
    :class:`PlacementTable`.
    """
    n_logical: int
    replicas: Dict[int, List[int]]        # logical → [physical slots]
    rotation_period: int = 4
    enabled: bool = True
    # physical slot → hosting NPU (primaries default to e % n_npus; set
    # by build_expert_map for redundant slots per the placement step)
    slot_npu: Dict[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        P = self.rotation_period
        tbl = np.zeros((P, self.n_logical), np.int32)
        for e in range(self.n_logical):
            slots = self.replicas.get(e, [e]) if self.enabled else [e]
            for p in range(P):
                tbl[p, e] = slots[p % len(slots)]
        self.table = tbl

    @property
    def n_physical(self) -> int:
        return 1 + max((max(s) for s in self.replicas.values()),
                       default=self.n_logical - 1)

    def map_tokens(self, positions: np.ndarray,
                   logical: np.ndarray) -> np.ndarray:
        """Vectorized gather (PyTorch-gather analogue, §4.5 step 4)."""
        return self.table[positions % self.rotation_period, logical]

    def replica_loads(self, expert: int, positions: np.ndarray)\
            -> Dict[int, int]:
        """Tokens per physical replica of ``expert`` when the tokens at
        ``positions`` are routed to it with exact round-robin selection
        (the PlacementTable rule: slot = replicas[pos % n_replicas])."""
        slots = self.replicas.get(expert, [expert])
        picked = np.asarray(slots, np.int64)[positions % len(slots)]
        return {int(s): int(np.sum(picked == s)) for s in slots}


def build_expert_map(counts: np.ndarray, n_experts: int, budget: int,
                     n_npus: int, slots_per_npu: int = 1,
                     rotation_period: int = 4) -> ExpertMap:
    """One-layer end-to-end: select + place + map. counts: [E, T]."""
    chosen = select_redundant_experts(counts, budget)
    placement = place_replicas(chosen, counts, n_npus, slots_per_npu)
    replicas: Dict[int, List[int]] = {e: [e] for e in range(n_experts)}
    slot_npu = {e: e % n_npus for e in range(n_experts)}
    next_slot = n_experts
    for e, npu in placement:
        replicas[e].append(next_slot)
        slot_npu[next_slot] = npu
        next_slot += 1
    return ExpertMap(n_experts, replicas, rotation_period,
                     slot_npu=slot_npu)


# ---------------------------------------------------------------------------
# Step 5: the device-resident data plane
# ---------------------------------------------------------------------------
class PlacementTable:
    """Stacked per-layer logical→physical placement, as device arrays.

    Carried through the decode forward path alongside the layer params —
    ``Model.decode_step`` slices layer ``ℓ`` out and ``moe_apply``
    routes with it:

    * ``replica_slots`` int32 ``[L, E, R]`` — physical slots of each
      logical expert's replicas, cyclically padded to the common width R.
    * ``n_replicas``   int32 ``[L, E]`` — live replica count per expert.
    * ``phys_owner``   int32 ``[L, n_physical]`` — physical slot → owning
      logical expert (identity-extended for unused padded slots, which
      the routing rule can never reference).

    Replica selection is *exact* round-robin of token position:
    ``slot = replica_slots[ℓ, e, pos % n_replicas[ℓ, e]]`` — a pure
    gather, communication-free (§4.5 step 4), and with ``n_replicas==1``
    everywhere (budget 0) the identity: ``slot == e`` bit-for-bit.

    Construction is host-side numpy (from per-layer :class:`ExpertMap`);
    ``TorchBackend.apply_placement`` copies the arrays to the backend's
    device once, when the table is installed. Shapes are padded
    (``pad_physical`` / ``pad_replicas``) so successive EPLB passes with
    the same budget keep the same kernel shapes.
    """

    def __init__(self, replica_slots, n_replicas, phys_owner):
        self.replica_slots = replica_slots
        self.n_replicas = n_replicas
        self.phys_owner = phys_owner

    # -----------------------------------------------------------------
    @property
    def n_layers(self) -> int:
        return int(self.replica_slots.shape[0])

    @property
    def n_logical(self) -> int:
        return int(self.replica_slots.shape[1])

    @property
    def n_physical(self) -> int:
        return int(self.phys_owner.shape[1])

    @property
    def max_replicas(self) -> int:
        return int(self.replica_slots.shape[2])

    def layer(self, i) -> Tuple:
        """Per-layer view ``(replica_slots [E, R], n_replicas [E],
        phys_owner [n_physical])`` — what block_apply/moe_apply consume."""
        return (self.replica_slots[i], self.n_replicas[i],
                self.phys_owner[i])

    def map_assignments(self, layer: int, positions: np.ndarray,
                        logical: np.ndarray) -> np.ndarray:
        """Host-side reference of the device routing rule."""
        rs = np.asarray(self.replica_slots[layer])
        nr = np.asarray(self.n_replicas[layer])
        logical = np.asarray(logical)
        return rs[logical, np.asarray(positions) % nr[logical]]

    # per-rank slot views (sharded-EP placement execution) -------------
    def slots_per_rank(self, ep_size: int) -> int:
        """Physical slots hosted per EP rank when slots are block-
        sharded over the EP axis (``models/ffn.py`` sharded-EP placement
        routing: slot ``s`` lives on rank ``s // slots_per_rank``).
        Rounds up — ``moe_apply`` pads the owner view with dead identity
        slots when ``n_physical % ep_size != 0``."""
        return -(-self.n_physical // int(ep_size))

    def rank_of_slot(self, slot, ep_size: int) -> np.ndarray:
        """EP rank hosting physical slot(s) ``slot`` (host-side
        reference of the device ``mine`` mask)."""
        return np.asarray(slot) // self.slots_per_rank(ep_size)

    def ranks_of_expert(self, layer: int, expert: int,
                        ep_size: int) -> List[int]:
        """Sorted EP ranks holding at least one LIVE replica of
        ``expert`` — under slot-sharded placement routing, every
        assignment of this expert lands on one of these ranks."""
        nr = int(np.asarray(self.n_replicas[layer])[expert])
        slots = np.asarray(self.replica_slots[layer])[expert, :nr]
        return sorted({int(r) for r in self.rank_of_slot(slots, ep_size)})


def identity_placement(n_layers: int, n_experts: int,
                       pad_physical: Optional[int] = None,
                       pad_replicas: int = 1) -> PlacementTable:
    """Budget-0 table: every expert a single replica in its own slot."""
    return build_placement_table([None] * n_layers, n_experts,
                                 pad_physical=pad_physical,
                                 pad_replicas=pad_replicas)


def build_placement_table(maps: Sequence[Optional[ExpertMap]],
                          n_experts: int,
                          pad_physical: Optional[int] = None,
                          pad_replicas: Optional[int] = None)\
        -> PlacementTable:
    """Stack per-layer :class:`ExpertMap`s (``None`` ⇒ identity layer)
    into one :class:`PlacementTable`. ``pad_physical``/``pad_replicas``
    fix the array shapes across EPLB passes."""
    L = len(maps)
    n_phys = max([n_experts]
                 + [m.n_physical for m in maps if m is not None])
    if pad_physical is not None:
        n_phys = max(n_phys, int(pad_physical))
    R = max([1] + [max(len(s) for s in m.replicas.values())
                   for m in maps if m is not None])
    if pad_replicas is not None:
        R = max(R, int(pad_replicas))
    replica_slots = np.tile(np.arange(n_experts, dtype=np.int32)[None, :,
                                                                 None],
                            (L, 1, R))
    n_replicas = np.ones((L, n_experts), np.int32)
    phys_owner = np.tile((np.arange(n_phys, dtype=np.int32) % n_experts)
                         [None], (L, 1))
    for li, m in enumerate(maps):
        # an absent or disabled map, and every expert a map leaves out,
        # keep the identity rows above
        experts = ([e for e in range(n_experts) if e in m.replicas]
                   if m is not None and m.enabled else [])
        if not experts:
            continue
        slots = [m.replicas[e] for e in experts]
        lens = np.array([len(s) for s in slots], np.int64)
        flat = np.array([s for ss in slots for s in ss], np.int32)
        first = np.cumsum(lens) - lens
        n_replicas[li, experts] = lens
        replica_slots[li, experts] = flat[first[:, None]
                                          + np.arange(R) % lens[:, None]]
        phys_owner[li, flat] = np.repeat(np.asarray(experts, np.int32),
                                         lens)
    return PlacementTable(replica_slots, n_replicas, phys_owner)


# ---------------------------------------------------------------------------
# Step 4: phased weight migration (§4.5 step 3) — non-blocking
# ---------------------------------------------------------------------------
class ReconfigState:
    """Phases of one live reconfiguration. Numbering is stable API:
    ``ENABLED == 4`` marks convergence (3 ``step()`` calls after
    ``begin``)."""
    IDLE, PREFETCHING, SHADOW_LOADING, READY, ENABLED = range(5)


@dataclasses.dataclass
class MigrationPlan:
    """What a reconfiguration moves: the (layer, expert, npu) replica
    loads that are NEW versus the active placement, plus bookkeeping to
    price the transfer on the fabric."""
    added: List[Tuple[int, int, int]]      # (layer, expert, npu) to load
    removed: List[Tuple[int, int, int]]    # slots freed (no traffic)
    bytes_per_replica: int = 0

    @property
    def n_replica_loads(self) -> int:
        return len(self.added)

    @property
    def total_bytes(self) -> int:
        return self.n_replica_loads * self.bytes_per_replica

    def per_npu_loads(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for _, _, npu in self.added:
            out[npu] = out.get(npu, 0) + 1
        return out

    @property
    def hottest_npu_loads(self) -> int:
        """Replica weight loads on the busiest receiving NPU — the
        migration's fabric critical path."""
        per = self.per_npu_loads()
        return max(per.values()) if per else 0


def _replica_set(maps: Mapping[int, ExpertMap])\
        -> set:
    """{(layer, expert, npu)} of REDUNDANT replicas (primaries never
    move — they live with the base layout)."""
    out = set()
    for li, m in maps.items():
        if m is None:
            continue
        for e, slots in m.replicas.items():
            for s in slots[1:]:
                out.add((li, e, m.slot_npu.get(s, s % max(m.n_logical, 1))))
    return out


def migration_plan(old_maps: Mapping[int, ExpertMap],
                   new_maps: Mapping[int, ExpertMap],
                   bytes_per_replica: int = 0) -> MigrationPlan:
    """Diff two per-layer map sets into the weight traffic a live
    reconfiguration must pay."""
    old, new = _replica_set(old_maps), _replica_set(new_maps)
    return MigrationPlan(added=sorted(new - old),
                         removed=sorted(old - new),
                         bytes_per_replica=bytes_per_replica)


class ExpertReconfigurator:
    """Phased live reconfiguration driver: prefetch → shadow-load →
    swap, never interrupting serving.

    ``begin(new_maps)`` diffs the pending placement against the active
    one into a :class:`MigrationPlan` and starts the prefetch; each
    ``step()`` advances one phase:

    1. PREFETCHING → SHADOW_LOADING: replica weights stream toward their
       target NPUs (``load_fn`` — async on hardware, priced on the UB
       fabric by the simulator). The OLD placement keeps serving.
    2. SHADOW_LOADING → READY: weights are resident in spare HBM slots;
       nothing routes to them yet.
    3. READY → ENABLED: the swap. ``apply_fn(new_maps)`` is invoked —
       deployments pass a callback that builds the new
       :class:`PlacementTable` and hands it to every DP group's
       ``ExecutionBackend.apply_placement`` *between* decode iterations
       (``DPGroup.apply_placement`` defers while a donated-cache decode
       step is in flight).

    Counters (``n_reconfigs``, ``total_migrated_bytes``,
    ``steps_to_converge``) feed the ``bench_eplb_reconfig`` benchmark
    and the simulator's fabric accounting.
    """

    #: phases between ``begin`` and ENABLED
    steps_to_converge: int = 3

    def __init__(self,
                 apply_fn: Optional[Callable] = None,
                 prefetch_fn: Optional[Callable] = None,
                 load_fn: Optional[Callable] = None,
                 bytes_per_replica: int = 0):
        self.state = ReconfigState.IDLE
        self.apply_fn = apply_fn or (lambda maps: None)
        self.prefetch_fn = prefetch_fn or (lambda plan: None)
        self.load_fn = load_fn or (lambda plan: None)
        self.bytes_per_replica = bytes_per_replica
        self.active_maps: Dict[int, ExpertMap] = {}
        self.pending_maps: Optional[Dict[int, ExpertMap]] = None
        self.plan: Optional[MigrationPlan] = None
        self.n_reconfigs = 0
        self.total_migrated_bytes = 0

    @staticmethod
    def _as_maps(maps) -> Dict[int, ExpertMap]:
        if isinstance(maps, ExpertMap):
            return {0: maps}
        return dict(maps or {})

    def begin(self, new_maps, placement=None) -> MigrationPlan:
        """Start a reconfiguration toward ``new_maps`` (a per-layer dict
        or a single :class:`ExpertMap`). ``placement`` is accepted for
        backward compatibility with the four-phase demo API and passed
        through to ``prefetch_fn`` when given."""
        assert self.state in (ReconfigState.IDLE, ReconfigState.ENABLED), \
            "reconfiguration already in flight"
        self.pending_maps = self._as_maps(new_maps)
        self.plan = migration_plan(self.active_maps, self.pending_maps,
                                   self.bytes_per_replica)
        self.prefetch_fn(placement if placement is not None else self.plan)
        self.state = ReconfigState.PREFETCHING
        return self.plan

    def step(self, placement=None) -> int:
        if self.state == ReconfigState.PREFETCHING:
            # weights stream toward target NPUs; old placement serves on
            self.load_fn(placement if placement is not None else self.plan)
            self.state = ReconfigState.SHADOW_LOADING
        elif self.state == ReconfigState.SHADOW_LOADING:
            self.state = ReconfigState.READY
        elif self.state == ReconfigState.READY:
            # the swap: between decode iterations, atomically
            self.active_maps = self.pending_maps or {}
            self.pending_maps = None
            self.apply_fn(self.active_maps)
            self.n_reconfigs += 1
            if self.plan is not None:
                self.total_migrated_bytes += self.plan.total_bytes
            self.state = ReconfigState.ENABLED
        return self.state
