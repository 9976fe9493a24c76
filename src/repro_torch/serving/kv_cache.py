"""Paged KV block allocator + radix-tree prefix cache (FlowServe RTC).

Each DP group owns a :class:`BlockAllocator` accounting for its NPU-local
KV memory in fixed-size blocks (decode admission control and the
KV-usage-based DP load balancing of §4.3 read these counters).  Requests
hold blocks chunk-granularly: a chunked prefill extends its allocation as
each `ChunkWork` executes, so a request only ever owns blocks for tokens
prefilled so far.

:class:`RadixTree` is the Relational Tensor Cache role from FlowServe
[10], in the RadixAttention idiom: prompts are keyed by *cumulative*
block hashes (`hash_blocks` — hash equality implies an identical token
prefix), stored as path-compressed edges whose nodes reference per-block
KV payloads plus the `BlockAllocator` blocks that back them.  A lookup
returns the longest cached block-prefix; `DPGroup.run_prefill_chunk`
seeds the partial prefill cache from the stored KV and runs only the
un-cached suffix through the chunk programs — a *partial* hit skips
compute, not just an exact whole-prompt hit.  Per-node refcounts pin
in-use paths (lock/unlock covers the whole matched root path) and
eviction is strictly leaf-wise: only a childless unreferenced node is
ever removed, so a locked node — and every ancestor above it, which by
construction still has children — survives any amount of pool pressure,
and freed blocks go back to the pool.

The tensor payloads live host-side as pytrees (the app-data area in XCCL
terms), one per block; seeding assembles them into a fresh prefill cache
via the backend's `seed_prefill_cache` contract (`serving/backend.py`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

PyTree = Any


class OutOfBlocks(RuntimeError):
    pass


class DoubleFree(RuntimeError):
    """Raised when `BlockAllocator.free` is called for an owner that holds
    no blocks (double-free / free-of-unknown-owner)."""
    pass


@dataclasses.dataclass
class BlockAllocator:
    """Fixed-pool block accounting (one per DP group)."""
    n_blocks: int
    block_size: int = 16

    def __post_init__(self):
        self._free: List[int] = list(range(self.n_blocks))
        self._owned: Dict[int, List[int]] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def usage(self) -> float:
        return self.used_blocks / max(self.n_blocks, 1)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.block_size)

    def can_allocate(self, n_tokens: int, reserve_blocks: int = 0) -> bool:
        return self.blocks_for(n_tokens) + reserve_blocks <= self.free_blocks

    def allocate(self, owner: int, n_tokens: int) -> List[int]:
        need = self.blocks_for(n_tokens)
        if need > len(self._free):
            raise OutOfBlocks(
                f"owner {owner}: need {need}, free {len(self._free)}")
        blocks = [self._free.pop() for _ in range(need)]
        self._owned.setdefault(owner, []).extend(blocks)
        return blocks

    def extend(self, owner: int, n_new_tokens_total: int) -> List[int]:
        """Grow an owner's allocation to cover n_new_tokens_total."""
        have = len(self._owned.get(owner, ())) * self.block_size
        need_tokens = n_new_tokens_total - have
        if need_tokens <= 0:
            return []
        return self.allocate(owner, need_tokens)

    def holds(self, owner: int) -> bool:
        return owner in self._owned

    def owned_tokens(self, owner: int) -> int:
        """Token capacity of the blocks an owner currently holds."""
        return len(self._owned.get(owner, ())) * self.block_size

    def free(self, owner: int, *, missing_ok: bool = False) -> int:
        if owner not in self._owned:
            if missing_ok:
                return 0
            raise DoubleFree(f"owner {owner} holds no blocks")
        blocks = self._owned.pop(owner)
        self._free.extend(blocks)
        return len(blocks)

    def owners(self) -> List[int]:
        return list(self._owned)


def hash_blocks(tokens: List[int], block_size: int = 16) -> List[str]:
    """Rolling block hashes (each hash covers the whole prefix up to and
    including its block — standard prefix-cache keying, so hash equality
    implies token-prefix equality)."""
    out = []
    h = hashlib.sha256()
    n_full = len(tokens) // block_size
    for b in range(n_full):
        chunk = tokens[b * block_size:(b + 1) * block_size]
        h.update(bytes(str(chunk), "utf-8"))
        out.append(h.hexdigest()[:24])
    return out


@dataclasses.dataclass
class RadixNode:
    """One path-compressed edge of the radix tree.

    `hashes[i]` keys the i-th block of the edge; `payloads[i]` is that
    block's KV pytree (None when the tree is accounting-only) and
    `block_ids[i]` its backing block in the tree's allocator.  `start`
    is the token offset of the edge's first block, so the edge covers
    tokens [start, start + len(hashes) * block_size).
    """
    hashes: List[str]
    start: int
    parent: Optional["RadixNode"]
    payloads: List[PyTree]
    block_ids: List[int]
    node_id: int
    children: Dict[str, "RadixNode"] = dataclasses.field(default_factory=dict)
    ref: int = 0
    tick: int = 0
    hits: int = 0


@dataclasses.dataclass
class PrefixMatch:
    """Result of `RadixTree.match_blocks`: the longest cached block-prefix
    of the query, as the root path of matched nodes plus their flattened
    per-block payloads."""
    n_tokens: int
    n_blocks: int
    nodes: List[RadixNode]
    payloads: List[PyTree]

    @property
    def has_payloads(self) -> bool:
        return all(p is not None for p in self.payloads)


class RadixTree:
    """Radix-tree prefix cache over paged KV blocks.

    - `match_blocks(tokens)` walks the cumulative-hash chain and returns
      the longest cached block-prefix, capped below `len(tokens)` so at
      least one suffix token is always left to prefill (the chunk
      programs need a real forward to produce last-token logits).
    - `lock/unlock(nodes)` pin a matched root path while a request seeds
      from it; eviction is leaf-only, so the locked path's deepest node
      is protected by its ref and every node above it by its children
      (a later `_split` of a locked node leaves the new parent
      unreferenced on purpose — lock holders release exactly the node
      objects they locked).
    - `insert(tokens, payload_fn)` adds the un-cached suffix blocks,
      allocating from the tree's own allocator (evicting unreferenced
      LRU leaves on pressure) — re-inserting a cached prefix is a no-op,
      and *only* real payload-bearing blocks are ever stored (no
      placeholder sentinel entries: interior prefixes are simply interior
      nodes of the tree).
    - `evict(n_blocks)` removes unreferenced LRU leaves until the target
      is met, freeing their blocks back to the pool.
    """

    def __init__(self, capacity_blocks: int = 4096, block_size: int = 16,
                 allocator: Optional[BlockAllocator] = None):
        self.block_size = block_size
        self.allocator = allocator if allocator is not None else \
            BlockAllocator(capacity_blocks, block_size)
        self._ids = itertools.count()
        self.root = RadixNode([], 0, None, [], [], next(self._ids))
        self._nodes: Dict[int, RadixNode] = {}
        self._tick = 0
        # hit statistics (scheduler cost model / TE routing)
        self.n_queries = 0
        self.query_blocks = 0
        self.hit_blocks = 0
        # pod-level directory coherence (set by PodKVDirectory.register)
        self.directory: Optional["PodKVDirectory"] = None
        self.owner_id: Optional[int] = None

    # -- introspection ------------------------------------------------

    def __len__(self) -> int:
        """Number of cached nodes (edges)."""
        return len(self._nodes)

    @property
    def n_cached_blocks(self) -> int:
        return self.allocator.used_blocks

    @property
    def hit_rate(self) -> float:
        """Fraction of queried blocks served from cache (lifetime)."""
        return self.hit_blocks / max(self.query_blocks, 1)

    def evictable_blocks(self) -> int:
        return sum(len(n.block_ids) for n in self._nodes.values()
                   if n.ref == 0)

    # -- matching -----------------------------------------------------

    def _match_cap(self, tokens: List[int]) -> int:
        # never match the whole prompt: reserve >= 1 token of suffix
        return max(len(tokens) - 1, 0) // self.block_size

    def match_fraction(self, tokens: List[int]) -> float:
        """Longest cached block-prefix fraction (read-only: no splits,
        no LRU/stat updates — safe to call from scheduler scoring loops)."""
        hs = hash_blocks(tokens, self.block_size)
        if not hs:
            return 0.0
        hit, node = 0, self.root
        while hit < len(hs):
            child = node.children.get(hs[hit])
            if child is None:
                break
            k = 0
            while (k < len(child.hashes) and hit + k < len(hs)
                   and child.hashes[k] == hs[hit + k]):
                k += 1
            hit += k
            if k < len(child.hashes):
                break
            node = child
        return hit / len(hs)

    def match_blocks(self, tokens: List[int]) -> PrefixMatch:
        """Longest cached block-prefix (mutating walk: splits a
        partially-matched edge so the returned path covers the match
        exactly, and touches LRU ticks / hit counters)."""
        hs_full = hash_blocks(tokens, self.block_size)
        hs = hs_full[:self._match_cap(tokens)]
        self.n_queries += 1
        self.query_blocks += len(hs_full)
        node, i, path = self.root, 0, []
        while i < len(hs):
            child = node.children.get(hs[i])
            if child is None:
                break
            k = 0
            while (k < len(child.hashes) and i + k < len(hs)
                   and child.hashes[k] == hs[i + k]):
                k += 1
            if k == 0:
                break
            if k < len(child.hashes):
                child = self._split(child, k)
            path.append(child)
            node, i = child, i + k
        self._tick += 1
        for n in path:
            n.tick = self._tick
            n.hits += 1
        self.hit_blocks += i
        payloads = [p for n in path for p in n.payloads]
        return PrefixMatch(i * self.block_size, i, path, payloads)

    def _split(self, node: RadixNode, k: int) -> RadixNode:
        """Split `node`'s edge after its k-th block; returns the new
        upper node (parent of the shortened `node`)."""
        # the upper node starts UNREFERENCED even when `node` is locked:
        # lock holders only know the original node objects, so a copied
        # ref could never be released. Leaf-only eviction keeps this
        # safe — upper has a child (node) and is not evictable until
        # the whole lower subtree (incl. any locked node) is gone.
        upper = RadixNode(node.hashes[:k], node.start, node.parent,
                          node.payloads[:k], node.block_ids[:k],
                          next(self._ids), tick=node.tick,
                          hits=node.hits)
        node.parent.children[node.hashes[0]] = upper
        node.hashes = node.hashes[k:]
        node.payloads = node.payloads[k:]
        node.block_ids = node.block_ids[k:]
        node.start += k * self.block_size
        node.parent = upper
        upper.children[node.hashes[0]] = node
        # re-home the allocator blocks that moved to the upper node
        moved = self.allocator._owned.get(node.node_id, [])
        keep = [b for b in moved if b in set(node.block_ids)]
        up = [b for b in moved if b not in set(node.block_ids)]
        if up:
            self.allocator._owned[node.node_id] = keep
            self.allocator._owned[upper.node_id] = up
        self._nodes[upper.node_id] = upper
        return upper

    # -- refcounts ----------------------------------------------------

    def lock(self, nodes: List[RadixNode]) -> None:
        """Pin a matched root path (call with `PrefixMatch.nodes`)."""
        for n in nodes:
            n.ref += 1

    def unlock(self, nodes: List[RadixNode]) -> None:
        for n in nodes:
            if n.ref <= 0:
                raise RuntimeError(
                    f"unlock of unreferenced radix node {n.node_id}")
            n.ref -= 1

    # -- insertion / eviction -----------------------------------------

    def insert(self, tokens: List[int],
               payload_fn: Optional[Callable[[int, int], PyTree]] = None
               ) -> int:
        """Cache `tokens`' full blocks; `payload_fn(start, end)` slices
        the KV pytree for one block's token range (None for an
        accounting-only tree, e.g. the sim's TE prefix directory).
        Returns the number of newly cached blocks."""
        hs = hash_blocks(tokens, self.block_size)
        node, i = self.root, 0
        while i < len(hs):
            child = node.children.get(hs[i])
            if child is None:
                break
            k = 0
            while (k < len(child.hashes) and i + k < len(hs)
                   and child.hashes[k] == hs[i + k]):
                k += 1
            if k == 0:
                break
            if k < len(child.hashes):
                if i + k == len(hs):
                    return 0  # fully matched mid-edge: nothing new
                child = self._split(child, k)
            node, i = child, i + k
        if i >= len(hs):
            self._tick += 1
            node.tick = self._tick
            return 0
        # allocate blocks for the new suffix, evicting LRU on pressure;
        # store only as many blocks as the pool can hold
        want = len(hs) - i
        have = self._ensure_blocks(want)
        if have <= 0:
            return 0
        nid = next(self._ids)
        block_ids = self.allocator.allocate(nid, have * self.block_size)
        bs = self.block_size
        payloads = [payload_fn(b * bs, (b + 1) * bs)
                    if payload_fn is not None else None
                    for b in range(i, i + have)]
        new = RadixNode(hs[i:i + have], i * bs, node, payloads, block_ids,
                        nid)
        node.children[new.hashes[0]] = new
        self._nodes[nid] = new
        self._tick += 1
        new.tick = self._tick
        if self.directory is not None:
            self.directory._publish(self.owner_id, new.hashes,
                                    new.block_ids)
        return have

    def _ensure_blocks(self, want: int) -> int:
        """Evict until `want` blocks fit (or nothing evictable is left);
        returns how many blocks can actually be allocated."""
        want = min(want, self.allocator.n_blocks)
        if want > self.allocator.free_blocks:
            self.evict(want - self.allocator.free_blocks)
        return min(want, self.allocator.free_blocks)

    def evict(self, n_blocks: int) -> int:
        """Remove unreferenced LRU leaves until >= n_blocks are freed (or
        no candidates remain); never touches a referenced node.  Returns
        blocks actually freed."""
        freed = 0
        while freed < n_blocks:
            victim = None
            for n in self._nodes.values():
                if n.ref == 0 and not n.children:
                    if victim is None or n.tick < victim.tick:
                        victim = n
            if victim is None:
                break
            freed += self._remove(victim)
        return freed

    def _remove(self, node: RadixNode) -> int:
        assert node.ref == 0 and not node.children
        node.parent.children.pop(node.hashes[0], None)
        del self._nodes[node.node_id]
        if self.directory is not None:
            self.directory._retract(self.owner_id, node.hashes)
        if node.block_ids:
            return self.allocator.free(node.node_id)
        return 0

    def clear(self) -> None:
        for n in list(self._nodes.values()):
            n.ref = 0
        self.evict(1 << 60)  # leaves first; loop re-leafs parents


@dataclasses.dataclass
class RemotePin:
    """Lock token for a cross-DP prefix reference.

    Holds the owner's matched root path locked (through the owner tree's
    refcounts) while a remote DP reads the stored KV over UB global
    shared memory and seeds its partial-prefill cache from it.  Released
    exactly once via `PodKVDirectory.release` — a second release raises
    `DoubleFree`, mirroring the allocator's double-free guard."""
    owner: int
    nodes: List[RadixNode]
    payloads: List[PyTree]
    n_blocks: int
    n_tokens: int
    released: bool = False

    @property
    def has_payloads(self) -> bool:
        return bool(self.payloads) and \
            all(p is not None for p in self.payloads)


class PodKVDirectory:
    """Pod-level KV block directory over UB global shared memory.

    CloudMatrix-Infer pools prefix KV pod-wide: any NPU can read any
    cached prefix at microsecond latency over the UB plane, so a
    multi-turn session that re-lands on a different DP seeds from the
    previous DP's blocks instead of re-prefilling.  This directory is
    the control-plane half of that: it maps *cumulative block hashes*
    (`hash_blocks` keys — hash equality implies token-prefix equality)
    to the set of owning DPs and their backing block ids, kept coherent
    with per-DP insert/evict through publish/retract hooks wired by
    `register`.

    A remote reference pins the owner's blocks through the owner tree's
    existing refcounted lock/unlock (`acquire` → `RemotePin` →
    `release`): leaf-only eviction can therefore never remove a
    remotely-pinned path, exactly as it cannot remove a locally locked
    one.  The directory is keyed by hash rather than node id because
    `RadixTree._split` re-homes blocks across node ids but never changes
    a block's cumulative hash.
    """

    def __init__(self, block_size: int = 16):
        self.block_size = block_size
        self._trees: Dict[int, RadixTree] = {}
        # unregistered owners' trees, kept only so outstanding remote
        # pins can still be released exactly once
        self._dead_trees: Dict[int, RadixTree] = {}
        # cumulative block hash -> {owner id: backing block id}
        self._entries: Dict[str, Dict[int, int]] = {}
        self.n_remote_acquires = 0
        self.n_releases = 0

    def __len__(self) -> int:
        """Number of distinct block hashes published pod-wide."""
        return len(self._entries)

    def register(self, owner: int, tree: RadixTree) -> None:
        """Wire a per-DP tree into the directory: existing nodes are
        published, and future insert/evict publish/retract through the
        tree's coherence hooks."""
        if owner in self._trees:
            raise ValueError(f"owner {owner} already registered")
        if tree.directory is not None:
            raise ValueError("tree already registered with a directory")
        tree.directory = self
        tree.owner_id = owner
        self._trees[owner] = tree
        for node in tree._nodes.values():
            self._publish(owner, node.hashes, node.block_ids)

    def unregister(self, owner: int) -> None:
        """Tear an owner out of the directory (pod-level failure
        domain): every hash it published is retracted — future matches
        can no longer land on the dead owner's blocks — and the tree is
        unhooked from the coherence hooks. Outstanding :class:`RemotePin`
        objects against the owner stay release-safe (the tree is kept
        reachable for :meth:`release`), but callers should release them
        promptly: the pinned data is gone."""
        tree = self._trees.pop(owner, None)
        if tree is None:
            return
        tree.directory = None
        self._dead_trees[owner] = tree
        for h in list(self._entries):
            owners = self._entries[h]
            owners.pop(owner, None)
            if not owners:
                del self._entries[h]

    # -- coherence hooks (called by RadixTree insert / _remove) -------

    def _publish(self, owner: int, hashes: List[str],
                 block_ids: List[int]) -> None:
        ids = block_ids if len(block_ids) == len(hashes) else \
            [-1] * len(hashes)
        for h, b in zip(hashes, ids):
            self._entries.setdefault(h, {})[owner] = b

    def _retract(self, owner: int, hashes: List[str]) -> None:
        for h in hashes:
            owners = self._entries.get(h)
            if owners is not None and owner in owners:
                del owners[owner]
                if not owners:
                    del self._entries[h]

    # -- lookup / remote pinning --------------------------------------

    def match(self, tokens: List[int],
              exclude: Optional[Any] = None) -> Tuple[Optional[int], int]:
        """Longest published block-prefix of `tokens` held by a single
        owner (the read must be a contiguous range from one DP's
        blocks).  Returns `(owner, n_blocks)` — `(None, 0)` on a miss.
        `exclude` drops owners from consideration: a single owner id or
        a collection of them (a whole TE's DPs during routing).
        Read-only and deterministic (ties break to the lowest owner id);
        capped below `len(tokens)` like `RadixTree._match_cap`, so at
        least one suffix token is always left to prefill."""
        cap = max(len(tokens) - 1, 0) // self.block_size
        hs = hash_blocks(tokens, self.block_size)[:cap]
        return self._longest(hs, exclude)

    def _longest(self, hs: List[str],
                 exclude: Optional[Any]) -> Tuple[Optional[int], int]:
        excl = (set() if exclude is None
                else {exclude} if isinstance(exclude, int)
                else set(exclude))
        if not hs:
            return None, 0
        first = self._entries.get(hs[0])
        if not first:
            return None, 0
        best_owner, best = None, 0
        for owner in sorted(first):
            if owner in excl:
                continue
            n = 0
            while n < len(hs) and owner in self._entries.get(hs[n], ()):
                n += 1
            if n > best:
                best_owner, best = owner, n
        return best_owner, best

    def match_fraction(self, tokens: List[int],
                       exclude: Optional[Any] = None) -> float:
        """Pod-wide cached block-prefix fraction (scheduler scoring).
        Like ``RadixTree.match_fraction``, the read-only fraction is
        UNCAPPED — raw coverage, not the acquirable block count."""
        hs = hash_blocks(tokens, self.block_size)
        if not hs:
            return 0.0
        _, n = self._longest(hs, exclude)
        return n / len(hs)

    def acquire(self, owner: int,
                tokens: List[int]) -> Optional[RemotePin]:
        """Pin the owner's longest cached prefix of `tokens` for a
        cross-DP read: matches on the owner's tree (splitting edges so
        the locked path covers the match exactly) and takes a refcount
        on every node of the path.  Returns None when the owner no
        longer caches any prefix (raced with eviction)."""
        tree = self._trees.get(owner)
        if tree is None:
            return None
        m = tree.match_blocks(tokens)
        if m.n_blocks == 0:
            return None
        tree.lock(m.nodes)
        self.n_remote_acquires += 1
        return RemotePin(owner, m.nodes, m.payloads, m.n_blocks,
                         m.n_tokens)

    def release(self, pin: RemotePin) -> None:
        """Drop a remote pin (exactly once; double-release raises)."""
        if pin.released:
            raise DoubleFree(
                f"remote pin on owner {pin.owner} already released")
        pin.released = True
        tree = self._trees.get(pin.owner) \
            or self._dead_trees[pin.owner]
        tree.unlock(pin.nodes)
        self.n_releases += 1


# Backwards-compatible name: the RTC role is now radix-backed.
PrefixCache = RadixTree
