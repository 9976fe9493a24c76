"""The grouped expert FFN's launch plan (``gmm/kernel.py::plan``), a
mirror of ``gmm_launch``'s choices in ``csrc/gmm.cu``, and a model of the
kernel's walk, at the capacities the paths pack and off them
(DeepSeek-MoE-16B C 4 and 9-144, DeepSeek-V3 C 4, 20 and 24, Llama-4
C 4, 5 and 8, and C 12 and 16 either side of the tiles). Above C 8 the
walk is ``plan_kernel``'s live (slot, row tile) pairs crossed with the
column tiles of ``item_of``: every (slot, live row, output column) is
written exactly once in both passes, and each live slot's expert is
staged once per column tile while its rows fit one 128-row tile. At C <= 8
(one 8-row tile a slot, the K reduction cut into ``plan.splits`` fixed
ranges) the walk deals whole units round robin and cuts the leftover
units into pieces of ``piece_len`` ranges; at one live slot and at the
live counts the paths reach, every live element is written once (one
merge for a split unit), every (unit, 64-deep step) of weights is read
once, every unit folds its ranges in range order whatever the live
count, and one live slot gives each pass at least 132 (unit, range)
items. The plan's constants and formulas are read back from the CUDA
source. Numpy emulations of the wgmma order (float32 sums of 16-deep
products in K order, at C <= 8 within each K range and the range sums
folded in range order; the hidden cast to bf16) hold within 3e-2 of the
port's plain version and of the JAX Pallas kernel in interpret mode."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import ops as jops
from repro_torch.kernels import runtime
from repro_torch.kernels.gmm import kernel as K
from repro_torch.kernels.gmm.ref import gmm_ref
from torch_parity import one_thread, to_np  # noqa: F401

BF16 = torch.bfloat16
#: name → (experts, d, f, capacities)
MODELS = {"deepseek-moe-16b": (64, 2048, 1408, (4, 9, 12, 16, 18, 24, 36,
                                                72, 144)),
          "deepseek-v3": (256, 7168, 2048, (4, 20, 24)),
          "llama-4": (128, 5120, 8192, (4, 5, 8))}
CASES = [(m, C) for m, (_, _, _, caps) in MODELS.items() for C in caps]
#: (model, C, live slots) at C <= 8: one live slot, and the live counts of
#: the paths' decode packs and short chunks (DeepSeek-MoE-16B 63 of 64 at
#: its 32-token chunk; DeepSeek-V3 29 at decode, 229 at a 64-token chunk;
#: Llama-4 4 at decode, 128 at its 512- and 826-token chunks)
NARROW_CASES = ([("deepseek-moe-16b", 4, n) for n in (1, 21, 63)]
                + [("deepseek-v3", 4, n) for n in (1, 29, 229)]
                + [("llama-4", C, n) for C in (4, 5, 8) for n in (1, 4, 128)])
H100_SMEM = 232448          # shared memory a block can use
N_SMS = 132                 # the persistent grid of one block an SM


def _rows(S, C, seed):
    """Live rows per slot: empty, full, partial, and (C > 128) past one
    tile."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, C + 1, S)
    rows[:3] = (0, C, 1)
    return rows


def _walk(p, rows, C, n_cols, which):
    """The items of one pass above C 8 as the kernel walks them:
    plan_kernel's pairs s * rt + j (slot-major, one per live row tile),
    each crossed with the column tiles. Returns the writes per (slot, row,
    column) and the items as (slot, r0, nr, n0)."""
    rt, RT, nct = p.row_tiles, p.rows, p.col_tiles[which]
    pairs = [s * rt + j for s in range(len(rows))
             for j in range(-(-int(rows[s]) // RT))]
    writes = np.zeros((len(rows), C, n_cols), np.uint8)
    items = []
    for i in range(len(pairs) * nct):
        pr = pairs[i // nct]
        s, r0 = pr // rt, (pr % rt) * RT
        nr, n0 = min(RT, int(rows[s]) - r0), (i % nct) * K._BN
        writes[s, r0:r0 + nr, n0:min(n0 + K._BN, n_cols)] += 1
        items.append((s, r0, nr, n0))
    return writes, items


def _narrow_walk(p, rows, C, n_cols, which, G=N_SMS):
    """The C <= 8 walk of one pass on G blocks, as ``wg_pass<NW, 8>``
    takes it: units u = (live slot u // nct, column tile u % nct), the
    first rounds * G whole (unit b + q G to block b), the U2 left over cut
    into pieces of L ranges (piece b + q G to block b; piece p = k U2 + v:
    ranges [k L, k L + L) of unit rounds G + v), each block's pieces
    first. A piece from range 0 folds its ranges in registers; the others'
    range sums go to the scratch, and the piece completing the unit's
    ticket folds them. Returns the writes per (slot, row, column), the
    loads per (unit, step), each unit's fold order, the 64-deep steps
    each block streams and the busy blocks."""
    nct, nk, ns = p.col_tiles[which], p.k_steps[which], p.splits[which]
    live = [s for s in range(len(rows)) if rows[s] > 0]
    U = len(live) * nct
    rounds, U2 = divmod(U, G)
    L = K.piece_len(U2, ns, nk, G, (2, 1)[which])
    npieces = U2 * -(-ns // L)
    writes = np.zeros((len(rows), C, n_cols), np.uint8)
    loads = np.zeros((U, nk), np.uint8)
    order = {u: [] for u in range(U)}
    tick = np.zeros(U, np.int64)
    held = {}                                  # unit -> ranges in scratch
    steps = np.zeros(G, np.int64)

    def store(u):
        s, n0 = live[u // nct], (u % nct) * K._BN
        writes[s, :int(rows[s]), n0:min(n0 + K._BN, n_cols)] += 1

    tasks = [[] for _ in range(G)]
    for b in range(G):
        for pc in range(b, npieces, G):
            r0 = pc // U2 * L
            tasks[b].append((rounds * G + pc % U2, r0, min(ns, r0 + L)))
        tasks[b] += [(b + q * G, 0, ns) for q in range(rounds)]
    for q in range(max(map(len, tasks))):      # the blocks in lockstep
        for b in range(G):
            if q >= len(tasks[b]):
                continue
            u, r0, r1 = tasks[b][q]
            for kt in range(r0 * nk // ns, r1 * nk // ns):
                loads[u, kt] += 1
                steps[b] += 1
            if r1 - r0 == ns:
                order[u] += list(range(ns))
                store(u)
                continue
            held.setdefault(u, {}).update(
                {r0: list(range(r0, r1))} if r0 == 0
                else {r: [r] for r in range(r0, r1)})
            tick[u] += r1 - r0
            if tick[u] == ns:                  # this piece merges
                parts = held.pop(u)
                order[u] += [r for k in sorted(parts) for r in parts[k]]
                store(u)
    busy = int((steps > 0).sum())
    return writes, loads, order, steps, busy


def _live_rows(E, C, n, seed):
    """n live slots of 1..C rows (full at one live slot), the rest empty."""
    rng = np.random.default_rng(seed)
    rows = np.zeros(E, np.int64)
    on = rng.choice(E, n, replace=False)
    rows[on] = C if n == 1 else rng.integers(1, C + 1, n)
    return rows


@pytest.mark.parametrize("model,C", CASES)
def test_walk_writes_every_live_element_once(model, C):
    E, d, f, _ = MODELS[model]
    p = K.plan(E, C, d, f, BF16)
    rows = _rows(E, C, C)
    live = np.arange(C)[None, :] < rows[:, None]
    for which, (n_cols, k) in enumerate(((f, d), (d, f))):
        if C <= K.NARROW_C:
            writes = _narrow_walk(p, rows, C, n_cols, which)[0]
            assert (writes[live] == 1).all() and (writes[~live] == 0).all()
            continue
        writes, items = _walk(p, rows, C, n_cols, which)
        assert (writes[live] == 1).all() and (writes[~live] == 0).all()
        # every item's rows fit its staged rows, and its columns the pass
        assert all(nr <= p.nb and nr > 0 for _, _, nr, _ in items)
        assert p.col_tiles[which] * K._BN >= n_cols > (
            p.col_tiles[which] - 1) * K._BN
        assert p.k_steps[which] == -(-k // K._BK)


@pytest.mark.parametrize("model,C", CASES)
def test_each_live_expert_staged_once_per_column_tile(model, C):
    """While a slot's rows fit one row tile, each (slot, column tile) is
    one item: the expert's stripe is staged once, and the weight bytes
    staged over both passes are the bound's, 3 d f x 2 B a live slot."""
    E, d, f, _ = MODELS[model]
    p = K.plan(E, C, d, f, BF16)
    rows = _rows(E, C, 7 * C)
    staged = 0
    for which, (n_cols, nw) in enumerate(((f, 2), (d, 1))):
        if C <= K.NARROW_C:   # one 8-row tile a slot: each step read once
            loads = _narrow_walk(p, rows, C, n_cols, which)[1]
            assert (loads == 1).all()
            staged += loads.size * K._BK * K._BN * 2 * nw
            continue
        _, items = _walk(p, rows, C, n_cols, which)
        per = {}
        for s, _, _, n0 in items:
            per[s, n0] = per.get((s, n0), 0) + 1
        for (s, _), n in per.items():
            assert n == -(-int(rows[s]) // p.rows)
            assert n == 1 or rows[s] > K.WG_ROWS
        staged += len(items) * p.k_steps[which] * K._BK * K._BN * 2 * nw
    tiles = sum(-(-int(r) // p.rows) for r in rows)
    assert staged == tiles * 3 * d * f * 2
    if C <= K.WG_ROWS:
        assert staged == int((rows > 0).sum()) * 3 * d * f * 2


@pytest.mark.parametrize("model,C", CASES)
def test_variant_and_tiles(model, C):
    E, d, f, _ = MODELS[model]
    p = K.plan(E, C, d, f, BF16)
    assert p.variant == "wgmma"
    # the narrowest compiled width holding a tile's rows
    assert p.nb == min(w for w in K.WG_WIDTHS if w >= min(C, 128))
    assert p.col_tiles == (-(-f // 128), -(-d // 128))
    assert p.k_steps == (-(-d // 64), -(-f // 64))
    if C <= K.NARROW_C:
        # one 8-row tile a slot (a 1024-byte swizzle atom of rows), the K
        # reduction in the fixed ranges of split (two steps or more each)
        assert (p.rows, p.row_tiles, p.nb) == (8, 1, 8)
        assert p.splits == (K.split(f, d, 2), K.split(d, f, 1))
        assert all(2 * ns <= nk for ns, nk in zip(p.splits, p.k_steps))
    else:
        assert p.rows == K.WG_ROWS == 128 and p.splits == (1, 1)
        assert p.row_tiles == -(-C // 128)
    for stage, stages in zip(p.stage_bytes, p.stages):
        assert 4 <= stages <= 8 and stage % 1024 == 0
        assert stages * stage + 1024 + 16 * stages <= H100_SMEM


@pytest.mark.parametrize("model,C,n", NARROW_CASES)
def test_narrow_walk(model, C, n):
    """The C <= 8 walk at a path's live count: every live element written
    once (a split unit by one merge), every (unit, 64-deep step) of the
    live experts' weights read once, every unit's ranges folded in range
    order (the same whatever the live count), no block streaming more
    than the even share of the steps plus one piece; one live slot gives
    each pass at least 132 (unit, range) items, dealt to 96 or more of
    the 132 SMs."""
    E, d, f, _ = MODELS[model]
    p = K.plan(E, C, d, f, BF16)
    rows = _live_rows(E, C, n, 100 * C + n)
    live = np.arange(C)[None, :] < rows[:, None]
    for which, n_cols in enumerate((f, d)):
        writes, loads, order, steps, busy = _narrow_walk(
            p, rows, C, n_cols, which)
        assert (writes[live] == 1).all() and (writes[~live] == 0).all()
        assert (loads == 1).all() and loads.shape == (n * p.col_tiles[which],
                                                      p.k_steps[which])
        ns, nk = p.splits[which], p.k_steps[which]
        assert all(o == list(range(ns)) for o in order.values())
        U2 = loads.shape[0] % N_SMS
        L = K.piece_len(U2, ns, nk, N_SMS, (2, 1)[which])
        piece = -(-L * nk // ns)
        assert steps.max() <= -(-loads.size // N_SMS) + piece
        if n == 1:
            assert p.col_tiles[which] * ns >= N_SMS
            assert busy >= 96


@pytest.mark.parametrize("model", list(MODELS))
def test_work_buffer(model):
    """``work_ints``: rows, count and pairs as above C 8; at C <= 8 a
    ticket a (slot, column tile), then the partial sums from a 128-byte
    boundary, room for the (blocks - 1) ns pieces of the pass with more
    (fewer than one unit a block is ever split)."""
    E, d, f, _ = MODELS[model]
    for C in (4, 8, 9):
        n = E + 1 + E * C
        got = K.work_ints(E, C, d, f, BF16)
        if C > K.NARROW_C:
            assert got == n and K.work_ints(E, C, d, f, torch.float32) == n
            continue
        p = K.plan(E, C, d, f, BF16)
        start = -(-(n + E * max(p.col_tiles)) // 32) * 32
        assert start % 32 == 0 and start >= n + E * max(p.col_tiles)
        assert got - start == max(
            (N_SMS - 1) * ns * nw * 1024 for ns, nw in zip(p.splits, (2, 1)))


def test_float32_plan():
    p = K.plan(16, 36, 2048, 1408, torch.float32)
    assert (p.variant, p.rows, p.row_tiles, p.nb) == ("f32", 8, 5, 8)


def test_plan_constants_match_the_cuda_source():
    """The mirror's numbers and formulas are the source's: the widths
    gmm_launch dispatches on (8 up to C 8), the row tiles, the ring, the
    column and reduction tiles, the K split
    (wg_split: ranges of two steps or more, WG_FILL items, within 5% of
    the least), the piece cost and the work buffer's layout."""
    src = (runtime.CSRC / "gmm.cu").read_text()
    launch = src[src.index('extern "C" int gmm_launch'):]
    widths = [int(w) for w in re.findall(r"launch_bf16_wg<(\d+)>", launch)]
    assert tuple(widths) == K.WG_WIDTHS
    assert [int(c) for c in re.findall(r"if \(C <= (\d+)\)\n    return "
                                       r"launch_bf16_wg", launch)] == list(
        K.WG_WIDTHS[:-1])
    assert "tc_pass" not in src and "mma.sync" not in src

    def define(name):
        return re.search(rf"#define {name} \(?(\d+)", src).group(1)
    assert int(define("WG_RT")) == K.WG_ROWS
    assert int(define("WG_NARROW")) == K.NARROW_C == K.WG_WIDTHS[0]
    assert int(define("WG_FILL")) == K.WG_FILL == N_SMS
    assert int(define("WG_BK")) == K._BK
    assert int(define("WG_BN")) == K._BN
    assert int(define("WG_RING")) * 1024 == K._WG_RING
    assert int(define("F32_ROWS")) == K._F32_ROWS
    assert int(define("F32_KCHUNK")) == K._F32_KCHUNK
    # wg_piece_cost, wg_split's range floor and tolerance, the work layout
    assert ("const int pieces = U2 * ((ns + L - 1) / L);\n"
            "  return (pieces + G - 1) / G * (NW * ((L * nk + ns - 1) / ns) "
            "+ 8);") in src
    assert "const int top = nk / 2 > 1 ? nk / 2 : 1;" in src
    assert "20 * best(ns) <= 21 * least" in src
    assert "wg_split(f, d, 2), ns2 = wg_split(d, f, 1)" in src
    assert "(w->tick + (long long)S * w->tick_per_slot + 31) / 32 * 32" in src
    assert "ns1 > 1 ? (long long)(g1 - 1) * ns1 * 2 * 1024 : 0" in src
    assert "ns2 > 1 ? (long long)(g2 - 1) * ns2 * 1024 : 0" in src


def test_split_rule():
    """``split`` at the served shapes: at least 132 (unit, range) items at
    one live slot, ranges of two steps or more, and a time at one live
    slot within 5% of the best split's; the fallback where K is short."""
    for E, d, f, _ in MODELS.values():
        for N, Kd, nw in ((f, d, 2), (d, f, 1)):
            ns = K.split(N, Kd, nw)
            nct, nk = -(-N // 128), -(-Kd // 64)
            assert nct * ns >= K.WG_FILL and 2 * ns <= nk

            def best(x):
                return min(K.piece_cost(nct, x, nk, N_SMS, nw, L)
                           for L in range(1, x + 1))
            least = min(best(x) for x in range(1, nk // 2 + 1)
                        if nct * x >= K.WG_FILL)
            assert 20 * best(ns) <= 21 * least
    assert K.split(200, 72, 2) == 1 and K.split(136, 200, 1) == 2


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def _emulate(b, wg, wu, wd, splits=(1, 1)):
    """The wgmma variant's arithmetic on bf16-valued float32 arrays: each
    output a float32 sum, in K order, of 16-deep blocks of exact
    products, within each of a pass's K ranges (C <= 8: ``plan.splits``,
    the ranges of 64-deep steps r nk / ns .. (r + 1) nk / ns), the range
    sums folded in range order; the hidden cast to bf16 between the
    passes."""
    def mm(x, w, ns):
        nk = -(-x.shape[1] // 64)
        total = None
        for r in range(ns):
            acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
            for k0 in range(r * nk // ns * 64,
                            min(x.shape[1], (r + 1) * nk // ns * 64), 16):
                acc += x[:, k0:k0 + 16] @ w[k0:k0 + 16]
            total = acc if total is None else total + acc
        return total
    out = np.zeros(b.shape, np.float32)
    for s in range(b.shape[0]):
        g, u = mm(b[s], wg[s], splits[0]), mm(b[s], wu[s], splits[0])
        h = _bf16(g / (1 + np.exp(-g)) * u)
        out[s] = mm(h, wd[s], splits[1])
    return out


@pytest.mark.parametrize("C", [12, 36, 72, 144])
def test_wgmma_order_within_bf16_bar(C):
    E, d, f = 3, 64, 128
    rng = np.random.default_rng(C)
    b = (rng.standard_normal((E, C, d)) * 0.3).astype(np.float32)
    b[:, C * 2 // 3:] = 0.0                 # rows past the live ones
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    b, *ws = (_bf16(a) for a in (b, *ws))
    got = _emulate(b, *ws)
    plain = gmm_ref(*(torch.from_numpy(a) for a in (b, *ws)))
    np.testing.assert_allclose(got, to_np(plain), rtol=3e-2, atol=3e-2)
    want = jops.expert_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in (b, *ws)),
                           use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, to_np(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("C,d,f", [(4, 256, 384), (5, 320, 1408),
                                   (8, 1024, 256)])
def test_narrow_order_within_bf16_bar(C, d, f):
    """The C <= 8 order (the plan's K ranges, their sums folded in range
    order) on every row of a few slots, one of them all zero, within 3e-2
    of the plain version and of the Pallas kernel in interpret mode."""
    E = 3
    p = K.plan(E, C, d, f, BF16)
    assert p.splits[0] > 1 and p.splits[1] > 1
    rng = np.random.default_rng(C * d)
    b = (rng.standard_normal((E, C, d)) * 0.3).astype(np.float32)
    b[1] = 0.0                              # an empty slot
    b[2, C // 2:] = 0.0                     # rows past the live ones
    ws = [(rng.standard_normal(s) / s[1] ** 0.5).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    b, *ws = (_bf16(a) for a in (b, *ws))
    got = _emulate(b, *ws, splits=p.splits)
    assert (got[1] == 0).all() and not np.signbit(got[1]).any()
    plain = gmm_ref(*(torch.from_numpy(a) for a in (b, *ws)))
    np.testing.assert_allclose(got, to_np(plain), rtol=3e-2, atol=3e-2)
    want = jops.expert_ffn(*(jnp.asarray(a, jnp.bfloat16) for a in (b, *ws)),
                           use_pallas=True, interpret=True)
    np.testing.assert_allclose(got, to_np(want), rtol=3e-2, atol=3e-2)
