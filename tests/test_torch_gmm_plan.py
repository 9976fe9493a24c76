"""The grouped expert FFN's launch plan (``gmm/kernel.py::plan``), a
mirror of ``gmm_launch``'s choices in ``csrc/gmm.cu``, and a model of the
kernel's walk: ``plan_kernel``'s live (slot, row tile) pairs crossed
with the column tiles of ``item_of``, at the capacities the paths pack
and off them (DeepSeek-MoE-16B C 9-144, DeepSeek-V3 C 4, 20 and 24,
Llama-4 C 4, 5 and 8, and C 12 and 16 either side of the tiles). By that
walk every (slot, live row, output column) is written exactly once in
both passes, and each live slot's expert is staged once per column tile
while its rows fit one 128-row tile; C <= 8 keeps the 8-row mma.sync
tile. The plan's constants are read back from the CUDA source. A numpy
emulation of the wgmma variant's order (float32 sums of 16-deep products
in K order, the hidden cast to bf16) holds within 3e-2 of the port's
plain version and of the JAX Pallas kernel in interpret mode."""
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
MODELS = {"deepseek-moe-16b": (64, 2048, 1408, (9, 12, 16, 18, 24, 36, 72,
                                                144)),
          "deepseek-v3": (256, 7168, 2048, (4, 20, 24)),
          "llama-4": (128, 5120, 8192, (4, 5, 8))}
CASES = [(m, C) for m, (_, _, _, caps) in MODELS.items() for C in caps]
H100_SMEM = 232448          # shared memory a block can use


def _rows(S, C, seed):
    """Live rows per slot: empty, full, partial, and (C > 128) past one
    tile."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, C + 1, S)
    rows[:3] = (0, C, 1)
    return rows


def _walk(p, rows, C, n_cols, which):
    """The items of one pass as the kernel walks them: plan_kernel's
    pairs s * rt + j (slot-major, one per live row tile), each crossed
    with the column tiles. Returns the writes per (slot, row, column) and
    the items as (slot, r0, nr, n0)."""
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


@pytest.mark.parametrize("model,C", CASES)
def test_walk_writes_every_live_element_once(model, C):
    E, d, f, _ = MODELS[model]
    p = K.plan(E, C, d, f, BF16)
    rows = _rows(E, C, C)
    live = np.arange(C)[None, :] < rows[:, None]
    for which, (n_cols, k) in enumerate(((f, d), (d, f))):
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
    if C <= K.MMA_MAX_C:
        # today's tile: 8 rows on mma.sync, a 4-stage cp.async ring of
        # 64-deep weight tiles and 8 rows padded by 16 bytes
        assert p == K.Plan("mma", 8, 1, 8, (-(-f // 128), -(-d // 128)),
                           (-(-d // 64), -(-f // 64)),
                           (2 * 64 * 256 + 8 * 144, 64 * 256 + 8 * 144),
                           (4, 4))
        return
    assert p.variant == "wgmma" and p.rows == K.WG_ROWS == 128
    assert p.row_tiles == -(-C // 128)
    # the narrowest compiled width holding a tile's rows
    assert p.nb == min(w for w in K.WG_WIDTHS if w >= min(C, 128))
    for stage, stages in zip(p.stage_bytes, p.stages):
        assert 4 <= stages <= 8 and stage % 1024 == 0
        assert stages * stage + 1024 + 16 * stages <= H100_SMEM


def test_float32_plan():
    p = K.plan(16, 36, 2048, 1408, torch.float32)
    assert (p.variant, p.rows, p.row_tiles, p.nb) == ("f32", 8, 5, 8)


def test_plan_constants_match_the_cuda_source():
    """The mirror's numbers are the source's: the switch at C <= 8, the
    wgmma widths gmm_launch dispatches on, the row tile, the ring, the
    column and reduction tiles."""
    src = (runtime.CSRC / "gmm.cu").read_text()
    launch = src[src.index('extern "C" int gmm_launch'):]
    assert f"if (C <= {K.MMA_MAX_C})\n    return launch_bf16<1>" in launch
    widths = [int(w) for w in re.findall(r"launch_bf16_wg<(\d+)>", launch)]
    assert tuple(widths) == K.WG_WIDTHS
    assert [int(c) for c in re.findall(r"if \(C <= (\d+)\)\n    return "
                                       r"launch_bf16_wg", launch)] == list(
        K.WG_WIDTHS[:-1])

    def define(name):
        return re.search(rf"#define {name} \(?(\d+)", src).group(1)
    assert int(define("WG_RT")) == K.WG_ROWS
    assert int(define("WG_BK")) == int(define("TC_BK")) == K._BK
    assert int(define("TC_BN")) == K._BN
    assert int(define("WG_RING")) * 1024 == K._WG_RING
    assert int(define("F32_ROWS")) == K._F32_ROWS
    assert int(define("F32_KCHUNK")) == K._F32_KCHUNK


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        BF16).float().numpy()


def _emulate(b, wg, wu, wd):
    """The wgmma variant's arithmetic on bf16-valued float32 arrays: each
    output a float32 sum, in K order, of 16-deep blocks of exact
    products; the hidden cast to bf16 between the passes."""
    def mm(x, w):
        acc = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for k0 in range(0, x.shape[1], 16):
            acc += x[:, k0:k0 + 16] @ w[k0:k0 + 16]
        return acc
    out = np.zeros(b.shape, np.float32)
    for s in range(b.shape[0]):
        g, u = mm(b[s], wg[s]), mm(b[s], wu[s])
        h = _bf16(g / (1 + np.exp(-g)) * u)
        out[s] = mm(h, wd[s])
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
