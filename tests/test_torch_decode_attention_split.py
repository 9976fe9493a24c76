"""A plain model of how the CUDA decode-attention kernel partitions the
cache, held against the plain version and the JAX package's op.

The kernel (``csrc/decode_attention.cu``) walks each (batch row, KV
head) in ``n_split`` ranges of ``split_len`` slots (``split_plan``),
keeps an unnormalised (m, l, acc) per range with ``p`` cast to the value
type inside the range, and merges the ranges by log-sum-exp weights in
range order, in the same launch: inside one thread-block cluster where
``n_split`` is 2-8 (block j merging elements [j GD / n, (j + 1) GD / n)
of its group), by the last block to take a ticket where it is larger.
Both merges take the same sums in the same order. :func:`partitioned`
is that arithmetic in PyTorch, one range at a time; on the cases of
``tests/test_torch_decode_attention.py`` it must agree with
``decode_attention_ref`` and with the JAX op (the Pallas kernel in
interpret mode) within 2e-4 in float32 and 3e-2 in bf16, under the plan
of a 132-SM card and of a 4-SM one (more, shorter ranges). A NaN in a
masked slot (a stale cache tail past the row's position) must not reach
the output: it is held against the same inputs with that tail zeroed.

A KV head's query heads are split into groups of at most one warp set
of heads (``max(8, 1024 // hd)``), two sets at hd 256 (``head_groups``),
one block per (range, group): at RecurrentGemma's decode shape (hd 256,
10 query heads on one KV head, a ring of 2048 slots) one group of 10.
``block_work`` is the kernel's own index arithmetic of a block and
``merge_work`` the cluster merge's; under the plan every (row, query
head, slot) is walked by exactly one block, in ring mode and not, every
output element is merged once, and the partition by groups gives the
plain version's output, at the decode shapes of the served paths too."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_op
from repro_torch.kernels.decode_attention.kernel import (
    BLOCKS_PER_SM, block_work, head_groups, merge_work, plan, split_plan)
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      valid_slots)
from test_torch_decode_attention import CASES, TOL, _inputs


def partitioned(q, k, v, positions, *, window=0, n_sms=132):
    """The kernel's partition of the cache and of the query heads, as
    plain PyTorch."""
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    p = plan(B, H, KV, hd, L, n_sms, q.dtype)
    outs = [_partitioned_group(q.reshape(B, KV, G, hd)[:, :, g0:g0 + p[
        "gpb"]], k, v, positions, window, p["split_len"], p["n_split"])
        for g0 in range(0, G, p["gpb"])]
    return torch.cat(outs, dim=2).reshape(B, H, hd)


def _partitioned_group(qg, k, v, positions, window, split_len, n_split):
    """One head group [B, KV, g, hd] over the plan's slot ranges:
    (m, l, acc) per range, merged by log-sum-exp weights in order."""
    hd, L = qg.shape[-1], k.shape[1]
    valid = valid_slots(positions, L, window)
    qr = qg.float()
    ms, ls, accs = [], [], []
    for j in range(n_split):
        lo, hi = j * split_len, min(L, (j + 1) * split_len)
        ok = valid[:, lo:hi]
        kj = torch.where(ok[:, :, None, None], k[:, lo:hi],
                         torch.zeros((), dtype=k.dtype))
        vj = torch.where(ok[:, :, None, None], v[:, lo:hi],
                         torch.zeros((), dtype=v.dtype))
        s = torch.einsum("bkgd,blkd->bkgl", qr, kj.float()) / np.sqrt(hd)
        s = s.masked_fill(~ok[:, None, None, :], float("-inf"))
        m = s.amax(dim=-1)
        safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.where(torch.isfinite(s), torch.exp(s - safe[..., None]),
                        torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgl,blkd->bkgd",
                                 p.to(v.dtype).float(), vj.float()))
    m = torch.stack(ms)                              # [n, B, KV, g]
    M = m.amax(dim=0)
    safe = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.where(torch.isfinite(m), torch.exp(m - safe),
                    torch.zeros_like(m))
    acc = torch.zeros_like(accs[0])
    l = torch.zeros_like(ls[0])
    for j in range(len(accs)):                       # range order
        acc = acc + w[j][..., None] * accs[j]
        l = l + w[j] * ls[j]
    return acc / torch.clamp(l[..., None], min=1e-30)


@pytest.mark.parametrize("n_sms", [132, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_partition_matches_plain_version_and_jax_op(case, dtype, n_sms):
    (jq, jk, jv, jpos), (tq, tk, tv, tpos), w = _inputs(case, dtype)
    B, L, KV = tk.shape[0], tk.shape[1], tk.shape[2]
    assert split_plan(B, KV, L, n_sms)[1] >= 1
    got = partitioned(tq, tk, tv, tpos, window=w, n_sms=n_sms)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.numpy(), decode_attention_ref(tq, tk, tv, tpos, window=w).numpy(),
        rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_op(jq, jk, jv, jpos, window=w)),
                               rtol=tol, atol=tol)


def test_plan_splits_the_cases():
    """Under the 4-SM plan most cases of the file take several ranges,
    so the merge above is exercised, not bypassed."""
    n = [split_plan(B, KV, L, 4)[1] for B, H, KV, hd, L, w, p in
         CASES.values()]
    assert sum(x > 1 for x in n) >= 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 64])
def test_nan_in_a_masked_slot_does_not_reach_the_output(dtype, window):
    case = "ring-wrapped" if window else "gqa-g5"
    (jq, jk, jv, jpos), (tq, tk, tv, tpos), w = _inputs(case, dtype)
    assert w == window
    if w:      # rows early in the ring: slots not yet written are masked
        tpos = torch.tensor([700, 20, 5], dtype=torch.int32)
        jpos = jnp.asarray(tpos.numpy())
    valid = valid_slots(tpos, tk.shape[1], w)
    assert not valid.all()
    stale = ~valid[:, :, None, None]
    nan = torch.tensor(float("nan"), dtype=tk.dtype)
    zero = torch.zeros((), dtype=tk.dtype)
    kn, vn = (torch.where(stale, nan, t) for t in (tk, tv))
    kz, vz = (torch.where(stale, zero, t) for t in (tk, tv))
    tol = TOL[dtype]
    want = np.asarray(jax_op(jq, jnp.asarray(kz.float().numpy()).astype(
        jq.dtype), jnp.asarray(vz.float().numpy()).astype(jq.dtype), jpos,
        window=w))
    for n_sms in (132, 4):
        got = partitioned(tq, kn, vn, tpos, window=w, n_sms=n_sms)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    ref = decode_attention_ref(tq, kn, vn, tpos, window=w)
    assert torch.isfinite(ref).all()
    np.testing.assert_allclose(ref.numpy(), want, rtol=tol, atol=tol)
    assert torch.equal(ref, decode_attention_ref(tq, kz, vz, tpos, window=w))


#: RecurrentGemma-2B's local-attention decode: B, H, KV, hd, L = window
RING = (4, 10, 1, 256, 2048)


def _walked(p, B, H, KV, L, positions, window):
    """[B, H, L]: how often each (row, query head, slot) is walked by a
    block of the launch ``p``."""
    walked = np.zeros((B, H, L), np.int64)
    for split in range(p["n_split"]):
        for y in range(KV * p["n_grp"]):
            for b in range(B):
                heads, slots = block_work(p, H, KV, L, positions, window,
                                          split, y, b)
                assert 1 <= len(heads) <= p["gpb"]
                walked[b, heads.start:heads.stop,
                       slots.start:slots.stop] += 1
    return walked


def _merged_once(p, G, hd):
    """Every output element of a group is merged by exactly one block."""
    for g in range(p["n_grp"]):
        n_heads = min(p["gpb"], G - g * p["gpb"])
        merged = np.zeros(n_heads * hd, np.int64)
        blocks = range(p["n_split"]) if p["cluster"] > 1 else [0]
        for split in blocks:
            e = merge_work(p, n_heads, hd, split)
            merged[e.start:e.stop] += 1
        assert (merged == 1).all()


@pytest.mark.parametrize("n_sms", [132, 4])
@pytest.mark.parametrize("window", [2048, 0])
@pytest.mark.parametrize("B,positions", [
    (4, (0, 2047, 2048, 3000)), (4, (4095, 5, 100, 1500)),
    (8, (2047, 1, 2100, 0, 700, 4000, 2048, 64))])
def test_head_groups_cover_every_head_and_slot_once(B, positions, window,
                                                    n_sms):
    _, H, KV, hd, L = RING
    p = plan(B, H, KV, hd, L, n_sms)
    # all 10 heads in one block: two warp sets of 8 query columns
    assert (p["gpb"], p["n_grp"], p["wq"]) == (10, 1, 2)
    assert p["grid"] == (p["n_split"], KV * p["n_grp"], B)
    walked = _walked(p, B, H, KV, L, positions, window)
    # a ring walks every slot (the kernel masks the stale ones); global
    # attention walks the slots up to the row's position and no further
    want = np.ones((B, H, L), np.int64)
    if window == 0:
        want *= (np.arange(L)[None, None, :]
                 <= np.asarray(positions)[:, None, None])
    assert np.array_equal(walked, want)
    _merged_once(p, H // KV, hd)


@pytest.mark.parametrize("n_sms", [132, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_shape_partition_matches_plain_version_and_jax_op(dtype,
                                                               n_sms):
    B, H, KV, hd, L = RING
    rng = np.random.default_rng(256)
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.5 for s in
               ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    pos = np.asarray([0, 2047, 2048, 3000], np.int32)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(td) for a in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = partitioned(tq, tk, tv, tpos, window=L, n_sms=n_sms)
    tol = TOL[dtype]
    np.testing.assert_allclose(
        got.numpy(), decode_attention_ref(tq, tk, tv, tpos,
                                          window=L).numpy(),
        rtol=tol, atol=tol)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_op(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                  jnp.asarray(pos), window=L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_in_a_masked_ring_slot_stays_out_of_every_group(dtype):
    """Rows early in the ring (slots not yet written are masked) with
    those slots NaN: each head group's output equals the zero-filled
    cache's."""
    B, H, KV, hd, L = RING
    rng = np.random.default_rng(7)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32) * 0.5).to(td) for s in
        ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    tpos = torch.tensor([5, 700, 2046, 0], dtype=torch.int32)
    stale = ~valid_slots(tpos, L, L)[:, :, None, None]
    assert stale.any()
    kn, vn = (torch.where(stale, torch.tensor(float("nan"), dtype=td), t)
              for t in (tk, tv))
    kz, vz = (torch.where(stale, torch.zeros((), dtype=td), t)
              for t in (tk, tv))
    want = decode_attention_ref(tq, kz, vz, tpos, window=L)
    for n_sms in (132, 4):
        got = partitioned(tq, kn, vn, tpos, window=L, n_sms=n_sms)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(decode_attention_ref(tq, kn, vn, tpos, window=L),
                       want)


#: the decode shapes of the served paths with short caches or hd 256,
#: where a plan of one wave of one-tile blocks wastes the card: B, H,
#: KV, hd, L
SERVED = {
    "rg-ring-b8": (8, 10, 1, 256, 2048),
    "rg-ring-b4": (4, 10, 1, 256, 2048),
    "vlm-cross": (4, 32, 8, 128, 1601),
    "m4t-cross-shard": (4, 16, 16, 64, 256),
    "vlm-self": (4, 32, 8, 128, 256),
    "m4t-self": (4, 16, 16, 64, 256),
    "m4t-cross": (4, 16, 16, 64, 512),
    "llama4-shard": (4, 40, 8, 128, 512),
}


def _served_positions(row, B, L, window):
    rng = np.random.default_rng(sorted(SERVED).index(row))
    pos = rng.integers(0, 2 * L if window else L, B)
    pos[0] = L - 1
    return pos.astype(np.int32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("row", list(SERVED))
def test_served_shapes_walk_every_head_and_slot_once(row, ring, dtype):
    B, H, KV, hd, L = SERVED[row]
    window = L if ring else 0
    positions = _served_positions(row, B, L, window)
    p = plan(B, H, KV, hd, L, 132, dtype)
    want = np.ones((B, H, L), np.int64)
    if not ring:
        want *= np.arange(L)[None, None, :] <= positions[:, None, None]
    assert np.array_equal(_walked(p, B, H, KV, L, positions, window), want)
    _merged_once(p, H // KV, hd)
    # one group for every served model's heads, in at most two warp sets
    assert p["n_grp"] == 1 and p["gpb"] == H // KV and p["wq"] <= 2
    # the cluster merge wherever the splits fit a portable cluster
    assert p["cluster"] == (p["n_split"] if 1 < p["n_split"] <= 8 else 1)
    # the blocks an SM holds, as the table says, and at most two waves
    assert p["per_sm"] == BLOCKS_PER_SM[dtype, hd, p["sh"], p["wq"]]
    blocks = p["n_split"] * B * KV * p["n_grp"]
    assert blocks <= max(2 * p["per_sm"] * 132, B * KV * p["n_grp"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("row", list(SERVED))
def test_served_shapes_partition_matches_plain_version(row, dtype):
    B, H, KV, hd, L = SERVED[row]
    rng = np.random.default_rng(300 + sorted(SERVED).index(row))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32) * 0.5).to(td) for s in
        ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    window = L if row.startswith("rg") else 0
    tpos = torch.from_numpy(_served_positions(row, B, L, window))
    for n_sms in (132, 4):
        got = partitioned(tq, tk, tv, tpos, window=window, n_sms=n_sms)
        np.testing.assert_allclose(
            got.numpy(), decode_attention_ref(tq, tk, tv, tpos,
                                              window=window).numpy(),
            rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("G,hd,want", [
    (10, 256, (10, 1)), (4, 256, (4, 1)), (16, 256, (16, 1)),
    (20, 256, (10, 2)), (5, 128, (5, 1)), (8, 128, (8, 1)),
    (12, 128, (6, 2)), (1, 64, (1, 1)), (16, 64, (16, 1)),
    (40, 32, (20, 2))])
def test_head_groups_are_equal_and_fit_the_warp_sets(G, hd, want):
    assert head_groups(G, hd) == want
    gpb, n_grp = want
    p = plan(1, G, 1, hd, 1024, 132)
    assert (p["gpb"], p["n_grp"]) == want and gpb * n_grp >= G
    assert p["wq"] == (2 if gpb > 8 and hd == 256 else 1)
