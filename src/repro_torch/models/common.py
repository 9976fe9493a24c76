"""Shared building blocks: devices, trees, initializers, norms, RoPE,
attention and the chunked cross-entropy."""
from __future__ import annotations

import concurrent.futures
import functools
import math
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry point's
    default) requires a card: without one this raises rather than
    carrying on on the CPU, which runs only when asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf of a tree of dicts and tuples (a
    NamedTuple is a leaf) — parameters, caches and their specs."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def _walk(tree, fn):
    """Rebuild ``tree`` with ``fn`` applied to its leaves, visiting them
    in the JAX package's flatten order: dict keys sorted, tuples in
    order (a NamedTuple is a leaf). Dicts keep their own key order."""
    if isinstance(tree, dict):
        out = {k: _walk(tree[k], fn) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)) and not hasattr(tree, "_fields"):
        return tuple(_walk(v, fn) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and tuples in the JAX package's
    order (``jax.tree.leaves`` of the same tree)."""
    out: list = []
    _walk(tree, out.append)
    return out


def tree_unflatten_like(tree, leaves):
    """``tree``'s structure with :func:`tree_leaves`' positions filled
    from ``leaves``, in order."""
    it = iter(leaves)
    return _walk(tree, lambda _: next(it))


def microbatch_sizes(n: int, mb: int) -> Tuple[int, ...]:
    """Split ``n`` rows into ``mb`` contiguous §4.4 ping-pong
    micro-batches (earlier chunks take the remainder)."""
    mb = max(1, min(int(mb), n)) if n else 1
    return tuple(n // mb + (1 if i < n % mb else 0) for i in range(mb))


# ---------------------------------------------------------------------------
# Initializers (same distributions as the JAX package, not the same draws).
#
# Element i of a leaf is a function of (seed, i) alone, computed with
# operations that round the same way on every device: a counter-based
# hash in exact integer arithmetic (products stay below 2^63) gives a
# 24-bit uniform draw, and a tabulated inverse CDF (65536 intervals,
# made in float64 on the host) interpolated with one multiply and one add
# maps it to the distribution. So a seed gives the same weights on the
# card and on the CPU, drawn where the leaf lives, in slices that keep
# int64 temporaries small even for DeepSeek-V3's [256, 7168, 2048] expert
# stacks; and a rank of a mesh draws only its block of a leaf.
# ---------------------------------------------------------------------------
_FILL_ELEMS = 1 << 24
_HOST_ELEMS = 1 << 16
_M32 = (1 << 32) - 1
_BINS = 1 << 16


def part_seed(*keys: int) -> int:
    """A 63-bit seed from integer keys (seed, leaf)."""
    return int(np.random.SeedSequence([int(k) for k in keys])
               .generate_state(1, np.uint64)[0]) >> 1


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit mixing round on int64 values in [0, 2^32): xor-shifts
    and multiplies by odd constants below 2^31, masked to 32 bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x68E31DA5) & _M32
    return x ^ (x >> 16)


def _uniform24(idx: torch.Tensor, seed: int) -> torch.Tensor:
    """int64 indices → int64 draws in [0, 2^24), a function of (seed,
    index) only."""
    lo, hi = seed & _M32, (seed >> 32) & _M32
    h = _mix32(idx & _M32 ^ lo)
    return _mix32(h ^ (idx >> 32) ^ hi) >> 8


@functools.lru_cache(maxsize=None)
def _quantiles(kind: str, device: torch.device):
    """(knots [BINS + 1], steps [BINS]) float32 on ``device``: the
    inverse CDF at ``j / BINS`` of the normal truncated to ±2σ
    (``"truncated"``) or of the normal at the bin midpoints' range
    ``(j + 0.5) / (BINS + 1)`` (``"normal"``), computed in float64 on
    the host, and each interval's rise."""
    j = torch.arange(_BINS + 1, dtype=torch.float64)
    if kind == "truncated":
        lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
        p = lo + (1.0 - 2.0 * lo) * j / _BINS
        q = torch.special.ndtri(p).clamp(-2.0, 2.0)
    else:
        q = torch.special.ndtri((j + 0.5) / (_BINS + 1))
    knots = q.float()
    return knots.to(device), (knots[1:] - knots[:-1]).to(device)


def _fill_(out: torch.Tensor, kind: str, scale: float, seed: int,
           block=None) -> None:
    """Fill ``out`` (contiguous) with ``scale`` times draws of ``kind``
    (:func:`_quantiles`), element ``i`` of the leaf from ``(seed, i)``.
    ``block = (shape, dim, lo, hi)``: ``out`` is the block ``[lo, hi)``
    along ``dim`` of a leaf of ``shape`` whose later dims are whole (a
    rank's block on a mesh): its elements take the leaf's indices."""
    flat = out.view(-1)
    dev = out.device
    knots, steps = _quantiles(kind, dev)
    if block is not None:
        shape, dim, lo, hi = block
        inner = math.prod(shape[dim + 1:])
        run, stride = (hi - lo) * inner, shape[dim] * inner

    def one(a: int) -> None:
        i = torch.arange(a, min(a + size, flat.numel()), dtype=torch.int64,
                         device=dev)
        if block is not None:       # the leaf's index of each element
            i = (i // run) * stride + lo * inner + i % run
        m = _uniform24(i, seed)
        frac = (m & 255).to(torch.float32) * (1.0 / 256.0)
        bins = m >> 8
        z = knots[bins] + frac * steps[bins]
        flat[a:a + i.numel()] = (z * scale).to(out.dtype)
    if dev.type != "cpu":
        size = _FILL_ELEMS
        for a in range(0, flat.numel(), size):
            one(a)
        return
    # on the host: slices that stay in cache, on a pool of threads (the
    # operators release the GIL)
    size = _HOST_ELEMS
    starts = range(0, flat.numel(), size)
    if len(starts) <= 1:
        for a in starts:
            one(a)
        return
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        list(pool.map(one, starts))


def _block_shape(shape, block):
    if block is None:
        return tuple(shape)
    full, dim, lo, hi = block
    return tuple(hi - lo if i == dim else s for i, s in enumerate(full))


def dense_init(shape: Sequence[int], dtype, fan_in: int, seed: int,
               device, block=None) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, ``std = 1/sqrt(fan_in)``.
    ``block``: only that block of the leaf (:func:`_fill_`)."""
    out = torch.empty(_block_shape(shape, block), dtype=dtype, device=device)
    _fill_(out, "truncated", 1.0 / math.sqrt(max(fan_in, 1)), seed, block)
    return out


def embed_init(shape: Sequence[int], dtype, seed: int, device,
               block=None) -> torch.Tensor:
    """Normal init with std 0.02."""
    out = torch.empty(_block_shape(shape, block), dtype=dtype, device=device)
    _fill_(out, "normal", 0.02, seed, block)
    return out


# ---------------------------------------------------------------------------
# RMSNorm (scale stored as a deviation from 1.0, computed in f32)
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings (f64 frequencies, split halves)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=None)
def _rope_frequencies_on(head_dim: int, theta: float,
                         device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` as float32 on ``device``, copied there
    once: a copy from host memory each call would make every decode step
    wait for the card."""
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions broadcastable to
    [..., seq]."""
    head_dim = x.shape[-1]
    freqs = _rope_frequencies_on(head_dim, float(theta), x.device)
    angles = positions[..., None].float() * freqs       # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Reference attention (materializes scores; f32 scores and accumulation)
# ---------------------------------------------------------------------------
def _mask(qp, kp, causal: bool, window: int):
    """[Sq, Sk] bool: key position ``kp`` visible from query ``qp``."""
    msk = torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool,
                     device=qp.device)
    if causal:
        msk &= qp[:, None] >= kp[None, :]
    if window > 0:
        msk &= qp[:, None] - kp[None, :] < window
    return msk


def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    kv_positions: Optional[torch.Tensor] = None,
                    q_positions: Optional[torch.Tensor] = None):
    """q [B, Sq, H, hd]; k/v [B, Sk, KV, hd] → [B, Sq, H, vd].
    ``window > 0``: a query sees keys less than ``window`` positions
    behind it."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qr = q.reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bpkd->bkgqp", qr.float(), k.float()) * scale
    if causal or window > 0:
        qp = (q_positions if q_positions is not None
              else torch.arange(Sq, device=q.device))
        kp = (kv_positions if kv_positions is not None
              else torch.arange(k.shape[1], device=q.device))
        s = s.masked_fill(~_mask(qp, kp, causal, window), float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqp,bpkd->bqkgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        q_block: int = 512, kv_block: int = 512):
    """Flash-style causal attention, the reference's online softmax over
    KV blocks of ``kv_block`` (memory O(S * block), not O(S^2)): q
    [B, S, H, hd], k/v [B, S, KV, hd] → [B, S, H, vd]. Masked scores take
    an additive -1e30 and the running max starts at -1e30, as there: a
    block a row cannot see adds exp(0) junk that the first visible block
    scales away by exp(-1e30 - m) = 0. Every KV block is walked for every
    query block (as the reference's scan); query blocks are independent,
    so they run together."""
    B, S, H, hd = q.shape
    KV, vd = k.shape[2], v.shape[-1]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    q_block, kv_block = min(q_block, S), min(kv_block, S)
    nq, nk = -(-S // q_block), -(-S // kv_block)
    Sq, Sk = nq * q_block, nk * kv_block
    qr = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq - S)).reshape(
        B, Sq, KV, G, hd).float()
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Sk - S))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Sk - S))
    q_pos = torch.arange(Sq, device=q.device)
    m = torch.full((B, KV, G, Sq), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KV, G, Sq, vd), dtype=torch.float32,
                      device=q.device)
    for ki in range(nk):
        k_blk = k[:, ki * kv_block:(ki + 1) * kv_block]
        v_blk = v[:, ki * kv_block:(ki + 1) * kv_block]
        kp = torch.arange(ki * kv_block, (ki + 1) * kv_block,
                          device=q.device)
        s = torch.einsum("bqkgd,bpkd->bkgqp", qr, k_blk.float()) * scale
        msk = _mask(q_pos, kp, causal, window) & (kp < S)[None, :]
        bias = torch.where(msk, 0.0, -1e30).to(torch.float32)
        s = s + bias
        new_m = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - new_m[..., None])
        corr = torch.exp(m - new_m)
        l = corr * l + p.sum(dim=-1)
        acc = corr[..., None] * acc + torch.einsum(
            "bkgqp,bpkd->bkgqd", p.to(v_blk.dtype).float(), v_blk.float())
        m = new_m
    out = acc / torch.clamp(l[..., None], min=1e-30)
    # [B, KV, G, Sq, vd] -> [B, Sq, H, vd]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, vd)
    return out[:, :S].to(q.dtype)


# ---------------------------------------------------------------------------
# Linear recurrence h_t = a_t h_{t-1} + b_t (RG-LRU prefill)
# ---------------------------------------------------------------------------
def linear_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """Every ``h_t`` of ``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0``
    along ``dim``, in ceil(log2 S) doubling steps (Hillis-Steele), each
    composing an element with the one ``d`` before it as the reference's
    associative scan composes two: ``(a1, b1), (a2, b2) -> (a1 a2, a2
    b1 + b2)``. Another tree than ``jax.lax.associative_scan``'s, so the
    two agree within float rounding, not bit for bit."""
    S = a.shape[dim]
    d = 1
    while d < S:
        a_prev, b_prev = a.narrow(dim, 0, S - d), b.narrow(dim, 0, S - d)
        a_cur, b_cur = a.narrow(dim, d, S - d), b.narrow(dim, d, S - d)
        b = torch.cat([b.narrow(dim, 0, d), a_cur * b_prev + b_cur], dim)
        a = torch.cat([a.narrow(dim, 0, d), a_prev * a_cur], dim)
        d *= 2
    return b


# ---------------------------------------------------------------------------
# Chunked cross-entropy: never holds the [B, S, vocab] logits
# ---------------------------------------------------------------------------
def _xent_chunks(S: int, chunk: int):
    """The reference's chunks: ``S // chunk`` of ``chunk`` positions,
    then the remainder."""
    n = S // chunk
    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)]
    if S > n * chunk:
        bounds.append((n * chunk, S))
    return bounds


class _ChunkedXent(torch.autograd.Function):
    """Sum over tokens of ``mask · (lse - gold logit)``, the logits made
    a chunk at a time in float32. Forward keeps only each token's
    log-sum-exp; backward makes a chunk's logits again, so autograd never
    holds more than one ``[B, chunk, V]`` block. The unembedding is cast
    to float32 once per pass, not once per chunk.

    Vocab-parallel (``mc``, a ``MeshCtx``, and ``axes``): ``unembed`` is
    this rank's block of the vocabulary, starting at id ``v0``; the
    log-sum-exp takes its max through ``pmax`` and its sum through
    ``psum`` over ``axes``, as does the gold logit (on the one rank whose
    block holds the label). The sum is the same on every rank of
    ``axes``; in backward their cotangents are summed first (one scalar
    ``psum``), and this rank's hidden cotangent is its block's partial."""

    @staticmethod
    def forward(ctx, hidden, unembed, labels, mask, chunk: int, mc=None,
                axes=None, v0: int = 0):
        B, S, _ = hidden.shape
        w = unembed.float()
        n_v = w.shape[1]
        lse = torch.empty((B, S), dtype=torch.float32, device=hidden.device)
        tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for s0, s1 in _xent_chunks(S, chunk):
            logits = torch.matmul(hidden[:, s0:s1].float(), w)
            y = labels[:, s0:s1, None].long()
            if axes is None:
                l = torch.logsumexp(logits, dim=-1)
                gold = torch.gather(logits, -1, y)[..., 0]
            else:
                m = mc.pmax(logits.amax(dim=-1), axes)
                loc = y - v0
                inside = (loc >= 0) & (loc < n_v)
                gold = torch.where(
                    inside, torch.gather(logits, -1, loc.clamp(0, n_v - 1)),
                    torch.zeros((), device=logits.device))[..., 0]
                both = mc.psum(torch.stack(
                    [torch.exp(logits - m[..., None]).sum(dim=-1), gold]),
                    axes)
                l, gold = torch.log(both[0]) + m, both[1]
            tot = tot + torch.sum((l - gold) * mask[:, s0:s1])
            lse[:, s0:s1] = l
        ctx.save_for_backward(hidden, unembed, labels, mask, lse)
        ctx.chunk, ctx.mc, ctx.axes, ctx.v0 = chunk, mc, axes, v0
        return tot

    @staticmethod
    def backward(ctx, g_tot):
        hidden, unembed, labels, mask, lse = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        B, S, d = hidden.shape
        w = unembed.float()
        n_v = w.shape[1]
        if ctx.axes is not None:
            g_tot = ctx.mc._sum_f32(g_tot, ctx.axes, "psum.bwd")
        dh = torch.empty_like(hidden) if need_h else None
        dw = torch.zeros_like(w) if need_w else None
        for s0, s1 in _xent_chunks(S, ctx.chunk):
            h = hidden[:, s0:s1].float()
            coef = (mask[:, s0:s1] * g_tot)[..., None]        # [B, c, 1]
            # d(lse - gold)/d logits = softmax - onehot(label)
            dlog = torch.exp(torch.matmul(h, w) - lse[:, s0:s1, None])
            dlog.mul_(coef)
            y = labels[:, s0:s1, None].long() - ctx.v0
            if ctx.axes is None:
                dlog.scatter_add_(-1, y, -coef)
            else:
                inside = (y >= 0) & (y < n_v)
                dlog.scatter_add_(-1, y.clamp(0, n_v - 1),
                                  torch.where(inside, -coef,
                                              torch.zeros_like(coef)))
            if need_h:
                dh[:, s0:s1] = torch.matmul(dlog, w.t()).to(hidden.dtype)
            if need_w:
                dw.addmm_(h.reshape(-1, d).t(),
                          dlog.reshape(-1, dlog.shape[-1]))
        return (dh, None if dw is None else dw.to(unembed.dtype), None, None,
                None, None, None, None)


def xent_sum(hidden: torch.Tensor, labels: torch.Tensor,
             unembed: torch.Tensor, mask: Optional[torch.Tensor] = None,
             chunk: int = 128, *, mc=None, axes=None, v0: int = 0):
    """(sum over the counted tokens of the nll, their count): the two
    terms of :func:`chunked_softmax_xent`'s mean. ``mc`` / ``axes`` /
    ``v0``: ``unembed`` is this rank's block of the vocabulary over
    ``axes``, from id ``v0`` (see :class:`_ChunkedXent`)."""
    B, S, _ = hidden.shape
    chunk = min(chunk, S)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    tot = _ChunkedXent.apply(hidden, unembed, labels, mask, chunk, mc, axes,
                             v0)
    return tot, mask.sum()


def chunked_softmax_xent(hidden: torch.Tensor, labels: torch.Tensor,
                         unembed: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         chunk: int = 128):
    """hidden [B, S, d], labels [B, S] int, unembed [d, V], mask [B, S]
    (1.0 = count, default all) → (mean nll over the counted tokens,
    their count), as the reference's scan over sequence chunks of
    ``chunk`` positions and a remainder: ``tot / max(cnt, 1)``.
    Differentiable in ``hidden`` and ``unembed``."""
    tot, cnt = xent_sum(hidden, labels, unembed, mask, chunk)
    return tot / torch.clamp(cnt, min=1.0), cnt
