#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` (``/usr/local/cuda``) and the
repository's ``src/``; without a card it exits non-zero at once.

Stages (any failure raises and exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all in parallel);

DeepSeek-V3 (MLA + top-8 MoE):

3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (DeepSeek-V3 width, top-8 of 256 experts, capacity
   4; the token counts T the path packs: decode T=4, the prompts' padded
   prefill buckets 32 and 64, and the unpadded 37-token prompt):
   route-pack exactly (bf16, spread and hot routing, with and without
   INT8 quantize and expert ids, and with masked rows, over the 256
   experts and the EPLB table's 258 slots), the grouped expert FFN
   within 3e-2 (bf16), and the owner-indexed FFN within 3e-2 of its
   plain version and bit-identical to the plain kernel on
   owner-gathered weights over the 258 slots; time kernel (CUDA events,
   median of 20 after warm-up, and device time under the profiler),
   plain version and one PyTorch library call;
4. serve full-width DeepSeek-V3 cut to 4 layers (3 dense + 1 MoE, random
   bf16 weights made on the card from a seed) through the port's
   ``FlowServeEngine`` (2 DP groups × 4 slots): 4 prompts × 16 greedy
   tokens, then a skewed EPLB pass, then 4 more prompts; every kernel's
   launch count over this stage must be above 0, and the owner-indexed
   FFN must run after EPLB; the first route-pack of each shape the path
   makes (before and after EPLB) is replayed on the kernel and the plain
   version, exactly; then profile full-batch decode steps (host clock
   per engine step, device time by kernel with ``torch.profiler``, and
   the device's idle share within the same profiled steps);
5. check the output by the repository's own means: every request
   finished with its tokens, the logits are finite, and on the smoke
   DeepSeek-V3 (float32) the engine on the card gives the same greedy
   tokens as the engine on the CPU with the plain versions, before and
   after EPLB;

Llama-4 Maverick (GQA + top-1 MoE with a shared expert), after the
DeepSeek-V3 engine is freed:

6. make full-width Llama-4 cut to 2 layers (one dense GQA+MLP layer, one
   GQA+MoE layer; random bf16 weights made on the card from a seed) in
   a ``FlowServeEngine`` (2 DP groups x 4 slots, ``max_len`` 1024,
   512-token prefill chunks);
7. hold the kernels against their plain versions at Llama-4's shapes:
   decode attention in bf16 (3e-2) and float32 (2e-4) at the path's
   shape (B 4, H 40, KV 8, hd 128, L 1024, positions 0 and L-1 among
   them), at a ragged L, in ring-window mode, at G = 1 and G = 8, on a
   strided cache view and at head sizes 64 and 32; the MoE kernels as in stage 3, at top-1 of 128
   experts and 130 slots, on the engine's own MoE weights, at every
   capacity the path's packs have (4 at decode, 5 for a 512-token
   chunk, 8 for the 826-token prompt: one, two and two row tiles); time
   them as in stage 3 (``scaled_dot_product_attention`` is decode
   attention's library call), and decode attention also at L 32768;
8. serve 4 prompts x 16 greedy tokens (one of 825 bytes, prefilled in
   two 512-token chunks), a skewed EPLB pass on the MoE layer, 4 more
   prompts; every kernel of the path launches, the path's first pack of
   each shape is replayed exactly, the logits are finite; profile
   decode steps as for DeepSeek-V3;
9. the smoke Llama-4 with G = 5 (float32): the engine on the card gives
   the CPU's greedy tokens, before and after EPLB;

10. print the card's name and power limit, one JSON line with every
    kernel's launches per path, error, times and bound, then the final
    ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
BF16_FLOP_PER_S = 989e12           # H100 SXM dense bf16, published
PROMPTS = ["The SuperPod serves DeepSeek-V3 with", "Expert parallel decode",
           "Hello, world! 1 2 3", "Latent attention caches"]
PROMPTS_EPLB = ["Load balancing moves experts", "A second wave of",
                "requests after the swap", "ends the run."]
LLAMA_PROMPTS = [
    ("Llama-4 Maverick sends every token to one of 128 routed experts and "
     "adds one shared expert; grouped-query attention lets five query heads "
     "share each key-value head. ") * 5,
    "Top-1 routing", "Grouped-query attention", "One shared expert"]
LLAMA_PROMPTS_EPLB = ["After the swap", "a hot expert has", "two replicas",
                      "and the run ends."]
DEEPSEEK, LLAMA = "deepseek-v3-671b", "llama4-maverick-400b-a17b"
KERNELS = ("route_pack", "gmm", "placement_gmm", "decode_attention")
SOURCES = {"route_pack": "src/repro_torch/kernels/csrc/route_pack.cu",
           "gmm": "src/repro_torch/kernels/csrc/gmm.cu",
           "placement_gmm": "src/repro_torch/kernels/csrc/gmm.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu"}
REPLACES = {"route_pack": "src/repro/kernels/route_pack/kernel.py:105",
            "gmm": "src/repro/kernels/gmm/kernel.py:56",
            "placement_gmm": "src/repro/kernels/gmm/kernel.py:91",
            "decode_attention": "src/repro/kernels/decode_attention/"
                                "kernel.py:67"}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events per call)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Device time of ``fn`` per call: the CUDA kernels' own time under
    ``torch.profiler`` over ``reps`` calls after warm-up. Unlike
    :func:`time_ms` it leaves out the host's launch work, which sets the
    event-timed figure of a call shorter than its launch cost."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA") / 1e3 / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def routed_dest(T: int, k: int, E: int, gen, hot: int = 0) -> torch.Tensor:
    """Top-k experts of random router scores, flattened [T*k] int32. With
    ``hot > 0`` every token favours the same ``hot`` experts, so buckets
    overflow and ranks grow across the rank scan's tiles."""
    scores = torch.rand((T, E), generator=gen, device="cuda")
    if hot:
        scores[:, :hot] += 1.0
    return torch.topk(scores, k, dim=-1).indices.reshape(-1).to(torch.int32)


def pack_err(a, b, what: str) -> float:
    """Hold two RoutePacks field by field: exact, or the check fails.
    Returns the largest absolute difference over all fields."""
    err = 0.0
    for name in ("buckets", "scales", "eids", "rank", "keep"):
        ta, tb = getattr(a, name), getattr(b, name)
        check((ta is None) == (tb is None), f"{what}: {name} in both")
        if ta is None:
            continue
        check(ta.shape == tb.shape and ta.dtype == tb.dtype,
              f"{what}: {name} shape and dtype")
        if ta.numel():
            err = max(err, (ta.double() - tb.double()).abs().max().item())
        check(torch.equal(ta, tb), f"{what}: {name} exact")
    return err


def path_token_counts(prompts, max_batch: int, max_len: int = 256,
                      chunk: int = 0) -> list:
    """Token counts T of the route-packs a path makes: a decode step's
    batch, each prefill chunk (``chunk`` tokens, 0 for whole prompts)
    padded as ``TorchBackend.prefill_chunk`` pads it, and the unpadded
    first prompt of the finite-logits check."""
    from repro_torch.serving.backend import _bucket_len
    from repro_torch.serving.tokenizer import ByteTokenizer

    enc = ByteTokenizer().encode
    counts = {max_batch, len(enc(prompts[0]))}
    for p in prompts:
        n = len(enc(p))
        Lc, c = min(_bucket_len(n), max_len), chunk or n
        counts |= {min(_bucket_len(min(c, n - o)), Lc - o)
                   for o in range(0, n, c)}
    return sorted(counts)


# ---------------------------------------------------------------------------
# stages 3 and 7: kernels against their plain versions
# ---------------------------------------------------------------------------
def bmm_chain(xb, g, u, dn):
    """The grouped SwiGLU FFN as PyTorch batched products (the library
    yardstick of gmm)."""
    h = torch.bmm(xb, g)
    return torch.bmm(torch.nn.functional.silu(h) * torch.bmm(xb, u),
                     dn).float()


def check_moe_kernels(cfg, counts, max_batch: int, weights=None) -> dict:
    """Route-pack, gmm and placement_gmm at a path's shapes.

    ``counts``: the token counts T of the path's packs; ``weights``: the
    expert weights (we_gate, we_up, we_down), or None to make random
    ones. Route-pack is held exactly at every T, over the E logical
    experts and over the E + 2 physical slots of an EPLB table that
    replicates two experts. gmm is held within 3e-2 of its plain version
    at every bucket capacity the path's packs have (a capacity above 4
    takes more than one row tile), and placement_gmm within 3e-2 of its
    plain version and bit-identical to gmm on owner-gathered weights
    (gathered 16 slots at a time: a whole copy at Llama-4 width would be
    32 GB beside its 37 GB of weights). Times are taken at the decode
    shape (T = ``max_batch``)."""
    from repro_torch.kernels.gmm.kernel import gmm_cuda
    from repro_torch.kernels.gmm.ref import gmm_ref, placement_gmm_ref
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ops import placement_route
    from repro_torch.kernels.route_pack.ref import route_pack_ref
    from repro_torch.serving.eplb import build_placement_table, ExpertMap

    e, d = cfg.moe, cfg.d_model
    E, k, f = e.num_experts, e.top_k, e.expert_d_ff
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1234)
    if weights is None:
        def w(shape, fan):
            return (torch.randn(shape, generator=gen, device="cuda")
                    / fan ** 0.5).to(bf16)
        weights = w((E, d, f), d), w((E, d, f), d), w((E, f, d), f)
    wg, wu, wd = weights

    def cap_of(T):       # models/ffn.py's capacity, as Python arithmetic
        return max(int(T * k / E * e.capacity_factor), 4)

    # the EPLB table: two redundant replicas of two hot experts
    hot = [3 % E, 77 % E]
    emap = ExpertMap(E, {h: [h, E + i] for i, h in enumerate(hot)})
    table = build_placement_table([emap], E, pad_physical=E + 2,
                                  pad_replicas=3)
    rs, nr, owner = (torch.as_tensor(a[0], dtype=torch.int32, device="cuda")
                     for a in (table.replica_slots, table.n_replicas,
                               table.phys_owner))
    S = owner.shape[0]

    # -- route-pack: exact at every token count, over E and S slots -----
    rp_err, packs = 0.0, {}
    for T in counts:
        N, cap = T * k, cap_of(T)
        x = torch.randn((T, d), generator=gen, device="cuda").to(bf16)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        tok_of = torch.arange(T, device="cuda").repeat_interleave(k)
        variants = [(q, ei, None) for q in (False, True)
                    for ei in (None, eid)] + [(True, eid, mask)]
        for hot_n in (0, 12):
            dest = routed_dest(T, k, E, gen, hot_n)
            pdest = placement_route(dest, tok_of, rs, nr)
            for n_dest, dst in ((E, dest), (S, pdest)):
                for quant, ei, valid in variants:
                    kw = dict(k=k, n_dest=n_dest, capacity=cap,
                              quantize=quant)
                    rp_err = max(rp_err, pack_err(
                        route_pack_cuda(x, dst, valid, ei, **kw),
                        route_pack_ref(x, dst, valid, ei, **kw),
                        f"route_pack T={T} n_dest={n_dest} hot={hot_n} "
                        f"quantize={quant} eid={ei is not None} "
                        f"masked={valid is not None}"))
            if not hot_n:
                packs[T] = x, dest, pdest
        log(f"route_pack T={T} N={N} C={cap}: exact in "
            f"{4 * len(variants)} variants (n_dest {E} and {S}, spread and "
            f"hot routing x quantize x eid, and masked)")
    x, dest, pdest = packs[max_batch]
    kw = dict(k=k, n_dest=E, capacity=cap_of(max_batch), quantize=False)
    res = route_pack_cuda(x, dest, None, None, **kw)
    bnd, by = bound_ms(nbytes(x, dest, res.buckets, res.rank, res.keep), 0)
    out = {"route_pack": dict(
        max_abs_err=rp_err,
        ms=time_ms(lambda: route_pack_cuda(x, dest, None, None, **kw)),
        device_ms=device_ms(lambda: route_pack_cuda(x, dest, None, None,
                                                    **kw)),
        plain_ms=time_ms(lambda: route_pack_ref(x, dest, None, None, **kw)),
        library_ms=None, bound_ms=bnd, bound_by=by)}

    # -- gmm and placement_gmm at each capacity the path's packs have ----
    def pack(T, dst, n_dest):
        return route_pack_cuda(packs[T][0], dst, None, None, k=k,
                               n_dest=n_dest, capacity=cap_of(T),
                               quantize=False).buckets

    o = owner.long()
    err = perr = 0.0
    by_cap = {}
    for T in sorted(counts):
        by_cap.setdefault(cap_of(T), T)     # the smallest T of a capacity
    for T in by_cap.values():
        b = pack(T, packs[T][1], E)
        got = gmm_cuda(b, wg, wu, wd)
        err = max(err, (got - gmm_ref(b, wg, wu, wd)).abs().max().item())
        ident = torch.arange(E, device="cuda", dtype=torch.int32)
        check(torch.equal(gmm_cuda(b, wg, wu, wd, ident), got),
              f"placement_gmm with identity owners bit-identical to gmm, "
              f"T={T}")
        pb = pack(T, packs[T][2], S)
        pgot = gmm_cuda(pb, wg, wu, wd, owner)
        for s in range(0, S, 16):
            sub = [t[o[s:s + 16]] for t in (wg, wu, wd)]
            check(torch.equal(gmm_cuda(pb[s:s + 16], *sub), pgot[s:s + 16]),
                  f"placement_gmm bit-identical to gmm on owner-gathered "
                  f"weights, T={T}, slots {s}..{s + 15}")
            del sub
        perr = max(perr, (pgot - placement_gmm_ref(pb, wg, wu, wd, owner))
                   .abs().max().item())
        torch.cuda.synchronize()
        log(f"gmm [{E},{b.shape[1]},{d}]x{f}: max abs err {err:.3g}; "
            f"placement_gmm [{S},{pb.shape[1]},{d}] (replicas of experts "
            f"{hot}): bit-identical to gathered, max abs err vs plain "
            f"{perr:.3g}")
    check(err <= 3e-2, f"gmm max abs err {err} <= 3e-2")
    check(perr <= 3e-2, f"placement_gmm max abs err {perr} <= 3e-2")

    for name, dst, n_dest in (("gmm", dest, E), ("placement_gmm", pdest, S)):
        b = pack(max_batch, dst, n_dest)
        own = None if name == "gmm" else owner
        ref = gmm_ref if own is None else (
            lambda *a: placement_gmm_ref(*a, owner))
        rows = int((b.abs().amax(dim=-1) > 0).sum())
        live = int((b.abs().amax(dim=(1, 2)) > 0).sum())
        io = nbytes(b, own) + b.numel() * 4
        bnd, by = bound_ms(live * 3 * d * f * 2 + io, 6 * rows * d * f)
        dense, _ = bound_ms(n_dest * 3 * d * f * 2 + io,
                            6 * b.shape[0] * b.shape[1] * d * f)
        out[name] = dict(
            max_abs_err=err if own is None else perr,
            ms=time_ms(lambda: gmm_cuda(b, wg, wu, wd, own)),
            device_ms=device_ms(lambda: gmm_cuda(b, wg, wu, wd, own)),
            plain_ms=time_ms(lambda: ref(b, wg, wu, wd)),
            # no single PyTorch call takes an owner table
            library_ms=(time_ms(lambda: bmm_chain(b, wg, wu, wd))
                        if own is None else None),
            bound_ms=bnd, bound_by=by, bound_dense_walk_ms=dense,
            nonempty_slots=live, slots=n_dest)
    for name, r in out.items():
        log(f"  {name}: {r['ms']:.4f} ms, device {r['device_ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# stage 7: decode attention against its plain version
# ---------------------------------------------------------------------------
def check_decode_attention(cfg, max_batch: int, max_len: int) -> dict:
    """Decode attention at the path's shape and around it, in bf16 and
    float32, against the plain version; then timed at the path's shape
    (every row at the last slot, so the whole cache is read) and at a
    long context."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref, valid_slots)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, L = max_batch, max_len
    gen = torch.Generator(device="cuda").manual_seed(4321)
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False

    def rand(*shape):
        return torch.randn(shape, generator=gen, device="cuda") * 0.5

    def inputs(H, KV, L, dtype, pos, heads_alloc=None, hd=hd):
        """q, k, v, positions; ``heads_alloc`` > KV makes k/v views of a
        wider cache (a head stride that is not KV * hd). The random
        values past each row's position stand for stale slots."""
        n = heads_alloc or KV
        k = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        v = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        return (rand(B, H, hd).to(dtype), k, v,
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    last = [L - 1] * B
    cases = [  # name, H, KV, L, window, positions, heads_alloc, hd
        ("path", H, KV, L, 0, [0, L - 1, L // 2 + 3, 37], None, hd),
        ("ragged L=1000", H, KV, 1000, 0, [999, 0, 517, 1], None, hd),
        ("ring window 256", H, KV, 256, 256, [255, 256, 700, 1500], None,
         hd),
        ("ring window 256, ragged L=250", H, KV, 250, 256,
         [249, 300, 1000, 0], None, hd),
        ("G=1", KV, KV, L, 0, last, None, hd),
        ("G=8", 8 * KV, KV, L, 0, [5, L - 1, 600, 0], None, hd),
        ("strided cache view", H, KV, L, 0, [L - 1, 3, 800, 64], 2 * KV,
         hd),
        # the other head sizes the wrapper takes (32: the smoke model's)
        ("hd=64", H, KV, L, 0, [L - 1, 0, 300, 901], None, 64),
        ("hd=32", H, KV, 1000, 0, [999, 12, 0, 640], None, 32),
    ]
    errs = {}
    for dtype, bar in ((torch.bfloat16, 3e-2), (torch.float32, 2e-4)):
        for name, h, kv, length, w, pos, alloc, d in cases:
            q, k, v, p = inputs(h, kv, length, dtype, pos, alloc, d)
            got = decode_attention_cuda(q, k, v, p, window=w)
            want = decode_attention_ref(q, k, v, p, window=w)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            check(err <= bar, f"decode_attention {name} {dtype}: max abs "
                  f"err {err} <= {bar}")
            errs[(name, str(dtype))] = err
            log(f"decode_attention {name} [{B},{h},{d}] x L={length} "
                f"window={w} {str(dtype)[6:]}: max abs err {err:.3g}")

    def timed(L):
        q, k, v, p = inputs(H, KV, L, torch.bfloat16, [L - 1] * B)
        mask = valid_slots(p, L)[:, None, None, :]

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        lib_err = (sdpa()[:, :, 0].float()
                   - decode_attention_ref(q, k, v, p)).abs().max().item()
        rows = int(mask.sum())                 # cache slots the data needs
        bnd, by = bound_ms(rows * KV * hd * 2 * 2 + nbytes(q, p)
                           + B * H * hd * 4, 4 * rows * H * hd)
        return dict(ms=time_ms(lambda: decode_attention_cuda(q, k, v, p)),
                    device_ms=device_ms(
                        lambda: decode_attention_cuda(q, k, v, p)),
                    plain_ms=time_ms(lambda: decode_attention_ref(q, k, v,
                                                                  p)),
                    library_ms=time_ms(sdpa), library_max_abs_err=lib_err,
                    bound_ms=bnd, bound_by=by)
    out = timed(L)
    out["long_context_L32768"] = timed(32768)
    out["max_abs_err"] = max(e for (_, dt), e in errs.items()
                             if dt == "torch.bfloat16")
    out["max_abs_err_f32"] = max(e for (_, dt), e in errs.items()
                                 if dt == "torch.float32")
    return out


# ---------------------------------------------------------------------------
# stage 4: the main path at full width
# ---------------------------------------------------------------------------
def serve(engine, prompts, n_new: int):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=n_new, ignore_eos=True)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    t0 = time.monotonic()
    engine.run_until_done()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    for r in reqs:
        check(r.state.value == "finished" and len(r.output_tokens) == n_new,
              f"request {r.req_id} finished with {n_new} tokens")
        check(all(0 <= t < engine.cfg.vocab_size for t in r.output_tokens),
              "tokens inside the vocabulary")
    return reqs, wall


def moe_layers(cfg) -> list:
    from repro_torch.configs.base import MOE
    return [i for i, (_, f) in enumerate(cfg.layer_kinds()) if f == MOE]


def skewed_counts(cfg, gen_seed: int = 7):
    """Routed-token counts [n_layers, E] with two hot experts in every
    MoE layer."""
    import numpy as np
    rng = np.random.default_rng(gen_seed)
    E = cfg.moe.num_experts
    counts = rng.integers(0, 4, size=(cfg.num_layers, E))
    hot = np.ix_(moe_layers(cfg), [3 % E, 77 % E])
    counts[hot] += 400
    return counts


class PackRecorder:
    """Stands in for the MoE layer's route-pack entry point and keeps a
    copy of the inputs of the first call of each shape, so that the
    path's own packs can be held against the plain version afterwards."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}

    def __call__(self, x, dest, valid=None, eid=None, **kw):
        kw = {"k": 1, "quantize": False, **kw}     # the entry's defaults
        key = (x.shape[0], kw["n_dest"], kw["capacity"], x.dtype,
               kw["quantize"], valid is not None, eid is not None)
        if key not in self.calls:
            self.calls[key] = (x.clone(), dest.clone(),
                               None if valid is None else valid.clone(),
                               None if eid is None else eid.clone(), kw)
        return self.fn(x, dest, valid, eid, **kw)


def replay_packs(rec: PackRecorder, cfg) -> float:
    """The path's own route-packs, one of each shape, on the kernel and
    on the plain version: exact. Returns the largest difference."""
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ref import route_pack_ref

    E, err = cfg.moe.num_experts, 0.0
    for (T, n_dest, cap, *_), (x, dest, valid, eid, kw) in rec.calls.items():
        err = max(err, pack_err(route_pack_cuda(x, dest, valid, eid, **kw),
                                route_pack_ref(x, dest, valid, eid, **kw),
                                f"path route_pack T={T} n_dest={n_dest}"))
    shapes = sorted((T, n, c) for T, n, c, *_ in rec.calls)
    check(any(n > E for _, n, _ in shapes), "a post-EPLB pack was replayed")
    check(any(T * cfg.moe.top_k > 256 for T, _, _ in shapes),
          "a pack spanning more than one rank-scan tile was replayed")
    log(f"path route_pack replayed exactly at (T, n_dest, C) {shapes}")
    return err


def make_engine(cfg, **kw):
    """The port's engine with random weights made on the card."""
    from repro_torch.models.weights import flatten
    from repro_torch.serving.flowserve import FlowServeEngine

    t0 = time.monotonic()
    engine = FlowServeEngine(cfg, device="cuda", n_dp_groups=2, seed=0, **kw)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(engine.params).values())
    log(f"path: {cfg.name} depth {cfg.num_layers}, {n_params / 1e9:.2f} B "
        f"parameters made on the card in {time.monotonic() - t0:.1f} s")
    return engine


def run_path(engine, prompts, prompts_eplb, kernels) -> dict:
    """Serve ``prompts``, run a skewed EPLB pass, serve
    ``prompts_eplb``, with every launch count set to 0 just before and
    read just after: each of ``kernels`` must have launched. Then replay
    the path's packs, profile decode, and close the engine."""
    from unittest import mock

    from repro_torch.kernels import runtime
    from repro_torch.models import ffn

    cfg = engine.cfg
    torch.cuda.reset_peak_memory_stats()
    rec = PackRecorder(ffn.fused_route_pack)
    with mock.patch.object(ffn, "fused_route_pack", rec):
        runtime.reset_launch_counts()
        reqs, wall = serve(engine, prompts, 16)
        before = dict(runtime.LAUNCHES)
        engine.record_expert_counts(skewed_counts(cfg))
        maps = engine.run_eplb()
        check(all(any(len(s) > 1 for s in maps[i].replicas.values())
                  for i in moe_layers(cfg)),
              "EPLB installed redundant replicas in every MoE layer")
        reqs2, wall2 = serve(engine, prompts_eplb, 16)
        launches = dict(runtime.LAUNCHES)
        check(all(launches.get(n, 0) > 0 for n in kernels),
              f"every kernel launched on the path: {launches}")
        check(launches["placement_gmm"] > before.get("placement_gmm", 0),
              "placement_gmm ran after EPLB")

        # the output is finite: logits of one prompt through the model
        tok = torch.tensor([engine.tokenizer.encode(prompts[0])],
                           device=engine.device)
        with torch.no_grad():
            logits, _ = engine.model.prefill(engine.params, tok)
        check(bool(torch.isfinite(logits).all()), "finite logits")
    replay_err = replay_packs(rec, cfg)
    del rec
    profile = profile_decode(engine)
    everyone = reqs + reqs2
    ttft = [r.ttft for r in everyone]
    tpot = [r.tpot for r in everyone]
    res = dict(launches=launches, launches_before_eplb=before,
               route_pack_replay_err=replay_err,
               ttft_ms_mean=1e3 * statistics.mean(ttft),
               ttft_ms_max=1e3 * max(ttft),
               tpot_ms_mean=1e3 * statistics.mean(tpot),
               tpot_ms_max=1e3 * max(tpot),
               ttft_ms=[1e3 * t for t in ttft],
               serve_s=[wall, wall2],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               decode_profile=profile,
               text=engine.tokenizer.decode(reqs[0].output_tokens))
    engine.close()
    log(f"path: {len(everyone)} requests x 16 tokens served in {wall:.2f} "
        f"s + {wall2:.2f} s; TTFT mean {res['ttft_ms_mean']:.1f} ms, TPOT "
        f"mean {res['tpot_ms_mean']:.2f} ms, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB; launches {launches}")
    return res


def profile_decode(engine, steps: int = 4) -> dict:
    """Where a decode step's time goes: engine steps with every slot of
    both DP groups decoding, timed on the host clock, then the same
    number of steps under ``torch.profiler``, which gives device time by
    kernel; the idle share compares that busy time with the host-clock
    time of the same profiled steps. Runs after the path's launch counts
    were read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.request import Request

    n = sum(d.max_batch for d in engine.dps)
    for i in range(n):
        engine.submit(Request(prompt=f"profile prompt {i}",
                              max_new_tokens=2 * steps + 8, ignore_eos=True))
    for _ in range(3):                        # prefill + first decodes
        engine.step()
    check(all(d.active == d.max_batch for d in engine.dps),
          "every slot decoding while profiled")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall = (time.monotonic() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) / steps * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3 / steps)
                      for e in prof.key_averages()
                      if e.device_type.name == "CUDA"
                      and e.self_device_time_total > 0),
                     key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    check(0 < busy <= prof_wall, f"device busy {busy} ms per step within "
          f"the profiled step's {prof_wall} ms")
    engine.run_until_done()
    res = dict(engine_step_ms=wall, profiled_step_ms=prof_wall,
               device_busy_ms=busy, device_idle_share=1.0 - busy / prof_wall,
               dp_groups=len(engine.dps),
               batch_per_group=engine.dps[0].max_batch,
               top_kernels_ms=[(k[:60], ms) for k, ms in kernels[:8]])
    log(f"decode profile: engine step {wall:.2f} ms (host clock), "
        f"{prof_wall:.2f} ms under the profiler, device busy {busy:.2f} ms, "
        f"idle share {res['device_idle_share']:.4f} of the profiled step")
    for k, ms in res["top_kernels_ms"]:
        log(f"  {ms:8.3f} ms/step  {k}")
    return res


# ---------------------------------------------------------------------------
# stage 5: the card against the CPU on a small input
# ---------------------------------------------------------------------------
def check_small_reference(arch: str, **overrides):
    """The smoke variant of ``arch`` in float32: greedy tokens of the
    engine on the card equal the CPU plain versions', before and after
    EPLB."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.serving.flowserve import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32",
                              mtp_num_layers=0, **overrides)
    outs = {}
    cpu_params = Model(cfg).init(0, device="cpu")
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        eng = FlowServeEngine(cfg, params, device=dev, n_dp_groups=2,
                              max_batch=2)
        first = [r.output_tokens for r in serve_any(eng, PROMPTS[:3])]
        eng.record_expert_counts(skewed_counts(cfg))
        eng.run_eplb()
        second = [r.output_tokens for r in serve_any(eng, PROMPTS[:3])]
        eng.close()
        outs[dev] = (first, second)
    check(outs["cpu"] == outs["cuda"],
          "smoke engine: card tokens equal CPU tokens before and after EPLB")
    log(f"small reference: {cfg.name} {overrides} (f32) greedy tokens on "
        f"the card equal the CPU plain versions', before and after EPLB")


def serve_any(engine, prompts):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=8, ignore_eos=True)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return reqs


# ---------------------------------------------------------------------------
def free(what: str) -> None:
    """Drop what the last stage left on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated")


def deepseek_stages(get_config) -> tuple:
    """Stages 3-5 on DeepSeek-V3 cut to 4 layers."""
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=4,
                              mtp_num_layers=0)
    max_batch = 4
    t0 = time.monotonic()
    kern = check_moe_kernels(
        cfg, path_token_counts(PROMPTS + PROMPTS_EPLB, max_batch), max_batch)
    free(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    path = run_path(make_engine(cfg, max_batch=max_batch), PROMPTS,
                    PROMPTS_EPLB, ("route_pack", "gmm", "placement_gmm"))
    kern["route_pack"]["max_abs_err"] = max(kern["route_pack"]["max_abs_err"],
                                            path["route_pack_replay_err"])
    free(f"path: {time.monotonic() - t0:.1f} s; sample output "
         f"{path['text']!r}")

    t0 = time.monotonic()
    check_small_reference(DEEPSEEK)
    log(f"small reference: {time.monotonic() - t0:.1f} s")
    return kern, path


def llama_stages(get_config) -> tuple:
    """Stages 6-9 on Llama-4 Maverick cut to 2 layers."""
    from repro_torch.configs.base import MOE

    cfg = dataclasses.replace(get_config(LLAMA), num_layers=2)
    max_batch, max_len, chunk = 4, 1024, 512
    t0 = time.monotonic()
    engine = make_engine(cfg, max_batch=max_batch, max_len=max_len,
                         chunk_tokens=chunk)
    counts = path_token_counts(LLAMA_PROMPTS + LLAMA_PROMPTS_EPLB, max_batch,
                               max_len, chunk)
    check(chunk in counts, f"a {chunk}-token chunk among the packs {counts}")
    moe = engine.params["blocks"][
        f"pos{[f for _, f in cfg.layer_pattern].index(MOE)}"]["ffn"]
    kern = check_moe_kernels(
        cfg, counts, max_batch,
        [moe[n][0] for n in ("we_gate", "we_up", "we_down")])
    del moe
    kern["decode_attention"] = check_decode_attention(cfg, max_batch,
                                                      max_len)
    free(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    path = run_path(engine, LLAMA_PROMPTS, LLAMA_PROMPTS_EPLB, KERNELS)
    del engine
    kern["route_pack"]["max_abs_err"] = max(kern["route_pack"]["max_abs_err"],
                                            path["route_pack_replay_err"])
    free(f"path: {time.monotonic() - t0:.1f} s; sample output "
         f"{path['text']!r}")

    t0 = time.monotonic()
    check_small_reference(LLAMA, num_heads=10, num_kv_heads=2, head_dim=32)
    log(f"small reference: {time.monotonic() - t0:.1f} s")
    return kern, path


def kernel_line(results: dict) -> dict:
    """One entry per kernel: launches per path (and their sum), the
    largest error of any path, and the Llama-4 path's times and bound
    (each path's own measurements in full under ``by_path``)."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = []
    for n in KERNELS:
        meas = {p: k[n] for p, (k, _) in results.items() if n in k}
        launches = {p: r["launches"].get(n, 0)
                    for p, (_, r) in results.items()}
        top = meas[LLAMA]
        kernels.append(dict(
            name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
            launches=sum(launches.values()), launches_by_path=launches,
            **{k: top[k] for k in keys},
            max_abs_err=max(m["max_abs_err"] for m in meas.values()),
            by_path=meas))
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    t0 = time.monotonic()
    libs = runtime.build()
    log(f"build: {len(libs)} kernel libraries in "
        f"{time.monotonic() - t0:.1f} s ({', '.join(sorted(libs))})")
    for name, text in sorted(runtime.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}.cu: {line.strip()}")

    results = {DEEPSEEK: deepseek_stages(get_config),
               LLAMA: llama_stages(get_config)}
    for p, (_, path) in results.items():
        log(json.dumps({"path": p, **{k: v for k, v in path.items()
                                      if k != "text"}}))
    print(smi)
    print(json.dumps({"kernels": kernel_line(results)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
