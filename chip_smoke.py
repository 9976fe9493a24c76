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

3. hold each MoE kernel against its plain PyTorch version on the card at
   the main path's shapes (DeepSeek-V3 width, top-8 of 256 experts,
   capacity 4; the token counts T the path packs: decode T=4, the
   prompts' padded prefill buckets 32 and 64, and the unpadded 37-token
   prompt): route-pack exactly (bf16, spread and hot routing, with and
   without INT8 quantize and expert ids, with masked rows, and with the
   EPLB Collect count block — logical ids counted, int32 dest without a
   placement and the router's int64 ids with one, counts equal to
   ``collect_ref`` — over the 256 experts and the EPLB table's 258
   slots; and on padding rows, payload rows off the 16-byte vector, a
   capacity past 256 slots and a call with no rows, counting ids with -1
   and ids >= E mixed in), the standalone Collect kernel exactly at every
   N = T·8 (routed int64 ids, and int32 ids with -1 and ids >= E mixed
   in), the grouped expert FFN within 3e-2 (bf16), and the owner-indexed
   FFN within 3e-2 of its plain version and bit-identical to the plain
   kernel on owner-gathered weights over the 258 slots; every gmm call
   also has its device-side live rows equal to ``live_rows``, a second
   call bit-identical and every all-zero bucket row +0, and gmm is also
   held on an all-empty call (all +0), one live slot, partly filled rows
   and in float32 (2e-4, 16 experts' weights); route-pack must be one
   device kernel per call under the profiler, with no memset or fill
   beside it, with and without the count block, its device time with the
   block within 10% of its time without (in turn in one profiler window)
   and its event time below route-pack + the standalone Collect's (in
   turn); time kernel (CUDA events, median of 20 after warm-up, and
   device time under the profiler), plain version and one PyTorch
   library call, gmm also on one live slot
   and at the largest T of each capacity, each beside its live-slot
   count, its bound and its dense-walk bound;
4. serve full-width DeepSeek-V3 cut to 4 layers (3 dense + 1 MoE, and
   its MTP head; random bf16 weights made on the card from a seed)
   through the port's
   ``FlowServeEngine`` (2 DP groups × 4 slots): 4 prompts × 16 greedy
   tokens, then a skewed EPLB pass, then 4 more prompts; every kernel's
   launch count over this stage must be above 0 (route-pack, gmm,
   placement_gmm), the owner-indexed FFN must run after EPLB, and EPLB
   Collect must have run inside every route-pack launch (68 of them, one
   per MoE layer call) and never on its own; the first route-pack of
   each shape the path makes is replayed on the kernel and the plain
   version, exactly, its counts equal to ``collect_ref`` on its logical
   ids, with and without a placement; then profile full-batch decode steps
   (host clock per engine step, device time by kernel with
   ``torch.profiler``, and the device's idle share within the same
   profiled steps), and run one full-batch decode step of a DP group
   twice from copies of one cache with the same inputs: the logits must
   be bit-identical (the MoE combine sums in a fixed order);
5. the INT8 path of §4.7 on that engine before it is freed, with the
   launch counts set to 0 just before it and read just after: on layer
   0's full-width ``wq_a``, ``wkv_a``, ``wq_b`` (as [1536, 24576]), the
   dense MLP's ``wi_gate`` and ``wo`` and one routed expert's
   ``we_gate``, with the path's own tokens' rms-normed embeddings (their
   q latent for ``wq_b``, their SwiGLU for ``wo``) as activations and
   calibration set: SmoothQuant, channel-wise weights (stored K-major),
   the W8A8 linear (quant-dispatch + INT8-matmul kernels) at M 4, 37, 64
   and 512, naive and smoothed, each bit-identical to the plain path,
   with its error against the bf16 product logged; GPTQ of ``wkv_a`` in
   float64 on the card (timed, error against naive rounding); the served
   MLA caches quantized. Then quant-dispatch bit-identical at every
   input, a zero row, .5 quotients, (7, 32), (5, 1000), the ragged
   (4, 7170), an unaligned (4, 7168) and all-zero rows (+0 and -0) on
   the cluster and block paths; INT8 matmul on K-major
   weights at (100,300,50), (1,64,17), (37,1000,300), (130,136,257) (K
   not a multiple of 16 but at (1,64,17)) and on a weight 1 byte off a
   16-byte boundary; the caches bit-identical; and both kernels timed
   (quant-dispatch at widths 1536, 7168 and 18432 x M 4, 37, 64 and 512
   in bf16 and f32 and on the MLA cache rows, each bit-identical, one
   device kernel per call, beside its plan and bound, and at M 4 called
   in turn with the two-pass launch of the same function — the plan's
   scalar path, a block per row — which it must beat on the device, and
   with the one of one block a row and a cluster of blocks that the plan
   did not pick; INT8 matmul on ``wi_gate`` at every M, one
   device kernel per call, its share of the int8 peak logged, and called
   in turn with ``torch._int_mm`` + the same epilogue on the same K-major
   weight where that takes the shape (M > 16): the kernel must be faster
   at M 512);
6. MTP speculative decoding (§4.6) on that engine's weights, with its
   MTP head (a [14336, 7168] projection and one MLA + dense-MLP block,
   0.69 B parameters): a ``FlowServeEngine`` with ``mtp_k`` 1, then 2,
   serves the plain path's prompts with the same EPLB pass, and every
   request's tokens must equal the plain engine's; every iteration of
   every DP group must launch route-pack (with Collect's count block),
   and gmm before EPLB or placement_gmm after it, ``k + 1`` times per MoE
   layer and nothing else, call ``_logits`` ``2k + 1`` times and never in
   the draft-cache fill pass; 4 requests at temperature 0.7 (the
   residual and bonus draws); the second wave again with an oracle head
   (its logits peaked at the token the plain engine emitted next: every
   draft accepted, as a well-trained head's would be) and once more with
   one of its drafts per request wrong (a rejection mid-block, junk left
   in both caches), the tokens unchanged each time; one rolled-back
   iteration (``inject_fault``)
   at a full batch of greedy and sampled slots must give the fault-free
   iteration's blocks and accepted counts; then the acceptance rate,
   tokens per iteration, TPOT per emitted token (host clock; and at the
   oracle's full acceptance), one DP
   group's device time per iteration split into draft chain, verify
   chain and fill pass beside the plain ``decode_sample`` from the same
   state (``torch.profiler``), and a decode profile of the engine, each
   printed beside the plain path's;
7. check the output by the repository's own means: every request
   finished with its tokens, the logits are finite, and on the smoke
   DeepSeek-V3 (float32) the engine on the card gives the same greedy
   tokens as the engine on the CPU with the plain versions, before and
   after EPLB, and with its MTP head at ``mtp_k`` 2 the same tokens and,
   iteration by iteration, the CPU's blocks and accepted counts (with a
   wave under the oracle head, so full and partial blocks are among
   them);

Llama-4 Maverick (GQA + top-1 MoE with a shared expert), after the
DeepSeek-V3 engine is freed:

8. make full-width Llama-4 cut to 2 layers (one dense GQA+MLP layer, one
   GQA+MoE layer; random bf16 weights made on the card from a seed) in
   a ``FlowServeEngine`` (2 DP groups x 4 slots, ``max_len`` 1024,
   512-token prefill chunks);
9. hold the kernels against their plain versions at Llama-4's shapes:
   the MoE kernels and Collect as in stage 3, at top-1 of 128 experts
   and 130 slots, on the engine's own MoE weights, at every capacity
   the path's packs have (4 at decode, 5 for a 512-token chunk, 8 for
   the 826-token prompt: one tensor-core row tile each), timed as in
   stage 3; decode attention in bf16 (3e-2) and float32 (2e-4), both as
   an absolute error and scaled by each output row's size (min(1,
   max |want|)), at the path's shape (B 4, H 40, KV 8, hd 128, L 1024,
   positions 0 and L-1 among them), at a ragged L, in ring-window mode
   (rows past and before their first wrap), at G = 1 and G = 8, on a
   strided cache view, at head sizes 64 and 32 and with peaked scores,
   each also with every slot its rows do not attend to NaN-filled (a
   stale tail: the output must not change beyond the bar) and repeated
   bit-identically; timed (``scaled_dot_product_attention`` is its
   library call, the two called in turn) at the path's shape, at
   L 8192, 32768 and 131072 and on a ragged batch at L 32768 (positions
   L-1, L/2, 100, 0), each beside its bound from the slots the data
   needs; one call must be one launch under the profiler, no slower
   than SDPA at L 1024, 8192 and 32768, and at L 32768 within 2x the
   bound on the device;
10. serve 4 prompts x 16 greedy tokens (one of 825 bytes, prefilled in
   two 512-token chunks), a skewed EPLB pass on the MoE layer, 4 more
   prompts; every kernel of the path launches, Collect inside each of
   the 70 route-packs and never alone, the path's first pack of each
   shape is replayed exactly with its counts, the logits are
   finite; profile decode steps and repeat a decode step as for
   DeepSeek-V3;
11. the INT8 KV cache on that engine, launch counts set to 0 just
    before and read just after: every layer's k/v of both DP groups
    quantized per (position, head) through quant-dispatch, bit-identical
    to the plain version; INT8 attention scores at the path's shape (one
    query row per KV head, [4, 8, 128] against [4, 1024, 8, 128]) equal
    on the card and the CPU; quant-dispatch timed on the cache rows
    [32768, 128] and on each head's whole cache as a row [32, 131072];
12. the smoke Llama-4 with G = 5 (float32): the engine on the card gives
    the CPU's greedy tokens, before and after EPLB;

13. print the card's name and power limit, one JSON line with every
    kernel's launches per path, error, times and bound (Collect's
    launches are the route-pack launches that ran its body), then the
    final ``{"ok": true, ...}`` line.
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
INT8_OP_PER_S = 1979e12            # H100 SXM dense int8, published
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
DEEPSEEK_INT8, LLAMA_INT8_KV = DEEPSEEK + "/int8", LLAMA + "/int8-kv"
KERNELS = ("route_pack", "gmm", "placement_gmm", "decode_attention",
           "quant_dispatch", "int8_matmul", "collect")
SOURCES = {n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in KERNELS}
SOURCES["placement_gmm"] = SOURCES["gmm"]
#: Collect's body: run by route-pack's count block on the path, and by
#: the standalone launch of csrc/collect.cu
SOURCES["collect"] = "src/repro_torch/kernels/csrc/collect.cuh"
REPLACES = {"route_pack": "src/repro/kernels/route_pack/kernel.py:105",
            "gmm": "src/repro/kernels/gmm/kernel.py:56",
            "placement_gmm": "src/repro/kernels/gmm/kernel.py:91",
            "decode_attention": "src/repro/kernels/decode_attention/"
                                "kernel.py:67",
            "quant_dispatch": "src/repro/kernels/quant_dispatch/kernel.py:30",
            "int8_matmul": "src/repro/kernels/int8_matmul/kernel.py:38",
            "collect": "src/repro/kernels/collect/kernel.py:38"}
#: the path whose measurements each kernel's entry of the kernels line
#: carries (every path's own are under ``by_path``)
TIMED_ON = {"quant_dispatch": DEEPSEEK_INT8, "int8_matmul": DEEPSEEK_INT8}
#: the INT8 stage's token counts M: a DP group's decode batch, the
#: unpadded first prompt, its padded prefill bucket, and a 512 bucket
INT8_M = (4, 37, 64, 512)
#: route-pack launches (one per MoE layer call) over each served path
PATH_PACKS = {DEEPSEEK: 68, LLAMA: 70}


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


def profile_calls(fn, reps: int = 20, warm: int = 3, tries: int = 3) -> dict:
    """``fn`` under ``torch.profiler`` over ``reps`` calls after warm-up:
    ``device_ms``, the CUDA kernels' own time per call, ``per_call``, the
    device kernels and memsets per call, and their ``names``, all from
    one window. Unlike :func:`time_ms` the time leaves out the host's
    launch work, which sets the event-timed figure of a call shorter than
    its launch cost. The profiler drops a single event now and then, so
    each kernel counts as its mean time times its launches per call (its
    count over ``reps``, rounded); more rarely it records nothing in a
    window, or drops most of one kernel's events (seen in fewer than
    half the calls), and the window is then profiled again, up to
    ``tries`` times. After that the last window that recorded anything
    is returned, or every figure is None: "not measured", never 0."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    got = dict(device_ms=None, per_call=None, names=[])
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.count]
        total = sum(e.self_device_time_total / e.count
                    * max(1, round(e.count / reps)) for e in ev)
        if total > 0:
            got = dict(device_ms=total / 1e3,
                       per_call=round(sum(e.count for e in ev) / reps, 2),
                       names=sorted(e.key for e in ev))
            if all(2 * e.count >= reps for e in ev):
                return got
    return got


def device_ms(fn, reps: int = 20, warm: int = 3):
    """The device time per call of :func:`profile_calls`, or None."""
    return profile_calls(fn, reps, warm)["device_ms"]


def one_launch(prof: dict, name: str, what: str) -> None:
    """Hold a :func:`profile_calls` window to one device kernel per call,
    the kernel ``name``: no memset, fill or second kernel beside it."""
    check(prof["per_call"] is not None and prof["device_ms"] is not None,
          f"{what}: measured under the profiler")
    check(len(prof["names"]) == 1 and round(prof["per_call"]) == 1
          and name in prof["names"][0],
          f"{what}: one launch per call, got {prof['per_call']} of "
          f"{prof['names']}")


def profile_turns(fa, fb, reps: int = 20, warm: int = 3,
                  tries: int = 3) -> tuple:
    """Device ms per call of ``fa`` and of ``fb`` called in turn (a, b,
    b, a, ...) in one ``torch.profiler`` window, each the sum of its own
    kernels' mean times (:func:`profile_calls` names them in a window of
    its own first: the two must launch kernels of different names). A
    window that misses a kernel is profiled again, up to ``tries``
    times. Returns (a ms, b ms, a's window, b's window)."""
    from torch.profiler import ProfilerActivity, profile

    pa, pb = profile_calls(fa, warm=warm), profile_calls(fb, warm=warm)
    na, nb = set(pa["names"]), set(pb["names"])
    check(bool(na) and bool(nb) and not na & nb,
          f"profile_turns: kernels told apart by name ({na} and {nb})")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(2 * reps):
                (fa, fb)[(i + i // 2) % 2]()
            torch.cuda.synchronize()
        ev = {e.key: e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.count}
        if na | nb <= set(ev):
            break
    check(na | nb <= set(ev), f"profile_turns: {na | nb} recorded")

    def per_call(names):
        return sum(ev[n].self_device_time_total / ev[n].count
                   * max(1, round(ev[n].count / reps)) for n in names) / 1e3
    return per_call(na), per_call(nb), pa, pb


def time_pair(fa, fb, reps: int = 50, warm: int = 3):
    """Median CUDA-event times of ``fa`` and ``fb`` (ms per call, as
    :func:`time_ms`), called in turn (a, b, b, a, ...) so that both
    meet the same card and host state."""
    for _ in range(warm):
        fa()
        fb()
    torch.cuda.synchronize()
    times = ([], [])
    for i in range(2 * reps):
        j = (i + i // 2) % 2                   # a b b a a b b a ...
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        (fa, fb)[j]()
        b.record()
        b.synchronize()
        times[j].append(a.elapsed_time(b))
    return statistics.median(times[0]), statistics.median(times[1])


def bound_ms(n_bytes: float, n_flops: float, peak: float = BF16_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / peak * 1e3
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
    for name in ("buckets", "scales", "eids", "rank", "keep", "counts"):
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


def exact(got, want, what: str) -> float:
    """Hold a kernel's output to its plain version: same shape and dtype
    and bit-identical, or the check fails. Returns the largest absolute
    difference, computed from the two tensors."""
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: shape and dtype")
    err = ((got.double() - want.double()).abs().max().item()
           if got.numel() else 0.0)
    check(torch.equal(got, want), f"{what}: bit-identical (max abs "
                                  f"difference {err})")
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
# stages 3 and 9: kernels against their plain versions
# ---------------------------------------------------------------------------
def bmm_chain(xb, g, u, dn):
    """The grouped SwiGLU FFN as PyTorch batched products (the library
    yardstick of gmm)."""
    h = torch.bmm(xb, g)
    return torch.bmm(torch.nn.functional.silu(h) * torch.bmm(xb, u),
                     dn).float()


def check_moe_kernels(cfg, counts, max_batch: int, weights=None) -> dict:
    """Route-pack, Collect, gmm and placement_gmm at a path's shapes.

    ``counts``: the token counts T of the path's packs; ``weights``: the
    expert weights (we_gate, we_up, we_down), or None to make random
    ones. Route-pack is held exactly at every T, over the E logical
    experts and over the E + 2 physical slots of an EPLB table that
    replicates two experts, and Collect at every N = T·k; gmm and
    placement_gmm as :func:`check_gmm` says, on the path's packs. Times
    are taken at the decode shape (T = ``max_batch``), and gmm's also at
    the shapes :func:`check_gmm` names."""
    from repro_torch.kernels.collect.kernel import collect_cuda
    from repro_torch.kernels.collect.ref import collect_ref
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

    def held_pack(x, dst, valid, ei, what, **kw):
        """One route-pack held to its plain version (the counts too, and
        those to Collect's plain version)."""
        got = route_pack_cuda(x, dst, valid, ei, **kw)
        err = pack_err(got, route_pack_ref(x, dst, valid, ei, **kw), what)
        if kw.get("count_ids") is not None:
            exact(got.counts, collect_ref(kw["count_ids"], kw["n_count"]),
                  f"{what}: counts against collect_ref")
        return err

    # -- route-pack: exact at every token count, over E and S slots, with
    # and without the count block (the path's form: logical ids counted,
    # as int32 dest without a placement and the router's int64 ids with)
    rp_err, packs = 0.0, {}
    for T in counts:
        N, cap = T * k, cap_of(T)
        x = torch.randn((T, d), generator=gen, device="cuda").to(bf16)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        tok_of = torch.arange(T, device="cuda").repeat_interleave(k)
        variants = ([(q, ei, None, False) for q in (False, True)
                     for ei in (None, eid)]
                    + [(True, eid, mask, False), (False, None, None, True),
                       (True, eid, mask, True)])
        for hot_n in (0, 12):
            dest = routed_dest(T, k, E, gen, hot_n)
            pdest = placement_route(dest, tok_of, rs, nr)
            for n_dest, dst, ids in ((E, dest, dest), (S, pdest, dest.long())):
                for quant, ei, valid, counted in variants:
                    kw = dict(k=k, n_dest=n_dest, capacity=cap,
                              quantize=quant)
                    if counted:
                        kw.update(count_ids=ids, n_count=E)
                    rp_err = max(rp_err, held_pack(
                        x, dst, valid, ei,
                        f"route_pack T={T} n_dest={n_dest} hot={hot_n} "
                        f"quantize={quant} eid={ei is not None} "
                        f"masked={valid is not None} counted={counted}",
                        **kw))
            if not hot_n:
                packs[T] = x, dest, pdest
        log(f"route_pack T={T} N={N} C={cap}: exact in "
            f"{4 * len(variants)} variants (n_dest {E} and {S}, spread and "
            f"hot routing x quantize x eid, masked, and with the count "
            f"block: counts equal to collect_ref)")
    # edge cases: padding rows (dest == n_dest, valid or masked), payload
    # rows off the 16-byte vector (f32 and bf16), a capacity past one
    # 256-slot window, and a call with no rows
    for T, dd, kk, n_dest, cap, dt in ((37, d, k, E, cap_of(37), bf16),
                                       (64, 100, 2, 3, 300, torch.float32),
                                       (16, 36, 1, 5, 4, bf16),
                                       (0, d, k, E, 4, bf16)):
        N = T * kk
        x = torch.randn((T, dd), generator=gen, device="cuda").to(dt)
        dest = torch.randint(0, n_dest, (N,), generator=gen, device="cuda",
                             dtype=torch.int32)
        pad = torch.rand((N,), generator=gen, device="cuda") < 0.2
        dest = torch.where(pad, torch.full_like(dest, n_dest), dest)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        # count ids with padding (-1) and ids at E or above mixed in
        wild = torch.randint(-1, E + 5, (N,), generator=gen, device="cuda")
        for quant in (False, True):
            for ei, valid, ids in ((None, None, None), (eid, mask, None),
                                   (eid, None, None), (None, None, wild),
                                   (eid, mask, wild.int())):
                kw = dict(k=kk, n_dest=n_dest, capacity=cap, quantize=quant)
                if ids is not None:
                    kw.update(count_ids=ids, n_count=E)
                rp_err = max(rp_err, held_pack(
                    x, dest, valid, ei,
                    f"route_pack edge T={T} d={dd} {dt} n_dest={n_dest} "
                    f"C={cap} quantize={quant} eid={ei is not None} "
                    f"masked={valid is not None} counted={ids is not None}",
                    **kw))
        log(f"route_pack edge T={T} d={dd} {dt} n_dest={n_dest} C={cap}, "
            f"padding rows: exact with and without quantize, eid, mask and "
            f"the count block (int64 and int32 ids, -1 and ids >= E)")
    # -- timed at decode, in the path's form: the pack counts the logical
    # ids (here dest itself: no placement) in the same launch
    x, dest, pdest = packs[max_batch]
    kw = dict(k=k, n_dest=E, capacity=cap_of(max_batch), quantize=False)
    cw = dict(kw, count_ids=dest, n_count=E)

    def rp():
        return route_pack_cuda(x, dest, None, None, **cw)

    def rp_alone():
        return route_pack_cuda(x, dest, None, None, **kw)

    def rp_then_collect():               # the two launches it replaces
        return rp_alone(), collect_cuda(dest, E)
    res = rp()
    bnd, by = bound_ms(nbytes(x, dest, res.buckets, res.rank, res.keep,
                              res.counts), 0)
    with_ms, alone_ms, prof, prof_alone = profile_turns(rp, rp_alone)
    one_launch(prof, "route_pack", f"route_pack T={max_batch} with counts")
    one_launch(prof_alone, "route_pack", f"route_pack T={max_batch}")
    check(with_ms <= 1.10 * alone_ms,
          f"route_pack T={max_batch}: device {with_ms} ms with the count "
          f"block within 10% of {alone_ms} ms without it, in turn")
    fused_ms, two_ms = time_pair(rp, rp_then_collect)
    check(fused_ms < two_ms,
          f"route_pack with counts: {fused_ms} ms below route_pack + "
          f"collect_cuda's {two_ms} ms, in turn")
    out = {"route_pack": dict(
        max_abs_err=rp_err, ms=time_ms(rp), device_ms=with_ms,
        device_ms_without_counts=alone_ms,
        kernels_per_call=prof["per_call"],
        plain_ms=time_ms(lambda: route_pack_ref(x, dest, None, None, **cw)),
        library_ms=None, bound_ms=bnd, bound_by=by)}
    log(f"route_pack T={max_batch}: device {with_ms:.4f} ms with the count "
        f"block, {alone_ms:.4f} without (in turn); events {fused_ms:.4f} ms "
        f"against {two_ms:.4f} for route_pack + collect_cuda (in turn)")

    out["collect"] = check_collect(counts, k, E, gen)
    out["collect"]["in_route_pack"] = dict(
        events_ms=fused_ms, events_ms_route_pack_then_collect=two_ms,
        device_ms=with_ms, device_ms_route_pack_alone=alone_ms)

    # -- gmm and placement_gmm at each capacity the path's packs have ----
    def pack(T, dst, n_dest):
        return route_pack_cuda(packs[T][0], dst, None, None, k=k,
                               n_dest=n_dest, capacity=cap_of(T),
                               quantize=False).buckets

    out.update(check_gmm(
        weights, owner, hot, counts, max_batch, cap_of, gen,
        lambda T: pack(T, packs[T][1], E), lambda T: pack(T, packs[T][2], S)))
    for name, r in out.items():
        log(f"  {name}: {r['ms']:.4f} ms, device {r['device_ms']} ms "
            f"(plain {r['plain_ms']:.4f} ms, library {r['library_ms']}, "
            f"bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    return out


def sparse_buckets(S: int, C: int, d: int, live: int, gen,
                   dtype=torch.bfloat16, full: bool = False):
    """[S, C, d] buckets, all zero but ``live`` random slots, which hold
    1..C leading rows of random values (all C if ``full``); in a live
    slot of three or more rows, row 1 is zero (a zero row between live
    ones)."""
    b = torch.zeros((S, C, d), device="cuda")
    slots = torch.randperm(S, generator=gen, device="cuda")[:live].tolist()
    n = (torch.full((live,), C) if full else
         torch.randint(1, C + 1, (live,), generator=gen, device="cuda"))
    for s, r in zip(slots, n.tolist()):
        b[s, :r] = torch.randn((r, d), generator=gen, device="cuda")
        if r >= 3:
            b[s, 1] = 0.0
    return b.to(dtype)


def check_gmm(weights, owner, hot, counts, max_batch: int, cap_of, gen,
              pack_experts, pack_slots) -> dict:
    """gmm and placement_gmm at a path's shapes.

    ``pack_experts(T)`` / ``pack_slots(T)``: the path's route-pack of T
    tokens into the E experts' / the EPLB table's S slots' buckets. Every
    call below is held to its plain version (3e-2 in bf16, 2e-4 in f32),
    its device-side rows (the kernel's prologue) to ``live_rows`` exactly,
    a second call bit-identical to it, and every all-zero bucket row to
    +0 in the output. The calls: each capacity the path's packs have
    (with identity owners bit-identical to gmm, and placement_gmm
    bit-identical to gmm on owner-gathered weights, 16 slots at a time: a
    whole copy at Llama-4 width would be 32 GB beside its 37 GB of
    weights); at the decode capacity an all-empty call (all +0), one live
    slot, partly filled rows; the float32 variant on 16 experts' weights.
    Timed: the decode packs of both, and for gmm a one-live-slot decode
    and the largest T of each capacity, each beside its live-slot count,
    its bound (live experts' weights read once), its dense-walk bound
    (every slot's weights), the plain version and ``bmm_chain``."""
    from repro_torch.kernels.gmm.kernel import gmm_cuda, gmm_cuda_with_rows
    from repro_torch.kernels.gmm.ref import (gmm_ref, live_rows,
                                             placement_gmm_ref)

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    wg, wu, wd = weights
    E, d, f = wg.shape
    S = owner.shape[0]
    o = owner.long()
    errs = {}

    def held(b, own, what, ws=weights):
        """One call held to the plain version, rows, repeat and zeros."""
        bar = 3e-2 if b.dtype == torch.bfloat16 else 2e-4
        got, rows = gmm_cuda_with_rows(b, *ws, own)
        want = (gmm_ref(b, *ws) if own is None
                else placement_gmm_ref(b, *ws, own))
        err = (got - want).abs().max().item()
        check(err <= bar, f"{what}: max abs err {err} <= {bar}")
        check(torch.equal(rows, live_rows(b)),
              f"{what}: the kernel's rows equal live_rows")
        check(torch.equal(gmm_cuda(b, *ws, own), got),
              f"{what}: two calls bit-identical")
        zero = ~(b != 0).any(dim=-1)
        check(bool((got[zero] == 0).all())
              and not bool(torch.signbit(got[zero]).any()),
              f"{what}: every all-zero bucket row gives +0")
        key = ("gmm" if own is None else "placement_gmm", str(b.dtype))
        errs[key] = max(errs.get(key, 0.0), err)
        return got, int((rows > 0).sum())

    by_cap = {}
    for T in sorted(counts):
        by_cap.setdefault(cap_of(T), T)     # the smallest T of a capacity
    ident = torch.arange(E, device="cuda", dtype=torch.int32)
    for T in by_cap.values():
        b = pack_experts(T)
        got, live = held(b, None, f"gmm T={T}")
        check(torch.equal(gmm_cuda(b, wg, wu, wd, ident), got),
              f"placement_gmm with identity owners bit-identical to gmm, "
              f"T={T}")
        pb = pack_slots(T)
        pgot, plive = held(pb, owner, f"placement_gmm T={T}")
        for s in range(0, S, 16):
            sub = [t[o[s:s + 16]] for t in (wg, wu, wd)]
            check(torch.equal(gmm_cuda(pb[s:s + 16], *sub), pgot[s:s + 16]),
                  f"placement_gmm bit-identical to gmm on owner-gathered "
                  f"weights, T={T}, slots {s}..{s + 15}")
            del sub
        torch.cuda.synchronize()
        log(f"gmm [{E},{b.shape[1]},{d}]x{f} ({live} live): rows, repeat "
            f"and zeros held; placement_gmm [{S},{pb.shape[1]},{d}] "
            f"({plive} live; replicas of experts {hot}): bit-identical to "
            f"gathered; max abs err vs plain {errs}")

    C = cap_of(max_batch)
    for own, n in ((None, E), (owner, S)):
        z, rows = gmm_cuda_with_rows(
            torch.zeros((n, C, d), dtype=wg.dtype, device="cuda"), wg, wu,
            wd, own)
        check(not bool(rows.any()) and bool((z == 0).all())
              and not bool(torch.signbit(z).any()),
              f"all-empty call ({n} slots): no live rows, output all +0")
    held(sparse_buckets(E, C, d, 1, gen, full=True), None, "gmm, one live "
         "slot")
    held(sparse_buckets(S, C, d, 1, gen, full=True), owner,
         "placement_gmm, one live slot")
    held(sparse_buckets(E, C, d, E // 4, gen), None, "gmm, partly filled")
    held(sparse_buckets(S, C, d, S // 4, gen), owner,
         "placement_gmm, partly filled")
    # float32 on 16 experts (the smoke engines' variant; a whole f32 copy
    # would be 45 GB at DeepSeek-V3 width), 4 more slots with replicas
    n = min(16, E)
    wf = [w[:n].float() for w in weights]
    own_f = (torch.cat([torch.arange(n), torch.tensor([3, 3, 9, 15]) % n])
             .to(device="cuda", dtype=torch.int32))
    for Cf in sorted({C, max(by_cap)}):
        held(sparse_buckets(n, Cf, d, 6, gen, torch.float32), None,
             f"gmm f32 C={Cf}", wf)
        held(sparse_buckets(n + 4, Cf, d, 7, gen, torch.float32), own_f,
             f"placement_gmm f32 C={Cf}", wf)
    del wf
    log(f"gmm: all-empty, one live slot, partly filled rows and float32 "
        f"held; max abs err vs plain {errs}")
    f32 = str(torch.float32)
    bf = str(torch.bfloat16)

    def timed(b, own) -> dict:
        ref = gmm_ref if own is None else (
            lambda *a: placement_gmm_ref(*a, own))
        rows = live_rows(b)
        live_slots = (rows > 0).nonzero().flatten()
        live = int(live_slots.numel())
        experts = int((live_slots if own is None else own[live_slots])
                      .unique().numel())
        io = nbytes(b, own) + b.numel() * 4
        n_rows = int(rows.sum())
        bnd, by = bound_ms(experts * 3 * d * f * 2 + io, 6 * n_rows * d * f)
        dense, _ = bound_ms(b.shape[0] * 3 * d * f * 2 + io,
                            6 * b.shape[0] * b.shape[1] * d * f)
        r = dict(shape=list(b.shape), nonempty_slots=live,
                 live_experts=experts, slots=b.shape[0],
                 ms=time_ms(lambda: gmm_cuda(b, wg, wu, wd, own)),
                 device_ms=device_ms(lambda: gmm_cuda(b, wg, wu, wd, own)),
                 plain_ms=time_ms(lambda: ref(b, wg, wu, wd)),
                 # no single PyTorch call takes an owner table
                 library_ms=(time_ms(lambda: bmm_chain(b, wg, wu, wd))
                             if own is None else None),
                 bound_ms=bnd, bound_by=by, bound_dense_walk_ms=dense)
        log(f"  {'gmm' if own is None else 'placement_gmm'} "
            f"{list(b.shape)} x {f}, {live} of {b.shape[0]} slots live: "
            f"{r['ms']:.4f} ms, device {r['device_ms']} ms, bound "
            f"{bnd:.4f} ms by {by}, dense walk {dense:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, bmm_chain {r['library_ms']}")
        return r

    res = {"gmm": timed(pack_experts(max_batch), None),
           "placement_gmm": timed(pack_slots(max_batch), owner)}
    res["gmm"]["max_abs_err"] = errs[("gmm", bf)]
    res["gmm"]["max_abs_err_f32"] = errs[("gmm", f32)]
    res["placement_gmm"]["max_abs_err"] = errs[("placement_gmm", bf)]
    res["placement_gmm"]["max_abs_err_f32"] = errs[("placement_gmm", f32)]
    largest = {}
    for T in sorted(counts):
        largest[cap_of(T)] = T
    res["gmm"]["shapes"] = {
        "one live slot, decode": timed(
            sparse_buckets(E, C, d, 1, gen, full=True), None),
        **{f"T={T}, C={c}": timed(pack_experts(T), None)
           for c, T in largest.items()}}
    return res


def check_collect(counts, k: int, E: int, gen) -> dict:
    """Collect exactly against its plain version at every N = T·k the
    path routes, on routed ids (int64, as the router's top-k gives them)
    and on int32 ids with -1 and ids at E or above mixed in; its counts
    sum to the number of valid ids. Timed at the decode shape (the first
    T) on routed ids."""
    from repro_torch.kernels.collect.kernel import collect_cuda
    from repro_torch.kernels.collect.ref import collect_ref

    err = 0.0
    for T in counts:
        N = T * k
        routed = torch.rand((T, E), generator=gen, device="cuda").topk(
            k, dim=-1).indices.reshape(-1)
        mixed = torch.randint(-1, E, (N,), generator=gen, device="cuda",
                              dtype=torch.int32)
        wild = torch.rand((N,), generator=gen, device="cuda") < 0.15
        mixed[wild] = E + torch.randint(0, 3 * E, (N,), generator=gen,
                                        device="cuda",
                                        dtype=torch.int32)[wild]
        for name, ids in (("routed int64", routed), ("mixed int32", mixed)):
            got = collect_cuda(ids, E)
            err = max(err, exact(got, collect_ref(ids, E),
                                 f"collect N={N} E={E} {name}"))
            check(int(got.sum()) == int(((ids >= 0) & (ids < E)).sum()),
                  f"collect N={N}: the counts sum to the valid ids")
        log(f"collect N={N} E={E}: exact on routed int64 ids and on int32 "
            f"ids with -1 and ids >= E mixed in")
    ids = torch.rand((counts[0], E), generator=gen, device="cuda").topk(
        k, dim=-1).indices.reshape(-1)
    bnd, by = bound_ms(nbytes(ids) + E * 4, 0)
    return dict(max_abs_err=err, n=ids.numel(),
                ms=time_ms(lambda: collect_cuda(ids, E)),
                device_ms=device_ms(lambda: collect_cuda(ids, E)),
                plain_ms=time_ms(lambda: collect_ref(ids, E)),
                library_ms=time_ms(lambda: torch.bincount(ids, minlength=E)),
                library="torch.bincount", bound_ms=bnd, bound_by=by)


# ---------------------------------------------------------------------------
# stage 9: decode attention against its plain version
# ---------------------------------------------------------------------------
def attention_err(got, want) -> tuple:
    """(max abs err, scaled err) of decode attention's output [B, H, hd]
    against the plain version's. The scaled error is the largest of any
    row (b, head) over that row's scale, min(1, max |want|): with
    near-uniform scores an output is a mean of many values, far below 1,
    where a bar on the absolute error could not tell a wrong kernel
    (zeros, a dropped split or warp) from a right one. NaN reads as
    failed."""
    d = (got - want).abs()
    scale = want.abs().amax(-1).clamp(min=1e-30, max=1.0)
    scaled = (d.amax(-1) / scale).max().item()
    return d.max().item(), scaled


def held_attention(got, want, bar: float, what: str) -> tuple:
    """Check decode attention's output within ``bar`` of the plain
    version's, both as an absolute error and scaled by each row's
    output (:func:`attention_err`); returns both errors."""
    err, scaled = attention_err(got, want)
    check(bool(torch.isfinite(got).all()) and err <= bar and scaled <= bar,
          f"decode_attention {what}: max abs err {err}, scaled by the "
          f"output {scaled}, within {bar}")
    return err, scaled


def check_decode_attention(cfg, max_batch: int, max_len: int) -> dict:
    """Decode attention at the path's shape and around it, in bf16 and
    float32, against the plain version (:func:`held_attention`), with
    the slots past each row's position NaN-filled where the row does not
    attend to them (a stale cache tail the kernel must never read), and
    a repeat of every call bit-identical; then timed (CUDA events and
    device time) at the path's shape and at L 8192, 32768 and 131072
    (every row at the last slot, so the whole cache is read), and on a
    ragged batch at L 32768 (positions L-1, L/2, 100, 0), each beside
    its bound from the slots the data needs, the plain version and
    ``scaled_dot_product_attention``. One call must be one launch, no
    slower than SDPA's (events, called in turn) at L <= 32768 with every
    row full, and at L 32768 within 2x its bound on the device."""
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

    def inputs(H, KV, L, dtype, pos, heads_alloc=None, hd=hd, q_scale=1.0):
        """q, k, v, positions; ``heads_alloc`` > KV makes k/v views of a
        wider cache (a head stride that is not KV * hd); ``q_scale``
        widens the scores (std 0.25 at 1). The random values past each
        row's position stand for stale slots."""
        n = heads_alloc or KV
        k = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        v = rand(B, L, n, hd).to(dtype)[:, :, :KV]
        return ((rand(B, H, hd) * q_scale).to(dtype), k, v,
                torch.tensor(pos, dtype=torch.int32, device="cuda"))

    last = [L - 1] * B
    cases = [  # name, H, KV, L, window, positions, heads_alloc, hd, q_scale
        ("path", H, KV, L, 0, [0, L - 1, L // 2 + 3, 37], None, hd, 1.0),
        ("ragged L=1000", H, KV, 1000, 0, [999, 0, 517, 1], None, hd, 1.0),
        ("ring window 256", H, KV, 256, 256, [255, 256, 700, 1500], None,
         hd, 1.0),
        ("ring window 256, ragged L=250", H, KV, 250, 256,
         [249, 300, 1000, 0], None, hd, 1.0),
        ("ring window 256, early rows", H, KV, 256, 256, [255, 20, 5, 0],
         None, hd, 1.0),
        ("G=1", KV, KV, L, 0, last, None, hd, 1.0),
        ("G=8", 8 * KV, KV, L, 0, [5, L - 1, 600, 0], None, hd, 1.0),
        ("strided cache view", H, KV, L, 0, [L - 1, 3, 800, 64], 2 * KV,
         hd, 1.0),
        # the other head sizes the wrapper takes (32: the smoke model's)
        ("hd=64", H, KV, L, 0, [L - 1, 0, 300, 901], None, 64, 1.0),
        ("hd=32", H, KV, 1000, 0, [999, 12, 0, 640], None, 32, 1.0),
        # peaked scores (std 4): the running max moves between tiles and
        # splits, and the outputs are of order 1
        ("peaked scores", H, KV, L, 0, [L - 1, 700, 64, 3], None, hd, 16.0),
    ]
    errs = {}
    for dtype, bar in ((torch.bfloat16, 3e-2), (torch.float32, 2e-4)):
        for name, h, kv, length, w, pos, alloc, d, qs in cases:
            q, k, v, p = inputs(h, kv, length, dtype, pos, alloc, d, qs)
            want = decode_attention_ref(q, k, v, p, window=w)
            got = decode_attention_cuda(q, k, v, p, window=w)
            # the same call with every slot the rows do not attend to
            # NaN-filled: the stale tail must not reach the output
            stale = ~valid_slots(p, length, w)[:, :, None, None]
            k.masked_fill_(stale, float("nan"))
            v.masked_fill_(stale, float("nan"))
            nan_got = decode_attention_cuda(q, k, v, p, window=w)
            again = decode_attention_cuda(q, k, v, p, window=w)
            torch.cuda.synchronize()
            what = f"{name} {dtype}"
            e1 = held_attention(got, want, bar, what)
            e2 = held_attention(nan_got, want, bar, what + ", NaN tail")
            check(torch.equal(nan_got, again),
                  f"decode_attention {what}: repeat bit-identical")
            errs[(name, str(dtype))] = (max(e1[0], e2[0]), max(e1[1], e2[1]))
            log(f"decode_attention {name} [{B},{h},{d}] x L={length} "
                f"window={w} {str(dtype)[6:]}: max abs err "
                f"{errs[(name, str(dtype))][0]:.3g}, scaled "
                f"{errs[(name, str(dtype))][1]:.3g} (NaN tail too), repeat "
                f"bit-identical")

    def timed(L, pos):
        q, k, v, p = inputs(H, KV, L, torch.bfloat16, pos)
        valid = valid_slots(p, L)
        mask = valid[:, None, None, :]

        def kernel():
            return decode_attention_cuda(q, k, v, p)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        want = decode_attention_ref(q, k, v, p)
        err, scaled = held_attention(kernel(), want, 3e-2, f"timed L={L}")
        lib_err = attention_err(sdpa()[:, :, 0].float(), want)
        del want
        rows = int(valid.sum())                # cache slots the data needs
        bnd, by = bound_ms(rows * KV * hd * 2 * 2 + nbytes(q, p)
                           + B * H * hd * 4, 4 * rows * H * hd)
        prof = profile_calls(kernel)
        one_launch(prof, "decode_attention", f"decode_attention L={L}")
        ms, lib_ms = time_pair(kernel, sdpa)
        res = dict(ms=ms, device_ms=prof["device_ms"],
                   plain_ms=time_ms(lambda: decode_attention_ref(q, k, v, p),
                                    reps=5, warm=1),
                   library_ms=lib_ms, library_device_ms=device_ms(sdpa),
                   library_max_abs_err=lib_err[0],
                   library_scaled_err=lib_err[1], max_abs_err=err,
                   scaled_err=scaled, bound_ms=bnd, bound_by=by,
                   slots_needed=rows, kernels_per_call=prof["per_call"],
                   positions=pos)
        log(f"decode_attention timed L={L} positions {pos}: "
            f"{res['ms']:.4f} ms (device {res['device_ms']}), plain "
            f"{res['plain_ms']:.4f}, SDPA {res['library_ms']:.4f} (device "
            f"{res['library_device_ms']}), bound {bnd:.4f} ms ({by}); err "
            f"{err:.3g}, scaled {scaled:.3g}")
        return res
    out = timed(L, last)
    for n in (8192, 32768, 131072):
        out[f"long_context_L{n}"] = timed(n, [n - 1] * B)
        gc.collect()
        torch.cuda.empty_cache()
    out["ragged_L32768"] = timed(32768, [32767, 16384, 100, 0])
    for n, t in ((L, out), (8192, out["long_context_L8192"]),
                 (32768, out["long_context_L32768"])):
        check(t["ms"] <= t["library_ms"],
              f"decode_attention L={n}: {t['ms']} ms no slower than "
              f"scaled_dot_product_attention's {t['library_ms']} ms")
    t = out["long_context_L32768"]
    check(t["device_ms"] <= 2 * t["bound_ms"],
          f"decode_attention L=32768: device {t['device_ms']} ms within 2x "
          f"its bound {t['bound_ms']} ms")
    timed_runs = [t for t in out.values() if isinstance(t, dict)] + [out]
    bf16 = [e for (_, dt), e in errs.items() if dt == "torch.bfloat16"]
    out["max_abs_err"] = max([e for e, _ in bf16]
                             + [t["max_abs_err"] for t in timed_runs])
    out["max_scaled_err"] = max([s for _, s in bf16]
                                + [t["scaled_err"] for t in timed_runs])
    f32 = [e for (_, dt), e in errs.items() if dt == "torch.float32"]
    out["max_abs_err_f32"] = max(e for e, _ in f32)
    out["max_scaled_err_f32"] = max(s for _, s in f32)
    return out


# ---------------------------------------------------------------------------
# stage 4: the main path at full width
# ---------------------------------------------------------------------------
def serve(engine, prompts, n_new: int, **kw):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=n_new, ignore_eos=True, **kw)
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
    """Stands in for the MoE layer's route-pack entry point, counts its
    calls and those that asked for EPLB Collect's counts, and keeps a
    copy of the inputs of the first call of each shape, so that the
    path's own packs (and their counts) can be held against the plain
    versions afterwards."""

    def __init__(self, fn):
        self.fn, self.calls = fn, {}
        self.n_calls = self.n_counted = 0

    def __call__(self, x, dest, valid=None, eid=None, **kw):
        kw = {"k": 1, "quantize": False, **kw}     # the entry's defaults
        ids = kw.get("count_ids")
        self.n_calls += 1
        self.n_counted += ids is not None
        key = (x.shape[0], kw["n_dest"], kw["capacity"], x.dtype,
               kw["quantize"], valid is not None, eid is not None,
               None if ids is None else ids.dtype)
        if key not in self.calls:
            if ids is not None:
                kw["count_ids"] = ids.clone()
            self.calls[key] = (x.clone(), dest.clone(),
                               None if valid is None else valid.clone(),
                               None if eid is None else eid.clone(), kw)
        return self.fn(x, dest, valid, eid, **kw)


def replay_packs(rec: PackRecorder, cfg) -> tuple:
    """The path's own route-packs, one of each shape, on the kernel and
    on the plain version: exact, their counts too, and those equal to
    Collect's plain version on the pack's count ids: logical expert ids,
    which under a placement are not the physical slots the pack routes
    to. Every pack of the path must have counted. Returns the largest
    differences of the packs and of the counts."""
    from repro_torch.kernels.collect.ref import collect_ref
    from repro_torch.kernels.route_pack.kernel import route_pack_cuda
    from repro_torch.kernels.route_pack.ref import route_pack_ref

    E, err, c_err = cfg.moe.num_experts, 0.0, 0.0
    check(rec.n_counted == rec.n_calls,
          f"every MoE layer call's pack counted its ids "
          f"({rec.n_counted} of {rec.n_calls})")
    placed = plain = 0
    for (T, n_dest, cap, *_), (x, dest, valid, eid, kw) in rec.calls.items():
        what = f"path route_pack T={T} n_dest={n_dest}"
        got = route_pack_cuda(x, dest, valid, eid, **kw)
        err = max(err, pack_err(got, route_pack_ref(x, dest, valid, eid,
                                                    **kw), what))
        ids = kw["count_ids"]
        check(kw["n_count"] == E, f"{what}: counts over the {E} experts")
        c_err = max(c_err, exact(got.counts, collect_ref(ids, E),
                                 f"{what}: counts against collect_ref"))
        if n_dest > E:           # physical slots routed, logical counted
            placed += 1
            check(ids.dtype == torch.int64 and bool((ids < E).all()),
                  f"{what}: the router's logical ids counted")
        else:
            plain += 1
    shapes = sorted((T, n, c) for T, n, c, *_ in rec.calls)
    check(placed > 0 and plain > 0,
          "packs with and without a placement were replayed")
    check(any(T * cfg.moe.top_k > 256 for T, _, _ in shapes),
          "a pack spanning more than one rank-scan tile was replayed")
    log(f"path route_pack replayed exactly at (T, n_dest, C) {shapes}, "
        f"counts equal to collect_ref ({placed} with a placement)")
    return err, c_err


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


def run_path(engine, prompts, prompts_eplb, kernels,
             before_close=None) -> dict:
    """Serve ``prompts``, run a skewed EPLB pass, serve
    ``prompts_eplb``, with every launch count set to 0 just before and
    read just after: each of ``kernels`` must have launched. Then replay
    the path's packs and Collect calls, profile decode, call
    ``before_close(engine, requests)`` if given (its result goes under
    ``"stage"``), and close the engine."""
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
        launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
        check(all(launches.get(n, 0) > 0 for n in kernels),
              f"every kernel launched on the path: {launches}")
        check(launches["placement_gmm"] > before.get("placement_gmm", 0),
              "placement_gmm ran after EPLB")
        # EPLB Collect: in every route-pack launch, never on its own
        check(launches.get("collect", 0) == 0
              and fused.get("collect", 0) == launches["route_pack"]
              == rec.n_calls == PATH_PACKS[cfg.name],
              f"Collect ran in each of the path's {PATH_PACKS[cfg.name]} "
              f"route-pack launches and never alone: launches {launches}, "
              f"fused {fused}, MoE layer calls {rec.n_calls}")

        # the output is finite: logits of one prompt through the model
        tok = torch.tensor([engine.tokenizer.encode(prompts[0])],
                           device=engine.device)
        with torch.no_grad():
            logits, _ = engine.model.prefill(engine.params, tok)
        check(bool(torch.isfinite(logits).all()), "finite logits")
    replay_err, collect_err = replay_packs(rec, cfg)
    del rec
    profile = profile_decode(engine)
    check_decode_repeat(engine)
    everyone = reqs + reqs2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stage = before_close(engine, everyone) if before_close else None
    ttft = [r.ttft for r in everyone]
    tpot = [r.tpot for r in everyone]
    res = dict(launches=launches, fused=fused, launches_before_eplb=before,
               route_pack_replay_err=replay_err,
               collect_replay_err=collect_err,
               ttft_ms_mean=1e3 * statistics.mean(ttft),
               ttft_ms_max=1e3 * max(ttft),
               tpot_ms_mean=1e3 * statistics.mean(tpot),
               tpot_ms_max=1e3 * max(tpot),
               ttft_ms=[1e3 * t for t in ttft],
               # the first wave pays the process's cold costs
               ttft_ms_mean_by_wave=[1e3 * statistics.mean(r.ttft for r in w)
                                     for w in (reqs, reqs2)],
               serve_s=[wall, wall2],
               peak_mem_gib=peak,
               decode_profile=profile, stage=stage,
               tokens={r.prompt: list(r.output_tokens) for r in everyone},
               text=engine.tokenizer.decode(reqs[0].output_tokens))
    engine.close()
    log(f"path: {len(everyone)} requests x 16 tokens served in {wall:.2f} "
        f"s + {wall2:.2f} s; TTFT mean {res['ttft_ms_mean']:.1f} ms (by "
        f"wave {res['ttft_ms_mean_by_wave'][0]:.1f}, "
        f"{res['ttft_ms_mean_by_wave'][1]:.1f}), TPOT "
        f"mean {res['tpot_ms_mean']:.2f} ms, peak memory "
        f"{res['peak_mem_gib']:.2f} GiB; launches {launches}")
    return res


def check_decode_repeat(engine) -> None:
    """One full-batch decode step of a DP group (every slot prefilled
    with its own prompt, the EPLB placement installed), run twice from
    copies of the same cache with the same inputs: the logits must be
    bit-identical, so the MoE combine sums in a fixed order."""
    from repro_torch.models.common import tree_map

    dp = engine.dps[0]
    be, B = dp.backend, dp.max_batch
    check(be._placement is not None, "an EPLB placement is installed")
    cache = be.init_cache(B, dp.max_len)
    lens = []
    for i in range(B):
        toks = engine.tokenizer.encode(f"repeat {i}: " + PROMPTS[i % 4])
        cache1, _ = be.prefill(toks)
        be.write_slot(cache, cache1, i)
        lens.append(len(toks))
    tokens = torch.arange(7, 7 + B, dtype=torch.int32,
                          device=engine.device)[:, None]
    positions = torch.tensor(lens, dtype=torch.int32, device=engine.device)
    logits = []
    with torch.no_grad():
        for _ in range(2):
            out, _ = be.model.decode_step(be.params,
                                          tree_map(torch.clone, cache),
                                          tokens, positions,
                                          placement=be._placement)
            logits.append(out)
    torch.cuda.synchronize()
    check(torch.equal(logits[0], logits[1]),
          f"{engine.cfg.name}: a decode step run twice gives bit-identical "
          f"logits")
    log(f"decode repeat: {engine.cfg.name} full-batch decode step (B {B}) "
        f"twice from one cache: logits bit-identical")


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
    attention = sum(ms for k, ms in kernels if "decode_attention" in k)
    check(0 < busy <= prof_wall, f"device busy {busy} ms per step within "
          f"the profiled step's {prof_wall} ms")
    engine.run_until_done()
    res = dict(engine_step_ms=wall, profiled_step_ms=prof_wall,
               device_busy_ms=busy, device_idle_share=1.0 - busy / prof_wall,
               decode_attention_ms=attention,
               dp_groups=len(engine.dps),
               batch_per_group=engine.dps[0].max_batch,
               top_kernels_ms=[(k[:60], ms) for k, ms in kernels[:8]])
    log(f"decode profile: engine step {wall:.2f} ms (host clock), "
        f"{prof_wall:.2f} ms under the profiler, device busy {busy:.2f} ms, "
        f"idle share {res['device_idle_share']:.4f} of the profiled step; "
        f"decode attention {attention:.4f} ms of it")
    for k, ms in res["top_kernels_ms"]:
        log(f"  {ms:8.3f} ms/step  {k}")
    return res


# ---------------------------------------------------------------------------
# stage 6: MTP speculative decoding (§4.6) on the served DeepSeek-V3
# ---------------------------------------------------------------------------
class MTPRecorder:
    """Stands in for a DP group's ``decode_sample_mtp`` and checks each
    iteration as it runs: route-pack (with Collect's count block), and
    gmm before EPLB or placement_gmm after it, launch ``k + 1`` times per
    MoE layer, Collect never alone, ``_logits`` ``2k + 1`` times and
    never in the draft-cache fill pass. Keeps every iteration's block
    and accepted counts and which slots were busy."""

    def __init__(self, dp, logits_calls: dict, n_moe: int):
        self.dp, self.real = dp, dp.backend.decode_sample_mtp
        self.logits_calls, self.n_moe = logits_calls, n_moe
        self.iters = []
        dp.backend.decode_sample_mtp = self

    def __call__(self, *a, **kw):
        from repro_torch.kernels import runtime

        be, k = self.dp.backend, self.dp.mtp_k
        busy = [not s.free for s in self.dp.slots]
        before = (dict(runtime.LAUNCHES), dict(runtime.FUSED),
                  dict(self.logits_calls))
        out = self.real(*a, **kw)
        after = (runtime.LAUNCHES, runtime.FUSED, self.logits_calls)
        d = [{n: c.get(n, 0) - b.get(n, 0) for n in c}
             for b, c in zip(before, after)]
        moe = (k + 1) * self.n_moe
        ffn = "gmm" if be._placement is None else "placement_gmm"
        check(d[0].get("route_pack", 0) == d[0].get(ffn, 0) == moe
              and d[0].get("collect", 0) == 0
              and d[1].get("collect", 0) == moe
              and sum(d[0].values()) == 2 * moe,
              f"MTP k={k} iteration: route-pack (with Collect) and {ffn} "
              f"{moe} times each, nothing else: launches {d[0]}, fused "
              f"{d[1]}")
        check(d[2].get("all", 0) == 2 * k + 1 and d[2].get("fill", 0) == 0,
              f"MTP k={k} iteration: _logits {2 * k + 1} times, none in "
              f"the fill pass: {d[2]}")
        self.iters.append(dict(block=out[0].cpu(), n_acc=out[1].cpu(),
                               busy=torch.tensor(busy)))
        return out

    def restore(self) -> None:
        self.dp.backend.decode_sample_mtp = self.real


def mtp_counters(engine, n_moe: int) -> tuple:
    """Count ``_logits`` calls on the engine's model (and those made in
    a backend's fill pass) and install an :class:`MTPRecorder` on each
    DP group. Returns the counts, the recorders and a function that
    takes all of it off again."""
    calls = {"all": 0, "fill": 0, "in_fill": False}
    model = engine.model
    logits = model._logits

    def counted(*a, **kw):
        calls["all"] += 1
        calls["fill"] += calls["in_fill"]
        return logits(*a, **kw)
    model._logits = counted
    for dp in engine.dps:
        fill = dp.backend._mtp_fill

        def flagged(*a, _fill=fill, **kw):
            calls["in_fill"] = True
            try:
                return _fill(*a, **kw)
            finally:
                calls["in_fill"] = False
        dp.backend._mtp_fill = flagged
    recs = [MTPRecorder(dp, calls, n_moe) for dp in engine.dps]

    def undo():
        del model._logits
        for dp, rec in zip(engine.dps, recs):
            del dp.backend._mtp_fill
            rec.restore()
    return calls, recs, undo


def acceptance(iters) -> dict:
    """Acceptance over the busy slots of recorded iterations."""
    n = torch.cat([it["n_acc"][it["busy"]] for it in iters])
    k = iters[0]["block"].shape[1] - 1
    return dict(iterations=len(iters), slot_iterations=int(n.numel()),
                acceptance=float(n.sum()) / max(k * n.numel(), 1),
                tokens_per_iteration=float((n + 1).float().mean()),
                full_blocks=int((n == k).sum()),
                rejected_blocks=int((n < k).sum()))


def mtp_split(engine) -> dict:
    """Device time of one DP group's MTP iteration at a full batch, split
    into the draft chain, the verify chain and the fill pass, beside the
    whole iteration and the plain one-token ``decode_sample`` from the
    same state (``profile_calls``: each phase called alone on copies of
    the group's caches)."""
    from repro_torch.models.common import tree_map
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.request import Request

    dp = engine.dps[0]
    be = dp.backend
    for i in range(sum(d.max_batch for d in engine.dps)):
        engine.submit(Request(prompt=f"split prompt {i}", max_new_tokens=24,
                              ignore_eos=True))
    for _ in range(3):
        engine.step()
    check(dp.active == dp.max_batch, "every slot decoding while split")
    tokens, positions, temps, _ = dp._gather_step_inputs()
    cache = tree_map(torch.clone, dp.cache)
    mtp = tree_map(torch.clone, dp.mtp_cache)
    toks, pos = be._ints(tokens), be._ints(positions)
    t = torch.as_tensor(temps, device=be.device)
    with torch.no_grad():
        drafts, _ = be._mtp_draft(mtp, toks, pos, t, 0, False)
        _, hiddens = be._mtp_verify(cache, toks, pos, drafts)
        phases = {
            "draft": lambda: be._mtp_draft(mtp, toks, pos, t, 0, False),
            "verify": lambda: be._mtp_verify(cache, toks, pos, drafts),
            "fill": lambda: be._mtp_fill(mtp, hiddens, drafts, pos),
            "iteration": lambda: TorchBackend.decode_sample_mtp(
                be, cache, mtp, tokens, positions, temps, 0),
            "plain_decode_sample": lambda: TorchBackend.decode_sample(
                be, cache, tokens, positions, temps, 0)}
        res = {f"{n}_ms": profile_calls(fn, reps=5, warm=1)["device_ms"]
               for n, fn in phases.items()}
    engine.run_until_done()
    return res


def mtp_rollback(engine, rec: MTPRecorder) -> dict:
    """One ``inject_fault=True`` iteration of DP group 0 at a full batch,
    half the slots greedy and half at temperature 0.7: the faulted run
    and its replay each give the blocks and accepted counts of the
    fault-free iteration from the same state (``donate=False`` keeps
    it)."""
    from repro_torch.serving.request import Request

    dp = engine.dps[0]
    for i in range(sum(d.max_batch for d in engine.dps)):
        engine.submit(Request(prompt=f"rollback prompt {i}",
                              max_new_tokens=16, ignore_eos=True,
                              temperature=0.7 * ((i // 2) % 2)))
    for _ in range(3):
        engine.step()
    check(dp.active == dp.max_batch, "every slot decoding at the rollback")
    tokens, positions, temps, _ = dp._gather_step_inputs()
    check(bool((temps > 0).any() and (temps == 0).any()),
          "greedy and sampled slots at the rollback")
    n = len(rec.iters)
    dp.backend.decode_sample_mtp(dp.cache, dp.mtp_cache, tokens, positions,
                                 temps, dp.steps, donate=False)
    dp.decode_step_all(inject_fault=True)
    want, *runs = rec.iters[n:]
    check(len(runs) == 2 and all(
        torch.equal(r["block"], want["block"])
        and torch.equal(r["n_acc"], want["n_acc"]) for r in runs),
        "MTP rollback: the faulted iteration and its replay give the "
        "fault-free blocks and accepted counts")
    engine.run_until_done()
    return dict(block=want["block"].tolist(), n_acc=want["n_acc"].tolist())


class OracleHead:
    """Stands in for a DP group's model: the MTP head's logits get a
    peak at the token the plain engine emitted at the next position of
    each slot's request, so drafts are accepted as a well-trained head's
    would be; ``wrong`` names output indices whose draft is made wrong
    (a rejection in the middle of a block, leaving junk in both caches).
    The table of targets lives on the card and changes only when a
    slot's request does, so the head adds no host sync."""

    PEAK = 1e4

    def __init__(self, model, dp, plain: dict, wrong=()):
        self.model, self.dp, self.plain, self.wrong = model, dp, plain, wrong
        self.table = torch.zeros((dp.max_batch, dp.max_len),
                                 dtype=torch.long, device=dp.backend.device)
        self.owner = [None] * dp.max_batch

    def __getattr__(self, name):
        return getattr(self.model, name)

    def mtp_step(self, params, idx, hidden, tokens, positions, cache=None):
        for b, s in enumerate(self.dp.slots):
            if s.req is not None and s.req is not self.owner[b]:
                row = [0] * self.dp.max_len
                for i, t in enumerate(self.plain[s.req.prompt]):
                    if s.req.prompt_len + i < self.dp.max_len:
                        row[s.req.prompt_len + i] = (
                            t + 1 if i in self.wrong else t)
                self.table[b] = torch.tensor(row, device=self.table.device)
                self.owner[b] = s.req
        logits, h, cache = self.model.mtp_step(params, idx, hidden, tokens,
                                               positions, cache)
        rows = torch.arange(self.table.shape[0], device=self.table.device)
        tgt = self.table[rows, torch.clamp(positions.long() + 1,
                                           max=self.table.shape[1] - 1)]
        logits = logits.index_put((rows, tgt), torch.full_like(
            tgt, self.PEAK, dtype=logits.dtype), accumulate=True)
        return logits, h, cache


def oracle_wave(engine, plain: dict, prompts, n_new: int,
                wrong=()) -> tuple:
    """Serve ``prompts`` with every DP group's head replaced by an
    :class:`OracleHead`: the tokens must still equal the plain engine's.
    Returns the requests and the host-clock wall time."""
    models = [dp.backend.model for dp in engine.dps]
    for dp in engine.dps:
        dp.backend.model = OracleHead(dp.backend.model, dp, plain, wrong)
    try:
        reqs, wall = serve(engine, prompts, n_new)
    finally:
        for dp, m in zip(engine.dps, models):
            dp.backend.model = m
    differ = [r.prompt for r in reqs if r.output_tokens != plain[r.prompt]]
    check(not differ, f"mtp_k={engine.dps[0].mtp_k}, oracle head (wrong "
                      f"drafts at output indices {sorted(wrong)}): tokens "
                      f"equal the plain engine's; differ: {differ}")
    return reqs, wall


def mtp_path(cfg, params, k: int, plain: dict, placement) -> dict:
    """Serve the plain path's greedy prompts with ``mtp_k=k`` on the
    plain engine's weights, with the same EPLB pass: every request's
    tokens equal the plain engine's, with the random head and, before
    EPLB and after it, with an oracle head. Then 4 requests at
    temperature 0.7 and one rolled-back iteration, all with the launch
    counts set to 0 just before and read just after. With the recorders
    taken off (each syncs the host once per iteration): the greedy
    waves again, for TPOT, an oracle wave, the device split and a decode
    profile."""
    import numpy as np

    from repro_torch.kernels import runtime
    from repro_torch.serving.flowserve import FlowServeEngine

    engine = FlowServeEngine(cfg, params=params, device="cuda",
                             n_dp_groups=2, seed=0, max_batch=4, mtp_k=k)
    calls, recs, undo = mtp_counters(engine, len(moe_layers(cfg)))

    def since(marks):
        return [it for rec, n in zip(recs, marks) for it in rec.iters[n:]]

    def equal_plain(reqs, what):
        differ = [(r.prompt, next(i for i, (a, b) in enumerate(
            zip(r.output_tokens, plain[r.prompt])) if a != b),
            r.output_tokens, plain[r.prompt]) for r in reqs
            if r.output_tokens != plain[r.prompt]]
        check(not differ, f"MTP k={k}, {what}: every request gives the "
                          f"plain engine's tokens; differ (prompt, first "
                          f"index, MTP, plain): {differ}")

    runtime.reset_launch_counts()
    reqs, wall = serve(engine, PROMPTS, 16)
    greedy = [it for rec in recs for it in rec.iters]
    # full and partial blocks on gmm (no placement yet)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS, 16, wrong={5})
    before_eplb = acceptance(since(marks))
    check(before_eplb["full_blocks"] > 0
          and before_eplb["rejected_blocks"] >= len(PROMPTS),
          f"MTP k={k}, oracle head before EPLB: full blocks and the wrong "
          f"drafts rejected: {before_eplb}")
    engine.record_expert_counts(skewed_counts(cfg))
    engine.run_eplb()
    got = engine.dps[0].backend._placement
    check(all(np.array_equal(getattr(got, f).cpu(), getattr(placement, f)
                             .cpu()) for f in ("replica_slots", "n_replicas",
                                               "phys_owner")),
          "the MTP engine's EPLB pass installed the plain path's placement")
    marks = [len(rec.iters) for rec in recs]
    reqs2, wall2 = serve(engine, PROMPTS_EPLB, 16)
    greedy += since(marks)
    equal_plain(reqs + reqs2, "random head")
    marks = [len(rec.iters) for rec in recs]
    sampled, wall3 = serve(engine, PROMPTS, 16, temperature=0.7)
    temp = since(marks)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS_EPLB, 16)
    full = since(marks)
    marks = [len(rec.iters) for rec in recs]
    oracle_wave(engine, plain, PROMPTS_EPLB, 16, wrong={5})
    rejected = acceptance(since(marks))
    check(rejected["rejected_blocks"] >= len(PROMPTS_EPLB),
          f"MTP k={k}, oracle head: the wrong drafts were rejected")
    rollback = mtp_rollback(engine, recs[0])
    launches, fused = dict(runtime.LAUNCHES), dict(runtime.FUSED)
    check(launches.get("collect", 0) == 0 and fused.get("collect", 0)
          == launches.get("route_pack", 0) > 0,
          f"MTP k={k}: Collect in every route-pack, never alone: "
          f"{launches}, {fused}")
    undo()
    timed, wall4 = serve(engine, PROMPTS, 16)
    timed2, wall5 = serve(engine, PROMPTS_EPLB, 16)
    equal_plain(timed + timed2, "unrecorded")
    oracle, wall6 = oracle_wave(engine, plain, PROMPTS_EPLB, 16)
    split = mtp_split(engine)
    profile = profile_decode(engine)
    engine.close()
    everyone = timed + timed2
    res = dict(k=k, launches=launches, fused=fused,
               greedy=acceptance(greedy), temperature_0_7=acceptance(temp),
               tpot_ms_mean=1e3 * statistics.mean(r.tpot for r in everyone),
               tpot_ms_max=1e3 * max(r.tpot for r in everyone),
               ttft_ms_mean=1e3 * statistics.mean(r.ttft for r in everyone),
               # the same prompts served earlier under the recorders
               tpot_ms_mean_recorded=1e3 * statistics.mean(
                   r.tpot for r in reqs + reqs2),
               oracle=acceptance(full), oracle_before_eplb=before_eplb,
               oracle_with_rejections=rejected,
               tpot_ms_mean_oracle=1e3 * statistics.mean(
                   r.tpot for r in oracle),
               serve_s=[wall, wall2, wall3, wall4, wall5, wall6],
               logits_calls=calls["all"],
               rollback=rollback, device_split=split,
               decode_profile=profile)
    g = res["greedy"]
    log(f"MTP k={k}: {len(reqs + reqs2)} greedy requests equal the "
        f"plain engine's tokens, {len(everyone)} more unrecorded; "
        f"acceptance {g['acceptance']:.4f}, "
        f"{g['tokens_per_iteration']:.4f} tokens per iteration over "
        f"{g['iterations']} DP-group iterations, TPOT per emitted token "
        f"{res['tpot_ms_mean']:.2f} ms (host clock, unrecorded waves; "
        f"{res['tpot_ms_mean_recorded']:.2f} ms recorded); at "
        f"temperature 0.7: "
        f"acceptance {res['temperature_0_7']['acceptance']:.4f}, "
        f"{res['temperature_0_7']['full_blocks']} full blocks (bonus "
        f"token) and {res['temperature_0_7']['rejected_blocks']} with a "
        f"rejection (residual resample); oracle head: "
        f"{res['oracle']['tokens_per_iteration']:.4f} tokens per "
        f"iteration, TPOT per emitted token {res['tpot_ms_mean_oracle']:.2f}"
        f" ms, lossless with a wrong draft per request too, before EPLB "
        f"({res['oracle_before_eplb']['full_blocks']} full blocks, "
        f"{res['oracle_before_eplb']['rejected_blocks']} with a rejection)"
        f" and after it")
    log(f"MTP k={k} device ms per DP-group iteration (B 4): draft "
        f"{split['draft_ms']:.3f}, verify {split['verify_ms']:.3f}, fill "
        f"{split['fill_ms']:.3f}, whole iteration "
        f"{split['iteration_ms']:.3f}; plain decode_sample "
        f"{split['plain_decode_sample_ms']:.3f}; engine step device busy "
        f"{profile['device_busy_ms']:.3f} ms")
    return res


def mtp_stage(cfg, params, path: dict) -> dict:
    """MTP at k = 1 and 2 on the served DeepSeek-V3's weights, held to
    the plain path's tokens."""
    res = {}
    for k in (1, 2):
        res[f"{DEEPSEEK}/mtp-k{k}"] = ({}, mtp_path(
            cfg, params, k, path["tokens"], path["placement"]))
        free(f"MTP k={k}")
    p = path["decode_profile"]["device_busy_ms"]
    log(f"MTP against the plain path: engine-step device busy "
        f"{p:.3f} ms plain, " + ", ".join(
            f"{r['decode_profile']['device_busy_ms']:.3f} ms at k="
            f"{r['k']}" for _, r in res.values())
        + f"; TPOT {path['tpot_ms_mean']:.2f} ms plain, " + ", ".join(
            f"{r['tpot_ms_mean']:.2f} ms at k={r['k']} (oracle head "
            f"{r['tpot_ms_mean_oracle']:.2f})" for _, r in res.values()))
    return res


# ---------------------------------------------------------------------------
# stages 7 and 12: the card against the CPU on a small input
# ---------------------------------------------------------------------------
def check_small_reference(arch: str, **overrides):
    """The smoke variant of ``arch`` in float32: greedy tokens of the
    engine on the card equal the CPU plain versions', before and after
    EPLB; where it has an MTP head, also with ``mtp_k=2`` (and an oracle
    head before EPLB and after it), whose tokens equal the plain
    engine's and whose every iteration's block and accepted counts are
    the CPU's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.serving.flowserve import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch + "-smoke"), dtype="float32",
                              **overrides)
    outs, blocks = {}, {}
    cpu_params = Model(cfg).init(0, device="cpu")
    for dev in ("cpu", "cuda"):
        params = tree_map(lambda t: t.to(dev), cpu_params)
        for k in (0, 2) if cfg.mtp_num_layers else (0,):
            eng = FlowServeEngine(cfg, params, device=dev, n_dp_groups=2,
                                  max_batch=2, mtp_k=k)
            seen = []
            for d in eng.dps if k else ():
                real = d.backend.decode_sample_mtp

                def spy(*a, _real=real, _dp=d, **kw):
                    out = _real(*a, **kw)
                    busy = [i for i, s in enumerate(_dp.slots) if not s.free]
                    seen.append((_dp.dp_id, out[0][busy].tolist(),
                                 out[1][busy].tolist()))
                    return out
                d.backend.decode_sample_mtp = spy
            first = [r.output_tokens for r in serve_any(eng, PROMPTS[:3])]
            if k:   # drafts accepted, and one rejected, on gmm
                oracle_wave(eng, dict(zip(PROMPTS, outs[dev, 0][0])),
                            PROMPTS[:3], 8, wrong={3})
            eng.record_expert_counts(skewed_counts(cfg))
            eng.run_eplb()
            second = [r.output_tokens for r in serve_any(eng, PROMPTS[:3])]
            if k:   # and on placement_gmm
                oracle_wave(eng, dict(zip(PROMPTS, outs[dev, 0][1])),
                            PROMPTS[:3], 8, wrong={3})
            eng.close()
            outs[dev, k], blocks[dev, k] = (first, second), seen
    check(outs["cpu", 0] == outs["cuda", 0],
          "smoke engine: card tokens equal CPU tokens before and after EPLB")
    if cfg.mtp_num_layers:
        check(outs["cpu", 2] == outs["cpu", 0] == outs["cuda", 2],
              "smoke engine, mtp_k=2: tokens equal the plain engine's")
        check(blocks["cpu", 2] == blocks["cuda", 2] and blocks["cpu", 2],
              f"smoke engine, mtp_k=2: every iteration's greedy block and "
              f"accepted counts on the card equal the CPU's "
              f"({len(blocks['cpu', 2])} iterations)")
        n_acc = np.array([n for _, _, ns in blocks["cuda", 2] for n in ns])
        check(n_acc.max() == 2 and n_acc.min() < 2,
              "smoke engine, mtp_k=2: full and partial blocks accepted")
        log(f"small reference: mtp_k=2 blocks and accepted counts equal "
            f"on the card and the CPU over {len(blocks['cpu', 2])} "
            f"iterations, the oracle head's among them (accepted drafts "
            f"{int(n_acc.sum())})")
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
# stages 5 and 11: the INT8 path of §4.7 on the served engines
# ---------------------------------------------------------------------------
def int8_token_rows(engine, reqs) -> dict:
    """M → token ids of the INT8 stage: the last token of four served
    requests (a DP group's decode batch), the first prompt unpadded and
    padded to its prefill bucket as the backend pads it, and every prompt
    and output token of the path, cycled to 512 (the calibration set)."""
    from repro_torch.serving.backend import _bucket_len
    from repro_torch.serving.tokenizer import PAD

    enc = engine.tokenizer.encode
    first = enc(PROMPTS[0])
    every = [t for r in reqs for t in enc(r.prompt) + list(r.output_tokens)]
    rows = {4: [r.output_tokens[-1] for r in reqs[:4]],
            len(first): first,
            _bucket_len(len(first)): first + [PAD] * (
                _bucket_len(len(first)) - len(first)),
            512: (every * (512 // len(every) + 1))[:512]}
    check(tuple(sorted(rows)) == INT8_M, f"INT8 token counts {sorted(rows)}")
    return rows


def hold_quant_dispatch(x, what: str) -> float:
    """quant-dispatch on ``x`` [T, d] against its plain version: the
    int8 values and the scales bit-identical."""
    from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    (q, sc), (rq, rsc) = quant_dispatch_cuda(x), quant_dispatch_ref(x)
    return max(exact(q, rq, f"quant_dispatch {what} values"),
               exact(sc, rsc, f"quant_dispatch {what} scales"))


def time_quant_dispatch(x, n_sms: int, rivals: bool = False) -> dict:
    """quant-dispatch on ``x`` [T, d] at one path shape: bit-identical to
    the plain version, its plan, one device kernel per call, device time
    and events, the plain version's events and the bound. With
    ``rivals``, also two other launches of the same function on the same
    input, each bit-identical to it and called in turn with it (events
    and device time): the two-pass launch — the plan's scalar path, what
    it gives an unaligned input: a warp or a block per row, the row read
    twice with scalar loads — and the launch the plan did not pick
    between one block a row and a cluster of blocks (``one_block`` where
    the plan splits the row, ``cluster_2`` where it does not)."""
    from repro_torch.kernels.quant_dispatch import kernel as qk
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    T, d = x.shape
    shape = f"[{T}, {d}] {str(x.dtype)[6:]}"
    what = f"quant_dispatch {shape}"
    aligned = x.data_ptr() % 16 == 0
    p = qk.plan(T, d, n_sms, aligned=aligned)
    err = hold_quant_dispatch(x, shape)
    q, sc = qk.quant_dispatch_cuda(x)
    bnd, by = bound_ms(nbytes(x, q, sc), 0)

    def kernel():
        return qk.quant_dispatch_cuda(x)
    r = dict(shape=[T, d], dtype=str(x.dtype), plan=list(p),
             max_abs_err=err,
             plain_ms=time_ms(lambda: quant_dispatch_ref(x)),
             library_ms=None, bound_ms=bnd, bound_by=by)
    prof = profile_calls(kernel)
    one_launch(prof, "quant_dispatch", what)
    dev, ms = prof["device_ms"], time_ms(kernel)
    line = ""
    if rivals:
        others = {"two_pass": qk.plan(T, d, n_sms, aligned=False)}
        if p.path in ("block", "cluster"):
            others["one_block" if p.cluster > 1 else "cluster_2"] = \
                qk.plan(T, d, n_sms, aligned=aligned,
                        cluster=1 if p.cluster > 1 else 2)
        q2, s2 = torch.empty_like(q), torch.empty_like(sc)
        for name, other in others.items():
            def rival(other=other):
                qk.launch(x, other, q2, s2)
            rival()
            exact(q2, q, f"{what}: the {name} launch, values")
            exact(s2, sc, f"{what}: the {name} launch, scales")
            p_dev, o_dev, _, _ = profile_turns(kernel, rival)
            p_ms, o_ms = time_pair(kernel, rival)
            r[name] = dict(plan=list(other), ms=o_ms, device_ms=o_dev,
                           plan_ms=p_ms, plan_device_ms=p_dev)
            line += (f"; {name} {other.path} x{other.cluster} in turn "
                     f"{o_ms:.4f} ms, device {o_dev:.4f} ms (the plan's "
                     f"{p_ms:.4f}, device {p_dev:.4f})")
    r.update(ms=ms, device_ms=dev, kernels_per_call=prof["per_call"],
             bound_share=bnd / dev)
    log(f"  {what} {p.path} (group {p.group}, vec {p.vec}, cluster "
        f"{p.cluster}, {p.blocks} blocks): {ms:.4f} ms, device {dev:.4f} ms "
        f"({bnd / dev:.0%} of the bound {bnd:.4f} ms by {by}), plain "
        f"{r['plain_ms']:.4f} ms" + line)
    return r


def rel_err(y, ref) -> float:
    return float(torch.linalg.norm(y.float() - ref.float())
                 / torch.linalg.norm(ref.float()))


def int8_stage(engine, reqs) -> dict:
    """The §4.7 pipeline on the served DeepSeek-V3 engine's layer-0
    weights and its cache. Launch counts are set to 0 just before the
    pipeline and read just after; the comparisons with the plain
    versions that need a kernel launch come after that."""
    from repro_torch import quant as Q
    from repro_torch.kernels import runtime
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
    from repro_torch.kernels.int8_matmul.kernel import plan as int8_plan
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref
    from repro_torch.models.common import rms_norm

    t_stage = time.monotonic()
    cfg, p = engine.cfg, engine.params
    eps, m = cfg.norm_eps, cfg.mla
    l0 = p["prefix"][0]
    mla, mlp = l0["mixer"], l0["ffn"]
    silu = torch.nn.functional.silu
    ids = {M: torch.tensor(t, device="cuda")
           for M, t in int8_token_rows(engine, reqs).items()}
    with torch.no_grad():
        # the weights' inputs, computed with the port's functions: the
        # rms-normed embeddings (wq_a, wkv_a, wi_gate, the expert), their
        # q latent (wq_b) and their SwiGLU through the dense MLP (wo)
        x = {M: rms_norm(p["embed"][t], l0["mixer_norm"], eps)
             for M, t in ids.items()}
        acts = {"x": x,
                "cq": {M: rms_norm(v @ mla["wq_a"], mla["q_norm"], eps)
                       for M, v in x.items()},
                "h": {M: silu(v @ mlp["wi_gate"]) * (v @ mlp["wi_up"])
                      for M, v in x.items()}}
    weights = [("wq_a", mla["wq_a"], "x"), ("wkv_a", mla["wkv_a"], "x"),
               ("wq_b", mla["wq_b"].reshape(m.q_lora_rank, -1), "cq"),
               ("wi_gate", mlp["wi_gate"], "x"), ("wo", mlp["wo"], "h"),
               ("we_gate[3]", p["blocks"]["pos0"]["ffn"]["we_gate"][0][3],
                "x")]

    def plain_linear(x, qw):
        xq, xs = quant_dispatch_ref(x.reshape(-1, x.shape[-1]))
        return int8_matmul_ref(xq, xs, qw.values, qw.scale)

    # -- the pipeline, counted ------------------------------------------
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    t0 = time.monotonic()
    errs, lin_err, held, qws = {}, 0.0, [], {}
    for name, w, kind in weights:
        ws, s = Q.smooth_quant_pair(acts[kind][512], w)
        qn, qs = Q.quantize_weight_channelwise(w), \
            Q.quantize_weight_channelwise(ws)
        qws[name] = qn
        for M in INT8_M:
            xm = acts[kind][M]
            y16 = xm @ w                                # the bf16 product
            xs_ = xm / s[None]                          # f32 after smoothing
            yn, ys = Q.quantized_linear(xm, qn), Q.quantized_linear(xs_, qs)
            lin_err = max(lin_err,
                          exact(yn, plain_linear(xm, qn),
                                f"quantized_linear {name} M={M}"),
                          exact(ys, plain_linear(xs_, qs),
                                f"smoothed quantized_linear {name} M={M}"))
            held += [(f"{name} M={M} bf16", xm), (f"{name} M={M} smoothed",
                                                  xs_)]
            errs[f"{name} M={M}"] = dict(naive=rel_err(yn, y16),
                                         smoothed=rel_err(ys, y16))
        del ws, s, qs
    x512 = acts["x"][512]
    h = Q.hessian_from_calibration(x512)
    torch.cuda.synchronize()
    tg = time.monotonic()
    qg, gptq_w_rel = Q.gptq_quantize(mla["wkv_a"], h)
    torch.cuda.synchronize()
    gptq_s = time.monotonic() - tg
    del h
    y16 = x512 @ mla["wkv_a"]
    yg = Q.quantized_linear(x512, qg)
    lin_err = max(lin_err, exact(yg, plain_linear(x512, qg),
                                 "quantized_linear wkv_a GPTQ"))
    gptq = dict(seconds=gptq_s, weight_rel_err=gptq_w_rel,
                out_rel_err=rel_err(yg, y16),
                naive_out_rel_err=errs["wkv_a M=512"]["naive"])
    caches = []
    for g, dp in enumerate(engine.dps):
        c = dp.cache
        layers = [(f"prefix{i}", lc) for i, lc in enumerate(c["prefix"])]
        layers.append(("blocks.pos0", c["blocks"]["pos0"]))
        caches += [(f"dp{g} {n}", lc, Q.quantize_mla_cache(lc))
                   for n, lc in layers]
    torch.cuda.synchronize()
    pipeline_s = time.monotonic() - t0
    launches = dict(runtime.LAUNCHES)
    check(all(launches.get(n, 0) > 0 for n in ("quant_dispatch",
                                                 "int8_matmul")),
          f"the INT8 path launched both kernels: {launches}")
    log(f"int8: pipeline over {len(weights)} weights x M {INT8_M} (naive "
        f"and smoothed), GPTQ of wkv_a ({gptq_s:.2f} s in float64 on the "
        f"card) and {len(caches)} MLA caches in {pipeline_s:.2f} s; "
        f"launches {launches}; quantized_linear bit-identical to the plain "
        f"path everywhere")
    for k, e in errs.items():
        log(f"  {k}: rel err vs bf16 naive {e['naive']:.4g}, smoothed "
            f"{e['smoothed']:.4g}")
    log(f"  GPTQ wkv_a M=512: rel err {gptq['out_rel_err']:.4g} (naive "
        f"{gptq['naive_out_rel_err']:.4g}), weight rel err "
        f"{gptq_w_rel:.4g}")

    # -- quant-dispatch and INT8 matmul against their plain versions -----
    qd_err = 0.0
    for what, xh in held:
        qd_err = max(qd_err, hold_quant_dispatch(xh.reshape(-1, xh.shape[-1]),
                                                 what))
    kv_err, kv_rt = 0.0, 0.0
    for what, lc, qc in caches:
        rows = lc["ckv"].reshape(-1, lc["ckv"].shape[-1])
        rq, rsc = quant_dispatch_ref(rows)
        kv_err = max(kv_err,
                     exact(qc["ckv_q"].reshape(rows.shape), rq,
                           f"MLA cache {what} values"),
                     exact(qc["ckv_scale"].reshape(-1), rsc,
                           f"MLA cache {what} scales"))
        check(qc["krope"] is lc["krope"], "the RoPE part stays as it is")
        back = Q.dequantize_mla_cache(qc)["ckv"]
        kv_rt = max(kv_rt, (back.float() - lc["ckv"].float()).abs().max()
                    .item())
    log(f"int8: MLA caches {tuple(caches[0][1]['ckv'].shape)} per layer "
        f"quantized bit-identically to the plain version; round-trip max "
        f"abs err {kv_rt:.4g}")
    gen = torch.Generator(device="cuda").manual_seed(99)
    edge = torch.zeros((3, 300), device="cuda")
    edge[1, :8] = torch.tensor([127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                                -126.5])
    edge[2] = torch.randn(300, generator=gen, device="cuda")
    qd_err = max(qd_err, hold_quant_dispatch(edge, "zero row, .5 quotients"))
    check(quant_dispatch_cuda(edge)[0][1, :8].tolist()
          == [127, 2, -4, 0, 0, 2, 126, -126], "half to even")
    for dt in (torch.float32, torch.bfloat16):
        qd_err = max(qd_err, hold_quant_dispatch(
            torch.randn((7, 32), generator=gen, device="cuda").to(dt),
            f"(7, 32) {dt}"))
        # a row that ends mid-group (warp path), ragged d (scalar), an
        # input 2 or 4 bytes off a 16-byte boundary (scalar)
        for T, d in ((5, 1000), (4, 7170)):
            qd_err = max(qd_err, hold_quant_dispatch(
                torch.randn((T, d), generator=gen, device="cuda").to(dt),
                f"({T}, {d}) {dt}"))
        off = torch.randn((4 * 7168 + 1,), generator=gen,
                          device="cuda").to(dt)[1:].view(4, 7168)
        qd_err = max(qd_err, hold_quant_dispatch(off, f"unaligned (4, 7168) "
                                                      f"{dt}"))
        # all-zero rows (+0 and -0) on the cluster and block paths, which
        # store them without the divide
        for T in (6, 300):
            z = torch.randn((T, 7168), generator=gen, device="cuda")
            z[1], z[T - 1] = 0.0, -0.0
            z[2, ::3] = -0.0
            z[2, 1::3] = 0.0
            z[2, 2::3] = 0.0
            qd_err = max(qd_err, hold_quant_dispatch(z.to(dt), f"zero rows "
                                                               f"({T}, 7168) "
                                                               f"{dt}"))
    mm_err, n_sms = lin_err, torch.cuda.get_device_properties(0) \
        .multi_processor_count
    # K-major weights ([N, K] row-major, viewed [K, N]); K not a multiple
    # of 16 at M 100, 37 and 130, and the last one's weight 1 byte off a
    # 16-byte boundary at a shape TMA would take: the ragged variant
    for M, K, N, skew in ((100, 300, 50, 0), (1, 64, 17, 0),
                          (37, 1000, 300, 0), (130, 136, 257, 0),
                          (4, 7168, 300, 1)):
        xq = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (N * K + skew,), generator=gen,
                           device="cuda", dtype=torch.int8)[skew:] \
            .view(N, K).t()
        xs_, ws_ = (torch.rand(n, generator=gen, device="cuda") + 0.1
                    for n in (M, N))
        p = int8_plan(M, K, N, n_sms, aligned=wq.data_ptr() % 16 == 0)
        mm_err = max(mm_err, exact(int8_matmul_cuda(xq, xs_, wq, ws_),
                                   int8_matmul_ref(xq, xs_, wq, ws_),
                                   f"int8_matmul ragged ({M},{K},{N}) "
                                   f"{p.path}"))
        log(f"int8: int8_matmul ({M},{K},{N}), weight base +{skew}: "
            f"bit-identical ({p.path} variant)")
    log("int8: quant_dispatch bit-identical at every input of the pipeline, "
        "a zero row, .5 quotients, (7, 32), (5, 1000), (4, 7170), an "
        "unaligned (4, 7168) and zero rows of +0 and -0 at (6, 7168) and "
        "(300, 7168)")

    # -- times at the path's shapes ----------------------------------------
    # quant-dispatch at every activation width (q latent 1536, d_model
    # 7168, d_ff 18432) and M, bf16 (as served) and f32 (after
    # SmoothQuant), other launches of it in turn at M 4, and the MLA
    # cache rows
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_shape = {}
    for kind in ("cq", "x", "h"):
        for M in INT8_M:
            for dt in (torch.bfloat16, torch.float32):
                xt = acts[kind][M].to(dt).contiguous()
                r = time_quant_dispatch(xt, n_sms, rivals=M == 4)
                by_shape[f"[{M}, {xt.shape[1]}] {str(dt)[6:]}"] = r
                if M == 4:
                    t = r["two_pass"]
                    check(t["plan_device_ms"] < t["device_ms"],
                          f"quant_dispatch [4, {xt.shape[1]}] {dt}: device "
                          f"{t['plan_device_ms']} ms below the two-pass "
                          f"launch's {t['device_ms']} ms, in turn")
    rows = caches[0][1]["ckv"].reshape(-1, caches[0][1]["ckv"].shape[-1])
    by_shape[f"MLA cache rows {list(rows.shape)} bfloat16"] = \
        time_quant_dispatch(rows, n_sms)
    big = by_shape[f"[512, {cfg.d_model}] bfloat16"]
    qd = dict(big, max_abs_err=max([qd_err] + [r["max_abs_err"] for r in
                                               by_shape.values()]),
              kv_max_abs_err=kv_err,
              kv_round_trip_max_abs_err=kv_rt, library="none",
              target_device_ms=0.0066,
              target_met=big["device_ms"] <= 0.0066, by_shape=by_shape)
    qw = qws["wi_gate"]
    K, N = qw.values.shape
    check(qw.values.t().is_contiguous(), "QTensor keeps wi_gate K-major")
    mm = {}
    for M in INT8_M:
        xq, xs_ = quant_dispatch_cuda(acts["x"][M])

        def kernel():
            return int8_matmul_cuda(xq, xs_, qw.values, qw.scale)
        out = kernel()
        ops = 2 * M * K * N
        bnd, by = bound_ms(nbytes(xq, xs_, qw.values, qw.scale, out), ops,
                           INT8_OP_PER_S)
        prof = profile_calls(kernel)
        one_launch(prof, "int8_matmul", f"int8_matmul M={M}")
        r = dict(shape=[M, K, N], plan=list(int8_plan(M, K, N, n_sms)),
                 device_ms=prof["device_ms"],
                 kernels_per_call=prof["per_call"],
                 int8_peak_share=ops / INT8_OP_PER_S * 1e3
                 / prof["device_ms"],
                 plain_ms=time_ms(lambda: int8_matmul_ref(
                     xq, xs_, qw.values, qw.scale)),
                 bound_ms=bnd, bound_by=by)
        if M > 16:                # torch._int_mm takes M > 16
            def lib():
                return (torch._int_mm(xq, qw.values).float() * xs_[:, None]
                        * qw.scale[None, :])
            ms, lib_ms = time_pair(kernel, lib)
            r.update(ms=ms, library_ms=lib_ms, library_ratio=ms / lib_ms,
                     library="torch._int_mm + the same epilogue, on the "
                             "same K-major weight",
                     library_device_ms=device_ms(lib),
                     library_max_abs_err=(lib() - out).abs().max().item())
        else:
            r.update(ms=time_ms(kernel), library_ms=None,
                     library="none at this shape (torch._int_mm takes "
                             "M > 16)")
        mm[M] = r
        log(f"  int8_matmul M={M} {r['plan']}: {r['ms']:.4f} ms, device "
            f"{r['device_ms']:.4f} ms ({r['int8_peak_share']:.1%} of the "
            f"int8 peak; bound {bnd:.4f} ms by {by}), library "
            f"{r['library_ms']} (kernel/library "
            f"{r.get('library_ratio')})")
    check(mm[512]["ms"] < mm[512]["library_ms"],
          f"int8_matmul M=512: {mm[512]['ms']} ms faster than torch._int_mm "
          f"+ the epilogue's {mm[512]['library_ms']} ms, called in turn")
    mm4 = dict(mm[4], max_abs_err=mm_err, by_m=mm)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  quant_dispatch [512, 7168] bf16: device {qd['device_ms']:.4f} "
        f"ms against the target 0.0066 ms: "
        f"{'met' if qd['target_met'] else 'missed'}")
    return dict(kernels={"quant_dispatch": qd, "int8_matmul": mm4},
                launches=launches, output_rel_err=errs, gptq=gptq,
                pipeline_s=pipeline_s, peak_mem_gib=peak,
                stage_s=time.monotonic() - t_stage)


def int8_kv_stage(engine, reqs) -> dict:
    """The INT8 GQA cache on the served Llama-4 engine: each layer's k/v
    of each DP group quantized per (position, head) with launch counts
    set to 0 just before and read just after, bit-identical to the plain
    version; then INT8 attention scores at the path's shape, one query
    row per KV head, against the CPU."""
    from repro_torch import quant as Q
    from repro_torch.kernels import runtime
    from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref

    layers = [(f"dp{g} {pos}", lc) for g, dp in enumerate(engine.dps)
              for pos, lc in dp.cache["blocks"].items()]
    torch.cuda.synchronize()
    runtime.reset_launch_counts()
    quantized = [(w, lc, Q.quantize_gqa_cache(lc)) for w, lc in layers]
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    check(launches.get("quant_dispatch", 0) > 0,
          f"the INT8 KV path launched quant_dispatch: {launches}")
    err, rt = 0.0, 0.0
    for what, lc, qc in quantized:
        back = Q.dequantize_gqa_cache(qc, lc["k"].dtype)
        for n in ("k", "v"):
            rows = lc[n].reshape(-1, lc[n].shape[-1])
            rq, rsc = quant_dispatch_ref(rows)
            err = max(err, exact(qc[n + "_q"].reshape(rows.shape), rq,
                                 f"GQA cache {what} {n} values"),
                      exact(qc[n + "_scale"].reshape(-1), rsc,
                            f"GQA cache {what} {n} scales"))
            rt = max(rt, (back[n].float() - lc[n].float()).abs().max()
                     .item())
    # scores: q [B, KV, hd] per row, k [B, L, KV, hd] per (row, head) over
    # all positions, the scale shapes the reference's broadcast takes
    k = layers[0][1]["k"][0]
    B, L, KV, hd = k.shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q = torch.randn((B, KV, hd), generator=gen, device="cuda").to(k.dtype)
    qq, qs = Q.quantize_act_tokenwise(q)
    kh, ks = Q.quantize_act_tokenwise(
        k.permute(0, 2, 1, 3).reshape(B, KV, L * hd))
    per_head = k.permute(0, 2, 1, 3).reshape(B * KV, L * hd)
    err = max(err, hold_quant_dispatch(per_head, "k per head"))
    kq = kh.reshape(B, KV, L, hd).permute(0, 2, 1, 3)
    got = Q.int8_attention_scores(qq, qs, kq, ks)
    want = Q.int8_attention_scores(qq.cpu(), qs.cpu(), kq.cpu(), ks.cpu())
    sc_err = exact(got.cpu(), want, "int8_attention_scores card vs CPU")
    log(f"int8-kv: {len(layers)} GQA caches {tuple(k.shape)} quantized "
        f"bit-identically to the plain version (round-trip max abs err "
        f"{rt:.4g}); launches {launches}; int8_attention_scores "
        f"[{B},{KV},{hd}] x [{B},{L},{KV},{hd}] on the card equal the CPU's")
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = layers[0][1]["k"].reshape(-1, hd)
    by_shape = {
        f"GQA cache rows {list(rows.shape)} bfloat16":
            time_quant_dispatch(rows, n_sms),
        f"k per head {list(per_head.shape)} bfloat16":
            time_quant_dispatch(per_head.contiguous(), n_sms)}
    return dict(kernels={"quant_dispatch": dict(max_abs_err=err,
                                                by_shape=by_shape)},
                launches=launches, round_trip_max_abs_err=rt,
                scores_max_abs_err=sc_err)


# ---------------------------------------------------------------------------
def free(what: str) -> None:
    """Drop what the last stage left on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{what}: {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB still "
        f"allocated")


def deepseek_stages(get_config) -> dict:
    """Stages 3-7 on DeepSeek-V3 cut to 4 layers, with its MTP head."""
    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=4)
    check(cfg.mtp_num_layers == 1, "DeepSeek-V3 has its MTP head")
    max_batch = 4
    t0 = time.monotonic()
    kern = check_moe_kernels(
        cfg, path_token_counts(PROMPTS + PROMPTS_EPLB, max_batch), max_batch)
    free(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    engine = make_engine(cfg, max_batch=max_batch)
    path = run_path(engine, PROMPTS, PROMPTS_EPLB,
                    ("route_pack", "gmm", "placement_gmm"),
                    before_close=int8_stage)
    fold_replays(kern, path)
    int8 = path.pop("stage")
    free(f"path: {time.monotonic() - t0:.1f} s (the INT8 stage "
         f"{int8['stage_s']:.1f} s of it); sample output {path['text']!r}")

    t0 = time.monotonic()
    mtp = mtp_stage(cfg, engine.params, dict(
        path, placement=engine.dps[0].backend._placement))
    path.pop("tokens")
    del engine
    free(f"MTP: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    check_small_reference(DEEPSEEK)
    log(f"small reference: {time.monotonic() - t0:.1f} s")
    return {DEEPSEEK: (kern, path), **mtp,
            DEEPSEEK_INT8: (int8.pop("kernels"), int8)}


def fold_replays(kern: dict, path: dict) -> None:
    """The path's replayed route-packs and their counts count in the
    kernels' errors."""
    for n in ("route_pack", "collect"):
        kern[n]["max_abs_err"] = max(kern[n]["max_abs_err"],
                                     path[f"{n}_replay_err"])


def llama_stages(get_config) -> dict:
    """Stages 8-12 on Llama-4 Maverick cut to 2 layers."""
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
    path = run_path(engine, LLAMA_PROMPTS, LLAMA_PROMPTS_EPLB,
                    ("route_pack", "gmm", "placement_gmm",
                     "decode_attention"),
                    before_close=int8_kv_stage)
    del engine
    fold_replays(kern, path)
    kv = path.pop("stage")
    path.pop("tokens")
    free(f"path: {time.monotonic() - t0:.1f} s; sample output "
         f"{path['text']!r}")

    t0 = time.monotonic()
    check_small_reference(LLAMA, num_heads=10, num_kv_heads=2, head_dim=32)
    log(f"small reference: {time.monotonic() - t0:.1f} s")
    return {LLAMA: (kern, path), LLAMA_INT8_KV: (kv.pop("kernels"), kv)}


def kernel_line(results: dict) -> dict:
    """One entry per kernel: launches per path (and their sum), the
    largest error of any path, and the times and bound of the path named
    in ``TIMED_ON`` (Llama-4 by default; each path's own measurements in
    full under ``by_path``). Collect runs on the paths inside route-pack's
    launches: its launches are those (``runtime.FUSED``), its own
    standalone launches on the paths (none) are listed beside them, and
    its times are the standalone kernel's (``check_collect``), with the
    fused launch's under ``in_route_pack``."""
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
    kernels = []
    for n in KERNELS:
        meas = {p: k[n] for p, (k, _) in results.items() if n in k}
        own = {p: r["launches"].get(n, 0) for p, (_, r) in results.items()}
        launches = own
        extra = {}
        if n == "collect":
            launches = {p: r.get("fused", {}).get(n, 0)
                        for p, (_, r) in results.items()}
            extra = dict(fused_into="route_pack",
                         standalone_source=f"src/repro_torch/kernels/csrc/"
                                           f"{n}.cu",
                         standalone_launches_by_path=own)
        check(sum(launches.values()) > 0, f"{n} launched on a path")
        top = meas[TIMED_ON.get(n, LLAMA)]
        kernels.append(dict(
            name=n, route="cuda", source=SOURCES[n], replaces=REPLACES[n],
            launches=sum(launches.values()), launches_by_path=launches,
            **{k: top[k] for k in keys},
            max_abs_err=max(m["max_abs_err"] for m in meas.values()),
            **extra, by_path=meas))
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

    results = {**deepseek_stages(get_config), **llama_stages(get_config)}
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
