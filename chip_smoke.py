#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` (``/usr/local/cuda``) and the
repository's ``src/``; without a card it exits non-zero at once.

Stages (any failure raises and exits non-zero):

1. print the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels`` (one ``nvcc`` per source, all in parallel);
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (DeepSeek-V3 width, top-8 of 256 experts, capacity
   4; the token counts T the path packs: decode T=4, the prompts' padded
   prefill buckets 32 and 64, and the unpadded 37-token prompt):
   route-pack exactly (bf16, spread and hot routing, with and without
   INT8 quantize and expert ids, and with masked rows, and at the EPLB
   table's 258 slots), the grouped expert FFN within 3e-2 (bf16, and at
   C=6 for a second row tile), and the owner-indexed FFN bit-identical
   to the plain kernel on owner-gathered weights over the 258 slots;
   time kernel, plain version and one PyTorch library call with CUDA
   events (median of 20 after warm-up);
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
6. print one JSON line with every kernel's launches, error, times and
   bound, then the final ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import dataclasses
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


def path_token_counts(max_batch: int) -> list:
    """Token counts T of the route-packs the main path makes: a decode
    step's batch, each prompt's padded prefill bucket, and the unpadded
    prompt of the finite-logits check."""
    from repro_torch.serving.backend import _bucket_len
    from repro_torch.serving.tokenizer import ByteTokenizer

    enc = ByteTokenizer().encode
    counts = {max_batch, len(enc(PROMPTS[0]))}
    counts |= {_bucket_len(len(enc(p))) for p in PROMPTS + PROMPTS_EPLB}
    return sorted(counts)


# ---------------------------------------------------------------------------
# stage 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(cfg, max_batch: int) -> dict:
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
    out = {}

    # -- route-pack: exact, at the path's token counts, all variants -----
    rp_err = 0.0
    for T in path_token_counts(max_batch):
        N = T * k
        cap = max(int(N / E * e.capacity_factor), 4)
        x = torch.randn((T, d), generator=gen, device="cuda").to(bf16)
        eid = torch.randint(0, E, (N,), generator=gen, device="cuda",
                            dtype=torch.int32)
        mask = torch.rand((N,), generator=gen, device="cuda") > 0.2
        variants = [(q, ei, None) for q in (False, True)
                    for ei in (None, eid)] + [(True, eid, mask)]
        for hot in (0, 12):
            dest = routed_dest(T, k, E, gen, hot)
            for quant, ei, valid in variants:
                a = route_pack_cuda(x, dest, valid, ei, k=k, n_dest=E,
                                    capacity=cap, quantize=quant)
                b = route_pack_ref(x, dest, valid, ei, k=k, n_dest=E,
                                   capacity=cap, quantize=quant)
                rp_err = max(rp_err, pack_err(
                    a, b, f"route_pack T={T} hot={hot} quantize={quant} "
                    f"eid={ei is not None} masked={valid is not None}"))
            if T == max_batch and not hot:
                decode_in = x, dest, cap
        log(f"route_pack T={T} N={N} C={cap}: exact in {2 * len(variants)} "
            f"variants (spread and hot routing x quantize x eid, and masked)")
    x, dest, cap = decode_in            # the decode configuration
    args = (x, dest, None, None)
    kw = dict(k=k, n_dest=E, capacity=cap, quantize=False)
    res = route_pack_cuda(*args, **kw)
    rp_err = max(rp_err, pack_err(res, route_pack_ref(*args, **kw),
                                  "route_pack decode"))
    bnd, by = bound_ms(nbytes(x, dest, res.buckets, res.rank, res.keep), 0)
    out["route_pack"] = dict(
        max_abs_err=rp_err, ms=time_ms(lambda: route_pack_cuda(*args, **kw)),
        plain_ms=time_ms(lambda: route_pack_ref(*args, **kw)),
        library_ms=None, bound_ms=bnd, bound_by=by)
    decode_pack = res, x, dest, cap

    # -- grouped expert FFN at decode shapes -----------------------------
    def w(shape, fan):
        return (torch.randn(shape, generator=gen, device="cuda")
                / fan ** 0.5).to(bf16)
    wg, wu, wd = w((E, d, f), d), w((E, d, f), d), w((E, f, d), f)
    pack, x, dest, cap = decode_pack
    buckets = pack.buckets
    got = gmm_cuda(buckets, wg, wu, wd)
    ref = gmm_ref(buckets, wg, wu, wd)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    check(err <= 3e-2, f"gmm max abs err {err} <= 3e-2")
    ident = torch.arange(E, device="cuda", dtype=torch.int32)
    check(torch.equal(gmm_cuda(buckets, wg, wu, wd, ident), got),
          "placement_gmm with identity owners bit-identical to gmm")
    # the path's capacity is 4, one row tile; C=6 takes a second, partial
    # tile, which guards the tiling for longer prompts
    x6 = torch.randn((8, 6, d), generator=gen, device="cuda").to(bf16)
    w8 = (wg[:8], wu[:8], wd[:8])
    err6 = (gmm_cuda(x6, *w8) - gmm_ref(x6, *w8)).abs().max().item()
    check(err6 <= 3e-2, f"gmm at C=6 max abs err {err6} <= 3e-2")
    del x6, w8

    def bmm_chain(xb, g, u, dn):
        h = torch.bmm(xb, g)
        return torch.bmm(torch.nn.functional.silu(h) * torch.bmm(xb, u),
                         dn).float()

    rows = int((buckets.abs().amax(dim=-1) > 0).sum())
    live = int((buckets.abs().amax(dim=(1, 2)) > 0).sum())
    io = nbytes(buckets) + got.numel() * 4
    bnd, by = bound_ms(live * 3 * d * f * 2 + io, 6 * rows * d * f)
    dense, _ = bound_ms(E * 3 * d * f * 2 + io, 6 * E * cap * d * f)
    out["gmm"] = dict(max_abs_err=err,
                      ms=time_ms(lambda: gmm_cuda(buckets, wg, wu, wd)),
                      plain_ms=time_ms(lambda: gmm_ref(buckets, wg, wu, wd)),
                      library_ms=time_ms(lambda: bmm_chain(buckets, wg, wu,
                                                           wd)),
                      bound_ms=bnd, bound_by=by, bound_dense_walk_ms=dense,
                      nonempty_slots=live, slots=E)
    log(f"gmm [{E},{cap},{d}]x{f}: max abs err {err:.3g}; "
        f"{live} of {E} buckets non-empty")

    # -- owner-indexed FFN over the EPLB table's physical slots ----------
    hot = torch.bincount(dest.long(), minlength=E).topk(2).indices.tolist()
    emap = ExpertMap(E, {h: [h, E + i] for i, h in enumerate(hot)})
    table = build_placement_table([emap], E, pad_physical=E + 2,
                                  pad_replicas=3)
    rs, nr, owner = (torch.as_tensor(a[0], dtype=torch.int32, device="cuda")
                     for a in (table.replica_slots, table.n_replicas,
                               table.phys_owner))
    S = owner.shape[0]
    tok_of = torch.arange(x.shape[0], device="cuda").repeat_interleave(k)
    pdest = placement_route(dest, tok_of, rs, nr)
    ppack = route_pack_cuda(x, pdest, None, None, k=k, n_dest=S,
                            capacity=cap, quantize=False)
    rp_err = max(rp_err, pack_err(
        ppack, route_pack_ref(x, pdest, None, None, k=k, n_dest=S,
                              capacity=cap, quantize=False),
        f"route_pack under placement, n_dest={S}"))
    out["route_pack"]["max_abs_err"] = rp_err
    pbuckets = ppack.buckets
    pgot = gmm_cuda(pbuckets, wg, wu, wd, owner)
    pref = placement_gmm_ref(pbuckets, wg, wu, wd, owner)
    o = owner.long()
    gathered = [t[o].contiguous() for t in (wg, wu, wd)]
    pgath = gmm_cuda(pbuckets, *gathered)
    torch.cuda.synchronize()
    check(torch.equal(pgot, pgath),
          "placement_gmm bit-identical to gmm on owner-gathered weights")
    del gathered, pgath
    perr = (pgot - pref).abs().max().item()
    check(perr <= 3e-2, f"placement_gmm max abs err {perr} <= 3e-2")
    prows = int((pbuckets.abs().amax(dim=-1) > 0).sum())
    plive = int((pbuckets.abs().amax(dim=(1, 2)) > 0).sum())
    pio = nbytes(pbuckets, owner) + pgot.numel() * 4
    bnd, by = bound_ms(plive * 3 * d * f * 2 + pio, 6 * prows * d * f)
    pdense, _ = bound_ms(S * 3 * d * f * 2 + pio, 6 * S * cap * d * f)
    out["placement_gmm"] = dict(
        max_abs_err=perr,
        ms=time_ms(lambda: gmm_cuda(pbuckets, wg, wu, wd, owner)),
        plain_ms=time_ms(lambda: placement_gmm_ref(pbuckets, wg, wu, wd,
                                                   owner)),
        library_ms=time_ms(lambda: bmm_chain(pbuckets, wg[o], wu[o],
                                             wd[o])),
        bound_ms=bnd, bound_by=by, bound_dense_walk_ms=pdense,
        nonempty_slots=plive, slots=S)
    log(f"placement_gmm [{S},{cap},{d}]x{f} (replicas of experts {hot}): "
        f"bit-identical to gathered; max abs err vs plain {perr:.3g}")
    for name, r in out.items():
        log(f"  {name}: {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']}, bound {r['bound_ms']:.4f} ms "
            f"by {r['bound_by']})")
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


def skewed_counts(cfg, gen_seed: int = 7):
    import numpy as np
    rng = np.random.default_rng(gen_seed)
    E = cfg.moe.num_experts
    counts = rng.integers(0, 4, size=(cfg.num_layers, E))
    counts[len(cfg.prefix_layers):, [3 % E, 77 % E]] += 400   # two hot experts
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


def run_path(cfg, max_batch: int) -> dict:
    from unittest import mock

    from repro_torch.kernels import runtime
    from repro_torch.models import ffn
    from repro_torch.models.weights import flatten
    from repro_torch.serving.flowserve import FlowServeEngine

    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = FlowServeEngine(cfg, device="cuda", n_dp_groups=2,
                             max_batch=max_batch, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flatten(engine.params).values())
    log(f"path: {cfg.name} depth {cfg.num_layers}, {n_params / 1e9:.2f} B "
        f"parameters made on the card in {time.monotonic() - t0:.1f} s")

    rec = PackRecorder(ffn.fused_route_pack)
    with mock.patch.object(ffn, "fused_route_pack", rec):
        runtime.reset_launch_counts()
        reqs, wall = serve(engine, PROMPTS, 16)
        before = dict(runtime.LAUNCHES)
        engine.record_expert_counts(skewed_counts(cfg))
        maps = engine.run_eplb()
        check(any(len(s) > 1 for m in maps.values()
                  for s in m.replicas.values()),
              "EPLB installed redundant replicas")
        reqs2, wall2 = serve(engine, PROMPTS_EPLB, 16)
        launches = dict(runtime.LAUNCHES)
        check(all(launches.get(n, 0) > 0
                  for n in ("route_pack", "gmm", "placement_gmm")),
              f"every kernel launched on the path: {launches}")
        check(launches["placement_gmm"] > before.get("placement_gmm", 0),
              "placement_gmm ran after EPLB")

        # the output is finite: logits of one prompt through the model
        tok = torch.tensor([engine.tokenizer.encode(PROMPTS[0])],
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
               serve_s=[wall, wall2],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               decode_profile=profile,
               text=engine.tokenizer.decode(reqs[0].output_tokens))
    engine.close()
    log(f"path: 8 requests x 16 tokens served in {wall:.2f} s + "
        f"{wall2:.2f} s; TTFT mean {res['ttft_ms_mean']:.1f} ms, TPOT mean "
        f"{res['tpot_ms_mean']:.2f} ms, peak memory "
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
def check_small_reference():
    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.transformer import Model
    from repro_torch.serving.flowserve import FlowServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 comparison
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_config("deepseek-v3-671b-smoke"),
                              dtype="float32", mtp_num_layers=0)
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
    log("small reference: smoke DeepSeek-V3 (f32) greedy tokens on the card "
        "equal the CPU plain versions', before and after EPLB")


def serve_any(engine, prompts):
    from repro_torch.serving.request import Request

    reqs = [Request(prompt=p, max_new_tokens=8, ignore_eos=True)
            for p in prompts]
    for r in reqs:
        engine.submit(r)
    engine.run_until_done()
    return reqs


# ---------------------------------------------------------------------------
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

    cfg = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=4,
                              mtp_num_layers=0)
    max_batch = 4
    t0 = time.monotonic()
    kern = check_kernels(cfg, max_batch)
    torch.cuda.empty_cache()
    log(f"kernel checks: {time.monotonic() - t0:.1f} s")

    t0 = time.monotonic()
    path = run_path(cfg, max_batch)
    kern["route_pack"]["max_abs_err"] = max(kern["route_pack"]["max_abs_err"],
                                            path["route_pack_replay_err"])
    torch.cuda.empty_cache()
    log(f"path: {time.monotonic() - t0:.1f} s; sample output "
        f"{path['text']!r}")
    log(json.dumps({"path": {k: v for k, v in path.items()
                             if k != "text"}}))

    t0 = time.monotonic()
    check_small_reference()
    log(f"small reference: {time.monotonic() - t0:.1f} s")

    sources = {"route_pack": "src/repro_torch/kernels/csrc/route_pack.cu",
               "gmm": "src/repro_torch/kernels/csrc/gmm.cu",
               "placement_gmm": "src/repro_torch/kernels/csrc/gmm.cu"}
    replaces = {"route_pack": "src/repro/kernels/route_pack/kernel.py:105",
                "gmm": "src/repro/kernels/gmm/kernel.py:56",
                "placement_gmm": "src/repro/kernels/gmm/kernel.py:91"}
    kernels = [dict(name=n, route="cuda", source=sources[n],
                    replaces=replaces[n], launches=path["launches"][n],
                    **kern[n]) for n in ("route_pack", "gmm",
                                         "placement_gmm")]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
