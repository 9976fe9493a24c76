#!/usr/bin/env python3
"""The grouped expert FFN kernel of one or more trees, on the card, in turns.

    python3 tools/gmm_variants.py --src A/src [--src B/src] [--quick]
        [--out FILE]

Each ``src/`` tree's ``kernels/csrc/gmm.cu`` is built by ``nvcc`` (this
tree's flags, all builds at once) into a temporary directory and loaded
with ``ctypes`` into one process, so that every build runs on the same
card, inputs and host state. The call is the wrapper's (``gmm_launch``:
buckets, weights, owner, hidden, output, work). Prints each build's
``ptxas`` lines (registers, spills), then:

* held: on small odd shapes (widths off the 64- and 128-element tiles,
  C 12, 100 and 130: a second row tile) and at every timed shape, each
  build within 3e-2 of ``gmm_ref``, its rows equal to ``live_rows``, a
  repeat bit-identical, all-zero rows +0, and the owner-indexed call
  bit-identical to the plain call on owner-gathered weights;
* timed, at DeepSeek-MoE-16B's width (64 experts, d 2048, f 1408, top-6,
  capacity factor 1.5) at T 4, 64, 88, 120, 128, 256, 512 and 1024
  routed tokens (C 4, 9, 12, 16, 18, 36, 72, 144), and DeepSeek-V3's
  (256 experts, d 7168, f 2048, top-8, 1.25) at T 4, 512 and 615 (C 4,
  20, 24): CUDA-event ms per call (median of 20, the builds called in
  turn a b b a), device ms under ``torch.profiler`` (each build in a
  window of its own; each kernel's share beside the sum), the bound
  (live experts' weights read once at 3.35 TB/s), the ``torch.bmm``
  chain's event ms, and the largest difference between the builds'
  outputs. ``--quick`` times only C 36 and 72.

Buckets are routed as the MoE layer routes them (top-k of random scores,
each expert's first min(count, C) rows filled), from seed 0. Prints the
card's name and power limit, then one JSON line (also written to
``--out``).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.gmm.kernel import plan  # noqa: E402
from repro_torch.kernels.gmm.ref import (gmm_ref, live_rows,  # noqa: E402
                                         placement_gmm_ref)

HBM = 3.35e12
#: (name, experts, d, f, top-k, capacity factor, token counts)
MODELS = (("deepseek-moe-16b", 64, 2048, 1408, 6, 1.5,
           (4, 64, 88, 120, 128, 256, 512, 1024)),
          ("deepseek-v3-671b", 256, 7168, 2048, 8, 1.25, (4, 512, 615)))
QUICK = {("deepseek-moe-16b", 256), ("deepseek-moe-16b", 512)}
#: (slots, experts, C, d, f): off the tiles, a second row tile
ODD = ((7, 5, 12, 72, 200), (6, 6, 100, 64, 136), (5, 4, 130, 136, 64),
       (4, 4, 40, 2048, 1408))


def build(srcs, tmp):
    procs = []
    for i, src in enumerate(srcs):
        cu = Path(src) / "repro_torch/kernels/csrc/gmm.cu"
        lib = Path(tmp) / f"libgmm{i}.so"
        procs.append((lib, subprocess.Popen(
            [runtime._nvcc(), *runtime.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for (lib, proc), src in zip(procs, srcs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        name = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "spill" in line or "registers" in line:
                print(f"{src}: {name}: {line.strip()}", flush=True)
        fn = ctypes.CDLL(str(lib)).gmm_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs.append(fn)
    return libs


def call(fn, b, wg, wu, wd, owner=None):
    S, C, d = b.shape
    E, _, f = wg.shape
    hidden = torch.empty((S, C, f), dtype=b.dtype, device=b.device)
    out = torch.empty((S, C, d), dtype=torch.float32, device=b.device)
    work = torch.empty(S + 1 + S * C, dtype=torch.int32, device=b.device)
    status = fn(b.data_ptr(), wg.data_ptr(), wu.data_ptr(), wd.data_ptr(),
                None if owner is None else owner.data_ptr(),
                hidden.data_ptr(), out.data_ptr(), work.data_ptr(), S, C, d,
                f, E, 1, runtime.stream_handle(b))
    if status:
        raise RuntimeError(f"gmm_launch: CUDA error {status}")
    return out, work[:S]


def routed(T, E, C, d, k, gen, S=None):
    """[S or E, C, d] bf16 buckets of T tokens routed top-k over E."""
    S = S or E
    ids = torch.rand((T, S), generator=gen, device="cuda").topk(
        k, dim=-1).indices.reshape(-1)
    rows = torch.bincount(ids, minlength=S).clamp(max=C)
    keep = torch.arange(C, device="cuda")[None, :] < rows[:, None]
    x = torch.randn((S, C, d), generator=gen, device="cuda")
    return (x * keep[..., None]).to(torch.bfloat16)


def weights(E, d, f, gen):
    return [(torch.randn(s, generator=gen, device="cuda",
                         dtype=torch.bfloat16) / fan ** 0.5)
            for s, fan in (((E, d, f), d), ((E, d, f), d), ((E, f, d), f))]


def held(fns, b, ws, what, owner=None):
    """Every build within 3e-2 of the plain version, rows, repeat, +0
    rows, placement = gathered; returns (outputs, largest error)."""
    want = (gmm_ref(b, *ws) if owner is None
            else placement_gmm_ref(b, *ws, owner))
    outs, err = [], 0.0
    zero = ~(b != 0).any(dim=-1)
    for i, fn in enumerate(fns):
        got, rows = call(fn, b, *ws, owner)
        e = (got - want).abs().max().item()
        ok = (e <= 3e-2 and torch.equal(rows, live_rows(b))
              and torch.equal(call(fn, b, *ws, owner)[0], got)
              and bool((got[zero] == 0).all())
              and not bool(torch.signbit(got[zero]).any()))
        if owner is not None:
            o = owner.long()
            ok = ok and torch.equal(call(fn, b, *(w[o] for w in ws))[0], got)
        if not ok:
            raise RuntimeError(f"{what}, build {i}: max abs err {e}, rows "
                               f"{torch.equal(rows, live_rows(b))}")
        outs.append(got)
        err = max(err, e)
    return outs, err


def turns(fns, reps=20):
    """Median event ms per call of each of ``fns``, called in turn."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    order = list(range(len(fns)))
    for r in range(reps):
        for j in (order if r % 2 == 0 else order[::-1]):
            a = torch.cuda.Event(enable_timing=True)
            z = torch.cuda.Event(enable_timing=True)
            a.record()
            fns[j]()
            z.record()
            z.synchronize()
            times[j].append(a.elapsed_time(z))
    return [statistics.median(t) for t in times]


def device_ms(fn, reps=20):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {e.key: e.self_device_time_total / e.count
           * max(1, round(e.count / reps)) / 1e3
           for e in prof.key_averages()
           if e.device_type.name == "CUDA" and e.count}
    return {"ms": sum(per.values()), "kernels": per}


def by_kernel(dev: dict) -> str:
    """'name ms, ...' of a :func:`device_ms` result, names without their
    argument lists."""
    return ", ".join(f"{k.split('(')[0]} {v:.5f}"
                     for k, v in dev["kernels"].items())


def bmm_chain(b, g, u, dn):
    h = torch.bmm(b, g)
    return torch.bmm(torch.nn.functional.silu(h) * torch.bmm(b, u),
                     dn).float()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        fns = build(args.src, tmp)
        res = {"card": smi, "trees": args.src, "odd": {}, "timed": []}
        for S, E, C, d, f in ODD:
            ws = weights(E, d, f, gen)
            owner = torch.cat([torch.arange(E), torch.tensor([1, 3, 1])[
                :S - E]]).to(device="cuda", dtype=torch.int32)
            b = routed(C * S // 2, S, C, d, 2, gen, S)
            _, err = held(fns, b, ws, f"odd {S, E, C, d, f}", owner)
            bs = routed(C * E // 2, E, C, d, 2, gen)
            _, err2 = held(fns, bs, ws, f"odd {E, C, d, f}")
            res["odd"][f"S{S} E{E} C{C} d{d} f{f}"] = max(err, err2)
            print(f"odd S {S} E {E} C {C} d {d} f {f}: held, max abs err "
                  f"{max(err, err2):.3g}", flush=True)
        for name, E, d, f, k, cf, counts in MODELS:
            ws = weights(E, d, f, gen)
            for T in counts:
                if args.quick and (name, T) not in QUICK:
                    continue
                C = max(int(T * k / E * cf), 4)
                b = routed(T, E, C, d, k, gen)
                outs, err = held(fns, b, ws, f"{name} T {T}")
                rows = live_rows(b)
                live = int((rows > 0).sum())
                bound = (live * 3 * d * f * 2 + b.numel() * 6) / HBM * 1e3
                calls = [lambda fn=fn: call(fn, b, *ws) for fn in fns]
                ev = turns(calls + [lambda: bmm_chain(b, *ws)])
                row = dict(model=name, T=T, C=C, live=live,
                           rows=int(rows.sum()),
                           plan=plan(E, C, d, f, torch.bfloat16)._asdict(),
                           max_abs_err=err, events_ms=ev[:-1],
                           device=[device_ms(c) for c in calls],
                           bmm_chain_ms=ev[-1], bound_ms=bound,
                           builds_max_diff=max(
                               (o - outs[0]).abs().max().item()
                               for o in outs))
                res["timed"].append(row)
                print(f"{name} T {T} C {C} ({live} live): events "
                      f"{[round(t, 4) for t in ev[:-1]]} ms, device "
                      f"{[round(x['ms'], 5) for x in row['device']]} ms "
                      f"({'; '.join(map(by_kernel, row['device']))}), "
                      f"bmm_chain {ev[-1]:.4f}, bound {bound:.4f}, err "
                      f"{err:.3g}, builds differ by "
                      f"{row['builds_max_diff']:.3g}", flush=True)
            del ws
            torch.cuda.empty_cache()
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
