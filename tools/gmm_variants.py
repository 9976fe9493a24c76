#!/usr/bin/env python3
"""The grouped expert FFN kernel of one or more trees, on the card, in turns.

    python3 tools/gmm_variants.py --src A/src [--src B/src] [--quick]
        [--out FILE]

Each ``src/`` tree's ``kernels/csrc/gmm.cu`` is built by ``nvcc`` (this
tree's flags, all builds at once) into a temporary directory and loaded
with ``ctypes`` into one process, so that every build runs on the same
card, inputs and host state. The call is the wrapper's (``gmm_launch``:
buckets, weights, owner, hidden, output, work), with the work buffer a
build's own ``gmm_work_ints`` asks for (``S + 1 + S * C`` ints for a
build that has none, as before the C <= 8 K split). Prints each build's
``ptxas`` lines (registers, spills), then:

* held: on small odd shapes (widths off the 64- and 128-element tiles,
  C 3, 5, 6, 12, 100 and 130: a second row tile; d 1000, f 2504 with
  40 slots: whole rounds and leftover pieces) and at every timed shape,
  each build within 3e-2 of ``gmm_ref``, its rows equal to
  ``live_rows``, a repeat bit-identical, all-zero rows +0, the
  owner-indexed call bit-identical to the plain call on owner-gathered
  weights (16 slots at a time), and a live slot's output bit-identical
  alone in the call and beside every other slot;
* timed, at DeepSeek-MoE-16B's width (64 experts, d 2048, f 1408, top-6,
  capacity factor 1.5) at T 4, 32, 64, 88, 120, 128, 256, 512 and 1024
  routed tokens (C 4, 4, 9, 12, 16, 18, 36, 72, 144), DeepSeek-V3's (256
  experts, d 7168, f 2048, top-8, 1.25) at T 4, 64, 512 and 615 (C 4, 4,
  20, 24) and Llama-4's (128 experts, d 5120, f 8192, top-1, 1.25) at T
  4, 32, 512 and 826 (C 4, 4, 5, 8); for each model one live slot of C
  4 rows, and at T 4 (decode) ``placement_gmm`` on E + 2 slots (two hot
  experts replicated): CUDA-event ms per call (median of 20, the builds
  called in turn a b b a), device ms under ``torch.profiler`` (each
  build in a window of its own; each kernel's share beside the sum), the
  bound (live experts' weights read once at 3.35 TB/s), the
  ``torch.bmm`` chain's event and device ms (plain calls only), and the
  largest difference between the builds' outputs. ``--quick`` times only
  the C <= 8 shapes; ``--models`` picks models by name.

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
#: (name, experts, d, f, top-k, capacity factor, token counts; 0: one
#: live slot of C 4 rows)
MODELS = (("deepseek-moe-16b", 64, 2048, 1408, 6, 1.5,
           (4, 0, 32, 64, 88, 120, 128, 256, 512, 1024)),
          ("deepseek-v3-671b", 256, 7168, 2048, 8, 1.25, (4, 0, 64, 512, 615)),
          ("llama-4", 128, 5120, 8192, 1, 1.25, (4, 0, 32, 512, 826)))
#: the decode token count: placement_gmm is timed there too
DECODE_T = 4
#: (slots, experts, C, d, f): off the tiles, a second row tile; at C <= 8
#: ragged tiles under a K split, and whole rounds beside leftover pieces
ODD = ((7, 5, 12, 72, 200), (6, 6, 100, 64, 136), (5, 4, 130, 136, 64),
       (4, 4, 40, 2048, 1408), (7, 5, 3, 72, 200), (4, 4, 8, 2048, 1408),
       (6, 5, 6, 1000, 2504), (42, 40, 5, 1000, 2504))


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
        so = ctypes.CDLL(str(lib))
        fn = so.gmm_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn.work_ints = lambda S, C, d, f: S + 1 + S * C
        if hasattr(so, "gmm_work_ints"):
            so.gmm_work_ints.argtypes = [ctypes.c_int] * 5
            so.gmm_work_ints.restype = ctypes.c_longlong
            fn.work_ints = (lambda S, C, d, f, w=so.gmm_work_ints:
                            w(S, C, d, f, 1))
        libs.append(fn)
    return libs


def call(fn, b, wg, wu, wd, owner=None):
    S, C, d = b.shape
    E, _, f = wg.shape
    hidden = torch.empty((S, C, f), dtype=b.dtype, device=b.device)
    out = torch.empty((S, C, d), dtype=torch.float32, device=b.device)
    work = torch.empty(fn.work_ints(S, C, d, f), dtype=torch.int32,
                       device=b.device)
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
    rows, placement = gathered (16 slots at a time), and a live slot
    alone = beside the others; returns (outputs, largest error)."""
    want = (gmm_ref(b, *ws) if owner is None
            else placement_gmm_ref(b, *ws, owner))
    outs, err = [], 0.0
    zero = ~(b != 0).any(dim=-1)
    live = (live_rows(b) > 0).nonzero().flatten()
    alone = torch.zeros_like(b)
    if live.numel():
        alone[live[0]] = b[live[0]]
    for i, fn in enumerate(fns):
        got, rows = call(fn, b, *ws, owner)
        e = (got - want).abs().max().item()
        checks = {
            "within 3e-2": e <= 3e-2,
            "rows": torch.equal(rows, live_rows(b)),
            "repeat": torch.equal(call(fn, b, *ws, owner)[0], got),
            "+0 rows": bool((got[zero] == 0).all())
            and not bool(torch.signbit(got[zero]).any())}
        if live.numel():
            checks["alone"] = torch.equal(
                call(fn, alone, *ws, owner)[0][live[0]], got[live[0]])
        if owner is not None:
            o = owner.long()
            checks["gathered"] = all(
                torch.equal(call(fn, b[s:s + 16],
                                 *(w[o[s:s + 16]] for w in ws))[0],
                            got[s:s + 16])
                for s in range(0, b.shape[0], 16))
        if not all(checks.values()):
            raise RuntimeError(f"{what}, build {i}: max abs err {e}, "
                               f"{checks}")
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


def timed(fns, b, ws, name, T, C, owner=None) -> dict:
    """One shape held, then timed: each build's event and device ms in
    turns beside the bound and (plain calls) the bmm chain's."""
    what = f"{name} T {T or 'one live slot'}" + (
        " placement" if owner is not None else "")
    outs, err = held(fns, b, ws, what, owner)
    E, d, f = ws[0].shape
    rows = live_rows(b)
    live_slots = (rows > 0).nonzero().flatten()
    experts = int((live_slots if owner is None else owner[live_slots])
                  .unique().numel())
    bound = (experts * 3 * d * f * 2 + b.numel() * 6) / HBM * 1e3
    calls = [lambda fn=fn: call(fn, b, *ws, owner) for fn in fns]
    chain = [] if owner is not None else [lambda: bmm_chain(b, *ws)]
    ev = turns(calls + chain)
    row = dict(model=name, T=T, C=C, slots=b.shape[0],
               placement=owner is not None, live=int(live_slots.numel()),
               rows=int(rows.sum()),
               plan=plan(b.shape[0], C, d, f, torch.bfloat16)._asdict(),
               max_abs_err=err, events_ms=ev[:len(fns)],
               device=[device_ms(c) for c in calls],
               bmm_chain_ms=ev[-1] if chain else None,
               bmm_chain_device_ms=(device_ms(chain[0])["ms"] if chain
                                    else None),
               bound_ms=bound,
               builds_max_diff=max((o - outs[0]).abs().max().item()
                                   for o in outs))
    print(f"{what} C {C} ({row['live']} of {b.shape[0]} live): events "
          f"{[round(t, 4) for t in row['events_ms']]} ms, device "
          f"{[round(x['ms'], 5) for x in row['device']]} ms "
          f"({'; '.join(map(by_kernel, row['device']))}), bmm_chain "
          f"{row['bmm_chain_ms']} (device {row['bmm_chain_device_ms']}), "
          f"bound {bound:.4f}, err {err:.3g}, builds differ by "
          f"{row['builds_max_diff']:.3g}", flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--models", nargs="*")
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
            if args.models and name not in args.models:
                continue
            ws = weights(E, d, f, gen)
            for T in counts:
                C = max(int(T * k / E * cf), 4)
                if args.quick and C > 8:
                    continue
                if T:
                    b = routed(T, E, C, d, k, gen)
                else:
                    b = torch.zeros((E, C, d), dtype=torch.bfloat16,
                                    device="cuda")
                    b[E // 3] = torch.randn((C, d), generator=gen,
                                            device="cuda")
                res["timed"].append(timed(fns, b, ws, name, T, C))
                if T == DECODE_T:
                    hot = torch.tensor([3 % E, 77 % E])
                    owner = torch.cat([torch.arange(E), hot]).to(
                        device="cuda", dtype=torch.int32)
                    pb = routed(T, E + 2, C, d, k, gen, E + 2)
                    res["timed"].append(timed(fns, pb, ws, name, T, C,
                                              owner))
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
