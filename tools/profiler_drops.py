"""How many of a profiler window's device kernel events ``torch.profiler``
keeps, probed before and after each of ``chip_smoke.py``'s DeepSeek-V3
sub-stages (on the card).

A probe is one device-activity window of three blocks of ``REPS``
launches each: ``add_``, ``mul_`` and ``sub_`` on a small tensor.
``sub_`` runs torch's add kernel, so ``add`` counts the first and the
last block (``2 * REPS`` launches), ``mul`` the middle one, and ``sub``
stays 0. Each probe runs in four forms:
``plain`` (``ProfilerActivity.CUDA``), ``cpu`` (CPU and CUDA
activities), ``lead`` (``LEAD`` launches of a fourth kernel, ``fill_``,
before the blocks and after them) and ``sleep`` (the window held open
0.05 s before and after the blocks). Prints one JSON line per probe:
the stage it follows, the process age in seconds, and per form the
events each block kept.

    python tools/profiler_drops.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
REPS = 20
LEAD = 64
T0 = time.monotonic()


def window(form: str) -> dict:
    from torch.profiler import ProfilerActivity, profile

    a = torch.zeros(4096, device="cuda")
    b = torch.zeros(4096, device="cuda")
    acts = ([ProfilerActivity.CPU, ProfilerActivity.CUDA] if form == "cpu"
            else [ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if form == "sleep":
            time.sleep(0.05)
        for _ in range(LEAD if form == "lead" else 0):
            b.fill_(0.0)
        for op in (a.add_, a.mul_, a.sub_):
            for _ in range(REPS):
                op(1.0)
        for _ in range(LEAD if form == "lead" else 0):
            b.fill_(0.0)
        torch.cuda.synchronize()
        if form == "sleep":
            time.sleep(0.05)
    got = {"add": 0, "mul": 0, "sub": 0, "fill": 0, "other": 0}
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or not e.count:
            continue
        k = e.key.lower()
        name = next((n for n, pat in (("add", "add"), ("mul", "mul"),
                                      ("sub", "sub"), ("fill", "fill"))
                     if pat in k), "other")
        got[name] += e.count
    return got


def probe(after: str) -> None:
    print(json.dumps({"after": after,
                      "age_s": round(time.monotonic() - T0, 1),
                      **{f: window(f) for f in ("plain", "cpu", "lead",
                                                "sleep")}}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profiler_drops: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime

    probe("start")
    runtime.build()
    probe("build")
    for name in ("check_moe_kernels", "pd_stage", "mtp_stage",
                 "moe_attn_stage", "r0_init", "check_small_reference",
                 "launcher_stage"):
        def wrapped(*a, _f=getattr(cs, name), _n=name, **kw):
            out = _f(*a, **kw)
            probe(_n)
            return out
        setattr(cs, name, wrapped)
    cs.deepseek_stages(get_config)
    probe("deepseek_stages")
    for _ in range(200):
        window("plain")
    probe("200 more windows")
    return 0


if __name__ == "__main__":
    sys.exit(main())
