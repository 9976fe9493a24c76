#!/usr/bin/env python3
"""Decode attention at RecurrentGemma-2B's local-attention shape, timed
at every split of the cache, on one NVIDIA GPU.

Run from the repository root: ``python3 tools/decode_attention_splits.py``.

The shape is B 4 and 8 rows, 10 query heads on one KV head, hd 256, a
ring of 2048 slots with every slot valid, bf16: three head groups of 4,
4 and 2 heads per (row, KV head). For each ``split_len`` (slots a block
walks; the wrapper's plan picks one by ``kernel.plan``) the kernel is
launched through its C entry with that split and timed under
``torch.profiler`` (device ms per call, 50 calls after warm-up), beside
its error against the plain version and ``scaled_dot_product_attention``
with the same mask. It answers whether another split of the cache, and
so another number of blocks per SM, would speed the kernel up. Prints
the card's name and power limit first.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

H, KV, HD, L = 10, 1, 256, 2048
SPLITS = (64, 128, 192, 256, 448, 512, 1024)


def device_ms(fn, reps: int = 50) -> float:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type.name == "CUDA" and e.count) / reps / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_attention_splits: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    from repro_torch.kernels import runtime
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    gpb, n_grp = K.head_groups(H // KV, HD)
    for B in (4, 8):
        q, k, v = ((torch.randn(s, generator=gen, device="cuda") * 0.5)
                   .bfloat16() for s in ((B, H, HD), (B, L, KV, HD),
                                         (B, L, KV, HD)))
        p = torch.full((B,), 3000, dtype=torch.int32, device="cuda")
        want = decode_attention_ref(q, k, v, p, window=L)
        print(f"B {B}: the plan takes split_len "
              f"{K.plan(B, H, KV, HD, L, K._n_sms(q.device))['split_len']}")
        for split_len in SPLITS:
            n_split = -(-L // split_len)
            pairs = B * KV * n_grp
            ws = torch.empty(pairs * n_split * (gpb * HD + 2 * gpb),
                             device="cuda")
            tickets = torch.zeros(pairs, dtype=torch.int32, device="cuda")
            out = torch.empty((B, H, HD), device="cuda")
            stream = runtime.stream_handle(q)

            def call():
                runtime.check_status("decode_attention", K._fn()(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
                    ws.data_ptr(), tickets.data_ptr(), out.data_ptr(), B, H,
                    KV, HD, gpb, L, split_len, n_split, L, *k.stride()[:3],
                    *v.stride()[:3], 1, stream))
            call()
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            print(f"B {B} split_len {split_len} n_split {n_split} blocks "
                  f"{n_split * pairs}: device {device_ms(call):.5f} ms, "
                  f"max abs err {err:.3g}", flush=True)
        mask = torch.ones((B, 1, 1, L), dtype=torch.bool, device="cuda")
        sdpa = device_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(
                             q[:, :, None], k.transpose(1, 2),
                             v.transpose(1, 2), attn_mask=mask,
                             enable_gqa=True))
        print(f"B {B} scaled_dot_product_attention: device {sdpa:.5f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
