"""The port's GQA decode attention against the JAX package's.

The plain version (what a CPU tensor runs) is held against the JAX
package's ``decode_attention`` op (the Pallas kernel in interpret mode
on the CPU, as ``tests/test_kernels.py`` runs it) and against its
``decode_attention_ref``, on the same inputs made with numpy from a
seed: 2e-4 in float32 and 3e-2 in bf16, the bars of
``tests/test_kernels.py``. The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py``; here the wrapper's
checks and its split plan are tested, and the entry point's refusal of
other devices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_op
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention.kernel import (decode_attention_cuda,
                                                         split_plan)
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

TOL = {"float32": 2e-4, "bfloat16": 3e-2}

# (B, H, KV, hd, L, window, positions): None draws positions as
# tests/test_kernels.py does
CASES = {
    # the five shapes of tests/test_kernels.py
    "kernels-0": (2, 8, 2, 64, 512, 0, None),
    "kernels-1": (3, 4, 4, 32, 1024, 0, None),
    "kernels-2-ring": (2, 8, 2, 64, 512, 256, None),
    "kernels-3": (1, 16, 1, 128, 2048, 0, None),
    "kernels-4": (2, 4, 2, 64, 384, 0, None),
    # Llama-4's grouping: G = 5 query heads per KV head
    "gqa-g5": (3, 10, 2, 32, 256, 0, (0, 97, 255)),
    # a ragged cache length, with the last slot in use
    "ragged-L100": (2, 10, 2, 32, 100, 0, (99, 41)),
    # a new token at position 0: one valid slot
    "pos0": (2, 8, 2, 64, 128, 0, (0, 0)),
    # a ring window several wraps past its length, ragged L
    "ring-wrapped": (3, 10, 2, 32, 200, 64, (700, 63, 130)),
    # the served groupings at hd 128 (named to sort after the cases
    # above, whose seeds are their sorted index): G = 1 (DeepSeek-MoE's
    # MHA), G = 2 (InternLM2) with ragged positions, G = 8 (Command-R)
    "served-g1-hd128": (2, 4, 4, 128, 256, 0, None),
    "served-g2-hd128": (3, 4, 2, 128, 300, 0, (299, 0, 131)),
    "served-g8-hd128": (2, 16, 2, 128, 512, 0, None),
}


def _inputs(case, dtype):
    B, H, KV, hd, L, w, pos = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, k, v = (rng.standard_normal(s).astype(np.float32) * 0.5
               for s in ((B, H, hd), (B, L, KV, hd), (B, L, KV, hd)))
    if pos is None:
        lo = min(L, w or L) // 2
        pos = rng.integers(lo, (w or L) - 1, B) + (100 if w else 0)
    pos = np.asarray(pos, np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [jnp.asarray(pos)]
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + \
        [torch.from_numpy(pos)]
    return jx, tx, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_jax_op_and_ref(case, dtype):
    (jq, jk, jv, jpos), (tq, tk, tv, tpos), w = _inputs(case, dtype)
    got = decode_attention(tq, tk, tv, tpos, window=w)
    assert got.dtype == torch.float32 and got.shape == tq.shape
    tol = TOL[dtype]
    for want in (jax_op(jq, jk, jv, jpos, window=w),
                 jax_ref(jq, jk, jv, jpos, window=w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
    # the plain version is what the entry point runs for a CPU tensor
    assert torch.equal(got, decode_attention_ref(tq, tk, tv, tpos, window=w))


def test_entry_point_refuses_other_devices():
    q = torch.zeros((1, 2, 32), device="meta")
    kv = torch.zeros((1, 8, 1, 32), device="meta")
    pos = torch.zeros((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        decode_attention(q, kv, kv, pos)


def test_cuda_wrapper_checks_before_launching():
    """The wrapper refuses what the kernel does not take, and a CPU
    tensor: it never falls back to the plain version."""
    q = torch.zeros((2, 10, 32))
    kv = torch.zeros((2, 16, 2, 32))
    pos = torch.zeros((2,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA device"):
        decode_attention_cuda(q, kv, kv, pos)
    with pytest.raises(ValueError, match="shapes"):      # hd 48
        decode_attention_cuda(torch.zeros((2, 10, 48)),
                              torch.zeros((2, 16, 2, 48)),
                              torch.zeros((2, 16, 2, 48)), pos)
    with pytest.raises(ValueError, match="unit stride"):
        t = torch.zeros((2, 16, 32, 2)).transpose(2, 3)
        decode_attention_cuda(q, t, t, pos)
    with pytest.raises(ValueError, match="aligned"):    # base off by 4 B
        t = torch.zeros(2 * 16 * 2 * 32 + 1)[1:].view(2, 16, 2, 32)
        decode_attention_cuda(q, t, t, pos)
    with pytest.raises(TypeError, match="dtype"):
        decode_attention_cuda(q, kv.to(torch.bfloat16), kv, pos)


@pytest.mark.parametrize("B,KV,L", [(4, 8, 1024), (4, 8, 32768),
                                    (4, 8, 1000), (1, 2, 1), (3, 2, 100),
                                    (64, 8, 4096), (4, 8, 131072),
                                    (4, 8, 576), (1, 1, 1_000_000),
                                    # short caches: one cluster's ranges
                                    (4, 1, 2048), (8, 1, 2048),
                                    (1, 1, 256), (2, 4, 1601)])
def test_split_plan_covers_the_cache_in_whole_tiles(B, KV, L):
    sms = 132
    split_len, n = split_plan(B, KV, L, n_sms=sms)
    assert split_len % 64 == 0 and 1 <= n <= 64
    assert (n - 1) * split_len < L <= n * split_len
    tiles = -(-L // 64)
    # a wave is two blocks per SM; the batch alone may fill it
    wave = max(1, 2 * sms // (B * KV))
    if tiles <= 32:
        # a short cache: one block up to 4 tiles, else at most 8 ranges
        # (one cluster) of at least 3 tiles
        assert n == 1 if tiles <= 4 else (n <= 8 and split_len >= 3 * 64)
        return
    # the card is at least half filled, or every tile has its own block
    assert 2 * n > min(wave, tiles, 64)
    # at most two waves
    assert B * KV * n <= max(2 * 2 * sms, 2 * B * KV)
    # a block walks at most 2048 slots unless the plan takes two waves
    assert split_len <= 2048 or n >= min(2 * wave, 64)
    # a cluster's blocks (2-8 splits) take at most 7/8 of a wave
    if 2 <= n <= 8 and B * KV * n <= 2 * sms:
        assert 8 * B * KV * n <= 7 * 2 * sms
