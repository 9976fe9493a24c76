"""A plain model of how the CUDA decode-attention kernel partitions the
cache, held against the plain version and the JAX package's op.

The kernel (``csrc/decode_attention.cu``) walks each (batch row, KV
head) in ``n_split`` ranges of ``split_len`` slots (``split_plan``),
keeps an unnormalised (m, l, acc) per range with ``p`` cast to the value
type inside the range, and merges the ranges by log-sum-exp weights in
range order, in the same launch. :func:`partitioned` is that arithmetic
in PyTorch, one range at a time; on the cases of
``tests/test_torch_decode_attention.py`` it must agree with
``decode_attention_ref`` and with the JAX op (the Pallas kernel in
interpret mode) within 2e-4 in float32 and 3e-2 in bf16, under the plan
of a 132-SM card and of a 4-SM one (more, shorter ranges). A NaN in a
masked slot (a stale cache tail past the row's position) must not reach
the output: it is held against the same inputs with that tail zeroed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_op
from repro_torch.kernels.decode_attention.kernel import split_plan
from repro_torch.kernels.decode_attention.ref import (decode_attention_ref,
                                                      valid_slots)
from test_torch_decode_attention import CASES, TOL, _inputs


def partitioned(q, k, v, positions, *, window=0, n_sms=132):
    """The kernel's partition of the cache, as plain PyTorch."""
    B, H, hd = q.shape
    L, KV = k.shape[1], k.shape[2]
    G = H // KV
    split_len, n_split = split_plan(B, KV, L, n_sms)
    valid = valid_slots(positions, L, window)
    qr = q.reshape(B, KV, G, hd).float()
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
    m = torch.stack(ms)                              # [n, B, KV, G]
    M = m.amax(dim=0)
    safe = torch.where(torch.isfinite(M), M, torch.zeros_like(M))
    w = torch.where(torch.isfinite(m), torch.exp(m - safe),
                    torch.zeros_like(m))
    acc = torch.zeros_like(accs[0])
    l = torch.zeros_like(ls[0])
    for j in range(len(accs)):                       # range order
        acc = acc + w[j][..., None] * accs[j]
        l = l + w[j] * ls[j]
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, H, hd)


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
