"""Grouped expert FFN on decode-like sparse buckets: what the CUDA
kernel's skip of empty buckets and rows relies on.

Most slots empty, some partly filled, at the capacities the serving paths
pack (4, 5, 8) and one above a tensor-core row tile (12). The port's
``expert_ffn`` on the CPU (its plain version) against the JAX reference:
2e-4 in float32 against ``gmm_ref`` / ``placement_gmm_ref``, 3e-2 in bf16
against the Pallas kernel in interpret mode (which casts the hidden to
bf16, as the CUDA kernel does), with and without an owner table
(repeated owners, empty replica slots). An all-zero row gives exactly
+0.0 in both plain versions, which is what the kernel writes for the
rows it skips. ``live_rows`` (the rows the kernel's prologue counts on the
card) against a numpy loop. The CUDA wrapper's refusals, which come
before any build or launch."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import ops as jops
from repro.kernels.gmm.ref import gmm_ref, placement_gmm_ref
from repro_torch.kernels.gmm.kernel import gmm_cuda_with_rows
from repro_torch.kernels.gmm.ops import expert_ffn
from repro_torch.kernels.gmm.ref import gmm_ref as plain_gmm_ref
from repro_torch.kernels.gmm.ref import live_rows
from repro_torch.kernels.gmm.ref import placement_gmm_ref as plain_placement
from torch_parity import to_np

CAPACITIES = (4, 5, 8, 12)


def _sparse(seed, S, E, C, d, f, live):
    """Buckets [S, C, d] with ``live`` slots holding 1..C leading rows
    (one slot full), the rest zero; weights [E, ...]; an owner table [S]
    with two experts repeated and every expert owned."""
    rng = np.random.default_rng(seed)
    b = np.zeros((S, C, d), np.float32)
    slots = rng.choice(S, size=live, replace=False)
    for i, s in enumerate(slots):
        n = C if i == 0 else int(rng.integers(1, C + 1))
        b[s, :n] = rng.standard_normal((n, d)) * 0.3
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    owner = np.concatenate([np.arange(E), rng.integers(0, E, S - E)])
    return b, ws, rng.permutation(owner).astype(np.int32)


def _both(arrs, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("owned", [False, True])
@pytest.mark.parametrize("C", CAPACITIES)
def test_sparse_buckets_f32_match_jax_ref(C, owned):
    E, d, f = 8, 64, 96
    S = E + 4 if owned else E
    b, ws, owner = _sparse(C * 10 + owned, S, E, C, d, f, live=3)
    (jb, *jw), (tb, *tw) = _both([b, *ws], "float32")
    if owned:
        got = expert_ffn(tb, *tw, phys_owner=torch.from_numpy(owner))
        want = placement_gmm_ref(jb, *jw, jnp.asarray(owner))
    else:
        got, want = expert_ffn(tb, *tw), gmm_ref(jb, *jw)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("owned", [False, True])
@pytest.mark.parametrize("C", CAPACITIES)
def test_sparse_buckets_bf16_within_pallas_tolerance(C, owned):
    E, d, f = 4, 64, 128
    S = E + 3 if owned else E
    b, ws, owner = _sparse(C * 7 + owned, S, E, C, d, f, live=2)
    (jb, *jw), (tb, *tw) = _both([b, *ws], "bfloat16")
    kw = {"phys_owner": jnp.asarray(owner)} if owned else {}
    want = jops.expert_ffn(jb, *jw, use_pallas=True, interpret=True, **kw)
    tkw = {"phys_owner": torch.from_numpy(owner)} if owned else {}
    got = expert_ffn(tb, *tw, **tkw)
    assert got.dtype == torch.float32 and got.shape == (S, C, d)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("owned", [False, True])
def test_all_zero_rows_give_positive_zero(owned):
    """Every all-zero row (empty slots, rows past a slot's live ones, a
    zero row between live ones, a row of -0.0) is +0.0 in every element
    of the port's plain version and of the JAX reference."""
    E, C, d, f = 4, 5, 32, 64
    S = E + 2 if owned else E
    b, ws, owner = _sparse(3, S, E, C, d, f, live=2)
    live = np.flatnonzero(np.abs(b).max(axis=(1, 2)) > 0)
    b[live[0], 1] = 0.0
    b[live[1], C - 1] = -0.0
    zero = ~np.any(b != 0, axis=-1)
    assert zero.sum() >= (S - 2) * C + 1
    tb, *tw = (torch.from_numpy(a) for a in (b, *ws))
    jb, *jw = (jnp.asarray(a) for a in (b, *ws))
    if owned:
        port = plain_placement(tb, *tw, torch.from_numpy(owner))
        jax_ = placement_gmm_ref(jb, *jw, jnp.asarray(owner))
    else:
        port, jax_ = plain_gmm_ref(tb, *tw), gmm_ref(jb, *jw)
    for out in (to_np(port), to_np(jax_)):
        assert np.all(out[zero] == 0.0)
        assert not np.any(np.signbit(out[zero]))


def _live_rows_loop(b):
    """1 + the index of the last row with an element != 0 (NaN counts),
    0 for none."""
    S, C, _ = b.shape
    out = np.zeros(S, np.int32)
    for s in range(S):
        for c in range(C):
            if any(v != 0 for v in b[s, c]):
                out[s] = c + 1
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_live_rows_matches_loop(dtype):
    S, C, d = 7, 6, 16
    rng = np.random.default_rng(5)
    b = np.zeros((S, C, d), np.float32)
    b[0, :3] = rng.standard_normal((3, d))          # three leading rows
    b[1, C - 1, d - 1] = 2.0                        # only the last element
    b[2, 0] = 1.0
    b[2, 2] = -0.0                                  # a -0.0 row counts as 0
    b[3, 4, 7] = np.nan                             # a NaN row is live
    b[4, 1] = -0.0
    b[5, 0, 0] = np.inf
    b[5, 2] = 0.5                                   # a zero row between
    want = _live_rows_loop(b)
    np.testing.assert_array_equal(want, [3, C, 1, 5, 0, 3, 0])
    got = live_rows(torch.from_numpy(b).to(getattr(torch, dtype)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(5, 4, 8), (3, 0, 8), (0, 4, 8)])
def test_live_rows_of_empty_tensors(shape):
    b = torch.zeros(shape)
    b[:, :, 0] = -0.0
    got = live_rows(b)
    assert got.dtype == torch.int32 and got.shape == (shape[0],)
    assert not got.any()


def _refused(case):
    E, C, d, f = 2, 4, 16, 32
    dt = torch.bfloat16
    args = [torch.zeros(sh, dtype=dt)
            for sh in ((E, C, d), (E, d, f), (E, d, f), (E, f, d))]
    owner = None
    if case == "bf16 width not a multiple of 8":
        args = [torch.zeros(sh, dtype=dt)
                for sh in ((E, C, 12), (E, 12, f), (E, 12, f), (E, f, 12))]
    elif case == "dtypes differ":
        args[3] = args[3].float()
    elif case == "owner shape":
        owner = torch.zeros((E + 1,), dtype=torch.int32)
    elif case == "buckets for another expert count":
        args[0] = torch.zeros((E + 1, C, d), dtype=dt)
    return args, owner


@pytest.mark.parametrize("case", ["cpu tensors", "bf16 width not a "
                                  "multiple of 8", "dtypes differ",
                                  "owner shape",
                                  "buckets for another expert count"])
def test_kernel_wrapper_refuses(case):
    """The CUDA wrapper has no CPU route and takes only what the kernel
    takes; it raises before it builds or launches anything."""
    args, owner = _refused(case)
    err = TypeError if case == "dtypes differ" else ValueError
    with pytest.raises(err):
        gmm_cuda_with_rows(*args, owner)
