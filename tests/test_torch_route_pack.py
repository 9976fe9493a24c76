"""Route-pack: the port's plain version against the JAX reference and the
Pallas kernel (interpret mode). The bar is exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.route_pack import ops as jops
from repro.kernels.route_pack.kernel import route_pack_kernel
from repro.kernels.route_pack.ref import route_pack_ref as jax_ref
from repro_torch.kernels.route_pack import ops as tops
from repro_torch.kernels.route_pack.ref import route_pack_ref as torch_ref
from torch_parity import to_np

FIELDS = ("buckets", "scales", "eids", "rank", "keep")


def _inputs(seed, T, d, k, E, dtype, masked):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, d)) * 2).astype(np.float32)
    N = T * k
    dest = rng.integers(0, E, N).astype(np.int32)
    valid = rng.random(N) > 0.25 if masked else np.ones(N, bool)
    eid = rng.integers(0, 50, N).astype(np.int32)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx, dest, valid, eid


def _assert_same(got, want, tag):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), (tag, name)
        if g is not None:
            np.testing.assert_array_equal(to_np(g), to_np(w),
                                          err_msg=f"{tag} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("with_eid", [False, True])
@pytest.mark.parametrize("T,d,k,E,C,masked", [
    (16, 32, 2, 4, 6, True),       # masked rows
    (50, 16, 8, 8, 4, False),      # capacity overflows: drops
    (7, 128, 8, 3, 20, True),
    (1, 4, 1, 1, 4, False),
])
def test_route_pack_matches_jax(dtype, quantize, with_eid, T, d, k, E, C,
                                masked):
    jx, tx, dest, valid, eid = _inputs(T * 31 + E, T, d, k, E, dtype,
                                       masked)
    ei = eid if with_eid else None
    kw = dict(k=k, n_dest=E, capacity=C, quantize=quantize)
    want = jax_ref(jx, jnp.asarray(dest), jnp.asarray(valid),
                   None if ei is None else jnp.asarray(ei), **kw)
    pallas = jops.fused_route_pack(
        jx, jnp.asarray(dest), jnp.asarray(valid),
        None if ei is None else jnp.asarray(ei), use_pallas=True,
        interpret=True, **kw)
    targs = (tx, torch.from_numpy(dest), torch.from_numpy(valid),
             None if ei is None else torch.from_numpy(ei))
    _assert_same(torch_ref(*targs, **kw), want, "ref vs jax ref")
    _assert_same(tops.fused_route_pack(*targs, **kw), pallas,
                 "ops vs pallas")
    if not valid.all() or T * k > E * C:
        got = torch_ref(*targs, **kw)
        assert not got.keep.all()       # the case really drops rows


def test_padding_rows_take_no_rank_against_pallas_kernel():
    """Rows with dest == n_dest are padding: rank 0, never kept, no rank
    slot consumed — as in the Pallas kernel's padded tail."""
    rng = np.random.default_rng(3)
    T, d, k, E, C = 64, 8, 2, 5, 9
    N = T * k
    x = rng.standard_normal((T, d)).astype(np.float32)
    dest = rng.integers(0, E, N).astype(np.int32)
    pad = rng.random(N) < 0.3
    dest[pad] = E
    valid = (~pad & (rng.random(N) > 0.2)).astype(np.int32)
    eid = rng.integers(0, 9, N).astype(np.int32)
    b, s, e, rank, keep = route_pack_kernel(
        jnp.asarray(x), jnp.asarray(dest)[:, None],
        jnp.asarray(valid)[:, None], jnp.asarray(eid)[:, None], k=k,
        n_dest=E, capacity=C, quantize=True, has_eid=True, bn=128,
        interpret=True)
    got = torch_ref(torch.from_numpy(x), torch.from_numpy(dest),
                    torch.from_numpy(valid.astype(bool)),
                    torch.from_numpy(eid), k=k, n_dest=E, capacity=C,
                    quantize=True)
    for name, want in zip(FIELDS, (b, s, e, rank, keep)):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      to_np(want), err_msg=name)
    assert (got.rank.numpy()[pad] == 0).all() and not got.keep[pad].any()


def test_quantize_rounds_half_to_even():
    """An exact .5 quotient rounds to even (jnp.round), not away from 0."""
    x = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0]], np.float32)
    dest = np.zeros(1, np.int32)
    want = jax_ref(jnp.asarray(x), jnp.asarray(dest), n_dest=1, capacity=4,
                   quantize=True)
    got = torch_ref(torch.from_numpy(x), torch.from_numpy(dest), n_dest=1,
                    capacity=4, quantize=True)
    np.testing.assert_array_equal(got.buckets.numpy(), np.asarray(
        want.buckets))
    assert got.buckets[0, 0, 1:7].tolist() == [0, 2, 2, 0, -2, -2]


@pytest.mark.parametrize("E,R,n_local", [(6, 3, 2), (8, 1, 4), (5, 4, 5)])
def test_placement_route_matches_jax(E, R, n_local):
    rng = np.random.default_rng(E * 7 + R)
    N = 64
    dest = rng.integers(0, E, N).astype(np.int32)
    pos = np.repeat(np.arange(N // 4), 4).astype(np.int32)
    n_rep = rng.integers(1, R + 1, E).astype(np.int32)
    slots = rng.integers(0, E + R, (E, R)).astype(np.int32)
    want = jops.placement_route(*(jnp.asarray(a) for a in
                                  (dest, pos, slots, n_rep)))
    got = tops.placement_route(*(torch.from_numpy(a) for a in
                                 (dest, pos, slots, n_rep)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for rank in range(-(-(E + R) // n_local)):
        wl, wm = jops.placement_route_local(
            *(jnp.asarray(a) for a in (dest, pos, slots, n_rep)), rank,
            n_local)
        gl, gm = tops.placement_route_local(
            *(torch.from_numpy(a) for a in (dest, pos, slots, n_rep)), rank,
            n_local)
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
