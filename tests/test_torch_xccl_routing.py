"""XCCL dispatch / combine and A2E / E2A across 8 gloo ranks, against the
reference's ``shard_map`` programs on an 8-device mesh
(``tests/test_multidevice.py``'s cases): the routing state (FIFO ranks,
keep masks, received expert ids, destination ranks) exactly, payloads
within 1e-5 in f32, the quantized wire within its error bound, and the
trampoline's staged and returned payloads exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import reference

E, D, N_LOC, R = 16, 32, 24, 8
N_ATTN, C = 4, 4
CASES = [(q, cf) for q in (False, True) for cf in (8.0, 1.0)]


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((R, N_LOC, D)).astype(np.float32)
    idx = rng.integers(0, E, (R, N_LOC)).astype(np.int32)
    payload = np.zeros((R, R, C, D), np.float32)
    for a in range(N_ATTN):
        payload[a] = a + 1 + rng.standard_normal((R, C, D)) * 0.01
    return x, idx, payload


REFERENCE = """
from repro.xccl.routing import dispatch_local, combine_local, make_a2e_e2a
from test_torch_xccl_routing import CASES, E, R, N_ATTN, _inputs
x, idx, payload = _inputs()
mesh = auto_mesh((R,), ("ep",))
for q, cf in CASES:
    def body(x, idx):
        buckets, st = dispatch_local(x[0], idx[0], ep_axis="ep", ep_size=R,
                                     n_experts=E, capacity_factor=cf,
                                     quantize=q)
        e_local = E // R
        expert = buckets * (jnp.arange(e_local, dtype=jnp.float32)
                            + 1.0)[:, None, None]
        y = combine_local(expert, st, ep_axis="ep", ep_size=R, quantize=q)
        flat_eid, rank2, keep2, dest_rank, rank1, keep1, _, _ = st
        return tuple(a[None] for a in (y, buckets, flat_eid, rank2, keep2,
                                       dest_rank, rank1, keep1))
    f = shard_map(body, mesh=mesh,
                  in_specs=(P("ep", None, None), P("ep", None)),
                  out_specs=(P("ep"),) * 8, check_rep=False)
    outs = f(jnp.asarray(x), jnp.asarray(idx))
    for n, a in zip(("y", "buckets", "flat_eid", "rank2", "keep2",
                     "dest_rank", "rank1", "keep1"), outs):
        put(f"{n}/{q}/{cf}", a)
a2e, e2a = make_a2e_e2a(mesh, "ep", N_ATTN, R)
staged = a2e(jnp.asarray(payload).reshape(R, R, *payload.shape[2:]))
put("staged", staged)
put("back", e2a(staged))
"""


def _rank(rank, world, init, x, idx, payload):
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.xccl.routing import (combine_local, dispatch_local,
                                          make_a2e_e2a)

    mesh = init_mesh((R,), "gloo", "cpu", axis_names=("ep",), rank=rank,
                     world_size=world, init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=(), ep_axis="ep")
    out = {}
    xs, ids = torch.from_numpy(x[rank]), torch.from_numpy(idx[rank])
    for q, cf in CASES:
        buckets, st = dispatch_local(xs, ids, ctx=ctx, ep_axis="ep",
                                     ep_size=R, n_experts=E,
                                     capacity_factor=cf, quantize=q)
        expert = buckets * (torch.arange(E // R, dtype=torch.float32)
                            + 1.0)[:, None, None]
        y = combine_local(expert, st, ctx=ctx, ep_axis="ep", ep_size=R,
                          quantize=q)
        flat_eid, rank2, keep2, dest_rank, rank1, keep1, _, _ = st
        for n, a in zip(("y", "buckets", "flat_eid", "rank2", "keep2",
                         "dest_rank", "rank1", "keep1"),
                        (y, buckets, flat_eid, rank2, keep2, dest_rank,
                         rank1, keep1)):
            out[f"{n}/{q}/{cf}"] = a.numpy()
    a2e, e2a = make_a2e_e2a(ctx, "ep", N_ATTN, R)
    staged = a2e(torch.from_numpy(payload[rank]))
    out["staged"] = staged.numpy()
    out["back"] = e2a(staged).numpy()
    out["sent"] = dict(mesh.comm.sent)
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    want = reference(tmp_path_factory.mktemp("ref"), REFERENCE)
    x, idx, payload = _inputs()
    got = spawn(_rank, R, x, idx, payload)
    return want, got


def _stacked(got, key):
    return np.stack([g[key] for g in got])


@pytest.mark.parametrize("q,cf", CASES)
def test_dispatch_routing_state_exact(both, q, cf):
    want, got = both
    for n in ("flat_eid", "rank2", "keep2", "dest_rank", "rank1", "keep1"):
        np.testing.assert_array_equal(
            _stacked(got, f"{n}/{q}/{cf}"),
            want[f"{n}/{q}/{cf}"].astype(_stacked(got, f"{n}/{q}/{cf}").dtype),
            err_msg=n)
    if cf == 1.0:           # the small capacity drops assignments
        assert not want[f"keep1/{q}/{cf}"].all()


@pytest.mark.parametrize("q,cf", CASES)
def test_dispatch_combine_payloads(both, q, cf):
    want, got = both
    b = _stacked(got, f"buckets/{q}/{cf}")
    y = _stacked(got, f"y/{q}/{cf}")
    np.testing.assert_allclose(b, want[f"buckets/{q}/{cf}"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(y, want[f"y/{q}/{cf}"], rtol=1e-5, atol=1e-5)
    if cf == 8.0:
        # the round trip through an expert that scales expert j by j + 1
        x, idx, _ = _inputs()
        scale = (idx % (E // R) + 1.0)[..., None]
        err = float(np.max(np.abs(y - x * scale)))
        assert err < (0.05 if q else 1e-5), err


def test_a2e_e2a_trampoline(both):
    want, got = both
    staged = _stacked(got, "staged")
    np.testing.assert_array_equal(staged, want["staged"])
    # every expert rank holds one bucket from each attention rank
    for r in range(R):
        vals = set(np.round(staged[r, :N_ATTN, 0, 0]).tolist())
        assert vals == {1.0, 2.0, 3.0, 4.0}, (r, vals)
    back = _stacked(got, "back")
    np.testing.assert_array_equal(back, want["back"])
    _, _, payload = _inputs()
    np.testing.assert_array_equal(back[:N_ATTN], payload[:N_ATTN])
    assert not back[N_ATTN:].any()
    # the identity ppermute moves nothing over the wire
    assert all(g["sent"].get("ppermute", 0) == 0 for g in got)
    assert all(g["sent"]["all_to_all"] > 0 for g in got)
