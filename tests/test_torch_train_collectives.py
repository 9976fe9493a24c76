"""The collectives' backward (``models/mesh_ctx.py``) against the
reference's ``jax.vjp`` of the same collective inside ``shard_map`` on
the same Auto-axis (2,2) mesh.

Each of 4 gloo ranks holds its block of a seeded input and of a seeded
cotangent (every rank a different one: cotangents are partials); its
output and its input's gradient must equal the reference's device
block within 1e-6 relative (float32; 1e-2 for the bfloat16 all-gather,
whose backward sums in float32). Cases: ``psum`` and ``pmean`` over one
axis and both, the tiled ``all_gather`` (dims 0 and 1, one axis and
both), the tiled ``all_to_all``, ``ppermute`` (a swap and a cyclic
shift over both axes), a log-sum-exp across ranks through ``pmax``
(no gradient) and ``psum``, and a gather followed by this rank's block.
Under ``torch.no_grad()`` the outputs are the same bit for bit and no
backward bytes are counted; with grad each backward counts its bytes
under its own key.
"""
from __future__ import annotations

import numpy as np
import pytest

from torch_mesh import reference, rel_err

ROWS, COLS = 8, 4
#: case → its body, written once for both packages: ``C`` is
#: ``jax.lax`` (with the helpers below) or the port's ``MeshCtx``
CASES = {
    "psum_model": "C.psum(x, 'model')",
    "psum_all": "C.psum(x, ('data', 'model'))",
    "pmean_data": "C.pmean(x, 'data')",
    "all_gather_model_0": "C.all_gather(x, 'model', 0)",
    "all_gather_model_1": "C.all_gather(x, 'model', 1)",
    "all_gather_all_0": "C.all_gather(x, ('data', 'model'), 0)",
    "all_to_all_model": "C.all_to_all(x, 'model')",
    "all_to_all_all": "C.all_to_all(x, ('data', 'model'))",
    "ppermute_swap": "C.ppermute(x, 'model', [(0, 1), (1, 0)])",
    "ppermute_shift": "C.ppermute(x, ('data', 'model'), "
                      "[(i, (i + 1) % 4) for i in range(4)])",
    "lse_model": "C.lse(x, 'model')",
    "gather_block": "C.gather_block(x, 'model')",
}
BF16 = "all_gather_bf16"


def data():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4 * ROWS, COLS)).astype(np.float32)
    cts = {name: rng.standard_normal((16 * ROWS, 4 * COLS)).astype(
        np.float32) for name in list(CASES) + [BF16]}
    return x, cts


REFERENCE = """
from test_torch_train_collectives import BF16, CASES, ROWS, data
mesh = auto_mesh((2, 2))


class C:
    @staticmethod
    def psum(x, a):
        return jax.lax.psum(x, a)

    @staticmethod
    def pmean(x, a):
        return jax.lax.pmean(x, a)

    @staticmethod
    def all_gather(x, a, dim):
        return jax.lax.all_gather(x, a, axis=dim, tiled=True)

    @staticmethod
    def all_to_all(x, a):
        return jax.lax.all_to_all(x, a, 0, 0, tiled=True)

    @staticmethod
    def ppermute(x, a, perm):
        return jax.lax.ppermute(x, a, perm)

    @staticmethod
    def lse(x, a):
        m = jax.lax.pmax(jax.lax.stop_gradient(x.max(-1)), a)
        return (jnp.log(jax.lax.psum(jnp.exp(x - m[:, None]).sum(-1), a))
                + m)[:, None]

    @staticmethod
    def gather_block(x, a):
        g = jax.lax.all_gather(x, a, axis=0, tiled=True)
        i = jax.lax.axis_index(a)
        return jax.lax.dynamic_slice_in_dim(g, i * ROWS, ROWS) * 2 + g[:ROWS]


x, cts = data()
spec = P(("data", "model"))
for name, body in list(CASES.items()) + [(BF16, CASES["all_gather_model_0"])]:
    f = shard_map(lambda x, body=body: eval(body), mesh=mesh, in_specs=spec,
                  out_specs=spec, check_rep=False)
    xin = x
    if name == BF16:
        xin = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    y, vjp = jax.vjp(f, jnp.asarray(xin))
    ct = cts[name][:y.shape[0], :y.shape[1]]
    put(name + "/y", y)
    put(name + "/g", vjp(jnp.asarray(ct))[0])
"""


def _rank(rank, world, init):
    import torch

    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx

    mesh = init_mesh((2, 2), "gloo", "cpu", rank=rank, world_size=world,
                     init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))

    class C:
        psum, pmean = ctx.psum, ctx.pmean
        all_gather, all_to_all, ppermute = (ctx.all_gather, ctx.all_to_all,
                                            ctx.ppermute)

        @staticmethod
        def lse(x, a):
            m = ctx.pmax(x.amax(-1), a)
            return (torch.log(ctx.psum(torch.exp(x - m[:, None]).sum(-1),
                                       a)) + m)[:, None]

        @staticmethod
        def gather_block(x, a):
            g = ctx.all_gather(x, a, 0)
            return ctx.take_block(g, 0, a) * 2 + g[:ROWS]

    x, cts = data()
    mine = torch.from_numpy(x[rank * ROWS:(rank + 1) * ROWS])
    out = {}
    for name, body in list(CASES.items()) + [
            (BF16, CASES["all_gather_model_0"])]:
        xin = mine.to(torch.bfloat16) if name == BF16 else mine.clone()
        with torch.no_grad():
            mesh.comm.sent.clear()
            y0 = eval(body, {"C": C, "x": xin})
            plain = dict(mesh.comm.sent)
        mesh.comm.sent.clear()
        xg = xin.clone().requires_grad_()
        y = eval(body, {"C": C, "x": xg})
        ct = cts[name][rank * y.shape[0]:(rank + 1) * y.shape[0],
                       :y.shape[1]]
        g, = torch.autograd.grad(y, xg, torch.from_numpy(ct).to(y.dtype))
        out[name] = {"y": y.detach().float().numpy(),
                     "g": g.float().numpy(),
                     "same": torch.equal(y0, y.detach()),
                     "plain": plain, "sent": dict(mesh.comm.sent)}
    return out


@pytest.fixture(scope="module")
def both(tmp_path):
    from repro_torch.launch.mesh import spawn

    return reference(tmp_path, REFERENCE), spawn(_rank, 4)


@pytest.fixture(scope="module")
def tmp_path(tmp_path_factory):
    return tmp_path_factory.mktemp("ref")


@pytest.mark.parametrize("name", list(CASES) + [BF16])
def test_backward_matches_reference_vjp(both, name):
    want, got = both
    bar = 1e-2 if name == BF16 else 1e-6
    n = got[0][name]["y"].shape[0]
    for r, g in enumerate(got):
        y_ref = want[name + "/y"][r * n:(r + 1) * n]
        assert rel_err(g[name]["y"], y_ref) < bar, (name, r)
        g_ref = want[name + "/g"][r * ROWS:(r + 1) * ROWS]
        assert rel_err(g[name]["g"], g_ref) < bar, (name, r)


@pytest.mark.parametrize("name", list(CASES) + [BF16])
def test_no_grad_forward_is_unchanged_and_backward_bytes_have_own_keys(
        both, name):
    _, got = both
    for g in got:
        case = g[name]
        assert case["same"] is True
        assert case["plain"]
        assert not any(k.endswith(".bwd") for k in case["plain"])
        fwd = {k: v for k, v in case["sent"].items()
               if not k.endswith(".bwd")}
        assert fwd == case["plain"], name
        # every collective with a gradient moved its backward's bytes
        if "lse" not in name:
            assert any(k.endswith(".bwd") for k in case["sent"]), name
