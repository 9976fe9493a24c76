"""MoE layer parity: the port's ``moe_apply`` against JAX's on the smoke
DeepSeek-V3 MoE weights (float32, carried across by the weight bridge),
within 2e-4 — decode and prefill, micro-batches, EPLB placement tables
and a router with ties."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.serving import eplb as jeplb
from repro_torch.models import ffn as tffn
from repro_torch.serving import eplb as teplb
from torch_parity import auto_ctx, reference, to_np

TOL = dict(rtol=2e-4, atol=2e-4)


def _layer():
    jcfg, _, params, tcfg, tparams = reference("float32")
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"]["pos0"]["ffn"])
    tp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"]["pos0"]["ffn"].items()}
    return jcfg, tcfg, jp, tp


def _x(mode, d, seed=0):
    shape = (4, 1, d) if mode == "decode" else (2, 8, d)
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tables(maps, E):
    jt = jeplb.build_placement_table(maps, E)
    tt = teplb.build_placement_table(maps and [
        None if m is None else teplb.ExpertMap(m.n_logical, m.replicas)
        for m in maps], E)
    jl = tuple(jnp.asarray(a) for a in jt.layer(0))
    tl = tuple(torch.as_tensor(np.asarray(a)) for a in tt.layer(0))
    return jl, tl


def _run(jcfg, tcfg, jp, tp, x, mode, mb=1, placement=(None, None)):
    ctx = auto_ctx(decode_microbatches=mb)
    jy, jaux = jax.jit(lambda p, x, pl: jffn.moe_apply(
        p, x, cfg=jcfg, ctx=ctx, mode=mode, placement=pl))(
            jp, jnp.asarray(x), placement[0])
    ty, taux = tffn.moe_apply(tp, torch.from_numpy(x), cfg=tcfg, mode=mode,
                              placement=placement[1], microbatches=mb)
    return (jy, jaux), (ty, taux)


def _assert_close(j, t):
    (jy, jaux), (ty, taux) = j, t
    np.testing.assert_allclose(to_np(ty), to_np(jy), **TOL)
    np.testing.assert_array_equal(to_np(taux["expert_counts"]),
                                  to_np(jaux["expert_counts"]))
    for k in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(to_np(taux[k]), to_np(jaux[k]), **TOL)


@pytest.mark.parametrize("mode,mb", [("decode", 1), ("decode", 2),
                                     ("prefill", 1), ("chunk", 1)])
def test_moe_apply_matches_jax(mode, mb):
    jcfg, tcfg, jp, tp = _layer()
    x = _x(mode, jcfg.d_model)
    _assert_close(*_run(jcfg, tcfg, jp, tp, x, mode, mb))


@pytest.mark.parametrize("mb", [1, 2])
def test_one_replica_table_matches_jax(mb):
    jcfg, tcfg, jp, tp = _layer()
    E = jcfg.moe.num_experts
    emap = jeplb.ExpertMap(E, {1: [1, E]})
    pl = _tables([emap], E)
    x = _x("decode", jcfg.d_model, seed=1)
    _assert_close(*_run(jcfg, tcfg, jp, tp, x, "decode", mb, pl))


def test_budget0_table_bit_identical_to_logical_routing():
    jcfg, tcfg, jp, tp = _layer()
    E = jcfg.moe.num_experts
    _, tl = _tables([None], E)
    x = torch.from_numpy(_x("decode", jcfg.d_model, seed=2))
    plain, _ = tffn.moe_apply(tp, x, cfg=tcfg, mode="decode")
    placed, _ = tffn.moe_apply(tp, x, cfg=tcfg, mode="decode", placement=tl)
    assert torch.equal(plain, placed)


def test_router_ties_pick_the_lower_index_like_jax():
    jcfg, tcfg, jp, tp = _layer()
    d, E, k = jcfg.d_model, jcfg.moe.num_experts, jcfg.moe.top_k
    router = np.zeros((d, E), np.float32)
    router[:, 1] = router[:, 3] = 0.05            # experts 1 and 3 tie
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    x = np.abs(_x("decode", d, seed=3))
    jidx = jffn._route(jnp.asarray(x[:, 0]), jnp.asarray(router), k)[0]
    tidx = tffn._route(torch.from_numpy(x[:, 0]), torch.from_numpy(router),
                       k)[0]
    np.testing.assert_array_equal(to_np(tidx), to_np(jidx))
    assert to_np(tidx)[:, 0].tolist() == [1] * 4
    zero = np.zeros((d, E), np.float32)          # all experts tie
    jidx = jffn._route(jnp.asarray(x[:, 0]), jnp.asarray(zero), k)[0]
    tidx = tffn._route(torch.from_numpy(x[:, 0]), torch.from_numpy(zero),
                       k)[0]
    np.testing.assert_array_equal(to_np(tidx), to_np(jidx))
    _assert_close(*_run(jcfg, tcfg, jp, tp, x, "decode"))


def test_capacity_drops_match_jax():
    """A tight capacity factor drops assignments: the dropped set (and so
    the output) follows the reference's ``max(int(N/E*cf), 4)``."""
    jcfg, tcfg, jp, tp = _layer()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.55))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.55))
    x = _x("prefill", jcfg.d_model, seed=4)
    _assert_close(*_run(jcfg, tcfg, jp, tp, x, "prefill"))
    from repro_torch.kernels.route_pack.ops import fused_route_pack
    T, k, E = 16, tcfg.moe.top_k, tcfg.moe.num_experts
    idx = tffn._route(torch.from_numpy(x.reshape(T, -1)), tp["router"], k)[0]
    cap = max(int(T * k / E * 0.55), 4)
    keep = fused_route_pack(torch.from_numpy(x.reshape(T, -1)),
                            idx.reshape(-1).to(torch.int32), k=k, n_dest=E,
                            capacity=cap).keep
    assert not keep.all()
