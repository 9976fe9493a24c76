"""``moe_apply`` on meshes (2,4), (1,4) and (4,1) over gloo ranks, against
the reference's ``moe_apply`` on the same mesh: the decode gather
(experts sharded over the EP axis, or replicated on (4,1)), budget-0
placement bit-identical to no placement, a replica-carrying EPLB table
(``tests/test_multidevice.py``'s case, slots block-sharded over the EP
ranks), EP over both axes (tokens gathered over the data axis and
sliced back), and the prefill all-to-all dispatch. ``expert_counts``
exact; ``y`` within 1e-5 in f32.

The 4-rank meshes run on the 8 ranks of one world as two replicas: a
leading axis ``r`` that no collective names.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import reference

E, D, F_E = 8, 16, 16
#: case → (reference mesh shape, batch axes, EP axis, mode, placement)
CASES = {
    "2x4/decode": ((2, 4), "model", "decode", None),
    "2x4/decode/budget0": ((2, 4), "model", "decode", "identity"),
    "2x4/decode/replicas": ((2, 4), "model", "decode", "replicas"),
    "2x4/decode/ep-both": ((2, 4), ("data", "model"), "decode", None),
    "2x4/decode/ep-both/replicas": ((2, 4), ("data", "model"), "decode",
                                    "replicas"),
    "2x4/prefill": ((2, 4), "model", "prefill", None),
    "1x4/decode": ((1, 4), "model", "decode", None),
    "1x4/decode/replicas": ((1, 4), "model", "decode", "replicas"),
    "1x4/prefill": ((1, 4), "model", "prefill", None),
    "4x1/decode": ((4, 1), "model", "decode", None),
    "4x1/decode/replicas": ((4, 1), "model", "decode", "replicas"),
    "4x1/prefill": ((4, 1), "model", "prefill", None),
}


def _inputs():
    rng = np.random.default_rng(1)
    xd = rng.standard_normal((8, 1, D)).astype(np.float32)
    xp = rng.standard_normal((4, 8, D)).astype(np.float32)
    counts = rng.integers(0, 20, (E, 4))
    counts[1] += 300
    return xd, xp, counts


REFERENCE = """
from repro.configs.base import ModelConfig, MoEConfig
from repro.models.ffn import moe_apply, moe_init
from repro.models.mesh_ctx import MeshCtx
from repro.serving.eplb import (build_expert_map, build_placement_table,
                                identity_placement)
from test_torch_sharded_moe import CASES, E, D, F_E, _inputs, config_kw
cfg = ModelConfig(**config_kw(MoEConfig))
params = moe_init(jax.random.PRNGKey(0), cfg, jnp.float32)
for n, a in jax.tree_util.tree_flatten_with_path(params)[0]:
    put("param/" + ".".join(k.key for k in n), a)
xd, xp, counts = _inputs()
tables = {"identity": identity_placement(1, E),
          "replicas": build_placement_table(
              [build_expert_map(counts, E, 3, n_npus=4)], E)}
for k, t in tables.items():
    for i, a in enumerate(t.layer(0)):
        put(f"table/{k}/{i}", a)
for name, (shape, ep, mode, pl) in CASES.items():
    ctx = MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",),
                  remat="none", ep_axis=ep)
    x = jnp.asarray(xd if mode == "decode" else xp)
    p = None if pl is None else tables[pl].layer(0)
    y, aux = jax.jit(lambda pr, x, p: moe_apply(
        pr, x, cfg=cfg, ctx=ctx, mode=mode, placement=p))(params, x, p)
    put(name + "/y", y)
    put(name + "/counts", aux["expert_counts"])
    put(name + "/lb", aux["moe_lb_loss"])
"""


def config_kw(moe_cls):
    """The tiny MoE layer of ``tests/test_multidevice.py`` with a shared
    expert; capacity factor 8, so no bucket overflows."""
    return dict(name="tiny-moe", d_model=D, d_ff=32, num_layers=2,
                num_heads=2, vocab_size=64,
                moe=moe_cls(num_experts=E, top_k=2, expert_d_ff=F_E,
                            num_shared_experts=1, capacity_factor=8.0))


def _mesh_for(shape):
    """The case's mesh on 8 ranks: (2,4) itself, a 4-rank mesh as two
    replicas along a leading axis ``r``."""
    if shape[0] * shape[1] == 8:
        return shape, ("data", "model")
    return (2,) + shape, ("r", "data", "model")


def _rank(rank, world, init, params, xd, xp, tables):
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import ffn
    from repro_torch.models.mesh_ctx import MeshCtx

    cfg = ModelConfig(**config_kw(MoEConfig))
    tp = {k: torch.from_numpy(v) for k, v in params.items()
          if "." not in k}
    tp["shared"] = {k.split(".")[1]: torch.from_numpy(v)
                    for k, v in params.items() if k.startswith("shared.")}
    out, meshes = {}, {}
    for name, (shape, ep, mode, pl) in CASES.items():
        mshape, names = _mesh_for(shape)
        if mshape not in meshes:
            meshes[mshape] = init_mesh(mshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
        ctx = MeshCtx(mesh=meshes[mshape], batch_axes=("data",),
                      remat="none", ep_axis=ep)
        x = torch.from_numpy(xd if mode == "decode" else xp)
        xl = ctx.take_block(x, 0, "data")
        p = (None if pl is None else
             tuple(torch.from_numpy(a) for a in tables[pl]))
        y, aux = ffn.moe_apply(tp, xl, cfg=cfg, mode=mode, placement=p,
                               ctx=ctx)
        # the rank's rows, gathered back over the data axis
        out[name + "/y"] = ctx.all_gather(y, "data", dim=0).numpy()
        out[name + "/counts"] = aux["expert_counts"].numpy()
        out[name + "/lb"] = aux["moe_lb_loss"].numpy()
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    want = reference(tmp_path_factory.mktemp("ref"), REFERENCE)
    params = {k[len("param/"):]: v for k, v in want.items()
              if k.startswith("param/")}
    tables = {k: [want[f"table/{k}/{i}"] for i in range(3)]
              for k in ("identity", "replicas")}
    xd, xp, _ = _inputs()
    return want, spawn(_rank, 8, params, xd, xp, tables)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_reference_on_mesh(both, name):
    want, got = both
    for g in got:           # every rank, every replica: the same result
        np.testing.assert_array_equal(g[name + "/counts"],
                                      want[name + "/counts"])
        np.testing.assert_allclose(g[name + "/y"], want[name + "/y"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g[name + "/lb"], want[name + "/lb"],
                                   rtol=1e-5, atol=1e-7)
        np.testing.assert_array_equal(g[name + "/y"], got[0][name + "/y"])


@pytest.mark.parametrize("prefix", ["2x4", "1x4"])
def test_budget0_and_replicas(both, prefix):
    want, got = both
    for g in got:
        if prefix == "2x4":
            # budget-0 placement is bit-identical to logical routing
            np.testing.assert_array_equal(g["2x4/decode/budget0/y"],
                                          g["2x4/decode/y"])
        # a replica table computes each slot with its owner's weights
        np.testing.assert_allclose(g[prefix + "/decode/replicas/y"],
                                   g[prefix + "/decode/y"], rtol=1e-5,
                                   atol=1e-5)
    tab = want["table/replicas/1"]
    assert int(np.max(tab)) > 1
