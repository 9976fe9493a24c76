"""RecurrentGemma-2B (RG-LRU and ring-window attention) and Mamba2-130M
(SSD) served on meshes over gloo ranks, against the reference on the
same Auto-axis meshes (``tests/torch_mesh_serving.py``).

* ``Model.prefill`` and three ``decode_step``s on (2,1), (1,2) and
  (2,2), with and without ``shard_kv_seq``, in float32: logits within
  1e-4 relative of the reference's, identical on every rank; in
  bfloat16 on (2,2) within 0.08 of the reference's float32 logits.
* ``FlowServeEngine(ctx=)`` on (2,1), (1,2) and (2,2): the reference's
  greedy tokens on every rank (one prompt runs past the ring window).
* A live mesh of one rank: bit for bit the one-device path, the model
  and the engine.
* A TP cut through an RG-LRU gate block (5 heads: one block of every
  channel) on (1,2): the one-device path's logits within 1e-5.
* Every registered configuration runs its mesh code path (a live 1×1
  mesh in this process): prefill, decode and the training loss equal to
  the one-device path's bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_mesh_serving as tms
from torch_mesh import rel_err

CONFIGS = {
    # one superblock (RG-LRU, RG-LRU, ring-window attention) and a
    # 2-layer RG-LRU tail: 4 gate blocks of 64 channels, 2 per TP rank
    "recurrentgemma": ("recurrentgemma-2b-smoke", {"num_layers": 5}),
    "mamba2": ("mamba2-130m-smoke", {}),
}
#: 5 heads: RG-LRU's gates are one block of all 256 channels, so a TP
#: rank's 128 channels cut it and the layer gathers its weights; the
#: ring-window attention pads its heads for TP 2
HELD_TO_ONE_DEVICE = {
    "recurrentgemma-5h": ("recurrentgemma-2b-smoke",
                          {"num_layers": 5, "num_heads": 5}),
}
CASES = [(n, m) for n in CONFIGS for m in tms.MESHES]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    return tms.run(tmp_path_factory, __name__, CONFIGS)


def _steps():
    return ["prefill"] + [f"decode{i}" for i in range(tms.STEPS)]


@pytest.mark.parametrize("name,mesh", CASES)
def test_logits_match_reference_on_mesh(both, name, mesh):
    want, got = both
    for k in _steps():
        key = f"{name}/{mesh}/{k}"
        err = rel_err(got[0][key], want[key])
        assert err < 1e-4, (key, err)
        for g in got[1:]:
            np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_bf16_logits_within_bar(both, name):
    want, got = both
    for k in _steps():
        key = f"{name}/bf16/{k}"
        err = rel_err(got[0][key], want[f"{name}/{tms.BF16_MESH}/{k}"])
        assert err < 0.08, (key, err)
        for g in got[1:]:
            np.testing.assert_array_equal(g[key], got[0][key])


@pytest.mark.parametrize("mesh", tms.ENGINE_MESHES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_tokens_match_reference_on_every_rank(both, name, mesh):
    want, got = both
    ref = want[f"{name}/engine"].tolist()
    assert all(len(t) == tms.NEW for t in ref)
    for g in got:
        assert g[f"{name}/engine/{mesh}"] == ref


@pytest.mark.parametrize("name", list(CONFIGS))
def test_world_size_one_is_the_one_device_path(both, name):
    _, got = both
    for g in got:
        assert g[f"{name}/world1"] is True
        assert g[f"{name}/world1/engine"] is True
        assert "psum" in g[f"{name}/sent"] or name == "mamba2"
        assert "all_gather" in g[f"{name}/sent"]


def test_cut_through_a_gate_block_is_the_one_device_path(both):
    _, got = both
    for g in got:
        errs = g["recurrentgemma-5h/held"]
        assert max(errs.values()) < 1e-5, errs


def _registered():
    from repro_torch.configs.registry import list_archs

    return [a + "-smoke" for a in list_archs()]


@pytest.fixture
def one_thread():
    # smoke shapes: one thread is enough, and under a loaded xdist run
    # eight would only contend with the other workers
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", _registered())
def test_every_registered_config_runs_its_mesh_path(arch, one_thread):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.mesh_ctx import Comm, MeshCtx, MeshShape
    from repro_torch.models.transformer import Model, seeded_memory

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    live = MeshShape((1, 1), ("data", "model"),
                     comm=Comm({"data": 1, "model": 1}, 0, "gloo"))
    m1 = Model(cfg, ctx=MeshCtx(mesh=live, remat="none"))
    m0 = Model(cfg)
    assert m1.sharded and not m0.sharded
    params = m0.init(0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    mem = (seeded_memory(cfg, gen, "cpu") if m0.has_cross else None)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), generator=gen)
    out = []
    for m in (m1, m0):
        lp, cache = m.prefill(params, toks, memory=None if mem is None
                              else mem.expand(2, -1, -1))
        full = m.init_cache(2, 16, device="cpu")
        for keys, t in tms._leaves(full).items():
            part = tms._leaves(cache)[keys]
            t[tuple(slice(0, n) for n in part.shape)].copy_(part)
        ld, _ = m.decode_step(params, m.place_cache(full, 2), toks[:, :1],
                              torch.full((2,), 8, dtype=torch.int32))
        out.append((lp, ld))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    # training runs the mesh path too, its loss the one device's
    losses = [m.forward_train(params, toks, toks, memory=None if mem is None
                              else mem.expand(2, -1, -1))[0]
              for m in (m1, m0)]
    assert torch.equal(losses[0], losses[1])
