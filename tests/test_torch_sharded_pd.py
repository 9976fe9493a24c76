"""Prefix-KV seeding, disaggregated PD and the KV transfer between rank
groups on meshes over gloo ranks, in f32, against the reference.

* Prefix KV: DP groups with the pod-pooled directory on the smoke
  DeepSeek-V3 (a remote hit, a local hit, a chunk the cache covers
  whole) on (1,2) and on (2,2) under ``DECODE_RULES``: every count (hits
  by kind, pins, skipped chunks, the radix trees' hit and query blocks,
  the stored payloads' bytes) equal to the reference's on (1,2) (its
  batch-1 prefill raises on two data ranks), the logits within 1e-4,
  the same on every rank; a seeded prefill's logits bit-identical to a
  cold prefill split at the seed.
* ``DisaggregatedPD(ctx=)`` with ``kv_pool`` and ``mtp_k=1``, sessions
  sharing a system prompt served in waves (as
  ``tests/test_torch_pd_disagg.py``): TE choices, prefix hits, chunk
  counts, the streamed chunks and bytes of every DistFlow pair and the
  greedy tokens equal to the reference's on (1,2), on every rank.
* ``execute_transfer`` across a (pd 2, data 1, model 2) mesh: each
  decode rank's block of a prefill KV equals the matching shard of the
  reference's ``jax.device_put`` of the same KV onto ``NamedSharding``s
  of a second (1,2) sub-mesh, bit for bit, within one group too, and
  through ``DistFlowInstance(dst=)``; a stream of two chunks under a
  layout that keeps the sequence whole assembles the whole KV on each
  decode rank; ``plan_transfer`` counts the reference's bytes on both
  groups.

The (1,2) mesh runs on the 4 ranks of one world as replicas along a
leading axis ``r`` that no collective names.
"""
from __future__ import annotations

import types

import numpy as np
import pytest

from torch_mesh import Reference, rel_err

ARCH = "deepseek-v3-671b-smoke"
BS, MAX_LEN = 16, 128
#: a 64-byte system prompt (with BOS 65 tokens: four full KV blocks)
SYSTEM = "System: you are the SuperPod's helper; answer briefly, kindly..."
WAVES = [[SYSTEM + " User: what is MLA?"],
         [SYSTEM + " User: what is EPLB?", SYSTEM + " User: what is MTP?",
          "A long request with no shared prefix at all: it runs for more "
          "than a hundred bytes, so it prefills in several chunks."],
         [SYSTEM + " User: what is MLA? Assistant: latent attention. "
          "User: and then?"]]
PD_KW = dict(n_prefill_te=2, n_decode_te=1, dp_per_te=2, max_batch=2,
             max_len=MAX_LEN, chunk_tokens=32, kv_pool=True, mtp_k=1)
#: port mesh name → (mesh, EP axis, decode rules)
MESHES = {"1x2": ((1, 2), "model", False),
          "2x2/decode-rules": ((2, 2), ("data", "model"), True)}
#: the prompt whose prefill KV crosses between the rank groups
XFER_PROMPT = list(range(3, 43))


def config(get_config):
    """The smoke DeepSeek-V3 in f32, cut to one dense MLA layer and one
    MoE layer (and its MTP head): every kind of block, half the
    reference's compile time."""
    import dataclasses

    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, dtype="float32", num_layers=2,
                               prefix_layers=cfg.prefix_layers[:1])


def prefix_scenario(ns) -> dict:
    """Three DP groups on one pod directory (``ns``: one package's
    classes and a backend factory): dp0 caches a 100-token prompt; dp1
    seeds a longer one from dp0's blocks (remote hit); dp0 seeds a
    prompt sharing 3 blocks (local hit); dp1 runs a 120-token prompt in
    chunks, the first covered by its cache; a cold group prefills the
    remote-hit prompt split at the seed. One new token each: the groups
    clip no prompt."""
    pod = ns.Pod(block_size=BS)
    dps = [ns.DPGroup(i, ns.backend(), max_batch=2, max_len=MAX_LEN,
                      pod_directory=pod) for i in (0, 1)]
    cold = ns.DPGroup(9, ns.backend(), max_batch=2, max_len=MAX_LEN)
    out = {}

    def req(toks):
        return ns.Request(prompt_tokens=list(toks), max_new_tokens=1)
    try:
        toks = [int(t) for t in np.arange(2, 102) % 60]
        dps[0].run_prefill(req(toks))
        q = toks + [7] * 9
        r1 = req(q)
        _, out["remote_logits"] = dps[1].run_prefill(r1)
        r2 = req(toks[:50] + [3] * 20)
        _, out["local_logits"] = dps[0].run_prefill(r2)
        r3 = req(toks + [8] * 20)
        skipped = dps[1].run_prefill_chunk(ns.ChunkWork(r3, 0, 64)) is None
        pos = r3.prefill_pos
        _, out["chunk_logits"] = dps[1].run_prefill_chunk(
            ns.ChunkWork(r3, pos, r3.prompt_len - pos))
        n = r1.prefix_hit_tokens
        c, _ = cold.backend.prefill_chunk(None, q[:n], 0, len(q))
        _, out["cold_split_logits"] = cold.backend.prefill_chunk(
            c, q[n:], n, len(q))
        out["counts"] = dict(
            hits=[r.prefix_hit_tokens for r in (r1, r2, r3)],
            remote=[(d.n_remote_hits, d.remote_hit_blocks) for d in dps],
            pins=(pod.n_remote_acquires, pod.n_releases),
            skipped=(skipped, pos),
            trees=[(d.prefix_cache.hit_blocks, d.prefix_cache.query_blocks)
                   for d in dps],
            stored=[sum(ns.pytree_bytes(p) for node in
                        d.prefix_cache._nodes.values()
                        for p in node.payloads if p is not None)
                    for d in dps])
    finally:
        for d in (*dps, cold):
            d.close()
    return out


def pd_scenario(ns, pd, n_new: int = 5) -> dict:
    """Serve :data:`WAVES` on ``pd``, each wave to completion before the
    next: every request's TE choices, hits, chunks and tokens, the
    prefill groups' hits, each DistFlow pair's streamed chunks and
    bytes, and the pod directory's pins."""
    reqs = []
    try:
        for wave in WAVES:
            rs = [ns.Request(prompt=p, max_new_tokens=n_new,
                             ignore_eos=True) for p in wave]
            n0 = len(pd.finished)
            for r in rs:
                pd.submit(r)
            while len(pd.finished) < n0 + len(rs):
                pd.step()
            reqs += rs
        for te in pd.decode_tes:
            for d in te.dps:
                d.drain()
    finally:
        pd.close()
    return dict(
        reqs=[(r.prefill_te, r.decode_te, r.prefix_hit_tokens,
               r.n_prefill_chunks, list(r.output_tokens)) for r in reqs],
        remote=[(d.dp_id, d.n_remote_hits, d.remote_hit_blocks,
                 d.prefix_cache.hit_blocks)
                for te in pd.prefill_tes for d in te.dps],
        flows={k: (f.fabric, f.chunks_streamed, f.bytes_moved,
                   len(f.streams)) for k, f in sorted(pd.distflow.items())},
        pins=(pd.pod_dir.n_remote_acquires, pd.pod_dir.n_releases))


REFERENCE = """
import types
from jax.sharding import Mesh, NamedSharding
from repro.configs import get_config
from repro.core import DisaggregatedPD
from repro.launch.sharding import cache_pspecs
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
from repro.serving import dp_group, kv_cache, request, scheduler
from repro.serving.backend import JAXBackend
from repro.xccl.pd_transfer import execute_transfer, plan_transfer, pytree_bytes
from test_torch_sharded_pd import (MAX_LEN, PD_KW, XFER_PROMPT, config,
                                   pd_scenario, prefix_scenario)
cfg = config(get_config)
ctx1 = MeshCtx(mesh=auto_mesh((1, 1)), batch_axes=("data",), remat="none")
m1 = build_model(cfg, ctx1)
params = jax.jit(m1.init)(jax.random.PRNGKey(0))
for n, a in jax.tree_util.tree_flatten_with_path(params)[0]:
    put("param/" + ".".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in n), a)
kv, _ = JAXBackend(m1, params, max_len=MAX_LEN).prefill(XFER_PROMPT)
kv = jax.tree.map(np.asarray, kv)
names = {}
for n, a in jax.tree_util.tree_flatten_with_path(kv)[0]:
    name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in n)
    put("kv/" + name, a)
publish("params")

# the transfer: the KV on a (1,2) prefill sub-mesh, put onto the
# NamedShardings of the decode sub-mesh of devices 2 and 3
devs = np.array(jax.devices())
from jax.sharding import AxisType
sub = [Mesh(devs[i:i + 2].reshape(1, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2) for i in (0, 2)]
ctxs = [MeshCtx(mesh=m, batch_axes=("data",)) for m in sub]
src = jax.device_put(kv, jax.tree.map(lambda s: NamedSharding(sub[0], s),
                                      cache_pspecs(kv, ctxs[0])))
moved = execute_transfer(src, jax.tree.map(
    lambda s: NamedSharding(sub[1], s), cache_pspecs(kv, ctxs[1])))
for n, a in jax.tree_util.tree_flatten_with_path(moved)[0]:
    name = ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in n)
    for sh in a.addressable_shards:
        put(f"xfer/{name}/{sh.device.id - 2}", sh.data)
put("xfer/bytes", plan_transfer(kv).total_bytes)

ctx = MeshCtx(mesh=auto_mesh((1, 2)), batch_axes=("data",), remat="none")
model = build_model(cfg, ctx)
ns = types.SimpleNamespace(
    backend=lambda: JAXBackend(model, params, max_len=MAX_LEN),
    DPGroup=dp_group.DPGroup, Pod=kv_cache.PodKVDirectory,
    Request=request.Request, ChunkWork=scheduler.ChunkWork,
    pytree_bytes=pytree_bytes)
out = prefix_scenario(ns)
for k in ("remote_logits", "local_logits", "chunk_logits",
          "cold_split_logits"):
    put("prefix/" + k, out[k])
put("prefix/counts", np.frombuffer(repr(out["counts"]).encode(), np.uint8))
pd = pd_scenario(ns, DisaggregatedPD(cfg, params, ctx=ctx, **PD_KW))
put("pd", np.frombuffer(repr(pd).encode(), np.uint8))
"""


def _port_mesh(shape):
    if shape[0] * shape[1] == 4:
        return shape, ("data", "model")
    return (4 // (shape[0] * shape[1]),) + shape, ("r", "data", "model")


def _ns(model, params):
    from repro_torch.serving import dp_group, kv_cache, request, scheduler
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.xccl.pd_transfer import pytree_bytes

    return types.SimpleNamespace(
        backend=lambda: TorchBackend(model, params, max_len=MAX_LEN,
                                     device="cpu"),
        DPGroup=dp_group.DPGroup, Pod=kv_cache.PodKVDirectory,
        Request=request.Request, ChunkWork=scheduler.ChunkWork,
        pytree_bytes=pytree_bytes)


def _transfer(rank, world, init, kv_flat, cfg) -> dict:
    """The reference's prefill KV (global, numpy) across the ``pd`` axis
    of a (2,1,2) mesh and within a group, and through DistFlow."""
    import torch

    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import PD_AXES, init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import flatten
    from repro_torch.serving.distflow import DistFlowInstance
    from repro_torch.xccl.pd_transfer import (KVLayout, execute_transfer,
                                              plan_transfer, slice_kv_chunk)

    mesh = init_mesh((2, 1, 2), "gloo", "cpu", axis_names=PD_AXES,
                     rank=rank, world_size=world, init_method=init)
    ctx = MeshCtx(mesh=mesh, batch_axes=("data",))
    # the prefill's cache is its bucket's length: the prefix leaves'
    # dim 1
    L = next(a.shape[1] for k, a in kv_flat.items()
             if k.startswith("prefix."))
    meta = Model(cfg).cache_spec(1, L)
    group = mesh.comm.coords["pd"]

    def tree(keys, t):
        if group == 1:            # the decode group: global shapes only
            return t
        return torch.from_numpy(kv_flat[".".join(map(str, keys))])
    kv = shd.map_with_paths(meta, tree)
    specs = shd.cache_pspecs(meta, ctx)
    out = {"plan": plan_transfer(kv).total_bytes}
    across = KVLayout(ctx, specs, axis="pd", device="cpu")
    moved = execute_transfer(kv, across)
    out["across"] = None if moved is None else {
        p: t.numpy() for p, t in flatten(moved).items()}
    flow = DistFlowInstance("p0-d0", dst=across)
    task = flow.register(7, kv)
    assert flow.trigger(task.task_id, lambda: True)
    out["flow"] = (task.plan.total_bytes, None if task.result is None else {
        p: t.numpy() for p, t in flatten(task.result).items()})
    try:
        flow.open_stream(8)
        out["stream_refused"] = False
    except ValueError:
        out["stream_refused"] = True
    # a stream under a layout that keeps every leaf whole: two chunks
    whole = DistFlowInstance("p0-d1", dst=KVLayout(ctx, axis="pd",
                                                   device="cpu"))
    whole.open_stream(9)
    for lo, hi in ((0, 16), (16, L)):
        whole.stream_chunk(9, slice_kv_chunk(kv, lo, hi), last=hi == L)
    streamed = whole.pop_stream(9)
    out["stream"] = (whole.bytes_moved, None if streamed is None else {
        p: t.numpy() for p, t in flatten(streamed).items()})
    out["sent"] = dict(mesh.comm.sent)
    if group == 0:            # within the prefill group: cut, no wire
        within = execute_transfer(kv, KVLayout(ctx, specs))
        out["within"] = {p: t.numpy() for p, t in flatten(within).items()}
    out["model"] = mesh.comm.coords["model"]
    return out


def _rank(rank, world, init, flat_params, kv_flat):
    from repro_torch.configs import get_config
    from repro_torch.core import DisaggregatedPD
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params

    cfg = config(get_config)
    out = {"transfer": _transfer(rank, world, init, kv_flat, cfg)}
    meshes = {}
    for mname, (shape, ep, drules) in MESHES.items():
        pshape, names = _port_mesh(shape)
        if pshape not in meshes:
            meshes[pshape] = init_mesh(pshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
        ctx = MeshCtx(mesh=meshes[pshape], batch_axes=("data",),
                      remat="none", ep_axis=ep)
        rules = shd.DECODE_RULES if drules else None
        params = from_jax_params(flat_params, cfg, "cpu", ctx=ctx,
                                 rules=rules)
        model = Model(cfg, ctx=ctx, rules=rules)
        ns = _ns(model, params)
        out[f"prefix/{mname}"] = prefix_scenario(ns)
        out[f"pd/{mname}"] = pd_scenario(ns, DisaggregatedPD(
            cfg, params, device="cpu", ctx=ctx, rules=rules, **PD_KW))
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    ref = Reference(tmp_path_factory.mktemp("ref"), REFERENCE, timeout=900)
    part = ref.part("params")
    flat = {k[6:]: v for k, v in part.items() if k.startswith("param/")}
    kv = {k[3:]: v for k, v in part.items() if k.startswith("kv/")}
    got = spawn(_rank, 4, flat, kv, threads=2)
    return ref.result(), got, kv


def _text(a) -> str:
    return bytes(a).decode()


@pytest.mark.parametrize("mesh", list(MESHES))
def test_prefix_counts_and_logits_match_reference_on_mesh(both, mesh):
    want, got, _ = both
    counts = _text(want["prefix/counts"])
    for g in got:
        mine = g[f"prefix/{mesh}"]
        assert repr(mine["counts"]) == counts
        for k in ("remote_logits", "local_logits", "chunk_logits"):
            assert rel_err(mine[k], want[f"prefix/{k}"]) <= 1e-4, k
            np.testing.assert_array_equal(mine[k],
                                          got[0][f"prefix/{mesh}"][k])
        # a seeded prefill is the cold prefill split at the seed, bitwise
        np.testing.assert_array_equal(mine["remote_logits"],
                                      mine["cold_split_logits"])
    c = got[0][f"prefix/{mesh}"]["counts"]
    assert c["hits"][0] == 96 and c["remote"][1][0] == 1
    assert c["skipped"] == (True, 96) and min(c["stored"]) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_pd_disagg_on_mesh_matches_reference(both, mesh):
    want, got, _ = both
    for g in got:
        assert repr(g[f"pd/{mesh}"]) == _text(want["pd"])
    pd = got[0][f"pd/{mesh}"]
    assert all(len(r[4]) == 5 for r in pd["reqs"])
    assert any(r[2] > 0 for r in pd["reqs"])          # a prefix hit


def test_transfer_across_the_pd_axis_is_the_reference_shard(both):
    want, got, kv = both
    plans = {g["transfer"]["plan"] for g in got} \
        | {g["transfer"]["flow"][0] for g in got} \
        | {g["transfer"]["stream"][0] for g in got}
    assert plans == {int(want["xfer/bytes"])}
    names = sorted(kv)
    assert names
    for r, g in enumerate(got):
        t = g["transfer"]
        j = t["model"]
        if r < 2:                       # the prefill group keeps no block
            assert t["across"] is None and t["flow"][1] is None
            assert t["stream"][1] is None
            assert t["sent"]["ppermute"] > 0
            for n in names:
                np.testing.assert_array_equal(t["within"][n],
                                              want[f"xfer/{n}/{j}"])
            continue
        assert "ppermute" not in t["sent"]
        for n in names:
            np.testing.assert_array_equal(t["across"][n],
                                          want[f"xfer/{n}/{j}"])
            np.testing.assert_array_equal(t["flow"][1][n],
                                          want[f"xfer/{n}/{j}"])
            np.testing.assert_array_equal(t["stream"][1][n], kv[n])
        assert t["stream_refused"]
    # the decode layout cut the sequence: each rank got half of it
    seq = [want[f"xfer/{n}/0"].shape for n in names]
    assert any(s != kv[n].shape for s, n in zip(seq, names))
