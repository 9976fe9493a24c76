"""MTP speculative decoding (§4.6) on meshes over gloo ranks, in f32,
against the reference on the same mesh.

* ``TorchBackend.decode_sample_mtp`` at k 1 and 2 on (2,2), (1,2) and
  (2,2) under ``DECODE_RULES`` with EP over both axes: token blocks and
  accepted counts equal to the reference's ``JAXBackend(mtp_k=)`` on
  the same mesh (the EP-over-both-axes case held to the reference's
  (2,2) run: its EP axes change its program, not its function), the
  carried hidden and both caches after the fill pass
  (gathered from the ranks' blocks) within 1e-4 relative, the same on
  every rank. An oracle head (its logits peaked at the plain greedy
  chain's next token, wrong on purpose at two positions, as
  ``tests/test_torch_mtp_backend.py``) forces acceptance, full and in
  the middle of a block; it reads the global positions and adds to the
  all-gathered logits, so every rank peaks alike. Both sides prefill on
  one device of their package (the reference's batch-1 prefill raises
  on two data ranks).
* Stochastic slots (temperature 0.7), on (2,2)/``DECODE_RULES``: every
  rank draws the same blocks.
* ``FlowServeEngine(ctx=, mtp_k=2)`` before and after an EPLB pass on
  (2,2) and (2,1) under ``DECODE_RULES`` and on (1,2): greedy tokens equal to
  the reference's engine with ``mtp_k=2`` on (1,2) (its engine raises on
  two data ranks) and on every rank; host traffic ``4·B·(k+1) + 4·B``
  bytes an iteration.
* ``MTPDecoder`` on (2,2)/``DECODE_RULES``: the plain greedy chain, every draft accepted
  under the oracle.

The smaller meshes run on the 4 ranks of one world as replicas along a
leading axis ``r`` that no collective names.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_mesh import Reference, rel_err

ARCH = "deepseek-v3-671b-smoke"
B, L, ITERS, PEAK = 4, 64, 3, 1e4
PROMPTS = [[5, 9, 14, 3, 7], [11, 2, 8], [4, 4, 19, 23, 6, 30, 2],
           [17, 1, 9, 9]]
KS = (1, 2)
#: name → (mesh, EP axis, decode rules)
MESHES = {"2x2": ((2, 2), "model", False),
          "1x2": ((1, 2), "model", False),
          "2x2/decode-rules": ((2, 2), ("data", "model"), True)}
#: the port's mesh → the reference run it is held to: the reference's
#: EP axes change its program, not the function it computes, so
#: (2,2) with EP over both axes is held to its (2,2) run
REF_OF = {"2x2": "2x2", "1x2": "1x2", "2x2/decode-rules": "2x2"}
#: the engines' meshes: the decode deployment (EP over both axes, DP
#: attention) and TP 2 (under ``LOGICAL_RULES`` two data ranks would
#: all-gather every FSDP-cut weight at every pass, minutes over gloo)
ENGINES = {"2x2/decode-rules": ((2, 2), ("data", "model"), True),
           "2x1/decode-rules": ((2, 1), ("data", "model"), True),
           "1x2": ((1, 2), "model", False)}
ENGINE_PROMPTS = ["hello world", "the quick brown fox jumps", "a"]
N_NEW = 8
#: greedy steps of the plain chain the oracle reads
CHAIN = ITERS * (max(KS) + 1) + 2


def config(get_config):
    """The smoke DeepSeek-V3 in f32, cut to one dense MLA layer and one
    MoE layer (and its MTP head): every kind of block, half the
    reference's compile time."""
    import dataclasses

    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, dtype="float32", num_layers=2,
                               prefix_layers=cfg.prefix_layers[:1])


def wrong_table(table, k: int, vocab: int) -> np.ndarray:
    """The plain chain with two targets wrong: slot 0 rejects a draft in
    the second iteration, slot 2 its first in the third."""
    wrong = table.copy()
    p0 = len(PROMPTS[0]) + (k + 1) + 1 + min(1, k - 1)
    p2 = len(PROMPTS[2]) + 2 * (k + 1) + 1
    wrong[0, p0] = (wrong[0, p0] + 1) % vocab
    wrong[2, p2] = (wrong[2, p2] + 1) % vocab
    return wrong


def eplb_counts(cfg, moe_kind) -> np.ndarray:
    counts = np.zeros((cfg.num_layers, cfg.moe.num_experts), np.int64)
    moe = [i for i, (_, f) in enumerate(cfg.layer_kinds()) if f == moe_kind]
    counts[moe, 1], counts[moe, 0] = 100, 5
    return counts


REFERENCE = """
from repro.configs import get_config
from repro.configs.base import MOE
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model
from repro.serving.backend import JAXBackend
from repro.serving.flowserve import FlowServeEngine
from repro.serving.request import Request
from test_torch_sharded_mtp import (B, CHAIN, ENGINE_PROMPTS, ITERS, KS, L,
                                    MESHES, N_NEW, PEAK, PROMPTS, REF_OF,
                                    config, eplb_counts, wrong_table)
cfg = config(get_config)
ctx1 = MeshCtx(mesh=auto_mesh((1, 1)), batch_axes=("data",), remat="none")
m1 = build_model(cfg, ctx1)
params = jax.jit(m1.init)(jax.random.PRNGKey(0))
for n, a in jax.tree_util.tree_flatten_with_path(params)[0]:
    put("param/" + ".".join(
        str(getattr(k, "key", getattr(k, "idx", k))) for k in n), a)
be1 = JAXBackend(m1, params, max_len=L)
c1s, first = [], []
for p in PROMPTS:
    c, lg = be1.prefill(p)
    c1s.append(jax.tree.map(np.asarray, c))     # uncommitted to device 0
    first.append(int(np.argmax(lg)))
lens = np.array([len(p) for p in PROMPTS], np.int32)
cache = be1.init_cache(B, L)
for i, c in enumerate(c1s):
    cache = be1.write_slot(cache, c, i)
table = np.zeros((B, L), np.int32)
tok, pos = np.array(first, np.int32)[:, None], lens.copy()
for s in range(CHAIN):
    table[np.arange(B), pos] = tok[:, 0]
    nxt, cache = be1.decode_sample(cache, tok, pos, np.zeros(B, np.float32), s)
    tok, pos = np.asarray(nxt)[:, None], pos + 1
put("table", table)
publish("params")


def oracle(model, tab):
    real = type(model).mtp_step.__get__(model)
    tab = jnp.asarray(tab)

    def mtp_step(params, idx, hidden, tokens, positions, cache=None):
        logits, h, cache = real(params, idx, hidden, tokens, positions,
                                cache)
        tgt = tab[jnp.arange(positions.shape[0]),
                  jnp.minimum(positions + 1, L - 1)]
        return (logits + PEAK * jax.nn.one_hot(tgt, logits.shape[-1]), h,
                cache)
    model.mtp_step = mtp_step


def flat(prefix, tree):
    for n, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
        put(prefix + ".".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in n), a)


for mname in sorted(set(REF_OF.values())):
    shape, ep, _ = MESHES[mname]
    ctx = MeshCtx(mesh=auto_mesh(shape), batch_axes=("data",),
                  remat="none", ep_axis=ep)
    for k in KS:
        m = build_model(cfg, ctx)
        oracle(m, wrong_table(table, k, cfg.vocab_size))
        be = JAXBackend(m, params, max_len=L, mtp_k=k)
        cache = be.init_cache(B, L)
        for i, c in enumerate(c1s):
            cache = be.write_slot(cache, c, i)
        mtp = be.init_mtp_cache(B, L)
        tok, pos = np.array(first, np.int32)[:, None], lens.copy()
        key = f"{mname}/k{k}"
        for s in range(ITERS):
            block, n, cache, mtp = be.decode_sample_mtp(
                cache, mtp, tok, pos, np.zeros(B, np.float32), s)
            block, n = np.asarray(block), np.asarray(n)
            put(f"{key}/block{s}", block)
            put(f"{key}/n{s}", n)
            # a copy: the next call donates the buffer a view would read
            put(f"{key}/hidden{s}", np.array(mtp["hidden"], copy=True))
            tok = block[np.arange(B), n][:, None].astype(np.int32)
            pos = (pos + n + 1).astype(np.int32)
        flat(f"{key}/cache/", cache)
        flat(f"{key}/mtp/", mtp["kv"])
ectx = MeshCtx(mesh=auto_mesh((1, 2)), batch_axes=("data",), remat="none")
eng = FlowServeEngine(cfg, params, ctx=ectx, n_dp_groups=2, max_batch=2,
                      max_len=L, mtp_k=2)
for rnd in range(2):
    reqs = [Request(prompt=p, max_new_tokens=N_NEW, ignore_eos=True)
            for p in ENGINE_PROMPTS]
    for r in reqs:
        eng.submit(r)
    eng.run_until_done()
    put(f"engine/{rnd}", np.asarray([list(r.output_tokens) for r in reqs],
                                    np.int32))
    if rnd == 0:
        eng.record_expert_counts(eplb_counts(cfg, MOE))
        assert eng.run_eplb()
eng.close()
"""


def _port_mesh(shape):
    if shape[0] * shape[1] == 4:
        return shape, ("data", "model")
    return (4 // (shape[0] * shape[1]),) + shape, ("r", "data", "model")


def oracle(model, table) -> None:
    """The port's head with its logits peaked at ``table[row, position +
    1]``: global positions, global (all-gathered) logits."""
    real = model.mtp_step
    tab = torch.from_numpy(np.asarray(table)).long()

    def mtp_step(params, idx, hidden, tokens, positions, cache=None):
        logits, h, cache = real(params, idx, hidden, tokens, positions,
                                cache)
        tgt = tab[torch.arange(positions.shape[0]),
                  torch.clamp(positions.long() + 1, max=L - 1)]
        return (logits + PEAK * torch.nn.functional.one_hot(
            tgt, logits.shape[-1]), h, cache)
    model.mtp_step = mtp_step


def _start(be):
    """Each prompt prefilled and written into its slot: (cache, first
    tokens [B, 1], positions [B])."""
    cache, first = be.init_cache(B, L), []
    for i, p in enumerate(PROMPTS):
        c1, logits = be.prefill(p)
        cache = be.write_slot(cache, c1, i)
        first.append(int(np.argmax(logits)))
    return (cache, np.array(first, np.int32)[:, None],
            np.array([len(p) for p in PROMPTS], np.int32))


def _gathered(model, tree, full, names):
    """A decode-layout tree of this rank's blocks → the global tree
    (numpy, dotted paths), gathered from every rank's blocks."""
    from repro_torch.launch import sharding as shd
    from repro_torch.models.weights import flatten

    specs = flatten(model._layout_specs(full, True))
    # copies: an uncut leaf is the live tensor, which later steps write
    return {f"{names}{p}": shd.gather_local(t, specs[p], model.ctx).numpy()
            .copy() for p, t in flatten(tree).items()}


def _mtp_meta(model):
    """The head's global state as ``meta`` tensors (shapes for the
    layout's specs)."""
    spec = model.mtp_cache_spec(B, L)
    return {"kv": {n: torch.empty(s, device="meta")
                   for n, s in spec["kv"].items()},
            "hidden": torch.empty(spec["hidden"], device="meta")}


def _backend_runs(model, params, table, temps, k):
    from repro_torch.serving.backend import TorchBackend

    be = TorchBackend(model, params, max_len=L, mtp_k=k, device="cpu")
    cache, tok, pos = _start(be)
    mtp = be.init_mtp_cache(B, L)
    out = {}
    for s in range(ITERS):
        block, n, cache, mtp = be.decode_sample_mtp(cache, mtp, tok, pos,
                                                    temps, s)
        block, n = block.numpy(), n.numpy()
        out[f"block{s}"], out[f"n{s}"] = block, n
        out[f"hidden{s}"] = _gathered(
            model, {"h": mtp["hidden"]}, {"h": _mtp_meta(model)["hidden"]},
            "")["h"]
        tok = block[np.arange(B), n][:, None].astype(np.int32)
        pos = (pos + n + 1).astype(np.int32)
    out.update(_gathered(model, cache, model.cache_spec(B, L), "cache/"))
    out.update(_gathered(model, mtp["kv"], _mtp_meta(model)["kv"], "mtp/"))
    return out


def _engine(cfg, params, ctx, rules, moved):
    from repro_torch.configs.base import MOE
    from repro_torch.serving import dp_group
    from repro_torch.serving.flowserve import FlowServeEngine
    from repro_torch.serving.request import Request

    eng = FlowServeEngine(cfg, params, device="cpu", ctx=ctx, rules=rules,
                          n_dp_groups=2, max_batch=2, max_len=L, mtp_k=2)
    real = dp_group.to_host

    def spy(t):
        moved.append((tuple(t.shape), str(t.dtype)))
        return real(t)
    dp_group.to_host = spy
    out = []
    try:
        for rnd in range(2):
            reqs = [Request(prompt=p, max_new_tokens=N_NEW, ignore_eos=True)
                    for p in ENGINE_PROMPTS]
            for r in reqs:
                eng.submit(r)
            eng.run_until_done()
            out.append([list(r.output_tokens) for r in reqs])
            if rnd == 0:
                eng.record_expert_counts(eplb_counts(cfg, MOE))
                assert eng.run_eplb()
        placed = all(d.backend._placement is not None for d in eng.dps)
    finally:
        dp_group.to_host = real
        eng.close()
    return out, placed


def _decoder(model, params, table):
    from repro_torch.serving.backend import TorchBackend
    from repro_torch.serving.mtp import MTPDecoder

    be = TorchBackend(model, params, max_len=L, device="cpu")
    c1, logits = be.prefill(PROMPTS[0])
    cache = be.write_slot(be.init_cache(1, L), c1, 0)
    dec = MTPDecoder(model, params)
    got, _ = dec.generate(cache, int(np.argmax(logits)), len(PROMPTS[0]), 9)
    return got, dec.stats.accepted


def _rank(rank, world, init, flat_params, table):
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as shd
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models.mesh_ctx import MeshCtx
    from repro_torch.models.transformer import Model
    from repro_torch.models.weights import from_jax_params

    cfg = config(get_config)
    out, meshes = {}, {}

    def setup(shape, ep, drules):
        pshape, names = _port_mesh(shape)
        if pshape not in meshes:
            meshes[pshape] = init_mesh(pshape, "gloo", "cpu",
                                       axis_names=names, rank=rank,
                                       world_size=world, init_method=init)
        ctx = MeshCtx(mesh=meshes[pshape], batch_axes=("data",),
                      remat="none", ep_axis=ep)
        rules = shd.DECODE_RULES if drules else None
        return ctx, rules, from_jax_params(flat_params, cfg, "cpu", ctx=ctx,
                                           rules=rules)
    greedy = np.zeros(B, np.float32)
    for mname, (shape, ep, drules) in MESHES.items():
        ctx, rules, params = setup(shape, ep, drules)
        for k in KS:
            model = Model(cfg, ctx=ctx, rules=rules)
            oracle(model, wrong_table(table, k, cfg.vocab_size))
            for key, v in _backend_runs(model, params, table, greedy,
                                        k).items():
                out[f"{mname}/k{k}/{key}"] = v
        if mname == "2x2/decode-rules":
            model = Model(cfg, ctx=ctx, rules=rules)
            temps = np.array([0.7, 0.0, 0.7, 0.7], np.float32)
            run = _backend_runs(model, params, table, temps, 2)
            out["stochastic"] = [run[f"block{s}"] for s in range(ITERS)] \
                + [run[f"n{s}"] for s in range(ITERS)]
            model = Model(cfg, ctx=ctx, rules=rules)
            oracle(model, table)
            out["decoder"] = _decoder(model, params, table)
    for mname, (shape, ep, drules) in ENGINES.items():
        ctx, rules, params = setup(shape, ep, drules)
        moved = []
        out[f"engine/{mname}"] = _engine(cfg, params, ctx, rules, moved)
        out[f"moved/{mname}"] = moved
    return out


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    from repro_torch.launch.mesh import spawn

    ref = Reference(tmp_path_factory.mktemp("ref"), REFERENCE, timeout=900)
    part = ref.part("params")
    flat = {k[6:]: v for k, v in part.items() if k.startswith("param/")}
    got = spawn(_rank, 4, flat, part["table"], threads=2)
    return ref.result(), got, part["table"]


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_sample_mtp_matches_reference_on_mesh(both, mesh, k):
    want, got, table = both
    key, ref = f"{mesh}/k{k}", f"{REF_OF[mesh]}/k{k}"
    for s in range(ITERS):
        for g in got:
            np.testing.assert_array_equal(g[f"{key}/block{s}"],
                                          want[f"{ref}/block{s}"])
            np.testing.assert_array_equal(g[f"{key}/n{s}"],
                                          want[f"{ref}/n{s}"])
        assert rel_err(got[0][f"{key}/hidden{s}"],
                       want[f"{ref}/hidden{s}"]) <= 1e-4, s
    # the oracle: all drafts accepted, but where a target is wrong
    n_acc = np.stack([want[f"{ref}/n{s}"] for s in range(ITERS)])
    assert n_acc[0].tolist() == [k] * B
    assert n_acc[1, 0] == min(1, k - 1) and n_acc[2, 2] == 0
    assert (n_acc == k).sum() == n_acc.size - 2
    caches = [p[len(ref):] for p in want if p.startswith(f"{ref}/cache/")
              or p.startswith(f"{ref}/mtp/")]
    assert any(p.startswith("/mtp/") for p in caches) and len(caches) > 2
    for p in caches:
        assert rel_err(got[0][key + p], want[ref + p]) <= 1e-4, p
        for g in got[1:]:
            np.testing.assert_array_equal(g[key + p], got[0][key + p])
    # lossless: each slot's stream is the plain greedy chain
    for b in range(B):
        pos, emitted = len(PROMPTS[b]), []
        for s in range(ITERS):
            emitted += want[f"{ref}/block{s}"][b,
                                               :want[f"{ref}/n{s}"][b] + 1
                                               ].tolist()
        assert emitted == table[b, pos + 1:pos + 1 + len(emitted)].tolist()


def test_stochastic_draws_are_the_same_on_every_rank(both):
    _, got, _ = both
    for g in got[1:]:
        for a, b in zip(g["stochastic"], got[0]["stochastic"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", list(ENGINES))
def test_mtp_engine_tokens_match_reference_before_and_after_eplb(both,
                                                                 mesh):
    want, got, _ = both
    ref = [want[f"engine/{r}"].tolist() for r in range(2)]
    assert all(len(t) == N_NEW for rnd in ref for t in rnd)
    for g in got:
        tokens, placed = g[f"engine/{mesh}"]
        assert placed and tokens == ref
        # per iteration: the [2, k+1] block and the [2] counts, int32
        moved = g[f"moved/{mesh}"]
        assert moved and len(moved) % 2 == 0
        assert set(moved[0::2]) == {((2, 3), "torch.int32")}
        assert set(moved[1::2]) == {((2,), "torch.int32")}


def test_mtp_decoder_on_a_mesh_is_the_plain_chain(both):
    _, got, table = both
    p = len(PROMPTS[0])
    for g in got:
        tokens, accepted = g["decoder"]
        assert tokens == table[0, p + 1:p + 10].tolist()
        assert accepted == 4
