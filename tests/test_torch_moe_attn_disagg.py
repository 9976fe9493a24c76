"""The port's disaggregated MoE-Attention (§5.2,
``repro_torch.core.moe_attn_disagg``) against the reference's and against
the port's own monolithic decode step, on the smoke DeepSeek-V3 (MLA,
top-2 of 4) and the smoke Llama-4 with G = 5 (GQA, top-1 of 4, a shared
expert), in float32 with the same weights.

* The disaggregated decode step against the reference's
  (``DisaggregatedMoEAttention`` on the Auto-axis mesh), from the same
  ragged-position cache: microbatches {1, 2} x quantize {False, True},
  and with an EPLB placement table — the same greedy tokens, logits
  within 1e-4 relative, the same KV.
* ``pack_dispatch`` (route-pack, with and without its INT8 wire format,
  with and without a placement) against the reference's: destinations,
  rank, keep and buckets exact; ``unpack_combine`` on those packs (some
  assignments dropped) equal to the reference's.
* The disaggregated step against the port's ``Model.decode_step`` at the
  same micro-batching and the model's capacity factor (so the buckets
  are equal): the KV bit-identical (the MoE layer is the last one, and
  its KV is written before its FFN), logits within 0.05 (the combine adds
  ``(x + routed) + shared`` where the monolithic layer adds ``x + (routed
  + shared)``).
* ``quantize_tokens`` / ``dequantize_tokens`` exact against the
  reference's; ``unpack_combine`` bit-identical under a permuted bucket
  layout, and equal to ``index_add_`` on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe_attn_disagg as jdis
from repro.serving import eplb as jeplb
from repro.xccl import routing as jrouting
from repro_torch.core import moe_attn_disagg as tdis
from repro_torch.models.transformer import Model
from repro_torch.serving import eplb as teplb
from repro_torch.xccl import routing as trouting
from torch_parity import reference, rel_err, to_np

B, S, L = 4, 6, 16
#: decode positions: rows at different lengths (ragged), written over
#: the prompt's own slots where a row is shorter than S
POSITIONS = np.array([S, S - 3, S - 1, S - 5], np.int32)
CONFIGS = ("deepseek-v3", "llama4-gqa")


def _moe_layer(cfg) -> int:
    return next(i for i, (_, f) in enumerate(cfg.layer_kinds())
                if f == "moe")


@functools.lru_cache(maxsize=None)
def _setup(config: str):
    """Both packages' prefill of one seeded batch, padded to L slots: the
    JAX cache, a function making a fresh port cache, and the next tokens
    (the reference's greedy ones)."""
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config=config)
    toks = np.random.default_rng(11).integers(
        2, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jc1 = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    model = Model(tcfg)
    with torch.no_grad():
        _, tc1 = model.prefill(tparams, torch.from_numpy(toks))

    def pad(path, a):
        ax = 2 if any(getattr(p, "key", None) == "blocks" for p in path) \
            else 1
        w = [(0, 0)] * a.ndim
        w[ax] = (0, L - a.shape[ax])
        return jnp.pad(a, w)
    jcache = jax.tree_util.tree_map_with_path(pad, jc1)

    def torch_cache():
        full = model.init_cache(B, L, device="cpu")
        for i, layer in enumerate(tc1.get("prefix", ())):
            for n, t in layer.items():
                full["prefix"][i][n][:, :S] = t
        for p, leaves in tc1["blocks"].items():
            for n, t in leaves.items():
                full["blocks"][p][n][:, :, :S] = t
        return full
    tok = np.argmax(to_np(jl), -1).astype(np.int32)[:, None]
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                tparams=tparams, model=model, jcache=jcache,
                torch_cache=torch_cache, tok=tok)


def _tables(jcfg):
    """The same EPLB table for both packages: two replicated experts in
    the MoE layer (E + 2 physical slots), identity elsewhere."""
    E = jcfg.moe.num_experts
    maps = [None] * jcfg.num_layers
    maps[_moe_layer(jcfg)] = jeplb.ExpertMap(E, {1: [1, E], 2: [2, E + 1]})
    t = jeplb.build_placement_table(maps, E, pad_physical=E + 2,
                                    pad_replicas=2)
    arrays = (t.replica_slots, t.n_replicas, t.phys_owner)
    return (jeplb.PlacementTable(*(jnp.asarray(a) for a in arrays)),
            teplb.PlacementTable(*(torch.as_tensor(np.asarray(a),
                                                   dtype=torch.int32)
                                   for a in arrays)))


def _jax_step(s, microbatches, quantize, placement):
    """The reference driver's decode step, the whole step under one
    ``jax.jit`` (its dense layers run eagerly otherwise, which on the CPU
    costs tens of seconds a step)."""
    d = jdis.DisaggregatedMoEAttention(
        s["jmodel"], s["jparams"], quantize=quantize,
        microbatches=microbatches, placement=placement)
    return jax.jit(d.decode_step)(s["jcache"], jnp.asarray(s["tok"]),
                                  jnp.asarray(POSITIONS))


CASES = ([(c, mb, q, False) for c in CONFIGS for mb in (1, 2)
          for q in (False, True)]
         + [(c, 2, q, True) for c in CONFIGS for q in (False, True)])


@pytest.mark.parametrize("config,microbatches,quantize,placed", CASES)
def test_disaggregated_step_matches_reference(config, microbatches,
                                              quantize, placed):
    s = _setup(config)
    jtab, ttab = _tables(s["jcfg"]) if placed else (None, None)
    jl, jc = _jax_step(s, microbatches, quantize, jtab)
    drv = tdis.DisaggregatedMoEAttention(
        s["model"], s["tparams"], quantize=quantize,
        microbatches=microbatches, placement=ttab)
    cache = s["torch_cache"]()
    with torch.no_grad():
        tl, tc = drv.decode_step(cache, torch.from_numpy(s["tok"]),
                                 torch.from_numpy(POSITIONS))
    assert tc is cache
    assert tl.dtype == torch.float32 and tl.shape == (B, s["tcfg"].vocab_size)
    assert rel_err(tl, jl) < 1e-4, (config, microbatches, quantize, placed)
    np.testing.assert_array_equal(np.argmax(to_np(tl), -1),
                                  np.argmax(to_np(jl), -1))
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = _leaves(tc)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(tleaves, jleaves):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("placed", [False, True])
def test_pack_dispatch_matches_reference(config, quantize, placed):
    s = _setup(config)
    cfg = s["tcfg"]
    E, k, d = cfg.moe.num_experts, cfg.moe.top_k, cfg.d_model
    rng = np.random.default_rng(5)
    T = 24
    hn = rng.standard_normal((T, 1, d)).astype(np.float32)
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).astype(
        np.int32)
    idx[:9] = idx[0]                       # a hot expert set: drops
    w = rng.random((T, k)).astype(np.float32)
    n_dest, jp, tp = E, None, None
    if placed:
        jtab, ttab = _tables(s["jcfg"])
        li = _moe_layer(cfg)
        jp, tp = jtab.layer(li)[:2], ttab.layer(li)[:2]
        n_dest = E + 2
    cap = tdis.chunk_cap(T, n_dest, k, 1.0)
    assert cap == jdis.chunk_cap(T, n_dest, k, 1.0)
    jb, jstate = jdis.pack_dispatch(jnp.asarray(hn), jnp.asarray(idx),
                                    jnp.asarray(w), n_dest, cap, quantize,
                                    placement=jp)
    tb, tstate = tdis.pack_dispatch(torch.from_numpy(hn),
                                    torch.from_numpy(idx),
                                    torch.from_numpy(w), n_dest, cap,
                                    quantize, placement=tp)
    assert tb.shape == (n_dest, cap, d) and tb.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tb), to_np(jb))
    for name, a, b in zip(("dest", "rank", "keep", "tok_of", "w"), tstate,
                          jstate):
        np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=name)
    assert not to_np(tstate[2]).all(), "the hot expert set drops"
    if placed:
        assert (to_np(tstate[0]) >= E).any(), "replica slots routed to"
    # E2A on these packs: dropped assignments add nothing
    out = rng.standard_normal((n_dest, cap, d)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tdis.unpack_combine(torch.from_numpy(out), tstate, T, d, cap)),
        to_np(jdis.unpack_combine(jnp.asarray(out), jstate, T, d, cap)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("microbatches", [1, 2])
def test_disaggregated_step_matches_monolithic(config, microbatches):
    s = _setup(config)
    cfg = s["tcfg"]
    mono = Model(cfg, decode_microbatches=microbatches)
    drv = tdis.DisaggregatedMoEAttention(
        s["model"], s["tparams"], capacity_factor=cfg.moe.capacity_factor,
        microbatches=microbatches)
    tok, pos = torch.from_numpy(s["tok"]), torch.from_numpy(POSITIONS)
    c_mono, c_dis = s["torch_cache"](), s["torch_cache"]()
    with torch.no_grad():
        for _ in range(3):          # teacher-forced by the monolithic step
            want, _ = mono.decode_step(s["tparams"], c_mono, tok, pos)
            got, _ = drv.decode_step(c_dis, tok, pos)
            assert rel_err(got, want) < 0.05
            for a, b in zip(_leaves(c_dis), _leaves(c_mono)):
                assert torch.equal(a, b)
            tok = want.argmax(-1, keepdim=True).to(torch.int32)
            pos = pos + 1


def _leaves(tree):
    """A cache's tensors in JAX's leaf order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def test_quantize_tokens_match_reference():
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((33, 96)) * 10.0 ** rng.integers(
        -4, 4, (33, 1))).astype(np.float32)
    x[4] = 0.0                                  # an all-zero row
    x[5, :3] = [0.5, -0.5, 1.5]                  # ties of round-half-even
    tq, ts = trouting.quantize_tokens(torch.from_numpy(x))
    jq, js = jrouting.quantize_tokens(jnp.asarray(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tq), to_np(jq))
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    np.testing.assert_array_equal(
        to_np(trouting.dequantize_tokens(tq, ts)),
        to_np(jrouting.dequantize_tokens(jq, js)))


def test_unpack_combine_is_order_fixed():
    """The same assignments laid out in other bucket slots (each bucket's
    rows permuted, ranks following them) give the same bits, equal to
    ``index_add_`` into zeros on the CPU."""
    rng = np.random.default_rng(8)
    T, k, E, C, d = 20, 4, 6, 20, 40
    idx = np.stack([rng.permutation(E)[:k] for _ in range(T)]).reshape(-1)
    rank = np.zeros_like(idx)
    seen = np.zeros(E, int)
    for i, e in enumerate(idx):
        rank[i], seen[e] = seen[e], seen[e] + 1
    keep = rank < C
    out = (rng.standard_normal((E, C, d)) * 10.0 ** rng.integers(
        -5, 5, (E, C, 1))).astype(np.float32)
    w = rng.random(T * k).astype(np.float32)
    tok_of = np.arange(T * k) // k

    def run(out, rank):
        state = tuple(torch.from_numpy(a) for a in
                      (idx.astype(np.int32), rank.astype(np.int32), keep,
                       tok_of, w))
        return tdis.unpack_combine(torch.from_numpy(out), state, T, d, C)
    base = run(out, rank)
    perm = np.stack([rng.permutation(C) for _ in range(E)])
    moved = np.empty_like(out)
    for e in range(E):
        moved[e, perm[e]] = out[e]
    got = run(moved, perm[idx, rank])
    assert torch.equal(got, base)
    y = torch.from_numpy(out[idx, rank] * w[:, None])
    want = torch.zeros((T, d)).index_add_(0, torch.from_numpy(tok_of), y)
    assert torch.equal(base, want)
