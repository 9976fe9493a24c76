"""The MTP draft head (§4.6) of the port's model against the JAX
reference, on the smoke DeepSeek-V3 (MLA + MoE, one MTP layer) in
float32 with the same weights: ``init_mtp_cache`` shapes,
``decode_step_hidden`` (and ``decode_step`` bit-identical to it), and
``mtp_step`` with a decode cache and without one, within 1e-4 relative.
Junk left in a cache past each row's position is never read."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.common import tree_map
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten
from torch_parity import reference, rel_err, to_np

B, PROMPT, MAX_LEN, STEPS = 2, 6, 16, 4
BAR = 1e-4


@pytest.fixture(scope="module")
def ref():
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32")
    return jcfg, jmodel, jparams, tcfg, tparams, Model(tcfg)


def _prefilled(ref):
    """Both models' decode caches [B, MAX_LEN] after a B-row prefill, and
    the first greedy tokens."""
    jcfg, jmodel, jparams, tcfg, tparams, model = ref
    toks = np.random.default_rng(3).integers(
        2, jcfg.vocab_size, (B, PROMPT)).astype(np.int32)
    jl, jc = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    with torch.no_grad():
        _, tc = model.prefill(tparams, torch.from_numpy(toks))
    full = model.init_cache(B, MAX_LEN, device="cpu")
    for i, layer in enumerate(tc["prefix"]):
        for n, t in layer.items():
            full["prefix"][i][n][:, :PROMPT] = t
    for pos, leaves in tc["blocks"].items():
        for n, t in leaves.items():
            full["blocks"][pos][n][:, :, :PROMPT] = t

    def pad(path, a):
        ax = 2 if any(getattr(p, "key", None) == "blocks" for p in path) \
            else 1
        w = [(0, 0)] * a.ndim
        w[ax] = (0, MAX_LEN - a.shape[ax])
        return jnp.pad(a, w)
    jc = jax.tree_util.tree_map_with_path(pad, jc)
    return jc, full, np.argmax(to_np(jl), -1).astype(np.int32)


def test_bridge_carries_the_mtp_head(ref):
    _, _, jparams, tcfg, tparams, model = ref
    assert tcfg.mtp_num_layers == 1 and len(tparams["mtp"]) == 1
    want = flatten(jax.tree_util.tree_map(np.asarray, jparams["mtp"]))
    got = flatten(tparams["mtp"])
    assert set(got) == set(want) and "0.block.mixer.wkv_a" in got
    assert all(np.array_equal(to_np(got[p]), np.asarray(want[p]))
               for p in want)
    assert model.mtp_kind == tuple(tcfg.layer_pattern[-1][:1]) + ("mlp",)


def test_init_mtp_cache_shapes_match_reference(ref):
    _, jmodel, _, _, _, model = ref
    want = {p: (tuple(a.shape), str(a.dtype))
            for p, a in flatten(jmodel.init_mtp_cache(3, MAX_LEN)).items()}
    cache = model.init_mtp_cache(3, MAX_LEN, device="cpu")
    got = {p: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
           for p, t in flatten(cache).items()}
    assert got == want
    assert set(got) == {"kv.ckv", "kv.krope", "hidden"}
    assert all(not t.any() for t in flatten(cache).values())
    spec = model.mtp_cache_spec(3, MAX_LEN)
    assert spec["hidden"] == got["hidden"][0]
    assert {f"kv.{n}": s for n, s in spec["kv"].items()} == {
        p: s for p, (s, _) in got.items() if p.startswith("kv.")}


def test_decode_step_hidden_matches_reference(ref):
    jcfg, jmodel, jparams, tcfg, tparams, model = ref
    jc, tc, tok = _prefilled(ref)
    jstep = jax.jit(jmodel.decode_step_hidden)
    for step in range(STEPS):
        pos = np.full((B,), PROMPT + step, np.int32)
        jl, jh, jc = jstep(jparams, jc, jnp.asarray(tok[:, None]),
                           jnp.asarray(pos))
        args = (torch.from_numpy(tok[:, None]), torch.from_numpy(pos))
        with torch.no_grad():
            plain, _ = model.decode_step(tparams, tree_map(torch.clone, tc),
                                         *args)
            tl, th, tc = model.decode_step_hidden(tparams, tc, *args)
        assert torch.equal(plain, tl), f"step {step}"
        assert th.shape == (B, 1, tcfg.d_model)
        assert rel_err(tl, jl) <= BAR and rel_err(th, jh) <= BAR
        tok = np.argmax(to_np(jl), -1).astype(np.int32)
        np.testing.assert_array_equal(np.argmax(to_np(tl), -1), tok)


def test_mtp_step_with_and_without_cache_matches_reference(ref):
    """Four chained head steps on a decode cache (positions 0-3 of each
    row, the hidden carried), then the cache-free step (the reference's
    train mode, the port's prefill mode on one token), against the
    reference; the cache-free step also equals a cached step at
    position 0 of an empty cache."""
    jcfg, jmodel, jparams, tcfg, tparams, model = ref
    rng = np.random.default_rng(11)
    hid = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    toks = rng.integers(2, tcfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    jstep = jax.jit(jmodel.mtp_step, static_argnames=("mtp_index",))
    jc = jmodel.init_mtp_cache(B, MAX_LEN)["kv"]
    tc = model.init_mtp_cache(B, MAX_LEN, device="cpu")["kv"]
    jh, th = jnp.asarray(hid), torch.from_numpy(hid)
    for s in range(STEPS):
        pos = np.full((B,), s, np.int32)
        jl, jh, jc = jstep(jparams, mtp_index=0, hidden=jh,
                           next_tokens=jnp.asarray(toks[s]),
                           positions=jnp.asarray(pos), mtp_cache=jc)
        with torch.no_grad():
            tl, th, tc = model.mtp_step(tparams, 0, th,
                                        torch.from_numpy(toks[s]),
                                        torch.from_numpy(pos), tc)
        assert tl.shape == (B, tcfg.vocab_size) and th.shape == hid.shape
        assert rel_err(tl, jl) <= BAR and rel_err(th, jh) <= BAR, s
        for n in ("ckv", "krope"):
            assert rel_err(tc[n], jc[n]) <= BAR
    pos0 = np.zeros((B,), np.int32)
    jl, jh, _ = jstep(jparams, mtp_index=0, hidden=jnp.asarray(hid),
                      next_tokens=jnp.asarray(toks[0]),
                      positions=jnp.asarray(pos0))
    with torch.no_grad():
        tl, th, none = model.mtp_step(tparams, 0, torch.from_numpy(hid),
                                      torch.from_numpy(toks[0]),
                                      torch.from_numpy(pos0))
        cl, ch, _ = model.mtp_step(
            tparams, 0, torch.from_numpy(hid), torch.from_numpy(toks[0]),
            torch.from_numpy(pos0),
            model.init_mtp_cache(B, MAX_LEN, device="cpu")["kv"])
    assert none is None
    assert rel_err(tl, jl) <= BAR and rel_err(th, jh) <= BAR
    assert rel_err(cl, tl) <= 1e-5 and rel_err(ch, th) <= 1e-5
    # mtp_hidden is the head without its logits
    with torch.no_grad():
        h, _ = model.mtp_hidden(tparams, 0, torch.from_numpy(hid),
                                torch.from_numpy(toks[0]),
                                torch.from_numpy(pos0))
    assert torch.equal(h, th)


def test_junk_past_each_rows_position_is_never_read(ref):
    """The verify chain leaves rejected drafts' KV past a row's position:
    finite junk there (main cache and the head's cache) must not change
    a decode step's logits or a head step's, bit for bit."""
    jcfg, jmodel, jparams, tcfg, tparams, model = ref
    _, clean, tok = _prefilled(ref)
    pos = torch.tensor([PROMPT, PROMPT + 3], dtype=torch.int32)
    junk = tree_map(torch.clone, clean)
    gen = torch.Generator().manual_seed(5)
    for t in flatten(junk).values():
        seq = t.shape[-2]           # [.., B, L, r]: L is second to last
        tail = torch.arange(seq)[None, :] > pos[:, None]       # [B, L]
        noise = 1e3 * torch.randn(t.shape, generator=gen)
        t.copy_(torch.where(tail[..., None], noise, t))
    args = (torch.from_numpy(tok[:, None]), pos)
    rng = np.random.default_rng(2)
    hid = torch.from_numpy(
        rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32))
    heads = []
    for fill in (0.0, 1e3):
        kv = model.init_mtp_cache(B, MAX_LEN, device="cpu")["kv"]
        for t in kv.values():
            t[:, PROMPT:] = fill
        heads.append(kv)
    with torch.no_grad():
        want, _ = model.decode_step(tparams, clean, *args)
        got, _ = model.decode_step(tparams, junk, *args)
        pos_h = torch.full((B,), PROMPT - 1, dtype=torch.int32)
        outs = [model.mtp_step(tparams, 0, hid, args[0], pos_h, kv)[0]
                for kv in heads]
    assert torch.equal(got, want)
    assert torch.equal(outs[0], outs[1])
