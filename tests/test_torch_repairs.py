"""Three repairs of the port, each held on the CPU.

* ``TorchBackend(top_k=...)``: sampled tokens lie in each row's top k,
  and their distribution matches the reference's ``top_k_mask`` followed
  by a softmax (total variation <= 0.03 over 4000 draws; the two random
  number generators differ, so tokens are never compared one for one).
* ``Model(decode_microbatches=2)``: the §4.4 decode ping-pong reaches
  the MoE layers, and a decode step of the smoke DeepSeek-V3 matches the
  unsplit step and the reference's split step (built on the Auto-axis
  mesh with ``decode_microbatches=2``) within 0.02 relative, the bar of
  ``tests/test_core_disagg.py``, with the same greedy tokens (float32).
* ``ffn.combine_assignments``: each token's k weighted assignments are
  summed in index order, bit-identical to the ``index_add_`` it replaces
  on the CPU, for k = 1 and k = 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import build_model as jax_build_model
from repro.serving.sampling import top_k_mask as jax_top_k_mask
from repro_torch.models import ffn
from repro_torch.models.transformer import Model
from repro_torch.serving.backend import TorchBackend
from torch_parity import auto_ctx, reference, rel_err, to_np

V, K_TOP, N_DRAWS = 16, 5, 4000


class _FixedLogits:
    """Stands in for a model: every decode step returns the same logits
    [B, V] and leaves the cache as it is."""

    def __init__(self, logits):
        self.logits = logits
        self.cfg = type("Cfg", (), {"vocab_size": logits.shape[-1]})()

    def decode_step(self, params, cache, tokens, positions, placement=None):
        return self.logits, cache


def _sample(logits, top_k, temperature, steps=1):
    be = TorchBackend(_FixedLogits(logits), {}, top_k=top_k, seed=3,
                      device="cpu")
    B = logits.shape[0]
    out = []
    for step in range(steps):
        toks, _ = be.decode_sample({}, np.zeros((B, 1), np.int32),
                                   np.zeros((B,), np.int32),
                                   np.full((B,), temperature, np.float32),
                                   step)
        out.append(toks.numpy())
    return np.concatenate(out)


def test_backend_top_k_samples_only_each_rows_top_k():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((64, V)).astype(np.float32))
    toks = _sample(logits, K_TOP, 2.0, steps=8).reshape(8, 64)
    top = torch.topk(logits, K_TOP, dim=-1).indices.numpy()
    for row in range(64):
        assert set(toks[:, row]) <= set(top[row]), row
    # without top_k the same rows reach past their top k
    free = _sample(logits, 0, 2.0, steps=8).reshape(8, 64)
    assert any(not set(free[:, r]) <= set(top[r]) for r in range(64))


@pytest.mark.parametrize("temperature", [0.7, 1.5])
def test_backend_top_k_distribution_matches_reference(temperature):
    rng = np.random.default_rng(1)
    row = rng.standard_normal(V).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (N_DRAWS, 1)))
    toks = _sample(logits, K_TOP, temperature)
    emp = np.bincount(toks, minlength=V) / N_DRAWS
    want = np.asarray(jax.nn.softmax(
        jax_top_k_mask(jnp.asarray(row)[None], K_TOP) / temperature,
        axis=-1))[0]
    assert np.all(emp[want == 0] == 0)
    tv = 0.5 * np.abs(emp - want).sum()
    assert tv <= 0.03, (tv, emp, want)


def test_decode_microbatch_pingpong_matches_unsplit_and_reference(
        monkeypatch):
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32")
    B, S, L = 4, 6, 16
    toks = np.random.default_rng(9).integers(
        2, jcfg.vocab_size, (B, S)).astype(np.int32)
    model = Model(tcfg)
    split = Model(tcfg, decode_microbatches=2)
    with torch.no_grad():
        tl, tc1 = model.prefill(tparams, torch.from_numpy(toks))
    jl, jc1 = jax.jit(jmodel.prefill)(jparams, jnp.asarray(toks))
    tok = np.argmax(to_np(tl), -1).astype(np.int32)
    np.testing.assert_array_equal(tok, np.argmax(to_np(jl), -1))
    pos = np.full((B,), S, np.int32)

    def padded_torch():
        full = model.init_cache(B, L, device="cpu")
        for i, layer in enumerate(tc1["prefix"]):
            for n, t in layer.items():
                full["prefix"][i][n][:, :S] = t
        for p, leaves in tc1["blocks"].items():
            for n, t in leaves.items():
                full["blocks"][p][n][:, :, :S] = t
        return full

    seen = []
    moe_apply = ffn.moe_apply

    def spy(*a, mode, microbatches=1, **kw):
        seen.append((mode, microbatches))
        return moe_apply(*a, mode=mode, microbatches=microbatches, **kw)
    monkeypatch.setattr(ffn, "moe_apply", spy)
    with torch.no_grad():
        ref, _ = model.decode_step(tparams, padded_torch(),
                                   torch.from_numpy(tok[:, None]),
                                   torch.from_numpy(pos))
        got, _ = split.decode_step(tparams, padded_torch(),
                                   torch.from_numpy(tok[:, None]),
                                   torch.from_numpy(pos))
    n_moe = tcfg.num_layers - len(tcfg.prefix_layers)
    assert seen == [("decode", 1)] * n_moe + [("decode", 2)] * n_moe

    def pad(path, a):
        ax = 2 if any(getattr(p, "key", None) == "blocks" for p in path) \
            else 1
        w = [(0, 0)] * a.ndim
        w[ax] = (0, L - a.shape[ax])
        return jnp.pad(a, w)
    jc = jax.tree_util.tree_map_with_path(pad, jc1)
    jsplit = jax_build_model(jcfg, auto_ctx(decode_microbatches=2))
    jgot, _ = jax.jit(jsplit.decode_step)(jparams, jc,
                                          jnp.asarray(tok[:, None]),
                                          jnp.asarray(pos))
    assert rel_err(got, ref) < 0.02
    assert rel_err(got, jgot) < 0.02
    greedy = np.argmax(to_np(got), -1)
    np.testing.assert_array_equal(greedy, np.argmax(to_np(ref), -1))
    np.testing.assert_array_equal(greedy, np.argmax(to_np(jgot), -1))


@pytest.mark.parametrize("k", [1, 8])
def test_ordered_combine_bit_identical_to_index_add(k):
    T, d = 37, 96
    rng = np.random.default_rng(k)
    wa = torch.from_numpy(
        (rng.standard_normal((T * k, d)) * 10.0 ** rng.integers(
            -6, 6, (T * k, 1))).astype(np.float32))
    wa[3] = -0.0                             # a dropped assignment
    tok_of = torch.arange(T).repeat_interleave(k)
    want = torch.zeros((T, d)).index_add_(0, tok_of, wa)
    got = ffn.combine_assignments(wa, k)
    assert got.dtype == torch.float32 and got.shape == (T, d)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
