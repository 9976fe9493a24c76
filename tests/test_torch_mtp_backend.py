"""The port's ``TorchBackend.decode_sample_mtp`` (§4.6 propose-then-
verify) against the reference's ``JAXBackend``, on the smoke DeepSeek-V3
in float32 with the same weights, over several iterations: greedy token
blocks and accepted counts equal, the carried hidden within 1e-4.

Random heads almost never propose the main model's argmax, so an
*oracle* head forces acceptance: its logits are the head's own plus a
peak at the token the plain greedy chain puts at the next position
(wrong on purpose at a few positions, so drafts are also rejected in the
middle of a block). Under it every block is accepted in full, ``k + 1``
tokens an iteration, and the emitted stream is the plain chain."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.backend import JAXBackend
from repro_torch.models.common import tree_map
from repro_torch.models.transformer import Model
from repro_torch.serving.backend import TorchBackend
from repro_torch.serving.mtp import MTPDecoder
from torch_parity import one_thread, reference, rel_err, to_np  # noqa: F401

MAX_LEN, ITERS = 64, 4
PROMPTS = [[5, 9, 14, 3, 7], [11, 2, 8], [4, 4, 19, 23, 6, 30, 2]]
B = len(PROMPTS)
PEAK = 1e4


@pytest.fixture(scope="module")
def ref():
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32")
    return jmodel, jparams, Model(tcfg), tparams


def _start(backend):
    """Every slot prefilled with its prompt: (cache, first tokens [B, 1],
    positions [B])."""
    cache = backend.init_cache(B, MAX_LEN)
    first = []
    for i, p in enumerate(PROMPTS):
        c1, logits = backend.prefill(p)
        cache = backend.write_slot(cache, c1, i)
        first.append(int(np.argmax(logits)))
    return (cache, np.array(first, np.int32)[:, None],
            np.array([len(p) for p in PROMPTS], np.int32))


def plain_chain(model, params, n: int) -> np.ndarray:
    """[B, MAX_LEN] table: the token plain greedy decoding puts at each
    position (0 outside the first ``n`` decoded positions)."""
    be = TorchBackend(model, params, max_len=MAX_LEN, device="cpu")
    cache, tok, pos = _start(be)
    table = np.zeros((B, MAX_LEN), np.int32)
    temps = np.zeros(B, np.float32)
    for s in range(n):
        table[np.arange(B), pos] = tok[:, 0]
        nxt, cache = be.decode_sample(cache, tok, pos, temps, s)
        tok, pos = nxt.numpy()[:, None], pos + 1
    return table


def torch_oracle(monkeypatch, model, target_of):
    """The port's head with its logits peaked at ``target_of(row,
    position + 1)``."""
    real = Model.mtp_step.__get__(model)

    def mtp_step(params, idx, hidden, tokens, positions, cache=None):
        logits, h, cache = real(params, idx, hidden, tokens, positions,
                                cache)
        tgt = torch.tensor([int(target_of(b, int(p) + 1))
                            for b, p in enumerate(positions)])
        logits = logits + PEAK * torch.nn.functional.one_hot(
            tgt, logits.shape[-1])
        return logits, h, cache
    monkeypatch.setattr(model, "mtp_step", mtp_step)


def jax_oracle(monkeypatch, jmodel, table):
    real = type(jmodel).mtp_step.__get__(jmodel)
    tab = jnp.asarray(table)

    def mtp_step(params, idx, hidden, tokens, positions, cache=None):
        logits, h, cache = real(params, idx, hidden, tokens, positions,
                                cache)
        tgt = tab[jnp.arange(B), jnp.minimum(positions + 1, MAX_LEN - 1)]
        return (logits + PEAK * jax.nn.one_hot(tgt, logits.shape[-1]), h,
                cache)
    monkeypatch.setattr(jmodel, "mtp_step", mtp_step)


def _run(backend, k, temps, iters=ITERS):
    """``iters`` MTP iterations from the prefilled slots; each slot goes
    on from its last emitted token. → per iteration (block, n_acc,
    hidden), and each slot's emitted stream."""
    cache, tok, pos = _start(backend)
    mtp = backend.init_mtp_cache(B, MAX_LEN)
    out, emitted = [], [[int(t)] for t in tok[:, 0]]
    for s in range(iters):
        block, n, cache, mtp = backend.decode_sample_mtp(
            cache, mtp, tok, pos, temps, s)
        block, n = to_np(block), to_np(n)
        assert block.shape == (B, k + 1) and block.dtype == np.int32
        assert n.shape == (B,) and n.dtype == np.int32
        out.append((block, n, to_np(mtp["hidden"]).copy()))
        for b in range(B):
            emitted[b] += block[b, :n[b] + 1].tolist()
        tok = block[np.arange(B), n][:, None].astype(np.int32)
        pos = (pos + n + 1).astype(np.int32)
    return out, emitted


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("k", [1, 2])
def test_decode_sample_mtp_matches_reference(ref, monkeypatch, k, oracle):
    jmodel, jparams, model, tparams = ref
    table = plain_chain(model, tparams, ITERS * (k + 1) + 1)
    if oracle:
        wrong = table.copy()
        # slot 0 rejects its second draft of the second iteration; slot
        # 2 its first of the third
        p0 = len(PROMPTS[0]) + (k + 1) + 1 + min(1, k - 1)
        p2 = len(PROMPTS[2]) + 2 * (k + 1) + 1
        wrong[0, p0] = (wrong[0, p0] + 1) % model.cfg.vocab_size
        wrong[2, p2] = (wrong[2, p2] + 1) % model.cfg.vocab_size
        torch_oracle(monkeypatch, model, lambda b, q: wrong[b, q])
        jax_oracle(monkeypatch, jmodel, wrong)
    temps = np.zeros(B, np.float32)
    got, emitted = _run(TorchBackend(model, tparams, max_len=MAX_LEN,
                                     mtp_k=k, device="cpu"), k, temps)
    want, _ = _run(JAXBackend(jmodel, jparams, max_len=MAX_LEN, mtp_k=k),
                   k, temps)
    for s, ((b, n, h), (jb, jn, jh)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(b, jb, err_msg=f"iteration {s}")
        np.testing.assert_array_equal(n, jn, err_msg=f"iteration {s}")
        assert rel_err(h, jh) <= 1e-4, s
    # lossless: each slot's stream is the plain greedy chain
    for b in range(B):
        p = len(PROMPTS[b])
        assert emitted[b] == table[b, p:p + len(emitted[b])].tolist()
    n_acc = np.stack([n for _, n, _ in got])
    if oracle:
        assert n_acc[0].tolist() == [k] * B
        assert n_acc[1, 0] == min(1, k - 1) and n_acc[2, 2] == 0
        full = n_acc == k
        assert full.sum() == n_acc.size - 2
    else:
        assert n_acc.max() <= k


def test_mtp_needs_a_head(ref):
    _, _, model, tparams = ref
    headless = {n: t for n, t in tparams.items() if n != "mtp"}
    with pytest.raises(ValueError, match="MTP head"):
        TorchBackend(model, headless, mtp_k=1, device="cpu")
    be = TorchBackend(model, headless, device="cpu")
    with pytest.raises(NotImplementedError):
        be.decode_sample_mtp(None, None, np.zeros((1, 1), np.int32),
                             np.zeros(1, np.int32), np.zeros(1), 0)


def test_donate_false_keeps_both_caches(ref):
    _, _, model, tparams = ref
    be = TorchBackend(model, tparams, max_len=MAX_LEN, mtp_k=2,
                      device="cpu")
    cache, tok, pos = _start(be)
    mtp = be.init_mtp_cache(B, MAX_LEN)
    temps = np.array([0.0, 0.7, 1.0], np.float32)
    before = tree_map(torch.clone, (cache, mtp))
    a = be.decode_sample_mtp(cache, mtp, tok, pos, temps, 3, donate=False)
    assert all(torch.equal(x, y) for x, y in
               zip(_leaves((cache, mtp)), _leaves(before)))
    b = be.decode_sample_mtp(cache, mtp, tok, pos, temps, 3)
    # in place, and the same draws: identical blocks, counts and caches
    assert b[2] is cache and b[3] is mtp
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))
    assert not all(torch.equal(x, y) for x, y in
                   zip(_leaves((cache, mtp)), _leaves(before)))


def _leaves(tree):
    from repro_torch.models.weights import flatten
    return [t for _, t in sorted(flatten(tree).items())]


def test_reset_mtp_slot_zeroes_one_slot(ref):
    _, _, model, tparams = ref
    be = TorchBackend(model, tparams, max_len=MAX_LEN, mtp_k=1,
                      device="cpu")
    mtp = tree_map(lambda t: torch.ones_like(t),
                   be.init_mtp_cache(B, MAX_LEN))
    assert be.reset_mtp_slot(mtp, 1) is mtp
    for t in _leaves(mtp):
        assert not t[1].any() and bool((t[0] == 1).all()) \
            and bool((t[2] == 1).all())


@pytest.mark.parametrize("oracle", [False, True])
def test_mtp_decoder_generate_is_lossless(ref, monkeypatch, oracle):
    """The batch-1 greedy loop gives plain greedy decoding's tokens; with
    the oracle head every draft is accepted."""
    _, _, model, tparams = ref
    n = 9
    table = plain_chain(model, tparams, n + 2)
    if oracle:
        torch_oracle(monkeypatch, model, lambda b, q: table[0, q])
    be = TorchBackend(model, tparams, max_len=MAX_LEN, device="cpu")
    cache1, logits = be.prefill(PROMPTS[0])
    cache = be.init_cache(1, MAX_LEN)
    cache = be.write_slot(cache, cache1, 0)
    p = len(PROMPTS[0])
    dec = MTPDecoder(model, tparams)
    got, _ = dec.generate(cache, int(np.argmax(logits)), p, n)
    assert got == table[0, p + 1:p + 1 + n].tolist()
    st = dec.stats
    assert st.tokens == n and st.drafts == st.iterations
    if oracle:
        assert st.accepted == n // 2 and st.tokens_per_step > 1.5
    else:
        assert st.accepted == 0 and st.tokens_per_step == 1.0
