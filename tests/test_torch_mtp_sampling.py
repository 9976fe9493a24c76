"""``speculative_verify`` (§4.6 acceptance) against the reference's.

Greedy rows must give the reference's tokens and accepted counts
exactly; at ``k = 0`` the step is plain sampling; stochastic rows are
compared as distributions only (the two random number generators
differ): each emitted token is distributed as the main model's ``p``,
and the accepted counts as the reference's. A step's draws are a pure
function of ``(seed, step)``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.sampling import sample_tokens as jax_sample_tokens
from repro.serving.sampling import speculative_verify as jax_verify
from repro_torch.serving.sampling import (DRAFT, greedy_verify,
                                          sample_tokens, speculative_verify,
                                          step_generator)


def _case(B, k, V, seed):
    rng = np.random.default_rng(seed)
    main = rng.standard_normal((B, k + 1, V)).astype(np.float32)
    draft_logits = rng.standard_normal((B, k, V)).astype(np.float32)
    drafts = rng.integers(0, V, (B, k)).astype(np.int32)
    # rows 0-2: the first 0, 1 and all drafts equal the main argmax
    top = main.argmax(-1)
    for row, n in enumerate((0, 1, k)):
        drafts[row, :n] = top[row, :n]
        if n < k:
            drafts[row, n] = (top[row, n] + 1) % V
    return main, drafts, draft_logits


def _both(main, drafts, dlogits, temps, top_k=0):
    got = speculative_verify(torch.from_numpy(main), torch.from_numpy(drafts),
                             torch.from_numpy(dlogits),
                             torch.from_numpy(temps), 7, 3, top_k=top_k)
    want = jax_verify(jnp.asarray(main), jnp.asarray(drafts),
                      jnp.asarray(dlogits), jnp.asarray(temps),
                      jax.random.PRNGKey(0), top_k=top_k)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_greedy_rows_equal_reference_exactly(k):
    main, drafts, dlogits = _case(6, k, 50, k)
    temps = np.zeros(6, np.float32)
    (tok, n), (jtok, jn) = _both(main, drafts, dlogits, temps)
    assert tok.dtype == np.int32 and n.dtype == np.int32
    np.testing.assert_array_equal(tok, jtok)
    np.testing.assert_array_equal(n, jn)
    assert n[:3].tolist() == [0, 1, k]
    g, gn = greedy_verify(torch.from_numpy(main), torch.from_numpy(drafts))
    np.testing.assert_array_equal(g.numpy(), tok)
    np.testing.assert_array_equal(gn.numpy(), n)
    # greedy rows of a mixed batch are untouched by the stochastic rows
    temps[3:] = 0.8
    (tok, n), (jtok, jn) = _both(main, drafts, dlogits, temps, top_k=5)
    np.testing.assert_array_equal(tok[:3], jtok[:3])
    np.testing.assert_array_equal(n[:3], jn[:3])
    assert ((0 <= n) & (n <= k)).all() and ((0 <= tok) & (tok < 50)).all()


def test_k0_is_plain_sampling():
    """k = 0: greedy rows are the argmax, stochastic rows a sample from
    softmax(logits / t) (the bonus draw)."""
    V, N, temp = 4, 6000, 0.9
    row = np.array([2.0, 1.0, 0.0, -1.0], np.float32)
    main = np.tile(row, (N, 1, 1))
    temps = np.full(N, temp, np.float32)
    temps[:10] = 0.0
    tok, n = speculative_verify(
        torch.from_numpy(main), torch.zeros((N, 0), dtype=torch.int32),
        torch.zeros((N, 0, V)), torch.from_numpy(temps), 1, 2)
    assert tok.shape == (N, 1) and not n.any()
    assert (tok[:10, 0] == 0).all()
    emp = np.bincount(tok[10:, 0].numpy(), minlength=V) / (N - 10)
    want = torch.softmax(torch.from_numpy(row) / temp, -1).numpy()
    np.testing.assert_allclose(emp, want, atol=0.025)
    jtok, _ = jax_verify(jnp.asarray(main[:10]), jnp.zeros((10, 0), jnp.int32),
                         jnp.zeros((10, 0, V)), jnp.zeros(10),
                         jax.random.PRNGKey(0))
    np.testing.assert_array_equal(tok[:10].numpy(), np.asarray(jtok))


def test_stochastic_marginals_match_p_and_the_reference():
    """N copies of one slot (k = 2, V = 5), drafts drawn from q as the
    backend draws them: the first emitted token is distributed as p's
    row 0, a bonus token (all drafts accepted) as p's last row, and the
    accepted counts as the reference's."""
    V, k, N, temp = 5, 2, 8000, 1.0
    rng = np.random.default_rng(0)
    main_row = rng.standard_normal((k + 1, V)).astype(np.float32) * 1.5
    draft_row = rng.standard_normal((k, V)).astype(np.float32) * 1.5
    main = np.tile(main_row, (N, 1, 1))
    dlog = np.tile(draft_row, (N, 1, 1))
    temps = np.full(N, temp, np.float32)
    gen = step_generator(5, 9, "cpu", DRAFT)
    drafts = torch.stack([sample_tokens(torch.from_numpy(dlog[:, j]),
                                        torch.from_numpy(temps), gen)
                          for j in range(k)], dim=1)
    tok, n = speculative_verify(torch.from_numpy(main), drafts,
                                torch.from_numpy(dlog),
                                torch.from_numpy(temps), 5, 9)
    keys = jax.random.split(jax.random.PRNGKey(1), k + 1)
    jdrafts = jnp.stack([jax_sample_tokens(jnp.asarray(dlog[:, j]),
                                           jnp.asarray(temps), keys[j])
                         for j in range(k)], axis=1)
    jtok, jn = jax_verify(jnp.asarray(main), jdrafts, jnp.asarray(dlog),
                          jnp.asarray(temps), keys[k])
    p = torch.softmax(torch.from_numpy(main_row) / temp, -1).numpy()
    for t in (tok.numpy(), np.asarray(jtok)):
        np.testing.assert_allclose(np.bincount(t[:, 0], minlength=V) / N,
                                   p[0], atol=0.025)
    full, jfull = n.numpy() == k, np.asarray(jn) == k
    assert full.sum() > 500 and jfull.sum() > 500
    np.testing.assert_allclose(
        np.bincount(tok.numpy()[full, k], minlength=V) / full.sum(),
        p[k], atol=0.05)
    np.testing.assert_allclose(np.bincount(n.numpy(), minlength=k + 1) / N,
                               np.bincount(np.asarray(jn),
                                           minlength=k + 1) / N, atol=0.03)
    # a partly accepted block emits the accepted drafts, then a resample
    part = (n > 0).numpy() & (n < k).numpy()
    assert part.any()
    assert (tok.numpy()[part, 0] == drafts.numpy()[part, 0]).all()


def test_a_step_replays_its_draws():
    main, drafts, dlogits = _case(64, 2, 40, 4)
    temps = torch.full((64,), 1.3)
    args = (torch.from_numpy(main), torch.from_numpy(drafts),
            torch.from_numpy(dlogits), temps)
    a = speculative_verify(*args, 11, 5)
    b = speculative_verify(*args, 11, 5)
    c = speculative_verify(*args, 11, 6)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    # the streams of one step differ from each other and from stream 0
    draws = [torch.rand(8, generator=step_generator(11, 5, "cpu", s))
             for s in range(5)]
    assert len({tuple(d.tolist()) for d in draws}) == 5
    assert torch.equal(draws[0],
                       torch.rand(8, generator=step_generator(11, 5, "cpu")))
