"""The prefix-KV contract of the port's ``TorchBackend`` (slice, seed,
remote read) against cold prefill and against the reference's
``JAXBackend``, in float32 on the smoke configurations.

A prompt sharing a 3-block prefix with an earlier one is seeded from the
earlier prompt's stored block payloads (read back through
``read_remote_kv`` for a pod-pooled remote hit) and prefills only its
suffix: its logits and the valid region of its KV must be bit-identical
to the cold prefill of the whole prompt in the port (the smoke MoE's
capacity factor drops nothing, so the split does not change the
function), and within 1e-4 of the reference's seeded prefill."""
import jax
import numpy as np
import pytest
import torch

from repro.serving.backend import JAXBackend
from repro.xccl.pd_transfer import slice_kv_chunk as jax_slice
from repro_torch.serving.backend import TorchBackend, _bucket_len
from repro_torch.xccl.pd_transfer import _leaves, _map_seq, slice_kv_chunk
from torch_parity import reference, rel_err

ARCHS = ["internlm2", "deepseek-v3", "llama4"]
PREFIX = 48                                           # 3 blocks


def _prompts(seed: int):
    """A provider and a consumer prompt sharing a 3-block prefix, in
    different padding buckets (64 and 128)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, 60, PREFIX).tolist()
    return (prefix + rng.integers(2, 60, 10).tolist(),
            prefix + rng.integers(2, 60, 70).tolist())


def _port(config: str):
    *_, tcfg, tparams = reference("float32", config=config)
    from repro_torch.models.transformer import Model
    return TorchBackend(Model(tcfg), tparams, max_len=256, device="cpu")


def _seeded(be, provider, consumer, remote: bool):
    cache_p, _ = be.prefill_chunk(None, provider, 0, len(provider))
    payloads = [be.slice_prefill_kv(cache_p, provider, b * 16, (b + 1) * 16)
                for b in range(PREFIX // 16)]
    if remote:
        payloads = be.read_remote_kv(payloads)
    seeded = be.seed_prefill_cache(payloads, PREFIX, len(consumer))
    return be.prefill_chunk(seeded, consumer[PREFIX:], PREFIX,
                            len(consumer))


@pytest.mark.parametrize("remote", [False, True], ids=["local", "remote"])
@pytest.mark.parametrize("config", ARCHS)
def test_seeded_prefill_bit_identical_to_cold(config, remote):
    be = _port(config)
    assert be.supports_prefix_kv
    provider, consumer = _prompts(0 if not remote else 1)
    cache_c, log_c = be.prefill_chunk(None, consumer, 0, len(consumer))
    cache_s, log_s = _seeded(be, provider, consumer, remote)
    np.testing.assert_array_equal(log_c, log_s)
    kv_c = _leaves(slice_kv_chunk(cache_c, 0, len(consumer)))
    kv_s = _leaves(slice_kv_chunk(cache_s, 0, len(consumer)))
    assert all(torch.equal(a, b) for a, b in zip(kv_c, kv_s))


@pytest.mark.parametrize("config", ARCHS)
def test_seeded_prefill_matches_reference(config):
    """The port's seeded prefill (payloads, seed, suffix chunk) against
    the reference's on the same weights: logits and valid-region KV."""
    _, jmodel, jparams, *_ = reference("float32", config=config)
    jbe = JAXBackend(jmodel, jparams, max_len=256)
    provider, consumer = _prompts(2)
    cache_j, log_j = _seeded(jbe, provider, consumer, remote=True)
    cache_t, log_t = _seeded(_port(config), provider, consumer, remote=True)
    assert rel_err(log_t, log_j) < 1e-4
    want = jax.tree_util.tree_leaves(jax_slice(cache_j, 0, len(consumer)))
    # both in the reference's leaf order (dict keys sorted)
    got = jax.tree_util.tree_leaves(slice_kv_chunk(cache_t, 0,
                                                   len(consumer)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        assert rel_err(g, w) < 1e-4


@pytest.mark.parametrize("config", ARCHS)
def test_seed_allocates_the_cold_chunk_buffer(config):
    """``seed_prefill_cache`` sizes its buffer as ``prefill_chunk(None,
    …)`` does for the same prompt length, copies the payloads into
    ``[0, prefix_len)`` as fresh storage and leaves the rest zero."""
    be = _port(config)
    provider, consumer = _prompts(3)
    cache_p, _ = be.prefill_chunk(None, provider, 0, len(provider))
    payloads = [be.slice_prefill_kv(cache_p, provider, b * 16, (b + 1) * 16)
                for b in range(PREFIX // 16)]
    cold, _ = be.prefill_chunk(None, consumer, 0, len(consumer))
    seeded = be.seed_prefill_cache(payloads, PREFIX, len(consumer))
    Lc = min(_bucket_len(len(consumer)), 256)

    def one(c, s, p, ax):
        assert c.shape == s.shape and s.shape[ax] == Lc
        assert torch.equal(s.narrow(ax, 0, PREFIX), p)
        assert not s.narrow(ax, PREFIX, Lc - PREFIX).any()
    _map_seq(one, cold, seeded, slice_kv_chunk(cache_p, 0, PREFIX))
    # payloads are copies: writing the provider's buffer changes nothing
    for t in _leaves(cache_p):
        t.fill_(float("nan"))
    again = be.seed_prefill_cache(payloads, PREFIX, len(consumer))
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(again), _leaves(seeded)))


@pytest.mark.parametrize("config", ARCHS)
def test_same_split_seed_is_bit_identical(config):
    """The bar that holds at any width: seeded from a cold chunked
    prefill whose chunk ends at the seed boundary, the same suffix chunk
    gives the cold run's logits and KV bit for bit."""
    be = _port(config)
    _, consumer = _prompts(4)
    n = len(consumer)
    cache, _ = be.prefill_chunk(None, consumer[:PREFIX], 0, n)
    payloads = [slice_kv_chunk(cache, b * 16, (b + 1) * 16)
                for b in range(PREFIX // 16)]
    cache, log_c = be.prefill_chunk(cache, consumer[PREFIX:], PREFIX, n)
    seeded = be.seed_prefill_cache(be.read_remote_kv(payloads), PREFIX, n)
    cache_s, log_s = be.prefill_chunk(seeded, consumer[PREFIX:], PREFIX, n)
    np.testing.assert_array_equal(log_c, log_s)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(slice_kv_chunk(cache, 0, n)),
        _leaves(slice_kv_chunk(cache_s, 0, n))))
