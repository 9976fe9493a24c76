"""§4.6 "Multiple MTPs": the port's ``MTPTrainer`` against the
reference's on the CPU in float32, on the smoke DeepSeek-V3 with a
second MTP head (the reference's own test's setting: ``mtp_index`` 1, lr
5e-3, seeded tokens [4, 32], 8 steps): the per-step losses within 1e-4
relative, the trained head within 1e-4 of the reference's, and every
other weight (the main stack, head 0) bit-identical before and after.
The reference is built on the Auto-axis mesh: its own test fails on the
Explicit-axis one. In bfloat16 the port's loss falls over the 8 steps,
the criterion of the reference's test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.mtp import MTPTrainer as JaxMTPTrainer
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten
from repro_torch.serving.mtp import MTPTrainer
from torch_parity import reference, to_np

BAR = 1e-4
STEPS = 8


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32)


def test_mtp_trainer_matches_reference():
    jcfg, jmodel, jparams, tcfg, tparams = reference(
        "float32", config="deepseek-v3-mtp2")
    toks = tokens(jcfg)
    jt = JaxMTPTrainer(jmodel, jparams, mtp_index=1, lr=5e-3)
    want = [jt.train_step(jnp.asarray(toks)) for _ in range(STEPS)]
    tt = MTPTrainer(Model(tcfg), tparams, mtp_index=1, lr=5e-3)
    t = torch.as_tensor(toks)
    got = [tt.train_step(t) for _ in range(STEPS)]
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= BAR * abs(w), (i, g, w)
    assert got[-1] < got[0], got
    after, before = flatten(tt.params), flatten(tparams)
    trained = {k for k in before if k.startswith("mtp.1.")}
    assert trained
    for k in before:
        if k not in trained:
            assert after[k] is before[k] or torch.equal(after[k],
                                                        before[k]), k
    ref = flatten(jax.tree.map(np.asarray, jt.params))
    for k in trained:
        err = np.max(np.abs(to_np(after[k]) - ref[k]))
        assert err <= BAR * max(np.max(np.abs(ref[k])), 1e-6), k
        assert not torch.equal(after[k], before[k]) or k.endswith("norm"), k


def test_mtp_trainer_lowers_the_draft_loss_in_bf16():
    _, _, _, tcfg, tparams = reference("bfloat16",
                                       config="deepseek-v3-mtp2")
    tt = MTPTrainer(Model(tcfg), tparams, mtp_index=1, lr=5e-3)
    t = torch.as_tensor(tokens(tcfg))
    losses = [tt.train_step(t) for _ in range(STEPS)]
    assert losses[-1] < losses[0], losses
    for k, v in flatten(tt.params["mtp"][1]).items():
        assert v.dtype == flatten(tparams["mtp"][1])[k].dtype, k
