"""The port's optimizer, data pipeline and weight bridge against the JAX
reference on the CPU: ``lr_at`` over warm-up and cosine, ``global_norm``
and three ``adamw_update`` steps (with and without clipping, bf16 and
float32 parameters) within 1e-6 relative; the packed loader's batches
equal to the reference's, token for token; the reference's gradients
and ``AdamWState`` carried across by path."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import data as jax_data
from repro.train import optimizer as jax_opt
from repro_torch.models.weights import (adamw_state_from_jax, flatten,
                                        from_jax_params)
from repro_torch.train import data as torch_data
from repro_torch.train import optimizer as torch_opt
from torch_parity import reference, to_np

BAR = 1e-6


def rel(got, want) -> float:
    got, want = (np.asarray(to_np(a), np.float64) for a in (got, want))
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-30))


@pytest.mark.parametrize("step", [0, 1, 5, 9, 10, 11, 55, 99, 100, 150])
def test_lr_at_matches_reference(step):
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = jax_opt.lr_at(jax_opt.AdamWConfig(**cfg), jnp.int32(step))
    got = torch_opt.lr_at(torch_opt.AdamWConfig(**cfg),
                          torch.tensor(step, dtype=torch.int32))
    assert rel(got, want) <= BAR, (float(got), float(want))


def _tree(seed: int, dtype):
    """A params-like tree: dicts (unsorted keys) and a tuple."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"w": a(4, 6), "blocks": {"z": a(3, 2, 5), "b": a(7)},
            "prefix": ({"q": a(2, 3)}, {"q": a(2, 3)})}
    return (jax.tree.map(lambda x: jnp.asarray(x, dtype), tree),
            jax.tree.map(lambda x: torch.tensor(x).to(
                torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32),
                tree))


@pytest.mark.parametrize("clip", [1.0, 1e3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_steps_match_reference(clip, dtype):
    """Gradients of norm ~10: clipped at ``grad_clip`` 1, untouched at
    1e3; warm-up of 2 steps, then the cosine."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, tp = _tree(0, jdt)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg, tcfg = jax_opt.AdamWConfig(**cfg), torch_opt.AdamWConfig(**cfg)
    js, ts = jax_opt.init_adamw(jp), torch_opt.init_adamw(tp)
    for i in range(3):
        jg, tg = _tree(10 + i, jdt)
        assert rel(torch_opt.global_norm(tg), jax_opt.global_norm(jg)) \
            <= BAR
        jp, js, jm = jax_opt.adamw_update(jcfg, jp, jg, js)
        tp, ts, tm = torch_opt.adamw_update(tcfg, tp, tg, ts)
        assert int(ts.step) == int(js.step) == i + 1
        for k in ("grad_norm", "lr"):
            assert rel(tm[k], jm[k]) <= BAR, (i, k)
        for name, a, b in (("p", tp, jp), ("m", ts.m, js.m),
                           ("v", ts.v, js.v)):
            fa, fb = flatten(a), flatten(jax.tree.map(np.asarray, b))
            for k in fb:
                assert fa[k].dtype == (torch.float32 if name != "p"
                                       else tp["w"].dtype)
                assert rel(fa[k], fb[k]) <= BAR, (i, name, k)
    if clip == 1.0:
        assert float(tm["grad_norm"]) > 1.0


def test_global_norm_reads_leaves_in_the_reference_order():
    _, tp = _tree(3, jnp.float32)
    leaves = [t for t in flatten(tp).values()]
    want = np.sqrt(sum(float(np.sum(np.square(t.numpy().astype(np.float64))))
                       for t in leaves))
    assert rel(torch_opt.global_norm(tp), np.float64(want)) <= BAR


@pytest.mark.parametrize("cfg", [dict(seq_len=64, global_batch=2, seed=3),
                                 dict(seq_len=256, global_batch=8, seed=0),
                                 dict(seq_len=33, global_batch=3, seed=7,
                                      copy_prob=0.9)])
def test_loader_batches_equal_reference(cfg):
    """Five batches token for token (tokens, labels, mask), the
    ``SyntheticCorpus`` documents included."""
    ja = jax_data.PackedLoader(jax_data.DataConfig(**cfg))
    ta = torch_data.PackedLoader(torch_data.DataConfig(**cfg))
    for _ in range(5):
        for x, y in zip(ta.next_batch(), ja.next_batch()):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    jd = jax_data.SyntheticCorpus(jax_data.DataConfig(**cfg)).documents()
    td = torch_data.SyntheticCorpus(torch_data.DataConfig(**cfg)).documents()
    for _ in range(20):
        assert next(td) == next(jd)


def test_reference_grads_and_adamw_state_cross_the_bridge():
    """A gradient tree (the params' dtypes) and an ``AdamWState`` (float32
    moments, int32 step) of the reference land on the port's tree paths
    unchanged; a moment in the params' bf16 dtype is refused."""
    jcfg, jmodel, jparams, tcfg, _ = reference("bfloat16",
                                               config="internlm2")
    grads = jax.tree.map(lambda p: (jnp.ones_like(p) * 0.5).astype(p.dtype),
                         jparams)
    tg = from_jax_params(jax.tree.map(np.asarray, grads), tcfg, "cpu")
    for k, v in flatten(tg).items():
        assert float(v.float().min()) == float(v.float().max()) == 0.5, k
    state = jax_opt.init_adamw(jparams)
    state = state._replace(step=jnp.int32(7), m=jax.tree.map(
        lambda x: x + 1.0, state.m))
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, state), tcfg, "cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 7
    for name, tree in (("m", ts.m), ("v", ts.v)):
        for k, v in flatten(tree).items():
            assert v.dtype == torch.float32, (name, k)
            assert float(v.min()) == float(v.max()) == (
                1.0 if name == "m" else 0.0)
    with pytest.raises(ValueError, match="expected"):
        from_jax_params(jax.tree.map(np.asarray, state.m), tcfg, "cpu")
