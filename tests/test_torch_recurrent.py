"""The recurrent mixers of the port (``models/rglru.py``, the RG-LRU
block of RecurrentGemma; ``models/ssm.py``, the Mamba-2 SSD block)
against the JAX reference's, on the smoke configurations' widths with
the reference's own weights (one layer's, carried over as numpy) and
inputs made with numpy from a seed.

Prefill at S below the SSD chunk (20) and at a multiple of it (64), then
decode steps from that cache: the outputs, the float32 state and the
conv history within 1e-5 relative in float32 and 3e-2 in bf16. The
RG-LRU prefill runs a log-depth scan of another tree than
``jax.lax.associative_scan``'s, so it is held within float rounding,
not bit for bit; ``linear_scan`` itself is held to the sequential
recurrence in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro.models import ssm as JS
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.common import linear_scan
from repro_torch.models.weights import _to_torch
from torch_parity import auto_ctx, configs, rel_err

BAR = {"float32": 1e-5, "bfloat16": 3e-2}
MODULES = {"rglru": ("recurrentgemma", JR.rglru_init, JR.rglru_apply,
                     TR.rglru_apply),
           "ssm": ("mamba2", JS.ssm_init, JS.ssm_apply, TS.ssm_apply)}


def _layer(kind, dtype):
    config, init, japply, tapply = MODULES[kind]
    jcfg, tcfg = configs(dtype, config=config)
    jp = init(jax.random.PRNGKey(3), jcfg, jnp.dtype(dtype))
    tp = {n: _to_torch(np.asarray(a)) for n, a in jp.items()}
    return jcfg, tcfg, jp, tp, japply, tapply


def _x(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [20, 64])
@pytest.mark.parametrize("kind", ["rglru", "ssm"])
def test_prefill_then_decode_matches_reference(kind, S, dtype):
    jcfg, tcfg, jp, tp, japply, tapply = _layer(kind, dtype)
    if kind == "ssm":
        assert tcfg.ssm.chunk_size == 32 and (S < 32 or S % 32 == 0)
    ctx, bar = auto_ctx(), BAR[dtype]
    jx, tx = _x((2, S, tcfg.d_model), dtype, S)
    jy, jc = japply(jp, jx, cfg=jcfg, ctx=ctx, mode="prefill")
    with torch.no_grad():
        ty, tc = tapply(tp, tx, cfg=tcfg, mode="prefill")
    assert ty.dtype == tx.dtype and tc["state"].dtype == torch.float32
    assert rel_err(ty, jy) <= bar
    for n in ("state", "conv"):
        assert tuple(tc[n].shape) == jc[n].shape
        assert rel_err(tc[n], jc[n]) <= bar, n
    for step in range(3):
        jx, tx = _x((2, 1, tcfg.d_model), dtype, 100 + step)
        jy, jc = japply(jp, jx, cfg=jcfg, ctx=ctx, mode="decode", cache=jc)
        before = tc["state"]
        with torch.no_grad():
            ty, tc2 = tapply(tp, tx, cfg=tcfg, mode="decode", cache=tc)
        assert tc2 is tc and tc["state"] is before      # written in place
        assert rel_err(ty, jy) <= bar, step
        for n in ("state", "conv"):
            assert rel_err(tc[n], jc[n]) <= bar, (step, n)


@pytest.mark.parametrize("kind", ["rglru", "ssm"])
def test_cache_spec_matches_reference(kind):
    config = MODULES[kind][0]
    jcfg, tcfg = configs("bfloat16", config=config)
    jspec = (JR.rglru_cache_spec if kind == "rglru"
             else JS.ssm_cache_spec)(jcfg, 3, jnp.bfloat16)
    tspec = (TR.rglru_cache_spec if kind == "rglru"
             else TS.ssm_cache_spec)(tcfg, 3, torch.bfloat16)
    assert {n: (s, str(dt).removeprefix("torch.")) for n, (s, dt)
            in tspec.items()} == {n: (a.shape, str(a.dtype))
                                  for n, a in jspec.items()}


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_is_the_recurrence(S):
    rng = np.random.default_rng(S)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, S, 3)))
    b = torch.from_numpy(rng.standard_normal((2, S, 3)))
    h, want = torch.zeros(2, 3, dtype=torch.float64), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = linear_scan(a, b, dim=1)
    assert torch.allclose(got, torch.stack(want, dim=1), rtol=1e-12,
                          atol=1e-12)


def test_ssd_refuses_a_length_off_the_chunk():
    _, tcfg, _, tp, _, _ = _layer("ssm", "float32")
    with pytest.raises(AssertionError, match="divisible"):
        TS.ssm_apply(tp, torch.zeros((1, 40, tcfg.d_model)), cfg=tcfg,
                     mode="prefill")
