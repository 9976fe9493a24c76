"""The port's INT8 package (§4.7) against ``repro.quant`` on the same numpy
inputs: weight and activation quantization and the W8A8 linear
bit-identical in float32, SmoothQuant's scales within 2 ulp (the
reference's square root is not correctly rounded) and all that follows
them exactly; GPTQ with identical scales and
int8 values; the INT8 KV cache and INT8 attention scores exact; and the
pipeline as a whole on the smoke DeepSeek-V3's own layer-0 weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro.quant.int8 import quantization_error as jax_qerr
from repro.quant.kvcache_quant import quantize_kv_entry as jax_kv_entry
from repro_torch import quant as tq
from repro_torch.models.common import rms_norm
from repro_torch.quant.int8 import quantization_error
from repro_torch.quant.kvcache_quant import quantize_kv_entry
from torch_parity import reference, to_np


def _eq(got, want, what=""):
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=what)


def _arr(seed, shape, scale=1.0, outlier=None):
    x = np.random.default_rng(seed).standard_normal(shape) * scale
    if outlier is not None:           # a §4.7 activation outlier channel
        x[..., outlier] *= 50.0
    return x.astype(np.float32)


def _both(x, dtype="float32"):
    return (jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16"
                        else jnp.float32),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _tq(jt):
    """The port's QTensor of a JAX QTensor's arrays."""
    return tq.QTensor(torch.from_numpy(np.asarray(jt.values)),
                      torch.from_numpy(np.asarray(jt.scale)))


def _calib(seed=0, n=256, d_in=64, d_out=48):
    return _arr(seed, (n, d_in), outlier=3), _arr(seed + 1, (d_in, d_out),
                                                  0.1)


# ---------------------------------------------------------------------------
# int8.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((64, 48), -1), ((48, 64), 0),
                                        ((3, 16, 24), -1), ((5,), 0)])
def test_quantize_weight_channelwise_matches_jax(dtype, shape, axis):
    """A 3-D expert weight shares one scale per output channel across
    experts, as the reference reduces every axis but ``axis``."""
    jw, tw = _both(_arr(sum(shape), shape, 0.1), dtype)
    want = jq.quantize_weight_channelwise(jw, axis)
    got = tq.quantize_weight_channelwise(tw, axis)
    assert got.values.dtype == torch.int8 and got.shape == tw.shape
    _eq(got.values, want.values, "values")
    _eq(got.scale, want.scale, "scale")
    if axis % len(shape) == len(shape) - 1:    # dequantize scales the last
        _eq(got.dequantize(), want.dequantize(), "dequantize")
        np.testing.assert_allclose(quantization_error(tw, got),
                                   jax_qerr(jw, want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 64), (2, 5, 64), (37, 7168)])
def test_quantize_act_tokenwise_matches_jax(dtype, shape):
    jx, tx = _both(_arr(len(shape), shape, outlier=7), dtype)
    q, s = tq.quantize_act_tokenwise(tx)
    wq, ws = jq.quantize_act_tokenwise(jx)
    assert q.shape == tx.shape and s.shape == tx.shape[:-1]
    _eq(q, wq, "values")
    _eq(s, ws, "scales")


@pytest.mark.parametrize("x_shape,w_shape", [((256, 64), (64, 48)),
                                             ((2, 8, 64), (64, 48)),
                                             ((37, 7168), (7168, 576))])
def test_quantized_linear_matches_jax(x_shape, w_shape):
    """The W8A8 linear, DeepSeek-V3's ``wkv_a`` width included:
    bit-identical in float32."""
    jx, tx = _both(_arr(1, x_shape, outlier=7))
    jw, tw = _both(_arr(2, w_shape, 0.05))
    jqw = jq.quantize_weight_channelwise(jw)
    tqw = tq.quantize_weight_channelwise(tw)
    got = tq.quantized_linear(tx, tqw)
    assert got.dtype == torch.float32 and got.shape == x_shape[:-1] + (
        w_shape[1],)
    _eq(got, jq.quantized_linear(jx, jqw))
    # the port's weight format read from the reference's arrays
    _eq(tq.quantized_linear(tx, _tq(jqw)), got)
    xq, xs = tq.quantize_act_tokenwise(tx.reshape(-1, x_shape[-1]))
    _eq(tq.int8_matmul_ref(xq, xs, tqw).reshape(got.shape), got)


# ---------------------------------------------------------------------------
# smoothquant.py
# ---------------------------------------------------------------------------
def _hold_smoothing(tx, tw, jx, jw, what=""):
    """SmoothQuant against the reference: the scales s within 2 ulp, and
    everything after s exactly. The reference's ``x ** 0.5`` is glibc's
    ``powf`` when JAX runs op by op and a sqrt/rsqrt rewrite under jit,
    each a last bit off the correctly rounded square root in some values;
    PyTorch's ``x ** 0.5`` is the correctly rounded square root."""
    jws, js = jq.smooth_quant_pair(jx, jw)
    tws, ts = tq.smooth_quant_pair(tx, tw)
    _eq(tq.calibrate_act_amax(tx), jq.calibrate_act_amax(jx), what + "amax")
    np.testing.assert_array_max_ulp(to_np(ts), to_np(js), maxulp=2)
    s_ref = torch.from_numpy(np.asarray(js))
    _eq(tq.apply_smoothing(tw, s_ref), jws, what + "smoothed weight")
    got = tq.quantized_linear(tx / s_ref[None], tq.quantize_weight_channelwise(
        tq.apply_smoothing(tw, s_ref)))
    want = jq.quantized_linear(jx / js[None],
                               jq.quantize_weight_channelwise(jws))
    _eq(got, want, what + "smoothed W8A8 linear")
    return tws, ts


def test_smooth_quant_pair_matches_jax():
    x, w = _calib()
    (jx, tx), (jw, tw) = _both(x), _both(w)
    _, ts = _hold_smoothing(tx, tw, jx, jw)
    # a bf16 weight is smoothed in f32 and rounded back to bf16
    jwb, twb = _both(w, "bfloat16")
    s_ref = jq.smoothing_scales(jq.calibrate_act_amax(jx), jwb)
    got = tq.apply_smoothing(twb, torch.from_numpy(np.asarray(s_ref)))
    assert got.dtype == torch.bfloat16
    _eq(got, jq.apply_smoothing(jwb, s_ref))


def test_smoothquant_tames_outliers():
    x, w = _calib()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = tx @ tw
    plain = tq.quantized_linear(tx, tq.quantize_weight_channelwise(tw))
    ws, s = tq.smooth_quant_pair(tx, tw)
    smooth = tq.quantized_linear(tx / s[None], tq.quantize_weight_channelwise(
        ws))

    def rel(a):
        return float(torch.linalg.norm(a - y) / torch.linalg.norm(y))
    assert rel(smooth) < rel(plain) * 0.5, (rel(smooth), rel(plain))


# ---------------------------------------------------------------------------
# gptq.py
# ---------------------------------------------------------------------------
def test_hessian_matches_jax():
    x, _ = _calib()
    want = jq.hessian_from_calibration(jnp.asarray(x))
    got = tq.hessian_from_calibration(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("with_hessian", [True, False])
def test_gptq_matches_jax(with_hessian):
    """Scales identical; int8 values identical (a last-bit difference of
    the float64 linear algebra could move a value across a rounding
    boundary: that would be held to |Δq| ≤ 1 on ≤ 0.1% of entries)."""
    x, w = _calib(3, 128, 64, 40)
    jh = jq.hessian_from_calibration(jnp.asarray(x)) if with_hessian else None
    th = (tq.hessian_from_calibration(torch.from_numpy(x)) if with_hessian
          else None)
    jqw, jrel = jq.gptq_quantize(jnp.asarray(w), jh)
    tqw, trel = tq.gptq_quantize(torch.from_numpy(w), th)
    assert tqw.values.dtype == torch.int8
    _eq(tqw.scale, jqw.scale, "scales")
    dq = np.abs(to_np(tqw.values).astype(int)
                - np.asarray(jqw.values).astype(int))
    assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3, dq.sum()
    np.testing.assert_allclose(trel, jrel, rtol=1e-9)
    if not with_hessian:       # H = I: GPTQ is naive rounding
        _eq(tqw.values, tq.quantize_weight_channelwise(
            torch.from_numpy(w)).values)


def test_gptq_beats_naive_on_output_error():
    x, w = _calib(5, 256, 64, 48)
    tx, tw = torch.from_numpy(x).double(), torch.from_numpy(w).double()
    qg, _ = tq.gptq_quantize(tw.float(), tq.hessian_from_calibration(tx))
    qn = tq.quantize_weight_channelwise(tw.float())
    y = tx @ tw

    def err(q):
        yq = tx @ q.dequantize().double()
        return float(torch.linalg.norm(yq - y) / torch.linalg.norm(y))
    assert err(qg) < err(qn)


def test_calibrate_moe_matches_jax():
    """Expert 5 has no sample and takes the seeded draw of the reference."""
    assign = np.array([0, 1, 1, 2, 3, 0, 4, 4, 4, 6, 6, 7, 1, 2])
    samples = _arr(9, (len(assign), 8))
    want = jq.calibrate_moe(jnp.asarray(samples), jnp.asarray(assign), 8, 4)
    got = tq.calibrate_moe(torch.from_numpy(samples),
                           torch.from_numpy(assign), 8, 4)
    assert got.shape == (8, 4)
    _eq(got, want)


# ---------------------------------------------------------------------------
# kvcache_quant.py
# ---------------------------------------------------------------------------
def test_kv_entry_matches_jax():
    jx, tx = _both(_arr(11, (2, 16, 4, 32)), "bfloat16")
    q, s = quantize_kv_entry(tx)
    wq, ws = jax_kv_entry(jx)
    _eq(q, wq, "values")
    _eq(s, ws, "scales")


def test_mla_cache_round_trip_matches_jax():
    cache = {"ckv": _arr(12, (2, 64, 32)), "krope": _arr(13, (2, 64, 16))}
    jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v).bfloat16() for k, v in cache.items()}
    jqc, tqc = jq.quantize_mla_cache(jc), tq.quantize_mla_cache(tc)
    assert tqc["ckv_q"].dtype == torch.int8
    assert tqc["krope"] is tc["krope"]          # RoPE part untouched
    for k in ("ckv_q", "ckv_scale", "krope"):
        _eq(tqc[k], jqc[k], k)
    back, jback = tq.dequantize_mla_cache(tqc), jq.dequantize_mla_cache(jqc)
    assert back["ckv"].dtype == torch.bfloat16
    _eq(back["ckv"], jback["ckv"])
    err = float((back["ckv"].float() - tc["ckv"].float()).abs().max())
    assert err < 0.05
    assert tq.memory_saving(2 * 64 * 32 * 2) == jq.memory_saving(
        2 * 64 * 32 * 2)


def test_gqa_cache_round_trip_matches_jax():
    cache = {"k": _arr(14, (2, 16, 4, 32)), "v": _arr(15, (2, 16, 4, 32))}
    jc = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v).bfloat16() for k, v in cache.items()}
    jqc, tqc = jq.quantize_gqa_cache(jc), tq.quantize_gqa_cache(tc)
    assert sorted(tqc) == sorted(jqc)
    for k in tqc:
        _eq(tqc[k], jqc[k], k)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        back = tq.dequantize_gqa_cache(tqc, dtype)
        jback = jq.dequantize_gqa_cache(jqc, jdt)
        for k in ("k", "v"):
            assert back[k].dtype == dtype
            _eq(back[k], jback[k], k)


def test_int8_attention_scores_match_jax():
    """q per row, k per (batch row, head) over all positions: the scale
    shapes the reference's broadcast takes."""
    B, L, H, d = 2, 16, 4, 32
    q = _arr(16, (B, H, d))
    k = _arr(17, (B, L, H, d))
    jq_, jqs = jax_kv_entry(jnp.asarray(q))
    kh = np.ascontiguousarray(k.transpose(0, 2, 1, 3)).reshape(B, H, L * d)
    jkh, jks = jax_kv_entry(jnp.asarray(kh))
    jk = jnp.asarray(np.asarray(jkh).reshape(B, H, L, d).transpose(0, 2, 1, 3))
    want = jq.int8_attention_scores(jq_, jqs, jk, jks)
    tq_, tqs = quantize_kv_entry(torch.from_numpy(q))
    tkh, tks = quantize_kv_entry(torch.from_numpy(kh))
    tk = tkh.reshape(B, H, L, d).permute(0, 2, 1, 3)
    got = tq.int8_attention_scores(tq_, tqs, tk, tks)
    assert got.shape == (B, H, L) and got.dtype == torch.float32
    _eq(got, want)


# ---------------------------------------------------------------------------
# the slice as a whole, on the smoke DeepSeek-V3's own weights
# ---------------------------------------------------------------------------
def test_int8_pipeline_on_smoke_deepseek_matches_jax():
    """Calibration from the rms-normed embeddings of a token sequence;
    layer 0's ``wq_a`` and ``wkv_a`` go through SmoothQuant, channel-wise
    quantization and the W8A8 linear (bit-identical to the reference;
    SmoothQuant's scales within 2 ulp, as ``_hold_smoothing`` says), and
    GPTQ (scales identical, values as in ``test_gptq_matches_jax``)."""
    jcfg, _, params, tcfg, tparams = reference("float32")
    tokens = np.random.default_rng(21).integers(0, tcfg.vocab_size, 64)
    layer = tparams["prefix"][0]
    x = rms_norm(tparams["embed"][torch.from_numpy(tokens)],
                 layer["mixer_norm"], tcfg.norm_eps)
    jx = jnp.asarray(x.numpy())
    for name in ("wq_a", "wkv_a"):
        w = layer["mixer"][name]
        jw = jnp.asarray(np.asarray(params["prefix"][0]["mixer"][name]))
        _eq(w, jw, f"{name} carried across")
        _hold_smoothing(x, w, jx, jw, f"{name} ")
        _eq(tq.quantized_linear(x, tq.quantize_weight_channelwise(w)),
            jq.quantized_linear(jx, jq.quantize_weight_channelwise(jw)),
            f"{name} W8A8")
        jg, _ = jq.gptq_quantize(jw, jq.hessian_from_calibration(jx))
        tg, _ = tq.gptq_quantize(w, tq.hessian_from_calibration(x))
        _eq(tg.scale, jg.scale, f"{name} gptq scales")
        dq = np.abs(to_np(tg.values).astype(int)
                    - np.asarray(jg.values).astype(int))
        assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3, (name, dq.sum())
