"""The INT8 path's kernels — quant-dispatch, INT8 matmul and EPLB
Collect: the port's plain versions against the JAX Pallas kernels in
interpret mode and against the JAX refs, exactly, at the shapes of
``tests/test_kernels.py`` plus DeepSeek-V3-width cases; the wrappers'
device rules and argument checks; and the MoE layer's Collect counts
against the reference's on the smoke DeepSeek-V3 and Llama-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collect.ops import expert_counts as jax_counts
from repro.kernels.collect.ref import collect_ref as jax_collect_ref
from repro.kernels.int8_matmul.ops import quantized_matmul as jax_qmm
from repro.kernels.int8_matmul.ref import int8_matmul_ref as jax_mm_ref
from repro.kernels.quant_dispatch.ops import fused_quantize as jax_fq
from repro.kernels.quant_dispatch.ref import quant_dispatch_ref as jax_qd_ref
from repro.models import ffn as jffn
from repro_torch.configs.base import MOE
from repro_torch.kernels.collect.kernel import collect_cuda
from repro_torch.kernels.collect.ops import expert_counts
from repro_torch.kernels.collect.ref import collect_ref
from repro_torch.kernels.int8_matmul.kernel import MAX_K, int8_matmul_cuda
from repro_torch.kernels.int8_matmul.ops import quantized_matmul
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
from repro_torch.kernels.quant_dispatch.ops import fused_quantize
from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref
from repro_torch.models import ffn as tffn
from torch_parity import auto_ctx, reference, to_np


def _eq(got, want, what=""):
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=what)


# ---------------------------------------------------------------------------
# quant_dispatch
# ---------------------------------------------------------------------------
def _rows(seed, T, d, outlier=False):
    x = np.random.default_rng(seed).standard_normal((T, d)) * 3
    if outlier:                       # the §4.7 activation outlier channel
        x[:, 7] *= 60.0
    return x.astype(np.float32)


def _hold_quant(x: np.ndarray, dtype: str):
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = quant_dispatch_ref(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    jq, js = jax_qd_ref(jx)
    _eq(q, jq, "ref values")
    _eq(s, js, "ref scales")
    # Under jit, XLA turns the reference's ``/ 127.0`` into a multiply by
    # 1/127, so the Pallas kernel's scale (and the jitted ref's) is
    # amax * f32(1/127): one ulp off the true divide in a few rows, where
    # a quotient may then round the other way. The port keeps the true
    # divide of the eager formula. Held exactly: the Pallas scale is that
    # product, and the port's rounding of x by the Pallas scale gives the
    # Pallas values; rows with equal scales have equal values.
    pq, ps = jax_fq(jx, use_pallas=True, interpret=True)
    amax = np.maximum(np.abs(to_np(tx)).max(axis=-1), np.float32(1e-8))
    _eq(ps, amax * np.float32(1 / 127), "pallas scales: reciprocal")
    np.testing.assert_array_max_ulp(to_np(s), to_np(ps), maxulp=1)
    by_ps = torch.clamp(torch.round(tx.float() / torch.from_numpy(
        np.asarray(ps))[:, None]), -127, 127).to(torch.int8)
    _eq(by_ps, pq, "pallas values from the pallas scales")
    same = torch.from_numpy(np.asarray(ps) == to_np(s))
    _eq(q[same], to_np(pq)[same.numpy()], "pallas values, equal scales")
    return q, s


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,outlier", [(64, 128, False), (100, 256, False),
                                         (1000, 64, False), (7, 32, False),
                                         (37, 7168, True), (4, 300, True)])
def test_quant_dispatch_matches_jax(dtype, T, d, outlier):
    _hold_quant(_rows(T * 7 + d, T, d, outlier), dtype)


def test_quant_dispatch_zero_row_and_half_quotients():
    """An all-zero row gives scale 1e-8/127 and zeros; a row with amax
    127 has scale 1 exactly, so its .5 values round half to even."""
    x = np.zeros((3, 8), np.float32)
    x[1] = [127, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]
    x[2, 3] = -1e-30
    q, s = _hold_quant(x, "float32")
    assert torch.equal(q[0], torch.zeros(8, dtype=torch.int8))
    assert float(s[0]) == np.float32(np.float32(1e-8) / np.float32(127))
    assert float(s[1]) == 1.0
    assert q[1].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


# ---------------------------------------------------------------------------
# int8_matmul
# ---------------------------------------------------------------------------
def _mm_inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (m, k)).astype(np.int8),
            (rng.random(m) + 0.1).astype(np.float32),
            rng.integers(-127, 128, (k, n)).astype(np.int8),
            (rng.random(n) + 0.1).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (100, 300, 50),
                                   (8, 128, 128), (256, 1024, 512),
                                   (1, 64, 17), (37, 7168, 576)])
def test_int8_matmul_matches_jax(m, k, n):
    args = _mm_inputs(m + k + n, m, k, n)
    got = int8_matmul_ref(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    jargs = tuple(map(jnp.asarray, args))
    _eq(got, jax_qmm(*jargs, use_pallas=True, interpret=True), "pallas")
    _eq(got, jax_mm_ref(*jargs), "ref")


def test_int8_matmul_sums_are_exact_at_the_extremes():
    """Every product at ±127² over K 4096: the float64 sum is the exact
    integer the int32 accumulator holds."""
    k = 4096
    x = np.full((2, k), 127, np.int8)
    x[1] = -127
    w = np.full((k, 3), 127, np.int8)
    got = int8_matmul_ref(torch.from_numpy(x), torch.ones(2),
                          torch.from_numpy(w), torch.ones(3))
    assert got[:, 0].tolist() == [127 * 127 * k, -127 * 127 * k]


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N,E", [(512, 16), (1000, 64), (4096, 256), (5, 8),
                                 (32, 256), (826, 128)])
def test_collect_matches_jax(N, E):
    """Ids of -1 and at or above E mixed in: both count nowhere."""
    rng = np.random.default_rng(N + E)
    ids = rng.integers(-1, E, N).astype(np.int32)
    ids[rng.random(N) < 0.1] = E + rng.integers(0, 3 * E, 1)[0]
    want = jax_collect_ref(jnp.asarray(ids), E)
    _eq(jax_counts(jnp.asarray(ids), n_experts=E, use_pallas=True,
                   interpret=True), want, "pallas vs jax ref")
    for dt in (torch.int32, torch.int64):
        got = collect_ref(torch.from_numpy(ids).to(dt), E)
        assert got.dtype == torch.int32 and got.shape == (E,)
        _eq(got, want, str(dt))
    assert int(got.sum()) == int(((ids >= 0) & (ids < E)).sum())


# ---------------------------------------------------------------------------
# the entry points and the CUDA wrappers' checks
# ---------------------------------------------------------------------------
def test_entry_points_take_the_plain_version_on_the_cpu():
    x = torch.from_numpy(_rows(3, 5, 40))
    for a, b in zip(fused_quantize(x), quant_dispatch_ref(x)):
        assert torch.equal(a, b)
    args = tuple(map(torch.from_numpy, _mm_inputs(4, 5, 48, 24)))
    assert torch.equal(quantized_matmul(*args), int8_matmul_ref(*args))
    ids = torch.tensor([0, 3, 3, -1, 9, 2])
    assert expert_counts(ids, n_experts=4).tolist() == [1, 0, 1, 2]


def test_entry_points_refuse_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fused_quantize(torch.zeros((2, 4), **meta))
    i8 = dict(dtype=torch.int8, **meta)
    with pytest.raises(ValueError, match="no kernel"):
        quantized_matmul(torch.zeros((2, 4), **i8), torch.zeros(2, **meta),
                         torch.zeros((4, 3), **i8), torch.zeros(3, **meta))
    with pytest.raises(ValueError, match="no kernel"):
        expert_counts(torch.zeros(4, dtype=torch.int32, **meta), n_experts=2)


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_arguments():
    """The wrappers check types and shapes first, then that every tensor
    lies on the card: a CPU tensor never reaches a kernel."""
    with pytest.raises(ValueError, match="CUDA device"):
        quant_dispatch_cuda(torch.zeros((2, 4)))
    with pytest.raises(TypeError):
        quant_dispatch_cuda(torch.zeros((2, 4), dtype=torch.float16))
    with pytest.raises(ValueError):
        quant_dispatch_cuda(torch.zeros((2, 0)))
    args = list(map(torch.from_numpy, _mm_inputs(1, 3, 32, 8)))
    args[2] = args[2].t().contiguous().t()      # the K-major weight
    with pytest.raises(ValueError, match="CUDA device"):
        int8_matmul_cuda(*args)
    with pytest.raises(TypeError):
        int8_matmul_cuda(args[0].int(), *args[1:])
    with pytest.raises(ValueError, match="shapes"):
        int8_matmul_cuda(args[0], args[1][:2], *args[2:])
    with pytest.raises(ValueError, match="overflow"):
        int8_matmul_cuda(torch.zeros((1, MAX_K + 1), dtype=torch.int8),
                         torch.ones(1),
                         torch.zeros((MAX_K + 1, 1), dtype=torch.int8),
                         torch.ones(1))
    with pytest.raises(ValueError, match="CUDA device"):
        collect_cuda(torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(TypeError):
        collect_cuda(torch.zeros(4), 8)
    with pytest.raises(ValueError):
        collect_cuda(torch.zeros(4, dtype=torch.int32), 0)


# ---------------------------------------------------------------------------
# the MoE layer's counts: route-pack's Collect block, fed to _aux_stats
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("config", ["deepseek-v3", "llama4-gqa"])
@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_moe_expert_counts_match_the_reference(config, mode):
    """The port's ``expert_counts`` aux (from the pack's Collect) equals
    the reference's one-hot sum on each smoke model's MoE layer, as
    float32, with the load-balance loss built from it."""
    jcfg, _, params, tcfg, tparams = reference("float32", config=config)
    pos = f"pos{[f for _, f in tcfg.layer_pattern].index(MOE)}"
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"][pos]["ffn"])
    tp = {k: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in tparams["blocks"][pos]["ffn"].items()}
    shape = (4, 1) if mode == "decode" else (2, 16)
    x = np.random.default_rng(5).standard_normal(
        shape + (tcfg.d_model,)).astype(np.float32)
    _, jaux = jax.jit(lambda p, x: jffn.moe_apply(
        p, x, cfg=jcfg, ctx=auto_ctx(), mode=mode))(jp, jnp.asarray(x))
    _, taux = tffn.moe_apply(tp, torch.from_numpy(x), cfg=tcfg, mode=mode)
    counts = taux["expert_counts"]
    assert counts.dtype == torch.float32
    _eq(counts, jaux["expert_counts"])
    assert float(counts.sum()) == np.prod(shape) * tcfg.moe.top_k
    np.testing.assert_allclose(to_np(taux["moe_lb_loss"]),
                               to_np(jaux["moe_lb_loss"]), rtol=2e-6)
