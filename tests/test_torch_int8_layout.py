"""INT8 weights are stored K-major: ``QTensor.values`` is the [in, out]
view of an [out, in] row-major tensor (stacked expert weights: of
[E, out, in]), whichever producer made it. Values, ``dequantize()`` and
the W8A8 linear stay those of the reference; the CUDA wrapper refuses
any other layout with a message that names it; and the INT8-matmul
launch plan sums every k exactly once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro_torch import quant as tq
from repro_torch.kernels.int8_matmul.kernel import (DECODE_MAX_M,
                                                    int8_matmul_cuda, k_ranges,
                                                    plan)
from torch_parity import to_np


def _eq(got, want, what=""):
    np.testing.assert_array_equal(to_np(got), to_np(want), err_msg=what)


def _w(seed, shape, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _k_major(v: torch.Tensor) -> bool:
    """values [..., in, out] with ``in`` contiguous, outer axes dense."""
    return v.transpose(-1, -2).is_contiguous()


def _producers():
    w2, w3 = _w(1, (96, 40)), _w(2, (3, 64, 24))
    x = _w(3, (128, 96), 1.0)
    return {
        "channelwise 2-D": lambda: (tq.quantize_weight_channelwise(
            torch.from_numpy(w2)), jq.quantize_weight_channelwise(
            jnp.asarray(w2))),
        "channelwise 3-D experts": lambda: (tq.quantize_weight_channelwise(
            torch.from_numpy(w3)), jq.quantize_weight_channelwise(
            jnp.asarray(w3))),
        "gptq": lambda: (tq.gptq_quantize(
            torch.from_numpy(w2),
            tq.hessian_from_calibration(torch.from_numpy(x)))[0],
            jq.gptq_quantize(jnp.asarray(w2), jq.hessian_from_calibration(
                jnp.asarray(x)))[0]),
    }


@pytest.mark.parametrize("name", list(_producers()))
def test_producers_store_k_major_with_the_reference_values(name):
    """Shape, int8 values and dequantized weights as the reference's,
    in the K-major layout. GPTQ's values may differ from the reference's
    by one step in a few entries (float64 rounding, as
    ``test_torch_quant.py`` allows); its scales are identical."""
    got, want = _producers()[name]()
    assert got.values.dtype == torch.int8
    assert tuple(got.values.shape) == tuple(want.values.shape)
    assert _k_major(got.values), got.values.stride()
    _eq(got.scale, want.scale, "scale")
    if name == "gptq":
        dq = np.abs(to_np(got.values).astype(int)
                    - np.asarray(want.values).astype(int))
        assert dq.max() <= 1 and (dq > 0).mean() <= 1e-3
    else:
        _eq(got.values, want.values, "values")
        _eq(got.dequantize(), want.dequantize(), "dequantize")


@pytest.mark.parametrize("shape", [(12, 5), (2, 12, 5), (1, 7), (7, 1)])
def test_direct_construction_makes_a_row_major_weight_k_major(shape):
    """A row-major int8 array given to ``QTensor`` is stored K-major with
    its values unchanged; one already K-major is kept as it is, without
    a copy."""
    q = torch.from_numpy(np.random.default_rng(0).integers(
        -127, 128, shape).astype(np.int8))
    scale = torch.rand(shape[-1]) + 0.1
    qt = tq.QTensor(q, scale)
    assert _k_major(qt.values) and torch.equal(qt.values, q)
    assert torch.equal(qt.dequantize(), q.float() * scale)
    again = tq.QTensor(qt.values, scale)
    assert again.values.data_ptr() == qt.values.data_ptr()


@pytest.mark.parametrize("M", [1, 5, 37])
def test_quantized_linear_on_the_k_major_weight_matches_jax(M):
    """The W8A8 linear on the K-major weight is bit-identical to the
    reference's on its row-major one (the CPU runs the plain version)."""
    w, x = _w(4, (96, 40)), _w(5 + M, (M, 96), 1.0)
    got = tq.quantized_linear(torch.from_numpy(x),
                              tq.quantize_weight_channelwise(
                                  torch.from_numpy(w)))
    want = jq.quantized_linear(jnp.asarray(x), jq.quantize_weight_channelwise(
        jnp.asarray(w)))
    assert got.dtype == torch.float32
    _eq(got, want)


def test_int8_matmul_cuda_refuses_a_row_major_weight():
    """Checked before the device, so a CPU test sees it: a row-major
    [K, N] weight would need a copy of the whole weight on every call."""
    xq = torch.zeros((4, 32), dtype=torch.int8)
    row_major = torch.zeros((32, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="K-major"):
        int8_matmul_cuda(xq, torch.ones(4), row_major, torch.ones(16))
    k_major = torch.zeros((16, 32), dtype=torch.int8).t()
    with pytest.raises(ValueError, match="CUDA device"):
        int8_matmul_cuda(xq, torch.ones(4), k_major, torch.ones(16))


@pytest.mark.parametrize("N", [18432, 17])
@pytest.mark.parametrize("K", [7168, 300, 64])
@pytest.mark.parametrize("M", [4, 37])
def test_split_plan_covers_every_k_exactly_once(M, K, N):
    """The splits of K are consecutive, non-empty, whole 128-deep tiles
    but the last, and together [0, K); the variant follows the shape; a
    split K leaves every SM two blocks where K has the tiles for it."""
    for n_sms in (132, 114):
        p = plan(M, K, N, n_sms)
        ranges = k_ranges(p, K)
        assert len(ranges) == p.n_split >= 1
        covered = np.zeros(K, int)
        for k0, k1 in ranges:
            assert k0 < k1 and k0 % 128 == 0
            covered[k0:k1] += 1
        assert (covered == 1).all(), (p, ranges)
        assert [r[0] for r in ranges[1:]] == [r[1] for r in ranges[:-1]]
        assert p.path == ("ragged" if K % 16 else "decode")
        if p.path == "decode":
            assert p.nb == (8 if M <= 8 else 64)
            n_tiles = -(-N // 64)
            if p.n_split > 1:
                assert n_tiles < 2 * n_sms
                assert (n_tiles * p.n_split >= 2 * n_sms
                        or p.chunk == 1), p


def test_plan_picks_the_wide_tile_by_waves():
    """M above the decode variant's limit takes 128-row tiles, the width
    whose waves of one tile per SM take least time; an unaligned base
    takes the ragged variant at any shape."""
    assert plan(512, 7168, 18432, 132) == ("wide", 192, 56, 1)
    assert plan(DECODE_MAX_M + 1, 7168, 1536, 132).path == "wide"
    assert plan(DECODE_MAX_M, 7168, 18432, 132).path == "decode"
    assert plan(4, 7168, 18432, 132, aligned=False).path == "ragged"
