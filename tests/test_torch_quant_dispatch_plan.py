"""Quant-dispatch's launch plan (``quant_dispatch/kernel.py::plan``) at
every shape the INT8 path quantizes and at ragged ones: by the kernel's
own index arithmetic (``covered``) every value of every row is written
exactly once; the cluster size is 1-8 and divides the blocks of a row;
vector loads only for whole 8-value units at a 16-byte aligned base; at
decode (M 4) one call spreads over more than 4 SMs. And the plain version
against the JAX package's ``quant_dispatch_ref`` at the path's widths, in
bf16 and f32, exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_dispatch.ref import quant_dispatch_ref as jax_ref
from repro_torch.kernels.quant_dispatch import kernel as K
from repro_torch.kernels.quant_dispatch.ref import quant_dispatch_ref
from torch_parity import to_np

H100_SMS = 132
#: the activations' widths (q_lora_rank, d_model, d_ff of DeepSeek-V3) at
#: the INT8 stage's M, and the caches' rows: MLA latents (4 x 256 slots
#: of 512) and GQA heads (4 x 1024 slots x 8 heads of 128), and one head's
#: whole cache as one row (the INT8 scores' k scale, [32, 1024 * 128])
PATH = ([(M, d) for M in (4, 37, 64, 512) for d in (1536, 7168, 18432)]
        + [(1024, 512), (32768, 128), (32, 131072)])
RAGGED = [(3, 300), (7, 32), (5, 1000), (4, 7170), (1, 8), (2, 24),
          (9, 576), (3, 600000)]


@pytest.mark.parametrize("T,d", PATH + RAGGED)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_value_once(T, d, aligned):
    p = K.plan(T, d, H100_SMS, aligned=aligned)
    n = K.covered(p, T, d)
    assert bool((n == 1).all()), (p, int(n.min()), int(n.max()))
    assert 1 <= p.cluster <= K.MAX_CLUSTER
    assert p.blocks % p.cluster == 0
    assert (p.path == "cluster") == (p.cluster > 1)
    if p.path in ("block", "cluster"):
        assert p.blocks == T * p.cluster            # CS blocks per row
        assert p.per * p.cluster >= d // 8 and p.group * p.vec >= p.per
        assert p.group % 32 == 0 and p.group <= K.MAX_GROUP[p.vec]
    if p.vec:                                       # 16-byte loads
        assert d % 8 == 0 and aligned
    else:
        assert p.path == "scalar"
    if d % 8 or not aligned:
        assert p.path == "scalar"


@pytest.mark.parametrize("cluster", [1, 2, 8])
@pytest.mark.parametrize("T,d", [(4, 1536), (4, 7168), (37, 18432)])
def test_forced_cluster_covers_every_value_once(T, d, cluster):
    """The launches chip_smoke compares the plan's with (one block a
    row, or a cluster where the plan keeps one) cover the call too."""
    p = K.plan(T, d, H100_SMS, cluster=cluster)
    assert p.cluster == cluster and p.blocks == T * cluster
    assert bool((K.covered(p, T, d) == 1).all()), p


@pytest.mark.parametrize("d", [7168, 18432])
def test_decode_rows_spread_over_the_card(d):
    """At M 4 a call runs a cluster of blocks a row (32 SMs), one
    launch; rows of 1536 stay one block each, the cluster's exchange
    costing more than it saves."""
    p = K.plan(4, d, H100_SMS)
    assert p.path == "cluster" and p.blocks == 32
    assert K.plan(4, 1536, H100_SMS) == K.Plan("block", 192, 1, 1, 192, 4)


def test_plan_of_the_large_shapes():
    """[512, 7168] keeps one block a row at 2 units a thread (448
    threads); the widest activation row fills 288 threads of 8."""
    assert K.plan(512, 7168, H100_SMS) == K.Plan("block", 448, 2, 1, 896,
                                                 512)
    assert K.plan(512, 18432, H100_SMS) == K.Plan("block", 288, 8, 1, 2304,
                                                  512)
    assert K.plan(32768, 128, H100_SMS).path == "warp"
    with pytest.raises(ValueError):
        K.plan(0, 128, H100_SMS)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("M,d", [(4, 1536), (37, 7168), (4, 18432),
                                 (64, 7168)])
def test_quant_dispatch_ref_matches_jax_at_path_widths(M, d, dtype):
    x = np.random.default_rng(M + d).standard_normal((M, d)) * 2
    x[:, 3] *= 40.0                       # an outlier channel
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    q, s = quant_dispatch_ref(tx)
    jq, js = jax_ref(jx)
    np.testing.assert_array_equal(to_np(q), to_np(jq))
    np.testing.assert_array_equal(to_np(s), to_np(js))
