"""Grouped expert FFN: the port's ``expert_ffn`` on the CPU (its plain
version) against the JAX reference. 2e-4 in float32 against JAX's
``gmm_ref``/``placement_gmm_ref``; 3e-2 in bf16 against the JAX Pallas
kernel in interpret mode (which casts the hidden to bf16, as the CUDA
kernel does); owner-indexed results bit-identical to the port's own
call on owner-gathered weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gmm import ops as jops
from repro.kernels.gmm.ref import gmm_ref, placement_gmm_ref
from repro_torch.kernels.gmm.ops import expert_ffn
from torch_parity import to_np


def _weights(seed, S, E, C, d, f):
    rng = np.random.default_rng(seed)
    b = (rng.standard_normal((S, C, d)) * 0.3).astype(np.float32)
    ws = [(rng.standard_normal(s) * 0.1).astype(np.float32)
          for s in ((E, d, f), (E, d, f), (E, f, d))]
    owner = rng.integers(0, E, S).astype(np.int32)
    return b, ws, owner


def _both(arrs, dtype):
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    return ([jnp.asarray(a, jd) for a in arrs],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs])


@pytest.mark.parametrize("E,C,d,f", [(4, 16, 64, 128), (8, 4, 128, 256),
                                     (2, 100, 32, 96), (1, 8, 16, 48)])
def test_expert_ffn_f32_matches_jax_ref(E, C, d, f):
    b, ws, _ = _weights(E * 100 + C, E, E, C, d, f)
    (jb, *jw), (tb, *tw) = _both([b, *ws], "float32")
    np.testing.assert_allclose(to_np(expert_ffn(tb, *tw)),
                               to_np(gmm_ref(jb, *jw)), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("E,S,C,d,f", [(4, 6, 16, 64, 128), (8, 11, 4, 32, 96),
                                       (1, 3, 100, 32, 64)])
def test_placement_expert_ffn_f32_matches_jax_ref(E, S, C, d, f):
    b, ws, owner = _weights(S * 10 + E, S, E, C, d, f)
    (jb, *jw), (tb, *tw) = _both([b, *ws], "float32")
    got = expert_ffn(tb, *tw, phys_owner=torch.from_numpy(owner))
    np.testing.assert_allclose(
        to_np(got), to_np(placement_gmm_ref(jb, *jw, jnp.asarray(owner))),
        rtol=2e-4, atol=2e-4)
    o = torch.from_numpy(owner).long()
    gathered = expert_ffn(tb, *(w[o] for w in tw))
    assert torch.equal(got, gathered)


@pytest.mark.parametrize("owned", [False, True])
def test_expert_ffn_bf16_within_pallas_tolerance(owned):
    E, S, C, d, f = 4, 6, 8, 64, 128
    b, ws, owner = _weights(11, S if owned else E, E, C, d, f)
    (jb, *jw), (tb, *tw) = _both([b, *ws], "bfloat16")
    kw = {"phys_owner": jnp.asarray(owner)} if owned else {}
    want = jops.expert_ffn(jb, *jw, use_pallas=True, interpret=True, **kw)
    tkw = {"phys_owner": torch.from_numpy(owner)} if owned else {}
    got = expert_ffn(tb, *tw, **tkw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=3e-2, atol=3e-2)


def test_identity_owner_table_is_plain_gmm():
    E, C, d, f = 4, 8, 32, 64
    b, ws, _ = _weights(5, E, E, C, d, f)
    _, (tb, *tw) = _both([b, *ws], "float32")
    ident = torch.arange(E, dtype=torch.int32)
    assert torch.equal(expert_ffn(tb, *tw, phys_owner=ident),
                       expert_ffn(tb, *tw))
