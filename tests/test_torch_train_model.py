"""Training on the port's models against the JAX reference on the CPU in
float32: ``chunked_softmax_xent`` (its loss and its gradients in the
hidden states and the unembedding) and ``Model.forward_train`` — the
loss, the metrics and the gradient of every parameter leaf — for the
seven smoke families, with the same seeded weights and tokens. The
reference is built on the Auto-axis mesh (``tests/torch_parity.py``).
Also: ``remat="full"`` against ``"none"``, one sequence above 2048
tokens (blockwise attention in both packages), the training mode's
switch to the plain route-pack and grouped FFN, and every CUDA kernel
wrapper's refusal of an input that requires grad."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import chunked_softmax_xent as jax_xent
from repro.models.mesh_ctx import MeshCtx
from repro.models.transformer import build_model as jax_build_model
from repro_torch.kernels.collect.kernel import collect_cuda
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.gmm.kernel import gmm_cuda
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_cuda
from repro_torch.kernels.quant_dispatch.kernel import quant_dispatch_cuda
from repro_torch.kernels.route_pack.kernel import route_pack_cuda
from repro_torch.models import ffn as torch_ffn
from repro_torch.models.common import chunked_softmax_xent
from repro_torch.models.transformer import Model
from repro_torch.models.weights import flatten, from_jax_params
from repro_torch.train.train_loop import loss_and_grads
from torch_parity import configs, memory, one_thread, reference  # noqa: F401

LOSS_BAR = 1e-5
GRAD_BAR = 1e-4

#: (config, B, S): S a multiple of mamba2's SSD chunk (32), and one
#: sequence ending in a partial cross-entropy chunk
CASES = [("deepseek-v3", 2, 64), ("llama4-gqa", 2, 48),
         ("internlm2", 2, 160), ("recurrentgemma", 2, 40),
         ("mamba2", 2, 64), ("seamless", 2, 24), ("vision", 2, 24)]


def batch(cfg, B: int, S: int, seed: int = 0, masked: bool = True):
    """Seeded tokens, labels and a loss mask with a few zeros."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    if masked:
        mask[:, -3:] = 0.0
    return toks[:, :-1], np.ascontiguousarray(toks[:, 1:]), mask


def rel_norm(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


def jax_loss_grads(model, params, toks, labels, mask, mem):
    fn = jax.jit(jax.value_and_grad(
        lambda p: model.forward_train(p, toks, labels, memory=mem,
                                      loss_mask=mask), has_aux=True))
    (loss, metrics), grads = fn(params)
    return float(loss), metrics, flatten(jax.tree_util.tree_map(np.asarray,
                                                                grads))


def torch_loss_grads(model, params, toks, labels, mask, mem):
    (loss, metrics), grads = loss_and_grads(
        model, params, torch.as_tensor(toks).long(),
        torch.as_tensor(labels).long(),
        memory=None if mem is None else torch.as_tensor(mem),
        loss_mask=torch.as_tensor(mask))
    return float(loss), metrics, {k: v.numpy() for k, v in
                                  flatten(grads).items()}


def held(jax_side, torch_side, what: str):
    jl, jm, jg = jax_side
    tl, tm, tg = torch_side
    assert abs(tl - jl) <= LOSS_BAR * abs(jl), (what, tl, jl)
    for k in ("nll", "moe_lb_loss", "moe_z_loss", "tokens"):
        assert abs(float(tm[k]) - float(jm[k])) <= LOSS_BAR * max(
            abs(float(jm[k])), 1e-6), (what, k, float(tm[k]), float(jm[k]))
    np.testing.assert_array_equal(tm["expert_counts"].numpy(),
                                  np.asarray(jm["expert_counts"]))
    assert set(tg) == set(jg)
    errs = {k: rel_norm(tg[k], jg[k]) for k in jg}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_BAR, (what, worst, errs[worst])


@pytest.mark.parametrize("config,B,S", CASES, ids=[c[0] for c in CASES])
def test_forward_train_matches_reference(config, B, S):
    jcfg, jmodel, jparams, tcfg, tparams = reference("float32",
                                                     config=config)
    toks, labels, mask = batch(jcfg, B, S)
    mem = (memory(jcfg, B, seed=3) if jcfg.family == "vlm"
           or jcfg.is_encdec else None)
    held(jax_loss_grads(jmodel, jparams, toks, labels, mask, mem),
         torch_loss_grads(Model(tcfg), tparams, toks, labels, mask, mem),
         config)


def test_remat_full_matches_none_and_reference():
    """Recomputing each superblock in backward changes nothing: the
    port's two settings give identical gradients, and the reference's
    ``jax.checkpoint`` run the same values."""
    jcfg, _, jparams, tcfg, tparams = reference("float32",
                                                config="deepseek-v3")
    toks, labels, mask = batch(jcfg, 2, 64, seed=1)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jmodel = jax_build_model(jcfg, MeshCtx(mesh=mesh, batch_axes=("data",),
                                           remat="full"))
    want = jax_loss_grads(jmodel, jparams, toks, labels, mask, None)
    none = torch_loss_grads(Model(tcfg), tparams, toks, labels, mask, None)
    full = torch_loss_grads(Model(tcfg, remat="full"), tparams, toks,
                            labels, mask, None)
    held(want, full, "remat full")
    assert full[0] == none[0]
    for k in none[2]:
        np.testing.assert_array_equal(full[2][k], none[2][k], err_msg=k)


def test_forward_train_above_2048_tokens_is_blockwise():
    """S 2100 > 2048: both packages attend blockwise (512-token blocks,
    the last one partial) and the cross-entropy ends in a 52-token
    chunk."""
    jcfg, jmodel, jparams, tcfg, tparams = reference(
        "float32", num_layers=2, config="internlm2")
    toks, labels, mask = batch(jcfg, 1, 2100, seed=2)
    held(jax_loss_grads(jmodel, jparams, toks, labels, mask, None),
         torch_loss_grads(Model(tcfg), tparams, toks, labels, mask, None),
         "S 2100")


@pytest.mark.parametrize("S,masked", [(256, False), (200, True),
                                      (128, True), (90, False)])
def test_chunked_softmax_xent_matches_reference(S, masked):
    """S a multiple of the 128-token chunk or not, with and without a
    mask: the mean loss, the token count and both gradients."""
    rng = np.random.default_rng(S)
    B, d, V = 2, 32, 300
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.2).astype(np.float32)
    y = rng.integers(0, V, (B, S)).astype(np.int32)
    m = ((rng.random((B, S)) > 0.3).astype(np.float32) if masked
         else None)

    def jf(h, w):
        return jax_xent(h, y, w, mask=None if m is None else m)
    (jl, jc), (gh, gw) = jax.value_and_grad(jf, argnums=(0, 1),
                                            has_aux=True)(h, w)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tl, tc = chunked_softmax_xent(th, torch.as_tensor(y).long(), tw,
                                  mask=None if m is None
                                  else torch.as_tensor(m))
    tl.backward()
    assert float(tc) == float(jc)
    assert abs(tl.item() - float(jl)) <= LOSS_BAR * abs(float(jl))
    assert rel_norm(th.grad.numpy(), gh) <= GRAD_BAR
    assert rel_norm(tw.grad.numpy(), gw) <= GRAD_BAR


def test_train_mode_takes_the_plain_versions(monkeypatch):
    """``mode="train"`` passes ``use_kernel=False`` to route-pack and the
    grouped FFN (the reference's ``use_pallas=False``); prefill passes
    ``True``, so the card keeps launching the kernels there."""
    seen = []
    real_pack, real_ffn = torch_ffn.fused_route_pack, torch_ffn.expert_ffn

    def pack(*a, use_kernel=True, **kw):
        seen.append(("route_pack", use_kernel))
        return real_pack(*a, use_kernel=use_kernel, **kw)

    def ffn(*a, use_kernel=True, **kw):
        seen.append(("gmm", use_kernel))
        return real_ffn(*a, use_kernel=use_kernel, **kw)
    monkeypatch.setattr(torch_ffn, "fused_route_pack", pack)
    monkeypatch.setattr(torch_ffn, "expert_ffn", ffn)
    _, _, _, tcfg, tparams = reference("float32", config="deepseek-v3")
    model = Model(tcfg)
    toks = torch.zeros((1, 8), dtype=torch.long)
    model.forward_train(tparams, toks, toks)
    assert seen == [("route_pack", False), ("gmm", False)]
    seen.clear()
    model.prefill(tparams, toks)
    assert seen == [("route_pack", True), ("gmm", True)]


def _needs_grad(*shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, requires_grad=True)


@pytest.mark.parametrize("name", ["gmm", "route_pack", "collect",
                                  "decode_attention", "quant_dispatch",
                                  "int8_matmul"])
def test_kernel_wrapper_refuses_an_input_that_requires_grad(name):
    """Each ``*_cuda`` wrapper checks for a requires-grad input before
    anything else (so on the CPU too): a kernel has no backward, and its
    output would silently leave the autograd graph. With grad mode off
    the same call goes on to the device check."""
    i8 = torch.zeros((4, 16), dtype=torch.int8)
    calls = {
        "gmm": lambda g: gmm_cuda(g(2, 4, 8), *(torch.zeros(2, 8, 8),) * 3),
        "route_pack": lambda g: route_pack_cuda(
            g(4, 8), torch.zeros(4, dtype=torch.int32), None, None, k=1,
            n_dest=2, capacity=4, quantize=False),
        # ids never require grad: the refusal covers whatever is passed
        "collect": lambda g: collect_cuda(g(4), 2),
        "decode_attention": lambda g: decode_attention_cuda(
            g(1, 2, 32), torch.zeros(1, 4, 1, 32), torch.zeros(1, 4, 1, 32),
            torch.zeros(1, dtype=torch.int32)),
        "quant_dispatch": lambda g: quant_dispatch_cuda(g(4, 16)),
        "int8_matmul": lambda g: int8_matmul_cuda(
            i8, g(4), torch.zeros((16, 16), dtype=torch.int8).t(),
            torch.zeros(16)),
    }
    with pytest.raises(RuntimeError, match="no backward"):
        calls[name](_needs_grad)
    with torch.no_grad(), pytest.raises((ValueError, TypeError)):
        calls[name](_needs_grad)
