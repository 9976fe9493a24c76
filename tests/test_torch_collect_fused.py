"""EPLB Collect inside route-pack's launch: the pack's ``counts`` (the
plain version on the CPU) against the port's ``collect_ref`` and the JAX
package's, exactly — int32 and int64 ids with padding ids and ids at E or
above, N of 4, 32 and 4096, with and without an EPLB placement (dest
physical, counts logical); the rest of the pack unchanged by counting;
the MoE layer's aux (``expert_counts``, ``moe_lb_loss``, ``moe_z_loss``)
against the reference on the Auto-axis mesh, with and without a
placement and with two decode micro-batches; the wrapper's checks of the
count ids; and the kernel build tag, which covers the shared headers."""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.collect.ref import collect_ref as jax_collect_ref
from repro.models import ffn as jffn
from repro.serving import eplb as jeplb
from repro_torch.configs.base import MOE
from repro_torch.kernels import runtime
from repro_torch.kernels.collect.ref import collect_ref
from repro_torch.kernels.route_pack.kernel import route_pack_cuda
from repro_torch.kernels.route_pack.ops import (fused_route_pack,
                                                placement_route)
from repro_torch.kernels.route_pack.ref import route_pack_ref
from repro_torch.models import ffn as tffn
from repro_torch.serving import eplb as teplb
from torch_parity import auto_ctx, reference, to_np

FIELDS = ("buckets", "scales", "eids", "rank", "keep")


def _table(E: int, hot):
    """An EPLB table with one redundant replica of each ``hot`` expert:
    (replica_slots, n_replicas, phys_owner) as torch tensors."""
    emap = teplb.ExpertMap(E, {h: [h, E + i] for i, h in enumerate(hot)})
    t = teplb.build_placement_table([emap], E)
    return tuple(torch.as_tensor(np.asarray(a)) for a in t.layer(0))


def _pack_case(seed, T, k, E, id_dtype, placed):
    """Payload, dest, count ids and n_dest of one call. Count ids are the
    logical ids of the assignments, with padding ids (-1) and ids at E or
    above mixed in; dest is their slot (physical under a placement)."""
    rng = np.random.default_rng(seed)
    N = T * k
    x = torch.from_numpy(rng.standard_normal((T, 16)).astype(np.float32))
    logical = rng.integers(0, E, N)
    ids = logical.copy()
    ids[rng.random(N) < 0.1] = -1
    ids[rng.random(N) < 0.1] = E + rng.integers(0, 3 * E)
    if placed:
        # experts of odd tokens: the round-robin sends those to replica 1
        rs, nr, owner = _table(E, sorted({int(logical[k]),
                                          int(logical[3 * k])}))
        dest = placement_route(torch.from_numpy(logical),
                               torch.arange(T).repeat_interleave(k), rs, nr)
        n_dest = owner.shape[0]
        assert n_dest > E and bool((dest >= E).any()), "a replica slot used"
    else:
        dest, n_dest = torch.from_numpy(logical).to(torch.int32), E
    return x, dest, torch.from_numpy(ids).to(id_dtype), n_dest


@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("T,k,E", [(4, 1, 128), (4, 8, 256), (512, 8, 256)])
def test_pack_counts_equal_collect(T, k, E, id_dtype, placed):
    """N = 4 (Llama-4 decode), 32 (DeepSeek-V3 decode) and 4096 (a
    512-token prompt at top-8)."""
    x, dest, ids, n_dest = _pack_case(T * k + E, T, k, E, id_dtype, placed)
    kw = dict(k=k, n_dest=n_dest, capacity=max(int(T * k / E), 4))
    want = jax_collect_ref(jnp.asarray(ids.numpy()), E)
    plain = route_pack_ref(x, dest, **kw)
    assert plain.counts is None
    for pack in (route_pack_ref(x, dest, count_ids=ids, n_count=E, **kw),
                 fused_route_pack(x, dest, count_ids=ids, n_count=E, **kw)):
        assert pack.counts.dtype == torch.int32 and pack.counts.shape == (E,)
        np.testing.assert_array_equal(to_np(pack.counts), to_np(want))
        assert torch.equal(pack.counts, collect_ref(ids, E))
        assert int(pack.counts.sum()) == int(((ids >= 0) & (ids < E)).sum())
        for name in FIELDS:       # counting changes nothing else
            a, b = getattr(pack, name), getattr(plain, name)
            assert (a is None and b is None) or torch.equal(a, b), name


def _layer(config):
    jcfg, _, params, tcfg, tparams = reference("float32", config=config)
    pos = f"pos{[f for _, f in tcfg.layer_pattern].index(MOE)}"
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"][pos]["ffn"])
    tp = {n: (v[0] if not isinstance(v, dict) else
              {kk: vv[0] for kk, vv in v.items()})
          for n, v in tparams["blocks"][pos]["ffn"].items()}
    return jcfg, tcfg, jp, tp


def _tables(E: int, hot: int):
    """The same one-replica EPLB table for the reference and the port."""
    jmap = jeplb.ExpertMap(E, {hot: [hot, E]})
    jt = jeplb.build_placement_table([jmap], E)
    tt = teplb.build_placement_table([teplb.ExpertMap(E, {hot: [hot, E]})],
                                     E)
    return (tuple(jnp.asarray(a) for a in jt.layer(0)),
            tuple(torch.as_tensor(np.asarray(a)) for a in tt.layer(0)))


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("placed", [False, True])
@pytest.mark.parametrize("config", ["deepseek-v3", "llama4-gqa"])
def test_moe_aux_matches_reference(config, placed, mb):
    """The MoE layer's counts now come from the pack's Collect block:
    equal to the reference's (exact, summed over micro-batches), and the
    losses built from them as before."""
    jcfg, tcfg, jp, tp = _layer(config)
    E = tcfg.moe.num_experts
    x = np.random.default_rng(11).standard_normal(
        (4, 1, tcfg.d_model)).astype(np.float32)
    xf = torch.from_numpy(x).reshape(4, -1)
    idx, _, probs, logits = tffn._route(xf, tp["router"], tcfg.moe.top_k)
    # a replica of token 1's first expert: the round-robin sends token 1's
    # assignment to the replica's slot, E, not to the expert's own
    jpl, tpl = _tables(E, int(idx[1, 0])) if placed else (None, None)
    _, jaux = jax.jit(lambda p, x, pl: jffn.moe_apply(
        p, x, cfg=jcfg, ctx=auto_ctx(decode_microbatches=mb), mode="decode",
        placement=pl))(jp, jnp.asarray(x), jpl)
    _, taux = tffn.moe_apply(tp, torch.from_numpy(x), cfg=tcfg,
                             mode="decode", placement=tpl, microbatches=mb)
    counts = taux["expert_counts"]
    assert counts.dtype == torch.float32 and counts.shape == (E,)
    np.testing.assert_array_equal(to_np(counts), to_np(jaux["expert_counts"]))
    assert float(counts.sum()) == 4 * tcfg.moe.top_k
    for n in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(to_np(taux[n]), to_np(jaux[n]), rtol=2e-6)
    if mb == 1:
        # the losses' f32 arithmetic is the one the Collect launch fed
        # before: counts of the logical ids, then the same formulas
        want = tffn._aux_stats(probs, collect_ref(idx.reshape(-1), E), E,
                               logits)
        e = tcfg.moe
        assert torch.equal(taux["moe_lb_loss"], want[0] * e.router_aux_coef)
        assert torch.equal(taux["moe_z_loss"], want[1] * e.router_z_coef)
        assert torch.equal(counts, want[2])


def test_cuda_wrapper_checks_count_ids():
    """The count ids' type, length and the counter count are checked
    before any launch, and CPU count ids never reach the card."""
    x = torch.zeros((4, 8))
    dest = torch.zeros(8, dtype=torch.int32)
    kw = dict(k=2, n_dest=3, capacity=4, quantize=False)
    with pytest.raises(TypeError, match="count ids"):
        route_pack_cuda(x, dest, None, None, count_ids=dest.float(),
                        n_count=3, **kw)
    with pytest.raises(ValueError, match="count ids"):
        route_pack_cuda(x, dest, None, None, count_ids=dest[:5], n_count=3,
                        **kw)
    with pytest.raises(ValueError, match="n_count"):
        route_pack_cuda(x, dest, None, None, count_ids=dest, n_count=0,
                        **kw)
    with pytest.raises(ValueError, match="CUDA device"):
        route_pack_cuda(x, dest, None, None, count_ids=dest.long(),
                        n_count=3, **kw)


def test_fused_launch_counts_once():
    """A launch that runs another kernel's body counts once under its own
    name and once in ``FUSED`` under the body's; a reset clears both."""
    runtime.reset_launch_counts()
    runtime.count_launch("route_pack")
    runtime.count_fused("collect")
    assert runtime.LAUNCHES == {"route_pack": 1}
    assert runtime.FUSED == {"collect": 1}
    runtime.reset_launch_counts()
    assert not runtime.LAUNCHES and not runtime.FUSED


@pytest.mark.parametrize("edited", ["collect.cuh", "route_pack.cu"])
def test_build_tag_covers_shared_headers(tmp_path, monkeypatch, edited):
    """Editing the shared header rebuilds every library; editing one
    source rebuilds that library alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(runtime.CSRC, csrc)
    monkeypatch.setattr(runtime, "CSRC", csrc)
    names = runtime.sources()
    assert {"collect", "route_pack"} <= set(names)
    before = {n: runtime._lib_path(n, tmp_path) for n in names}
    assert before == {n: runtime._lib_path(n, tmp_path) for n in names}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: runtime._lib_path(n, tmp_path) for n in names}
    changed = {n for n in names if after[n] != before[n]}
    if edited.endswith(".cuh"):
        assert changed == set(names)
    else:
        assert changed == {edited[:-3]}
