"""The port's KV transfer (``repro_torch.xccl.pd_transfer``) and its copy
of the link model (``repro_torch.xccl.topology``) against the reference.

The same cache trees, made from a seed with numpy in the model's layout
(``"prefix"`` leaves ``[B, L, ...]``, stacked ``"blocks"`` leaves
``[n_sb, B, L, ...]``), go through both packages: slices, reassembly and
UB reads must be exactly equal, byte counts and modeled times too, and
every payload the port cuts must be its own storage."""
import jax
import numpy as np
import pytest
import torch

from repro.xccl import pd_transfer as jpt
from repro.xccl import topology as jtopo
from repro_torch.xccl import pd_transfer as tpt
from repro_torch.xccl import topology as ttopo

L = 48


def _np_cache(seed: int = 0, dtype=np.float32, L: int = L) -> dict:
    """A batch-1 cache of the DeepSeek-V3 layout: two dense prefix layers
    of MLA latents and one stacked superblock of two positions."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return rng.standard_normal(shape).astype(dtype)
    return {
        "prefix": tuple({"ckv": leaf(1, L, 8), "krope": leaf(1, L, 4)}
                        for _ in range(2)),
        "blocks": {"pos0": {"k": leaf(2, 1, L, 2, 4), "v": leaf(2, 1, L, 2, 4)},
                   "pos1": {"ckv": leaf(2, 1, L, 8)}},
    }


def _to_torch(tree):
    return jax.tree_util.tree_map(torch.from_numpy, tree)


def _flat(tree):
    """(path, numpy leaf) pairs of a reference or port tree, in order."""
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(
            lambda x: x.numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x), tree))[0]
    return [(jax.tree_util.keystr(p), x) for p, x in leaves]


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.shape == b.shape and a.dtype == b.dtype, p
        np.testing.assert_array_equal(a, b, err_msg=p)


@pytest.mark.parametrize("start,end", [(0, 16), (16, 48), (5, 6), (0, L)])
def test_slice_kv_chunk_equals_reference(start, end):
    kv = _np_cache()
    _assert_trees_equal(tpt.slice_kv_chunk(_to_torch(kv), start, end),
                        jpt.slice_kv_chunk(kv, start, end))


@pytest.mark.parametrize("bounds", [(0, 48), (0, 16, 48), (0, 7, 16, 40, 48)])
def test_assemble_chunks_equals_reference(bounds):
    kv = _np_cache(1)
    ranges = list(zip(bounds[:-1], bounds[1:]))
    want = jpt.assemble_chunks([jpt.slice_kv_chunk(kv, a, b)
                                for a, b in ranges])
    tkv = _to_torch(kv)
    got = tpt.assemble_chunks([tpt.slice_kv_chunk(tkv, a, b)
                               for a, b in ranges])
    _assert_trees_equal(got, want)
    # the inverse of slicing over consecutive ranges
    _assert_trees_equal(got, kv)
    with pytest.raises(ValueError, match="no chunks"):
        tpt.assemble_chunks([])


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_ub_read_equals_reference_and_copies(dtype):
    kv = _np_cache(2, dtype)
    tkv = _to_torch(kv)
    got = tpt.ub_read(tkv)
    _assert_trees_equal(got, jpt.ub_read(kv))
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(tpt._leaves(tkv), tpt._leaves(got)))
    # leaves that are not tensors pass through
    assert tpt.ub_read({"prefix": ({"meta": 3},)}) == {"prefix": ({"meta": 3},)}


@pytest.mark.parametrize("fn", ["slice", "ub_read"])
def test_payload_survives_its_source_being_written(fn):
    """A chunk payload or a UB read is not a view: writing the prefill
    buffer afterwards (as the next chunk and its padded tail do) leaves
    it unchanged."""
    tkv = _to_torch(_np_cache(3))
    payload = (tpt.slice_kv_chunk(tkv, 16, 32) if fn == "slice"
               else tpt.ub_read(tpt.slice_kv_chunk(tkv, 16, 32)))
    want = [t.clone() for t in tpt._leaves(payload)]
    for t in tpt._leaves(tkv):
        t.fill_(float("nan"))
    for t, w in zip(tpt._leaves(payload), want):
        assert torch.equal(t, w) and t.is_contiguous()


def test_pytree_bytes_and_plan_equal_reference():
    for dtype in (np.float32, np.float16):
        kv = _np_cache(4, dtype)
        tkv = _to_torch(kv)
        assert tpt.pytree_bytes(tkv) == jpt.pytree_bytes(kv)
        for fab in ("ub", "roce", "vpc"):
            got, want = tpt.plan_transfer(tkv, fab), jpt.plan_transfer(kv, fab)
            assert (got.n_leaves, got.total_bytes, got.modeled_time_s,
                    got.fabric) == (want.n_leaves, want.total_bytes,
                                    want.modeled_time_s, want.fabric)


def test_execute_transfer_same_device_and_to_a_device():
    tkv = _to_torch(_np_cache(5))
    assert tpt.execute_transfer(tkv) is tkv
    moved = tpt.execute_transfer(tkv, "cpu")
    _assert_trees_equal(moved, tkv)


@pytest.mark.parametrize("fabric", ["ub", "roce", "vpc"])
def test_chunk_stream_and_ub_read_times_equal_reference(fabric):
    rng = np.random.default_rng(6)
    nbytes = [int(x) for x in rng.integers(1, 1 << 24, 5)]
    compute = [float(x) for x in rng.uniform(1e-5, 1e-2, 5)]
    assert tpt.chunk_stream_time(nbytes, compute, fabric) == \
        jpt.chunk_stream_time(nbytes, compute, fabric)
    assert all(tpt.ub_read_time(n, fabric) == jpt.ub_read_time(n, fabric)
               for n in nbytes)
    with pytest.raises(ValueError, match="align"):
        tpt.chunk_stream_time(nbytes, compute[:-1], fabric)


@pytest.mark.parametrize("fabric", ["ub", "roce", "vpc", "ici", "dcn"])
def test_topology_transfer_times_equal_reference(fabric):
    for n in (0, 1, 1000, 1 << 20, 9 << 20, 1 << 30):
        assert ttopo.best_transfer_time(n, fabric) == \
            jtopo.best_transfer_time(n, fabric)
        for cores in (1, 2, 8, 48):
            assert ttopo.mte_transfer_time(n, cores, fabric) == \
                jtopo.mte_transfer_time(n, cores, fabric)
        assert ttopo.dma_transfer_time(n, fabric) == \
            jtopo.dma_transfer_time(n, fabric)


@pytest.mark.parametrize("factory", ["single_pod", "two_pod", "homogeneous"])
def test_pod_topology_links_equal_reference(factory):
    def build(mod):
        T = mod.PodTopology
        if factory == "homogeneous":
            return T.homogeneous(3, ["910C", "910B", "910C"])
        return getattr(T, factory)()
    got, want = build(ttopo), build(jtopo)
    assert got.n_pods == want.n_pods and got.n_dies == want.n_dies
    for a in range(want.n_pods):
        assert got.compute_scale(a) == want.compute_scale(a)
        for b in range(want.n_pods):
            assert got.link(a, b) == want.link(a, b)
            assert got.transfer_time(1 << 20, a, b) == \
                want.transfer_time(1 << 20, a, b)
    for die in (0, want.n_dies - 1):
        assert got.pod_of_die(die) == want.pod_of_die(die)
    with pytest.raises(ValueError):
        got.link(0, want.n_pods)
