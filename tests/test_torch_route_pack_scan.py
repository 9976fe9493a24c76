"""Route-pack's CUDA design modelled on the CPU: one block per destination
walks ``dest`` in order, 256 assignments a tile, and each 32-lane warp's
ballot of ``dest == e`` with the popcount of the lanes below gives every
assignment of ``e`` its FIFO rank; then the block writes every slot of
``e`` once — the row of its assignment when that one is valid, else
zeros, scale 0 and expert id -1. The model is written with the kernel's
tile, warp and lane structure, and must equal the port's plain version
and the Pallas kernel (interpret mode) exactly, field by field, and the
JAX reference where no row is padding (it takes destinations in
``[0, n_dest)`` only)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.route_pack import ops as jops
from repro.kernels.route_pack.ref import route_pack_ref as jax_ref
from repro_torch.kernels.route_pack.ref import RoutePack
from repro_torch.kernels.route_pack.ref import route_pack_ref as torch_ref
from torch_parity import to_np

FIELDS = ("buckets", "scales", "eids", "rank", "keep")
THREADS, LANES = 256, 32          # RP_THREADS and the warp in the source


def ballot_scan(dest: torch.Tensor, n_dest: int):
    """``(rank [N], count [n_dest])`` as the kernel's blocks compute them:
    block e, tile t, warp w, lane l holds assignment ``t*256 + w*32 + l``;
    its rank is the hits of e in the tiles before (the running base), in
    the warps before within its tile (the warps' popcounts) and in the
    lanes below within its warp (``popc(ballot & lanemask_lt)``).
    Assignments with no destination (the extra block) take rank 0."""
    N = dest.shape[0]
    n_tiles = -(-N // THREADS)
    padded = torch.full((n_tiles * THREADS,), -1, dtype=torch.int64)
    padded[:N] = dest.long()
    e = torch.arange(n_dest)[:, None, None, None]
    ballot = padded.reshape(n_tiles, THREADS // LANES, LANES)[None] == e
    popc = ballot.sum(-1)                                   # [E, t, w]
    lanes_below = torch.cumsum(ballot, -1) - ballot.long()
    warps_before = torch.cumsum(popc, -1) - popc
    tile_total = popc.sum(-1)                               # [E, t]
    base = torch.cumsum(tile_total, -1) - tile_total
    rk = base[..., None, None] + warps_before[..., None] + lanes_below
    rank = (rk * ballot).sum(0).reshape(-1)[:N]             # one e per hit
    return rank.to(torch.int32), tile_total.sum(-1)


def assemble(x, dest, valid, eid, *, k, n_dest, capacity, quantize):
    """Every output written once, as the blocks write it: slot c of e is
    e's c-th assignment when c < min(count, C) and it is valid, else an
    empty slot (zeros, scale 0, expert id -1)."""
    N = dest.shape[0]
    rank, count = ballot_scan(dest, n_dest)
    ok = torch.ones(N, dtype=torch.bool) if valid is None else valid.bool()
    real = (dest >= 0) & (dest < n_dest)
    keep = real & (rank < capacity) & ok
    src = torch.full((n_dest, capacity), -1, dtype=torch.int64)
    for r in torch.nonzero(keep)[:, 0].tolist():
        assert src[dest[r], rank[r]] == -1, "a slot written twice"
        src[dest[r], rank[r]] = r
    assert ((src >= 0).sum(1) <= torch.clamp(count, max=capacity)).all()
    filled = src >= 0
    rows = x[torch.clamp(src, min=0) // k].float()          # [E, C, d]
    scales = None
    if quantize:
        amax = rows.abs().amax(-1)
        scale = torch.clamp(amax, min=1e-8) * torch.tensor(1.0 / 127.0)
        q = torch.clamp(torch.round(rows / scale[..., None]), -127, 127)
        buckets = torch.where(filled[..., None], q, 0.0).to(torch.int8)
        scales = torch.where(filled, scale, 0.0)
    else:
        buckets = torch.where(filled[..., None], rows, 0.0).to(x.dtype)
    eids = None
    if eid is not None:
        eids = torch.where(filled, eid.to(torch.int32)[torch.clamp(src,
                                                                   min=0)],
                           -1).to(torch.int32)
    return RoutePack(buckets, scales, eids,
                     torch.where(real, rank, 0).to(torch.int32), keep)


def _case(seed, T, d, k, E, C, pad, masked, dtype):
    rng = np.random.default_rng(seed)
    N = T * k
    x = (rng.standard_normal((T, d)) * 2).astype(np.float32)
    dest = rng.integers(0, E, N).astype(np.int32)
    valid = (rng.random(N) > 0.25) if masked else np.ones(N, bool)
    if pad:       # padding rows, masked as the reference's wrapper pads
        padded = rng.random(N) < pad
        dest[padded] = E
        valid[padded] = False
    eid = rng.integers(0, 300, N).astype(np.int32)
    return x, dest, valid, eid


def _same(got, want, tag):
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), (tag, name)
        if g is not None:
            np.testing.assert_array_equal(to_np(g), to_np(w),
                                          err_msg=f"{tag} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("T,d,k,E,C,pad,masked", [
    (4, 64, 8, 256, 4, 0.0, False),     # DeepSeek-V3 decode: 256 experts
    (64, 32, 8, 258, 4, 0.1, True),     # prefill bucket over EPLB slots
    (256, 16, 8, 256, 16, 0.2, True),   # N 2048, 8 tiles of the scan
    (2048, 8, 1, 130, 20, 0.0, True),   # N 2048 at top-1: overflow past C
    (300, 8, 2, 3, 300, 0.3, True),     # C past one 256-slot window
    (33, 24, 8, 5, 4, 0.5, False),      # ranks far past C, ragged tile
])
def test_ballot_scan_model_matches_reference_and_pallas(dtype, quantize, T,
                                                         d, k, E, C, pad,
                                                         masked):
    x, dest, valid, eid = _case(T * 13 + E + C, T, d, k, E, C, pad, masked,
                                dtype)
    kw = dict(k=k, n_dest=E, capacity=C, quantize=quantize)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    targs = (torch.from_numpy(dest), torch.from_numpy(valid),
             torch.from_numpy(eid))
    got = assemble(tx, *targs, **kw)
    _same(got, torch_ref(tx, *targs, **kw), "model vs plain")
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jargs = tuple(map(jnp.asarray, (dest, valid, eid)))
    if not pad:       # the JAX ref takes destinations in [0, n_dest) only
        _same(got, jax_ref(jx, *jargs, **kw), "model vs jax ref")
    _same(got, jops.fused_route_pack(jx, *jargs, use_pallas=True,
                                     interpret=True, **kw),
          "model vs pallas")
    rank = got.rank.numpy()
    assert (rank[dest == E] == 0).all() and not got.keep.numpy()[
        dest == E].any()
    if T * k > E * C or masked:
        assert not got.keep.all()           # the case really drops rows


def test_ballot_scan_ranks_are_fifo_within_each_destination():
    """Across tile and warp boundaries the ranks of one destination are
    0, 1, 2, ... in assignment order, and masked rows keep their rank."""
    rng = np.random.default_rng(5)
    dest = torch.from_numpy(rng.integers(0, 3, 1000).astype(np.int32))
    rank, count = ballot_scan(dest, 3)
    for e in range(3):
        mine = rank[dest == e]
        assert mine.tolist() == list(range(int((dest == e).sum())))
        assert int(count[e]) == len(mine)


def test_cuda_wrapper_checks_before_any_launch():
    """The wrapper refuses a bad payload type, an N other than T·k, an
    empty destination set and CPU tensors before it allocates or
    launches; ids already contiguous int32 are passed as they are."""
    from repro_torch.kernels.route_pack.kernel import _int32, route_pack_cuda
    x = torch.zeros((4, 8))
    dest = torch.zeros(8, dtype=torch.int32)
    kw = dict(k=2, n_dest=3, capacity=4, quantize=False)
    with pytest.raises(TypeError):
        route_pack_cuda(x.half(), dest, None, None, **kw)
    with pytest.raises(ValueError, match="T\\*k"):
        route_pack_cuda(x, dest[:6], None, None, **kw)
    with pytest.raises(ValueError, match="n_dest"):
        route_pack_cuda(x, dest, None, None, **dict(kw, n_dest=0))
    with pytest.raises(ValueError, match="CUDA device"):
        route_pack_cuda(x, dest, None, None, **kw)
    assert _int32(dest) is dest and _int32(None) is None
    assert _int32(dest.long()).dtype == torch.int32
