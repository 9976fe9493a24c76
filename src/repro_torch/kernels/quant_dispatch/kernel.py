"""ctypes wrapper of ``csrc/quant_dispatch.cu`` (CUDA tensors only), and
the launch plan that picks its path from the shapes."""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import runtime

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PATHS = {"scalar": 0, "warp": 1, "block": 2, "cluster": 3}
_UNIT = 8                 # values a 16-byte load of bf16 carries
_WARP_THREADS = 256       # QD_THREADS: the scalar and warp paths' block
#: rows of up to this many units take the warp path
WARP_MAX_UNITS = 128
#: rows of fewer units stay in one block: a cluster's barriers and its
#: exchange through distributed shared memory cost more than they save
SPLIT_MIN_UNITS = 512
#: a cluster block's slice is at least this many units (512 values)
MIN_SLICE = 64
MAX_CLUSTER = 8           # the portable cluster size
#: among the block sizes that waste equally few lanes, the one nearest
#: this many threads (measured fastest at the path's widths)
GROUP_TARGET = 384
#: units a thread may hold → the most threads a block of it may have
#: (MaxGroup in the source: its registers)
MAX_GROUP = {1: 1024, 2: 1024, 4: 512, 8: 512}


class Plan(NamedTuple):
    """How one call runs. ``path``: ``scalar``, ``warp``, ``block`` or
    ``cluster``; ``group``: threads per row (scalar and warp paths) or
    per block (block and cluster); ``vec``: 8-value units a thread holds
    (0 on the scalar path); ``cluster``: blocks per row; ``per``: units of
    a block's slice of the row (the whole row but on the cluster path);
    ``blocks``: the grid."""
    path: str
    group: int
    vec: int
    cluster: int
    per: int
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.cache
def plan(T: int, d: int, n_sms: int, aligned: bool = True,
         cluster: Optional[int] = None) -> Plan:
    """The launch of a ``[T, d]`` call on a card of ``n_sms`` SMs, a
    function of the shapes alone (and of whether the input's base is
    16-byte aligned). ``cluster`` (1, 2, 4 or 8) forces the blocks a row
    of the block and cluster paths starts from, to compare launches.

    Ragged d (not a multiple of 8) or an unaligned input takes the scalar
    path. Rows of up to ``WARP_MAX_UNITS`` 8-value units take the warp
    path: G lanes (a power of two, at most 32) hold the row, V ∈ {1, 2, 4}
    units each. Wider rows take one block each, or a cluster of CS blocks
    each: for rows of ``SPLIT_MIN_UNITS`` or more, CS doubles (up to 8)
    while the grid keeps at most one block per SM (T · CS ≤ n_sms) and
    each block at least ``MIN_SLICE`` units; and any row doubles CS
    further while a slice is wider than one block's registers take (512
    threads of 8 units); past 8 blocks of those the row goes to the
    scalar path.
    A block of G threads holds V ∈ {1, 2, 4, 8} units a thread: the pair
    that wastes fewest lanes, ties to G nearest ``GROUP_TARGET``."""
    if T < 1 or d < 1:
        raise ValueError(f"quant_dispatch: no plan for [{T}, {d}]")
    units = d // _UNIT

    def scalar():
        tpr = 32 if d <= 1024 else _WARP_THREADS
        return Plan("scalar", tpr, 0, 1, 0,
                    -(-T * tpr // _WARP_THREADS))

    if d % _UNIT or not aligned:
        return scalar()
    if units <= WARP_MAX_UNITS:
        g = min(32, _pow2_at_least(units))
        return Plan("warp", g, _pow2_at_least(-(-units // g)), 1, units,
                    -(-T // (_WARP_THREADS // g)))
    cs = cluster or 1
    while (cluster is None and units >= SPLIT_MIN_UNITS
           and cs < MAX_CLUSTER and T * cs * 2 <= n_sms
           and units // (cs * 2) >= MIN_SLICE):
        cs *= 2
    widest = max(MAX_GROUP[v] * v for v in MAX_GROUP)
    while -(-units // cs) > widest and cs < MAX_CLUSTER:
        cs *= 2
    per = -(-units // cs)
    if per > widest:
        return scalar()

    def threads(v):           # a block's threads at v units each
        return (-(-per // v) + 31) // 32 * 32
    v, g = min(((v, threads(v)) for v in MAX_GROUP
                if threads(v) <= MAX_GROUP[v]),
               key=lambda vg: (vg[0] * vg[1] - per,
                               abs(vg[1] - GROUP_TARGET)))
    return Plan("cluster" if cs > 1 else "block", g, v, cs, per, T * cs)


def covered(p: Plan, T: int, d: int) -> torch.Tensor:
    """[T, d] int32: how many times a launch of plan ``p`` writes each
    value, by the kernel's own index arithmetic (rows per block, the
    group's threads, each thread's units ``u0 + j·G + t``, the masks);
    every value once is a plan that covers the call."""
    n = torch.zeros((T, d), dtype=torch.int32)
    if p.path in ("scalar", "warp"):      # groups of p.group threads a row
        rows = torch.arange(p.blocks * (_WARP_THREADS // p.group))
        live = rows[rows < T]             # the kernel's `live` mask
    if p.path == "scalar":
        for lane in range(p.group):       # values lane, lane + G, ...
            n[live, lane::p.group] += 1
        return n
    flat = n.view(-1)
    units = d // _UNIT
    offs = torch.arange(_UNIT)

    def add(row, c):                      # units c of rows `row`, 8 values
        idx = (row * d + _UNIT * c + offs).reshape(-1)
        flat.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    if p.path == "warp":
        for t in range(p.group):
            for j in range(p.vec):
                c = j * p.group + t
                if c < units:
                    add(live[:, None], c)
        return n
    for blk in range(p.blocks):
        row, r = divmod(blk, p.cluster)
        u0 = r * p.per
        u1 = min(units, u0 + p.per)
        c = u0 + (torch.arange(p.vec)[:, None] * p.group
                  + torch.arange(p.group)[None, :]).reshape(-1)
        add(row, c[c < u1][:, None])
    return n


@functools.cache
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.cache
def _fn():
    fn = runtime.library("quant_dispatch").quant_dispatch_launch
    fn.argtypes = [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def launch(x: torch.Tensor, p: Plan, q: torch.Tensor,
           scales: torch.Tensor) -> None:
    """Launch plan ``p`` on ``x`` [T, d] into ``q`` and ``scales`` (every
    value written by the kernel). The C entry checks that the plan fits
    the call and refuses one that does not."""
    T, d = x.shape
    status = _fn()(x.data_ptr(), _DTYPES[x.dtype], T, d, _PATHS[p.path],
                   p.group, p.vec, p.cluster, p.per, q.data_ptr(),
                   scales.data_ptr(), runtime.stream_handle(x))
    runtime.check_status("quant_dispatch", status)
    runtime.count_launch("quant_dispatch")


def quant_dispatch_cuda(x: torch.Tensor):
    """x [T, d] bf16/f32 → (int8 [T, d], f32 scales [T]), one scale per
    row, bit-identical to :func:`quant_dispatch_ref`. One launch, on the
    path :func:`plan` picks."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"quant_dispatch: dtype {x.dtype} unsupported")
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quant_dispatch: x must be [T, d > 0], got "
                         f"{tuple(x.shape)}")
    x = x.contiguous()
    runtime.require_cuda("quant_dispatch", x)
    T, d = x.shape
    q = torch.empty((T, d), dtype=torch.int8, device=x.device)
    scales = torch.empty((T,), dtype=torch.float32, device=x.device)
    if T:
        launch(x, plan(T, d, _n_sms(x.device),
                       aligned=x.data_ptr() % 16 == 0), q, scales)
    return q, scales
