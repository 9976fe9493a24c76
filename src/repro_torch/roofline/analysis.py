"""Roofline terms of one step, at an H100's bounds.

compute    = FLOPs / peak FLOP/s
memory     = HBM bytes / HBM bandwidth
collective = collective bytes / link bandwidth

All quantities are per device (one rank of the mesh), in seconds per
step: :class:`RooflineTerms` and :func:`analytic_model_flops` keep the
reference's keys and arithmetic. Only the bounds differ: they are the
datasheet figures of the NVIDIA H100 80GB HBM3 (SXM5, 700 W) — dense
bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 bandwidth per
direction — not measurements. The reference's HLO parsers
(``shape_bytes``, ``collective_bytes``, ``while_trip_counts``) are not
ported: PyTorch produces no HLO (the dry run counts its collectives'
bytes itself, ``launch/dryrun_lib.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

# Hardware constants: NVIDIA H100 80GB HBM3 (SXM5, 700 W) datasheet
# figures, not measurements
PEAK_FLOPS = 989e12        # dense bf16 FLOP/s per device
HBM_BW = 3.35e12           # HBM3 bytes/s per device
NVLINK_BW = 450e9          # NVLink bytes/s per device, per direction

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-device
    hbm_bytes: float             # per-device
    coll_bytes: Dict[str, int]   # per-device, by op
    n_devices: int
    model_flops: float = 0.0     # analytic 6·N_active·D for the step

    @property
    def total_coll_bytes(self) -> float:
        return float(sum(self.coll_bytes.values()))

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.total_coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops * self.n_devices
        return self.model_flops / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_devices": self.n_devices,
        }


def analytic_model_flops(cfg, shape) -> float:
    """6·N_active·D for train (fwd+bwd), 2·N_active·D for inference."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one token per sequence
    return 2.0 * n_active * tokens
