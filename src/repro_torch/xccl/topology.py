"""CloudMatrix384 topology + transfer-latency model, pod-aware.

The paper's SuperPod: 48 servers × 8 Ascend 910C chips (2 dies each), three
fabrics: scale-up UB (memory semantics, highest bandwidth), scale-out RoCE
(cross-pod + 910B), VPC (external). XCCL offers two data paths per link:

  * MTE (memory-semantic, unified-buffer bounded): low startup latency,
    KB–MB payloads, parallelism over AIV cores; models Fig. 5.
  * DMA (bulk): higher startup latency, GB-scale payloads.

Bandwidth semantics: ``FabricSpec.bandwidth`` is the per-link unidirectional
rate and ``FabricSpec.n_links`` the number of parallel links a single die can
drive, so the aggregate DMA rate is ``bandwidth * n_links`` — UB keeps its
392 GB/s/die budget (49 GB/s × 8 planes) while a RoCE NIC is one 50 GB/s
port and VPC one 12.5 GB/s port. (Earlier revisions multiplied EVERY fabric
by the UB plane count, pricing RoCE/VPC bulk transfers at near-UB rates.)

Deployments beyond one SuperPod compose :class:`PodTopology`: per-pod
:class:`PodSpec` (a 910B-class prefill pod can differ from the 910C decode
pod, §7.2 / P/D-Serve), intra-pod traffic on UB, cross-pod on RoCE.

This module is the *analytic* side of XCCL: it models the paper's link
latencies, the port's PD transfer prices its plans with it
(``TransferPlan.modeled_time_s``), and the SuperPod simulator prices its
dispatch, A2E and KV transfers with it (``sim/fabric.py``). These are
modeled CloudMatrix times,
never the card's: what a copy takes on the GPU is measured. The constants
keep the Ascend view and a TPU-adapted one (UB ≈ ICI, RoCE ≈ DCN), as the
reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Literal, Sequence, Tuple

Fabric = Literal["ub", "roce", "vpc"]
Engine = Literal["mte", "dma"]


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    name: str
    bandwidth: float        # bytes/s per link (unidirectional)
    base_latency: float     # s, protocol + first-byte
    per_msg_overhead: float # s, per chunk/doorbell
    n_links: int = 1        # parallel links one die can drive


# Paper-scale constants (§2.2: UB "several times" RoCE bandwidth; Fig. 5:
# <20 µs for <1 MB payloads with 2 AIV cores → ~392 GB/s/die UB budget,
# spread over 8 UB planes).
UB = FabricSpec("ub", 392e9 / 8, 2.0e-6, 0.4e-6, n_links=8)
ROCE = FabricSpec("roce", 50e9, 5.0e-6, 1.0e-6, n_links=1)
VPC = FabricSpec("vpc", 12.5e9, 30e-6, 5.0e-6, n_links=1)

# TPU-adapted view (per system brief): ICI ≈ UB role (multiple links per
# chip), DCN ≈ RoCE role (one NIC).
ICI = FabricSpec("ici", 50e9, 1.5e-6, 0.3e-6, n_links=6)
DCN = FabricSpec("dcn", 25e9, 10e-6, 2.0e-6, n_links=1)

FABRICS = {"ub": UB, "roce": ROCE, "vpc": VPC, "ici": ICI, "dcn": DCN}

# Ascend 910C per-die engine characteristics (§2.2, §3.1). Calibrated to
# Fig. 5: <20 µs for ≤1 MB with 2 AIV cores; 9 MB with 48 cores ≈2.5-3×
# faster than with 2 (2 cores already reach a good share of the link).
AIV_CORES_PER_DIE = 48
UNIFIED_BUFFER_BYTES = 192 * 1024     # "KB-level" unified buffer per AIV
MTE_SETUP = 1.2e-6                    # kernel launch + metadata read
DMA_SETUP = 8.0e-6                    # §3.3: DMA has higher startup latency
MTE_PER_CORE_BW = 44e9                # per-core pipe, capped by link share
MTE_LINK_CAP = 250e9                  # per-die UB link budget


@dataclasses.dataclass(frozen=True)
class SuperPod:
    n_servers: int = 48
    chips_per_server: int = 8
    dies_per_chip: int = 2

    @property
    def n_chips(self) -> int:
        return self.n_servers * self.chips_per_server

    @property
    def n_dies(self) -> int:
        return self.n_chips * self.dies_per_chip

    @property
    def n_pairs(self) -> int:
        """§3.1: roughly 300K potential send/recv NPU pairs."""
        return self.n_dies * (self.n_dies - 1) // 2


# Relative per-die dense compute vs the 910C baseline. §7.2: prior-gen
# 910B pods keep serving as prefill-only capacity over scale-out RoCE;
# P/D-Serve runs the same heterogeneous shape in production.
CHIP_CLASSES: Dict[str, float] = {"910C": 1.0, "910B": 0.5}


@dataclasses.dataclass(frozen=True)
class PodSpec:
    """One SuperPod in a multi-pod deployment: its scale (dies) and chip
    generation, which sets the relative prefill compute rate."""
    pod: SuperPod = SuperPod()
    chip_class: str = "910C"

    def __post_init__(self):
        if self.chip_class not in CHIP_CLASSES:
            raise ValueError(f"unknown chip class {self.chip_class!r}; "
                             f"known: {sorted(CHIP_CLASSES)}")

    @property
    def compute_scale(self) -> float:
        return CHIP_CLASSES[self.chip_class]


@dataclasses.dataclass(frozen=True)
class PodTopology:
    """Dies → pods, and the link each (src pod, dst pod) path rides.

    Intra-pod traffic stays on the UB scale-up plane; any cross-pod path
    drops to the scale-out fabric (RoCE by default). Pods are laid out
    consecutively in the global die index space.
    """
    pods: Tuple[PodSpec, ...] = (PodSpec(),)
    intra_fabric: str = "ub"
    cross_fabric: str = "roce"

    def __post_init__(self):
        if not self.pods:
            raise ValueError("PodTopology needs at least one pod")
        for fab in (self.intra_fabric, self.cross_fabric):
            if fab not in FABRICS:
                raise ValueError(f"unknown fabric {fab!r}")

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def n_dies(self) -> int:
        return sum(p.pod.n_dies for p in self.pods)

    def _check_pod(self, pod_id: int) -> None:
        if not 0 <= pod_id < self.n_pods:
            raise ValueError(f"pod {pod_id} out of range "
                             f"(n_pods={self.n_pods})")

    def pod_of_die(self, die: int) -> int:
        """Pod owning global die index ``die`` (pods are consecutive)."""
        if die < 0:
            raise ValueError(f"negative die index {die}")
        lo = 0
        for pid, p in enumerate(self.pods):
            lo += p.pod.n_dies
            if die < lo:
                return pid
        raise ValueError(f"die {die} out of range (n_dies={self.n_dies})")

    def link(self, src_pod: int, dst_pod: int) -> str:
        """Fabric name for the (src pod → dst pod) path."""
        self._check_pod(src_pod)
        self._check_pod(dst_pod)
        return self.intra_fabric if src_pod == dst_pod else self.cross_fabric

    def transfer_time(self, nbytes: int, src_pod: int = 0,
                      dst_pod: int = 0) -> float:
        """Best-path transfer time over the link this pod pair rides."""
        return best_transfer_time(nbytes, self.link(src_pod, dst_pod))

    def compute_scale(self, pod_id: int) -> float:
        self._check_pod(pod_id)
        return self.pods[pod_id].compute_scale

    @classmethod
    def single_pod(cls, chip_class: str = "910C") -> "PodTopology":
        return cls(pods=(PodSpec(chip_class=chip_class),))

    @classmethod
    def two_pod(cls, prefill_class: str = "910B",
                decode_class: str = "910C") -> "PodTopology":
        """The §7.2 / P/D-Serve shape: pod 0 is the (910C) decode pod,
        pod 1 a heterogeneous prefill pod feeding it over RoCE."""
        return cls(pods=(PodSpec(chip_class=decode_class),
                         PodSpec(chip_class=prefill_class)))

    @classmethod
    def homogeneous(cls, n_pods: int,
                    chip_classes: Sequence[str] = ()) -> "PodTopology":
        """``n_pods`` SuperPods; optional per-pod chip classes."""
        classes = list(chip_classes) or ["910C"] * n_pods
        if len(classes) != n_pods:
            raise ValueError(f"chip_classes has {len(classes)} entries "
                             f"for {n_pods} pods")
        return cls(pods=tuple(PodSpec(chip_class=c) for c in classes))


def mte_transfer_time(nbytes: int, n_aiv_cores: int = 8,
                      fabric: Fabric = "ub") -> float:
    """Memory-semantic transfer (§3.1 protocol): chunked through each AIV's
    unified buffer in ping-pong, cores in parallel. Models Fig. 5."""
    f = FABRICS[fabric]
    n_aiv_cores = max(1, min(n_aiv_cores, AIV_CORES_PER_DIE))
    per_core_bytes = math.ceil(nbytes / n_aiv_cores)
    n_chunks = max(1, math.ceil(per_core_bytes / UNIFIED_BUFFER_BYTES))
    bw = min(MTE_PER_CORE_BW * n_aiv_cores, MTE_LINK_CAP,
             f.bandwidth * f.n_links)
    per_core_bw = bw / n_aiv_cores
    # ping-pong overlaps MTE2 (fill) and MTE3 (drain): one extra chunk cost.
    # n_chunks is already the PER-CORE chunk count (cores pay their
    # doorbells concurrently, not a shared pool split n_aiv_cores ways), so
    # the overhead term carries no further /n_aiv_cores discount — the Fig. 5
    # anchors (<20 µs @ ≤1 MB, 2 cores; 9 MB 2-vs-48-core ratio 2.5-3×)
    # hold with MTE_SETUP / per_msg_overhead unchanged.
    pipe = per_core_bytes / per_core_bw
    return (MTE_SETUP + f.base_latency
            + n_chunks * f.per_msg_overhead
            + pipe + min(UNIFIED_BUFFER_BYTES // 2, per_core_bytes)
            / MTE_PER_CORE_BW)


def dma_transfer_time(nbytes: int, fabric: Fabric = "ub") -> float:
    """Bulk DMA path (§2.2/§3.3): higher setup, no buffer bound. The rate
    is the fabric's own aggregate ``bandwidth * n_links`` — 392 GB/s for
    UB's 8 planes, a single NIC's worth for RoCE/VPC."""
    f = FABRICS[fabric]
    return DMA_SETUP + f.base_latency + nbytes / (f.bandwidth * f.n_links)


def best_transfer_time(nbytes: int, fabric: Fabric = "ub") -> float:
    """XCCL picks MTE for small payloads, DMA for bulk (§3.3 trade-off)."""
    return min(mte_transfer_time(nbytes, 8, fabric),
               mte_transfer_time(nbytes, AIV_CORES_PER_DIE, fabric),
               dma_transfer_time(nbytes, fabric))


def dispatch_latency_model(batch_per_die: int, hidden: int, ep: int,
                           top_k: int, quantized: bool = True) -> float:
    """§3.2 dispatch: metadata broadcast (one 32-byte field per rank,
    scalar-throughput bound) + pull phase. Calibrated to Fig. 6 / Fig. 20
    (≈234 µs average dispatch at bpd 96, EP128; INT8 dispatch overtakes
    bf16 combine past bpd ≈ 32)."""
    elem = 1 if quantized else 2
    payload_total = batch_per_die * top_k * hidden * elem
    # quantization: a fixed vector-pipeline ramp cost (the bf16 read
    # overlaps the MTE2 fill, so no separate read pass)
    quant_cost = 7.0e-6 if quantized else 0.0
    t_meta = ep * 1.2e-6          # per-rank metadata write + poll
    t_pull = mte_transfer_time(int(payload_total), AIV_CORES_PER_DIE)
    return t_meta + quant_cost + t_pull


def a2e_latency_model(n_attn: int, n_expert: int, batch_per_die: int,
                      hidden: int, top_k: int) -> float:
    """§3.3 trampoline A2E: attention → trampolines (= n_attn experts),
    then trampolines → remaining experts. Two stages of ~equal payload,
    plus one metadata field per destination expert rank on the critical
    path (the trampoline bounds this at O(n_attn + n_expert); a naive
    pull design pays O(n_attn × n_expert) — the §3.3 scalar-throughput
    wall). Calibrated to the paper's 172 µs A2E at 160/288/bpd96."""
    payload_stage1 = batch_per_die * hidden  # int8 after fused quant
    stage1 = mte_transfer_time(payload_stage1, AIV_CORES_PER_DIE)
    fan2 = max(1, (n_expert - n_attn))
    payload_stage2 = payload_stage1 * top_k / max(n_expert, 1) * fan2
    stage2 = mte_transfer_time(int(payload_stage2), AIV_CORES_PER_DIE)
    t_meta = 0.5e-6 * n_expert
    return t_meta + stage1 + stage2
