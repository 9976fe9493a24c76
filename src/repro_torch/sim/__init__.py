"""SuperPod-scale deterministic discrete-event simulator.

Drives the *real* serving control plane — ``PrefillScheduler``,
``DecodeLoadBalancer``, ``pick_prefill_te``, ``TEShell`` EPLB triggering,
tiered heartbeats, ``plan_partition`` — against a modeled CloudMatrix384
fabric (roofline-derived compute, XCCL link latencies) with model
execution replaced by cost-model stubs, so scheduler/EPLB/reliability
behaviour at 384-die scale is testable in CI seconds.

It is host code on numpy and Python floats, as the port's control plane
is: it places no tensor and takes no device. Every time it reports is a
MODELED CloudMatrix384 time, never a measurement of the card; seeded
reports (``SimReport.to_json``, the sha256 ``trace_hash``) equal the
reference simulator's byte for byte. Measured rows enter through
``SuperPodCostModel.from_calibration``.

Two deployments share the loop (``SimConfig.deployment``): the
colocated decode plan and the §5.2 MoE-Attention disaggregated mode
(separate attention/expert pools, A2E/E2A trampolines, the
``DomainPipeline`` closed form cross-validated against its discrete
schedule).
"""
from repro_torch.sim.events import EventLoop, SimClock
from repro_torch.sim.fabric import (CostModelBackend, DieModel,
                                    FabricModel, MoEAttnIterCost,
                                    SuperPodCostModel)
from repro_torch.sim.workload import WorkloadConfig, WorkloadGen
from repro_torch.sim.metrics import MetricsCollector, SimReport
from repro_torch.sim.engine import FaultPlan, SimConfig, SuperPodSim

__all__ = [
    "EventLoop", "SimClock",
    "CostModelBackend", "DieModel", "FabricModel", "MoEAttnIterCost",
    "SuperPodCostModel",
    "WorkloadConfig", "WorkloadGen",
    "MetricsCollector", "SimReport",
    "FaultPlan", "SimConfig", "SuperPodSim",
]
