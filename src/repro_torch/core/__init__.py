"""Transformerless (§5): the model split into placeable units, the
partition planner, the dataflow runtime, and the two disaggregated
deployments — Prefill-Decode (§5.1, task executors joined by DistFlow)
and MoE-Attention (§5.2, attention and expert halves exchanging A2E/E2A
payloads, with the DP-domain pipeline model)."""
from repro_torch.core.dataflow import DataflowGraph, Node, Packet, Port, Tag
from repro_torch.core.moe_attn_disagg import (DisaggregatedMoEAttention,
                                              DomainPipeline, PipelineReport,
                                              StageTimes, paper_stage_times)
from repro_torch.core.pd_disagg import (REMOTE_SEED_COST, DecodeTE,
                                        DisaggregatedPD, PrefillTE)
from repro_torch.core.transformerless import (PartitionPlan, UnitSpec,
                                              plan_partition, split_model)

__all__ = ["DataflowGraph", "Node", "Packet", "Port", "Tag",
           "DisaggregatedMoEAttention", "DomainPipeline", "PipelineReport",
           "StageTimes", "paper_stage_times",
           "REMOTE_SEED_COST", "DecodeTE", "DisaggregatedPD", "PrefillTE",
           "PartitionPlan", "UnitSpec", "plan_partition", "split_model"]
