"""XCCL's analytic link model, the KV transfer of disaggregated
Prefill-Decode (§5.1) and the token-wise INT8 wire format of the A2E
payload (§5.2)."""
from repro_torch.xccl.pd_transfer import (TransferPlan, assemble_chunks,
                                          chunk_stream_time,
                                          execute_transfer, plan_transfer,
                                          pytree_bytes, slice_kv_chunk,
                                          ub_read, ub_read_time)
from repro_torch.xccl.routing import dequantize_tokens, quantize_tokens
from repro_torch.xccl.topology import (CHIP_CLASSES, FABRICS, PodSpec,
                                       PodTopology, SuperPod,
                                       a2e_latency_model,
                                       best_transfer_time,
                                       dispatch_latency_model)

__all__ = [
    "CHIP_CLASSES", "FABRICS", "PodSpec", "PodTopology", "SuperPod",
    "a2e_latency_model", "best_transfer_time", "dispatch_latency_model",
    "TransferPlan", "assemble_chunks", "chunk_stream_time",
    "execute_transfer", "plan_transfer", "pytree_bytes", "slice_kv_chunk",
    "ub_read", "ub_read_time",
    "dequantize_tokens", "quantize_tokens",
]
