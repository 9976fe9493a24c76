"""Serving stack: FlowServe engine, DP groups, TE-shell, backend."""
from repro_torch.serving.mtp import MTPDecoder, MTPStats
