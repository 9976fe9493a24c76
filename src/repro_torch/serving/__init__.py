"""Serving stack: FlowServe engine, DP groups, TE-shell, backend."""
