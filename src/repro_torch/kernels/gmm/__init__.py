"""Grouped SwiGLU expert FFN (plain and EPLB owner-indexed)."""
