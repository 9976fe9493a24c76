"""Roofline terms of a step from its FLOPs, bytes and collective bytes,
at the H100's bounds (``analysis.py``)."""
