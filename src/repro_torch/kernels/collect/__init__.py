"""EPLB Collect: the per-expert histogram of routed ids (§4.5)."""
