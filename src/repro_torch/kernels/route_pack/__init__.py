"""Route-pack: fused capacity-bucket packing of routed tokens."""
