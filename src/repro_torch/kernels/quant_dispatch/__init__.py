"""Token-wise INT8 quantization (§3.2 step 2, §4.7)."""
