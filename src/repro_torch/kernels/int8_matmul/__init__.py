"""W8A8 INT8 matrix product with the dequantizing epilogue (§4.7)."""
