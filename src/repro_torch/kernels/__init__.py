"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``, ``sm_90a``).

Each subpackage follows the contract: ``kernel.py`` (ctypes wrapper that
launches the CUDA kernel and counts launches), ``ops.py`` (entry point:
the kernel for a CUDA tensor, the plain version for a CPU tensor),
``ref.py`` (the plain PyTorch version).

  route_pack — capacity rank + INT8 quantize + bucket scatter (§3.2/§4.7)
  gmm        — grouped expert FFN, plain and owner-indexed (§3.2/§4.5)
  decode_attention — flash-decoding GQA attention over the KV cache
  quant_dispatch — token-wise INT8 quantization (§3.2/§4.7)
  int8_matmul — W8A8 INT8 product with the dequantizing epilogue (§4.7)
  collect    — EPLB Collect: per-expert histogram of routed ids (§4.5)
"""
