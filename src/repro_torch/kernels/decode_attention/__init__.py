"""Flash-decoding GQA attention over a KV cache."""
