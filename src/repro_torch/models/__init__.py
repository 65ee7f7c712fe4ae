"""Models: config, parameters, quantization, KV cache, transformer."""
