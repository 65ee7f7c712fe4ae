"""Core numerics: precision policy, quantization, plane decompositions, plans."""
