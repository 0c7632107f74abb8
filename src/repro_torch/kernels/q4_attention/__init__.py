"""q4_attention: CUDA kernel wrapper (ops) and plain PyTorch version (plain)."""
