"""q4_matmul: CUDA kernel wrapper (ops) and plain PyTorch version (plain)."""
