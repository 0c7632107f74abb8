"""fp16_matmul: CUDA kernel wrapper (ops) and plain PyTorch version (plain)."""
