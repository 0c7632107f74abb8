"""slstm_scan: CUDA kernel wrapper (ops) and plain PyTorch version (plain)."""
