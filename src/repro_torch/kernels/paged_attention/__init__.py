"""paged_attention: decode attention gathered over per-lane page tables,
the CUDA route (ops) and the plain PyTorch version (plain)."""
