"""Hand-written Hopper kernels of the port, one package per TPU kernel
they replace, and the ACCEL/HOST dispatch layer (``api``) over them."""
