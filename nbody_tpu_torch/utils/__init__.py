"""Host-side helpers (numpy copies of the JAX package's) and the kernel build."""
