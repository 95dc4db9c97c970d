"""Force kernels: the naive oracle, the two CUDA sweeps and the registry."""
