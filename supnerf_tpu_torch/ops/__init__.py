"""Volume rendering and the fused render kernels with their plain versions."""
