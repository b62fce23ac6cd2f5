"""supnerf_tpu_torch: the PyTorch / CUDA port of supnerf_tpu for one NVIDIA
H100. It imports torch and numpy only, never the JAX package; its render
kernels are CUDA C++ in csrc/, built with nvcc at first use."""
