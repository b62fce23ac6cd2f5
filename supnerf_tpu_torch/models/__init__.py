"""SUP-NeRF modules in PyTorch, with the reference's parameter names."""
