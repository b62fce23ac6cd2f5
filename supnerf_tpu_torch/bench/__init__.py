"""Benchmarks of the port: CUDA microbenchmarks (*.cu, plain nvcc) and the host
decoders' timing (decode_seconds.py)."""
