"""Batched test-time optimization: pose refiner, core loop and driver."""
