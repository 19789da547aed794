"""Plain PyTorch reference of the benchmark's split training step. It
imports nothing of the program and no JAX."""
