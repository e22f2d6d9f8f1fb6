"""The plain references: float32 PyTorch, no kernel, no batching trick;
nothing here imports the program or JAX."""
