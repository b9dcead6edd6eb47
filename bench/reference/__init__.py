"""Plain references that decide a run's `correct`: NumPy and plain
PyTorch, importing nothing of the program, JAX or the JAX package."""
