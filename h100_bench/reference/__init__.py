"""The plain reference of the benchmark: float32 PyTorch, no kernel, no
import of the program (``repro_torch``) or of the JAX package."""
