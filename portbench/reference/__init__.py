"""The plain reference the port's outputs are judged by: plain PyTorch and
NumPy, float32, importing nothing of the port and nothing of JAX."""
