"""The plain PyTorch reference of the served models: imports neither JAX
nor anything of the program."""
