"""The plain reference that decides ``correct``: plain PyTorch and NumPy, a
frozen copy of the port's model code and of the plain versions of its
kernels, importing nothing of the port and nothing of JAX."""
