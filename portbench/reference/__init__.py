"""The plain reference that decides ``correct``: numpy, scipy and plain
PyTorch only; it imports nothing of the port and nothing of JAX."""
