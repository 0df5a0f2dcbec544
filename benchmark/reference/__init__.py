"""The plain reference: the upstream renderer's semantics in plain PyTorch and NumPy."""
