"""The plain reference: fp32 PyTorch and NumPy, no kernel, no cache, nothing
of the program under test."""
