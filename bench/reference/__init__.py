"""Plain PyTorch references of the benchmark's configurations.

They import nothing of the port, and read only the configuration's
published keys and the benchmark's own weights.
"""
