"""Hand-written Hopper kernels of the port (``csrc/*.cu``), their
wrappers and their plain PyTorch versions (``ref``)."""
