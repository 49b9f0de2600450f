"""The benchmark harness of the PyTorch and CUDA port (``repro_torch``).

Only :mod:`benchkit.program` imports the port; everything else here is
the yardstick: the cell's data, traffic generation, the drivers' clocks,
the reading of the profiler's trace, the rooflines and the comparison
with the plain reference under ``bench/reference``.
"""
