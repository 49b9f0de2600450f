"""PyTorch/CUDA port of the ``repro`` package, one slice at a time.

This slice serves the paper's traffic GRU from every tier: the model
(:mod:`repro_torch.models.gru`), FedAvg over client replicas
(:mod:`repro_torch.fl.aggregation`), the tiered replica pool
(:mod:`repro_torch.serving.replica`) and the latency model its
measurements calibrate (:mod:`repro_torch.routing.latency`).  Two
hand-written CUDA kernels carry the path: ``gru_seq`` and
``fedavg_reduce`` (:mod:`repro_torch.kernels.ops`).

The package imports ``torch`` and ``numpy`` only: never ``jax`` and
nothing of ``repro``.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"`` (:func:`repro_torch.device.resolve_device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
