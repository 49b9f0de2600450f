"""Hierarchical federated learning on the port: FedAvg over stacked
client parameters (``fedavg_reduce``), the clients' local SGD (every
forward through ``gru_seq``), the continual HFL runner, the round
timeline (a copy of ``repro/fl/schedule.py``), and the LM training
layer's cluster-replicated parameters: the global sync and its int8
error-feedback variant, both through ``fedavg_reduce``, on one device
and with one cluster a rank over a ``DeviceMesh``.

The round-timeline types (``fl.schedule``: numpy/stdlib-only) are
imported eagerly; everything else is torch-backed and lazy (PEP 562),
as in the reference's facade, so the co-simulation stack (``sim``
imports ``round_schedule``) stays a torch-free importer (contract
LAYER001)."""
import importlib

from repro_torch.fl.schedule import RoundWindow, round_schedule

_LAZY = {
    "cluster_fedavg": "repro_torch.fl.aggregation",
    "fedavg": "repro_torch.fl.aggregation",
    "global_fedavg": "repro_torch.fl.aggregation",
    "ClientBatch": "repro_torch.fl.client",
    "draw_permutations": "repro_torch.fl.client",
    "eval_clients": "repro_torch.fl.client",
    "stack_clients": "repro_torch.fl.client",
    "train_clients_locally": "repro_torch.fl.client",
    "unstack_client": "repro_torch.fl.client",
    "cluster_divergence": "repro_torch.fl.collectives",
    "cluster_slice": "repro_torch.fl.collectives",
    "collective_bytes": "repro_torch.fl.collectives",
    "flat_allreduce": "repro_torch.fl.collectives",
    "global_sync": "repro_torch.fl.collectives",
    "global_sync_shardmap": "repro_torch.fl.collectives",
    "hierarchical_allreduce": "repro_torch.fl.collectives",
    "make_hfl_local_step_shardmap": "repro_torch.fl.collectives",
    "reset_collective_bytes": "repro_torch.fl.collectives",
    "stack_for_clusters": "repro_torch.fl.collectives",
    "EFState": "repro_torch.fl.compression",
    "compressed_global_sync": "repro_torch.fl.compression",
    "compressed_global_sync_manual": "repro_torch.fl.compression",
    "compressed_global_sync_shardmap": "repro_torch.fl.compression",
    "dequantize_int8": "repro_torch.fl.compression",
    "init_ef_state": "repro_torch.fl.compression",
    "quantize_int8": "repro_torch.fl.compression",
    "sync_bytes": "repro_torch.fl.compression",
    "ContinualHFL": "repro_torch.fl.hierarchy",
    "HFLResult": "repro_torch.fl.hierarchy",
    "HFLRunConfig": "repro_torch.fl.hierarchy",
    "continuous_vs_static": "repro_torch.fl.hierarchy",
}

__all__ = ["RoundWindow", "round_schedule", "cluster_fedavg", "fedavg",
           "global_fedavg", "ClientBatch", "draw_permutations",
           "eval_clients", "stack_clients", "train_clients_locally",
           "unstack_client", "cluster_divergence", "cluster_slice",
           "global_sync", "stack_for_clusters", "collective_bytes",
           "flat_allreduce", "global_sync_shardmap", "hierarchical_allreduce",
           "make_hfl_local_step_shardmap", "reset_collective_bytes",
           "EFState", "compressed_global_sync",
           "compressed_global_sync_manual",
           "compressed_global_sync_shardmap", "dequantize_int8",
           "init_ef_state",
           "quantize_int8", "sync_bytes", "ContinualHFL", "HFLResult",
           "HFLRunConfig", "continuous_vs_static"]


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)
