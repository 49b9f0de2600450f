"""Hierarchical federated learning on the port: FedAvg over stacked
client parameters (``fedavg_reduce``), the clients' local SGD (every
forward through ``gru_seq``), the continual HFL runner, the round
timeline (a copy of ``repro/fl/schedule.py``), and the LM training
layer's cluster-replicated parameters: the global sync and its int8
error-feedback variant, both through ``fedavg_reduce``, on one device
and with one cluster a rank over a ``DeviceMesh``."""
from repro_torch.fl.aggregation import cluster_fedavg, fedavg, global_fedavg
from repro_torch.fl.client import (ClientBatch, draw_permutations,
                                   eval_clients, stack_clients,
                                   train_clients_locally, unstack_client)
from repro_torch.fl.collectives import (cluster_divergence, cluster_slice,
                                        collective_bytes, flat_allreduce,
                                        global_sync, global_sync_shardmap,
                                        hierarchical_allreduce,
                                        make_hfl_local_step_shardmap,
                                        reset_collective_bytes,
                                        stack_for_clusters)
from repro_torch.fl.compression import (EFState, compressed_global_sync,
                                        compressed_global_sync_manual,
                                        compressed_global_sync_shardmap,
                                        dequantize_int8, init_ef_state,
                                        quantize_int8, sync_bytes)
from repro_torch.fl.hierarchy import (ContinualHFL, HFLResult, HFLRunConfig,
                                      continuous_vs_static)
from repro_torch.fl.schedule import RoundWindow, round_schedule

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
