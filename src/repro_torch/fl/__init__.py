"""Hierarchical federated learning on the port: FedAvg over stacked
client parameters (``fedavg_reduce``), the clients' local SGD (every
forward through ``gru_seq``), the continual HFL runner, and the round
timeline (a copy of ``repro/fl/schedule.py``)."""
from repro_torch.fl.aggregation import cluster_fedavg, fedavg, global_fedavg
from repro_torch.fl.client import (ClientBatch, draw_permutations,
                                   eval_clients, stack_clients,
                                   train_clients_locally, unstack_client)
from repro_torch.fl.hierarchy import (ContinualHFL, HFLResult, HFLRunConfig,
                                      continuous_vs_static)
from repro_torch.fl.schedule import RoundWindow, round_schedule

__all__ = ["RoundWindow", "round_schedule", "cluster_fedavg", "fedavg",
           "global_fedavg", "ClientBatch", "draw_permutations",
           "eval_clients", "stack_clients", "train_clients_locally",
           "unstack_client", "ContinualHFL", "HFLResult", "HFLRunConfig",
           "continuous_vs_static"]
