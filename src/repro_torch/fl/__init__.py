from repro_torch.fl.aggregation import cluster_fedavg, fedavg, global_fedavg

__all__ = ["cluster_fedavg", "fedavg", "global_fedavg"]
