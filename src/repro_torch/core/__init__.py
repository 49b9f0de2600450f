"""The paper's primary contribution: HFLOP (inference-aware hierarchical
FL orchestration) — problem model, exact + heuristic solvers,
communication-cost accounting, and the cluster topology object consumed
by the FL runtime, the inference router, and the TPU mesh mapping."""
from repro_torch.core.hflop import (HFLOPInstance, HFLOPSolution, build_ilp,
                              is_feasible, objective, paper_cost_instance,
                              random_instance, violations)
from repro_torch.core.solvers import (local_search, solve_bnb, solve_bruteforce,
                                solve_decomposed, solve_greedy,
                                solve_heuristic, solve_uncapacitated)
from repro_torch.core.partition import (LanHFLOPInstance, Partition,
                                  default_regions, paper_cost_lan,
                                  partition_instance, sub_instance)
from repro_torch.core.costmodel import (GRU_MODEL_BYTES, CostReport, flat_fl_cost,
                                  hfl_cost, savings_vs_flat)
from repro_torch.core.topology import ClusterTopology

__all__ = [
    "HFLOPInstance", "HFLOPSolution", "build_ilp", "is_feasible",
    "objective", "paper_cost_instance", "random_instance", "violations",
    "local_search", "solve_bnb", "solve_bruteforce", "solve_decomposed",
    "solve_greedy", "solve_heuristic", "solve_uncapacitated",
    "LanHFLOPInstance", "Partition", "default_regions", "paper_cost_lan",
    "partition_instance", "sub_instance", "GRU_MODEL_BYTES",
    "CostReport", "flat_fl_cost", "hfl_cost", "savings_vs_flat",
    "ClusterTopology",
]
