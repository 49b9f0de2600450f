"""Orchestration under environment dynamics on the PyTorch/CUDA port
(paper §III + §VI), the steps of ``examples/orchestrate_dynamic.py``:
edge-node failure and capacity changes trigger re-clustering; the
deployment adapts while staying feasible.  The controller keeps no model
replicas here (no serving tiers), so it runs on the host; ``--device``
is where the deployment's replica pool would live.

Run:  PYTHONPATH=src python examples/orchestrate_dynamic_torch.py
      PYTHONPATH=src python examples/orchestrate_dynamic_torch.py --device cpu
"""
import argparse

from repro_torch.core import is_feasible
from repro_torch.device import resolve_device
from repro_torch.orchestration import LearningController, random_inventory


def show(dep, label):
    t = dep.topology
    print(f"--- {label} ---")
    print(t.describe())
    print(f"    services: {len(dep.inference_services)} "
          f"(aggregators on edges {dep.aggregator_nodes})")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    inv = random_inventory(n=30, m=6, seed=1, capacity_slack=1.6)
    ctl = LearningController(inventory=inv, l=2, device=str(device))
    dep = show(ctl.deploy(), "initial deployment") or ctl.deployment

    # an edge host fails -> learning controller re-clusters
    failed = dep.aggregator_nodes[0]
    print(f"\n!! edge {failed} failed")
    dep = ctl.on_node_failure(failed)
    show(dep, "after failure re-clustering")
    inst = ctl.inventory.to_instance(l=2)
    assert is_feasible(inst, dep.topology.assign)
    after_failure = dep.topology.assign.copy()

    # a co-located workload halves one edge's serving capacity
    victim = dep.aggregator_nodes[0]
    new_cap = ctl.inventory.edges[victim].capacity_rps * 0.5
    print(f"\n!! edge {victim} capacity drops to {new_cap:.1f} req/s")
    dep = ctl.on_capacity_change(victim, new_cap)
    show(dep, "after capacity re-clustering")
    inst = ctl.inventory.to_instance(l=2)
    assert is_feasible(inst, dep.topology.assign)
    print(f"\nreclusterings performed: {ctl.recluster_count}")
    return {"failed": failed, "after_failure": after_failure,
            "final": dep.topology.assign, "reclusters": ctl.recluster_count}


if __name__ == "__main__":
    main()
