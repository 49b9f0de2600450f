"""Training–inference co-simulation subsystem.

The event core is imported eagerly; the co-sim engine and reactive loop
are lazy (PEP 562) because they import ``repro_torch.routing.simulator``,
which itself builds on ``repro_torch.sim.events`` — eager imports here would
close that cycle.
"""
import importlib

from repro_torch.sim.events import (EVENT_EFFECTS, Event, EventEffect, EventKind,
                              EventQueue, Simulation, control_trace)

_LAZY = {
    "CoSim": "repro_torch.sim.cosim",
    "CoSimConfig": "repro_torch.sim.cosim",
    "CoSimResult": "repro_torch.sim.cosim",
    "ColumnarLog": "repro_torch.sim.request_plane",
    "bucket_admissions": "repro_torch.sim.request_plane",
    "occupancy_replay": "repro_torch.sim.request_plane",
    "InterferenceConfig": "repro_torch.sim.interference",
    "InterferenceModel": "repro_torch.sim.interference",
    "AccuracyModel": "repro_torch.sim.reactive",
    "ReactiveLoop": "repro_torch.sim.reactive",
    "ReactivePolicy": "repro_torch.sim.reactive",
    "BudgetEntry": "repro_torch.sim.budget",
    "ReconfigBudget": "repro_torch.sim.budget",
    "SCENARIOS": "repro_torch.sim.scenarios",
    "Scenario": "repro_torch.sim.scenarios",
    "ScenarioResult": "repro_torch.sim.scenarios",
    "run_scenario": "repro_torch.sim.scenarios",
    "run_grid": "repro_torch.sim.scenarios",
}

__all__ = ["EVENT_EFFECTS", "Event", "EventEffect", "EventKind",
           "EventQueue", "Simulation", "control_trace"] + list(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)
