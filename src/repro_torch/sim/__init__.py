"""The event core of the simulation stack, and the request plane the
routing simulator runs on: copies of ``repro/sim/events.py`` and
``repro/sim/request_plane.py``.

The event core is imported eagerly; the request plane is lazy (PEP 562)
because it imports ``repro_torch.routing.rules``, whose package imports
the simulator, which builds on ``repro_torch.sim.events``: an eager
import here would close that cycle.  The co-simulation, the reactive
loop, scenarios, faults, budgets and interference are not ported yet.
"""
import importlib

from repro_torch.sim.events import (EVENT_EFFECTS, Event, EventEffect,
                                    EventKind, EventQueue, Simulation,
                                    control_trace)

_LAZY = {
    "ColumnarLog": "repro_torch.sim.request_plane",
    "bucket_admissions": "repro_torch.sim.request_plane",
    "occupancy_replay": "repro_torch.sim.request_plane",
}

__all__ = ["EVENT_EFFECTS", "Event", "EventEffect", "EventKind",
           "EventQueue", "Simulation", "control_trace"] + list(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(module), name)
