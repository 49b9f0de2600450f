"""The rest of the simulation stack on the port (``repro_torch.sim``:
co-simulation, reactive loop, scenarios, faults, budgets, interference,
copies of the reference's modules) against ``repro.sim``, and the five
examples that run on it or on the port's training pipeline, on the CPU.

- every scenario of ``SCENARIOS`` under every policy through
  ``run_scenario`` in both packages at the reference tests' 40 s
  (``tests/test_faults.py``): the same records, down to the event trace
  and every request's latency; the churn scenario with a ``Telemetry``
  attached: the same spans, metrics and decision audit;
- ``examples/{orchestrate_dynamic,scenario_suite,trace_reactive_run}
  _torch.py`` print what the reference examples print;
  ``continual_hfl_traffic_torch.py`` and
  ``reactive_orchestration_torch.py`` run at a small size, on the CPU."""
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.sim import scenarios as jax_scenarios  # noqa: E402
from repro.telemetry import Telemetry as JaxTelemetry  # noqa: E402
from repro_torch import sim  # noqa: E402
from repro_torch.sim import scenarios  # noqa: E402
from repro_torch.telemetry import Telemetry  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
DURATION = 40.0
POLICIES = ("static", "reactive", "budgeted")


def _record(res):
    """Everything a ScenarioResult holds, the request log as arrays."""
    out = {f.name: getattr(res, f.name)
           for f in dataclasses.fields(res) if f.name != "log"}
    out["log"] = {k: np.asarray(v) for k, v in vars(res.log).items()
                  if isinstance(v, np.ndarray)}
    out["fingerprint"] = res.fingerprint()
    out["control_fingerprint"] = res.control_fingerprint()
    return out


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in got:
        if k == "log":
            assert set(got[k]) == set(want[k]) and got[k]
            for col in got[k]:
                assert np.array_equal(got[k][col], want[k][col]), col
        else:
            assert got[k] == want[k], k


def test_sim_package_exports_the_references_names():
    import repro.sim as jax_sim
    assert sim.__all__ == jax_sim.__all__
    for name in sim.__all__:
        obj = getattr(sim, name)
        assert obj is not getattr(jax_sim, name), name
        if hasattr(obj, "__module__"):
            assert obj.__module__.startswith("repro_torch."), name


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", sorted(jax_scenarios.SCENARIOS))
def test_scenario_records_match_the_reference(name, policy):
    assert sorted(scenarios.SCENARIOS) == sorted(jax_scenarios.SCENARIOS)
    kw = dict(seed=0, duration_s=DURATION)
    if policy == "budgeted":
        kw["budget_total"] = scenarios.default_budget_total()
    got = scenarios.run_scenario(scenarios.SCENARIOS[name](), policy, **kw)
    want = jax_scenarios.run_scenario(jax_scenarios.SCENARIOS[name](),
                                      policy, **kw)
    assert got.n_requests > 0
    _assert_same(_record(got), _record(want))


def test_scenario_telemetry_matches_the_reference():
    tels = Telemetry(), JaxTelemetry()
    for mod, tel in zip((scenarios, jax_scenarios), tels):
        mod.run_scenario(mod.SCENARIOS["churn"](), "budgeted", seed=0,
                         duration_s=DURATION, telemetry=tel)
    got, want = tels
    assert got.tracer.spans and got.audit.records
    assert [vars(s) for s in got.tracer.spans] == \
        [vars(s) for s in want.tracer.spans]
    assert [vars(r) for r in got.audit.records] == \
        [vars(r) for r in want.audit.records]
    assert got.audit.counts() == want.audit.counts()
    for name in ("requests.total", "training.rounds_completed",
                 "reconfig.swaps", "alarms.latency"):
        assert got.metrics.value(name) == want.metrics.value(name), name


def _example(name):
    path = os.path.join(EXAMPLES, name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,argv", [
    ("orchestrate_dynamic", []),
    ("scenario_suite", []),
    ("trace_reactive_run", ["--duration", "60"])])
def test_host_examples_print_what_the_reference_prints(
        name, argv, capsys, monkeypatch, tmp_path):
    ours = _example(name + "_torch")
    theirs = _example(name)
    out = {}
    for key, mod, extra in (("port", ours, ["--device", "cpu"]),
                            ("ref", theirs, [])):
        d = tmp_path / key
        args = argv + (["--out", str(d)] if name == "trace_reactive_run"
                       else [])
        if name == "scenario_suite":
            monkeypatch.setattr(theirs, "DURATION", 30.0)
            args += ["--duration", "30"] if mod is ours else []
        monkeypatch.setattr(sys, "argv", [name] + args + extra)
        result = (mod.main(args + extra) if mod is ours else mod.main())
        out[key] = capsys.readouterr().out.replace(str(d), "OUT")
        if mod is ours:
            assert result
    assert out["port"] == out["ref"]
    assert out["port"].count("\n") > 5


def test_continual_hfl_traffic_example_runs_on_the_cpu(capsys):
    out = _example("continual_hfl_traffic_torch").main(
        ["--device", "cpu", "--reduced", "--rounds", "2",
         "--max-batches", "2"])
    assert str(out["device"]) == "cpu"
    assert len(out["mse"]) == 2 and np.isfinite(out["mse"]).all()
    assert (out["topology"].assign >= 0).all()
    assert "[GLOBAL]" in capsys.readouterr().out


def test_reactive_orchestration_example_runs_on_the_cpu(capsys):
    out = _example("reactive_orchestration_torch").main(
        ["--device", "cpu", "--duration", "150"])
    # the drifted regime raises the trained model's validation MSE, and
    # the co-simulation's reactive loop acts on it
    assert np.isfinite(out["base_mse"]) and out["drift_mse"] > \
        out["base_mse"]
    assert out["result"].actions and out["reclusters"] >= 0
    assert "accuracy alarm" in capsys.readouterr().out
