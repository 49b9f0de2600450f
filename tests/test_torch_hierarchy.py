"""The port's continual HFL runner (``repro_torch.fl.hierarchy``) against
``repro.fl.hierarchy`` on the reduced GRU (hidden 32): the per-round
validation MSE and train loss of both modes over the quickstart's
topology, a topology with non-participating (-1) devices and more
devices than clients, ``continuous_vs_static`` with its one reused key,
``HFLResult.converged_round``, and the steps of
``examples/quickstart_torch.py`` on the CPU.

Both runs start from the JAX package's initial model, carried over as
numpy, and train on the permutations its key chain draws: per round
``rng, sub = split(rng)`` from ``key(seed + 1)``, then per client and
epoch ``split(split(sub, C)[c], epochs)[e]``."""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.topology import ClusterTopology as JaxTopology  # noqa: E402
from repro.data.traffic import generate as jax_generate  # noqa: E402
from repro.fl import hierarchy as jax_hier  # noqa: E402
from repro.models import gru as jax_gru  # noqa: E402
from repro.orchestration import (DeviceNode as JaxDevice,  # noqa: E402
                                 EdgeNode as JaxEdge,
                                 Inventory as JaxInventory,
                                 LearningController as JaxController)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.topology import ClusterTopology  # noqa: E402
from repro_torch.data.traffic import generate, select_fl_sensors  # noqa: E402
from repro_torch.fl import hierarchy  # noqa: E402
from repro_torch.orchestration import (DeviceNode, EdgeNode,  # noqa: E402
                                       Inventory, LearningController)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-4
RUN = dict(rounds=3, max_batches=4, max_val_windows=64)


def jax_permutations(key, C, epochs, N):
    return np.stack([np.stack([np.asarray(jax.random.permutation(ek, N))
                               for ek in jax.random.split(ck, epochs)])
                     for ck in jax.random.split(key, C)])


def jax_round_permutations(seed):
    """The ``permutations`` callable that replays ``run_rounds``' key
    chain from ``key(seed)``; rounds must come in order."""
    state = {"rng": jax.random.key(seed), "round": 0}

    def draw(t, C, epochs, N):
        assert t == state["round"]
        state["round"] += 1
        state["rng"], sub = jax.random.split(state["rng"])
        return torch.from_numpy(jax_permutations(sub, C, epochs, N))

    return draw


def initial_params(jcfg, seed):
    params, _ = jax_gru.init_params(jax.random.key(seed), jcfg.model)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def datasets():
    return generate(num_days=30, seed=0), jax_generate(num_days=30, seed=0)


def quickstart_topology(ds, port):
    """The quickstart's 8 sensors and its HFLOP deployment's topology,
    built with either package."""
    Dev, Edge, Inv, Ctl = ((DeviceNode, EdgeNode, Inventory,
                            LearningController) if port else
                           (JaxDevice, JaxEdge, JaxInventory, JaxController))
    sensors = select_fl_sensors(ds, per_cluster=2, seed=0)
    lam = np.random.default_rng(0).uniform(2.0, 6.0, len(sensors))
    devices = [Dev(i, lam=float(lam[i]),
                   lan_edge=int(ds.cluster_of[sensors[i]]))
               for i in range(len(sensors))]
    edges = [Edge(j, capacity_rps=float(lam.sum() / 4 * 1.4))
             for j in range(4)]
    return sensors, Ctl(Inv(devices, edges), l=2).deploy().topology


def _run_both(datasets, sensors, jtopo, ttopo, mode, **run):
    ds, jds = datasets
    jcfg = jax_get_config("gru-traffic").reduced()
    tcfg = get_config("gru-traffic").reduced()
    jrun = jax_hier.HFLRunConfig(**run)
    trun = hierarchy.HFLRunConfig(**run)
    want = jax_hier.ContinualHFL(jcfg, jds, sensors, jtopo, jrun,
                                 mode=mode)
    got = hierarchy.ContinualHFL(
        tcfg, ds, sensors, ttopo, trun, mode=mode,
        params0=initial_params(jcfg, trun.seed),
        permutations=jax_round_permutations(trun.seed + 1), device="cpu")
    np.testing.assert_array_equal(got.cluster_ids, want.cluster_ids)
    return got, got.run_rounds(), want.run_rounds()


@pytest.mark.parametrize("mode", ["hier", "flat"])
def test_continual_hfl_matches_jax(datasets, mode):
    ds, jds = datasets
    sensors, ttopo = quickstart_topology(ds, port=True)
    _, jtopo = quickstart_topology(jds, port=False)
    np.testing.assert_array_equal(ttopo.assign, jtopo.assign)
    # 6 of the 8 devices train: the runner slices the topology's assign
    _, got, want = _run_both(datasets, sensors[:6], jtopo, ttopo, mode,
                             **RUN)
    assert got.mode == want.mode == mode
    assert got.mse.shape == got.train_loss.shape == (3, 6)
    assert np.isfinite(got.mse).all() and np.isfinite(got.train_loss).all()
    assert_allclose(got.mse, want.mse, rtol=RTOL)
    assert_allclose(got.train_loss, want.train_loss, rtol=RTOL)
    assert got.converged_round() == want.converged_round()


def test_non_participating_devices_form_a_cluster_of_their_own(datasets):
    """assign is longer than the client list (its tail is sliced off)
    and holds -1, which compacts to cluster id 0 like any other id."""
    ds, _ = datasets
    sensors = select_fl_sensors(ds, per_cluster=2, seed=0)[:5]
    assign = np.array([2, -1, 0, 2, -1, 1, 1])
    kw = dict(assign=assign, n_devices=7, n_edges=3, lam=np.ones(7),
              r=np.ones(3), l=2)
    hfl, got, want = _run_both(datasets, sensors, JaxTopology(**kw),
                               ClusterTopology(**kw), "hier",
                               rounds=2, max_batches=2, local_epochs=2,
                               max_val_windows=32)
    np.testing.assert_array_equal(hfl.cluster_ids, [2, 0, 1, 2, 0])
    assert_allclose(got.mse, want.mse, rtol=RTOL)
    assert_allclose(got.train_loss, want.train_loss, rtol=RTOL)


def test_continuous_vs_static_reuses_one_set_of_permutations(datasets):
    ds, jds = datasets
    jcfg = jax_get_config("gru-traffic").reduced()
    tcfg = get_config("gru-traffic").reduced()
    run = dict(local_epochs=2, max_batches=2, max_val_windows=32, seed=3)
    want = jax_hier.continuous_vs_static(jcfg, jds, 5,
                                         jax_hier.HFLRunConfig(**run),
                                         rounds=3)
    calls = []

    def permutations(t, C, epochs, N):
        calls.append((t, C, epochs, N))
        # the JAX function trains every call on key(seed) itself
        return torch.from_numpy(jax_permutations(
            jax.random.key(run["seed"]), C, epochs, N))

    got = hierarchy.continuous_vs_static(
        tcfg, ds, 5, hierarchy.HFLRunConfig(**run), rounds=3,
        params0=initial_params(jcfg, run["seed"]),
        permutations=permutations, device="cpu")
    assert len(calls) == 1 and calls[0][:3] == (0, 1, 2)
    assert set(got) == {"static_mse", "continual_mse"}
    for k in got:
        assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("mse", [
    [[3.0, 1.0], [1.0, 1.0], [0.9, 1.0]],       # within 5 % from round 1
    [[5.0], [4.0], [2.0], [1.0]],               # only the last round
    [[1.0, 1.0], [1.0, 1.0]],                   # flat: round 0
])
def test_converged_round_matches_jax(mse):
    mse = np.asarray(mse)
    loss = np.zeros_like(mse)
    got = hierarchy.HFLResult(mse=mse, train_loss=loss, mode="hier")
    want = jax_hier.HFLResult(mse=mse, train_loss=loss, mode="hier")
    for tol in (1.0, 1.05, 2.0):
        assert got.converged_round(tol) == want.converged_round(tol)


def test_default_draws_follow_the_seed(datasets):
    """Without ``params0`` and ``permutations`` a run is a function of
    ``run.seed`` alone."""
    ds, _ = datasets
    sensors, topo = quickstart_topology(ds, port=True)
    cfg = get_config("gru-traffic").reduced()
    results = []
    for seed in (0, 0, 1):
        run = hierarchy.HFLRunConfig(rounds=1, local_epochs=1,
                                     max_batches=2, max_val_windows=16,
                                     seed=seed)
        results.append(hierarchy.ContinualHFL(
            cfg, ds, sensors[:4], topo, run, device="cpu").run_rounds())
    np.testing.assert_array_equal(results[0].mse, results[1].mse)
    assert not np.array_equal(results[0].mse, results[2].mse)


def test_round_schedule_matches_jax(datasets):
    ds, jds = datasets
    sensors, ttopo = quickstart_topology(ds, port=True)
    _, jtopo = quickstart_topology(jds, port=False)
    run = dict(rounds=5, local_epochs=3)
    got = hierarchy.ContinualHFL(
        get_config("gru-traffic").reduced(), ds, sensors, ttopo,
        hierarchy.HFLRunConfig(**run), device="cpu").round_schedule()
    want = jax_hier.ContinualHFL(
        jax_get_config("gru-traffic").reduced(), jds, sensors, jtopo,
        jax_hier.HFLRunConfig(**run)).round_schedule()
    assert [dataclasses.asdict(w) for w in got] \
        == [dataclasses.asdict(w) for w in want]


def test_quickstart_torch_runs_its_steps_on_the_cpu():
    path = os.path.join(ROOT, "examples", "quickstart_torch.py")
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    out = quickstart.main(["--device", "cpu", "--reduced", "--rounds", "2",
                           "--max-batches", "2"])
    assert (out["topology"].assign >= 0).all()
    assert out["result"].mse.shape == (2, 8)
    assert np.isfinite(out["result"].mse).all()
    assert out["seconds_per_round"] > 0
    for tier in ("device", "edge", "cloud"):
        assert 0 < out["calibrated"].infer_ms(tier) < float("inf")
    for logs in (out["logs"], out["calibrated_logs"]):
        assert set(logs) == {"flat", "hflop"}
        assert all(np.isfinite(log.mean_latency()) for log in logs.values())
    flat, hier = out["costs"]
    assert hier.metered_bytes < flat.metered_bytes
