"""Continual hierarchical FL runner — the paper's §V-B2 experiments
(Fig. 6): 20 clients, 4 clusters, 5 local epochs per round, 2 local
aggregations per global aggregation, sliding continual-learning window;
per-client validation MSE recorded right after the client receives the
(cluster/global) model.  Counterpart of ``repro/fl/hierarchy.py``.

It runs on the card unless the caller passes ``device="cpu"``: each
round's windows are built on the host and moved to the device once,
local training runs every forward through ``gru_seq`` and every
aggregation through ``fedavg_reduce``.

Two things the JAX package draws from its key chain are parameters
here: ``params0``, the initial model (a numpy or tensor tree; without
it the model is drawn from a ``torch.Generator`` seeded with
``run.seed``), and ``permutations``, a callable ``(round, C, epochs, N)
-> (C, epochs, N)`` that gives each round's minibatch orders (without
it they are drawn from a ``torch.Generator`` seeded with
``run.seed + 1``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.topology import ClusterTopology
from repro_torch.data.traffic import (TrafficDataset, continual_split,
                                      windows_for_sensor)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fl.aggregation import cluster_fedavg, fedavg, global_fedavg
from repro_torch.fl.client import (ClientBatch, draw_permutations,
                                   eval_clients, stack_clients,
                                   train_clients_locally)
from repro_torch.fl.schedule import RoundWindow, round_schedule
from repro_torch.models import gru
from repro_torch.params import from_numpy_tree, tree_map

Tree = Any
#: (round, C, epochs, N) -> (C, epochs, N) integer permutations of range(N)
Permutations = Callable[[int, int, int, int], torch.Tensor]


def _even_indices(n: int, k: int) -> np.ndarray:
    """k indices spread evenly over [0, n) (all of them if n <= k)."""
    if n <= k:
        return np.arange(n)
    return np.linspace(0, n - 1, k).astype(int)


@dataclass
class HFLRunConfig:
    rounds: int = 100
    local_epochs: int = 5
    batch_size: int = 16
    lr: float = 1e-4
    history: int = 12
    train_days: int = 21
    val_days: int = 7
    shift_steps: int = 36
    max_batches: int = 40            # subsample batches/epoch for speed
    max_val_windows: int = 512
    seed: int = 0


@dataclass
class HFLResult:
    mse: np.ndarray                  # (rounds, clients) val MSE per round
    train_loss: np.ndarray           # (rounds, clients)
    mode: str

    def converged_round(self, tol: float = 1.05) -> int:
        """First round whose mean MSE is within tol x of the min."""
        means = self.mse.mean(axis=1)
        target = means.min() * tol
        idx = np.nonzero(means <= target)[0]
        return int(idx[0]) if idx.size else len(means) - 1


def _initial_params(cfg: ArchConfig, seed: int, params0: Optional[Tree],
                    device: torch.device) -> Tree:
    if params0 is None:
        params0 = gru.init_params(torch.Generator().manual_seed(seed),
                                  cfg.model, "cpu")
    return from_numpy_tree(params0, device)


def _generator_permutations(seed: int) -> Permutations:
    gen = torch.Generator().manual_seed(seed)
    return lambda _round, C, epochs, N: draw_permutations(gen, C, epochs, N)


def _to_batch(X: np.ndarray, y: np.ndarray, device: torch.device
              ) -> ClientBatch:
    return ClientBatch(X=torch.as_tensor(X, device=device),
                       y=torch.as_tensor(y, device=device))


class ContinualHFL:
    """mode: 'flat' (centralized FedAvg every round),
             'hier' (cluster aggregation each round, global every l)."""

    def __init__(self, cfg: ArchConfig, ds: TrafficDataset,
                 sensors: np.ndarray, topo: ClusterTopology,
                 run: HFLRunConfig, mode: str = "hier", *,
                 params0: Optional[Tree] = None,
                 permutations: Optional[Permutations] = None,
                 device: DeviceLike = None):
        if mode not in ("flat", "hier"):
            raise ValueError(f"mode must be 'flat' or 'hier', got {mode!r}")
        self.cfg, self.ds, self.run, self.mode = cfg, ds, run, mode
        self.device = resolve_device(device)
        self.sensors = np.asarray(sensors)
        self.topo = topo
        # cluster ids compacted to 0..k-1 for segment ops
        assign = topo.assign[:len(self.sensors)] \
            if topo.assign.shape[0] >= len(self.sensors) else topo.assign
        uniq = {int(j): k for k, j in enumerate(np.unique(assign))}
        self.cluster_ids = np.asarray([uniq[int(j)] for j in assign])
        params = _initial_params(cfg, run.seed, params0, self.device)
        self.params = stack_clients([params] * len(self.sensors))
        self.weights = np.ones(len(self.sensors))
        self.permutations = (permutations if permutations is not None
                             else _generator_permutations(run.seed + 1))

    def round_schedule(self, rounds: Optional[int] = None,
                       epoch_s: float = 6.0, upload_s: float = 2.0,
                       **kwargs) -> List[RoundWindow]:
        """Timeline of this run's rounds for the co-simulation."""
        return round_schedule(rounds or self.run.rounds, l=self.topo.l,
                              local_epochs=self.run.local_epochs,
                              epoch_s=epoch_s, upload_s=upload_s, **kwargs)

    def _round_data(self, round_idx: int):
        r = self.run
        tr, va = continual_split(self.ds, round_idx, r.train_days,
                                 r.val_days, r.shift_steps)
        Xs, ys, Xv, yv = [], [], [], []
        for s in self.sensors:
            X, y = windows_for_sensor(self.ds, int(s), tr.start, tr.stop,
                                      r.history)
            Xs.append(X)
            ys.append(y)
            X2, y2 = windows_for_sensor(self.ds, int(s), va.start, va.stop,
                                        r.history)
            # subsample the val week EVENLY: max_val_windows contiguous
            # windows cover only ~max_val_windows*5min, so a truncated
            # prefix slides through the daily cycle as rounds shift and
            # the metric tracks time-of-day, not learning
            idx = _even_indices(len(X2), r.max_val_windows)
            Xv.append(X2[idx])
            yv.append(y2[idx])
        return (_to_batch(np.stack(Xs), np.stack(ys), self.device),
                _to_batch(np.stack(Xv), np.stack(yv), self.device))

    def run_rounds(self, rounds: Optional[int] = None,
                   progress: bool = False) -> HFLResult:
        r = self.run
        rounds = rounds or r.rounds
        C = len(self.sensors)
        mse_hist, loss_hist = [], []
        for t in range(rounds):
            train, val = self._round_data(t)
            perms = self.permutations(t, C, r.local_epochs,
                                      train.X.shape[1])
            self.params, losses = train_clients_locally(
                self.params, train, perms, cfg=self.cfg,
                epochs=r.local_epochs, batch_size=r.batch_size, lr=r.lr,
                max_batches=r.max_batches)
            if self.mode == "flat":
                glob = fedavg(self.params, self.weights)
                self.params = tree_map(
                    lambda g: g.expand((C,) + tuple(g.shape)).contiguous(),
                    glob)
            else:
                if (t + 1) % self.topo.l == 0:      # global round
                    self.params = global_fedavg(self.params,
                                                self.cluster_ids,
                                                self.weights)
                else:                                # local round
                    self.params = cluster_fedavg(self.params,
                                                 self.cluster_ids,
                                                 self.weights)
            val_mse = eval_clients(self.params, val, cfg=self.cfg)
            mse_hist.append(val_mse.cpu().numpy())
            loss_hist.append(losses.cpu().numpy())
            if progress and (t % 10 == 0 or t == rounds - 1):
                print(f"  round {t:3d}: mean val MSE "
                      f"{float(np.mean(mse_hist[-1])):.5f}")
        return HFLResult(mse=np.stack(mse_hist),
                         train_loss=np.stack(loss_hist), mode=self.mode)


def continuous_vs_static(cfg: ArchConfig, ds: TrafficDataset, sensor: int,
                         run: HFLRunConfig, rounds: int = 20, *,
                         params0: Optional[Tree] = None,
                         permutations: Optional[Permutations] = None,
                         device: DeviceLike = None) -> Dict[str, float]:
    """Paper §V-B1: a single continuously-retrained model vs a one-shot
    model, evaluated on the final validation week.

    Like the JAX package, which passes one key to every training call,
    every call trains on the same minibatch orders: ``permutations`` is
    asked once per window length, with round 0, and its answer reused."""
    dev = resolve_device(device)
    stacked = stack_clients([_initial_params(cfg, run.seed, params0, dev)])
    permutations = (permutations if permutations is not None
                    else _generator_permutations(run.seed))
    perms_by_len: Dict[int, torch.Tensor] = {}

    def data(round_idx):
        tr, va = continual_split(ds, round_idx, run.train_days,
                                 run.val_days, run.shift_steps)
        X, y = windows_for_sensor(ds, sensor, tr.start, tr.stop, run.history)
        Xv, yv = windows_for_sensor(ds, sensor, va.start, va.stop,
                                    run.history)
        idx = _even_indices(len(Xv), run.max_val_windows)
        return (_to_batch(X[None], y[None], dev),
                _to_batch(Xv[idx][None], yv[idx][None], dev))

    def train(params, batch):
        N = batch.X.shape[1]
        if N not in perms_by_len:
            perms_by_len[N] = permutations(0, 1, run.local_epochs, N)
        params, _ = train_clients_locally(
            params, batch, perms_by_len[N], cfg=cfg, epochs=run.local_epochs,
            batch_size=run.batch_size, lr=run.lr,
            max_batches=run.max_batches)
        return params

    # static: train once on round-0 window
    tr0, _ = data(0)
    static = stacked
    for _ in range(4):               # a few extra passes, like 20 epochs
        static = train(static, tr0)
    # continual: retrain on each shifted window
    cont = stacked
    for t in range(rounds):
        trt, _ = data(t)
        cont = train(cont, trt)
    _, va_last = data(rounds - 1)
    mse_static = float(eval_clients(static, va_last, cfg=cfg)[0])
    mse_cont = float(eval_clients(cont, va_last, cfg=cfg)[0])
    return {"static_mse": mse_static, "continual_mse": mse_cont}
