"""The system under test: the only module of the harness that imports
the port (``repro_torch``).

:func:`arch_config` maps a configuration's published keys onto the
port's ``ArchConfig`` (the model by its architecture's module,
``configs/<model_type>.py``); :func:`serve_engine` builds the paged
engine the serving cells drive; :func:`load_kernels` builds or loads the port's
kernel library (in the checkout, at ``src/repro_torch/kernels/_build``).
"""
from __future__ import annotations

import sys
from typing import Any, Dict

from benchkit.spec import ROOT

if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import configs  # noqa: E402
from repro_torch.configs import base as port_configs  # noqa: E402


def arch_config(cfg: Dict[str, Any]):
    """The port's ``ArchConfig`` of a configuration: the model by its
    architecture's module (``configs/<model_type>.py``), a row's cache
    of ``serve.max_len`` slots (default: the published context)."""
    max_len = int(cfg.get("serve", {}).get("max_len",
                                           cfg["max_position_embeddings"]))
    run = port_configs.RunConfig(microbatches=1, remat="layer",
                                 max_cache_len=max_len)
    common = dict(name=cfg["name"], num_layers=cfg["num_hidden_layers"],
                  d_model=cfg["hidden_size"], vocab_size=cfg["vocab_size"],
                  act="silu",
                  tie_embeddings=bool(cfg["tie_word_embeddings"]),
                  dtype=cfg.get("torch_dtype", "bfloat16"),
                  param_dtype=cfg.get("torch_dtype", "bfloat16"))
    model = configs.arch(cfg).port_model(cfg, port_configs, common)
    return port_configs.ArchConfig(model=model, run=run)


def load_kernels() -> None:
    """Build (first run in a checkout) or load the kernel library."""
    from repro_torch.kernels import build
    build.load()


def serve_engine(cfg: Dict[str, Any], params: Dict[str, Any], rows: int,
                 device):
    """The paged continuous-batching engine over ``params`` (the tensors
    themselves: they are on ``device`` already), ``rows`` decode rows and
    a pool of ``serve.pages`` pages (default: the engine's, ``rows *
    max_len / page_size``)."""
    from repro_torch.serving.engine import PagedServeEngine
    serve = cfg.get("serve", {})
    return PagedServeEngine(arch_config(cfg), params, max_seqs=rows,
                            page_size=int(serve.get("page_size", 16)),
                            num_pages=serve.get("pages"), device=device)


def scheduler(engine):
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler
    return ContinuousBatchingScheduler(engine)


def request(req_id: int, prompt, max_new_tokens: int):
    from repro_torch.serving.scheduler import Request
    return Request(id=req_id, arrival_s=0.0, prompt=prompt,
                   max_new_tokens=max_new_tokens)


class HflTrainer:
    """The port's hierarchical-FL training of one configuration:
    ``make_hfl_train_step`` over ``clusters`` replicas stacked on the
    device (AdamW, the configuration's ``remat``) and ``hfl_global_round``
    as the sync, as ``launch/train.py --mode hfl`` runs them."""

    def __init__(self, cfg: Dict[str, Any], params: Dict[str, Any],
                 clusters: int, hyper: Dict[str, float]):
        from repro_torch.fl.collectives import stack_for_clusters
        from repro_torch.models import make_model
        from repro_torch.training.optimizer import AdamW
        from repro_torch.training.train_step import (init_hfl_opt_state,
                                                     make_hfl_train_step)
        arch = arch_config(cfg)
        self.opt = AdamW(lr=hyper["lr"], b1=hyper["b1"], b2=hyper["b2"],
                         eps=hyper["eps"], weight_decay=hyper["weight_decay"],
                         warmup_steps=int(hyper["warmup_steps"]),
                         state_dtype="float32")
        self.stacked = stack_for_clusters(params, clusters)
        self.opt_state = init_hfl_opt_state(self.opt, self.stacked)
        self._step = make_hfl_train_step(make_model(arch), arch, self.opt)

    def round(self, tokens):
        """One local round: every cluster one step on its rows of
        ``tokens`` (C, B, S + 1).  Returns the (C,) losses on the host."""
        batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}
        self.stacked, self.opt_state, losses = self._step(
            self.stacked, self.opt_state, batch)
        return losses.float().cpu()

    def sync(self) -> None:
        """The global round: every replica replaced by the mean."""
        from repro_torch.training.train_step import hfl_global_round
        self.stacked = hfl_global_round(self.stacked)

    def first_moments(self):
        """Every cluster's AdamW first moment, flat by leaf path."""
        from repro_torch.params import flatten_with_path
        return {"/".join(p): x for p, x in flatten_with_path(self.opt_state.m)}

    def params(self):
        """The stacked parameters, flat by leaf path."""
        from repro_torch.params import flatten_with_path
        return {"/".join(p): x for p, x in flatten_with_path(self.stacked)}
