"""Dry run at production size without the cards, the counterpart of
``repro/launch/dryrun.py``: every (architecture x input shape) traced on
the production meshes of ``launch/mesh.py`` (256 ranks as (data 32,
model 8), 512 as (pod 2, data 32, model 8)) over a fake process group,
on fake CPU tensors (``launch/specs.py``): nothing is allocated and
nothing is sent.  Each rank's program is traced as rank 0 runs it; the
record holds its memory, a roofline from the trace
(``launch/roofline.py``) and the analytic model (``launch/analytic.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch gemma3-1b --shape train_4k --mesh single,multi

Results are cached as JSON under --out (default results/dryrun_torch);
reruns skip cached combos unless --force.  A process has one default
process group, so each mesh size runs in a subprocess of its own
(:func:`run_in_subprocess`); a combo that fails is recorded with
``ok: false`` and its traceback, and the summary counts it.

Where the reference lowers and compiles (``lower_s``, ``compile_s``),
the port traces (``trace_s``).  What a trace runs, and how it is scaled,
is in each record's ``traced``:

- train: one microbatch's loss and gradients, counted ``microbatches``
  times, then one optimizer update.  Where the config's microbatch
  count would leave a data rank less than one row, fewer and larger
  microbatches are traced (``microbatches`` beside the config's).
- prefill: the forward over the prompt (as the reference's prefill
  program); decode: one step over a full cache.
- the sLSTM's loop over time (xlstm-125m): ``recurrent_steps_traced``
  steps, counted as the sequence's (``models/xlstm.py``).

``memory.argument_bytes`` is one rank's bytes of parameters, optimizer
state and batch (or tokens and cache); no tracker gives a peak under
fake tensors, so there is no ``temp_bytes`` or ``peak_bytes``: the
activations' high-water mark is the analytic one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import INPUT_SHAPES, applicable_shapes, get_config
from repro_torch.configs.registry import ASSIGNED
from repro_torch.launch import shardings as sh
from repro_torch.launch.analytic import (activation_peak_bytes,
                                        analytic_roofline)
from repro_torch.launch.mesh import (HBM_BYTES, init_fake_world,
                                     make_production_mesh)
from repro_torch.launch.roofline import (TraceCounter, analyze,
                                         model_flops_for)
from repro_torch.launch.specs import (cache_specs, decode_token_specs,
                                      model_batch_specs, param_specs_and_axes)
from repro_torch.models import make_model, xlstm
from repro_torch.models.common import logical_sharding, mesh_shape
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_step import value_and_grad

MESHES = {"single": ("32x8", 256), "multi": ("2x32x8", 512)}
#: sLSTM steps a trace runs; the rest are counted, not run
RECURRENT_STEPS = 32


def _zeros_like_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v, dtype) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=dtype)


def _batch_rows(mesh, rules) -> int:
    """Ranks the batch axis is split over on ``mesh``."""
    sizes = mesh_shape(mesh)
    n = 1
    for a in rules.get("batch", ()):
        n *= sizes.get(a, 1)
    return n


def build_programs(cfg, shape, mesh, rules, fake_mode: FakeTensorMode,
                   mode_override: Optional[str] = None):
    """(program, arguments, notes) for the config and input shape:
    ``program(trace)`` runs it under ``trace`` (a :class:`TraceCounter`);
    the arguments are the DTensor trees it reads (for their bytes); the
    notes say what is traced."""
    mode = mode_override or shape.mode
    api = make_model(cfg)
    with fake_mode:
        p_fake, axes = param_specs_and_axes(api, fake_mode)
        p_pl = sh.params_shardings(axes, p_fake, mesh, rules)
        params = sh.distribute_tree(p_fake, mesh, p_pl)
    notes: Dict[str, Any] = {"mode": mode}

    if mode == "train":
        opt = AdamW(lr=cfg.run.learning_rate,
                    state_dtype=cfg.run.opt_state_dtype)
        k_cfg = max(cfg.run.microbatches, 1)
        dp = _batch_rows(mesh, rules)
        k = max(1, min(k_cfg, shape.global_batch // dp))
        mb_shape = dataclasses.replace(shape,
                                       global_batch=shape.global_batch // k)
        st_dtype = torch.float32 if cfg.run.opt_state_dtype == "float32" \
            else torch.bfloat16
        with fake_mode:
            opt_state = AdamWState(
                step=torch.zeros((), dtype=torch.int32),
                m=sh.distribute_tree(_zeros_like_tree(p_fake, st_dtype),
                                     mesh, p_pl),
                v=sh.distribute_tree(_zeros_like_tree(p_fake, st_dtype),
                                     mesh, p_pl))
            spec = model_batch_specs(cfg, mb_shape, True, fake_mode)
            batch = sh.distribute_tree(
                spec, mesh, sh.batch_shardings(spec, mesh, rules))
        notes.update(microbatches=k, config_microbatches=k_cfg,
                     microbatch_rows=mb_shape.global_batch,
                     traced_microbatches=1)

        def program(trace: TraceCounter):
            with logical_sharding(mesh, rules):
                trace.scale = float(k)
                _, grads = value_and_grad(api.loss, params, batch)
                trace.scale = 1.0
                opt.update(grads, opt_state, params)
        return program, (params, opt_state, batch), notes

    if mode == "prefill":
        with fake_mode:
            spec = model_batch_specs(cfg, shape, False, fake_mode)
            batch = sh.distribute_tree(
                spec, mesh, sh.batch_shardings(spec, mesh, rules))

        def program(trace: TraceCounter):
            with logical_sharding(mesh, rules), torch.no_grad():
                api.forward(params, batch)
        return program, (params, batch), notes

    # decode
    with fake_mode:
        c_fake = cache_specs(api, shape.global_batch, shape.seq_len,
                             fake_mode)
        cache = sh.distribute_tree(c_fake, mesh,
                                   sh.cache_shardings(c_fake, mesh, rules))
        tok, pos = decode_token_specs(cfg, shape, fake_mode)
        tok = sh.distribute_tree(
            tok, mesh, sh.batch_shardings({"tokens": tok}, mesh,
                                          rules)["tokens"])
        pos = torch.zeros((), dtype=torch.int32)

    def program(trace: TraceCounter):
        with logical_sharding(mesh, rules), torch.no_grad():
            api.decode_step(params, tok, pos, cache)
    return program, (params, tok, cache), notes


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              rules_overrides=()) -> Dict[str, Any]:
    """One combo on the production mesh; the process must be rank 0 of a
    fake world of the mesh's size (:func:`init_fake_world`)."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = get_config(arch)
    rules = sh.rules_for(cfg, mesh, overrides=rules_overrides
                         or cfg.run.sharding_overrides)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": MESHES["multi" if multi_pod else "single"][0],
        "n_chips": mesh.size(),
    }
    rec.update(trace_combo(cfg, INPUT_SHAPES[shape_name], mesh, rules))
    rec["ok"] = True
    return rec


def trace_combo(cfg, shape, mesh, rules,
                recurrent_steps: int = RECURRENT_STEPS) -> Dict[str, Any]:
    """The record's measured part for ``cfg`` at ``shape`` on ``mesh`` (a
    ``DeviceMesh`` of fake or real ranks): trace time, what was traced,
    memory, the trace's roofline and the analytic one."""
    rec: Dict[str, Any] = {}
    fake_mode = FakeTensorMode()
    t0 = time.perf_counter()
    program, args, notes = build_programs(cfg, shape, mesh, rules,
                                          fake_mode)
    trace = TraceCounter()
    with xlstm.bounded_recurrence(recurrent_steps, trace) as steps:
        with fake_mode, implicit_replication(), trace:
            program(trace)
    rec["trace_s"] = time.perf_counter() - t0
    if steps["traced"]:
        notes["recurrent_steps_traced"] = steps["traced"]
        notes["recurrent_steps"] = steps["total"]
    notes["aten_ops"] = trace.ops
    rec["traced"] = notes
    args_b = sh.local_bytes(args)
    act_b = activation_peak_bytes(cfg, shape, mesh)
    live = args_b + act_b
    rec["memory"] = {"argument_bytes": args_b,
                     "activation_peak_bytes_analytic": act_b,
                     "fits_hbm": bool(live <= HBM_BYTES),
                     "hbm_fraction": live / HBM_BYTES}
    roof = analyze(trace, mesh, model_flops_for(cfg, shape))
    rec["roofline"] = roof.as_dict()
    rec["roofline"]["collective_groups"] = dict(trace.groups)
    ana = analytic_roofline(cfg, shape, mesh)
    rec["analytic"] = ana.as_dict()
    rec["analytic"]["mfu_upper_bound"] = ana.mfu(
        model_flops_for(cfg, shape) / mesh.size())
    return rec


def combos(arch_filter=None, shape_filter=None):
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            if arch_filter and arch not in arch_filter:
                continue
            if shape_filter and shape.name not in shape_filter:
                continue
            yield arch, shape.name


def _tag(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{MESHES[mesh_kind][0]}"


def _failed(arch, shape, mesh_kind, err: str, tb: str) -> Dict[str, Any]:
    return {"arch": arch, "shape": shape, "mesh": MESHES[mesh_kind][0],
            "ok": False, "error": err, "traceback": tb}


def run_mesh(mesh_kind: str, todo: Iterable[Tuple[str, str]], out: str,
             rules_overrides=()) -> List[Dict[str, Any]]:
    """Every combo of ``todo`` on one mesh in this process (rank 0 of a
    fake world of that mesh's size), one JSON file a combo under
    ``out`` (none when ``out`` is empty); ``rules_overrides`` as
    :func:`run_combo` takes them."""
    init_fake_world(MESHES[mesh_kind][1])
    recs = []
    for arch, shape in todo:
        try:
            rec = run_combo(arch, shape, mesh_kind == "multi",
                            rules_overrides)
        except Exception as e:  # noqa: BLE001 -- recorded, and counted
            rec = _failed(arch, shape, mesh_kind, repr(e),
                          traceback.format_exc())
        if out:
            with open(os.path.join(out, _tag(arch, shape, mesh_kind)
                                   + ".json"), "w") as f:
                json.dump(rec, f, indent=2)
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def run_in_subprocess(mesh_kind: str, todo: List[Tuple[str, str]],
                      timeout: Optional[float] = None, rules_overrides=()
                      ) -> List[Dict[str, Any]]:
    """:func:`run_mesh` in a child process (a fresh default group), its
    records read back from its output.  A child that dies records every
    combo it did not finish as failed."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    call = (f"run_mesh({mesh_kind!r}, {list(todo)!r}, '', "
            f"{tuple((k, tuple(v)) for k, v in rules_overrides)!r})")
    cmd = [sys.executable, "-c",
           f"from repro_torch.launch.dryrun import run_mesh; {call}"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=timeout)
        lines, err = proc.stdout.splitlines(), proc.stderr
    except subprocess.TimeoutExpired as e:
        lines = (e.stdout or b"").decode().splitlines() \
            if isinstance(e.stdout, bytes) else (e.stdout or "").splitlines()
        err = f"timed out after {timeout} s"
    recs = []
    for line in lines:
        if line.startswith("{"):
            recs.append(json.loads(line))
    done = {(r["arch"], r["shape"]) for r in recs}
    for arch, shape in todo:
        if (arch, shape) not in done:
            recs.append(_failed(arch, shape, mesh_kind,
                                "the worker process did not finish it",
                                err[-4000:]))
    return recs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="", help="comma-separated filter")
    ap.add_argument("--shape", default="", help="comma-separated filter")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    arch_f = set(args.arch.split(",")) if args.arch else None
    shape_f = set(args.shape.split(",")) if args.shape else None
    results = []
    t0 = time.perf_counter()
    for mesh_kind in args.mesh.split(","):
        todo = []
        for arch, shape in combos(arch_f, shape_f):
            path = os.path.join(args.out, _tag(arch, shape, mesh_kind)
                                + ".json") if args.out else ""
            if path and os.path.exists(path) and not args.force:
                with open(path) as f:
                    results.append(json.load(f))
                print(f"[cached] {_tag(arch, shape, mesh_kind)}")
                continue
            todo.append((arch, shape))
        if not todo:
            continue
        print(f"[trace] {len(todo)} combos on {MESHES[mesh_kind][0]} ...",
              flush=True)
        for rec in run_in_subprocess(mesh_kind, todo):
            tag = _tag(rec["arch"], rec["shape"], mesh_kind)
            if args.out:
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
            results.append(rec)
            r = rec.get("roofline", {})
            status = "OK" if rec.get("ok") else "FAIL " + rec.get("error", "")
            print(f"  {tag}: {status} trace={rec.get('trace_s', 0):.1f}s "
                  f"dominant={r.get('dominant', '?')} "
                  f"compute={r.get('compute_s', 0):.2e}s "
                  f"coll={r.get('collective_s', 0):.2e}s", flush=True)
    ok = sum(1 for r in results if r.get("ok"))
    print(f"\n{ok}/{len(results)} combos traced "
          f"({len(results) - ok} failed) in "
          f"{time.perf_counter() - t0:.1f} s")
    if ok != len(results):
        sys.exit(1)


if __name__ == "__main__":
    main()
