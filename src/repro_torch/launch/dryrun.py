"""Multi-pod dry run: trace one step of every (arch × shape × mesh) cell
on placeholder ranks (a port of :mod:`repro.launch.dryrun`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out artifacts/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh tiny \\
        --reduced --arch gemma2-2b --shape train_4k --out DIR

It runs on the CPU and needs no card.  Where the reference forces 512
placeholder host devices and lowers and compiles each cell with XLA, the
port

* starts a process group of placeholder ranks in this one process
  (:func:`repro_torch.launch.mesh.fake_process_group`: 256 for
  ``pod16x16``, 512 for ``pod2x16x16``, 4 for ``tiny2x2``) and builds the
  mesh over it, on ``"cpu"``;
* places the parameters, optimizer state, inputs and caches as DTensors
  by :class:`~repro_torch.distributed.sharding.ShardingRules` (GSPMD's
  shardings);
* traces one step under ``FakeTensorMode`` (nothing is allocated and
  nothing is launched) with the activation constraints of
  :mod:`repro_torch.distributed.act_shard` set, and counts what each rank
  would run (:class:`~repro_torch.launch.opcount.TraceCounter`: dot
  FLOPs, collectives, memory) in place of ``cost_analysis()``,
  ``memory_analysis()`` and the HLO's collectives;
* reports the three-term roofline on the H100's constants
  (:mod:`repro_torch.launch.roofline`).

The traced step is the train step (gradients through ``value_and_grad``
and the AdamW update, remat policy ``REPRO_REMAT_POLICY``, "full" by
default), the forward (prefill) or the serve step (decode, with the
decode layout: weights stationary, batch activations replicated).  Each
cell prints one SKIP, FAIL or OK line; a failed cell does not stop the
sweep, and the exit code is 1 if any failed.  Each OK cell writes
``<out>/<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.common.tree import leaves_with_paths, map_with_paths
from repro_torch.configs.base import SHAPES, ShapeCell, cell_applicable, \
    get_shape
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed.act_shard import activation_sharding
from repro_torch.distributed.sharding import ShardingRules, to_placements, \
    tree_pspecs
from repro_torch.launch import roofline as roofline_mod
from repro_torch.launch.mesh import (fake_process_group, make_mesh,
                                     make_production_mesh, n_chips)
from repro_torch.launch.opcount import TraceCounter
from repro_torch.models import api, transformer
from repro_torch.optim import adamw
from repro_torch.train.step import (TrainConfig, make_decode_step,
                                    make_train_step)

#: seconds a cell's trace may take: the port traces op by op on the host,
#: where XLA compiles a scan's body once, so a host loop over every
#: position (xLSTM's sLSTM) takes its sequence's length in steps; such a
#: cell fails on its budget and the sweep goes on
TRACE_BUDGET_S = 120.0

#: mesh name -> (shape, axes), the meshes ``--mesh`` offers
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "tiny2x2": ((2, 2), ("data", "model"))}


def pick_layout(cfg, shape, n_devices: int) -> str:
    """Small models gain nothing from 16-way TP for train and prefill, so
    both axes go to data/FSDP — but only where the global batch divides
    the whole device count."""
    if shape.mode == "decode":
        return "default"
    if shape.global_batch % n_devices != 0:
        return "default"
    active = (transformer.active_param_count(cfg) if not cfg.encdec
              else cfg.d_model * cfg.d_model * 12 * cfg.n_layers)
    return "fsdp_only" if active < 4e9 else "default"


def _place(rules: ShardingRules, specs: Any, kind: str, mesh) -> Any:
    """Fake DTensors of ``specs``' global shapes and types, placed by
    ``rules`` (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import distribute_tensor
    pspecs = tree_pspecs(rules, specs, kind)
    flat = dict(leaves_with_paths(pspecs, lambda x: not isinstance(x, dict)))

    def one(path, s):
        return distribute_tensor(torch.empty(s.shape, dtype=s.dtype), mesh,
                                 to_placements(flat[path], mesh))
    return map_with_paths(one, specs, lambda x: not isinstance(x, dict))


def _tensors(tree: Any):
    return [x for _, x in leaves_with_paths(
        tree, lambda x: not isinstance(x, (dict, tuple, list)))
        if isinstance(x, torch.Tensor)]


def trace_cell(cfg, shape: ShapeCell, mesh, *, layout: str = "auto",
               attribute: bool = False,
               budget_s: Optional[float] = TRACE_BUDGET_S
               ) -> Dict[str, Any]:
    """Trace one step of the cell on ``mesh`` (a mesh over placeholder
    ranks) under ``FakeTensorMode`` within ``budget_s`` seconds (None: no
    limit); returns {"counter", "trace_s", "args_bytes", "out_bytes",
    "rules"}.  ``attribute`` turns on the counter's sites
    (:class:`~repro_torch.launch.opcount.TraceCounter`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    if layout == "auto":
        layout = pick_layout(cfg, shape, n_chips(mesh))
    rules = ShardingRules(mesh, layout=layout)
    tp_size = (rules.axis_sizes[rules.tp_axis]
               if rules.layout == "default" else 1)
    pspecs = api.param_specs(cfg)
    counter = TraceCounter(budget_s, attribute=attribute)
    with FakeTensorMode(), implicit_replication():
        params = _place(rules, pspecs, "params", mesh)
        if shape.mode == "decode":
            rules_dec = ShardingRules(mesh, replicate_batch=True)
            ctx = activation_sharding(
                rules_dec.batch_axes, rules_dec.tp_axis,
                rules_dec.axis_sizes[rules_dec.tp_axis], batch_size=1,
                fsdp_axis=rules_dec.fsdp_axis,
                fsdp_size=rules_dec.axis_sizes[rules_dec.fsdp_axis],
                mode="decode")
            inputs = _place(rules_dec, api.input_specs(cfg, shape),
                            "inputs", mesh)
            # the serve step's position is a host integer
            inputs["pos"] = shape.seq_len - 1
            cache = _place(rules, api.cache_specs(cfg, shape.global_batch,
                                                  shape.seq_len),
                           "cache", mesh)
            step = make_decode_step(cfg)
            args = (params, cache, inputs)
        else:
            ctx = activation_sharding(
                rules.batch_axes,
                rules.tp_axis if rules.layout == "default" else "", tp_size,
                batch_size=math.prod(rules.axis_sizes[a]
                                     for a in rules.batch_axes),
                gather_axes=rules._fsdp_axes)
            inputs = _place(rules, api.input_specs(cfg, shape), "inputs",
                            mesh)
            if shape.mode == "train":
                tcfg = TrainConfig(remat=True, remat_policy=os.environ.get(
                    "REPRO_REMAT_POLICY", "full"))
                # the moments shard like the parameters (ZeRO-3); the
                # count is replicated
                count = DTensor.from_local(
                    torch.zeros((), dtype=torch.int32), mesh,
                    [Replicate()] * mesh.ndim, run_check=False)
                opt = adamw.AdamWState(
                    count,
                    _place(rules, adamw.state_specs(pspecs).mu, "params",
                           mesh),
                    _place(rules, adamw.state_specs(pspecs).nu, "params",
                           mesh))
                step = make_train_step(cfg, tcfg)
                args = (params, opt, inputs)
            else:
                def step(params, batch):
                    with torch.no_grad():
                        return api.forward(params, cfg, batch)[0]
                args = (params, inputs)
        arg_tensors = _tensors(args)
        counter.track(arg_tensors)
        args_bytes = counter.live_bytes
        t0 = time.perf_counter()
        with ctx, counter, counter.attribution():
            out = step(*args)
        trace_s = time.perf_counter() - t0
        out_bytes = sum(
            (x._local_tensor if isinstance(x, DTensor) else x).nbytes
            for x in _tensors(out))
    return {"counter": counter, "trace_s": trace_s, "args_bytes": args_bytes,
            "out_bytes": out_bytes, "rules": rules}


def _total_params(cfg) -> int:
    return sum(math.prod(s.shape) for _, s in transformer.leaves(
        api.param_specs(cfg)))


def _active_params(cfg) -> int:
    if not cfg.encdec:
        return transformer.active_param_count(cfg)
    return _total_params(cfg) - cfg.vocab * cfg.d_model


def report_cell(cfg, shape: ShapeCell, mesh, mesh_name: str):
    """Trace one cell (:func:`trace_cell`) and its roofline; returns
    (the :class:`~repro_torch.launch.roofline.RooflineReport`, the
    trace's dict)."""
    t = trace_cell(cfg, shape, mesh)
    active = _active_params(cfg)
    report = roofline_mod.analyze(
        t["counter"], cfg, shape, mesh_name, n_chips(mesh),
        roofline_mod.model_flops_for(cfg, shape, active),
        total_params=_total_params(cfg), active_params=active)
    return report, t


def run_cell(arch_id: str, shape_name: str, mesh, mesh_name: str,
             reduced: bool, outdir: Optional[str]) -> Dict[str, Any]:
    """Trace and report one cell: SKIP where the cell does not apply,
    FAIL (with the traceback on stderr) where the trace raises, else OK
    and the artifact."""
    cfg = get_config(arch_id, reduced=reduced)
    shape = get_shape(shape_name)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        print(f"SKIP  {arch_id:24s} {shape_name:12s} {mesh_name:10s} "
              f"{reason}", flush=True)
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    try:
        report, t = report_cell(cfg, shape, mesh, mesh_name)
    except Exception as e:  # noqa: BLE001 — report, continue the sweep
        traceback.print_exc()
        print(f"FAIL  {arch_id:24s} {shape_name:12s} {mesh_name}: {e}",
              flush=True)
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
                "status": "fail", "error": str(e)[:500]}
    counter = t["counter"]
    print(f"OK    {roofline_mod.format_report(report)} "
          f"trace={t['trace_s']:6.1f}s", flush=True)
    peak = int(counter.peak_bytes)
    result = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "layout": t["rules"].layout,
              "trace_s": t["trace_s"],
              "roofline": report.to_dict(),
              "memory_analysis": {
                  "argument_size_in_bytes": int(t["args_bytes"]),
                  "output_size_in_bytes": int(t["out_bytes"]),
                  "temp_size_in_bytes": peak - int(t["args_bytes"]),
                  "peak_size_in_bytes": peak},
              "collectives": {
                  "bytes_by_kind": counter.collectives.bytes_by_kind,
                  "count_by_kind": counter.collectives.count_by_kind},
              "skipped_shardings": t["rules"].skipped}
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        fn = os.path.join(outdir, f"{arch_id}__{shape_name}__{mesh_name}.json")
        with open(fn, "w") as f:
            json.dump(result, f, indent=1)
    return result


def _mesh(mesh_name: str):
    """The mesh ``mesh_name`` over the whole (placeholder) process group."""
    shape, axes = MESHES[mesh_name]
    if mesh_name == "tiny2x2":
        return make_mesh(shape, axes, device_type="cpu")
    return make_production_mesh(multi_pod=len(shape) == 3,
                                device_type="cpu")


def sweep(arch_ids, shape_names, mesh_name: str, reduced: bool,
          outdir: Optional[str]) -> list:
    """Every (arch × shape) cell on one mesh, over its own group of
    placeholder ranks, torn down after."""
    with fake_process_group(math.prod(MESHES[mesh_name][0])):
        mesh = _mesh(mesh_name)
        return [run_cell(a, s, mesh, mesh_name, reduced, outdir)
                for a in arch_ids for s in shape_names]


#: ``--mesh`` of one cell -> mesh name
CELL_MESHES = {"single": "pod16x16", "multi": "pod2x16x16",
               "tiny": "tiny2x2"}


def attributed_cell(argv=None, description: Optional[str] = None
                    ) -> Dict[str, Any]:
    """The command line of the attribution tools
    (``tools/torch_top_dots.py``, ``tools/torch_attribute_collectives.py``):
    ``arch shape [--mesh single|multi|tiny] [--reduced] [--json PATH]``,
    the rank count from ``REPRO_DRYRUN_DEVICES`` as the reference's tools
    read it (it picks the mesh of that many ranks where ``--mesh`` is not
    given, and must be that mesh's where it is; without either, 256 ranks
    of ``pod16x16``).  Traces the cell with the counter's sites on and no
    time budget (the sites' tracebacks take 2-3 times as long);
    returns the parsed arguments under "args" and :func:`trace_cell`'s
    dict."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("--mesh", choices=sorted(CELL_MESHES), default=None)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--json", default=None,
                    help="also write the exact totals and every site here")
    args = ap.parse_args(argv)
    env = os.environ.get("REPRO_DRYRUN_DEVICES")
    by_ranks = {math.prod(MESHES[m][0]): k for k, m in CELL_MESHES.items()}
    mesh = args.mesh or (by_ranks.get(int(env)) if env else "single")
    ranks = math.prod(MESHES[CELL_MESHES[mesh]][0]) if mesh else None
    if mesh is None or (env and int(env) != ranks):
        ap.error(f"REPRO_DRYRUN_DEVICES={env}: the mesh spans every rank; "
                 + ", ".join(f"--mesh {k} takes {n}"
                             for n, k in by_ranks.items()))
    cfg = get_config(args.arch, reduced=args.reduced)
    shape = get_shape(args.shape)
    ok, reason = cell_applicable(cfg, shape)
    if not ok:
        ap.exit(1, f"SKIP {args.arch} {args.shape}: {reason}\n")
    with fake_process_group(ranks):
        t = trace_cell(cfg, shape, _mesh(CELL_MESHES[mesh]), attribute=True,
                       budget_s=None)
    t["args"] = args
    return t


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "tiny"])
    ap.add_argument("--reduced", action="store_true",
                    help="use reduced configs (a smoke of the dry-run path)")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    arch_ids = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shape_names = [s.name for s in SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
              "both": ["pod16x16", "pod2x16x16"],
              "tiny": ["tiny2x2"]}[args.mesh]
    t0 = time.perf_counter()
    results = []
    for mesh_name in meshes:
        results += sweep(arch_ids, shape_names, mesh_name, args.reduced,
                         args.out)
    n = {k: sum(r["status"] == k for r in results)
         for k in ("ok", "skip", "fail")}
    print(f"\ndry-run: {n['ok']} ok, {n['skip']} skip, {n['fail']} fail "
          f"({time.perf_counter() - t0:.1f} s)")
    return 1 if n["fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
