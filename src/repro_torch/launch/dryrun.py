"""Multi-pod dry-run: size every (arch × shape) cell on the production
mesh (16×16 single-pod, 2×16×16 multi-pod) without allocating anything.

Port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each cell with XLA on 512 fake host devices and records its
``memory_analysis``, ``cost_analysis`` and the collective bytes parsed
from the compiled HLO.  The port has no compiler to ask.  Each record
holds what does not come from XLA:

* ``params_total`` and ``params_active`` (``analysis.active_params``);
* ``run``: the run configuration (``RUN_OVERRIDES``, the reference's);
* ``mem``: the analytic per-device memory model
  (``analysis.estimate_memory``) over the cell's sharding descriptions,
  the decode cache described by ``meta`` tensors (``cache_specs``), and
  the verdict against the H100's 80 GB, ``fits_80gb``;
* ``roofline``: ``model_flops_for_cell`` and the memory model's bytes at
  the H100's ceilings (``analysis.Roofline``);
* ``not_measured``: what the reference's record holds and the port
  cannot give — XLA's ``mem_xla``, the compiled program's flops and
  bytes, the collective bytes and the compile time.  No number stands
  in for them.

The train state, the parameters, the inputs and the cache are built as
``meta`` tensors with sharding descriptions (``abstract_state``,
``abstract_params``, ``input_specs``, ``cache_specs``), as the
reference builds its ``ShapeDtypeStruct`` inputs.

Usage::

  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
                                      [--out results/dryrun]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..configs.base import SHAPES, ModelConfig, RunConfig, ShapeCell
from ..configs.registry import cells, get_arch
from ..models import zoo
from ..models.params import abstract, abstract_params, torch_dtype
from ..roofline import analysis, hw
from ..sharding.logical import (default_rules, guarded_sharding,
                                set_active_mesh_axes)
from ..train.step import abstract_state
from .mesh import make_production_mesh

# Per-arch execution overrides (the reference's): big configs need FSDP;
# the 1T MoE needs a factored optimizer; microbatching divides
# activation memory for train cells.
RUN_OVERRIDES = {
    "kimi-k2-1t-a32b": RunConfig(fsdp=True, optimizer="adafactor",
                                 microbatches=16, remat_override="full"),
    "llava-next-34b": RunConfig(zero1=True, microbatches=8,
                                remat_override="full"),
    "internlm2-20b": RunConfig(fsdp=True, microbatches=8,
                               remat_override="full"),
    "mixtral-8x7b": RunConfig(zero1=True, microbatches=8,
                              remat_override="full"),
}
DEFAULT_RUN = RunConfig(microbatches=8, zero1=True)

# the reference record's fields that come from XLA's compiler
NOT_MEASURED = ("mem_xla", "hlo_flops", "hlo_bytes", "collective_bytes",
                "cross_pod_bytes", "useful_flops_ratio", "compile_s")


def run_config_for(arch: str) -> RunConfig:
    return RUN_OVERRIDES.get(arch, DEFAULT_RUN)


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.axis_sizes)


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh, rules) -> dict:
    """``meta`` stand-ins for every model input of the cell, each with
    its guarded sharding."""
    return {name: abstract(shape, torch_dtype(dtype),
                           guarded_sharding(shape, axes, rules, mesh))
            for name, (shape, dtype, axes)
            in zoo.batch_desc(cfg, cell).items()}


def cache_specs(cfg: ModelConfig, cell: ShapeCell, mesh, rules) -> dict:
    return {name: abstract(tuple(shape), torch_dtype(dtype),
                           guarded_sharding(tuple(shape), axes, rules, mesh))
            for name, (shape, axes, dtype)
            in zoo.cache_desc(cfg, cell).items()}


def prepare_cell(arch: str, shape_name: str, multi_pod: bool,
                 cfg: ModelConfig | None = None,
                 run: RunConfig | None = None, *,
                 cell: ShapeCell | None = None, mesh=None) -> dict:
    """Everything the reference's ``lower_cell`` builds before it
    lowers: the cell's config (the MoE dispatch groups and the remat
    override applied as the reference applies them), specs, mesh, rules
    and the abstract state or params, inputs and cache.  ``cell`` and
    ``mesh`` replace ``SHAPES[shape_name]`` and the production mesh."""
    cfg = cfg or get_arch(arch)
    run = run or run_config_for(arch)
    cell = cell or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(fsdp=run.fsdp, seq_shard=run.seq_shard_activations)
    if cfg.moe is not None and cfg.moe_dispatch_groups == 1:
        dp_total = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        cfg = dataclasses.replace(cfg, moe_dispatch_groups=dp_total)
    if run.remat_override and cfg.remat != run.remat_override:
        cfg = dataclasses.replace(cfg, remat=run.remat_override)
    specs = zoo.model_specs(cfg)
    out = dict(cfg=cfg, run=run, cell=cell, mesh=mesh, rules=rules,
               specs=specs, cache=None)
    set_active_mesh_axes(mesh.axis_names)
    try:
        if cell.kind == "train":
            out["state"] = abstract_state(cfg, run, specs, mesh, rules)
            out["batch"] = input_specs(cfg, cell, mesh, rules)
        else:
            out["params"] = abstract_params(specs, cfg.dtype, mesh, rules)
            out["batch"] = input_specs(cfg, cell, mesh, rules)
            if cell.kind == "decode":
                out["cache"] = cache_specs(cfg, cell, mesh, rules)
    finally:
        set_active_mesh_axes(())
    return out


def analyze_cell(arch: str, shape_name: str, multi_pod: bool,
                 cfg: ModelConfig | None = None,
                 run: RunConfig | None = None, *,
                 cell: ShapeCell | None = None, mesh=None) -> dict:
    """The cell's record (the module docstring says what it holds)."""
    t0 = time.perf_counter()
    c = prepare_cell(arch, shape_name, multi_pod, cfg, run, cell=cell,
                     mesh=mesh)
    cfg, run, cell, mesh = c["cfg"], c["run"], c["cell"], c["mesh"]
    n_chips = mesh.size
    model_flops = analysis.model_flops_for_cell(cfg, c["specs"], cell,
                                                n_chips)
    n_total, n_active = analysis.active_params(cfg, c["specs"])
    mem_model = analysis.estimate_memory(cfg, run, c["specs"], cell, mesh,
                                         c["rules"],
                                         cache_abstract=c["cache"])
    roof = analysis.Roofline(flops=model_flops,
                             hbm_bytes=float(mem_model["total"]),
                             model_flops=model_flops)
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(mesh),
        "n_chips": n_chips,
        "kind": cell.kind,
        "params_total": n_total,
        "params_active": n_active,
        "prepare_s": round(time.perf_counter() - t0, 3),
        "run": {"fsdp": run.fsdp, "microbatches": run.microbatches,
                "optimizer": run.optimizer, "remat": cfg.remat,
                "seq_shard": run.seq_shard_activations},
        "mem": {
            **{k: v / 2**30 for k, v in mem_model.items()},
            "bytes": mem_model,
            "live_gb": mem_model["total"] / 2**30,
            "fits_80gb": bool(mem_model["total"] <= hw.HBM_BYTES),
        },
        "roofline": roof.to_dict(),
        "not_measured": list(NOT_MEASURED),
    }


def fmt_row(rec: dict) -> str:
    r = rec["roofline"]
    return (f"{rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"live={rec['mem']['live_gb']:8.2f}GB "
            f"fits={'Y' if rec['mem']['fits_80gb'] else 'N'} "
            f"tc={r['t_compute_s']*1e3:9.2f}ms "
            f"tm={r['t_memory_s']*1e3:9.2f}ms "
            f"dom={r['bottleneck']:8s} "
            f"mfu_bound={r['mfu_bound']:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="results/dryrun")
    ap.add_argument("--fail-fast", action="store_true")
    args = ap.parse_args(argv)

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    todo = []
    if args.all:
        for arch, shape, skip in cells(include_skipped=True):
            for mp in meshes:
                todo.append((arch, shape, mp, skip))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        for mp in meshes:
            todo.append((args.arch, args.shape, mp, False))

    os.makedirs(args.out, exist_ok=True)
    ok = fail = 0
    for arch, shape, mp, skip in todo:
        mesh = "2x16x16" if mp else "16x16"
        path = os.path.join(args.out, f"{arch}__{shape}__{mesh}.json")
        if skip:
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "skipped": "full-attention arch: 500k dense-causal "
                              "context is out of contract (DESIGN.md)"}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"{arch:24s} {shape:12s} SKIP (full attention)")
            continue
        try:
            rec = analyze_cell(arch, shape, mp)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(fmt_row(rec))
            ok += 1
        except Exception as e:  # noqa: BLE001 - report the cell, go on
            fail += 1
            print(f"{arch:24s} {shape:12s} FAIL: {type(e).__name__}: {e}")
            with open(path + ".err", "w") as f:
                f.write(traceback.format_exc())
            if args.fail_fast:
                raise
    print(f"\ndry-run: {ok} ok, {fail} failed; not measured (no XLA "
          f"compiler): {', '.join(NOT_MEASURED)}")
    return 1 if fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
