"""The port's LM-side sharding, dry-run, abstract state and elastic
restore against the reference's.

The reference's dry-run side (``repro.launch.dryrun``'s config
handling, ``repro.roofline.analysis``'s memory model, params and model
flops, ``spec_for`` of every parameter and cache leaf) needs the 256- and
512-device production meshes, so it runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=512`` (the flag
cannot be set in a process whose JAX is up), as
``tests/test_torch_sharding.py``'s ``shard_map`` test does; it writes
JSON, which the port's numbers are held to for every ``cells()`` arch ×
shape on both meshes.  The rest runs in this process on the CPU.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import cells, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import zoo
from repro_torch.models.params import (abstract_params, axes_tree,
                                       init_params)
from repro_torch.roofline import analysis
from repro_torch.runtime.elastic import (make_mesh_from, plan_mesh,
                                         reshard_state)
from repro_torch.sharding.logical import (LogicalMesh, NamedSharding,
                                          constrain, default_rules,
                                          guarded_sharding, maybe_constrain,
                                          set_active_mesh_axes, sharding_for,
                                          spec_for, tree_shardings)
from repro_torch.train.optim import tree_leaves
from repro_torch.train.step import (abstract_state, build_train_step,
                                    init_state)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REF_DRYRUN = r"""
import dataclasses, json, sys
import jax
from repro.configs.base import SHAPES
from repro.configs.registry import cells, get_arch
from repro.launch.dryrun import cache_specs, run_config_for
from repro.launch.mesh import make_production_mesh
from repro.models import zoo
from repro.models.params import ParamSpec
from repro.roofline import analysis
from repro.sharding.logical import default_rules, spec_for

def spec_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]

out = {}
for multi_pod in (False, True):
    mesh = make_production_mesh(multi_pod=multi_pod)
    for arch, shape, _ in cells():
        cfg, run, cell = get_arch(arch), run_config_for(arch), SHAPES[shape]
        rules = default_rules(fsdp=run.fsdp,
                              seq_shard=run.seq_shard_activations)
        if cfg.moe is not None and cfg.moe_dispatch_groups == 1:
            dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
            cfg = dataclasses.replace(cfg, moe_dispatch_groups=dp)
        if run.remat_override and cfg.remat != run.remat_override:
            cfg = dataclasses.replace(cfg, remat=run.remat_override)
        specs = zoo.model_specs(cfg)
        cache = cache_specs(cfg, cell, mesh, rules) \
            if cell.kind == "decode" else None
        flat = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, ParamSpec))[0]
        out[f"{arch}|{shape}|{multi_pod}"] = {
            "params": list(analysis.active_params(cfg, specs)),
            "model_flops": analysis.model_flops_for_cell(
                cfg, specs, cell, mesh.devices.size),
            "mem": analysis.estimate_memory(cfg, run, specs, cell, mesh,
                                            rules, cache_abstract=cache),
            "specs": {"/".join(k.key for k in path):
                      spec_list(spec_for(s.axes, rules, mesh, s.shape))
                      for path, s in flat},
            "cache": None if cache is None else
            {k: spec_list(v.sharding.spec) for k, v in cache.items()},
            "mesh": [list(mesh.axis_names),
                     [mesh.shape[a] for a in mesh.axis_names]],
        }
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def ref_dryrun(tmp_path_factory):
    """The reference's numbers for every cell on both production meshes,
    from a subprocess with 512 fake host devices."""
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("ref_dryrun") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, "-c", _REF_DRYRUN, str(out)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(out.read_text())


def _spec_list(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [("/".join(path), tree)]


CELLS = [(a, s, mp) for a, s, _ in cells() for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if mp else '16x16'}"
                              for a, s, mp in CELLS])
def test_dryrun_cell_equals_reference(ref_dryrun, arch, shape, multi_pod):
    want = ref_dryrun[f"{arch}|{shape}|{multi_pod}"]
    c = dryrun.prepare_cell(arch, shape, multi_pod)
    cfg, mesh = c["cfg"], c["mesh"]
    assert [list(mesh.axis_names), list(mesh.axis_sizes)] == want["mesh"]
    assert list(analysis.active_params(cfg, c["specs"])) == want["params"]
    assert analysis.model_flops_for_cell(cfg, c["specs"], c["cell"],
                                         mesh.size) == want["model_flops"]
    mem = analysis.estimate_memory(cfg, c["run"], c["specs"], c["cell"],
                                   mesh, c["rules"], cache_abstract=c["cache"])
    assert mem == want["mem"]
    got = {k: _spec_list(spec_for(s.axes, c["rules"], mesh, s.shape))
           for k, s in _flat(c["specs"])}
    assert got == want["specs"]
    if want["cache"] is None:
        assert c["cache"] is None
    else:
        assert {k: _spec_list(v.sharding.spec)
                for k, v in c["cache"].items()} == want["cache"]
    rec = dryrun.analyze_cell(arch, shape, multi_pod)
    assert rec["mem"]["bytes"] == mem and rec["n_chips"] == mesh.size
    assert rec["mem"]["fits_80gb"] == (mem["total"] <= 80 * 10 ** 9)
    assert "collective_bytes" in rec["not_measured"]
    assert "mem_xla" not in rec and "compile_s" not in rec


def test_abstract_state_allocates_nothing_and_matches_init_state():
    cfg = get_arch("llama3-8b").reduced()
    specs = zoo.model_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    for opt in ("adamw", "adafactor", "adamw8bit"):
        run = RunConfig(optimizer=opt)
        real = init_state(cfg, run, init_params(specs, gen, cfg.dtype, "cpu"))
        abst = abstract_state(cfg, run, specs)
        fr, fa = _flat(real), _flat(abst)
        assert [k for k, _ in fr] == [k for k, _ in fa]
        for (k, r), (_, a) in zip(fr, fa):
            assert a.device.type == "meta", k
            assert (tuple(a.shape), a.dtype) == (tuple(r.shape), r.dtype), k
            assert a.sharding is None


def test_abstract_state_shardings_follow_the_rules():
    cfg = get_arch("llama3-8b")
    specs = zoo.model_specs(cfg)
    mesh = make_production_mesh()
    rules = default_rules()
    st = abstract_state(cfg, RunConfig(zero1=True), specs, mesh, rules)
    p = st["params"]["embed"]
    assert p.sharding.spec == spec_for(("vocab", "embed"), rules, mesh,
                                       tuple(p.shape))
    # ZeRO-1: the moments shard over data through the embed axis
    mu = st["opt"]["mu"]["embed"]
    assert mu.sharding.spec == ("model", "data")
    assert mu.sharding.shard_shape(tuple(mu.shape)) == (128256 // 16,
                                                        4096 // 16)
    params = abstract_params(specs, cfg.dtype, mesh, rules)
    assert params["embed"].dtype == torch.bfloat16
    assert axes_tree(specs)["embed"] == ("vocab", "embed")
    sh = tree_shardings(axes_tree(specs), rules, mesh)
    assert sh["embed"] == sharding_for(("vocab", "embed"), rules, mesh)


def test_shard_shape_and_guarded_sharding():
    mesh = LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    rules = default_rules(fsdp=True)
    sh = guarded_sharding((56, 4096), ("heads", "embed"), rules, mesh)
    # 56 heads do not shard 16 ways: replicated, not an error
    assert sh.spec == (None, "data") and sh.shard_shape((56, 4096)) == \
        (56, 256)
    sh = NamedSharding(mesh, (("pod", "data"), None))
    assert sh.shard_shape((64, 3)) == (2, 3)
    with pytest.raises(ValueError):
        sh.shard_shape((48, 3))
    with pytest.raises(ValueError):
        LogicalMesh(("data",), (2, 2))


def test_constrain_and_maybe_constrain_place_nothing():
    x = torch.randn(8, 4)
    mesh = LogicalMesh(("data", "model"), (2, 2))
    assert constrain(x, ("batch", None), default_rules(), mesh) is x
    assert constrain(x, ("batch", None), None, None) is x
    with pytest.raises(ValueError):
        constrain(torch.randn(3, 4), ("batch", None),
                  {"batch": "data"}, mesh)
    assert maybe_constrain(x, (("pod", "data"), None)) is x
    set_active_mesh_axes(("data", "model"))
    try:
        assert maybe_constrain(x, (("pod", "data"), "model")) is x
        with pytest.raises(ValueError):
            maybe_constrain(x, (None, None, None))
    finally:
        set_active_mesh_axes(())


def test_meshes():
    m = make_production_mesh()
    assert (m.axis_names, m.axis_sizes, m.size) == (("data", "model"),
                                                    (16, 16), 256)
    m = make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.shape, m.devices) == (
        ("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16}, None)
    cpus = [torch.device("cpu")] * 6
    m = make_host_mesh(model_parallel=4, devices=cpus)
    assert m.shape == {"data": 3, "model": 2} and len(m.devices) == 6
    assert m.distinct_devices("data") == 1


def test_plan_mesh_equals_reference():
    elastic = pytest.importorskip("repro.runtime.elastic")
    for n in range(1, 70):
        for mp in (1, 2, 3, 4, 8, 16):
            assert plan_mesh(n, mp) == elastic.plan_mesh(n, mp)
    m = make_mesh_from([torch.device("cpu")] * 7, 2)
    assert m.shape == {"data": 7, "model": 1} and len(m.devices) == 7
    m = make_mesh_from([torch.device("cpu")] * 8, 4)
    assert m.shape == {"data": 2, "model": 4}


def test_reshard_state_round_trips_bit_for_bit():
    """A reduced train state resharded onto a new mesh and back: every
    leaf bit-equal, each with its description under the new mesh."""
    cfg = get_arch("llama3-8b").reduced()
    specs = zoo.model_specs(cfg)
    gen = torch.Generator().manual_seed(3)
    params = init_params(specs, gen, "float32", "cpu")
    rules = default_rules()
    axes = axes_tree(specs)
    big = make_mesh_from([torch.device("cpu")] * 4, 2)
    one = make_mesh_from([torch.device("cpu")], 2)
    moved = reshard_state(params, axes, big, rules)
    back = reshard_state(moved, axes, one, rules)
    for (k, a), (_, b), (_, c) in zip(_flat(params), _flat(moved),
                                      _flat(back)):
        assert torch.equal(a, b) and torch.equal(a, c), k
        assert b.data_ptr() != a.data_ptr()
        assert b.sharding == sharding_for(dict(_flat(axes))[k], rules, big)
        assert c.sharding.mesh is one
    assert moved["embed"].sharding.spec == ("model", None)


def _reduced_step_inputs(seed=0):
    cfg = dataclasses.replace(get_arch("llama3-8b").reduced(),
                              dtype="float32")
    specs = zoo.model_specs(cfg)
    cell = dataclasses.replace(SHAPES["train_4k"].reduced(), global_batch=4)
    batch = zoo.make_batch(cfg, cell, seed=seed, device="cpu")
    return cfg, specs, batch


def test_train_step_with_dp_axes_on_one_card_equals_the_step_without():
    cfg, specs, batch = _reduced_step_inputs()
    run = RunConfig(microbatches=2, zero1=True)
    mesh = LogicalMesh(("data", "model"), (1, 1), (torch.device("cpu"),) * 1)
    rules = default_rules()
    r2 = dict(rules, embed="data")
    grad_sh = {k: v for k, v in tree_shardings(axes_tree(specs), r2,
                                               mesh).items()}
    outs = []
    for kw in ({}, {"dp_axes": ("data",), "grad_shardings": grad_sh,
                    "mesh": mesh}):
        gen = torch.Generator().manual_seed(1)
        params = init_params(specs, gen, cfg.dtype, "cpu")
        state = init_state(cfg, run, params)
        step = build_train_step(cfg, run, total_steps=10, **kw)
        for _ in range(2):
            state, m = step(state, batch)
        outs.append((state, m))
    (s0, m0), (s1, m1) = outs
    for a, b in zip(tree_leaves(s0), tree_leaves(s1)):
        assert torch.equal(a, b)
    assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_train_step_refuses_a_data_axis_over_several_cards():
    cfg, _, _ = _reduced_step_inputs()
    mesh = LogicalMesh(("data", "model"), (2, 1),
                       (torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(NotImplementedError, match="data axis"):
        build_train_step(cfg, RunConfig(microbatches=2), dp_axes=("data",),
                         mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        build_train_step(cfg, RunConfig(microbatches=2), dp_axes=("data",))
    # the same device named twice is one card: accepted
    twice = LogicalMesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
    build_train_step(cfg, RunConfig(microbatches=2), dp_axes=("data",),
                     mesh=twice)


def test_dryrun_main_all_cells(tmp_path):
    out = tmp_path / "dr"
    assert dryrun.main(["--all", "--both-meshes", "--out", str(out)]) == 0
    recs = [json.loads(p.read_text()) for p in out.glob("*.json")]
    assert len(recs) == 2 * len(cells(include_skipped=True))
    ok = [r for r in recs if "skipped" not in r]
    assert len(ok) == 2 * len(cells())
    for r in ok:
        assert r["mem"]["live_gb"] == r["mem"]["bytes"]["total"] / 2 ** 30
        assert np.isfinite(r["roofline"]["step_time_lower_bound_s"])
