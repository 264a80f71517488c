"""The port's dry run (``repro_torch.launch.{mesh,op_cost,dryrun_lib}``)
against the reference's ``repro.launch``: the per-cell model FLOPs, the
models' input specs and logical axes, each device's argument bytes on both
production meshes under the reference's own sharding rules, two cells'
records against ``repro``'s ``run_cell`` on a 2 x 4 mesh, a one-device
count equal to ``FlopCounterMode`` over the same step on CPU tensors, and
the kernels' meta branch.

A production mesh is a fake process group of 256 or 512 ranks, which is
process-global: those counts run in a subprocess, as the reference's run
in one with forced host devices.  The one-device count tears its group
down before it returns."""

import contextlib
import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

import repro.configs.base as RB
from repro.launch import dryrun_lib as RD
from repro.models import build_model as ref_build_model
from repro.sharding import rules as RR
from repro.train.optimizer import OptimizerConfig as RefOptimizerConfig
from repro.train.step import abstract_state as ref_abstract_state
from repro.train.step import state_logical_axes as ref_state_axes

import repro_torch.configs.base as TB
from repro_torch.kernels import cost, ops
from repro_torch.launch import dryrun_lib as TD
from repro_torch.launch import mesh as M
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import build_model
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step

from _torch_rules import plain_calls

ROOT = Path(__file__).resolve().parents[1]
CELLS = RB.all_cells()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# test_multidevice.py's reduced sizes, and the two cells whose reference
# dry run compiles on jax 0.9 (the other two fail there: see ROADMAP)
SMALL_CELLS = [("hymba_1_5b", "long_500k"), ("whisper_tiny", "decode_32k")]
SMALL = "seq_len=min(v.seq_len, 256), global_batch=min(v.global_batch, 8)"


def _last_json(code: str, env: dict, timeout: int = 240):
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


PORT_ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
REF_ENV = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")


# ---- per cell, in process ------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_estimate_matches_reference(arch, shape):
    assert TD.model_flops_estimate(TB.get_arch(arch), TB.SHAPES[shape]) == \
        RD.model_flops_estimate(RB.get_arch(arch), RB.SHAPES[shape])


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], pre + (k,))]
    return [(pre, tree)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_and_axes_match_reference(arch, shape):
    """Names, shapes, dtypes and logical axes of ``input_specs`` (the
    caches' ``cache_specs`` within) and ``input_logical_axes``."""
    ref = ref_build_model(RB.get_arch(arch))
    port = build_model(TB.get_arch(arch), device="meta")
    rs, ts = ref.input_specs(RB.SHAPES[shape]), port.input_specs(
        TB.SHAPES[shape])
    want = [(tuple(p.key for p in path), tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(rs)[0]]
    got = [(path, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for path, x in _flat(ts)]
    assert got == want
    assert all(x.device.type == "meta" for _, x in _flat(ts))
    assert port.input_logical_axes(TB.SHAPES[shape]) == \
        ref.input_logical_axes(RB.SHAPES[shape])


class _StubMesh:
    """What the reference's ``spec_for`` reads of a ``jax`` mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


def _ref_argument_bytes(arch: str, shape_name: str, mesh_key: str) -> int:
    """One device's bytes of a cell's step arguments under the
    reference's rules: each leaf's ``spec_for`` shard, summed."""
    shape, names = MESHES[mesh_key]
    mesh, sizes = _StubMesh(shape, names), dict(zip(names, shape))
    cfg, shp = RB.get_arch(arch), RB.SHAPES[shape_name]
    model, profile = ref_build_model(cfg), cfg.sharding_profile
    trees = [(model.input_specs(shp), model.input_logical_axes(shp),
              profile)]
    if shp.kind == "train":
        opt = RefOptimizerConfig(
            state_dtype=RD.OPT_STATE_DTYPE.get(cfg.name, "float32"))
        state, axes = ref_abstract_state(model, opt), ref_state_axes(model,
                                                                     opt)
        trees += [(state["params"], axes["params"], profile),
                  (state["opt"], axes["opt"], "fsdp_tp")]
    else:
        trees.append((model.abstract_params(), model.param_logical_axes(),
                      profile))
    total = 0
    for specs, axes, prof in trees:
        rules = RR.rules_for_profile(prof)
        leaves, treedef = jax.tree.flatten(specs)
        for x, a in zip(leaves, treedef.flatten_up_to(axes)):
            spec = tuple(RR.spec_for(a, x.shape, mesh, rules))
            n = 1
            for i, d in enumerate(x.shape):
                part = spec[i] if i < len(spec) else None
                parts = part if isinstance(part, tuple) else (part,)
                n *= d // math.prod(sizes[p] for p in parts if p)
            total += n * x.dtype.itemsize
    return total


@pytest.fixture(scope="module")
def port_argument_bytes():
    """``local_bytes`` of every cell's ``build_cell`` arguments on both
    production meshes (one subprocess: the fake groups)."""
    return _last_json("""
        import json
        from repro_torch.configs.base import all_cells
        from repro_torch.launch import dryrun_lib as D, mesh as M
        out = {}
        for multi in (False, True):
            mesh = M.make_production_mesh(multi_pod=multi)
            for a, s in all_cells():
                args = D.build_cell(a, s, mesh)[1]
                out[f"{a}/{s}/{M.mesh_name(mesh)}"] = D.local_bytes(args)
        M.destroy()
        print(json.dumps(out))
    """, PORT_ENV)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_argument_bytes_follow_reference_rules(port_argument_bytes, arch,
                                               shape):
    for key in MESHES:
        assert port_argument_bytes[f"{arch}/{shape}/{key}"] == \
            _ref_argument_bytes(arch, shape, key), key


# ---- two cells on a 2 x 4 mesh against the reference's run_cell ---------

@pytest.fixture(scope="module")
def small_records():
    """Both packages' ``run_cell`` records of ``SMALL_CELLS`` at
    ``test_multidevice.py``'s sizes: the reference compiled for 8 forced
    host devices, the port counted on a fake group of 8."""
    ref = _last_json(f"""
        import dataclasses, json, jax
        import repro.configs.base as B
        B.SHAPES = {{k: dataclasses.replace(v, {SMALL})
                    for k, v in B.SHAPES.items()}}
        import repro.launch.dryrun_lib as D
        D.SHAPES = B.SHAPES
        mesh = jax.make_mesh((2, 4), ("data", "model"))
        print(json.dumps([D.run_cell(a, s, mesh, verbose=False)
                          for a, s in {SMALL_CELLS!r}]))
    """, REF_ENV)
    port = _last_json(f"""
        import dataclasses, json
        import repro_torch.configs.base as B
        from repro_torch.launch import dryrun_lib as D, mesh as M
        mesh = M.make_test_mesh(2, 4)
        out = [D.run_cell(a, s, mesh, verbose=False,
                          shape=dataclasses.replace(B.SHAPES[s], **dict(
                              (lambda v: dict({SMALL}))(B.SHAPES[s]))))
               for a, s in {SMALL_CELLS!r}]
        M.destroy()
        print(json.dumps(out))
    """, PORT_ENV)
    return dict(zip(SMALL_CELLS, zip(ref, port)))


@pytest.mark.parametrize("cell", SMALL_CELLS)
def test_small_mesh_record_keys_and_argument_bytes(small_records, cell):
    """The record has the reference's keys, and one device's argument
    bytes (the arguments the step reads: jit drops Whisper's encoder
    weights from a decode step, and the port does not count them either)
    equal the reference's ``memory_analysis``."""
    ref, port = small_records[cell]
    assert set(ref) <= set(port)
    assert set(ref["memory"]) == set(port["memory"])
    assert set(ref["collective_bytes_per_device"]) == \
        set(port["collective_bytes_per_device"])
    assert (port["arch"], port["shape"], port["mesh"], port["devices"]) == \
        (ref["arch"], ref["shape"], ref["mesh"], ref["devices"])
    assert port["memory"]["argument_bytes"] == \
        ref["memory"]["argument_bytes"]
    assert port["model_flops_total"] == ref["model_flops_total"]


def _excess_flops(cell, port) -> float:
    """The FLOPs one device does in the port and not in the reference, by
    design.  Whisper's cross-attention cache splits its head dim over the
    model axis (6 kv heads do not divide 4), and XLA contracts the split
    dim with an all-reduce of the scores; the flash-decode kernel takes
    whole head dims, so the port gathers them and each device attends all
    of them: (n - 1) / n of that attention is the excess, 4*G*D flops per
    frame, kv head and row of the device's batch.  Hymba's cache splits
    its length instead, which the port attends in place: no excess."""
    if cell != ("whisper_tiny", "decode_32k"):
        return 0.0
    cfg = TB.get_arch("whisper_tiny")
    rows = 8 // 2                                 # batch over data
    n = 4                                         # the model axis
    per_layer = 4 * cfg.n_kv_heads * (cfg.n_heads // cfg.n_kv_heads) \
        * cfg.resolved_head_dim * cfg.enc_frames * rows
    return cfg.n_layers * per_layer * (n - 1) / n


@pytest.mark.parametrize("cell", SMALL_CELLS)
def test_small_mesh_flops_near_reference(small_records, cell):
    """One device's FLOPs within 5% of the reference's HLO count once the
    port's by-design excess (``_excess_flops``) is taken off.  What is
    left: the reference counts dots only (so does the port: matmuls and
    the kernels' formulas), and XLA and DTensor place a few small
    products differently (Hymba within 0.1%, Whisper about 1.3%)."""
    ref, port = small_records[cell]
    got = port["flops_per_device"] - _excess_flops(cell, port)
    assert abs(got / ref["flops_per_device"] - 1) < 0.05, (
        got, ref["flops_per_device"])


# ---- one device: the count equals FlopCounterMode on real tensors -------

@pytest.mark.parametrize("arch,seq", [("qwen3_4b", 64), ("qwen3_4b", 2080),
                                      ("grok_1_314b", 1024),
                                      ("hymba_1_5b", 64),
                                      ("xlstm_350m", 64),
                                      ("whisper_tiny", 64)])
def test_one_device_count_equals_flop_counter_on_cpu(arch, seq):
    """The smoke config's train step (with remat; 2080 tokens take the
    chunked attention, 1024 two MoE chunks), counted on ``meta`` on a
    1 x 1 mesh, against ``FlopCounterMode`` over the same step on CPU
    tensors: the same ATen ops on two devices, so exactly equal."""
    cfg = TB.get_arch(arch).smoke_config().scaled(remat=True)
    shape = TB.ShapeConfig("train", "train", seq, 2)
    opt = OptimizerConfig(total_steps=4)
    mesh = M.make_mesh((1, 1), ("data", "model"))
    try:
        rec = TD.run_cell(arch, "train_4k", mesh, verbose=False, cfg=cfg,
                          shape=shape, microbatches=1, opt_cfg=opt)
        args = TD.build_cell(arch, "train_4k", mesh, cfg=cfg, shape=shape,
                             opt_cfg=opt)[1]
    finally:
        M.destroy()
    assert not dist.is_initialized()
    model = build_model(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    state = init_state(model, opt, gen)
    batch = model.make_batch(gen, shape)
    with FlopCounterMode(display=False) as counter:
        make_train_step(model, opt)(state, batch)
    assert rec["flops_per_device"] == counter.get_total_flops() > 0
    assert rec["raw_cost_analysis"]["flops"] == rec["flops_per_device"]
    m = rec["memory"]
    assert m["alias_bytes"] > 0 and m["temp_bytes"] > 0
    assert m["argument_bytes"] == TD.local_bytes(args)


# ---- the kernels' meta branch --------------------------------------------

def _charged(fn, *args, **kw):
    counter = OpCost()
    with counter.counting():
        out = fn(*args, **kw)
    return out, counter


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_flash_attention_charges_its_formula():
    q, k = _meta(2, 8, 256, 64), _meta(2, 2, 256, 64)
    out, c = _charged(ops.flash_attention, q, k, k, causal=True, window=100)
    assert out.shape == q.shape and out.device.type == "meta"
    flops, nbytes = cost.attention_work(2, 8, 2, 256, 256, 64, 2, True, 100)
    assert (c.kernels, c.flops, c.bytes) == (
        {"flash_attention": 1}, flops, nbytes)


def test_meta_flash_decode_reads_host_lengths():
    q, k = _meta(3, 2, 4, 64), _meta(3, 2, 100, 64)
    lengths = torch.tensor([5, 100, 37], dtype=torch.int32)
    out, c = _charged(ops.flash_decode, q, k, k, lengths)
    assert out.shape == q.shape
    assert (c.flops, c.bytes) == cost.decode_work([5, 100, 37], 2, 4, 64, 2)
    assert c.kernels == {"flash_decode": 1}


def test_meta_grouped_matmul_and_crop_charge_their_formulas():
    out, c = _charged(ops.grouped_matmul, _meta(4, 10, 32), _meta(4, 32, 48))
    assert out.shape == (4, 10, 48) and out.dtype == torch.bfloat16
    assert (c.flops, c.bytes) == cost.gmm_work(4, 10, 32, 48, 2)
    img = _meta(2, 16, 16, 3, dtype=torch.uint8)
    idx = _meta(2, dtype=torch.int32)
    out, c = _charged(ops.crop_mirror_normalize, img, idx, idx, idx,
                      _meta(3, dtype=torch.float32),
                      _meta(3, dtype=torch.float32), out_h=8, out_w=8)
    assert out.shape == (2, 3, 8, 8) and out.dtype == torch.float32
    assert (c.flops, c.bytes) == cost.crop_work(2, 3, 8, 8, 4)
    assert c.kernels == {"crop_mirror_normalize": 1}


def test_meta_branch_charges_nothing_without_a_counter():
    q = _meta(1, 2, 8, 16)
    assert ops.flash_attention(q, q, q).shape == q.shape


def test_op_cost_counts_local_ops_and_live_bytes():
    """Per op on plain tensors: the flop formula of a matmul, operand and
    output bytes of data-moving ops, nothing for views; storages live
    from their op until freed."""
    a, b = _meta(64, 32, dtype=torch.float32), _meta(32, 16,
                                                     dtype=torch.float32)
    counter = OpCost()
    with counter.counting():
        base = counter.track((a, b))
        y = (a @ b).t()
        z = y * 2
        del y
    assert base == (64 * 32 + 32 * 16) * 4
    assert counter.flops == 2 * 64 * 32 * 16
    assert counter.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4 \
        + 2 * 64 * 16 * 4
    assert counter.peak_bytes == base + 2 * 64 * 16 * 4
    assert counter.live_bytes == base + 64 * 16 * 4 and z.shape == (16, 64)


# ---- the per-device rules (``launch.per_device``) ------------------------

def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


RULE_NAMES = ["_decode", "_mlstm_scan", "_slstm_scan", "adamw_update",
              "embed", "logz_and_target", "moe_apply", "output_head",
              "project_heads", "project_out", "sequence_attention",
              "unembed"]


def test_per_device_rules_are_swapped_in_only_while_installed():
    """``installed()`` puts each rule wherever its original is bound (the
    defining module and the modules that imported it by name), and puts
    every original back when it exits."""
    from repro_torch.launch import per_device as PD
    from repro_torch.models import hybrid, transformer, whisper, xlstm
    from repro_torch.train import step

    assert {name for _, name in PD.RULES} == set(RULE_NAMES) == \
        set(plain_calls())
    before = {(m, n): getattr(m, n) for m, n in PD.RULES}
    bound = [(transformer, "embed"), (hybrid, "unembed"),
             (whisper, "softmax_xent"), (xlstm, "embed"),
             (step, "adamw_update")]
    names = {(m, n): getattr(m, n) for m, n in bound}
    with PD.installed():
        for (m, n), rule in PD.RULES.items():
            assert getattr(m, n) is rule
        assert transformer.embed is PD.embed and hybrid.unembed is PD.unembed
        assert step.adamw_update is PD.adamw_update
        with pytest.raises(RuntimeError, match="already installed"):
            with PD.installed():
                pass
    assert {(m, n): getattr(m, n) for m, n in PD.RULES} == before
    assert {(m, n): getattr(m, n) for m, n in bound} == names


@pytest.mark.parametrize("name", RULE_NAMES)
def test_per_device_rule_passes_plain_tensors_to_the_original(name):
    """Given plain tensors, each rule returns exactly what its original
    returns (and updates the same tensors alike)."""
    from repro_torch.launch import per_device as PD

    module, fn, args, kw = plain_calls()[name]
    want_args = _clone(args)
    want = getattr(module, fn)(*want_args, **kw)
    with PD.installed():
        got = getattr(module, fn)(*args, **kw)
    for a, b in zip(_leaves((got, args)), _leaves((want, want_args))):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        else:
            assert a == b, name


def test_counted_train_step_on_plain_tensors_is_unchanged():
    """A whole MoE train step on CPU tensors, run with the rules installed,
    equals the step without them bit for bit."""
    from repro_torch.launch import per_device as PD
    from repro_torch.train.step import init_state

    cfg = TB.get_arch("grok_1_314b").smoke_config()
    model = build_model(cfg, device="cpu")
    opt = OptimizerConfig(total_steps=4)
    out = []
    for install in (False, True):
        gen = torch.Generator().manual_seed(0)
        state = init_state(model, opt, gen)
        batch = model.make_batch(gen, TB.ShapeConfig("train", "train", 64, 2))
        with PD.installed() if install else contextlib.nullcontext():
            state, metrics = make_train_step(model, opt)(state, batch)
        out.append(_leaves((state["params"], metrics)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.fixture(scope="module")
def refusals():
    """Each rule called with DTensors whose shards hold values (on a CPU
    mesh of 2 x 4 over a fake group), in a subprocess: {name: the
    error}."""
    return _last_json(f"""
        import json, torch
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from repro_torch.launch import mesh as M, per_device as PD
        M.fake_group(8)
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        import sys
        sys.path.insert(0, "tests")
        from _torch_rules import plain_calls

        def dt(t, dim=None):
            pl = [Replicate(), Shard(dim) if dim is not None else Replicate()]
            return DTensor.from_local(t, mesh, pl, run_check=False)

        def split(tree):
            if isinstance(tree, dict):
                return {{k: split(v) for k, v in tree.items()}}
            if isinstance(tree, tuple):
                return tuple(split(v) for v in tree)
            if isinstance(tree, torch.Tensor) and tree.is_floating_point():
                return dt(tree, 0 if tree.dim() and tree.shape[0] % 4 == 0
                          else None)
            return tree

        out = {{}}
        with PD.installed():
            for name, (module, fn, args, kw) in plain_calls().items():
                if name == "embed":
                    args = ({{"embedding": dt(args[0]["embedding"], 0)}},
                            dt(args[1]), args[2])
                elif name in ("unembed", "output_head"):
                    args = (args[0], dt(args[1], 1))
                else:
                    args = split(args)
                try:
                    getattr(module, fn)(*args, **kw)
                    out[name] = "no error"
                except RuntimeError as e:
                    out[name] = str(e)
        M.destroy()
        print(json.dumps(out))
    """, PORT_ENV)


@pytest.mark.parametrize("name", RULE_NAMES)
def test_per_device_rule_refuses_shards_that_hold_values(refusals, name):
    """A rule counts device 0's work and does not compute its values, so
    given DTensors whose shards are not ``meta`` it raises."""
    assert "count device 0's work on meta shards" in refusals[name]
