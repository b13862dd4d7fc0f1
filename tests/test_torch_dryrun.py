"""The port's input stand-ins and dry-run (``repro_torch.launch.inputs``,
``launch.dryrun``) against the JAX package's ``repro.launch.inputs``.

For every arch x input shape the reference's dry-run lowers
(``applicable``) on the two production meshes (16 x 16 and 2 x 16 x 16),
each of the port's stand-ins has the reference's ``input_specs`` leaf's
global shape, dtype and per-device shard shape, leaf by leaf, and the
port's per-device census is the reference's.  No 512 devices are needed
on either side: the reference is built on a ``jax.sharding.AbstractMesh``
and the port on a ``.shape`` mapping of the same extents (its stand-ins
on a real ``DeviceMesh`` are held in ``tests/test_torch_sharding.py``).
The output specs are the reference's, ``applicable`` agrees, the CLI runs
one pair in a subprocess (its record one rank's argument, output and temp
bytes and bytes accessed: ``tests/test_torch_dryrun_memory.py``), and the
meta device's FLOP count of a step is that of the same step on real CPU
tensors at smoke width.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core.hieavg import History as JHistory  # noqa: E402
from repro.launch.inputs import input_specs as j_input_specs  # noqa: E402
from repro.launch.inputs import output_shardings as j_output  # noqa: E402
from repro.models import INPUT_SHAPES  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core.hieavg import History  # noqa: E402
from repro_torch.launch import dryrun, inputs  # noqa: E402
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES as T_SHAPES  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
PAIRS = [(a, s) for a in ARCH_IDS for s in INPUT_SHAPES
         if dryrun.applicable(a, s)[0]]


def _meshes(name: str):
    shape, names = MESHES[name]
    return (AbstractMesh(shape, names),
            types.SimpleNamespace(shape=dict(zip(names, shape))))


def _ref_leaves(tree, path=""):
    """{path: ShapeDtypeStruct} of the reference's input tree; a History's
    parameter trees keyed as the port keys them (``a/b/c``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_ref_leaves(v, f"{path}{k}/"))
        return out
    if isinstance(tree, JHistory):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_ref_leaves(getattr(tree, f.name), f"{path}{f.name}/"))
        return out
    return {path.rstrip("/"): tree}


def _port_leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, f"{path}{k}/"))
        return out
    if isinstance(tree, History):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_port_leaves(getattr(tree, f.name),
                                    f"{path}{f.name}/"))
        return out
    return {path.rstrip("/"): tree}


def _ref_shard(leaf) -> tuple:
    if leaf.sharding is None:
        return tuple(leaf.shape)
    return tuple(leaf.sharding.shard_shape(leaf.shape))


def _pair(arch, shape, mesh_name):
    jm, tm = _meshes(mesh_name)
    ref = j_input_specs(jget(arch), INPUT_SHAPES[shape], jm)
    got = inputs.input_specs(get_config(arch), T_SHAPES[shape], tm)
    return ref, got, tm


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", PAIRS)
def test_stand_ins_match_the_references_leaf_by_leaf(arch, shape,
                                                     mesh_name):
    ref, got, tm = _pair(arch, shape, mesh_name)
    r, g = _ref_leaves(ref), _port_leaves(got)
    assert set(r) == set(g)
    for k, leaf in r.items():
        t = g[k]
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(leaf.shape), k
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), k
        assert shd.local_shape(tuple(t.shape), t.spec, tm) == \
            _ref_shard(leaf), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_census_equals_the_references_per_device_bytes(mesh_name):
    for arch, shape in PAIRS:
        ref, got, tm = _pair(arch, shape, mesh_name)
        want = sum(int(np.prod(_ref_shard(x))) * x.dtype.itemsize
                   for x in jax.tree.leaves(ref))
        assert inputs.census(got, tm) == want, (arch, shape)
        split = dryrun.split_census(got, tm)
        assert sum(split.values()) == want
        assert split["params"] == inputs.census(got["params"], tm)


def test_deepseek_train_census_is_4_02_gib_a_device_on_two_pods():
    _, got, tm = _pair("deepseek-7b", "train_4k", "2x16x16")
    assert abs(inputs.census(got, tm) / 2**30 - 4.0248) < 1e-3


def _spec(ns) -> tuple:
    spec = tuple(ns.spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_output_specs_equal_the_references(mesh_name):
    jm, tm = _meshes(mesh_name)
    for arch, shape in PAIRS:
        ref = j_output(jget(arch), INPUT_SHAPES[shape], jm)
        got = inputs.output_shardings(get_config(arch), T_SHAPES[shape], tm)
        assert len(ref) == len(got)
        for r, g in zip(ref, got):
            r, g = _ref_leaves(r), _port_leaves(g)
            assert set(r) == set(g), (arch, shape)
            for k in r:
                assert g[k] == _spec(r[k]), (arch, shape, k)


def test_applicable_agrees_with_the_reference():
    # the reference's dry-run module sets XLA_FLAGS when imported
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jdry
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    for a in ARCH_IDS:
        for s in INPUT_SHAPES:
            assert dryrun.applicable(a, s) == jdry.applicable(a, s), (a, s)


def test_n_micro_follows_the_references_rule():
    _, tm = _meshes("16x16")
    _, tm2 = _meshes("2x16x16")
    shape = T_SHAPES["train_4k"]
    # 256 sequences over 16 clients: 16 a client, microbatches of 8
    assert dryrun.n_micro(get_config("deepseek-7b"), shape, tm) == 2
    assert dryrun.n_micro(get_config("deepseek-7b"), shape, tm2) == 1
    # one client a pod: microbatches of 16 out of 256 (128 on two pods)
    assert get_config("grok-1-314b").clients_per_pod == 1
    assert dryrun.n_micro(get_config("grok-1-314b"), shape, tm) == 16
    assert dryrun.n_micro(get_config("grok-1-314b"), shape, tm2) == 8


def test_cli_runs_one_pair_and_writes_its_record(tmp_path):
    out = tmp_path / "dry.json"
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-130m", "--shape", "decode_32k", "--mesh", "pod", "--out",
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (rec,) = json.loads(out.read_text())
    assert rec["arch"] == "mamba2-130m" and rec["mesh"] == "16x16"
    _, got, tm = _pair("mamba2-130m", "decode_32k", "16x16")
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == inputs.census(got, tm)
    assert rec["bytes_per_device"] == inputs.census(got, tm) \
        + mem["temp_size_in_bytes"]
    assert rec["flops"] > 0
    assert isinstance(mem["temp_size_in_bytes"], int)
    assert isinstance(mem["output_size_in_bytes"], int)
    assert isinstance(rec["hlo_bytes"], float) and rec["hlo_bytes"] > 0
    assert set(rec["collectives"]) == set(dryrun.KINDS) | {"total_bytes"}
    assert "OK   mamba2-130m x decode_32k x 16x16" in proc.stdout


SMOKE_SHAPES = (InputShape("t", 64, 4, "train"),
                InputShape("p", 64, 2, "prefill"),
                InputShape("d", 64, 2, "decode"))


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_meta_flops_equal_cpu_flops_at_smoke_width(arch, shape):
    cfg = dataclasses.replace(get_smoke(arch), clients_per_pod=2)
    _, tm = _meshes("16x16")
    micro = dryrun.n_micro(cfg, shape, tm) if shape.kind == "train" else 1
    meta = dryrun.step_flops(cfg, shape, tm, device="meta", micro=micro)
    cpu = dryrun.step_flops(cfg, shape, tm, device="cpu", micro=micro)
    assert meta == cpu and meta > 0
