"""The port's sharding rules, meshes and mesh-taking steps
(``repro_torch.launch.{mesh,sharding,steps}``) against the JAX package's.

* The rule tables are the reference's, and ``resolve_spec`` gives
  ``tuple(repro.launch.sharding.resolve_spec(...))`` over every leaf of
  the ten architectures' ``param_specs`` (with and without the FL prefix
  dims) and ``cache_specs``, under the train, FL1 and serve rules, on
  meshes given as ``.shape`` mappings: 1 x 1, 16 x 16, 2 x 16 x 16, 4, 3,
  8 x 2 and 2 x 8 (the last two: KV head counts that do not divide).
* Every leaf's (shape, logical axes, init) of ``param_specs`` and
  ``cache_specs`` is the reference's, for all ten architecture ids.
* ``placements`` and the DTensor stand-ins on a real ``DeviceMesh``
  (2 x 2 x 2 over a fake process group of 8 ranks, in a subprocess).
* Ports of ``tests/test_sharding_launch.py``: on a mesh of one rank
  (1 x 1) the steps compute bitwise what they compute with
  ``mesh=None`` (the steps on a mesh above one rank are
  ``tests/test_torch_mesh_*.py``'s).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCH_IDS  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.launch import sharding as jshd  # noqa: E402
from repro.models import cache_specs as j_cache_specs  # noqa: E402
from repro.models import param_specs as j_param_specs  # noqa: E402
from repro.models.spec import ParamSpec as JParamSpec  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.launch import (init_fl_histories, input_specs,  # noqa: E402
                                make_debug_mesh, make_hfl_train_step,
                                make_prefill_step, make_serve_step)
from repro_torch.launch import sharding as shd  # noqa: E402
from repro_torch.launch.inputs import leaves as tleaves  # noqa: E402
from repro_torch.launch.mesh import mesh_axis_size, mesh_shape  # noqa: E402
from repro_torch.launch.serve import make_caches, make_params  # noqa: E402
from repro_torch.models import (ParamSpec, cache_specs,  # noqa: E402
                                init_from_specs, param_specs)
from repro_torch.models.config import INPUT_SHAPES  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401


def _mesh(**shape):
    return types.SimpleNamespace(shape=shape)


MESHES = [_mesh(data=1, model=1), _mesh(data=16, model=16),
          _mesh(pod=2, data=16, model=16), _mesh(data=4), _mesh(data=3),
          _mesh(data=8, model=2), _mesh(data=2, model=8)]


@pytest.fixture(scope="module")
def one_rank():
    """A 1 x 1 ``DeviceMesh`` on a process group of one rank, started here
    and stopped after the module where none ran."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    yield make_debug_mesh()
    if started:
        dist.destroy_process_group()


def _leaves(tree, cls, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, cls):
            out[path + k] = v
        else:
            out.update(_leaves(v, cls, f"{path}{k}/"))
    return out


def test_rule_tables_are_the_references():
    for name in ("_TP", "TRAIN_RULES", "TRAIN_RULES_FL1", "SERVE_RULES",
                 "SWEEP_RULES", "SECONDARY_AXES"):
        assert getattr(shd, name) == getattr(jshd, name), name
    assert shd.train_rules(1) == jshd.train_rules(1)
    assert shd.train_rules(16) == jshd.train_rules(16)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_resolve_spec_is_the_references_over_every_leaf(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    jleaves = _leaves(j_param_specs(jcfg), JParamSpec)
    leaves = _leaves(param_specs(cfg), ParamSpec)
    jc = _leaves(j_cache_specs(jcfg, 128, 32768), JParamSpec)
    c = _leaves(cache_specs(cfg, 128, 32768), ParamSpec)
    cases = []
    for k, s in leaves.items():
        j = jleaves[k]
        for rules, jrules in ((shd.SERVE_RULES, jshd.SERVE_RULES),
                              (shd.TRAIN_RULES, jshd.TRAIN_RULES),
                              (shd.TRAIN_RULES_FL1, jshd.TRAIN_RULES_FL1)):
            cases.append((s.shape, s.axes, j.shape, j.axes, rules, jrules))
            pre = (2, 16)
            cases.append((pre + s.shape, ("fl_pods", "fl_clients") + s.axes,
                          pre + j.shape, ("fl_pods", "fl_clients") + j.axes,
                          rules, jrules))
    for k, s in c.items():
        cases.append((s.shape, s.axes, jc[k].shape, jc[k].axes,
                      shd.SERVE_RULES, jshd.SERVE_RULES))
    for mesh in MESHES:
        for shape, axes, jshape, jaxes, rules, jrules in cases:
            want = tuple(jshd.resolve_spec(jshape, jaxes, jrules, mesh))
            assert shd.resolve_spec(shape, axes, rules, mesh) == want, \
                (arch, shape, axes, mesh.shape)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.shape.values()))
def test_sweep_spec_and_batch_axes_are_the_references(mesh):
    for n in (1, 2, 3, 4, 8, 12, 16, 32, 64):
        assert shd.sweep_spec(n, mesh) == tuple(jshd.sweep_spec(n, mesh))
    assert shd.sweep_data_spec() == tuple(jshd.sweep_data_spec())
    assert shd.batch_axes(mesh) == jshd.batch_axes(mesh)


def test_kv_seq_takes_the_model_axis_when_kv_heads_cannot():
    """8 KV heads on a 16-way model axis: the cache shards its sequence."""
    mesh = _mesh(data=16, model=16)
    axes = ("act_batch", "kv_seq", "kv_heads", None)
    assert shd.resolve_spec((128, 32768, 8, 128), axes, shd.SERVE_RULES,
                            mesh) == ("data", "model")
    assert shd.resolve_spec((128, 32768, 16, 128), axes, shd.SERVE_RULES,
                            mesh) == ("data", None, "model")
    assert shd.resolve_spec((8, 128), ("kv_heads", None), shd.SERVE_RULES,
                            mesh) == ()
    assert shd.resolve_spec((4096, 11008), ("mlp", "mlp"), shd.TRAIN_RULES,
                            mesh) == ("model",)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_cache_specs_carry_the_references_axes(arch):
    for batch, max_len in ((4, 64), (128, 32768)):
        for mine, ref in (
                (param_specs(get_config(arch)), j_param_specs(jget(arch))),
                (cache_specs(get_config(arch), batch, max_len),
                 j_cache_specs(jget(arch), batch, max_len))):
            got, want = _leaves(mine, ParamSpec), _leaves(ref, JParamSpec)
            assert set(got) == set(want)
            for k, s in got.items():
                assert (s.shape, s.axes, s.init) == \
                    (want[k].shape, want[k].axes, want[k].init), (arch, k)


def test_param_spec_checks_the_axes_length():
    with pytest.raises(ValueError, match="differ in length"):
        ParamSpec((2, 3), ("embed",))


def test_mesh_shape_reads_a_device_mesh_and_a_mapping(one_rank):
    assert mesh_shape(one_rank) == {"data": 1, "model": 1}
    assert tuple(one_rank.mesh_dim_names) == ("data", "model")
    assert mesh_shape(_mesh(pod=2, data=16)) == {"pod": 2, "data": 16}
    assert mesh_axis_size(_mesh(data=4), "pod") == 1
    with pytest.raises(TypeError):
        mesh_shape(types.SimpleNamespace(shape=(2, 2)))


_DEVICE_MESH = textwrap.dedent("""
    import torch, torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    from repro_torch.configs import get_config
    from repro_torch.launch import inputs, make_debug_mesh
    from repro_torch.launch import sharding as shd
    from repro_torch.models.config import INPUT_SHAPES
    mesh = make_debug_mesh(data=2, model=2, pod=2)
    assert shd.placements(("pod", "data", None, "model"), mesh) == (
        Shard(0), Shard(1), Shard(3))
    assert shd.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shd.placements((), mesh) == (Replicate(),) * 3
    ns = type("M", (), {"shape": {"pod": 2, "data": 2, "model": 2}})
    for arch, shape in (("h2o-danube-1.8b", "train_4k"),
                        ("minicpm3-4b", "decode_32k")):
        cfg = get_config(arch)
        real = inputs.input_specs(cfg, INPUT_SHAPES[shape], mesh)
        flat = inputs.input_specs(cfg, INPUT_SHAPES[shape], ns)
        for d, t in zip(inputs.leaves(real), inputs.leaves(flat)):
            assert type(d).__name__ == "DTensor" and d.device.type == "meta"
            assert d.shape == t.shape and d.dtype == t.dtype
            assert d.spec == t.spec
            assert d.placements == shd.placements(t.spec, mesh)
            assert tuple(d.to_local().shape) == shd.local_shape(
                tuple(t.shape), t.spec, ns)
        assert inputs.census(real, mesh) == inputs.census(flat, ns)
    print("DEVICE_MESH_OK")
""")


def test_placements_and_stand_ins_on_a_real_device_mesh():
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _DEVICE_MESH],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DEVICE_MESH_OK" in proc.stdout


# ------------------------------------------ ports of test_sharding_launch
def test_production_and_debug_mesh_axes(one_rank):
    assert tuple(one_rank.mesh_dim_names) == ("data", "model")
    assert one_rank.shape == (1, 1)


def test_resolve_spec_divisibility_fallback():
    mesh = _mesh(data=16, model=16)
    assert shd.resolve_spec((8, 128), ("kv_heads", None), shd.SERVE_RULES,
                            mesh) == ()
    assert shd.resolve_spec((32, 128), ("kv_heads", None), shd.SERVE_RULES,
                            mesh) == ("model",)


def test_train_input_specs_shapes(one_rank):
    cfg = get_config("deepseek-7b")
    specs = input_specs(cfg, INPUT_SHAPES["train_4k"], one_rank)
    e, c = 1, cfg.clients_per_pod
    b = 256 // (e * c)
    assert tuple(specs["batch"]["tokens"].shape) == (e, c, b, 4096)
    assert tuple(specs["dev_mask"].shape) == (e, c)
    leaf = next(iter(specs["params"]["embed"].values()))
    assert tuple(leaf.shape[:2]) == (e, c)


def test_serve_input_specs_decode(one_rank):
    specs = input_specs(get_config("minicpm3-4b"),
                        INPUT_SHAPES["decode_32k"], one_rank)
    assert tuple(specs["token"].shape) == (128, 1)
    c_kv = specs["caches"]["unit"]["0"]["c_kv"]
    assert c_kv.shape[-2] == 32768


def _hfl_inputs(c: int, diverge: bool):
    cfg = get_smoke("h2o-danube-1.8b")
    e, b, s = 1, 2, 16
    g = torch.Generator().manual_seed(0)
    base = init_from_specs(param_specs(cfg), g, "cpu", torch.float32)
    params = jax.tree.map(lambda x: x[None, None].expand(
        (e, c) + tuple(x.shape)).contiguous(), base)
    dev_hist, glob_hist = init_fl_histories(params)
    if diverge:
        params = jax.tree.map(lambda x: x * (1.0 + 0.1 * torch.arange(
            c, dtype=x.dtype).reshape(1, c, *[1] * (x.ndim - 2))), params)
    batch = {"tokens": torch.zeros((e, c, b, s), dtype=torch.long),
             "labels": torch.zeros((e, c, b, s), dtype=torch.long)}
    return cfg, params, dev_hist, glob_hist, batch


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return dataclasses.replace(tree, **{
        f.name: _clone(getattr(tree, f.name))
        for f in dataclasses.fields(tree)})


def test_hfl_train_step_on_a_one_rank_mesh_is_the_meshless_step(one_rank):
    """E = 1, C = 2: the step with a 1 x 1 mesh is bitwise the step
    without, and after the global round every slot holds one model."""
    cfg, params, dh, gh, batch = _hfl_inputs(2, diverge=False)
    e, c = 1, 2
    args = (batch, torch.ones((e, c), dtype=torch.bool),
            torch.ones((e,), dtype=torch.bool), 1e-3)
    out = [make_hfl_train_step(cfg, mesh=m, kernel_mode="torch")(
        _clone(params), _clone(dh), _clone(gh), *args)
        for m in (None, one_rank)]
    for a, b in zip(tleaves(out[0]), tleaves(out[1])):
        assert torch.equal(a, b)
    assert np.isfinite(float(out[1][3]))
    l0 = tleaves(out[1][0])[0]
    torch.testing.assert_close(l0[0, 0], l0[0, 1], rtol=1e-6, atol=0)


def test_hfl_step_straggler_mask_changes_result(one_rank):
    cfg, params, dh, gh, batch = _hfl_inputs(3, diverge=True)
    step = make_hfl_train_step(cfg, mesh=one_rank, kernel_mode="torch")
    em = torch.ones((1,), dtype=torch.bool)
    p_all, *_ = step(_clone(params), _clone(dh), _clone(gh), batch,
                     torch.ones((1, 3), dtype=torch.bool), em, 0.0)
    p_mask, *_ = step(_clone(params), _clone(dh), _clone(gh), batch,
                      torch.tensor([[True, False, True]]), em, 0.0)
    diff = sum(float((a - b).abs().sum()) for a, b in
               zip(tleaves(p_all), tleaves(p_mask)))
    assert diff > 0.0


def test_serve_steps_on_a_one_rank_mesh_are_the_meshless_steps(one_rank):
    cfg = get_smoke("mamba2-130m")
    params = make_params(cfg, 0, "cpu")
    tokens = torch.zeros((2, 8), dtype=torch.long)
    outs = []
    for m in (None, one_rank):
        caches = make_caches(cfg, 2, 32, "cpu", smoke=True)
        logits, caches = make_prefill_step(cfg, "torch", mesh=m)(
            params, tokens, caches)
        logits2, _ = make_serve_step(cfg, mesh=m)(
            params, torch.zeros((2, 1), dtype=torch.long), 8, caches)
        outs.append((logits, logits2))
    assert outs[0][1].shape == (2, cfg.vocab)
    assert not torch.isnan(outs[1][1]).any()
    for a, b in zip(outs[0], outs[1]):
        assert torch.equal(a, b)
