"""The dry-run's per-rank figures (``repro_torch.launch.dryrun``'s
``census_mode`` and ``step_census``): one rank's FLOPs, live bytes and
bytes accessed, counted in the one run of the plain step that also counts
its collectives.

* the tracker on a hand-reckoned chain, whose peak is known to the byte:
  a view and an in-place op add nothing, a tensor that autograd saves
  lives until the backward, a deleted tensor leaves, and with its frees
  ignored the tracker reads above the true peak;
* on the meta device it reads what it reads on real CPU tensors for the
  smoke steps (the pattern of ``test_torch_dryrun.py``'s FLOP test);
* on a two-rank fake mesh a matmul split over ``model`` counts half its
  FLOPs a rank, and a smoke pair's rank count lies below the global count
  with the ranks' sum at or above it;
* the steps run on fake meshes whose extents do not divide the heads
  (mamba2's 24 SSD heads, minicpm3's 40 MLA heads over 16) and with a
  ring cache that wraps on the meta device;
* a ``run_pair`` record carries numeric ``temp_size_in_bytes``,
  ``output_size_in_bytes`` and ``hlo_bytes``, with ``bytes_per_device``
  the argument and temp bytes, and FLOPs below the global step's.

Every fake group starts in a subprocess: a process group is global to its
process, and one must never start in a test worker.
"""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import InputShape  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

F32 = 4


def _chain(device: str, frees: bool = True) -> dict:
    """The tracker's readings along a chain of 256-float ops."""
    n = 256 * F32
    w = torch.zeros(256, device=device, requires_grad=True)
    mode = dryrun.census_mode(frees)
    seen = {}
    with mode:
        seen["argument"] = mode.hold({"w": w, "none": None})
        a = w * 2                       # +n
        v = a.view(16, 16)              # a view: +0
        v.add_(1)                       # in place: +0
        seen["view_inplace"] = mode.current
        b = a.exp()                     # +n; exp saves b for its backward
        del a, v                        # -n: nothing saved the product
        c = b.sum()                     # +4
        seen["after_del"] = mode.current
        t = torch.zeros(1000, device=device)
        del t                           # +4000, then -4000
        seen["after_temp"] = mode.current
        del b                           # the graph still holds b
        seen["saved"] = mode.current
        c.backward()
        del c                           # the graph and b leave
        gc.collect()
        seen["after_backward"] = mode.current
        seen["peak"] = mode.peak
    return seen


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_the_tracker_reads_a_hand_reckoned_chain_to_the_byte(device):
    n = 256 * F32
    got = _chain(device)
    assert got["argument"] == n
    assert got["view_inplace"] == 2 * n
    assert got["after_del"] == 2 * n + 4
    assert got["after_temp"] == 2 * n + 4
    assert got["saved"] == 2 * n + 4
    # w and its gradient (the product's backward, stolen by w.grad)
    assert got["after_backward"] == 2 * n
    # the largest moment: w, the product, exp's output and the zeros
    # made and deleted later (4000 bytes beside w, b and c)
    assert got["peak"] == max(3 * n, 2 * n + 4 + 4000)


def test_the_tracker_with_its_frees_ignored_reads_above():
    sound, control = _chain("meta"), _chain("meta", frees=False)
    assert control["after_backward"] > sound["after_backward"]
    assert control["peak"] > sound["peak"]


SMOKE_SHAPES = (InputShape("t", 64, 4, "train"),
                InputShape("p", 64, 2, "prefill"),
                InputShape("d", 64, 2, "decode"))
POD = types.SimpleNamespace(shape={"data": 16, "model": 16})


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "mamba2-130m",
                                  "deepseek-v2-lite-16b",
                                  "seamless-m4t-large-v2"])
def test_meta_tracker_equals_cpu_tracker_at_smoke_width(arch, shape):
    cfg = dataclasses.replace(get_smoke(arch), clients_per_pod=2)
    micro = dryrun.n_micro(cfg, shape, POD) if shape.kind == "train" else 1
    got = {}
    for device in ("meta", "cpu"):
        x = dryrun.materialize(dryrun.input_specs(cfg, shape, POD), device)
        got[device] = dryrun.step_census(cfg, shape, None, x, micro=micro)
    meta, cpu = got["meta"], got["cpu"]
    for k in ("flops", "argument", "output", "peak", "temp"):
        assert meta[k] == cpu[k], k
    assert meta["peak"] > meta["argument"] > 0 and meta["flops"] > 0
    if cfg.moe is None:
        assert meta["hlo_bytes"] == cpu["hlo_bytes"]
    else:
        # aten's one_hot (the router's) builds its result by device: on
        # the CPU it checks the index range (aminmax) and scatters into
        # zeros, on the meta device it compares an arange: the same
        # output from other operands, a few percent of the smoke step
        assert meta["hlo_bytes"] < cpu["hlo_bytes"] \
            < 1.05 * meta["hlo_bytes"]


_FAKE = """
import dataclasses, json, sys
import torch
from repro_torch.configs import cut_depth, get_config, get_smoke
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.config import INPUT_SHAPES, InputShape
torch.set_num_threads(1)
dryrun.start_fake_group(512)
rec = {}
# a matmul whose weight is split over model on two ranks
mesh = make_debug_mesh(data=1, model=2)
from torch.distributed.tensor import DTensor, Replicate, Shard
m, k, n = 64, 32, 48
a = DTensor.from_local(torch.empty(m, k, device="meta"), mesh,
                       (Replicate(), Replicate()), run_check=False)
w = DTensor.from_local(torch.empty(k, n // 2, device="meta"), mesh,
                       (Replicate(), Shard(1)), run_check=False,
                       shape=torch.Size((k, n)), stride=(n, 1))
mode = dryrun.census_mode()
with mode:
    mode.hold((a, w))
    y = a @ w
rec["matmul"] = {"rank": mode.flops, "global": 2 * m * k * n,
                 "out": mode.current - 4 * (m * k + k * n // 2),
                 "out_local": 4 * m * n // 2}
# a smoke train pair on those two ranks
cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"), clients_per_pod=2)
shape = InputShape("t", 64, 4, "train")
one = dryrun.step_census(cfg, shape, mesh)
one["global"] = dryrun.step_flops(cfg, shape, mesh)
one["census"] = dryrun.census(dryrun.input_specs(cfg, shape, mesh), mesh)
one.pop("collectives")
rec["train"] = one
# steps that raised in the dry-run before
rec["uneven"] = {}
for name, cfg, shape, dm in (
        # 24 SSD heads over 16: their gradient made whole before the view
        ("ssd_heads", cut_depth(get_config("mamba2-130m"), 1),
         InputShape("t", 64, 32, "train"), (16, 16)),
        # 40 MLA heads over 16: the decode's pending sum reduced first
        ("mla_decode", cut_depth(get_config("minicpm3-4b"), 1),
         InputShape("d", 64, 16, "decode"), (16, 16)),
        # a ring cache that wraps (window 16 < 64) on the meta device
        ("ring_prefill", get_smoke("h2o-danube-1.8b"),
         InputShape("p", 64, 2, "prefill"), (1, 2))):
    got = dryrun.step_census(cfg, shape, make_debug_mesh(*dm))
    rec["uneven"][name] = got["peak"] > got["argument"] > 0
# one pair of the production mesh, and its global plain step's FLOPs
rec["pair"] = dryrun.run_pair("mamba2-130m", "decode_32k", False)
rec["pair_global_flops"] = dryrun.step_flops(
    get_config("mamba2-130m"), INPUT_SHAPES["decode_32k"],
    make_debug_mesh(data=16, model=16))
json.dump(rec, open(sys.argv[1] + "/fake.json", "w"))
"""


@pytest.fixture(scope="module")
def fake(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_memory")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", _FAKE, str(out)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return json.load(open(out / "fake.json"))


def test_a_matmul_split_over_model_counts_half_a_rank(fake):
    mm = fake["matmul"]
    assert mm["rank"] * 2 == mm["global"]
    assert mm["out"] == mm["out_local"]


def test_a_smoke_pairs_rank_count_is_below_the_global_count(fake):
    one = fake["train"]
    assert one["flops"] < one["global"] <= 2 * one["flops"]
    assert one["argument"] == one["census"]
    assert one["peak"] >= one["argument"] + one["output"] + one["temp"]
    assert one["hlo_bytes"] > 0


@pytest.mark.parametrize("case", ["ssd_heads", "mla_decode",
                                  "ring_prefill"])
def test_the_steps_run_where_heads_do_not_divide_the_mesh(fake, case):
    """Each case raised in the dry-run before: a view over heads that the
    mesh does not divide, and ring slots made on the meta device."""
    assert fake["uneven"][case]


def test_run_pair_records_one_ranks_memory_and_flops(fake):
    rec = fake["pair"]
    mem = rec["memory"]
    for k in ("temp_size_in_bytes", "output_size_in_bytes"):
        assert isinstance(mem[k], int) and mem[k] >= 0, k
    assert mem["generated_code_size_in_bytes"] is None
    assert isinstance(rec["hlo_bytes"], float) and rec["hlo_bytes"] > 0
    assert rec["bytes_per_device"] == \
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["argument_size_in_bytes"] == sum(
        mem[f"{k}_bytes"] for k in ("params", "histories", "caches", "batch"))
    # one rank's share: below the global plain step's FLOPs
    assert 0 < rec["flops"] < fake["pair_global_flops"]
