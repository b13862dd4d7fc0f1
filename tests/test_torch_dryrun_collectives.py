"""The dry-run's ``collectives`` field (``repro_torch.launch.dryrun.
collective_census``): one rank's collectives of the plain step on the
meta stand-ins over a fake process group, under ``CommDebugMode``.

* the record has the reference's five kinds (``repro.launch.dryrun.
  _COLLECTIVES``), each ``{"count", "bytes"}``, and ``total_bytes``;
* danube-smoke's train step on a (data=2, model=2) fake group counts,
  kind by kind, what ``CommDebugMode`` counts on rank 0 of the same step
  run by four real ``gloo`` ranks on the CPU over tensors of the same
  shapes (placed by the same specs), and the same bytes;
* a mesh of one rank counts none.

Both groups run in subprocesses: a process group is global to its
process, and a fake group must never start in a test worker.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from _torch_mesh import run_ranks  # noqa: E402
from repro.launch.dryrun import _COLLECTIVES  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

#: danube-smoke, two clients of 2 rows of 24 tokens
SHAPE = ("t", 24, 4, "train")

_COMMON = """
import dataclasses, json
from repro_torch.configs import get_smoke
from repro_torch.launch import dryrun
from repro_torch.models.config import InputShape
cfg = dataclasses.replace(get_smoke("h2o-danube-1.8b"), clients_per_pod=2)
shape = InputShape(*{shape!r})
"""

_FAKE = _COMMON + """
import sys
from repro_torch.launch.mesh import make_debug_mesh
world, out = int(sys.argv[1]), sys.argv[2]
dryrun.start_fake_group(world)
data, model = (2, 2) if world == 4 else (1, 1)
rec = dryrun.collective_census(cfg, shape, make_debug_mesh(data=data,
                                                           model=model))
json.dump(rec, open(f"{{out}}/fake{{world}}.json", "w"))
"""

_REAL = _COMMON + """
from repro_torch.launch import inputs
from repro_torch.launch import sharding as shd
x = dryrun.materialize(inputs.input_specs(cfg, shape, mesh), "cpu")
gen = torch.Generator().manual_seed(0)
for leaf in inputs.leaves(x):
    if leaf.is_floating_point():
        leaf.copy_(torch.randn(leaf.shape, generator=gen) * 0.1)
x["batch"] = {{k: v.random_(0, cfg.vocab, generator=gen)
              for k, v in x["batch"].items()}}
x["dev_mask"].fill_(True)
x["edge_mask"].fill_(True)
x["lr"] = 0.01
specs = inputs.input_specs(cfg, shape, mesh)
placed = {{k: shd.place(v, specs[k], mesh) if k != "lr" else v
          for k, v in x.items()}}
with dryrun.census_mode() as mode:
    dryrun.run_step(cfg, shape, mesh, placed)
if rank == 0:
    json.dump(dryrun.by_kind(mode), open(f"{{out}}/real.json", "w"))
"""


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_collectives")
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    for world in (4, 1):
        p = subprocess.run([sys.executable, "-c",
                            _FAKE.format(shape=SHAPE), str(world),
                            str(out)], env=env, capture_output=True,
                           text=True, timeout=300)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    run_ranks(_REAL.format(shape=SHAPE), 2, 2, out)
    return {name: json.load(open(out / f"{name}.json"))
            for name in ("fake4", "fake1", "real")}


def test_the_record_has_the_references_kinds(records):
    rec = records["fake4"]
    assert tuple(dryrun.KINDS) == tuple(_COLLECTIVES)
    assert set(rec) == set(_COLLECTIVES) | {"total_bytes"}
    for k in _COLLECTIVES:
        assert set(rec[k]) == {"count", "bytes"}, k
    assert rec["total_bytes"] == sum(rec[k]["bytes"] for k in _COLLECTIVES)
    # a data x model mesh moves the clients' edge sum (all-reduce over
    # data) and the tensor-parallel activations (gathers and scatters)
    for k in ("all-reduce", "all-gather", "reduce-scatter"):
        assert rec[k]["count"] > 0, k


def test_the_fake_group_counts_what_the_real_ranks_issue(records):
    fake, real = records["fake4"], records["real"]
    assert {k: fake[k]["count"] for k in _COLLECTIVES} == \
        {k: real[k]["count"] for k in _COLLECTIVES}
    assert {k: fake[k]["bytes"] for k in _COLLECTIVES} == \
        {k: real[k]["bytes"] for k in _COLLECTIVES}


def test_a_one_rank_mesh_counts_none(records):
    rec = records["fake1"]
    assert all(rec[k] == {"count": 0, "bytes": 0} for k in _COLLECTIVES)
    assert rec["total_bytes"] == 0
