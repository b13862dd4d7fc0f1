"""The port's sweep split over the ranks of a mesh
(``repro_torch.fl.sweep.execute_plan`` with ``mesh=``) against the JAX
package's ``placement="vmap"`` run and the port's one-process run.

Four ``gloo`` ranks on the CPU, in a subprocess (a process group is global
to its process), run the TINY grid of ``tests/test_multidevice_sweep.py``
(``REDUCED`` at T = 3, N = J = 3, 8x8 images) with
``placement="shard", max_buckets=1``: each rank runs one of the bucket's
four points and the ``[P, T]`` rows are all-gathered.  Rank 0's rows are
held to the reference's ``run_sweep(placement="vmap")`` (never its
``shard_map`` path, which has failed since the seed) and to one standalone
reference run within the engine-parity bounds of
``tests/test_engine_parity.py`` (accuracy ``atol 0.02``, loss
``rtol = atol = 1e-3``, delta ``rtol 0.01``), clock and energy equal, and
to the port's one-process run of the same plan within the same bounds.
The reference's initial weights are carried over.  The ranks also check
``sweep_spec`` on their mesh, that ``"shard"`` on buckets that cannot
divide the mesh raises the reference's message, and that ``"auto"`` gives
every rank the same rows.
"""
import dataclasses
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.fl import run_sweep as jax_run_sweep  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.fl import run_sweep  # noqa: E402
from repro_torch.launch.mesh import make_sweep_mesh  # noqa: E402
from repro_torch.launch.sharding import sweep_spec  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=3, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=3, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
OVS = [{"n_edges": 2}, {"j_per_edge": 2}, {"k_edge_rounds": 1},
       {"straggler_frac": 0.4}]
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")
ACC_TOL, LOSS_TOL, DELTA_RTOL = 0.02, 1e-3, 0.01
RANKS = 4

_RANK = textwrap.dedent("""
    import dataclasses, datetime, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import REDUCED
    from repro_torch.fl import run_sweep
    from repro_torch.launch.mesh import make_sweep_mesh
    from repro_torch.launch.sharding import sweep_spec

    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{{port}}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    mesh = make_sweep_mesh()
    assert sweep_spec(4, mesh) == ("data",), sweep_spec(4, mesh)
    assert sweep_spec(3, mesh) == (), sweep_spec(3, mesh)
    TINY = dataclasses.replace(REDUCED, t_global_rounds=3, n_edges=3,
                               j_per_edge=3, image_hw=8)
    KW = dict(n_train=300, n_test=100, steps_per_epoch=2, device="cpu")
    ovs = {ovs!r}
    w0 = {{k: v for k, v in np.load(out + "/w0.npz").items()}}
    shard = run_sweep(TINY, overrides=ovs, placement="shard",
                      max_buckets=1, mesh=mesh, init_params=w0, **KW)
    try:
        run_sweep(TINY, overrides=ovs, placement="shard", mesh=mesh,
                  bucket_cost="proxy", max_buckets=4, init_params=w0, **KW)
        raise SystemExit("placement='shard' ran buckets that cannot divide")
    except ValueError as e:
        msg = str(e)
    auto = run_sweep(TINY, overrides=ovs, placement="auto", mesh=mesh,
                     bucket_cost="proxy", init_params=w0, **KW)
    np.savez(f"{{out}}/rank{{rank}}.npz", msg=msg,
             **{{"shard_" + k: getattr(shard, k) for k in {rows!r}}},
             **{{"auto_" + k: getattr(auto, k) for k in {rows!r}}})
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def w0():
    """The reference's initial model of seed 0 (what its sweep draws)."""
    sim = JaxSim(TINY, seed=0, **KW)
    return {k: np.asarray(v) for k, v in
            init_from_specs(sim.specs, jax.random.key(0)).items()}


@pytest.fixture(scope="module")
def ranks(w0, tmp_path_factory):
    """Each rank's saved rows, from four ``gloo`` ranks on the CPU."""
    out = tmp_path_factory.mktemp("mesh_sweep")
    np.savez(out / "w0.npz", **w0)
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    code = _RANK.format(ovs=OVS, rows=ROWS)
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r),
                               str(RANKS), str(port), str(out)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(RANKS)]


def _within(a: dict, b: dict) -> None:
    np.testing.assert_allclose(a["accuracy"], b["accuracy"], rtol=0,
                               atol=ACC_TOL)
    np.testing.assert_allclose(a["loss"], b["loss"], rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                               rtol=DELTA_RTOL, atol=1e-4)
    np.testing.assert_array_equal(a["sim_clock"], b["sim_clock"])
    np.testing.assert_array_equal(a["sim_energy"], b["sim_energy"])


def _rows(res, prefix: str = "") -> dict:
    if isinstance(res, dict):
        return {k: res[prefix + k] for k in ROWS}
    return {k: np.asarray(getattr(res, k)) for k in ROWS}


def test_four_ranks_agree_with_the_reference_vmap_sweep(ranks):
    ref = jax_run_sweep(TINY, overrides=OVS, placement="vmap",
                        max_buckets=1, bucket_cost="proxy", **KW)
    _within(_rows(ranks[0], "shard_"), _rows(ref))


def test_four_ranks_agree_with_a_standalone_reference_run(ranks):
    r0 = JaxSim(dataclasses.replace(TINY, **OVS[0]), "hieavg", "temporary",
                "temporary", **KW).run()
    got = _rows(ranks[0], "shard_")
    t = len(r0.accuracy)
    _within({k: got[k][0, :t] for k in ROWS},
            {k: np.asarray(getattr(r0, k)) for k in ROWS})


def test_four_ranks_agree_with_the_ports_one_process_run(ranks, w0):
    one = run_sweep(PORT_TINY, overrides=OVS, max_buckets=1, device="cpu",
                    init_params=w0, **KW)
    _within(_rows(ranks[0], "shard_"), _rows(one))


@pytest.mark.parametrize("placement", ["shard", "auto"])
def test_every_rank_returns_the_same_rows(ranks, placement):
    for r in ranks[1:]:
        for k in ROWS:
            np.testing.assert_array_equal(r[f"{placement}_{k}"],
                                          ranks[0][f"{placement}_{k}"])


def test_shard_on_indivisible_buckets_raises_the_references_message(ranks):
    msg = str(ranks[0]["msg"])
    assert msg.startswith("placement='shard' but a bucket of ")
    assert "does not divide a >1 mesh axis (mesh={'data': 4}); force " \
        "max_buckets=1 or use placement='auto'" in msg


def test_sweep_spec_on_one_rank_and_the_one_rank_shard_refusal(w0):
    """A world of one: every bucket runs whole, and ``"shard"`` raises as
    the reference does on a one-device mesh."""
    import torch.distributed as dist
    started = not dist.is_initialized()
    mesh = make_sweep_mesh()
    try:
        assert sweep_spec(4, mesh) == ()
        assert sweep_spec(4, type("M", (), {"shape": {"data": 4}})) \
            == ("data",)
        assert sweep_spec(3, type("M", (), {"shape": {"data": 4}})) == ()
        with pytest.raises(ValueError, match=r"placement='shard' but a "
                           r"bucket of 4 grid points \(of 4 total\) does "
                           r"not divide a >1 mesh axis \(mesh=\{'data': 1\}"):
            run_sweep(PORT_TINY, overrides=OVS, max_buckets=1, mesh=mesh,
                      placement="shard", device="cpu", init_params=w0, **KW)
    finally:
        if started:
            dist.destroy_process_group()
