"""The LLM training entry point on a multi-rank mesh
(``repro_torch.launch.train.run(mesh=...)``) on the CPU, against the
port's one-process ``train.run`` and the JAX package's
``repro.launch.train.run``.

Four ranks of a (data=2, model=2) mesh run in subprocesses on the staged
group (``tests/_torch_mesh.py``: ``start_group``, collectives through
``gloo`` on host copies), danube-smoke with the reference's weights
carried over (``init_params``), 3 global rounds of 2 edge rounds, fused
and per-round.  Bounds, those of ``tests/test_torch_train.py``'s
``train.run`` test for both comparisons: the host plane (every batch's
tokens and labels, the masks) bitwise, ``sim_clock``, ``blocks`` and
``chain_valid`` equal; the first global round's loss within
``rtol = atol = 1e-3``, the later rounds' within ``rtol 2e-2`` (training
these random weights is chaotic: the split over ``model`` sums its
products in another order, as the reference's jit and eager do).  A
checkpoint after one global round of the mesh run holds the one-process
run's leaves within the first round's bound (``rtol 1e-3``, ``atol``
1e-3 of the leaf's largest; the embedding is 5.9e-4 of its largest off,
the reference 2.4e-3: a round later the chaos parts them by 0.35 and
0.14 on the CPU).  Each rank's state built leaf by leaf
(``train.mesh_state``: from the seed, in float32 and bfloat16, and from
numpy) equals its chunk of the one-process state bitwise.
"""
import json
import sys

import jax
import numpy as np
import pytest
import torch
from _torch_mesh import run_ranks
from _torch_threads import one_thread  # noqa: F401

import repro.launch.train as jtrain
from repro.configs import get_smoke as j_get_smoke
from repro.models import init_from_specs as j_init
from repro.models import param_specs as j_param_specs
from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import flatten, unflatten

ARCH = "h2o-danube-1.8b"
KW = dict(smoke=True, steps=3, k_edge=2, progress=False)
MODES = {"fused": True, "loop": False}
SOURCES = ("seed", "seed_bf16", "numpy")

#: each rank: the three state builds against ``place`` of the one-process
#: state, then ``train.run`` fused (with a checkpoint) and per-round, the
#: step wrapped to record every batch and mask gathered whole
RANK = """
import torch.distributed as dist
from repro_torch.configs import get_smoke
from repro_torch.launch import sharding as shd
from repro_torch.launch import train
from repro_torch.launch.serve import make_params
from repro_torch.launch.steps import flatten, init_fl_histories, unflatten
from repro_torch.models.transformer import params_from_numpy
from repro_torch.optim.sgd import tree_map
ARCH = "h2o-danube-1.8b"
z = np.load(f"{out}/base.npz")
init = unflatten({k: z[k] for k in z.files})
same = {}
for source in ("seed", "seed_bf16", "numpy"):
    cfg = dataclasses.replace(get_smoke(ARCH), clients_per_pod=2,
                              param_dtype="bfloat16" if source == "seed_bf16"
                              else "float32")
    specs = train.mesh_specs(cfg, mesh, edges=1, clients=2, batch=4, seq=64)
    mine = train.mesh_state(cfg, mesh, specs, seed=0, device="cpu",
                            init_params=init if source == "numpy" else None)
    w = make_params(cfg, 0, "cpu") if source != "numpy" else tree_map(
        lambda x: x.to(cfg.torch_param_dtype), params_from_numpy(init))
    p = tree_map(lambda x: x[None, None].expand(1, 2, *x.shape).contiguous(),
                 w)
    want = shd.place((p, *init_fl_histories(p)),
                     (specs["params"], specs["dev_hist"], specs["glob_hist"]),
                     mesh)
    def leaves(t, pre):
        if isinstance(t, dict):
            return {f"{pre}/{k}": v for k, v in flatten(t).items()}
        return {f"{pre}.{f}": getattr(t, f)
                for f in ("n_obs", "miss_count")} | {
            f"{pre}.prev/{k}": v for k, v in t.prev_w.items()} | {
            f"{pre}.dmean/{k}": v for k, v in t.delta_mean.items()}
    g = {**leaves(mine[0], "params"), **leaves(mine[1], "dev"),
         **leaves(mine[2], "glob")}
    r = {**leaves(want[0], "params"), **leaves(want[1], "dev"),
         **leaves(want[2], "glob")}
    same[source] = {"keys": sorted(g) == sorted(r), "differ": [
        k for k in r if not (g[k].to_local().dtype == r[k].to_local().dtype
                             and torch.equal(g[k].to_local(),
                                             r[k].to_local()))],
        "placements": [k for k in r if g[k].placements != r[k].placements
                       or g[k].shape != r[k].shape],
        "leaves": len(r)}
seen = []
make = train.make_hfl_train_step
def recording(*a, **k):
    step = make(*a, **k)
    def wrapped(params, dh, gh, batch, dm, em, lr):
        seen.append([shd.whole(x).numpy() for x in
                     (batch["tokens"], batch["labels"], dm, em)])
        return step(params, dh, gh, batch, dm, em, lr)
    return wrapped
train.make_hfl_train_step = recording
runs = {}
for name, fused in (("fused", True), ("loop", False)):
    seen.clear()
    res = train.run(ARCH, smoke=True, steps=3, k_edge=2, progress=False,
                    fused=fused, device="cpu", init_params=init, mesh=mesh)
    runs[name] = {k: np.asarray(v).tolist() if k != "mesh" else v
                  for k, v in res.items()}
    np.savez(f"{out}/seen_{name}_{rank}.npz",
             **{f"{i}_{j}": x for i, s in enumerate(seen)
                for j, x in enumerate(s)})
train.run(ARCH, smoke=True, steps=1, k_edge=2, progress=False, device="cpu",
          init_params=init, mesh=mesh, ckpt_dir=f"{out}/ckpt")
json.dump({"same": same, "runs": runs}, open(f"{out}/rank{rank}.json", "w"))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def base() -> dict:
    """The reference's danube-smoke weights from seed 0 (numpy), as its
    ``train.run`` draws them."""
    cfg = j_get_smoke(ARCH)
    return jax.tree.map(np.asarray, j_init(j_param_specs(cfg),
                                           jax.random.key(0),
                                           param_dtype=np.float32))


@pytest.fixture(scope="module")
def ranks(base, tmp_path_factory) -> dict:
    """Every rank's record and the batches it saw, from one group."""
    out = tmp_path_factory.mktemp("train_mesh")
    np.savez(out / "base.npz", **flatten(base))
    run_ranks(RANK, 2, 2, out)
    recs = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(4)]
    seen = {(m, r): dict(np.load(out / f"seen_{m}_{r}.npz"))
            for m in MODES for r in range(4)}
    return {"recs": recs, "seen": seen, "ckpt": out / "ckpt"}


def _recording(monkeypatch) -> list:
    """Wrap ``train``'s step builder: every batch and mask it is handed,
    numpy, in order."""
    seen, make = [], ttrain.make_hfl_train_step

    def recording(*a, **k):
        step = make(*a, **k)

        def wrapped(params, dh, gh, batch, dm, em, lr):
            seen.append([x.numpy().copy() for x in
                         (batch["tokens"], batch["labels"], dm, em)])
            return step(params, dh, gh, batch, dm, em, lr)
        return wrapped

    monkeypatch.setattr(ttrain, "make_hfl_train_step", recording)
    return seen


def _held(got: dict, want: dict, what: str) -> None:
    if "sim_clock" in want:
        np.testing.assert_array_equal(got["sim_clock"], want["sim_clock"])
    assert (got["blocks"], got["chain_valid"]) == (want["blocks"],
                                                   want["chain_valid"]), what
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-3, atol=1e-3, err_msg=what)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=2e-2,
                               err_msg=what)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_run_matches_one_process(ranks, base, mode, monkeypatch,
                                      tmp_path):
    seen = _recording(monkeypatch)
    want = ttrain.run(ARCH, device="cpu", init_params=base, fused=MODES[mode],
                      ckpt_dir=str(tmp_path) if mode == "fused" else None,
                      **KW)
    runs = [{k: v for k, v in rec["runs"][mode].items() if k != "wall"}
            for rec in ranks["recs"]]
    for r, got in enumerate(runs):
        assert got == runs[0], f"rank {r} returned another dict"
    got = runs[0]
    assert got["backend"] == "staged"
    assert got["mesh"] == {"data": 2, "model": 2}
    assert set(ranks["recs"][0]["runs"][mode]) == set(want) | {"backend",
                                                                "mesh"}
    _held(got, want, mode)
    assert len(seen) == 6
    for r in range(4):
        mine = ranks["seen"][mode, r]
        assert len(mine) == 4 * len(seen)
        for i, s in enumerate(seen):
            for j, x in enumerate(s):
                np.testing.assert_array_equal(mine[f"{i}_{j}"], x)


@pytest.mark.parametrize("mode", MODES)
def test_mesh_run_matches_reference(ranks, mode):
    want = jtrain.run(ARCH, fused=MODES[mode], **KW)
    got = ranks["recs"][0]["runs"][mode]
    assert set(got) == set(want) | {"backend", "mesh"}
    _held(got, want, mode)


@pytest.mark.parametrize("source", SOURCES)
def test_rank_chunks_equal_the_one_process_state(ranks, source):
    for r, rec in enumerate(ranks["recs"]):
        same = rec["same"][source]
        assert same["keys"] and same["leaves"] > 10, (r, same)
        assert same["placements"] == [], (r, same)
        assert same["differ"] == [], (r, same)


def test_mesh_checkpoint_matches_one_process(ranks, base, tmp_path):
    from repro_torch.checkpoint import latest_step
    ttrain.run(ARCH, device="cpu", init_params=base, ckpt_dir=str(tmp_path),
               **dict(KW, steps=1))
    assert latest_step(str(ranks["ckpt"])) == latest_step(str(tmp_path)) == 1
    name = "step_00000001"
    got = dict(np.load(ranks["ckpt"] / f"{name}.npz"))
    want = dict(np.load(tmp_path / f"{name}.npz"))
    assert got.keys() == want.keys() and len(want) > 10
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=1e-3,
                                   atol=1e-3 * float(np.abs(w).max()),
                                   err_msg=k)
    meta = [json.loads((d / f"{name}.json").read_text())
            for d in (ranks["ckpt"], tmp_path)]
    assert meta[0] == meta[1]


# ------------------------------------------------------------- backends
@pytest.mark.parametrize("cuda, cards, world, asked, chosen", [
    (True, 4, 4, "auto", "nccl"),
    (True, 1, 4, "auto", "staged"),
    (False, 0, 4, "auto", "staged"),
    (True, 1, 4, "staged", "staged"),
    (True, 4, 4, "nccl", "nccl"),
    (True, 1, 4, "nccl", RuntimeError),
    (False, 0, 1, "nccl", RuntimeError),
    (True, 4, 4, "mpi", ValueError),
])
def test_backend_rule(monkeypatch, cuda, cards, world, asked, chosen):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if isinstance(chosen, str):
        got, why = tmesh.choose_backend(asked, world)
        assert got == chosen
        assert f"{cards} card" in why and f"{world} rank" in why
        assert why.startswith("auto" if asked == "auto" else "asked")
        return
    with pytest.raises(chosen):
        tmesh.choose_backend(asked, world)


@pytest.mark.parametrize("cuda, cards", [(False, 0), (True, 1)])
def test_nccl_that_cannot_be_honoured_raises_before_a_group(monkeypatch,
                                                            cuda, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match="nccl"):
        tmesh.start_group(0, 4, 1, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_start_group_reads_the_launcher_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
              "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        tmesh._launcher_env(None, None, None)
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tmesh._launcher_env(None, None, None)
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert tmesh._launcher_env(None, None, None) == (3, 4, 3, "env://")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="single node"):
        tmesh._launcher_env(None, None, None)
    assert tmesh._launcher_env(1, 2, 1234) == (1, 2, 1,
                                               "tcp://127.0.0.1:1234")


# ----------------------------------------------------- the command line
@pytest.mark.parametrize("text, want", [
    ("data=2,model=2", {"data": 2, "model": 2}),
    ("data=1,model=4,pod=2", {"data": 1, "model": 4, "pod": 2}),
    ("data=2", ValueError), ("data=2,model=0", ValueError),
    ("data=2,model=2,data=1", ValueError), ("rows=2,model=2", ValueError),
])
def test_parse_mesh(text, want):
    if isinstance(want, dict):
        assert ttrain.parse_mesh(text) == want
        return
    with pytest.raises(want):
        ttrain.parse_mesh(text)


def test_backend_needs_mesh(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--backend", "nccl"])
    with pytest.raises(SystemExit):
        ttrain.main()
    assert "--backend needs --mesh" in capsys.readouterr().err


@pytest.mark.parametrize("axes, edges, clients, batch", [
    ({"pod": 2, "data": 1, "model": 1}, 3, 2, 4),
    ({"data": 2, "model": 1}, 1, 3, 4),
    ({"data": 2, "model": 1}, 1, 1, 3),
])
def test_mesh_specs_refuse_a_mesh_that_does_not_divide(axes, edges, clients,
                                                       batch):
    cfg = get_smoke(ARCH)
    mesh = type("Mesh", (), {"shape": axes})()
    with pytest.raises(ValueError, match="axis of 2"):
        ttrain.mesh_specs(cfg, mesh, edges=edges, clients=clients,
                          batch=batch, seq=16)
