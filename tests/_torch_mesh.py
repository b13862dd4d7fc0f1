"""Shared helpers of the mesh step tests (``tests/test_torch_mesh_*.py``):
the reference's smoke weights, seeded inputs, and the ranks of a
``gloo`` group on the CPU, started in one subprocess group a file (a
process group is global to its process, and never runs in a pytest
worker).  Each rank joins through ``launch.mesh.start_group``, the group
the mesh steps run on the card too, so the host-staged collectives are
the ones tested here."""
import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np

#: the rank scripts' common start: argv is (rank, world, port, data,
#: model, directory); one torch thread a rank
PRELUDE = """
import dataclasses, json, sys
import numpy as np
import torch
from repro_torch.launch.mesh import make_debug_mesh, start_group
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
data, model, out = int(sys.argv[4]), int(sys.argv[5]), sys.argv[6]
torch.set_num_threads(1)
start_group(rank, world, port, timeout_s=240)
mesh = make_debug_mesh(data=data, model=model)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code: str, data: int, model: int, out, timeout: float = 300):
    """``code`` (after PRELUDE) in ``data * model`` processes, the ranks of
    one group on a (data, model) mesh; every rank must exit 0."""
    world = data * model
    src = os.path.join(os.path.dirname(__file__), os.pardir, "src")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src) + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", PRELUDE + code, str(r), str(world), str(port),
         str(data), str(model), str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-8000:]


@functools.lru_cache(maxsize=None)
def weights(arch: str, seed: int = 0, over: tuple = ()) -> dict:
    """Smoke weights of ``arch`` (``over``: ``port_cfg``'s) drawn with
    numpy by the reference's rule (``N(0, 1) / sqrt(shape[-2])`` for a
    normal leaf, zeros and ones for the others) over its ``param_specs``'
    leaves, flat ``{"a/b": numpy}`` float32 (read only)."""
    from repro_torch.launch.steps import flatten
    from repro_torch.models import param_specs
    rng = np.random.default_rng(seed)
    out = {}
    for k, spec in sorted(flatten(param_specs(
            port_cfg(arch, over=over))).items()):
        if spec.init == "zeros":
            v = np.zeros(spec.shape, np.float32)
        elif spec.init == "ones":
            v = np.ones(spec.shape, np.float32)
        else:
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else \
                spec.shape[-1]
            v = (rng.standard_normal(spec.shape)
                 / np.sqrt(max(fan_in, 1))).astype(np.float32)
        v.setflags(write=False)
        out[k] = v
    return out


def port_cfg(arch: str, clients: int = None, over: tuple = ()):
    """The port's smoke config of ``arch`` (``clients_per_pod`` set, and
    the fields of ``over``, (name, value) pairs)."""
    from repro_torch.configs import get_smoke
    cfg = dataclasses.replace(get_smoke(arch), **dict(over))
    return cfg if clients is None else \
        dataclasses.replace(cfg, clients_per_pod=clients)


def memory_of(cfg, lead: tuple, rng, frames: int = 24):
    """Raw cross-attention memory ``[*lead, frames, d_model]`` (N(0, 1),
    float32) for a model that reads one, else None."""
    from repro_torch.launch.inputs import memory_shape
    if memory_shape(cfg) is None:
        return None
    return rng.standard_normal(lead + (frames, cfg.d_model)).astype(
        np.float32)


# ------------------------------------------------------------ train steps
#: one HieAvg step: E edges of C clients (2 rows of SEQ tokens each),
#: client 1 a straggler, learning rate LR
E, ROWS, SEQ, LR = 1, 2, 24, 0.05
#: the HieAvg step's bounds (``tests/test_torch_train.py``): rtol, atol and
#: the share of a leaf's largest change in the step added to atol
RTOL, ATOL, CHANGE = 1e-5, 1e-6, 5e-3

TRAIN_RANK = """
from repro_torch.configs import get_smoke
from repro_torch.launch import inputs, make_hfl_train_step
from repro_torch.launch import sharding as shd
from repro_torch.launch.steps import init_fl_histories, flatten, unflatten
from repro_torch.models.config import InputShape
for i, (name, arch, c, over) in enumerate(
        json.load(open(f"{out}/cases.json"))):
    z = np.load(f"{out}/in_{i}.npz")
    cfg = dataclasses.replace(get_smoke(arch), clients_per_pod=c, **over)
    params = unflatten({k[2:]: torch.from_numpy(z[k]) for k in z.files
                        if k.startswith("p/")})
    dh, gh = init_fl_histories(params)
    batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels",
                                                 "memory") if k in z.files}
    dm, em = torch.from_numpy(z["dm"]), torch.from_numpy(z["em"])
    e, c_, b, s = batch["tokens"].shape
    sp = inputs.train_input_specs(cfg, InputShape("t", s, e * c_ * b,
                                                  "train"), mesh)
    args = shd.place((params, dh, gh, batch, dm, em),
                     (sp["params"], sp["dev_hist"], sp["glob_hist"],
                      {k: sp["batch"][k] for k in batch}, sp["dev_mask"],
                      sp["edge_mask"]), mesh)
    p, d, g, loss = make_hfl_train_step(cfg, mesh=mesh)(*args,
                                                        float(z["lr"]))
    p, d, g = shd.whole((p, d, g))
    if rank == 0:
        flat = {"params/" + k: v for k, v in flatten(p).items()}
        for tag, h in (("dev", d), ("glob", g)):
            flat.update({f"{tag}.prev/{k}": v for k, v in h.prev_w.items()})
            flat.update({f"{tag}.dmean/{k}": v
                         for k, v in h.delta_mean.items()})
            flat[f"{tag}.n_obs"], flat[f"{tag}.miss_count"] = h.n_obs, \\
                h.miss_count
        np.savez(f"{out}/out_{i}.npz", loss=loss.numpy(),
                 **{k: v.numpy() for k, v in flat.items()})
"""


class TrainCases:
    """The train cases of one test file: ``cases`` maps a name to (arch,
    clients a pod, (data, model)), or to (arch, clients a pod, (data,
    model), {field: value} set on the smoke config); ``seed`` offsets the
    data's seeds."""

    def __init__(self, cases: dict, seed: int = 0):
        self.cases, self.seed = cases, seed

    def case(self, name: str) -> tuple:
        """(arch, clients a pod, (data, model), over: (field, value) pairs)."""
        arch, c, mesh, *over = self.cases[name]
        return arch, c, mesh, tuple(sorted(over[0].items())) if over else ()

    def inputs(self, name: str) -> dict:
        """Layout-A weights (client c scaled by 1 + c/100), tokens, labels
        (the first two of each row -1), memory, masks and lr, numpy."""
        arch, c, _, over = self.case(name)
        cfg = port_cfg(arch, c, over)
        scale = 1.0 + 0.01 * np.arange(c, dtype=np.float32)
        out = {}
        for k, v in weights(arch, over=over).items():
            w = np.broadcast_to(v, (E, c) + v.shape)
            out["p/" + k] = np.ascontiguousarray(
                w * scale.reshape((1, c) + (1,) * v.ndim)).astype(np.float32)
        rng = np.random.default_rng(self.seed + list(self.cases).index(name))
        out["tokens"] = rng.integers(0, cfg.vocab, (E, c, ROWS, SEQ))
        lab = rng.integers(0, cfg.vocab, (E, c, ROWS, SEQ))
        lab[..., :2] = -1
        out["labels"] = lab
        mem = memory_of(cfg, (E, c, ROWS), rng)
        if mem is not None:
            out["memory"] = mem
        out["dm"] = np.array([[True, False]] if c == 2 else [[True]])
        out["em"] = np.ones((E,), bool)
        out["lr"] = np.float32(LR)
        return out

    def run(self, tmp_path_factory) -> dict:
        """{case: the mesh step's outputs gathered whole}: each mesh's
        cases in one group of ranks."""
        res = {}
        for mesh in sorted({self.case(n)[2] for n in self.cases}):
            names = [n for n in self.cases if self.case(n)[2] == mesh]
            out = tmp_path_factory.mktemp("mesh_steps")
            with open(out / "cases.json", "w") as f:
                json.dump([(n, *self.case(n)[:2], dict(self.case(n)[3]))
                           for n in names], f)
            for i, n in enumerate(names):
                np.savez(out / f"in_{i}.npz", **self.inputs(n))
            run_ranks(TRAIN_RANK, *mesh, out)
            res.update({n: dict(np.load(out / f"out_{i}.npz"))
                        for i, n in enumerate(names)})
        return res

    @staticmethod
    def _torch(z: dict):
        import torch

        from repro_torch.launch.steps import unflatten
        params = unflatten({k[2:]: torch.from_numpy(v) for k, v in z.items()
                            if k.startswith("p/")})
        batch = {k: torch.from_numpy(z[k]) for k in ("tokens", "labels",
                                                     "memory") if k in z}
        return params, batch

    @staticmethod
    def state(p, d, g, loss, tree=lambda t: t) -> dict:
        """Flat numpy state keyed as the ranks save it; ``tree`` flattens a
        history's parameter trees (the reference's are nested)."""
        from repro_torch.launch.steps import flatten
        out = {"params/" + k: v for k, v in flatten(p).items()}
        for tag, h in (("dev", d), ("glob", g)):
            out.update({f"{tag}.prev/{k}": v
                        for k, v in tree(h.prev_w).items()})
            out.update({f"{tag}.dmean/{k}": v
                        for k, v in tree(h.delta_mean).items()})
            out[f"{tag}.n_obs"], out[f"{tag}.miss_count"] = h.n_obs, \
                h.miss_count
        out["loss"] = loss
        return {k: np.asarray(v) for k, v in out.items()}

    def cold(self, name: str) -> dict:
        """Each leaf's value before the step (the cold boot)."""
        import torch

        from repro_torch.launch import init_fl_histories
        params, _ = self._torch(self.inputs(name))
        return self.state(params, *init_fl_histories(params),
                          torch.zeros(()))

    def meshless(self, name: str) -> dict:
        import torch

        from repro_torch.launch import init_fl_histories, make_hfl_train_step
        arch, c, _, over = self.case(name)
        z = self.inputs(name)
        params, batch = self._torch(z)
        out = make_hfl_train_step(port_cfg(arch, c, over),
                                  kernel_mode="torch")(
            params, *init_fl_histories(params), batch,
            torch.from_numpy(z["dm"]), torch.from_numpy(z["em"]),
            float(z["lr"]))
        return self.state(*out)

    def reference(self, name: str) -> dict:
        """The JAX package's one-device step (jitted) on the same inputs."""
        import jax
        import jax.numpy as jnp
        from repro.configs import get_smoke as j_get_smoke
        from repro.launch.steps import init_fl_histories as j_init_hist
        from repro.launch.steps import make_hfl_train_step as j_make_hfl

        from repro_torch.launch.steps import flatten, unflatten
        arch, c, _, over = self.case(name)
        z = self.inputs(name)
        jp = jax.tree.map(jnp.asarray, unflatten(
            {k[2:]: v for k, v in z.items() if k.startswith("p/")}))
        batch = {k: jnp.asarray(z[k].astype(np.float32 if k == "memory"
                                            else np.int32))
                 for k in ("tokens", "labels", "memory") if k in z}
        cfg = dataclasses.replace(j_get_smoke(arch), clients_per_pod=c,
                                  **dict(over))
        out = jax.jit(j_make_hfl(cfg))(
            jp, *j_init_hist(jp), batch, jnp.asarray(z["dm"]),
            jnp.asarray(z["em"]), jnp.float32(z["lr"]))
        return self.state(*out, tree=flatten)


def hold_step(got: dict, want: dict, cold: dict, what: str) -> None:
    """The loss ``rtol 1e-5``, the counts exactly, every other leaf within
    RTOL, ATOL and CHANGE times its largest change in the step."""
    assert got.keys() == want.keys(), what
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               err_msg=f"{what} loss")
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        if k == "loss":
            continue
        if k.endswith(("n_obs", "miss_count")):
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")
            continue
        w = w.astype(np.float32)
        change = float(np.abs(w - cold[k]).max())
        np.testing.assert_allclose(g, w, rtol=RTOL,
                                   atol=ATOL + CHANGE * change,
                                   err_msg=f"{what} {k}")


# ------------------------------------------------------------- serving
#: a prefill of B rows of PROMPT tokens, then STEPS teacher-forced decode
#: steps, into caches of CACHE_LEN positions
B, PROMPT, STEPS, CACHE_LEN = 2, 24, 2, 32

SERVE_RANK = """
from repro_torch.configs import get_smoke
from repro_torch.launch import inputs
from repro_torch.launch import sharding as shd
from repro_torch.launch.serve import make_caches
from repro_torch.launch.steps import (flatten, make_prefill_step,
                                      make_serve_step, step_hints, unflatten)
from repro_torch.models import encode, hints
from repro_torch.models.config import InputShape
for i, arch in enumerate(json.load(open(f"{out}/cases.json"))):
    z = np.load(f"{out}/in_{i}.npz")
    cfg = get_smoke(arch)
    params = unflatten({k[2:]: torch.from_numpy(z[k]) for k in z.files
                        if k.startswith("p/")})
    tok, nxt = torch.from_numpy(z["tokens"]), torch.from_numpy(z["next"])
    b, s = tok.shape
    n = int(z["len"])
    sp = inputs.serve_input_specs(cfg, InputShape("p", n, b, "prefill"),
                                  mesh)
    dp, dc, dt = shd.place(
        (params, make_caches(cfg, b, n, "cpu", smoke=True), tok),
        (sp["params"], sp["caches"], sp["tokens"]), mesh)
    mem = None
    if "memory" in z.files:
        with hints.use(step_hints(cfg, mesh, train=False)[0]):
            mem = encode(dp, shd.place(torch.from_numpy(z["memory"]),
                                       sp["memory"], mesh), cfg)
    logits, dc = make_prefill_step(cfg, mesh=mesh)(dp, dt, dc, memory=mem)
    seen = [logits]
    for j in range(nxt.shape[0]):
        logits, dc = make_serve_step(cfg, mesh=mesh)(
            dp, shd.place(nxt[j], sp["tokens"], mesh), s + j, dc, mem)
        seen.append(logits)
    seen, dc = shd.whole((seen, dc))
    if rank == 0:
        np.savez(f"{out}/out_{i}.npz", logits=torch.stack(seen).numpy(),
                 **{"c/" + k: v.numpy() for k, v in flatten(dc).items()})
"""


class ServeCases:
    """The serve cases of one test file: arch ids on one (data, model)
    mesh, (2, 2) by default, into caches of ``cache_len`` positions."""

    def __init__(self, archs: tuple, seed: int = 0, mesh: tuple = (2, 2),
                 cache_len: int = CACHE_LEN):
        self.archs, self.seed, self.mesh = archs, seed, mesh
        self.cache_len = cache_len

    def inputs(self, arch: str) -> dict:
        cfg = port_cfg(arch)
        out = {"p/" + k: v for k, v in weights(arch, seed=1).items()}
        rng = np.random.default_rng(self.seed + self.archs.index(arch))
        out["tokens"] = rng.integers(0, cfg.vocab, (B, PROMPT))
        out["next"] = rng.integers(0, cfg.vocab, (STEPS, B, 1))
        mem = memory_of(cfg, (B,), rng)
        if mem is not None:
            out["memory"] = mem
        out["len"] = np.int64(self.cache_len)
        return out

    def run(self, tmp_path_factory) -> dict:
        """{arch: every step's logits and the caches at the end, gathered
        whole}, from one group of ranks on the cases' mesh."""
        out = tmp_path_factory.mktemp("mesh_serve")
        with open(out / "cases.json", "w") as f:
            json.dump(list(self.archs), f)
        for i, a in enumerate(self.archs):
            np.savez(out / f"in_{i}.npz", **self.inputs(a))
        run_ranks(SERVE_RANK, *self.mesh, out)
        return {a: dict(np.load(out / f"out_{i}.npz"))
                for i, a in enumerate(self.archs)}

    def meshless(self, arch: str) -> dict:
        import torch

        from repro_torch.launch.serve import make_caches
        from repro_torch.launch.steps import (flatten, make_prefill_step,
                                              make_serve_step, unflatten)
        from repro_torch.models import encode
        cfg = port_cfg(arch)
        z = self.inputs(arch)
        params = unflatten({k[2:]: torch.from_numpy(v.copy())
                            for k, v in z.items() if k.startswith("p/")})
        mem = None if "memory" not in z else encode(
            params, torch.from_numpy(z["memory"]), cfg)
        caches = make_caches(cfg, B, self.cache_len, "cpu", smoke=True)
        logits, caches = make_prefill_step(cfg)(
            params, torch.from_numpy(z["tokens"]), caches, memory=mem)
        seen = [logits]
        for j in range(STEPS):
            logits, caches = make_serve_step(cfg)(
                params, torch.from_numpy(z["next"][j]), PROMPT + j, caches,
                mem)
            seen.append(logits)
        return {"logits": torch.stack(seen).numpy(),
                **{"c/" + k: v.numpy() for k, v in flatten(caches).items()}}

    def reference(self, arch: str) -> dict:
        """The JAX package's prefill and decode (jitted), same inputs."""
        import jax
        import jax.numpy as jnp
        import repro.models.transformer as jtr
        from repro.configs import get_smoke as j_get_smoke
        from repro.models import cache_specs as j_cache_specs
        from repro.models import init_from_specs as j_init

        from repro_torch.launch.steps import flatten, unflatten
        cfg = j_get_smoke(arch)
        z = self.inputs(arch)
        params = jax.tree.map(jnp.asarray, unflatten(
            {k[2:]: v for k, v in z.items() if k.startswith("p/")}))
        caches = j_init(j_cache_specs(cfg, B, self.cache_len,
                                      dtype=jnp.float32), jax.random.key(1))
        logits, caches = jax.jit(functools.partial(jtr.prefill, cfg=cfg))(
            params, jnp.asarray(z["tokens"], jnp.int32), caches=caches)
        seen = [logits]
        dec = jax.jit(functools.partial(jtr.decode_step, cfg=cfg))
        for j in range(STEPS):
            logits, caches = dec(params,
                                 jnp.asarray(z["next"][j], jnp.int32),
                                 jnp.asarray(PROMPT + j, jnp.int32),
                                 caches=caches)
            seen.append(logits)
        return {"logits": np.stack([np.asarray(x) for x in seen]),
                **{"c/" + k: np.asarray(v) for k, v in flatten(
                    jax.tree.map(np.asarray, caches)).items()}}


def hold_serve(got: dict, want: dict, rel: float, what: str,
               logits_atol=None) -> None:
    """Every step's logits and every cache leaf: ``rtol`` 1e-5 (0 against
    an absolute ``logits_atol``) and ``atol`` ``rel`` of the leaf's
    largest."""
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        if k == "logits" and logits_atol is not None:
            np.testing.assert_allclose(got[k], w, rtol=0, atol=logits_atol,
                                       err_msg=f"{what} {k}")
            continue
        np.testing.assert_allclose(
            got[k], w, rtol=0 if logits_atol is not None else 1e-5,
            atol=rel * float(np.abs(w).max()), err_msg=f"{what} {k}")
