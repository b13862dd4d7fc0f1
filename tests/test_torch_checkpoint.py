"""The port's checkpoints (``repro_torch.checkpoint``) and resumable runs
(``BHFLSimulator.run_checkpointed``).

  * Round trips of nested dicts and dataclasses are bitwise for float32,
    bfloat16 and float8_e4m3fn tensors (NaN and infinity included), bool
    and integer tensors and numpy arrays; keys, shapes and dtypes are
    checked on restore.  Writes leave no temporary file behind.
  * A checkpointed TINY run killed after a chunk and resumed from a fresh
    simulator ends bitwise equal to the uninterrupted checkpointed run
    (HieAvg with bf16 history, delayed-gradient with its pending store and
    ages); against ``run()`` it agrees to ``rtol 1e-5``, ``atol 1e-6``
    (on the CPU the chunked loop launches the same operations).  The
    checkpointed run matches the JAX package's ``run_checkpointed`` at the
    engine-parity bounds of ``tests/test_engine_parity.py``.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.bhfl_cnn import REDUCED  # noqa: E402
from repro.fl import BHFLSimulator as JaxSim  # noqa: E402
from repro.models import init_from_specs  # noqa: E402
from repro_torch.checkpoint import (latest_step,  # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs import REDUCED as PORT_REDUCED  # noqa: E402
from repro_torch.core.hieavg import History, init_history  # noqa: E402
from repro_torch.fl import BHFLSimulator  # noqa: E402
from _torch_threads import one_thread  # noqa: E402,F401

TINY = dataclasses.replace(REDUCED, t_global_rounds=4, n_edges=3,
                           j_per_edge=3, image_hw=8)
PORT_TINY = dataclasses.replace(PORT_REDUCED, t_global_rounds=4, n_edges=3,
                                j_per_edge=3, image_hw=8)
KW = dict(n_train=300, n_test=100, steps_per_epoch=2)
ROWS = ("accuracy", "loss", "grad_norm", "sim_clock", "sim_energy")


def _tree(dtype):
    g = torch.Generator()
    g.manual_seed(0)
    x = torch.randn((3, 5), generator=g) * 100
    x[0, :3] = torch.tensor([float("inf"), float("nan"), -1e-8])
    hist = init_history({"w": x}, None if dtype == torch.float32 else dtype)
    return {"carry": {"hist": hist, "mask": x > 0,
                      "count": torch.arange(4, dtype=torch.int64)},
            "outs": {"acc": np.linspace(0, 1, 4, dtype=np.float32)}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, History):
        return _leaves(dataclasses.asdict(tree))
    return [tree]


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.contiguous().view(torch.uint8).equal(
                b.contiguous().view(torch.uint8)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float8_e4m3fn],
                         ids=["f32", "bf16", "f8"])
def test_round_trip_is_bitwise(tmp_path, dtype):
    tree = _tree(dtype)
    path = save_checkpoint(str(tmp_path), 7, tree, metadata={"t": 7})
    assert os.path.basename(path) == "step_00000007.npz"
    assert sorted(os.listdir(tmp_path)) == ["step_00000007.json",
                                            "step_00000007.npz"]
    like = _tree(dtype)
    got, meta = restore_checkpoint(str(tmp_path), like)
    assert meta == {"t": 7}
    assert isinstance(got["carry"]["hist"], History)
    assert got["carry"]["hist"].prev_w["w"].dtype == dtype
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert _same(a, b)


def test_restore_checks_keys_shapes_and_dtypes(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.zeros(3),
                                       "b": torch.zeros(2, dtype=torch.bfloat16)})
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(4),
                                           "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="stored"):
        restore_checkpoint(str(tmp_path),
                           {"a": torch.zeros(3),
                            "b": torch.zeros(2, dtype=torch.float8_e4m3fn)})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), {})
    assert latest_step(str(tmp_path)) == 1
    save_checkpoint(str(tmp_path), 12, {"a": torch.zeros(3)})
    assert latest_step(str(tmp_path)) == 12


# ------------------------------------------------------------ resumed runs
def _kill_after_first_chunk(ckpt_dir):
    """Delete every checkpoint after the first, as if the run had been
    killed then."""
    steps = sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz"))
    assert len(steps) >= 2
    for f in steps[1:]:
        os.remove(os.path.join(ckpt_dir, f))
        os.remove(os.path.join(ckpt_dir, f.replace(".npz", ".json")))


@pytest.mark.parametrize("agg,kw", [
    ("hieavg", dict(history_dtype=torch.bfloat16)),
    ("delayed_grad", {})], ids=["hieavg_bf16", "delayed_grad"])
def test_resumed_run_is_bitwise_the_uninterrupted_one(tmp_path, agg, kw):
    def sim():
        return BHFLSimulator(PORT_TINY, agg, "temporary", "temporary",
                             device="cpu", **KW, **kw)

    full = sim().run_checkpointed(str(tmp_path / "a"), every=1)
    sim().run_checkpointed(str(tmp_path / "b"), every=1)
    _kill_after_first_chunk(str(tmp_path / "b"))
    assert latest_step(str(tmp_path / "b")) == 1
    resumed = sim().run_checkpointed(str(tmp_path / "b"), every=1)
    for row in ROWS:
        np.testing.assert_array_equal(getattr(resumed, row),
                                      getattr(full, row), err_msg=row)
    assert resumed.blocks == full.blocks and resumed.chain_valid
    ref = sim().run()
    for row in ROWS:
        np.testing.assert_allclose(getattr(full, row), getattr(ref, row),
                                   rtol=1e-5, atol=1e-6, err_msg=row)
    # the last checkpoint holds the final state, so a rerun only reads it
    again = sim().run_checkpointed(str(tmp_path / "b"), every=1)
    np.testing.assert_array_equal(again.loss, full.loss)


def test_resume_false_starts_over_and_every_is_checked(tmp_path):
    sim = BHFLSimulator(PORT_TINY, device="cpu", **KW)
    with pytest.raises(ValueError, match="every"):
        sim.run_checkpointed(str(tmp_path), every=0)
    a = sim.run_checkpointed(str(tmp_path), every=3)
    assert latest_step(str(tmp_path)) == 4
    b = BHFLSimulator(PORT_TINY, device="cpu", **KW).run_checkpointed(
        str(tmp_path), every=2, resume=False)
    np.testing.assert_array_equal(a.loss, b.loss)
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) \
        == ["step_00000002.npz", "step_00000003.npz", "step_00000004.npz"]


def test_checkpointed_run_matches_jax(tmp_path):
    """The JAX package's ``run_checkpointed`` and the port's, with the
    initial weights carried over."""
    sim = JaxSim(TINY, "delayed_grad", kernel_mode="xla", **KW)
    w0 = {k: np.asarray(v) for k, v in
          init_from_specs(sim.specs, jax.random.key(sim.seed)).items()}
    ref = sim.run_checkpointed(str(tmp_path / "jax"), every=2)
    got = BHFLSimulator(PORT_TINY, "delayed_grad", device="cpu",
                        init_params=w0, **KW).run_checkpointed(
        str(tmp_path / "port"), every=2)
    np.testing.assert_allclose(got.accuracy, ref.accuracy, atol=0.02)
    np.testing.assert_allclose(got.loss, ref.loss, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.grad_norm, ref.grad_norm, rtol=0.01,
                               atol=1e-4)
    np.testing.assert_array_equal(got.sim_clock, ref.sim_clock)
    np.testing.assert_array_equal(got.sim_energy, ref.sim_energy)
    assert got.blocks == ref.blocks
