"""The ctypes signatures of the port's CUDA launchers against their C
declarations, and the host-side arithmetic of the bfloat16 flash kernels:
the forward's p split, and a plain-PyTorch model of the bfloat16 flash
backward's arithmetic (bf16 operands, P and dS split into ``BWD_TERMS``
bf16 terms, float32 sums) against ``ref.flash_attention_bwd_ref``.

``build.SIGNATURES`` sets each launcher's ``argtypes``; ctypes converts
every argument by it without looking at the C function, so a pointer
declared ``c_int`` there is cut to 32 bits in silence.  The first test
parses every ``extern "C" int *_launch(`` in ``kernels/csrc/*.cu`` and
holds its arity, and pointer or integer per argument, against the table.
The flash launchers' one float, ``scale``, is what the wrappers pass as
``1/sqrt(Dh)`` of the caller's head dim beside the built head dim they
run on (zero-padded where no kernel is built for it).  No compiler or
card is needed.
"""
import importlib
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.flash_attention import (BWD_TERMS,  # noqa: E402
                                                 _tma_strides)
from _torch_threads import one_thread  # noqa: E402,F401

#: C scalar types of the launchers and their ctypes
C_SCALARS = {"int": build._I, "long long": build._L, "float": build._F}


def _launchers() -> dict:
    """symbol -> list of ctypes, parsed from every source's extern "C"
    launchers (a pointer is any argument with a '*')."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+_launch)\((.*?)\)\s*\{',
                             text, re.S):
            args = []
            for arg in " ".join(m.group(2).split()).split(","):
                if "*" in arg:
                    args.append(build._P)
                    continue
                ctype = " ".join(arg.split()[:-1]).replace("const ", "")
                assert ctype in C_SCALARS, f"{src.name}: {arg!r}"
                args.append(C_SCALARS[ctype])
            found[m.group(1)] = args
    return found


def test_every_launcher_signature_matches_its_c_declaration():
    parsed = _launchers()
    assert sorted(parsed) == sorted(build.SIGNATURES)
    for name, args in parsed.items():
        want = list(build.SIGNATURES[name])
        assert len(args) == len(want), f"{name}: arity"
        for i, (a, w) in enumerate(zip(args, want)):
            assert a is w, f"{name} argument {i}: C {a}, ctypes {w}"


def _split(p: torch.Tensor, terms: int) -> list:
    """p (float32) as the kernel splits it: each bf16 term the round to
    nearest of what the terms before it left (exact in float32)."""
    out, r = [], p
    for _ in range(terms):
        t = r.to(torch.bfloat16)
        out.append(t)
        r = r - t.float()
    return out


@pytest.mark.parametrize("terms,rel", [(3, 2.0 ** -24), (2, 2.0 ** -16)])
def test_p_split_rebuilds_p_within_its_bound(terms, rel):
    """p in [0, 1] from exp of a logit, as the kernel's softmax makes it:
    three bf16 terms rebuild p within float32's own rounding (2^-24 p),
    two within 2^-16 p; bf16 subnormals add at most half their ulp."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.random(200000), -rng.random(200000) * 100,
                        [0.0, -1e-30, -87.0, -103.0, -110.0]])
    p = torch.exp(torch.from_numpy(np.minimum(x, 0.0)).float())
    p = torch.cat([p, torch.tensor([0.0, 1.0])])
    parts = _split(p, terms)
    back = sum(t.double() for t in parts)
    err = (back - p.double()).abs()
    assert bool((err <= rel * p.double() + 2.0 ** -134).all()), \
        float((err / p.double().clamp(min=1e-300)).max())
    assert all(t.dtype == torch.bfloat16 for t in parts)
    if terms == 2:     # why the kernel takes three: two leave more
        assert float(err.max()) > 2.0 ** -24


#: chip_smoke.py's FLASH_BWD_REL["bfloat16"]: each gradient within one
#: bfloat16 ulp at the top binade of its largest magnitude
BWD_REL_BF16 = 2.0 ** -7
#: (Sq, Skv, H, Hkv, Dh, causal, window, q_offset, q scale): GQA groups 1
#: and 4, tails of the 64- and 128-row tiles, windows that are no multiple
#: of a tile, rows that see no key after (window) and before (q_offset < 0)
#: the ones that do, a chunked prefill's offset, sharp logits (q x 24)
BWD_MODEL_CASES = [(129, 129, 8, 2, 80, True, 100, 0, 1.0),
                   (257, 129, 4, 1, 80, False, 90, 0, 1.0),
                   (96, 96, 4, 1, 32, True, None, -10, 1.0),
                   (200, 300, 8, 2, 64, True, 70, 100, 1.0),
                   (128, 256, 4, 1, 128, True, None, 128, 24.0)]


def _bwd_model(q, k, v, o, lse, do, terms, causal, window, q_offset):
    """The bfloat16 backward kernels' arithmetic in plain PyTorch: S = q kᵀ
    and dP = do vᵀ of bf16 values summed in float32, P = 2^((S/√Dh - lse)
    log2 e) (0 where the masks drop the pair), dS = P (dP - delta) with
    delta summed in float64, P and dS each split into ``terms`` bf16 terms
    (each the round to nearest of what the terms before it left) whose
    products with the bf16 operands are summed in float32, the scale on the
    float32 sums of dk and dq, each gradient rounded once to bf16."""
    b, sq, h, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(dh)
    qf, dof = (x.float().permute(0, 2, 1, 3) for x in (q, do))
    kf, vf = (x.float().permute(0, 2, 1, 3).repeat_interleave(g, 1)
              for x in (k, v))
    delta = (do.double() * o.double()).sum(-1).float().permute(0, 2, 1)
    qpos = q_offset + torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None]
    ok = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    t = (qf @ kf.transpose(2, 3)) * scale - lse[..., None]
    p = torch.where(ok, torch.exp2(t * math.log2(math.e)), 0.0)
    ds = p * (dof @ vf.transpose(2, 3) - delta[..., None])
    ps = [x.float() for x in _split(p, terms)]
    dss = [x.float() for x in _split(ds, terms)]
    dv = sum(x.transpose(2, 3) @ dof for x in ps)
    dk = sum(x.transpose(2, 3) @ qf for x in dss) * scale
    dq = sum(x @ kf for x in dss) * scale
    dk, dv = (x.view(b, hkv, g, skv, dh).sum(2) for x in (dk, dv))
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for x in (dq, dk, dv))


def _bwd_model_rel(case, terms):
    """The model's worst gradient against the plain backward, over
    BWD_REL_BF16 x that gradient's largest magnitude, and the model's dq
    on the rows that see no key (lse +inf)."""
    sq, skv, h, hkv, dh, causal, window, off, qs = case
    rng = np.random.default_rng(sq * 7 + skv)

    def bf16(*shape, scale=1.0):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32) * scale).to(torch.bfloat16)

    q, k, v, do = (bf16(2, sq, h, dh, scale=qs), bf16(2, skv, hkv, dh),
                   bf16(2, skv, hkv, dh), bf16(2, sq, h, dh))
    kw = dict(causal=causal, window=window, q_offset=off)
    o, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
    got = _bwd_model(q, k, v, o, lse, do, terms, **kw)
    rel = max(((a.float() - w.float()).abs().max()
               / w.float().abs().max()).item() for a, w in zip(got, want))
    return rel / BWD_REL_BF16, got[0][torch.isinf(lse).permute(0, 2, 1)]


@pytest.mark.parametrize("case", BWD_MODEL_CASES,
                         ids=[f"case{i}" for i in range(len(BWD_MODEL_CASES))])
def test_bwd_split_model_holds_the_bf16_bound(case):
    """The bfloat16 backward's arithmetic with P and dS in BWD_TERMS bf16
    terms holds chip_smoke.py's bound against the plain backward, within
    half of it, and a row that sees no key gets dq exactly 0."""
    frac, unseen = _bwd_model_rel(case, BWD_TERMS)
    assert frac <= 0.5, frac
    assert bool((unseen == 0).all())


def test_bwd_split_terms_why_two():
    """Why the kernels take two terms: one (P and dS rounded to bf16)
    reads above half the bound at some case and more than twice the worst
    reading of two; and the kernel source splits into the terms the
    wrapper names."""
    one = max(_bwd_model_rel(c, 1)[0] for c in BWD_MODEL_CASES)
    two = max(_bwd_model_rel(c, 2)[0] for c in BWD_MODEL_CASES)
    assert one > 0.5 and two <= 0.5 and one > 2 * two, (one, two)
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    m = re.search(r"constexpr int TERMS = (\d+);", src)
    assert m and int(m.group(1)) == BWD_TERMS


def test_tma_strides_refuse_what_tma_cannot_load():
    """The bf16 wrapper's TMA preconditions, raised before any launch:
    a 16-byte-aligned address and strides of multiples of 16 bytes; a
    dim of length 1 takes a valid stride whatever it had."""
    base = torch.zeros(2 * 64 * 8 * 80 + 8, dtype=torch.bfloat16)
    q = base[:2 * 64 * 8 * 80].view(2, 64, 8, 80)
    assert _tma_strides("q", q) == [64 * 8 * 80, 8 * 80, 80]
    assert _tma_strides("q", q[:, :, :4]) == [64 * 8 * 80, 8 * 80, 80]
    one = q[:1, :, :1]
    assert _tma_strides("q", one) == [80, 8 * 80, 80]
    with pytest.raises(ValueError, match="16-byte"):
        _tma_strides("q", base[1:1 + 2 * 64 * 8 * 80].view(2, 64, 8, 80))
    odd = torch.zeros(2, 64, 8, 84, dtype=torch.bfloat16)[..., :80]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        _tma_strides("k", odd)


class _StubLibrary:
    """Records each launcher call in place of the built library."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)

        def launcher(*args):
            self.calls.append((name, args))
            return 0
        return launcher


@pytest.mark.parametrize("rows", [False, True], ids=["one_scale", "per_row"])
def test_sgd_update_launch_passes_one_scale_or_the_row_vector(monkeypatch,
                                                              rows):
    """The host path of ``sgd_update_many`` (``build.use_kernel`` forced on,
    a stub library): one launch a call with the leaves' element counts; a
    host float goes as ``s`` with a null row vector and 0 rows, a ``[D]``
    vector by its pointer with D rows and ``s`` 0."""
    from repro_torch.kernels.sgd_update import sgd_update_many
    lib = _StubLibrary()
    monkeypatch.setattr(build, "use_kernel", lambda mode, w: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda: 0)
    ws = [torch.zeros(4, 3, 3), torch.zeros(4, 10), torch.zeros(4, 0)]
    scale = torch.arange(4, dtype=torch.float32) if rows else 0.25
    outs = sgd_update_many(ws, [torch.ones_like(w) for w in ws], scale)
    assert [c[0] for c in lib.calls] == ["sgd_update_launch"]
    wp, gp, numel, n, flat, s, sp, nrows, stream = lib.calls[0][1]
    assert n == 3 and [numel[i] for i in range(n)] == [36, 40, 0]
    if rows:
        assert (s, sp, nrows) == (0.0, scale.data_ptr(), 4)
    else:
        assert (s, sp, nrows) == (0.25, None, 0)
    assert [o.shape for o in outs] == [w.shape for w in ws]
    assert outs[0].untyped_storage().data_ptr() == flat


def _c_arg_names(symbol: str) -> list:
    """The argument names of an ``extern "C"`` launcher, in order."""
    for src in sorted(build.CSRC.glob("*.cu")):
        m = re.search(rf'extern "C" int {symbol}\((.*?)\)\s*\{{',
                      src.read_text(), re.S)
        if m:
            return [a.split()[-1].lstrip("*")
                    for a in " ".join(m.group(1).split()).split(",")]
    raise AssertionError(symbol)


FLASH_SCALED = ("flash_attention_launch", "flash_attention_bwd_dkdv_launch",
                "flash_attention_bwd_dq_launch")


@pytest.mark.parametrize("dh,built", [(80, 80), (40, 64), (200, 256)])
def test_flash_launchers_take_the_scale_of_the_true_head_dim(monkeypatch, dh,
                                                            built):
    """The forward's and the backward's launchers take the logits' scale
    as their one float argument (``scale`` in the C declaration, ``c_float``
    in ``build.SIGNATURES``), and the wrappers (``build.use_kernel`` forced
    on, a stub library, the device check passed over) pass ``1/sqrt(Dh)``
    of the caller's head dim beside the built head dim they run on."""
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    where = {}
    for name in FLASH_SCALED:
        names = _c_arg_names(name)
        where[name] = names.index("scale")
        assert [i for i, t in enumerate(build.SIGNATURES[name])
                if t is build._F] == [where[name]]
        assert names[where[name] - 1] == "q_offset"
    lib = _StubLibrary()
    monkeypatch.setattr(build, "use_kernel", lambda mode, t: True)
    monkeypatch.setattr(build, "library", lambda: lib)
    monkeypatch.setattr(build, "stream", lambda: 0)
    monkeypatch.setattr(fa, "_check_kernel_args", lambda *a: None)
    q = torch.zeros((1, 4, 2, dh), dtype=torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, q, q, lse=True)
    fa.flash_attention_bwd(q, q, q, o, lse, q)
    calls = {name: args for name, args in lib.calls}
    assert sorted(calls) == sorted(FLASH_SCALED
                                   + ("flash_attention_bwd_delta_launch",))
    for name in FLASH_SCALED:
        args = calls[name]
        assert args[where[name]] == 1.0 / math.sqrt(dh)
        assert args[_c_arg_names(name).index("D")] == built
