"""The ctypes signatures of the port's CUDA launchers against their C
declarations, and the host-side arithmetic of the bfloat16 flash kernel.

``build.SIGNATURES`` sets each launcher's ``argtypes``; ctypes converts
every argument by it without looking at the C function, so a pointer
declared ``c_int`` there is cut to 32 bits in silence.  The first test
parses every ``extern "C" int *_launch(`` in ``kernels/csrc/*.cu`` and
holds its arity, and pointer or integer per argument, against the table.
No compiler or card is needed.
"""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.flash_attention import _tma_strides  # noqa: E402

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
