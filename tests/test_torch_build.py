"""The port's compiled libraries are declared once, in ``ops/_build.py``'s
:class:`Library` tables, and nothing on the CPU runs their C code. So the
tables are held here to the C sources they bind: each table names every
function of its source's ``extern "C"`` block, with the same count and
kinds of parameters and the same return kind (a table that drifted would
pass garbage on the card). A fake library, substituted for the built one,
shows how :meth:`Library.call` picks the dtype's entry, appends the stream
and raises on a non-zero code."""

import ctypes
import importlib
import re
import types

import pytest
import torch

from blackstar_tpu_torch.ops import _build
from blackstar_tpu_torch.ops._build import D, I, L, P

# The modules that own a compiled library (``LIBRARY``).
MODULES = ("blackstar_tpu_torch.ops.march_cuda", "blackstar_tpu_torch.ops.march_adjoint_cuda",
           "blackstar_tpu_torch.stars.lookup_cuda", "blackstar_tpu_torch.stars.window_cuda",
           "blackstar_tpu_torch.ops.bloom_cuda",
           "blackstar_tpu_torch.scripts.probe_dynamic_gather", "blackstar_tpu_torch.native")

_DEFINE = re.compile(r"^[ \t]*#[ \t]*define[ \t]+(\w+)[ \t]+(.*)$", re.MULTILINE)
# A function defined at the top level of the extern "C" block: return type,
# name and parameter list (macros not yet expanded).
_PROTOTYPE = re.compile(r"^(\w[^\n#(){};=]*?)\b(bs_\w+)\s*\(([^)]*)\)", re.MULTILINE)


def _prototypes(source):
    """``{name: (return kind, [parameter kinds])}`` of the ``extern "C"``
    functions of ``source``, its object-like macros (from it and the local
    headers it includes) expanded in the parameter lists."""
    texts = []
    for path in _build._sources(source):
        with open(path) as f:
            text = f.read().replace("\\\n", " ")
        texts.append(re.sub(r"/\*.*?\*/|//[^\n]*", "", text, flags=re.DOTALL))
    macros = dict(m.groups() for t in texts for m in _DEFINE.finditer(t))
    block = texts[0][texts[0].index('extern "C"'):]
    out = {}
    for ret, name, params in _PROTOTYPE.findall(block):
        while True:
            expanded = re.sub(r"\w+", lambda m: macros.get(m.group(0), m.group(0)), params)
            if expanded == params:
                break
            params = expanded
        kinds = [_param_kind(p) for p in params.split(",") if p.strip() not in ("", "void")]
        out[name] = ("pointer" if "*" in ret else ret.strip(), kinds)
    return out


def _param_kind(decl):
    """``pointer``, or the type of a parameter declared as ``[const] type name``."""
    if "*" in decl:
        return "pointer"
    return " ".join(w for w in decl.split()[:-1] if w != "const")


def _ctypes_kind(t):
    if t is None:
        return "void"
    if t in (ctypes.c_void_p, ctypes.c_char_p) or issubclass(t, ctypes._Pointer):
        return "pointer"
    return {ctypes.c_int: "int", ctypes.c_int64: "int64_t", ctypes.c_double: "double"}[t]


@pytest.mark.parametrize("module", MODULES, ids=[m.rsplit(".", 1)[1] for m in MODULES])
def test_every_table_entry_matches_its_c_prototype(module):
    lib = importlib.import_module(module).LIBRARY
    protos = _prototypes(lib.source)
    names = [c for name, entry in lib.entries.items() for c in entry.names(name)]
    assert sorted(names) == sorted(protos), "the table and the extern \"C\" block differ"
    for name, entry in lib.entries.items():
        for cname in entry.names(name):
            assert cname in protos, f"{cname} is not an extern \"C\" function of {lib.source}"
            ret, params = protos[cname]
            assert [_ctypes_kind(t) for t in entry.args] == params, cname
            assert _ctypes_kind(entry.returns) == ret, cname
            if entry.stream:
                assert params[-1] == "pointer", f"{cname} takes no stream last"


class _FakeFn:
    """A C function of a fake library: records its calls, returns ``rc``."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """A Library over a source that is never built: a fake CDLL stands in
    its path's place in the loaded libraries, and the stream handle of a
    device is its name."""
    src = tmp_path / "k.cu"
    src.write_text("// never built\n")
    lib = _build.Library(str(src), ("-fmad=false",), {
        "bs_k": _build.Entry((P, L, D, P), dtyped=True),
        "bs_query": _build.Entry((I,), stream=False),
        "bs_new": _build.Entry((I, P), optional=True),
    })
    cdll = types.SimpleNamespace(bs_k_f32=_FakeFn(), bs_k_f64=_FakeFn(), bs_query=_FakeFn(7))
    monkeypatch.setitem(_build._loaded, lib.path, cdll)
    monkeypatch.setattr(_build, "stream_handle", lambda device: f"stream of {device}")
    return lib, cdll


def test_call_picks_the_dtypes_entry_and_appends_the_stream(fake):
    lib, cdll = fake
    lib.call("bs_k", 11, 3, 0.5, dtype=torch.float64, device="cuda:1")
    assert cdll.bs_k_f64.calls == [(11, 3, 0.5, "stream of cuda:1")]
    assert cdll.bs_k_f32.calls == []
    lib.call("bs_k", 12, 4, 0.25, dtype=torch.float32, device="cuda:0")
    assert cdll.bs_k_f32.calls == [(12, 4, 0.25, "stream of cuda:0")]
    # Bound from the table at load: every entry the fake has.
    assert cdll.bs_k_f32.argtypes == (P, L, D, P) and cdll.bs_k_f32.restype is I
    assert cdll.bs_query.argtypes == (I,)
    # An entry without a stream is called as it is; an optional entry this
    # build lacks is None.
    assert lib.entry("bs_query")(5) == 7 and cdll.bs_query.calls == [(5,)]
    assert lib.entry("bs_new") is None


def test_call_raises_on_a_nonzero_code(fake):
    lib, cdll = fake
    cdll.bs_k_f32.rc = 700
    with pytest.raises(RuntimeError, match="bs_k_f32: CUDA error 700 at launch"):
        lib.call("bs_k", 1, 2, 0.0, dtype=torch.float32, device="cuda:0")
    assert len(cdll.bs_k_f32.calls) == 1


def test_a_missing_entry_fails_the_load(fake):
    lib, cdll = fake
    del cdll.bs_query
    with pytest.raises(AttributeError, match="bs_query"):
        lib.load()
