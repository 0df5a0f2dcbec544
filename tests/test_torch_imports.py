"""The port stands alone: no module of ``blackstar_tpu_torch`` and not
``chip_smoke.py`` pulls in JAX, the JAX package or its ``scripts/``; and
importing it builds no kernel and no native library."""

import ast
import glob
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCES = sorted(glob.glob(os.path.join(_ROOT, "blackstar_tpu_torch", "**", "*.py"),
                            recursive=True)) + [os.path.join(_ROOT, "chip_smoke.py")]


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import blackstar_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "from blackstar_tpu_torch.ops import _build\n"
        "assert not _build._loaded, 'a kernel library was loaded at import'\n"
        "from blackstar_tpu_torch import native\n"
        "assert native._lib is None and not native._tried, 'the native library was loaded'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'blackstar_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("path", _SOURCES, ids=[os.path.relpath(p, _ROOT) for p in _SOURCES])
def test_source_imports_no_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib", "blackstar_tpu", "scripts"), (
                path, name)


def test_kernel_library_name_tracks_source_and_flags(tmp_path):
    from blackstar_tpu_torch.ops import _build

    src = tmp_path / "k.cu"
    src.write_text("// v1\n")
    a = _build.library_path(str(src))
    assert a == _build.library_path(str(src))
    assert a.startswith(_build.BUILD_DIR) and os.path.basename(a).startswith("libk-")
    assert _build.library_path(str(src), ("-fmad=false",)) != a
    src.write_text("// v2\n")
    assert _build.library_path(str(src)) != a
    # A local header the source includes is part of the name; another is not.
    (tmp_path / "step.cuh").write_text("// h1\n")
    (tmp_path / "other.cuh").write_text("// o1\n")
    src.write_text('#include <cuda_runtime.h>\n#include "step.cuh"\n// v2\n')
    b = _build.library_path(str(src))
    (tmp_path / "step.cuh").write_text("// h2\n")
    c = _build.library_path(str(src))
    assert c != b
    (tmp_path / "other.cuh").write_text("// o2\n")
    assert _build.library_path(str(src)) == c
