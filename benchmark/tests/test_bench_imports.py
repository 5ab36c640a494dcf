"""Nothing of the benchmark loads JAX or the JAX package, and the reference
imports nothing of the program."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark.tests._drive import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "nf_tpu"}


def _modules():
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True)):
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if ".tests." not in rel and not rel.endswith("__init__"):
            out.append(rel)
    return out


def test_no_jax_after_importing_every_module():
    """In a fresh process, import every harness module, every driver and
    every metric reader, and the program they drive; then compare the
    top-level names of ``sys.modules`` whole."""
    code = "\n".join([
        "import sys, importlib, importlib.util, glob, os",
        f"sys.path.insert(0, {ROOT!r})",
        "import nf_tpu_torch, nf_tpu_torch.training.unweight, nf_tpu_torch.phasespace",
        *[f"importlib.import_module({m!r})" for m in _modules() if ".metrics." not in m],
        f"for p in glob.glob(os.path.join({ROOT!r}, 'benchmark', 'metrics', '*.py')):",
        "    s = importlib.util.spec_from_file_location('m' + str(abs(hash(p))), p)",
        "    s.loader.exec_module(importlib.util.module_from_spec(s))",
        "print(sorted({m.split('.')[0] for m in sys.modules}))",
    ])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "nf_tpu_torch" in loaded and "benchmark" in loaded
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def _imports(path, whole=False):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name if whole else a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module if whole else node.module.split(".")[0]


def test_sources_import_no_jax_and_reference_no_program():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"), recursive=True):
        names = set(_imports(path))
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if os.sep + "reference" + os.sep in path:
            assert names <= {"__future__", "dataclasses", "math", "numpy", "torch", "benchmark"}, \
                (path, names)
            inside = {n for n in _imports(path, whole=True) if n.startswith("benchmark")}
            assert all(n.startswith("benchmark.reference") for n in inside), (path, inside)
