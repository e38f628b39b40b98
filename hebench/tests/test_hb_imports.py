"""What the benchmark may import: nothing under ``hebench/`` imports
``jax`` or the JAX package, and nothing under ``hebench/ref`` or
``hebench/gen`` imports the program either.  Top-level module names
are compared whole (``heaac_tpu_torch`` is not ``heaac_tpu``)."""
import ast
import os
import subprocess
import sys

import pytest

from hebench.tests.conftest import ROOT

HB = os.path.join(ROOT, "hebench")
NO_JAX = {"jax", "jaxlib", "flax", "heaac_tpu"}
NO_PROGRAM = NO_JAX | {"heaac_tpu_torch", "torch"}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub: str = "") -> list:
    out = []
    for d, _, files in os.walk(os.path.join(HB, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("sub,banned", [("", NO_JAX), ("ref", NO_PROGRAM),
                                        ("gen", NO_PROGRAM)])
def test_no_banned_import(sub, banned):
    bad = {p: top_level_imports(p) & banned for p in sources(sub)}
    assert not {p: b for p, b in bad.items() if b}


def test_ref_and_gen_load_alone():
    """Importing every module of ref and gen loads neither the program,
    PyTorch nor JAX."""
    mods = []
    for p in sources("ref") + sources("gen"):
        rel = os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                    else rel)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    loaded = set(eval(out))
    assert not loaded & NO_PROGRAM
