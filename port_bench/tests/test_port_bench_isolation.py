"""Nothing the benchmark runs loads JAX, flax or the JAX package, and the
reference loads nothing of the program.  Top-level module names are
compared whole: the program's name, ``dispu_tpu_torch``, begins with the
JAX package's."""

import ast
import pathlib
import subprocess
import sys

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "dispu_tpu"}


def _loaded_after(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    mods = ["port_bench.lib." + p.stem for p in (BENCH / "lib").glob("*.py")
            if p.stem != "__init__"]
    code = "\n".join(f"import {m}" for m in mods)
    code += ("\nfrom port_bench.lib.cell import (Cell, driver, manifest,\n"
             "    metric_reader, shape)\n"
             "[metric_reader(m['name']) for m in manifest()['per_layer']]\n"
             "cells = [Cell(w['name']) for w in manifest()['workloads']]\n"
             "[driver(c.traffic['driver']) for c in cells]\n"
             "[shape(c.traffic['shape']) for c in cells]\n"
             "import dispu_tpu_torch.inference, dispu_tpu_torch.train.steps\n"
             "import dispu_tpu_torch.train.gan_steps")
    loaded = _loaded_after(code)
    assert not loaded & JAX
    assert "dispu_tpu_torch" in loaded


def test_reference_loads_nothing_of_the_program():
    mods = ["port_bench.reference." + p.stem
            for p in (BENCH / "reference").glob("*.py")
            if p.stem != "__init__"]
    loaded = _loaded_after("\n".join(f"import {m}" for m in mods))
    assert not loaded & (JAX | {"dispu_tpu_torch"})


def test_reference_sources_import_only_plain_modules():
    allowed = {"torch", "numpy", "math", "contextlib", "contextvars",
               "collections", "__future__", "port_bench"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top in allowed, (path.name, n)
                if top == "port_bench":
                    assert n.startswith("port_bench.reference"), (path, n)
