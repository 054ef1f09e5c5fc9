"""What a run loads: nothing whose top-level name is jax, jaxlib, flax or
phaser_tpu (compared as whole names: phaser_tpu_torch is the port), and a
reference that loads nothing of the port either."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "phaser_tpu"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"
    )], cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=BENCH + os.pathsep + ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, BENCH)
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "bench_run_names", os.path.join(BENCH, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = dict(sys.modules)
    try:
        sys.modules.setdefault("phaser_tpu_torch_fake", object())
        assert "phaser_tpu" not in mod.forbidden_modules()
        sys.modules["phaser_tpu.engine"] = object()
        assert mod.forbidden_modules() == ["phaser_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """run.py and everything a pass of the port and the reference load."""
    names = _loaded(
        "import runpy, sys\n"
        "sys.argv = ['run.py', '--help']\n"
        "import importlib.util\n"
        "s = importlib.util.spec_from_file_location('r', 'benchmark/run.py')\n"
        "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)\n"
        "import harness.cell, harness.stages, harness.window, harness.trace\n"
        "import harness.roofline, gen.make, reference.pipeline\n"
        "import reference.compare\n"
        "import phaser_tpu_torch.cli.phaser_main, phaser_tpu_torch.utils.build\n"
        "import phaser_tpu_torch.engine.pipeline, phaser_tpu_torch.mapper.dispatch\n"
        "import phaser_tpu_torch.kernels.alleles, phaser_tpu_torch.io.bam_index\n")
    assert "phaser_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("import reference.pipeline, reference.compare, "
                    "reference.assign, gen.make")
    assert not names & (FORBIDDEN | {"phaser_tpu_torch", "torch"})


def test_the_reference_sources_import_nothing_of_the_program():
    for dirpath, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN | {
                        "phaser_tpu_torch"}, (f, m)
