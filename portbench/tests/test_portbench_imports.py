"""Nothing the benchmark runs loads JAX or the JAX package: the harness's
check of ``sys.modules`` compares whole top-level names, the reference
imports nothing of the program, and a whole run on the CPU ends with no
forbidden module loaded."""

import ast
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from portbench.run import forbidden_modules


def test_top_level_names_compared_whole():
    mods = ["ugaitnet_tpu_torch", "ugaitnet_tpu_torch.models.network",
            "jaxtyping", "flaxen", "numpy", "portbench.run"]
    assert forbidden_modules(mods) == []
    assert forbidden_modules(mods + ["jax.numpy", "flax", "jaxlib.xla",
                                     "ugaitnet_tpu.core"]) == [
        "flax", "jax.numpy", "jaxlib.xla", "ugaitnet_tpu.core"]


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_sources_import_no_jax(path):
    assert not forbidden_modules(imported_tops(path))


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert "ugaitnet_tpu_torch" not in set(imported_tops(path))


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from conftest import tiny_cell, tiny_config\n"
        "from portbench import run\n"
        "c = tiny_cell('gaitset.encode_bf16')\n"
        "res = run.execute(c, tiny_config(c['config']), 5, 0.5, False,"
        " device='cpu')\n"
        "print(json.dumps([res['correct'],"
        " run.forbidden_modules(sys.modules)]))\n"
        % (ROOT, os.path.join(BENCH, "tests")))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    correct, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []


def test_main_refuses_without_a_card():
    """No CUDA device: exit code 2 and no result line."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "gaitset.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout.strip() == ""
