"""The run's refusals: modules of JAX or the JAX package in the process, no
card, a directory holding the benchmark alone; and a reference that loads
neither the port nor JAX."""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

from h100_bench.manifest import HERE
from h100_bench.run import forbidden_modules

ROOT = HERE.parent


def test_top_level_names_are_compared_whole():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "fetalsyngen_tpu.ops.warp",
              "fetalsyngen_torch", "fetalsyngen_torch.ops.warp", "jaxtyping", "fetalsyngen_tpu_extra", "h100_bench"]
    assert forbidden_modules(loaded) == ["fetalsyngen_tpu.ops.warp", "flax.linen", "jax", "jax.numpy",
                                         "jaxlib.xla_client"]
    assert forbidden_modules(["fetalsyngen_torch.parallel.input_pipeline", "torch"]) == []


def _python(code: str, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_the_reference_loads_neither_the_port_nor_jax():
    out = _python("import sys, h100_bench.reference.stream, h100_bench.check, h100_bench.control; "
                  "print(sorted({m.split('.')[0] for m in sys.modules} & "
                  "{'jax', 'jaxlib', 'flax', 'fetalsyngen_tpu', 'fetalsyngen_torch'}))")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _run(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", "core.stream.b16", "--seed",
                           str(2**31 + 5), "--seconds", "1", "--trace", "0"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_a_card():
    out = _run(ROOT)
    if out.returncode == 0:  # a machine with a card runs the cell
        return
    assert out.stdout == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
