"""What the harness loads: no JAX, jaxlib or JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and a
reference that loads nothing of the port."""

import json
import os
import subprocess
import sys

import pytest

from sam_bench import spec

# JAX, flax, the JAX package, and the scripts bench.py and chip_smoke.py
JAX = {"jax", "jaxlib", "flax", "gtsam_petercdev_tpu", "bench", "chip_smoke"}


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=240,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("code", [
    "import sam_bench.run, sam_bench.harness, sam_bench.control",
    "import sam_bench.reference, sam_bench.reference.ba, sam_bench.reference.lm",
])
def test_no_jax(code):
    assert not (_loaded(code) & JAX)


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded("import sam_bench.reference.ba, sam_bench.reference.lm, "
                     "sam_bench.generators.ba_ring")
    assert "gtsam_petercdev_torch" not in loaded and not (loaded & JAX)


def test_a_whole_cpu_run_loads_no_jax():
    code = ("import torch\nfrom sam_bench.tests.small import small_cell\n"
            "from sam_bench import harness, run\n"
            "out = harness.run(small_cell('ladybug-1723.lm_schur'), 5, 0.2, False, 'cpu')\n"
            "assert out['correct'] and not run.forbidden_modules()")
    assert not (_loaded(code) & JAX)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from sam_bench import run

    monkeypatch.setitem(sys.modules, "gtsam_petercdev_tpux", sys)
    assert "gtsam_petercdev_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()


def test_no_chip_no_result():
    out = subprocess.run([sys.executable, "-m", "sam_bench.run", "--workload",
                          "ladybug-1723.lm_schur", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=240,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory with BENCHMARK.json and sam_bench/ but not the port."""
    import shutil

    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.PKG, tmp_path / "sam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "sam_bench.run", "--workload",
                          "ladybug-1723.lm_schur", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0 and out.stdout.strip() == ""
