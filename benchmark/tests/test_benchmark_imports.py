"""Nothing the benchmark runs loads JAX or the JAX package (top-level module
names compared whole), and the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from benchmark.harness import imports, spec  # noqa: E402


def test_names_are_compared_whole():
    assert imports.forbidden(["mvc_tpu_torch", "mvc_tpu_torch.ops.beam", "jaxtyping"]) == []
    assert imports.forbidden(["mvc_tpu.ops", "numpy"]) == ["mvc_tpu"]
    assert imports.forbidden(["jax.numpy", "jaxlib.xla_client", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, timeout=600, cwd=spec.ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_a_small_run_of_every_cell_loads_no_jax():
    loaded = _loaded_after(
        "from benchmark.tests import small\n"
        "for name in small.workloads():\n"
        "    small.run_small(name)\n")
    assert "mvc_tpu_torch" in loaded
    assert not loaded & imports.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import benchmark.reference.recnet")
    assert not loaded & (imports.FORBIDDEN | {"mvc_tpu_torch"})
    ref = os.path.join(spec.ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names}
        names |= {n.module.split(".")[0] for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module}
        assert names <= {"__future__", "contextlib", "csv", "json", "os", "typing", "numpy",
                         "torch"}, (f, names)
