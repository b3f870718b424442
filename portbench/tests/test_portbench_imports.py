"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level module name), and the reference imports nothing of the
program."""

import ast
import os
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "nanodecoder_tpu"}


def sources(sub=""):
    base = os.path.join(run.BENCH, sub)
    for dirpath, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not set(imported(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "nanodecoder_tpu_torch" not in set(imported(path)), path


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        "from portbench import run, control\n"
        "from portbench.tests.helpers import tiny_spec\n"
        "if __name__ == '__main__':\n"
        "    for w in ('mha.greedy', 'mqa.train'):\n"
        "        run.run_cell(tiny_spec(w), 5, 2.0, False, device='cpu')\n"
        "    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes\n"
        "    stop_ingest_processes()\n"
        "    print(','.join(run.forbidden_modules()) or 'none')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "none"
