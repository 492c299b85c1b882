"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (``repro_torch`` is not ``repro``)."""
import ast
import subprocess
import sys

from _util import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def test_sources_import_no_forbidden_module():
    found = []
    for path in (ROOT / "cambench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            found += [(str(path), n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert not found


def test_loaded_modules_after_a_run():
    code = (
        "import sys, runpy\n"
        "sys.argv = ['cambench.run', '--workload', 'pgm.tune-policy-10k',"
        " '--seed', '3', '--seconds', '1', '--rehearse']\n"
        "try:\n"
        "    runpy.run_module('cambench.run', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "import cambench.control, cambench.reference.tune\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "print('TOPS', sorted(tops & %r))\n" % (FORBIDDEN,))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "TOPS []"


def test_harness_refuses_a_loaded_jax_package(tmp_path):
    """A run whose process holds a forbidden module prints no result."""
    code = (
        "import sys, types, runpy\n"
        "sys.modules['repro'] = types.ModuleType('repro')\n"
        "sys.argv = ['cambench.run', '--workload', 'pgm.tune-policy-10k',"
        " '--seed', '3', '--seconds', '1', '--rehearse']\n"
        "runpy.run_module('cambench.run', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
    assert "repro" in proc.stderr
