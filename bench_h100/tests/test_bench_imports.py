"""Nothing the benchmark runs imports the JAX stack or the JAX package
(top-level module names compared whole: ``toucan_tpu_torch`` begins with
``toucan_tpu``), and the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
JAX_STACK = {"jax", "jaxlib", "flax", "optax", "orbax", "toucan_tpu"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_file_imports_the_jax_stack():
    for path in BENCH.rglob("*.py"):
        assert not imported_roots(path) & JAX_STACK, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        roots = imported_roots(path)
        assert "toucan_tpu_torch" not in roots, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module.startswith("bench_h100"):
                assert node.module.startswith("bench_h100.reference"), (path, node.module)


def test_a_loaded_harness_holds_no_jax_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import bench_h100.harness.run, bench_h100.harness.control\n"
            "from bench_h100.harness import spec\n"
            "import toucan_tpu_torch.infer.interface, importlib, pathlib\n"
            "[importlib.import_module(f'bench_h100.{p.parent.name}.{p.stem}') "
            "for d in ('families', 'clients') for p in pathlib.Path('bench_h100', d).glob('*.py')]\n"
            "[spec.reader(m['name']) for k in ('end_to_end', 'per_layer') "
            "for m in spec.benchmark()[k]]\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in %r))"
            % (str(BENCH.parent), JAX_STACK))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
