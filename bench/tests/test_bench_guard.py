"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""
import ast

from bench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def sources():
    """The benchmark's own files, not what its runs leave behind."""
    return [f for f in spec.BENCH.rglob("*.py")
            if not {"out", ".cache"} & set(f.relative_to(spec.BENCH).parts)]


def test_no_module_imports_jax_or_the_jax_package():
    for f in sources():
        tops = {m.split(".")[0] for m in imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for f in [*(spec.BENCH / "reference").rglob("*.py"),
              spec.BENCH / "yardstick.py", spec.BENCH / "inputs.py"]:
        tops = {m.split(".")[0] for m in imports(f)}
        assert "repro_torch" not in tops, f
        assert "bench.program" not in imports(f), f


def test_the_run_guard_compares_whole_top_level_names():
    found = harness.forbidden_modules(
        ["repro_torch", "repro_torch.engine.scan", "reprox", "jaxtyping",
         "repro.core.query", "jaxlib.xla_client", "flax", "numpy"])
    assert found == ["flax", "jaxlib.xla_client", "repro.core.query"]
