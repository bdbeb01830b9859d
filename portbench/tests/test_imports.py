"""Nothing that the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Each module's imports are read
from its source (ast), top-level names compared whole: the port's name
begins with the JAX package's."""

import ast
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "omnivggt_tpu"}


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(folder):
    return [p for p in folder.rglob("*.py") if "tests" not in p.relative_to(ROOT).parts]


def test_nothing_under_portbench_imports_jax_or_the_jax_package():
    found = {str(p): sorted(set(_imports(p)) & FORBIDDEN) for p in _sources(ROOT)}
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_program():
    for p in (ROOT / "reference").rglob("*.py"):
        names = set(_imports(p))
        assert "omnivggt_tpu_torch" not in names, p
        assert names <= {"__future__", "contextlib", "math", "typing", "torch", "portbench"}, \
            (p, names)


def test_top_level_names_are_compared_whole():
    assert "omnivggt_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "omnivggt_tpu.models".split(".")[0] in FORBIDDEN


def test_a_run_process_loads_no_jax(tmp_path):
    """A rehearsal in a fresh process: afterwards sys.modules holds none of
    the forbidden top-level names."""
    import subprocess
    import sys

    code = ("import sys; from portbench.rehearse import rehearse; "
            "rehearse('scene-s32', seconds=0.5); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT.parent, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
