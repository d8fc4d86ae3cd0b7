"""What the benchmark imports: nothing of JAX or the JAX package, compared
by whole top-level name (the port's name begins with the JAX package's),
and, in its reference, nothing of the port either."""

import ast
import subprocess
import sys

from vobench.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rampvo_tpu"}
HARNESS = ["vobench.run", "vobench.control", "vobench.check_vo",
           "vobench.check_train", "vobench.work", "vobench.scene",
           "vobench.trace", "vobench.weights", "vobench.loops.vo_eval",
           "vobench.loops.train_step"]


def _top_level_after(modules) -> set:
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    return set(out.split())


def _reference_modules():
    ref = ROOT / "vobench" / "reference"
    return ["vobench.reference." + ".".join(p.relative_to(ref).with_suffix(
        "").parts) for p in sorted(ref.rglob("*.py"))
        if p.name != "__init__.py"]


def test_harness_imports_no_jax():
    assert not _top_level_after(HARNESS) & FORBIDDEN


def test_reference_imports_neither_jax_nor_the_port():
    got = _top_level_after(_reference_modules())
    assert not got & (FORBIDDEN | {"rampvo_tpu_torch"})


def test_no_source_of_the_reference_names_the_port():
    for p in (ROOT / "vobench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"rampvo_tpu_torch"}, \
                    (p, n)


def test_no_harness_source_imports_jax():
    for p in (ROOT / "vobench").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] not in FORBIDDEN, (p, node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] not in FORBIDDEN, (p, a.name)
