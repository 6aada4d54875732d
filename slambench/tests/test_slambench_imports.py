"""Nothing the benchmark runs loads JAX or the JAX package: the top-level
name of each module is compared whole, so the port (`xchu_slam_tpu_torch`)
passes where `xchu_slam_tpu` would not."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

from slambench import harness

SB = harness.SB


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_imports_jax_or_the_jax_package():
    for path in SB.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imported_tops(path) & set(harness.FORBIDDEN), path


def test_the_reference_and_the_generator_import_nothing_of_the_program():
    for sub in ("reference", "gen"):
        for path in (SB / sub).rglob("*.py"):
            tops = _imported_tops(path)
            assert "xchu_slam_tpu_torch" not in tops and "bench" not in tops, path


def test_names_are_compared_whole():
    code = ("import sys; sys.path.insert(0, %r); "
            "import slambench.harness as h, slambench.reference.check, slambench.metrics, "
            "slambench.tracing, slambench.gen.drive, xchu_slam_tpu_torch.models.device_pipeline, "
            "xchu_slam_tpu_torch.io.prefetch; print(h.forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, check=True)
    assert out.stdout.strip() == "[]"
    sys.modules.setdefault("xchu_slam_tpu_torch_probe", object())
    assert "xchu_slam_tpu" not in {m.split(".")[0] for m in ["xchu_slam_tpu_torch.ops"]}
