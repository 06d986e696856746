"""What the benchmark may import: nothing of JAX, flax or the JAX package,
compared by whole top-level names (the port's name only begins with the JAX
package's); the reference, the traffic and the yardstick nothing of the
port either."""

import ast
import pathlib
import subprocess
import sys

import pytest

from benchmark.harness.cell import BENCH_DIR, FORBIDDEN_MODULES, ROOT

PORT = "multi_speaker_tts_tpu_torch"
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: pathlib.Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not imported_tops(path) & set(FORBIDDEN_MODULES)
    if path.relative_to(BENCH_DIR).parts[0] in ("reference", "traffic", "rooflines", "metrics"):
        assert PORT not in imported_tops(path)


def test_forbidden_is_whole_name():
    from benchmark.harness import cell

    saved = dict(sys.modules)
    try:
        sys.modules["multi_speaker_tts_tpu_torch_x"] = sys
        assert "multi_speaker_tts_tpu" not in cell.forbidden_loaded()
        sys.modules["multi_speaker_tts_tpu.ops"] = sys
        assert "multi_speaker_tts_tpu" in cell.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """A whole run of the embedding cell at a small size, in a fresh process,
    leaves no module of JAX, flax or the JAX package loaded."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark.tests import small; "
            "out = small.run('ge2e_embed.b64'); "
            "from benchmark.harness.cell import forbidden_loaded; "
            "print(out['result']['correct'], forbidden_loaded())" % str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "True []"
