"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package ``repro``, and
``chip_smoke.py`` refuses to report a result where it cannot run."""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.append(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_exist():
    assert (PORT / "__init__.py") in FILES and len(FILES) > 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_rule():
    assert _forbidden("jax.numpy") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def _run(code: str, cwd=None) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    return subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=cwd,
        capture_output=True, text=True, timeout=300,
    )


def test_port_imports_with_jax_and_reference_poisoned():
    proc = _run("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch, repro_torch.core, repro_torch.kernels.ops
        import repro_torch.data.synthetic, repro_torch.interop
        import repro_torch.launch.eigen, repro_torch.launch.mesh
        import repro_torch.comm, repro_torch.comm.transport
        print("ok")
    """)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_alone_fails_without_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    (and on a machine without a card) it exits non-zero, no result."""
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
