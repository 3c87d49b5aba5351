"""The port stands alone: no JAX and nothing of the reference package.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax`` or ``repro``, and importing the training,
serving, soak and dry-run CLIs, the steps and ``optim`` in a fresh
interpreter leaves ``jax`` and ``repro``
out of ``sys.modules``.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _import_leaves_jax_out(modules: str) -> None:
    pytest.importorskip("torch")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = (f"import sys, {modules}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_train_cli_import_leaves_jax_out():
    _import_leaves_jax_out("repro_torch.launch.train, repro_torch.core.runner")


def test_serve_cli_import_leaves_jax_out():
    _import_leaves_jax_out("repro_torch.launch.serve, "
                           "repro_torch.models.transformer, "
                           "repro_torch.models.mamba2, repro_torch.models.moe, "
                           "repro_torch.models.vlm, repro_torch.models.hybrid, "
                           "repro_torch.models.encdec")


def test_soak_cli_import_leaves_jax_out():
    _import_leaves_jax_out("repro_torch.launch.soak, repro_torch.serve, "
                           "repro_torch.compression.wire")


def test_steps_dryrun_optim_import_leaves_jax_out():
    _import_leaves_jax_out("repro_torch.launch.dryrun, "
                           "repro_torch.launch.steps, repro_torch.optim")


def test_distributed_import_leaves_jax_out():
    _import_leaves_jax_out("repro_torch.core.distributed, "
                           "repro_torch.launch.mesh")
