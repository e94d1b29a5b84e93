"""The port imports torch and numpy, never jax, jaxlib, optax or the JAX
package (vit_fpga_tpu), and it never drops to the CPU quietly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "vit_fpga_tpu"}


def _port_files():
    files = sorted((ROOT / "vit_fpga_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    """First dotted component of every absolute import in the file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax():
    files = _port_files()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & FORBIDDEN)
           for f in files}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, bad
    # the prefix trap: the port's own name starts with "vit_fpga_tpu"
    assert "vit_fpga_tpu_torch" not in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = ("import sys, vit_fpga_tpu_torch.models.vit, "
            "vit_fpga_tpu_torch.runtime.serving, "
            "vit_fpga_tpu_torch.train.trainer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'vit_fpga_tpu')); print(bad)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_resolve_device_raises_without_cuda():
    from vit_fpga_tpu_torch.utils.platform import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
