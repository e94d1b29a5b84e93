"""The port imports torch and numpy, never jax, jaxlib, optax, orbax,
transformers or the JAX package (vit_fpga_tpu), and it never drops to the
CPU quietly."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "optax", "orbax", "transformers",
             "vit_fpga_tpu"}
INT8_MODULES = ("vit_fpga_tpu_torch.models.quantized",
                "vit_fpga_tpu_torch.ops.quant_fused",
                "vit_fpga_tpu_torch.ops.quant_block")
LATENCY_MODULES = ("vit_fpga_tpu_torch.ops.vit_stack",)
STATIC_MODULES = ("vit_fpga_tpu_torch.utils.calibrate",)
# the dense NetAbstract backend, its runtime and its copies of the JAX
# package's numpy-only modules
DENSE_MODULES = ("vit_fpga_tpu_torch.defines",
                 "vit_fpga_tpu_torch.abstract",
                 "vit_fpga_tpu_torch.activations",
                 "vit_fpga_tpu_torch.runtime.perf",
                 "vit_fpga_tpu_torch.runtime.engine",
                 "vit_fpga_tpu_torch.runtime.pipeline",
                 "vit_fpga_tpu_torch.ops.image_filter",
                 "vit_fpga_tpu_torch.ops.quant",
                 "vit_fpga_tpu_torch.backends.cpu",
                 "vit_fpga_tpu_torch.backends.cuda",
                 "vit_fpga_tpu_torch.native_bridge",
                 "vit_fpga_tpu_torch.utils.options",
                 "vit_fpga_tpu_torch.cli")
# the large ViTs: CLIP (vision and text towers) and DeiT
FAMILY_MODULES = ("vit_fpga_tpu_torch.models.clip",
                  "vit_fpga_tpu_torch.models.deit")
# the per-block encoder's sequence attention (K7, K8, K9)
PER_BLOCK_MODULES = ("vit_fpga_tpu_torch.ops.attention",
                     "vit_fpga_tpu_torch.ops.flash_attention")
# the ops no model path calls: K10 (uint8 patch embed) and K26 (streamed GEMM)
OP_MODULES = ("vit_fpga_tpu_torch.ops.patch_embed",
              "vit_fpga_tpu_torch.ops.streamed_gemm")
# the model lifecycle: checkpoints and HF import, the data pipeline, the
# dense model family and the training example
LIFECYCLE_MODULES = ("vit_fpga_tpu_torch.utils.checkpoint",
                     "vit_fpga_tpu_torch.runtime.data",
                     "vit_fpga_tpu_torch.models.mlp",
                     "vit_fpga_tpu_torch.examples.train_vit")
ALL_MODULES = (LIFECYCLE_MODULES + INT8_MODULES + LATENCY_MODULES + STATIC_MODULES + DENSE_MODULES
               + FAMILY_MODULES + PER_BLOCK_MODULES + OP_MODULES)


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
    scanned = {str(f.relative_to(ROOT)) for f in files}
    for mod in ALL_MODULES:
        assert mod.replace(".", "/") + ".py" in scanned, mod
    assert "chip_smoke.py" in scanned
    # the prefix trap: the port's own name starts with "vit_fpga_tpu"
    assert "vit_fpga_tpu_torch" not in FORBIDDEN


def test_importing_the_port_loads_no_jax():
    code = ("import sys, vit_fpga_tpu_torch.models.vit, "
            "vit_fpga_tpu_torch.runtime.serving, "
            "vit_fpga_tpu_torch.train.trainer, "
            "vit_fpga_tpu_torch.profile_forward, "
            + ", ".join(ALL_MODULES)
            + "; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'orbax', 'transformers', "
            "'vit_fpga_tpu')); print(bad)")
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
