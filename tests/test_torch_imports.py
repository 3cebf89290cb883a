"""The PyTorch port stands alone: no file of the port package, and not
chip_smoke.py, imports JAX or the JAX package; and its entry points never
quietly run on the CPU when the GPU they default to is missing."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fem_glass_tempering_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fem_glass_tempering_tpu")


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20 and all(f.exists() for f in files)
    return files


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_entry_points_default_to_cuda(monkeypatch):
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.convert import state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ThermoViscoProblem(mesh=box_mesh_3d(2, 2, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"T": np.zeros(2)})


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernel library refuses to build (it is never
    built at import)."""
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    monkeypatch.setattr(kernel_lib.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib._nvcc()
