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
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"ops/cuda_dg_cell.py", "ops/spmv.py", "solver/amg.py",
            "io/checkpoint.py"} <= names
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


def test_kernel_library_lists_every_cuda_source():
    """Every .cu under the port's csrc/ is compiled into the library, and
    every exported function has its ctypes signature."""
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    on_disk = sorted(p.name for p in kernel_lib.CSRC.glob("*.cu"))
    assert sorted(kernel_lib.SOURCES) == on_disk
    assert "dg_cell_residual.cu" in on_disk
    exported = set()
    for name in on_disk:
        text = (kernel_lib.CSRC / name).read_text()
        exported |= {line.split("(")[0].split()[-1]
                     for line in text.splitlines()
                     if line.startswith('extern "C"')}
    assert exported == set(kernel_lib._SIGNATURES)


def test_entry_points_default_to_cuda(monkeypatch):
    from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_3d
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    from fem_glass_tempering_tpu_torch.convert import state_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ThermoViscoProblem(mesh=box_mesh_3d(2, 2, 1))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        state_from_numpy({"T": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ThermoViscoProblem()          # the default workload
    from fem_glass_tempering_tpu_torch.io.checkpoint import load_checkpoint
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_checkpoint("never-opened.npz")


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernel library refuses to build (it is never
    built at import)."""
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    monkeypatch.setattr(kernel_lib.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib._nvcc()
