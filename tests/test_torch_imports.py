"""The PyTorch port stands alone: no file of the port package, and neither
chip_smoke.py nor chip_ab.py, imports JAX or the JAX package or loads the
JAX package's native library (csrc/libfgtruntime.so); and its entry
points never quietly run on the CPU when the GPU they default to is
missing."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "fem_glass_tempering_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "fem_glass_tempering_tpu")


def _port_files():
    scripts = [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    files = sorted(PORT.rglob("*.py")) + scripts
    assert len(files) > 20 and all(f.exists() for f in files)
    names = {str(f.relative_to(PORT)) for f in files[:-len(scripts)]}
    assert {"ops/cuda_dg_cell.py", "ops/spmv.py", "solver/amg.py",
            "io/checkpoint.py", "main.py", "io/vtu.py", "io/xdmf.py",
            "fem/mshio.py", "models/analysis.py", "utils/logging.py",
            "utils/profiling.py", "ops/forms.py", "solver/direct.py",
            "utils/native.py", "parallel/comm.py", "parallel/partition.py",
            "parallel/sharding.py", "parallel/domain_cg.py",
            "parallel/domain.py", "parallel/grid_shard.py",
            "parallel/multihost.py", "io/sharded.py",
            "solver/grid_dg.py", "ops/grid2.py"} <= names
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


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_native_library(path):
    assert "libfgtruntime" not in path.read_text(), path.name


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
    # every source states its own flags; the kernels held to their plain
    # versions' roundings are built without multiply-add contraction
    assert sorted(kernel_lib.SOURCE_FLAGS) == on_disk
    for name in ("material_tspace.cu", "stencil_matvec.cu"):
        assert "-fmad=false" in kernel_lib.SOURCE_FLAGS[name]
    assert "-fmad=false" not in kernel_lib.NVCC_FLAGS


def test_native_runtime_is_the_ports_own_build():
    """The native runtime builds from the port's copy of its source into
    build/torch_native/ of this checkout, never from or into the JAX
    package's csrc/."""
    from fem_glass_tempering_tpu_torch.ops import kernel_lib
    from fem_glass_tempering_tpu_torch.utils import native

    assert kernel_lib.CSRC == PORT / "csrc"
    assert kernel_lib.HOST_SOURCES == ("runtime.cpp",)
    assert (PORT / "csrc" / "runtime.cpp").exists()
    assert kernel_lib.HOST_BUILD_DIR == ROOT / "build" / "torch_native"
    assert native.native_available(), native.native_error()
    path = kernel_lib.host_library().path
    assert path.parent == ROOT / "build" / "torch_native"
    assert (ROOT / "csrc") not in path.parents


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
    from fem_glass_tempering_tpu_torch.fem.functionspace import FunctionSpace
    from fem_glass_tempering_tpu_torch.ops.elasticity import (
        ElasticityOperator,
    )
    from fem_glass_tempering_tpu_torch.ops.grid_elasticity import (
        GridElasticityOperator,
    )
    fs = FunctionSpace(box_mesh_3d(2, 2, 1), "CG", 1, value_shape=(3, 3))
    for op in (ElasticityOperator, GridElasticityOperator):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            op(fs)
    from fem_glass_tempering_tpu_torch.parallel.comm import make_device_mesh
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_device_mesh()
    from fem_glass_tempering_tpu_torch.io.sharded import (
        PlaneLayout,
        load_sharded_checkpoint,
    )
    from fem_glass_tempering_tpu_torch.parallel import multihost
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_sharded_checkpoint("never-opened", PlaneLayout((4, 3, 2)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multihost.initialize("localhost:1", 2, 0)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the kernel library refuses to build (it is never
    built at import)."""
    from fem_glass_tempering_tpu_torch.ops import kernel_lib

    monkeypatch.setattr(kernel_lib.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernel_lib._nvcc()
