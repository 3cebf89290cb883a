"""The PyTorch port's output writers against the JAX package's.

On equal arrays (the port's given as tensors, JAX's as numpy) the nodal
values (`_point_values`), the `.vtu` files, the `.pvd` index, the
`.xdmf` index and every `.h5` dataset equal JAX's byte for byte, on CG-1,
DG-1 and CG-2 spaces with scalar and tensor fields. The cases of
tests/test_io.py:17-82 are mirrored, `test_solve_writes_all_formats`
included: the decoded files equal the port's final state exactly and a
JAX run's at the slice's tolerances (T max-rel 1e-9, sigma 1e-6 of max).
Without h5py the XDMF module imports and its writer raises JAX's error.
"""

import base64
import os
import struct
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

import h5py
import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import functionspace as jfs
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.io import vtu as jvtu
from fem_glass_tempering_tpu.io import xdmf as jxdmf
from fem_glass_tempering_tpu.models.problem import ThermoViscoProblem as JP
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import functionspace as tfs
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.io import vtu as tvtu
from fem_glass_tempering_tpu_torch.io import xdmf as txdmf
from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem as TP

ROOT = Path(__file__).resolve().parents[1]
SPACES = [("CG", 1), ("DG", 1), ("CG", 2)]
SPACE_IDS = ["CG1", "DG1", "CG2"]
_VTK_DTYPES = {"Float64": np.float64, "Int64": np.int64, "UInt8": np.uint8}


def _spaces(family, degree, value_shape=()):
    """The same space over the same 3x2 quad plate in both packages."""
    jm, tm = jmesh.box_mesh_2d(3, 2), tmesh.box_mesh_2d(3, 2)
    return (jfs.FunctionSpace(jm, family, degree, value_shape=value_shape),
            tfs.FunctionSpace(tm, family, degree, value_shape=value_shape))


def _values(fs, shape=(), seed=0):
    return np.random.default_rng(seed).random((fs.n_scalar_dofs,) + shape)


def read_vtu(path) -> dict:
    """Decode every DataArray of a binary .vtu file: name -> array
    (the points under "Points")."""
    out = {}
    for d in ET.parse(path).getroot().iter("DataArray"):
        raw = base64.b64decode(d.text)
        n = struct.unpack("<I", raw[:4])[0]
        a = np.frombuffer(raw[4:4 + n], dtype=_VTK_DTYPES[d.get("type")])
        ncomp = int(d.get("NumberOfComponents", 1))
        out[d.get("Name", "Points")] = a.reshape(-1, ncomp) if ncomp > 1 else a
    return out


def _h5_datasets(path) -> dict:
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[...])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


@pytest.mark.parametrize("value_shape", [(), (2, 2)], ids=["scalar", "tensor"])
@pytest.mark.parametrize("space", SPACES, ids=SPACE_IDS)
def test_point_values_equal_jax(space, value_shape):
    jf, tf = _spaces(*space, value_shape)
    v = _values(jf, value_shape)
    a = jvtu._point_values(jf, v)
    b = tvtu._point_values(tf, torch.tensor(v))
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("space", SPACES, ids=SPACE_IDS)
def test_write_vtu_bytes_equal_jax(tmp_path, space):
    js, ts = _spaces(*space)
    jt, tt = _spaces(*space, (2, 2))
    s, t = _values(js, seed=1), _values(jt, (2, 2), seed=2)
    nodal = _values(jfs.FunctionSpace(js.mesh, "CG", 1), seed=3)
    jvtu.write_vtu(str(tmp_path / "j.vtu"), js.mesh,
                   {"T": (js, s), "sigma": (jt, t), "nodal": nodal})
    tvtu.write_vtu(str(tmp_path / "t.vtu"), ts.mesh,
                   {"T": (ts, torch.tensor(s)), "sigma": (tt, torch.tensor(t)),
                    "nodal": torch.tensor(nodal)})
    assert (tmp_path / "t.vtu").read_bytes() == (tmp_path / "j.vtu").read_bytes()


def test_vtu_series_pvd_equal_jax(tmp_path):
    js, ts = _spaces("DG", 1)
    jw = jvtu.VTUSeriesWriter(str(tmp_path / "j"), "series", js.mesh)
    tw = tvtu.VTUSeriesWriter(str(tmp_path / "t"), "series", ts.mesh)
    for i in range(3):
        v = _values(js, seed=i)
        jw.write(0.1 * i, {"T": (js, v)})
        tw.write(0.1 * i, {"T": (ts, torch.tensor(v))})
    jw.close()
    tw.close()
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t"))
    assert "series.pvd" in names and len(names) == 4
    for n in names:
        assert (tmp_path / "t" / n).read_bytes() == (
            tmp_path / "j" / n).read_bytes(), n


@pytest.mark.parametrize("space", SPACES, ids=SPACE_IDS)
def test_xdmf_equal_jax(tmp_path, space):
    jt, tt = _spaces(*space, (2, 2))
    jw = jxdmf.XDMFWriter(str(tmp_path / "j" / "sigma.xdmf"), jt.mesh)
    tw = txdmf.XDMFWriter(str(tmp_path / "t" / "sigma.xdmf"), tt.mesh)
    for i in range(2):
        v = _values(jt, (2, 2), seed=i)
        jw.write_function("Stress_tensor", jt, v, 0.5 * i)
        tw.write_function("Stress_tensor", tt, torch.tensor(v), 0.5 * i)
    jw.close()
    tw.close()
    assert (tmp_path / "t" / "sigma.xdmf").read_bytes() == (
        tmp_path / "j" / "sigma.xdmf").read_bytes()
    a = _h5_datasets(tmp_path / "j" / "sigma.h5")
    b = _h5_datasets(tmp_path / "t" / "sigma.h5")
    assert sorted(a) == sorted(b) and len(a) == 4
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_xdmf_needs_h5py():
    """Without h5py the module imports and the writer raises JAX's
    RuntimeError (there is no inline-XML form)."""
    code = (
        "import sys; sys.modules['h5py'] = None\n"
        "from fem_glass_tempering_tpu_torch.io import xdmf\n"
        "from fem_glass_tempering_tpu_torch.fem.mesh import box_mesh_2d\n"
        "try:\n"
        "    xdmf.XDMFWriter('never-written.xdmf', box_mesh_2d(1, 1))\n"
        "except RuntimeError as e:\n"
        "    print('raised:', e)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr
    assert "raised: XDMFWriter requires h5py; use VTUSeriesWriter" in r.stdout
    assert not (ROOT / "never-written.xdmf").exists()


# ----------------------------------------------------------------------
# mirrors of tests/test_io.py:17-82
# ----------------------------------------------------------------------

def test_write_vtu_roundtrip_xml(tmp_path):
    m = tmesh.box_mesh_2d(3, 2)
    fs = tfs.FunctionSpace(m, "CG", 1)
    T = torch.linspace(0, 1, fs.n_scalar_dofs, dtype=torch.float64)
    path = str(tmp_path / "out.vtu")
    tvtu.write_vtu(path, m, {"T": (fs, T)})
    root = ET.parse(path).getroot()
    assert root.tag == "VTKFile"
    piece = root.find(".//Piece")
    assert piece.get("NumberOfPoints") == str(m.n_nodes)
    assert piece.get("NumberOfCells") == str(m.n_cells)
    names = [d.get("Name") for d in root.findall(".//PointData/DataArray")]
    assert "T" in names
    np.testing.assert_array_equal(read_vtu(path)["T"], T.numpy())


def test_vtu_series_pvd(tmp_path):
    m = tmesh.interval_mesh(4)
    fs = tfs.FunctionSpace(m, "CG", 1)
    w = tvtu.VTUSeriesWriter(str(tmp_path), "series", m)
    for i in range(3):
        w.write(0.1 * i, {"T": (fs, torch.full((fs.n_scalar_dofs,), float(i),
                                                dtype=torch.float64))})
    w.close()
    pvd = ET.parse(str(tmp_path / "series.pvd")).getroot()
    assert len(pvd.findall(".//DataSet")) == 3


def test_xdmf_writer(tmp_path):
    m = tmesh.box_mesh_2d(2, 2)
    fs = tfs.FunctionSpace(m, "CG", 1, value_shape=(2, 2))
    w = txdmf.XDMFWriter(str(tmp_path / "sigma.xdmf"), m)
    sig = np.random.default_rng(0).random((fs.n_scalar_dofs, 2, 2))
    w.write_function("sigma", fs, torch.tensor(sig), 0.0)
    w.close()
    root = ET.parse(str(tmp_path / "sigma.xdmf")).getroot()
    assert root.tag == "Xdmf"
    with h5py.File(str(tmp_path / "sigma.h5")) as f:
        assert f["mesh/geometry"].shape == (m.n_nodes, 3)
        np.testing.assert_array_equal(
            f["fields/sigma/0"][...], sig.reshape(m.n_nodes, 4))


def _cfg(m, n_steps, **out):
    return m.RunConfig(fe=m.FEConfig(),
                       time=m.TimeConfig(0.0, n_steps * 0.1, 0.1),
                       output=m.OutputConfig(**out))


VTU_FIELDS = {"Temperature": ("T", "fs_T"), "Fictive_Temperature": ("Tf", "fs_T"),
              "Shift_function": ("phi", "fs_T"), "Shifted_time": ("xi", "fs_T"),
              "Stress_tensor": ("sigma", "fs_sigma")}


def test_solve_writes_all_formats(tmp_path):
    """The default workload, 4 steps, a snapshot every 2 in npz, VTU and
    XDMF: the files hold the port's final state exactly, and a JAX run's
    within the slice's tolerances."""
    out = dict(write_every=2, formats=("npz", "vtu", "xdmf"))
    prob = TP(config=_cfg(tc, 4, output_dir=str(tmp_path / "t"), **out),
              device="cpu")
    prob.setup()
    st = prob.solve()
    jprob = JP(config=_cfg(jc, 4, output_dir=str(tmp_path / "j"), **out))
    jprob.setup()
    jprob.solve()
    for d in ("t", "j"):
        for f in ("series.npz", "visco.pvd", "visco_00001.vtu", "sigma.xdmf",
                  "sigma.h5"):
            assert os.path.exists(tmp_path / d / f), (d, f)
    with np.load(tmp_path / "t" / "series.npz") as z:
        assert len(z["times"]) == 2
        assert z["T"].shape[0] == 2
        assert z["sigma"].ndim == 4
        np.testing.assert_array_equal(z["T"][-1], st.T.numpy())
        np.testing.assert_array_equal(z["sigma"][-1], st.sigma.numpy())

    got = read_vtu(tmp_path / "t" / "visco_00001.vtu")
    ref = read_vtu(tmp_path / "j" / "visco_00001.vtu")
    for name, (field, space) in VTU_FIELDS.items():
        want = tvtu._point_values(getattr(prob, space), getattr(st, field))
        np.testing.assert_array_equal(
            got[name], want.reshape(got[name].shape), err_msg=name)
        a, b = ref[name], got[name]
        tol = 1e-6 if name == "Stress_tensor" else 1e-9
        assert np.abs(a - b).max() <= tol * np.abs(a).max(), name
    for k in ("Points", "connectivity", "offsets", "types"):
        assert got[k].tobytes() == ref[k].tobytes(), k

    sig = _h5_datasets(tmp_path / "t" / "sigma.h5")
    want = tvtu._point_values(prob.fs_sigma, st.sigma)
    np.testing.assert_array_equal(sig["fields/Stress_tensor/1"],
                                  want.reshape(prob.mesh.n_nodes, -1))
    assert (tmp_path / "t" / "sigma.xdmf").read_bytes() == (
        tmp_path / "j" / "sigma.xdmf").read_bytes()
