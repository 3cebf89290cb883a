"""The PyTorch port's command line against the JAX package's.

`python -m fem_glass_tempering_tpu_torch.main` takes JAX's flags plus
`--device`. For the same argv (with `--device cpu` added for the port) it
prints JAX's step, Newton and CG counts: the default 1D DG-1 slab (10 /
45 in 3 steps), the DG-1 box through "auto" (14 / 46) and the slab read
from a gmsh file (10 / 45); and one JSON config file written by JAX's
RunConfig drives both. Its npz output holds T within max-rel 1e-9 of
JAX's. Mirrors tests/test_cli_and_misc.py:49-68,86-126,128-153,177-195.
`--shard` raises (Slice 7); without CUDA the default `--device` raises
rather than running on the CPU; `--profile-dir` writes a torch.profiler
trace; the logging helpers and PhaseTimer work as JAX's.
"""

import json
import logging

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu import config as jc
from fem_glass_tempering_tpu.fem import mshio as jmshio
from fem_glass_tempering_tpu.main import main as jmain
from fem_glass_tempering_tpu_torch import config as tc
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.main import main as tmain
from fem_glass_tempering_tpu_torch.utils import logging as tlog
from fem_glass_tempering_tpu_torch.utils.profiling import (
    TRACE_FILE,
    PhaseTimer,
    device_trace,
)


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(argv, tmp_path, capsys):
    """Run the JAX and the port command lines on one argv, each into its
    own output directory -> (JAX's stats, the port's stats)."""
    assert jmain(argv + ["--output-dir", str(tmp_path / "j")]) == 0
    js = _last_json(capsys)
    assert tmain(argv + ["--output-dir", str(tmp_path / "t"),
                         "--device", "cpu"]) == 0
    return js, _last_json(capsys)


ALL_FORMATS = ["--formats", "npz,vtu,xdmf", "--write-every", "1"]


@pytest.mark.parametrize("argv,counts", [
    (["--steps", "3"] + ALL_FORMATS, (10, 45)),
    (["--steps", "3", "--problem-dim", "3", "--nx", "8", "--ny", "8",
      "--nz", "4"] + ALL_FORMATS, (14, 46)),
    (["--steps", "3", "--mesh", "MESH"], (10, 45)),
], ids=["slab", "dg-box", "gmsh-slab"])
def test_cli_counts_equal_jax(tmp_path, capsys, argv, counts):
    if "MESH" in argv:
        mesh = str(tmp_path / "mesh1d.msh")
        jmshio.create_mesh(mesh)
        argv = [mesh if a == "MESH" else a for a in argv]
    js, ts = _both(argv, tmp_path, capsys)
    assert ts["n_steps"] == js["n_steps"] == 3
    assert (ts["newton_iters"], ts["krylov_iters"]) == (
        js["newton_iters"], js["krylov_iters"]) == counts
    assert set(ts) == set(js)
    if "npz,vtu,xdmf" in argv:
        for f in ("series.npz", "visco.pvd", "visco_00002.vtu",
                  "sigma.xdmf", "sigma.h5"):
            assert (tmp_path / "t" / f).exists(), f
        with np.load(tmp_path / "j" / "series.npz") as zj, \
                np.load(tmp_path / "t" / "series.npz") as zt:
            np.testing.assert_array_equal(zj["times"], zt["times"])
            a, b = zj["T"], zt["T"]
            assert a.shape == b.shape == (3, b.shape[1])
            assert np.abs(a - b).max() / np.abs(a).max() < 1e-9


def test_cli_json_config_file(tmp_path, capsys):
    """One JSON file, written by the JAX package's RunConfig, drives both
    command lines to the same counts."""
    cfg = jc.RunConfig(
        fe=jc.FEConfig(T_family="CG", T_degree=1),
        time=jc.TimeConfig(0.0, 0.3, 0.1),
        solver=jc.SolverConfig(linear_operator="matrix_free"),
        output=jc.OutputConfig(write_every=0, formats=()),
    )
    p = tmp_path / "run.json"
    p.write_text(cfg.to_json())
    js, ts = _both(["--config", str(p), "--write-every", "0", "--formats", ""],
                   tmp_path, capsys)
    assert ts["n_steps"] == js["n_steps"] == 3
    assert (ts["newton_iters"], ts["krylov_iters"]) == (
        js["newton_iters"], js["krylov_iters"])
    assert tc.RunConfig.from_json(p.read_text()).to_json() == cfg.to_json()


def test_cli_short_run(tmp_path, capsys):
    rc = tmain(["--device", "cpu", "--steps", "3", "--output-dir",
                str(tmp_path), "--write-every", "0", "--formats", ""])
    assert rc == 0
    stats = _last_json(capsys)
    assert stats["n_steps"] == 3
    assert stats["newton_iters"] > 0
    assert stats["io_seconds"] >= 0.0 and stats["elapsed_seconds"] > 0.0


def test_cli_write_mesh(tmp_path, capsys):
    argv = ["--problem-dim", "2", "--nx", "4", "--ny", "3", "--write-mesh"]
    assert tmain(["--device", "cpu"] + argv + [str(tmp_path / "t.msh")]) == 0
    assert jmain(argv + [str(tmp_path / "j.msh")]) == 0
    assert "wrote" in capsys.readouterr().out
    m = tmesh.read_msh(str(tmp_path / "t.msh"))
    assert m.n_cells == 12
    assert (tmp_path / "t.msh").read_bytes() == (tmp_path / "j.msh").read_bytes()


def test_cli_shard_raises(tmp_path, monkeypatch, capsys):
    """--shard runs (parallel/sharding.py): as one rank on the CPU it
    steps as the unsharded command line does. Without a GPU the default
    device raises before any output, sharded or not."""
    counts = {}
    for tag in ("plain", "shard"):
        argv = ["--device", "cpu", "--steps", "2", "--output-dir",
                str(tmp_path / tag)] + (["--shard"] if tag == "shard" else [])
        assert tmain(argv) == 0
        out = json.loads(capsys.readouterr().out.splitlines()[-1])
        counts[tag] = (out["newton_iters"], out["krylov_iters"])
    assert counts["shard"] == counts["plain"]
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["--shard", "--steps", "1", "--output-dir",
               str(tmp_path / "cuda")])
    assert not (tmp_path / "cuda").exists()


@pytest.mark.parametrize("extra", [[], ["--write-mesh", "MESH"]],
                         ids=["run", "write-mesh"])
def test_cli_default_device_raises_without_cuda(tmp_path, monkeypatch, extra):
    """The command line runs on the GPU by default: without one it raises
    rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    extra = [str(tmp_path / "m.msh") if a == "MESH" else a for a in extra]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmain(["--steps", "1", "--output-dir", str(tmp_path)] + extra)
    assert not any(tmp_path.iterdir())


def test_cli_profile_dir_writes_trace(tmp_path, capsys):
    """--profile-dir traces the solve with torch.profiler (the CPU's
    operations here; on the GPU its kernels too)."""
    d = tmp_path / "trace"
    assert tmain(["--device", "cpu", "--steps", "2", "--output-dir",
                  str(tmp_path / "out"), "--formats", "",
                  "--profile-dir", str(d)]) == 0
    assert _last_json(capsys)["n_steps"] == 2
    events = json.loads((d / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names)


def test_device_trace_and_phase_timer(tmp_path):
    d = str(tmp_path / "t")
    with device_trace(d, device="cpu"):
        torch.ones(8).add_(1.0)
    events = json.loads((tmp_path / "t" / TRACE_FILE).read_text())[
        "traceEvents"]
    assert any(e.get("name") == "aten::add_" for e in events)
    t = PhaseTimer()
    with t.phase("x"):
        pass
    with t.phase("x"):
        pass
    assert t.counts["x"] == 2 and "x" in t.report()


def test_runconfig_json_roundtrip():
    cfg = tc.RunConfig(
        solver=tc.SolverConfig(newton_rtol=1e-7, preconditioner="mg",
                               linear_operator="stencil"),
        output=tc.OutputConfig(write_every=7, formats=("npz", "vtu"),
                               npz_fields=("T", "Tf_partial")),
        physics_mode="corrected", shift_function="eq25",
        dtype="float32", use_pallas=True,
    )
    assert tc.RunConfig.from_json(cfg.to_json()) == cfg


def test_npz_fields_config(tmp_path):
    from fem_glass_tempering_tpu_torch.models.problem import ThermoViscoProblem
    cfg = tc.RunConfig(
        time=tc.TimeConfig(0.0, 0.3, 0.1),
        output=tc.OutputConfig(output_dir=str(tmp_path), write_every=1,
                               formats=("npz",),
                               npz_fields=("T", "Tf_partial", "sigma")))
    prob = ThermoViscoProblem(config=cfg, device="cpu")
    prob.setup()
    prob.solve()
    with np.load(tmp_path / "series.npz") as z:
        assert z["Tf_partial"].shape[-1] == 6
        assert sorted(z.files) == ["T", "Tf_partial", "sigma", "times"]


def test_logging_helpers(tmp_path, capsys):
    log = tlog.get_logger("fgt-torch-test", level=logging.INFO)
    assert tlog.get_logger("fgt-torch-test") is log and len(log.handlers) == 1
    m = tlog.MetricsLog(str(tmp_path / "m" / "metrics.jsonl"))
    m.log(step=1, newton=3)
    m.log(step=2, newton=2, wall_s=0.5)
    m.close()
    rows = [json.loads(r) for r in
            (tmp_path / "m" / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2]
    assert "wall_s" in rows[0] and rows[1]["wall_s"] == 0.5
    cb = tlog.progress_printer(10, log)
    cb(0.5, None)
    assert "t=0.500" in capsys.readouterr().err
