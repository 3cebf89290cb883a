"""The PyTorch port's host-side FEM tables against the JAX package's.

Meshes (including the port's vectorised facet builder), function-space
dofmaps and owner maps, cell and boundary quadrature geometry, and the
StencilMatrix value tables and Gershgorin statistics must be exactly equal
(np.array_equal): both packages run the same numpy arithmetic, and the
port's facet builder must emit the same normalised layout.
"""

import jax  # noqa: F401  (JAX on the CPU, x64, via tests/conftest.py)
import numpy as np
import pytest
import torch

from fem_glass_tempering_tpu.fem import functionspace as jfs
from fem_glass_tempering_tpu.fem import mesh as jmesh
from fem_glass_tempering_tpu.ops import assembly as jasm
from fem_glass_tempering_tpu.ops.heat import HeatOperator as JHeat
from fem_glass_tempering_tpu.ops.stencil import StencilMatrix as JStencil
from fem_glass_tempering_tpu_torch.config import ModelParams
from fem_glass_tempering_tpu_torch.fem import functionspace as tfs
from fem_glass_tempering_tpu_torch.fem import mesh as tmesh
from fem_glass_tempering_tpu_torch.ops import assembly as tasm
from fem_glass_tempering_tpu_torch.ops.heat import HeatOperator as THeat
from fem_glass_tempering_tpu_torch.ops.stencil import StencilMatrix as TStencil

MESHES = {
    "ref1d": lambda m: m.reference_glass_mesh_1d(),
    "interval7": lambda m: m.interval_mesh(7, 0.0, 2.0),
    "quad3x2": lambda m: m.box_mesh_2d(3, 2, 1.0, 0.5),
    "tri3x2": lambda m: m.box_mesh_2d(3, 2, 1.0, 0.5, cell_type="triangle"),
    "box4x3x2": lambda m: m.box_mesh_3d(4, 3, 2, 1.0, 1.0, 0.01),
    "box8x8x4": lambda m: m.box_mesh_3d(8, 8, 4, 1.0, 1.0, 0.01),
    "tet2x2x1": lambda m: m.box_mesh_3d(2, 2, 1, 1.0, 1.0, 0.1,
                                        cell_type="tet"),
}
MESH_FIELDS = ("nodes", "cells", "boundary_cell", "boundary_local_facet",
               "interior_cell_p", "interior_local_facet_p",
               "interior_cell_m", "interior_local_facet_m")


def _pair(name):
    return MESHES[name](jmesh), MESHES[name](tmesh)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    assert np.array_equal(a, b), what


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_tables_equal(name):
    jm, tm = _pair(name)
    assert jm.cell_type == tm.cell_type
    for f in MESH_FIELDS:
        _equal(getattr(jm, f), getattr(tm, f), f)
    assert jm.structured == tm.structured


def test_facet_builder_matches_reference_loop():
    """The vectorised facet builder against the JAX package's per-pair
    Python loop (its numpy fallback), on a mesh with every facet kind."""
    jm, tm = _pair("box4x3x2")
    ref = jm._build_facets_numpy()
    got = (tm.boundary_cell, tm.boundary_local_facet, tm.interior_cell_p,
           tm.interior_local_facet_p, tm.interior_cell_m,
           tm.interior_local_facet_m)
    for a, b in zip(ref, got):
        _equal(a, b, "facets")


def test_facet_builder_rejects_nonmanifold():
    cells = np.array([[0, 1], [0, 2], [0, 3]])
    with pytest.raises(ValueError, match="incident cells"):
        tmesh.Mesh("interval", np.arange(4.0)[:, None], cells)


@pytest.mark.parametrize("name,family,degree", [
    ("ref1d", "CG", 1), ("ref1d", "DG", 1), ("box4x3x2", "CG", 1),
    ("box4x3x2", "DG", 1), ("box4x3x2", "CG", 2), ("box8x8x4", "CG", 1),
    ("tri3x2", "CG", 2),
])
def test_function_space_maps_equal(name, family, degree):
    jm, tm = _pair(name)
    a = jfs.FunctionSpace(jm, family, degree)
    b = tfs.FunctionSpace(tm, family, degree)
    assert a.n_scalar_dofs == b.n_scalar_dofs
    for f in ("dofmap", "dof_coords", "owner_cell", "owner_lpoint"):
        _equal(getattr(a, f), getattr(b, f), f)
    _equal(a.boundary_scalar_dofs(), b.boundary_scalar_dofs(), "bdofs")


@pytest.mark.parametrize("name", ["ref1d", "box4x3x2", "box8x8x4"])
def test_geometry_equal(name):
    jm, tm = _pair(name)
    a = jfs.FunctionSpace(jm, "CG", 1)
    b = tfs.FunctionSpace(tm, "CG", 1)
    cg_a = jasm.build_cell_geometry(jm, a)
    cg_b = tasm.build_cell_geometry(tm, b)
    for f in ("qpoints_ref", "qweights", "phi", "grad_phys", "qpoints_phys"):
        _equal(getattr(cg_a, f), getattr(cg_b, f), f)
    bg_a = jasm.build_boundary_geometry(jm, a, 5)
    bg_b = tasm.build_boundary_geometry(tm, b, 5)
    for f in ("cell", "qweights", "phi", "grad_phys", "normal",
              "qpoints_phys"):
        _equal(getattr(bg_a, f), getattr(bg_b, f), f)


@pytest.mark.parametrize("name", ["box4x3x2", "box8x8x4"])
def test_stencil_tables_equal(name):
    jm, tm = _pair(name)
    from fem_glass_tempering_tpu.config import ModelParams as JParams
    ja = JStencil(JHeat(jfs.FunctionSpace(jm, "CG", 1), JParams(), 0.1))
    tb = TStencil(THeat(tfs.FunctionSpace(tm, "CG", 1), ModelParams(), 0.1,
                        device="cpu"))
    _equal(ja.np_mass, tb.np_mass, "mass")
    _equal(ja.np_stiff, tb.np_stiff, "stiff")
    assert ja.gersh.keys() == tb.gersh.keys()
    for k in ja.gersh:
        _equal(ja.gersh[k], tb.gersh[k], k)
    _equal(np.asarray(ja.b_st_idx), tb.np_b_st_idx, "b_st_idx")
    _equal(ja.np_dense(800.0, 0.1), tb.np_dense(800.0, 0.1), "dense")
    assert tb.st_mass.dtype == torch.float64
