"""gmsh 4.1 ASCII writer.

Counterpart of fem_glass_tempering_tpu/fem/mshio.py, whose files it equals
byte for byte. The reference generates its mesh with the gmsh kernel
(geometry.py:3-29, physical group "cells" at geometry.py:23-24); here the
builders produce Mesh objects and this writer emits them as gmsh 4.1
files, physical groups included. Round-trips through read_msh with cell
and facet tags intact.
"""

from __future__ import annotations

import numpy as np

from fem_glass_tempering_tpu_torch.fem.mesh import Mesh, reference_glass_mesh_1d

_GMSH_ETYPE = {"interval": 1, "triangle": 2, "quad": 3, "tet": 4, "hex": 5}
# facet element type per cell type: 15 = point
_FACET_ETYPE = {"interval": 15, "triangle": 1, "quad": 1, "tet": 2, "hex": 3}
_ETYPE_PERM = {15: [0], 1: [0, 1], 2: [0, 1, 2], 3: [0, 1, 3, 2],
               4: [0, 1, 2, 3], 5: [0, 1, 3, 2, 4, 5, 7, 6]}


def write_msh(path: str, mesh: Mesh, physical_name: str = "cells",
              cell_tags: np.ndarray | None = None,
              facet_tags: np.ndarray | None = None,
              physical_names: dict | None = None) -> None:
    """Write `mesh` as gmsh 4.1 ASCII.

    cell_tags: (n_cells,) int physical tags; default = all 0 under the
      group `physical_name` (the reference's geometry.py:23-24 layout).
    facet_tags: (n_boundary_facets,) int tags aligned with the boundary
      facet enumeration; -1 = untagged (not written).
    physical_names: {name: (dim, tag)} extra $PhysicalNames entries;
      `physical_name` -> (tdim, 0) is always included when cell_tags
      defaults.
    """
    etype = _GMSH_ETYPE[mesh.cell_type]
    tdim = mesh.tdim
    n_nodes, n_cells = mesh.n_nodes, mesh.n_cells
    pts3 = np.zeros((n_nodes, 3))
    pts3[:, : mesh.gdim] = mesh.nodes

    names = dict(physical_names or {})
    if cell_tags is None:
        cell_tags = np.zeros(n_cells, dtype=np.int32)
        names.setdefault(physical_name, (tdim, 0))
    cell_tags = np.asarray(cell_tags, dtype=np.int32)

    def to_gmsh(verts, et):
        perm = _ETYPE_PERM[et]
        inv = np.argsort(perm)
        return [verts[p] for p in inv]

    # element blocks: (dim, entity_tag, etype, [(verts_gmsh, ...)]); one
    # entity per (dim, physical tag), entity_tag = running id per dim
    blocks = []
    entities: dict[int, list] = {d: [] for d in range(4)}  # dim -> [(etag, phys)]

    def add_group(dim, phys, et, elem_list):
        etag = len(entities[dim]) + 1
        entities[dim].append((etag, int(phys)))
        blocks.append((dim, etag, et, elem_list))

    for t in np.unique(cell_tags):
        sel = np.where(cell_tags == t)[0]
        add_group(tdim, t, etype,
                  [to_gmsh(mesh.cells[c], etype) for c in sel])
    if facet_tags is not None:
        facet_tags = np.asarray(facet_tags)
        fe = _FACET_ETYPE[mesh.cell_type]
        rc = mesh.ref_cell
        for t in np.unique(facet_tags):
            if t < 0:
                continue
            sel = np.where(facet_tags == t)[0]
            elems = []
            for k in sel:
                c = mesh.boundary_cell[k]
                lf = mesh.boundary_local_facet[k]
                elems.append(to_gmsh(
                    list(mesh.cells[c][list(rc.facets[lf])]), fe))
            add_group(tdim - 1, t, fe, elems)

    lines = []
    lines.append("$MeshFormat\n4.1 0 8\n$EndMeshFormat")
    if names:
        lines.append("$PhysicalNames")
        lines.append(str(len(names)))
        for nm, (d, t) in sorted(names.items(), key=lambda kv: kv[1]):
            lines.append(f'{d} {t} "{nm}"')
        lines.append("$EndPhysicalNames")
    # $Entities: minimal records binding each entity to its physical tag
    lines.append("$Entities")
    lines.append(" ".join(str(len(entities[d])) for d in range(4)))
    for d in range(4):
        for etag, phys in entities[d]:
            if d == 0:
                lines.append(f"{etag} 0 0 0 1 {phys}")
            else:
                lines.append(f"{etag} 0 0 0 0 0 0 1 {phys} 0")
    lines.append("$EndEntities")
    lines.append("$Nodes")
    lines.append(f"1 {n_nodes} 1 {n_nodes}")
    # nodes live on the first top-dim entity
    lines.append(f"{tdim} 1 0 {n_nodes}")
    lines.extend(str(i + 1) for i in range(n_nodes))
    lines.extend(f"{p[0]} {p[1]} {p[2]}" for p in pts3)
    lines.append("$EndNodes")
    n_elems = sum(len(b[3]) for b in blocks)
    lines.append("$Elements")
    lines.append(f"{len(blocks)} {n_elems} 1 {n_elems}")
    eid = 1
    for dim, etag, et, elems in blocks:
        lines.append(f"{dim} {etag} {et} {len(elems)}")
        for verts in elems:
            lines.append(str(eid) + " "
                         + " ".join(str(int(v) + 1) for v in verts))
            eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def create_mesh(path: str) -> None:
    """Write the reference's default graded 1D glass mesh to `path`
    (the reference's create_mesh entry point, geometry.py:3-29, without the
    gmsh kernel dependency)."""
    write_msh(path, reference_glass_mesh_1d())
