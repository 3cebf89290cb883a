"""Mesh partitioning and the halo maps of explicit domain decomposition.

Counterpart of fem_glass_tempering_tpu/parallel/partition.py, a numpy copy
whose arrays equal the JAX version's: cells are split into P contiguous
blocks along a lexicographic sort of their centroids (longest bounding-box
axis first), each block padded to equal size, and the interior facets
that cross a partition get symmetric halo maps: every rank publishes the
dof values of its interface cells, and each rank knows which (rank, slot)
rows its own cross-facet integrals read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from fem_glass_tempering_tpu_torch.fem.mesh import Mesh


def partition_cells(mesh: Mesh, n_parts: int) -> np.ndarray:
    """(n_cells,) device id per cell: contiguous blocks along a coordinate
    sort of cell centroids (major axis = longest bbox axis), which keeps
    interfaces small for plate-like meshes and matches the
    'partition contiguously within hosts' guidance of SURVEY.md §5."""
    cent = mesh.nodes[mesh.cells].mean(axis=1)
    bbox = cent.max(axis=0) - cent.min(axis=0)
    major = int(np.argmax(bbox))
    axes = [major] + [a for a in range(mesh.gdim) if a != major]
    order = np.lexsort(tuple(cent[:, a] for a in reversed(axes)))
    part = np.empty(mesh.n_cells, dtype=np.int32)
    # equal-size contiguous chunks over the sorted order
    bounds = np.linspace(0, mesh.n_cells, n_parts + 1).astype(np.int64)
    for p in range(n_parts):
        part[order[bounds[p]:bounds[p + 1]]] = p
    return part


@dataclass
class DDLayout:
    """Device-decomposed layout for a DG scalar space (cell-local dofs).

    All arrays carry a leading device axis P and are padded to static
    shapes; pad cells reference slot 0 with zero quadrature weight so they
    assemble exact zeros.
    """

    n_parts: int
    n_local_cells: int          # L: padded cells per device
    nloc: int
    cell_of_slot: np.ndarray    # (P, L) global cell id, -1 = padding
    n_dofs_global: int
    # dof <-> (device, slot) correspondence for gather/scatter at the edges
    global_dof_of_local: np.ndarray  # (P, L*nloc) global dof id, -1 padding
    # halo: interface-cell publication
    n_send: int                  # H: padded send-list length
    send_cell_slot: np.ndarray   # (P, H) local cell slot published (0 pad)
    send_mask: np.ndarray        # (P, H) 1.0 valid / 0.0 pad
    # per-device cross-facet remote gather: flat index into (P*H) published rows
    n_cross: int                 # F: padded cross-facet count per device
    cross_recv_flat: np.ndarray  # (P, F) index into flattened (P*H) rows


def build_dd_layout(mesh: Mesh, nloc: int, dofmap: np.ndarray,
                    n_parts: int) -> tuple[DDLayout, np.ndarray, dict]:
    """Build the layout + per-device cell lists for a DG space.

    Returns (layout, part, aux) where aux carries per-device index arrays
    used by the operator builder: local cell lists, intra/cross facet lists.
    """
    part = partition_cells(mesh, n_parts)
    P = n_parts
    cells_by_dev = [np.nonzero(part == p)[0].astype(np.int32) for p in range(P)]
    L = max(len(c) for c in cells_by_dev)
    cell_of_slot = np.full((P, L), -1, dtype=np.int32)
    slot_of_cell = np.full(mesh.n_cells, -1, dtype=np.int32)
    for p, cl in enumerate(cells_by_dev):
        cell_of_slot[p, : len(cl)] = cl
        slot_of_cell[cl] = np.arange(len(cl), dtype=np.int32)

    # interior facets: split intra-device vs cross-device; a cross facet is
    # duplicated onto both sides, each computing only its own cells' rows
    cp, cm = mesh.interior_cell_p, mesh.interior_cell_m
    pp, pm = part[cp], part[cm]
    cross = pp != pm
    intra_by_dev = [np.nonzero((~cross) & (pp == p))[0] for p in range(P)]
    # cross facets seen from each side
    cross_idx = np.nonzero(cross)[0]
    cross_by_dev_side = [[] for _ in range(P)]  # entries: (facet_idx, side)
    for fi in cross_idx:
        cross_by_dev_side[pp[fi]].append((fi, 0))   # owns '+' side rows
        cross_by_dev_side[pm[fi]].append((fi, 1))   # owns '-' side rows

    # send lists: interface cells each device must publish (remote side reads)
    send_lists = [set() for _ in range(P)]
    for fi in cross_idx:
        send_lists[pp[fi]].add(int(cp[fi]))
        send_lists[pm[fi]].add(int(cm[fi]))
    send_sorted = [np.array(sorted(s), dtype=np.int32) for s in send_lists]
    H = max((len(s) for s in send_sorted), default=1) or 1
    send_cell_slot = np.zeros((P, H), dtype=np.int32)
    send_mask = np.zeros((P, H))
    pub_row = {}  # global cell -> flat row in (P*H)
    for p, s in enumerate(send_sorted):
        for j, c in enumerate(s):
            send_cell_slot[p, j] = slot_of_cell[c]
            send_mask[p, j] = 1.0
            pub_row[int(c)] = p * H + j

    # per-device cross-facet remote row indices
    F = max((len(v) for v in cross_by_dev_side), default=1) or 1
    cross_recv_flat = np.zeros((P, F), dtype=np.int32)
    for p, lst in enumerate(cross_by_dev_side):
        for j, (fi, side) in enumerate(lst):
            remote_cell = int(cm[fi] if side == 0 else cp[fi])
            cross_recv_flat[p, j] = pub_row[remote_cell]

    # global dof ids of local slots (DG: cell-contiguous)
    gd = np.full((P, L * nloc), -1, dtype=np.int64)
    for p in range(P):
        cl = cells_by_dev[p]
        gd[p, : len(cl) * nloc] = dofmap[cl].reshape(-1)

    layout = DDLayout(
        n_parts=P, n_local_cells=L, nloc=nloc, cell_of_slot=cell_of_slot,
        n_dofs_global=int(dofmap.max()) + 1,
        global_dof_of_local=gd,
        n_send=H, send_cell_slot=send_cell_slot, send_mask=send_mask,
        n_cross=F, cross_recv_flat=cross_recv_flat,
    )
    aux = {
        "cells_by_dev": cells_by_dev,
        "slot_of_cell": slot_of_cell,
        "intra_by_dev": intra_by_dev,
        "cross_by_dev_side": cross_by_dev_side,
    }
    return layout, part, aux


def scatter_global_to_local(layout: DDLayout, vec: np.ndarray) -> np.ndarray:
    """(n_dofs_global,) -> (P, L*nloc) with 0 in padding slots."""
    out = np.zeros((layout.n_parts, layout.n_local_cells * layout.nloc),
                   dtype=vec.dtype)
    valid = layout.global_dof_of_local >= 0
    out[valid] = vec[layout.global_dof_of_local[valid]]
    return out


def gather_local_to_global(layout: DDLayout, loc: np.ndarray) -> np.ndarray:
    """(P, L*nloc) -> (n_dofs_global,) (DG: each global dof lives on exactly
    one device, so this is a pure placement)."""
    out = np.zeros(layout.n_dofs_global, dtype=loc.dtype)
    valid = layout.global_dof_of_local >= 0
    out[layout.global_dof_of_local[valid]] = loc[valid]
    return out
