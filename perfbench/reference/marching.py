"""Isosurface extraction via marching tetrahedra (Kuhn/Freudenthal split).

Replaces the reference's skimage.measure.marching_cubes
(clipfusion.py:723-739) with a from-scratch, fully vectorized implementation:

- each grid cell splits into 6 tetrahedra along the main diagonal (Kuhn
  triangulation, face-consistent across neighboring cells -> watertight
  surfaces)
- NaN handling matches the reference's contract: voxels never observed are
  NaN, and any geometry touching them is dropped (the reference drops faces
  with NaN vertices post-hoc; we skip invalid tetrahedra up front)
- vertices are deduplicated by global grid-edge id, so shared vertices are
  exact and the mesh is compact (the reference achieves this via marching
  cubes + reindexing, clipfusion.py:730-739)
- triangles are oriented so normals point toward positive values (empty
  space, for a TSDF at level 0)

Vectorized numpy on host (the JAX package also has a native C++ path with
identical output; the port uses this numpy one).
Vertex coordinates are returned in voxel-index space (like skimage), so the
caller applies `verts * voxel_size + origin`.
"""
from __future__ import annotations

import numpy as np

# Corner numbering n = dx*4 + dy*2 + dz over the unit cube.
_CORNER_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)

# Kuhn triangulation: 6 tets per cube, one per axis permutation; corner
# chains 0 -> e_a -> e_a + e_b -> 7.
_TETS = np.array(
    [
        [0, 4, 6, 7],  # x, y, z
        [0, 4, 5, 7],  # x, z, y
        [0, 2, 6, 7],  # y, x, z
        [0, 2, 3, 7],  # y, z, x
        [0, 1, 5, 7],  # z, x, y
        [0, 1, 3, 7],  # z, y, x
    ],
    dtype=np.int64,
)

# Tet edges indexed 0..5: (corner_i, corner_j) local to the tet.
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# Triangulation per inside-mask (bit i set = tet corner i is inside, i.e.
# value < level). Each entry: list of triangles as triples of tet-edge ids.
_CASE_TRIS = {
    1: [(0, 1, 2)],
    2: [(0, 3, 4)],
    3: [(1, 3, 4), (1, 4, 2)],
    4: [(1, 3, 5)],
    5: [(0, 3, 5), (0, 5, 2)],
    6: [(0, 1, 5), (0, 5, 4)],
    7: [(2, 4, 5)],
    8: [(2, 4, 5)],
    9: [(0, 1, 5), (0, 5, 4)],
    10: [(0, 3, 5), (0, 5, 2)],
    11: [(1, 3, 5)],
    12: [(1, 3, 4), (1, 4, 2)],
    13: [(0, 3, 4)],
    14: [(0, 1, 2)],
}


def marching_tetrahedra(vol: np.ndarray, level: float = 0.0):
    """Extract the `level` isosurface of a [X, Y, Z] float volume.

    Returns (verts [V, 3] float32 in voxel-index space, faces [F, 3] int64).
    NaN voxels are treated as unobserved: no geometry touches them.
    """
    vol = np.asarray(vol, dtype=np.float32)
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    flat = vol.reshape(-1)
    # linear index helpers
    sx, sy, sz = Y * Z, Z, 1

    # base linear index of every cell's corner (0,0,0)
    cx, cy, cz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = (cx * sx + cy * sy + cz * sz).reshape(-1)  # [Ncell]

    corner_lin_off = _CORNER_OFFSETS @ np.array([sx, sy, sz])  # [8]

    all_edge_a = []
    all_edge_b = []
    all_tri_edge_keys = []  # per-triangle 3 edge keys, appended per batch

    for tet in _TETS:
        lin = base[:, None] + corner_lin_off[tet][None, :]  # [Ncell, 4]
        vals = flat[lin]  # [Ncell, 4]
        finite = np.isfinite(vals).all(axis=1)
        inside = vals < level
        code = (
            inside[:, 0] * 1 + inside[:, 1] * 2 + inside[:, 2] * 4 + inside[:, 3] * 8
        )
        code = np.where(finite, code, 0)

        for case, tris in _CASE_TRIS.items():
            sel = np.nonzero(code == case)[0]
            if len(sel) == 0:
                continue
            lin_sel = lin[sel]  # [M, 4]
            for tri in tris:
                # each triangle vertex lies on a tet edge
                ea = _TET_EDGES[list(tri)][:, 0]  # [3] local corner a
                eb = _TET_EDGES[list(tri)][:, 1]
                a_lin = lin_sel[:, ea]  # [M, 3]
                b_lin = lin_sel[:, eb]
                all_edge_a.append(a_lin.reshape(-1))
                all_edge_b.append(b_lin.reshape(-1))

    if not all_edge_a:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    a_lin = np.concatenate(all_edge_a)  # [3*F]
    b_lin = np.concatenate(all_edge_b)
    return _dedup_orient_finish(vol, flat, a_lin, b_lin, level)


def _dedup_orient_finish(vol, flat, a_lin, b_lin, level):
    """Shared tail of marching_tetrahedra / marching_cubes: edge-keyed
    vertex dedup, interpolation, degenerate-face drop, compaction, and
    gradient-based orientation. a_lin/b_lin are flat [3*F] linear corner
    indices of the grid edge each triangle vertex lies on."""
    X, Y, Z = vol.shape
    sx, sy = Y * Z, Z

    # canonical (sorted) edge key -> dedup shared vertices exactly
    lo = np.minimum(a_lin, b_lin)
    hi = np.maximum(a_lin, b_lin)
    keys = lo * (X * Y * Z) + hi
    uniq_keys, inverse = np.unique(keys, return_inverse=True)
    faces = inverse.reshape(-1, 3)

    ulo = (uniq_keys // (X * Y * Z)).astype(np.int64)
    uhi = (uniq_keys % (X * Y * Z)).astype(np.int64)
    va = flat[ulo]
    vb = flat[uhi]
    t = (level - va) / (vb - va)
    t = np.clip(t, 0.0, 1.0)

    def lin_to_xyz(lin):
        return np.stack(
            [lin // sx, (lin % sx) // sy, lin % sy], axis=-1
        ).astype(np.float32)

    pa = lin_to_xyz(ulo)
    pb = lin_to_xyz(uhi)
    verts = pa + t[:, None].astype(np.float32) * (pb - pa)

    # drop degenerate triangles (repeated vertex ids)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    faces = faces[good]

    # drop unreferenced vertices, reindex compactly
    used = np.zeros(len(verts), dtype=bool)
    used[faces.reshape(-1)] = True
    reindex = np.cumsum(used) - 1
    faces = reindex[faces]
    verts = verts[used]

    # consistent orientation: normal points toward increasing field value
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    normals = np.cross(v1 - v0, v2 - v0)
    centroid = (v0 + v1 + v2) / 3.0
    grad = _sample_gradient(vol, centroid)
    flip = (normals * grad).sum(axis=1) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]

    return verts.astype(np.float32), faces.astype(np.int64)


def marching_cubes(vol: np.ndarray, level: float = 0.0):
    """Classic table-based marching cubes (256 corner configs, one vertex
    per cut CUBE edge) — the direct counterpart of the reference's
    skimage.measure.marching_cubes (clipfusion.py:727).

    Emits roughly half the triangles of `marching_tetrahedra` for the same
    volume (no interior-diagonal vertices), so mesh JSON payloads,
    per-object extraction, and vertex-bucketed query programs all shrink.
    Same contracts as MT: NaN cells emit no geometry, vertices dedup by
    global grid edge, normals orient toward increasing field value, and
    coordinates are in voxel-index space. The case table is generated
    (not transcribed) by mc_tables.build_tables(); ambiguous faces use a
    fixed separate-inside-corners rule, identical on both sides of a
    shared face, so surfaces stay watertight across cells.
    """
    from .mc_tables import CUBE_EDGES, build_tables

    vol = np.asarray(vol, dtype=np.float32)
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    flat = vol.reshape(-1)
    sx, sy, sz = Y * Z, Z, 1

    cx, cy, cz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = (cx * sx + cy * sy + cz * sz).reshape(-1)  # [Ncell]
    corner_lin_off = _CORNER_OFFSETS @ np.array([sx, sy, sz])  # [8]

    vals = flat[base[:, None] + corner_lin_off[None, :]]  # [Ncell, 8]
    finite = np.isfinite(vals).all(axis=1)
    inside = vals < level
    code = (inside << np.arange(8)[None, :]).sum(axis=1)
    code = np.where(finite, code, 0)

    tri_table, max_tris = build_tables()
    edges = np.asarray(CUBE_EDGES)  # [12, 2] corner ids
    edge_a_off = corner_lin_off[edges[:, 0]]  # [12]
    edge_b_off = corner_lin_off[edges[:, 1]]

    # one padded lookup table [256, 3*max_tris] of cube-edge ids (-1 pad);
    # all active cells then resolve in a single gather instead of a
    # per-case python loop
    tab = np.full((256, 3 * max_tris), -1, np.int64)
    for case, tris in enumerate(tri_table):
        if tris:
            flat_tris = np.asarray(tris, np.int64).reshape(-1)
            tab[case, : len(flat_tris)] = flat_tris

    active = np.nonzero((code != 0) & (code != 255))[0]
    if not len(active):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    cell_edges = tab[code[active]]  # [M, 3*max_tris]
    valid = cell_edges >= 0
    safe_edges = np.where(valid, cell_edges, 0)
    sel_base = base[active][:, None]
    a_lin = (sel_base + edge_a_off[safe_edges])[valid]
    b_lin = (sel_base + edge_b_off[safe_edges])[valid]
    if not len(a_lin):
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    return _dedup_orient_finish(vol, flat, a_lin, b_lin, level)


def _sample_gradient(vol, pts):
    """Central-difference gradient at float points (nearest voxel), NaN-safe.
    Neighbor indices are clamped to the volume, so boundary voxels use a
    one-sided difference — the old interior clamp (idx to [1, dim-2])
    collapsed to 0 when a dim was exactly 2 and read index -1 (wrap-around
    to the far face; out-of-bounds in the native mirror)."""
    X, Y, Z = vol.shape
    idx = np.round(pts).astype(np.int64)
    idx[:, 0] = np.clip(idx[:, 0], 0, X - 1)
    idx[:, 1] = np.clip(idx[:, 1], 0, Y - 1)
    idx[:, 2] = np.clip(idx[:, 2], 0, Z - 1)
    safe = np.nan_to_num(vol, nan=0.0)
    xp = np.minimum(idx[:, 0] + 1, X - 1)
    xm = np.maximum(idx[:, 0] - 1, 0)
    yp = np.minimum(idx[:, 1] + 1, Y - 1)
    ym = np.maximum(idx[:, 1] - 1, 0)
    zp = np.minimum(idx[:, 2] + 1, Z - 1)
    zm = np.maximum(idx[:, 2] - 1, 0)
    gx = safe[xp, idx[:, 1], idx[:, 2]] - safe[xm, idx[:, 1], idx[:, 2]]
    gy = safe[idx[:, 0], yp, idx[:, 2]] - safe[idx[:, 0], ym, idx[:, 2]]
    gz = safe[idx[:, 0], idx[:, 1], zp] - safe[idx[:, 0], idx[:, 1], zm]
    return np.stack([gx, gy, gz], axis=-1)
