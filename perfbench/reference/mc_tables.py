"""Marching-cubes case table, generated correct-by-construction.

The classic 256-case marching-cubes triangle table (Lorensen & Cline '87)
is usually copied verbatim from public listings; instead we DERIVE it:

- a cell's isosurface patch has one vertex per cut cube edge (an edge whose
  endpoints straddle the level);
- every cut edge lies on exactly 2 cube faces, and on each face the cut
  edges pair up by 2D marching-squares connectivity — unambiguous when a
  face has 2 cut edges, and resolved by a fixed, orientation-independent
  rule when it has 4 (pair the edges that share an INSIDE corner, i.e.
  "separate" the diagonal inside corners). Both cells adjacent to a face
  see the same corner pattern, so they pair the shared face identically —
  the mesh is watertight across cells by construction;
- each patch vertex then has degree exactly 2, so the cut edges decompose
  into closed loops, which we triangulate WITHOUT chords between two cut
  edges lying on a common cube face (interval DP over the loop): such a
  chord lies in the shared face plane, and the neighboring cell — whose
  loop shares that face's pair segments — could draw the very same chord,
  producing duplicated coplanar triangles and 4-use non-manifold edges
  (observed before this rule; tests/test_marching_cubes.py::
  test_ambiguous_faces_stay_watertight).

This reproduces classic marching-cubes behavior (same cut-edge vertex set,
1 triangle per 3-loop, n-2 per n-loop) without transcribing a 4096-entry
literal. `build_tables()` is deterministic; `emit_c_header()` renders it
as the C array `_native/mc_table.h` for the native extractor
(tests/test_marching_cubes.py asserts the checked-in header matches).

Corner numbering matches meshing/marching.py: n = dx*4 + dy*2 + dz.
Replaces the reference's skimage.measure.marching_cubes
(clipfusion.py:727); NaN cells are skipped by the runtime, matching the
reference's post-hoc NaN-face drop (clipfusion.py:730-731).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# corner n = dx*4 + dy*2 + dz (same as marching.py / marching.cpp)
CORNER_OFFSETS = np.array(
    [[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
     [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.int64
)

# 12 cube edges as (corner_lo, corner_hi) pairs, corners differing in one
# bit; deterministic order: z-edges, then y-edges, then x-edges.
CUBE_EDGES = []
for bit in (1, 2, 4):  # z, y, x axis bits
    for c in range(8):
        if not (c & bit):
            CUBE_EDGES.append((c, c | bit))
CUBE_EDGES = tuple(CUBE_EDGES)
_EDGE_ID = {e: i for i, e in enumerate(CUBE_EDGES)}

# 6 faces: (fixed bit, fixed value) -> 4 corners in cyclic order. The two
# free bits (u, v) walk (0,0) (0,1) (1,1) (1,0) around the face.
_FACES = []
for bit in (1, 2, 4):
    u, v = [b for b in (1, 2, 4) if b != bit]
    for val in (0, bit):
        cyc = [val, val | u, val | u | v, val | v]
        _FACES.append(tuple(cyc))
_FACES = tuple(_FACES)


def _case_loops(inside_mask: int):
    """Closed vertex loops (lists of cube-edge ids) for one corner config."""
    inside = [(inside_mask >> c) & 1 for c in range(8)]
    cut = {
        i for i, (a, b) in enumerate(CUBE_EDGES) if inside[a] != inside[b]
    }
    if not cut:
        return []

    # pair cut edges per face
    partners = {e: [] for e in cut}
    for cyc in _FACES:
        # face edges in cyclic order; face edge k connects corners
        # cyc[k], cyc[(k+1)%4]
        fedges = []
        for k in range(4):
            a, b = cyc[k], cyc[(k + 1) % 4]
            fedges.append(_EDGE_ID[(min(a, b), max(a, b))])
        fcut = [k for k in range(4) if fedges[k] in cut]
        if not fcut:
            continue
        if len(fcut) == 2:
            pairs = [(fedges[fcut[0]], fedges[fcut[1]])]
        else:  # 4 cut edges: ambiguous face; pair around INSIDE corners
            pairs = []
            for k in range(4):
                shared = cyc[(k + 1) % 4]  # corner between face edge k, k+1
                if inside[shared]:
                    pairs.append((fedges[k], fedges[(k + 1) % 4]))
            assert len(pairs) == 2, inside_mask
        for a, b in pairs:
            partners[a].append(b)
            partners[b].append(a)

    for e, p in partners.items():
        assert len(p) == 2, (inside_mask, e, p)

    loops = []
    seen = set()
    for start in sorted(cut):
        if start in seen:
            continue
        loop = [start]
        seen.add(start)
        prev, cur = None, start
        while True:
            a, b = partners[cur]
            nxt = b if a == prev else a
            if nxt == start:
                break
            loop.append(nxt)
            seen.add(nxt)
            prev, cur = cur, nxt
        loops.append(loop)
    return loops


# faces (as frozensets of edge ids they contain) for the chord rule
def _edge_faces():
    faces_of_edge = {i: set() for i in range(12)}
    for fi, cyc in enumerate(_FACES):
        for k in range(4):
            a, b = cyc[k], cyc[(k + 1) % 4]
            faces_of_edge[_EDGE_ID[(min(a, b), max(a, b))]].add(fi)
    return faces_of_edge


_FACES_OF_EDGE = _edge_faces()


def _triangulate_loop(loop):
    """Triangulate one closed loop of cut-edge ids using only chords whose
    two cut edges share NO cube face (see module docstring). Interval DP;
    every non-trivial config admits such a triangulation (asserted over
    all 256 cases at table build)."""
    n = len(loop)
    if n == 3:
        return [(loop[0], loop[1], loop[2])]

    def chord_ok(i, j):
        # loop edges (consecutive) are patch boundary, always usable
        if (j - i) % n in (1, n - 1):
            return True
        return not (_FACES_OF_EDGE[loop[i]] & _FACES_OF_EDGE[loop[j]])

    from functools import lru_cache as _lru

    @_lru(maxsize=None)
    def solve(i, j):
        """Triangles covering the polygon fan i..j (indices into loop,
        i<j), assuming segment (i, j) is usable; None if impossible."""
        if j - i < 2:
            return []
        for k in range(i + 1, j):
            if not (chord_ok(i, k) and chord_ok(k, j)):
                continue
            left = solve(i, k)
            if left is None:
                continue
            right = solve(k, j)
            if right is None:
                continue
            return left + [(loop[i], loop[k], loop[j])] + right
        return None

    tris = solve(0, n - 1)
    assert tris is not None, f"no face-safe triangulation for loop {loop}"
    return tris


@lru_cache(maxsize=1)
def build_tables():
    """-> (tri_table, max_tris): tri_table[case] is a tuple of (e0, e1, e2)
    cube-edge-id triangles (face-safe loop triangulations)."""
    table = []
    max_tris = 0
    for mask in range(256):
        tris = []
        for loop in _case_loops(mask):
            tris.extend(_triangulate_loop(loop))
        table.append(tuple(tris))
        max_tris = max(max_tris, len(tris))
    return tuple(table), max_tris


def emit_c_header() -> str:
    """Render the table as a C header (flat int8 array, -1 padded), consumed
    by _native/marching.cpp's mc_extract."""
    table, max_tris = build_tables()
    width = 3 * max_tris + 1  # -1 terminator slot
    lines = [
        "// GENERATED by spatially_aware_ai_tpu/meshing/mc_tables.py"
        " — do not edit.",
        "// tri table: per 256 corner configs, cube-edge-id triples,"
        " -1 terminated.",
        f"#define MC_TABLE_WIDTH {width}",
        "static const signed char MC_TRI_TABLE[256][MC_TABLE_WIDTH] = {",
    ]
    for mask in range(256):
        flat = [e for tri in table[mask] for e in tri]
        flat += [-1] * (width - len(flat))
        lines.append("    {" + ", ".join(str(v) for v in flat) + "},")
    lines.append("};")
    lines.append("")
    lines.append("// cube edges as (corner_lo, corner_hi),"
                 " corner n = dx*4 + dy*2 + dz")
    lines.append("static const int MC_EDGES[12][2] = {")
    lines.append("    " + ", ".join(
        "{%d, %d}" % e for e in CUBE_EDGES) + ",")
    lines.append("};")
    lines.append("")
    return "\n".join(lines)
