"""Triangle-mesh export from the closed-form geometry.

Counterpart of the reference's crystal mesh introspection
(LUMICE_GetCrystalMesh, /root/reference/src/include/lumice.h:1153, backed by
the legacy mesh pipeline in src/core/geo3d.cpp). Here the closed-form
polygon faces ARE the source of truth, so mesh export is a fan
triangulation of each present face — no half-space solver needed. Used for
previews, OBJ export, and geometry debugging.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from ice_halo_sim_jax.core.geometry import CrystalGeom


class TriMesh(NamedTuple):
    vertices: np.ndarray   # [V, 3] float32
    triangles: np.ndarray  # [T, 3] int32 vertex indices, CCW outside
    face_numbers: np.ndarray  # [T] int32 source crystal face number per tri


def geom_to_mesh(geom: CrystalGeom, dedup_eps: float = 1e-6) -> TriMesh:
    """Fan-triangulate one crystal's present faces into an indexed mesh.

    Vertices shared between faces are merged within ``dedup_eps`` so the
    result is a closed 2-manifold for valid crystals (Euler characteristic
    testable via V - E + F == 2, the reference's IsClosedTriMesh gate,
    crystal.hpp:50).
    """
    face_vtx = np.asarray(geom.face_vtx)
    face_cnt = np.asarray(geom.face_vtx_cnt)
    face_present = np.asarray(geom.face_present)
    face_number = np.asarray(geom.face_number)
    if face_vtx.ndim != 3:
        raise ValueError("geom_to_mesh expects a single (unbatched) geometry")

    verts: list = []
    tris: list = []
    tri_fn: list = []

    def vid(p) -> int:
        for i, q in enumerate(verts):
            if abs(q[0] - p[0]) < dedup_eps and abs(q[1] - p[1]) < dedup_eps \
                    and abs(q[2] - p[2]) < dedup_eps:
                return i
        verts.append((float(p[0]), float(p[1]), float(p[2])))
        return len(verts) - 1

    for f in range(face_vtx.shape[0]):
        if not face_present[f] or face_cnt[f] < 3:
            continue
        ids = [vid(face_vtx[f, k]) for k in range(int(face_cnt[f]))]
        for k in range(1, len(ids) - 1):
            tris.append((ids[0], ids[k], ids[k + 1]))
            tri_fn.append(int(face_number[f]))

    return TriMesh(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        triangles=np.asarray(tris, np.int32).reshape(-1, 3),
        face_numbers=np.asarray(tri_fn, np.int32),
    )


def is_closed_tri_mesh(n_vertices: int, n_triangles: int) -> bool:
    """Euler-characteristic gate V - E + F == 2 with E = 3F/2
    (reference IsClosedTriMesh, crystal.cpp). Necessary, not sufficient."""
    if n_triangles % 2 != 0:
        return False
    e = 3 * n_triangles // 2
    return n_vertices - e + n_triangles == 2


def mesh_to_obj(mesh: TriMesh) -> str:
    """Wavefront OBJ text (1-based indices)."""
    lines = ["# ice_halo_sim_jax crystal mesh"]
    for v in mesh.vertices:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")
    for t in mesh.triangles:
        lines.append(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}")
    return "\n".join(lines) + "\n"


def crystal_mesh(shape, dedup_eps: float = 1e-6) -> TriMesh:
    """Mesh for a crystal config shape at its distribution centers (the
    deterministic preview geometry the reference GUI shows)."""
    import jax.numpy as jnp

    from ice_halo_sim_jax.config.schema import PrismShape, PyramidShape
    from ice_halo_sim_jax.core import geometry, pyramid

    if isinstance(shape, PrismShape):
        g = geometry.prism_geom(
            jnp.float32(shape.height.center),
            jnp.asarray([d.center for d in shape.face_distance], jnp.float32),
        )
    elif isinstance(shape, PyramidShape):
        g = pyramid.pyramid_geom_batch(
            jnp.asarray([shape.upper_h.center], jnp.float32),
            jnp.asarray([shape.prism_h.center], jnp.float32),
            jnp.asarray([shape.lower_h.center], jnp.float32),
            shape.wedge_angle_u,
            shape.wedge_angle_l,
            jnp.asarray([[d.center for d in shape.face_distance]], jnp.float32),
        )
        g = CrystalGeom(*(x[0] for x in g))
    else:
        raise ValueError(f"unsupported shape {type(shape)}")
    return geom_to_mesh(g, dedup_eps)


def crystal_mesh_from_json(text: str) -> TriMesh:
    """Mesh for a crystal-section JSON fragment (the C-API GetCrystalMesh
    entry, LUMICE_GetCrystalMesh lumice.h:1153): parses the same schema as
    the project file's crystal entries and meshes the shape at its
    distribution centers. An ``id`` field is optional here."""
    import json

    from ice_halo_sim_jax.config.loader import parse_crystal

    obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError("crystal JSON must be an object")
    obj = dict(obj)
    obj.setdefault("id", 1)
    cfg = parse_crystal(obj)
    return crystal_mesh(cfg.shape)
