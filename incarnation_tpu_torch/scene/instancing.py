"""Scene replication: tile a packed scene into a grid of instances (port of
incarnation_tpu/scene/instancing.py).

Used to build large benchmark scenes from a small one and to exercise the
multi-mesh transform paths. Equivalent to loading a glTF whose nodes
reference the same mesh k times (ref: src/scene.cpp LoadNode handles shared
meshes the same way).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import loader as loader_mod
from .loader import Scene


def replicate_scene(scene: Scene, offsets: np.ndarray) -> Scene:
    """offsets: (k, 3) world-space translations; instance i gets
    transform @ translate(o_i). The tables are replicated on the host and
    the result lands on the device the scene lives on; the material stack
    and the lights are shared, not replicated."""
    offsets = np.asarray(offsets, np.float32)
    k = offsets.shape[0]
    m = scene.meta
    v, t, p = m.padded_vertices, m.padded_triangles, m.padded_primitives
    a, _ = loader_mod.scene_arrays(scene)
    nm = a["mesh_transforms"].shape[0]
    n_meshlets = a["meshlet_bsphere"].shape[0]

    def rep(name, stride=0):
        return np.concatenate([a[name] + i * stride for i in range(k)],
                              axis=0)

    def rep_ids(name, stride):
        """Replicated ids with -1 (padding) kept."""
        return np.concatenate(
            [np.where(a[name] >= 0, a[name] + i * stride, -1)
             for i in range(k)])

    xfs = []
    for i in range(k):
        tr = np.eye(4, dtype=np.float32)
        tr[3, :3] = offsets[i]
        xfs.append(np.einsum("mij,jk->mik", a["mesh_transforms"], tr))

    out = dict(a)
    out.update(
        positions=rep("positions"), normals=rep("normals"),
        tangents=rep("tangents"), uvs=rep("uvs"),
        tri_vtx=rep("tri_vtx", stride=v),
        tri_prim=rep_ids("tri_prim", p),
        vtx_mesh=rep("vtx_mesh", stride=nm),
        tri_corner=np.concatenate([a["tri_corner"]] * k, axis=1),
        tri_mesh=rep("tri_mesh", stride=nm),
        prim_mesh=rep("prim_mesh", stride=nm),
        prim_material=rep("prim_material"),
        prim_tri_offset=rep("prim_tri_offset", stride=t),
        prim_tri_count=rep("prim_tri_count"),
        prim_bsphere=rep("prim_bsphere"),
        tri_meshlet=rep_ids("tri_meshlet", n_meshlets),
        meshlet_bsphere=rep("meshlet_bsphere"),
        meshlet_mesh=rep("meshlet_mesh", stride=nm),
        meshlet_prim=rep("meshlet_prim", stride=p),
        prim_double_sided=rep("prim_double_sided"),
        prim_is_decal=rep("prim_is_decal"),
        prim_alpha_mode=rep("prim_alpha_mode"),
        mesh_transforms=np.concatenate(xfs, axis=0),
        mesh_visible=rep("mesh_visible"))
    meta = dataclasses.replace(
        m, num_vertices=k * v, num_triangles=k * t, num_primitives=k * p,
        num_meshes=k * nm, padded_vertices=k * v, padded_triangles=k * t,
        padded_primitives=k * p)
    return loader_mod.scene_from_arrays(out, meta, scene.tri_prim.device)


def grid_offsets(nx: int, nz: int, spacing: float) -> np.ndarray:
    xs = (np.arange(nx) - (nx - 1) / 2.0) * spacing
    zs = (np.arange(nz) - (nz - 1) / 2.0) * spacing
    g = np.stack(np.meshgrid(xs, zs, indexing="ij"), axis=-1).reshape(-1, 2)
    return np.stack([g[:, 0], np.zeros(len(g)), g[:, 1]],
                    axis=-1).astype(np.float32)
