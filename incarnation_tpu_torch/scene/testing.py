"""Synthetic scene construction for tests, smoke runs and examples (port of
incarnation_tpu/scene/testing.py).

Everything is assembled on the host with numpy and moved to `device` by
loader.scene_from_arrays (None = the CUDA card). Material tables, texture
stacks and light tables are the host forms of the port's scene modules:
the dicts of materials.build_material_table, textures.make_material_stack
and lights.light_arrays.
"""

from __future__ import annotations

import numpy as np

from . import lights as lights_mod
from . import loader as loader_mod
from . import materials as materials_mod
from . import textures as textures_mod
from .loader import Scene


def neutral_material_stack(n_materials: int = 1) -> dict:
    """A 1x1 all-neutral texel per material (white base, flat normal)."""
    flat = np.tile(textures_mod._NEUTRAL_TEXEL[None], (n_materials, 1))
    meta = np.stack([
        np.arange(n_materials, dtype=np.int32),          # base
        np.ones(n_materials, np.int32),                  # size
        np.ones(n_materials, np.int32),                  # levels
        np.zeros(n_materials, np.int32),                 # address (wrap)
    ], axis=-1)
    return textures_mod.make_material_stack(flat, meta)


def _checker_rows(size: int) -> np.ndarray:
    """(size*size, 4) texel rows: white base with a checkerboard alpha."""
    ys, xs = np.mgrid[0:size, 0:size]
    a = (((xs + ys) % 2) * 255).astype(np.uint32)
    w0 = (np.uint32(0x00FFFFFF) | (a << np.uint32(24)))
    return np.stack([
        w0,
        np.full_like(w0, 0xFFFF8080),
        np.full_like(w0, 0xFFFFFFFF),
        np.full_like(w0, 0x00FFFFFF),
    ], axis=-1).reshape(-1, 4).astype(np.uint32)


def checkerboard_alpha_stack(size: int = 4) -> dict:
    """One material whose base-color texture is white with a checkerboard
    alpha (single mip), for alpha-mask/cutout tests."""
    meta = np.asarray([[0, size, 1, textures_mod.ADDRESS_CLAMP]], np.int32)
    return textures_mod.make_material_stack(_checker_rows(size), meta)


def two_material_stack(size: int = 4) -> dict:
    """Material 0: neutral 1x1; material 1: white base with checkerboard
    alpha (size x size): a real multi-material stack for frame tests."""
    flat = np.concatenate([textures_mod._NEUTRAL_TEXEL[None],
                           _checker_rows(size)]).astype(np.uint32)
    meta = np.asarray([
        [0, 1, 1, textures_mod.ADDRESS_WRAP],
        [1, size, 1, textures_mod.ADDRESS_CLAMP],
    ], np.int32)
    return textures_mod.make_material_stack(flat, meta)


class _Materials:
    """The one attribute build_material_table reads of a glTF document."""

    def __init__(self, materials):
        self.materials = materials


def default_material_table() -> dict:
    return materials_mod.build_material_table(_Materials([{}]))


def make_rich_scene(device=None, blend_quad: bool = False) -> Scene:
    """A small scene exercising every frame path under one roof: textured
    opaque floor + MASK cutout quad (depth peels) + decal quad + two
    punctual lights (clustered) + a floating blocker (shadows).
    blend_quad adds a fifth primitive, a half-transparent BLEND quad
    standing in front of the cutout (the forward path's blend layers)."""
    quads = [
        # (origin, du, dv): floor, masked screen, high blocker, decal
        ([-8, -2, 0], [16, 0, 0], [0, 0, 16]),
        ([-3, -2, 6], [6, 0, 0], [0, 6, 0]),
        ([-2, 3.5, 7], [4, 0, 0], [0, 0, 4]),
        ([1, -1.98, 4], [3, 0, 0], [0, 0, 3]),
    ]
    mat_defs = [{}, {"alphaMode": "MASK", "alphaCutoff": 0.5}]
    prim_alpha, prim_mat, decal = [0, 1, 0, 0], [0, 1, 0, 1], [0, 0, 0, 1]
    stack = two_material_stack()
    if blend_quad:
        quads.append(([-2, -1.5, 5], [4, 0, 0], [0, 3, 0]))
        mat_defs.append({"alphaMode": "BLEND", "pbrMetallicRoughness": {
            "baseColorFactor": [0.2, 0.4, 1.0, 0.5]}})
        prim_alpha.append(2)
        prim_mat.append(2)
        decal.append(0)
        size = 4
        flat = np.concatenate([textures_mod._NEUTRAL_TEXEL[None],
                               _checker_rows(size),
                               textures_mod._NEUTRAL_TEXEL[None]])
        stack = textures_mod.make_material_stack(
            flat.astype(np.uint32), np.asarray([
                [0, 1, 1, textures_mod.ADDRESS_WRAP],
                [1, size, 1, textures_mod.ADDRESS_CLAMP],
                [1 + size * size, 1, 1, textures_mod.ADDRESS_WRAP]],
                np.int32))
    pos, uv, tris = [], [], []
    for (o, du, dv) in quads:
        b = len(pos)
        o, du, dv = (np.asarray(x, np.float32) for x in (o, du, dv))
        pos += [o, o + du, o + du + dv, o + dv]
        uv += [[0, 0], [2, 0], [2, 2], [0, 2]]
        tris += [[b, b + 2, b + 1], [b, b + 3, b + 2]]
    mats = materials_mod.build_material_table(_Materials(mat_defs))
    lights = lights_mod.light_arrays(
        [{"type": "point", "color": [1.0, 0.5, 0.2], "intensity": 30.0,
          "range": 10.0},
         {"type": "spot", "color": [0.2, 0.5, 1.0], "intensity": 50.0,
          "spot": {"innerConeAngle": 0.3, "outerConeAngle": 0.7}}],
        [np.asarray([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0],
                     [0, 2, 4, 1]], np.float32),
         np.asarray([[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0],
                     [-2, 4, 8, 1]], np.float32)])
    # the fourth prim is a decal projected onto the floor
    n = len(quads)
    return make_scene(pos, tris, double_sided=True, materials=mats,
                      lights=lights, uvs=np.asarray(uv, np.float32),
                      tri_prim=np.repeat(np.arange(n), 2), num_prims=n,
                      prim_tri_offset=2 * np.arange(n),
                      prim_alpha_mode=prim_alpha, prim_material=prim_mat,
                      prim_is_decal=decal, mat_stack=stack, device=device)


def make_scene(positions, tris, normals=None, uvs=None, tangents=None,
               double_sided=False, transform=None, materials=None,
               lights=None, tri_prim=None, num_prims=1,
               prim_tri_offset=None, prim_alpha_mode=None,
               prim_material=None, prim_is_decal=None, mat_stack=None,
               device=None) -> Scene:
    """positions (V, 3), tris (T, 3) -> minimal Scene with neutral
    materials. materials: a build_material_table dict; lights: a
    light_arrays dict; mat_stack: a make_material_stack dict."""
    positions = np.asarray(positions, np.float32)
    tris = np.asarray(tris, np.int32)
    v, t = positions.shape[0], tris.shape[0]
    if normals is None:
        normals = np.tile([0, 0, -1.0], (v, 1)).astype(np.float32)
    if uvs is None:
        uvs = np.zeros((v, 2), np.float32)
    if tangents is None:
        tangents = np.tile([1, 0, 0, 1.0], (v, 1)).astype(np.float32)
    if transform is None:
        transform = np.eye(4, dtype=np.float32)
    if tri_prim is None:
        tri_prim = np.zeros((t,), np.int32)
    if prim_tri_offset is None:
        prim_tri_offset = np.zeros((num_prims,), np.int32)
    if materials is None:
        materials = default_material_table()
    if lights is None:
        lights = lights_mod.light_arrays([], [])

    p = num_prims
    if prim_alpha_mode is None:
        prim_alpha_mode = np.zeros((p,), np.int32)
    prim_alpha_mode = np.asarray(prim_alpha_mode, np.int32)
    if prim_is_decal is None:
        prim_is_decal = np.zeros((p,), np.int32)
    prim_is_decal = np.asarray(prim_is_decal, np.int32)
    tri_prim = np.asarray(tri_prim, np.int32)
    if mat_stack is None:
        mat_stack = neutral_material_stack(
            int(materials["metallic_factor"].shape[0]))
    meta = loader_mod.SceneMeta(
        num_vertices=v, num_triangles=t, num_primitives=p, num_meshes=1,
        padded_vertices=v, padded_triangles=t, padded_primitives=p,
        has_decals=bool(prim_is_decal.any()),
        num_lights=int(lights["count"]),
        has_masked=bool((prim_alpha_mode > 0).any()),
        has_blend=bool((prim_alpha_mode >= 2).any()),
        has_extras=bool(
            float(np.max(materials["transmission_factor"])) > 0.0
            or float(np.max(materials["clearcoat_factor"])) > 0.0))
    far_sphere = np.tile([0, 0, 0, 1e6], (p, 1)).astype(np.float32)
    arrays = dict(
        positions=positions,
        normals=np.asarray(normals, np.float32),
        tangents=np.asarray(tangents, np.float32),
        uvs=np.asarray(uvs, np.float32),
        tri_vtx=tris, tri_prim=tri_prim,
        vtx_mesh=np.zeros((v,), np.int32),
        tri_corner=loader_mod.triangle_corner_table(
            positions, normals, tangents, uvs, tris),
        tri_mesh=np.zeros((t,), np.int32),
        prim_mesh=np.zeros((p,), np.int32),
        prim_material=(np.zeros((p,), np.int32) if prim_material is None
                       else np.asarray(prim_material, np.int32)),
        prim_tri_offset=np.asarray(prim_tri_offset, np.int32),
        prim_tri_count=np.bincount(tri_prim, minlength=p).astype(np.int32),
        prim_bsphere=far_sphere,
        prim_double_sided=np.full((p,), int(double_sided), np.int32),
        prim_is_decal=prim_is_decal,
        prim_alpha_mode=prim_alpha_mode,
        # one meshlet per primitive (meshlets never span primitives: the
        # raster prep's fused visibility gather relies on that)
        tri_meshlet=tri_prim,
        meshlet_bsphere=far_sphere,
        meshlet_mesh=np.zeros((p,), np.int32),
        meshlet_prim=np.arange(p, dtype=np.int32),
        mesh_transforms=np.asarray(transform, np.float32)[None],
        mesh_visible=np.ones((1,), np.int32),
        mat_params=materials_mod.pack_material_params(materials),
        sun_dir=lights_mod.DEFAULT_SUN_DIR)
    arrays.update({f"mat_stack.{k}": a for k, a in mat_stack.items()})
    arrays.update({f"lights.{k}": a for k, a in lights.items()})
    return loader_mod.scene_from_arrays(arrays, meta, device)
