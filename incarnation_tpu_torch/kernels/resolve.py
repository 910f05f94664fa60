"""GBuffer material resolve (port of incarnation_tpu/kernels/resolve.py,
exact path only: trilinear stack fetch, no stochastic taps, no chunk
compaction).

The raster kernel's 16 interpolated channels (u, v, world normal, world
tangent, sign, material id, analytic UV derivatives) drive one material
stack fetch per pixel; world position is reconstructed from depth.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import mathutils as mu
from ..scene import textures as tex_mod


@dataclasses.dataclass
class GBuffer:
    base_color: torch.Tensor   # (H, W, 4) rgb + opacity
    normals: torch.Tensor      # (H, W, 2) octahedral world normal
    mrao: torch.Tensor         # (H, W, 4) metallic, roughness, ao, aoblend
    emissive: torch.Tensor     # (H, W, 3) (already x20000)
    mask: torch.Tensor         # (H, W) bool geometry coverage
    world_pos: torch.Tensor    # (H, W, 3) reconstructed from depth
    uv: torch.Tensor           # (H, W, 2)
    extras: torch.Tensor       # (H, W, 3) transmission, clearcoat, ccrough


def world_from_depth(depth, inv_view_proj, width: int, height: int):
    """World position from reverse-Z depth (ref: sky-lighting.hlsl:66-77)."""
    xs, ys = mu.pixel_centers(depth.shape[0], depth.shape[1], depth.device)
    ndc = torch.stack([2.0 * xs / width - 1.0, -2.0 * ys / height + 1.0,
                       depth, torch.ones_like(depth)], dim=-1)
    wp = torch.matmul(ndc, inv_view_proj)
    return wp[..., :3] / torch.where(torch.abs(wp[..., 3:]) > 1e-20,
                                     wp[..., 3:], 1.0)


def _interp_lod(scene, mat_id, interp):
    """Mip level from the analytic UV screen derivatives."""
    meta = tex_mod.stack_meta_lookup(scene.mat_stack, mat_id)
    size_f = meta[..., 1].to(torch.float32)
    dudx, dudy, dvdx, dvdy = interp[10], interp[11], interp[12], interp[13]
    rho = torch.maximum(torch.sqrt(dudx * dudx + dvdx * dvdx),
                        torch.sqrt(dudy * dudy + dvdy * dvdy)) * size_f
    return torch.log2(torch.clamp(rho, min=1e-8))


def _pixel_noise(shape, device, row0: int = 0):
    """Per-pixel uniform in [0, 1): the JAX _frame_noise uint32 hash at
    frame 0 (the exact path never dithers by frame), in int64 arithmetic
    reduced modulo 2^32. row0: the first row's index in the whole frame
    (a band of a sharded frame hashes whole-frame rows)."""
    m32 = 0xFFFFFFFF
    xs = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    ys = torch.arange(row0, row0 + shape[0], dtype=torch.int64,
                      device=device)[:, None]
    h = (xs * 374761393 + ys * 668265263) & m32
    h = ((h ^ (h >> 13)) * 1274126177) & m32
    return ((h >> 16) & 0xFFFF).to(torch.float32) / 65536.0


def masked_alpha(scene, tri, interp, row0: int = 0):
    """Per-pixel opacity + pass threshold for a masked layer: MASK prims
    clip at alphaCutoff; BLEND prims get the screen-door threshold
    (resolve.py:107-181, exact path), hashed from the pixel's position in
    the whole frame (row0: the first row's). Fragment survives iff alpha
    >= thresh."""
    mat_id = interp[9].to(torch.int32)
    uv = torch.stack([interp[0], interp[1]], dim=-1)
    lod = _interp_lod(scene, mat_id, interp)
    # no coarser than half an amask cell (the in-race reject bound)
    meta = tex_mod.stack_meta_lookup(scene.mat_stack, mat_id)
    lod_max = torch.log2(torch.clamp(
        meta[..., 1].to(torch.float32) / (2.0 * tex_mod.AMASK_CELLS),
        min=1.0))
    lod = torch.minimum(lod, lod_max)
    a_tex = tex_mod.sample_stack_alpha(scene.mat_stack, mat_id, uv, lod=lod)
    fac = mu.gather_rows(scene.mat_params, mat_id)
    alpha = fac[..., 6] * a_tex
    blend_noise = _pixel_noise(tri.shape, tri.device, row0)
    thresh = torch.where(fac[..., 12] >= 2.0,
                         torch.clamp(blend_noise, min=1e-3), fac[..., 11])
    return alpha, thresh


def resolve_gbuffer(tri, depth, scene, interp, inv_view_proj,
                    width: int, height: int, return_normal3: bool = False):
    """tri (H, W) i32 (-1 = background), interp (16, H, W) -> GBuffer
    (resolve.py:242-376, exact trilinear path)."""
    mask = tri >= 0
    uv = torch.stack([interp[0], interp[1]], dim=-1)
    wn = torch.stack([interp[2], interp[3], interp[4]], dim=-1)
    wt = torch.stack([interp[5], interp[6], interp[7]], dim=-1)
    sign = interp[8][..., None]
    mat_id = interp[9].to(torch.int32)

    n = mu.normalize(wn)
    t = mu.normalize(wt)
    b = mu.normalize(torch.cross(n, t, dim=-1) * sign)

    lod = _interp_lod(scene, mat_id, interp)
    chans = tex_mod.sample_material_stack(scene.mat_stack, mat_id, uv,
                                          lod=lod, trilinear=True)
    tx = tex_mod.decode_stack_channels(chans)
    fac = mu.gather_rows(scene.mat_params, mat_id)

    base_color = fac[..., 3:6] * tx["base_rgb"]
    opacity = fac[..., 6] * tx["opacity"]
    emissive = fac[..., 0:3] * tx["emissive_rgb"]
    metallic = fac[..., 7] * tx["metallic"]
    roughness = fac[..., 8] * tx["roughness"]
    ao = tx["ao"]
    ao_blend = fac[..., 9]

    nxy = tx["normal_xy"] * fac[..., 10:11]
    nz = torch.sqrt(torch.clamp(1.0 - torch.sum(nxy * nxy, -1), min=1e-6))
    n_mapped = mu.normalize(nxy[..., 0:1] * t + nxy[..., 1:2] * b
                            + nz[..., None] * n)

    wp = world_from_depth(depth, inv_view_proj, width, height)
    m = mask[..., None]
    gb = GBuffer(
        base_color=torch.where(
            m, torch.cat([base_color, opacity[..., None]], -1), 0.0),
        normals=torch.where(m, mu.oct_encode(n_mapped), 0.0),
        mrao=torch.where(m, torch.stack(
            [metallic, roughness, ao, ao_blend], -1), 0.0),
        emissive=torch.where(m, emissive * 20000.0, 0.0),
        mask=mask,
        world_pos=torch.where(m, wp, 0.0),
        uv=uv,
        extras=torch.where(m, torch.stack(
            [fac[..., 13] * tx["transmission"],
             fac[..., 14] * tx["clearcoat"], fac[..., 15]], -1), 0.0),
    )
    if return_normal3:
        return gb, torch.where(m, n_mapped, 0.0)
    return gb


def vertex_world_attributes(scene, scene_rotation):
    """Per-vertex world-space normals and tangents (V, 3) each. Like the
    reference (gbuffer-compute.hlsl:238-241), normals go through the 3x3 of
    the local-to-world transform, without the inverse transpose."""
    rot = scene.mesh_transforms[:, :3, :3] @ scene_rotation[:3, :3]
    r = rot[scene.vtx_mesh.long()]                       # (V, 3, 3)

    def apply(x):
        return (x[:, 0:1] * r[:, 0] + x[:, 1:2] * r[:, 1]
                + x[:, 2:3] * r[:, 2])

    return apply(scene.normals), apply(scene.tangents[:, :3])
