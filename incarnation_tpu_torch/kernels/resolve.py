"""GBuffer material resolve (port of incarnation_tpu/kernels/resolve.py,
exact path only: trilinear stack fetch, no stochastic taps, no chunk
compaction).

The raster kernel's 16 interpolated channels (u, v, world normal, world
tangent, sign, material id, analytic UV derivatives) drive one material
stack fetch per pixel; world position is reconstructed from depth.

resolve_gbuffer is K5 and masked_alpha K6 (csrc/resolve.cu) on CUDA
tensors; on CPU tensors each runs its plain twin (resolve_gbuffer_plain,
masked_alpha_plain), the torch code the kernels were written from.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .build import Kernel, ptr
from ..core import mathutils as mu
from ..scene import textures as tex_mod

_P, _I = ctypes.c_void_p, ctypes.c_int
# tri, depth, interp, inv_view_proj, flat, n_flat, extra, n_extra, meta,
# n_meta, mat_params, n_params, then the outputs base_color, normals, mrao,
# emissive, mask, world_pos, uv, extras, n3 (NULL: none), width, height
K5 = Kernel("resolve", "k5_resolve",
            [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I] + [_P] * 9
            + [_I, _I])
# interp, meta, n_meta, mat_params, n_params, alpha mirror, n_alpha,
# alpha out, thresh out, width, height, row0
K6 = Kernel("resolve", "k6_masked_alpha",
            [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I])


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


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name}: need a contiguous {dtype} tensor of "
                         f"shape {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_tables(scene, dev, alpha: bool):
    """Raises unless the material tables K6 (alpha) or K5 reads are
    contiguous, non-empty rows of their width on dev."""
    st = scene.mat_stack
    tables = [("mat_stack.meta", st.meta, torch.int32, 6),
              ("mat_params", scene.mat_params, torch.float32, 16)]
    tables += ([("mat_stack.alpha", st.alpha, torch.int32, 4)] if alpha else
               [("mat_stack.flat", st.flat, torch.int32, 8),
                ("mat_stack.extra", st.extra, torch.int32, 6)])
    for name, t, dtype, cols in tables:
        _check(name, t, dtype, None, dev)
        if t.dim() != 2 or t.shape[1] != cols or t.shape[0] < 1:
            raise ValueError(f"{name}: need (N >= 1, {cols}) rows, got "
                             f"{tuple(t.shape)}")
    if st.flat.data_ptr() % 16:
        raise ValueError("mat_stack.flat: K5 loads its rows as 16-byte "
                         "words and needs a 16-byte aligned table")
    if not alpha and st.extra.data_ptr() % 8:
        raise ValueError("mat_stack.extra: K5 loads its 24-byte rows as "
                         "8-byte words and needs an 8-byte aligned table")


def masked_alpha(scene, tri, interp, row0: int = 0):
    """Per-pixel opacity + pass threshold for a masked layer: MASK prims
    clip at alphaCutoff; BLEND prims get the screen-door threshold
    (resolve.py:107-181, exact path), hashed from the pixel's position in
    the whole frame (row0: the first row's). Fragment survives iff alpha
    >= thresh. K6 on CUDA tensors, the twin on CPU ones."""
    if not interp.is_cuda:
        return masked_alpha_plain(scene, tri, interp, row0)
    dev = interp.device
    h, w = tri.shape
    _check("interp", interp, torch.float32, (16, h, w), dev)
    if row0 < 0:
        raise ValueError("masked_alpha: need row0 >= 0")
    _check_tables(scene, dev, alpha=True)
    st = scene.mat_stack
    alpha = torch.empty((h, w), dtype=torch.float32, device=dev)
    thresh = torch.empty((h, w), dtype=torch.float32, device=dev)
    K6(ptr(interp), ptr(st.meta), st.meta.shape[0], ptr(scene.mat_params),
       scene.mat_params.shape[0], ptr(st.alpha), st.alpha.shape[0],
       ptr(alpha), ptr(thresh), w, h, int(row0))
    return alpha, thresh


def masked_alpha_plain(scene, tri, interp, row0: int = 0):
    """K6's twin: masked_alpha in torch operations."""
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
    (resolve.py:242-376, exact trilinear path); with return_normal3 also
    the (H, W, 3) mapped world normal before its octahedral encoding. K5
    on CUDA tensors, the twin on CPU ones."""
    if not tri.is_cuda:
        return resolve_gbuffer_plain(tri, depth, scene, interp,
                                     inv_view_proj, width, height,
                                     return_normal3)
    dev = tri.device
    shape = (height, width)
    _check("tri", tri, torch.int32, shape, dev)
    _check("depth", depth, torch.float32, shape, dev)
    _check("interp", interp, torch.float32, (16,) + shape, dev)
    _check("inv_view_proj", inv_view_proj, torch.float32, (4, 4), dev)
    _check_tables(scene, dev, alpha=False)
    st = scene.mat_stack

    def out(c):
        return torch.empty(shape + (c,), dtype=torch.float32, device=dev)

    gb = GBuffer(base_color=out(4), normals=out(2), mrao=out(4),
                 emissive=out(3),
                 mask=torch.empty(shape, dtype=torch.bool, device=dev),
                 world_pos=out(3), uv=out(2), extras=out(3))
    n3 = out(3) if return_normal3 else None
    K5(ptr(tri), ptr(depth), ptr(interp), ptr(inv_view_proj), ptr(st.flat),
       st.flat.shape[0], ptr(st.extra), st.extra.shape[0], ptr(st.meta),
       st.meta.shape[0], ptr(scene.mat_params), scene.mat_params.shape[0],
       ptr(gb.base_color), ptr(gb.normals), ptr(gb.mrao), ptr(gb.emissive),
       ptr(gb.mask), ptr(gb.world_pos), ptr(gb.uv), ptr(gb.extras), ptr(n3),
       width, height)
    return (gb, n3) if return_normal3 else gb


def resolve_gbuffer_plain(tri, depth, scene, interp, inv_view_proj,
                          width: int, height: int,
                          return_normal3: bool = False):
    """K5's twin: resolve_gbuffer in torch operations."""
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
