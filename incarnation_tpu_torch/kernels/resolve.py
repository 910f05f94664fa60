"""GBuffer material resolve (port of incarnation_tpu/kernels/resolve.py).

The raster kernel's 16 interpolated channels (u, v, world normal, world
tangent, sign, material id, analytic UV derivatives) drive one material
stack fetch per pixel; world position is reconstructed from depth.

Exact path: a trilinear stack fetch. While TAA accumulates the frame may
ask for the stochastic filters (resolve.py:242-376): a dithered single mip
floor(lod + xi) (mip_dither, the frame index; with max_aniso > 1 the
footprint's minor-axis mip and the tap jittered along its major axis),
one jittered texel of that mip (uv_dither), the checkerboard half-rate
fetch (checker_parity, kernels/checker.py) and a chunk capacity (only the
first `capacity` covered 128-pixel chunks fetch). Every noise is
frame_noise, hashed from the pixel's whole-frame position (row0: a band's
first row).

resolve_gbuffer is K5 and masked_alpha K6 (csrc/resolve.cu) on CUDA
tensors, masked_peel, one masked depth peel's whole step (the alpha
test, its chunk capacity and the accumulate), K6's peel step, and
decal_step, the decal layer's whole step (its fetch under its chunk
capacity, the depth test and the composite into the GBuffer), K5's decal
role; on CPU tensors each runs its plain twin (resolve_gbuffer_plain,
masked_alpha_plain, masked_peel_plain, decal_step_plain), the torch code
the kernels were written from.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .build import Kernel, ptr, zero_scratch
from . import checker
from ..core import mathutils as mu
from ..scene import textures as tex_mod

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# tri, depth, interp, inv_view_proj, flat, n_flat, extra, n_extra, meta,
# n_meta, mat_params, n_params, then the outputs base_color, normals, mrao,
# emissive, mask, world_pos, uv, extras, n3 (NULL: none), width, height,
# then the role (R_* flags), frame index, max anisotropy, checker parity,
# row0 and the chunk keep flags (NULL: every chunk). Its variant
# k5_decal_step, the decal layer's step: d_tri, d_depth, d_interp, depth,
# the tables as above, base_color, normals, mrao and n3 (NULL: none), the
# overflow (an int64 scalar), the scratch and its words, width, height,
# role, frame index, max anisotropy, row0, chunk capacity (-1: none)
K5 = Kernel("resolve", "k5_resolve",
            [_P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I] + [_P] * 9
            + [_I, _I, _I, _I, _F, _I, _I, _P],
            variants={"k5_decal_step": [_P, _P, _P, _P, _P, _I, _P, _I, _P,
                                        _I, _P, _I] + [_P] * 6
                      + [_I, _I, _I, _I, _I, _F, _I, _I]})
# interp, meta, n_meta, mat_params, n_params, alpha mirror, n_alpha,
# alpha out, thresh out, width, height, row0, role, frame index, max
# anisotropy, chunk keep flags (NULL: every chunk). Its variant
# k6_masked_peel, one masked peel's step: m_tri, m_depth, m_interp, meta,
# n_meta, mat_params, n_params, alpha mirror, n_alpha, the accumulators
# tri, depth, interp and z_limit, the chunk overflow and the overflow
# (int64 scalars), the scratch and its words, width, height, row0, role,
# frame index, max anisotropy, chunk capacity (-1: none)
K6 = Kernel("resolve", "k6_masked_alpha",
            [_P, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _F,
             _P],
            variants={"k6_masked_peel": [_P, _P, _P, _P, _I, _P, _I, _P, _I,
                                         _P, _P, _P, _P, _P, _P, _P, _I,
                                         _I, _I, _I, _I, _I, _F, _I]})
# roles (csrc/resolve.cu): the dithered single mip, one jittered texel of
# it, the checkerboard half-rate fetch (K5, with R_JITTER)
R_DITHER, R_JITTER, R_CHECKER = 1, 2, 4
CHUNK_PX = 128

# frame_noise's channels, as the JAX package seeds them (resolve.py,
# skylight.py, shadow.py, taa.py)
N_ANISO, N_LOD, N_ALPHA_LOD = 2428444049, 2654435761, 741103597
N_JX, N_JY, N_BLEND = 1181783497, 3267000013, 1597334677


def frame_noise(shape, frame_index: int, mult: int, device, row0: int = 0):
    """(H, W) f32 uniforms in [0, 1): the JAX package's _frame_noise, a
    uint32 hash of the pixel (x, y) xor frame_index * mult (wrapped to 32
    bits), in int64 arithmetic reduced modulo 2^32; mult picks an
    independent channel. row0: the first row's index in the whole frame
    (a band of a sharded frame hashes whole-frame rows)."""
    m32 = 0xFFFFFFFF
    seed = (int(frame_index) * int(mult)) & m32
    xs = torch.arange(shape[1], dtype=torch.int64, device=device)[None, :]
    ys = torch.arange(row0, row0 + shape[0], dtype=torch.int64,
                      device=device)[:, None]
    h = ((xs * 374761393 + ys * 668265263) & m32) ^ seed
    h = ((h ^ (h >> 13)) * 1274126177) & m32
    return ((h >> 16) & 0xFFFF).to(torch.float32) / 65536.0


def chunk_keep(active, capacity: int):
    """(H*W/128,) bool: the 128-pixel chunks of the flat image that fetch
    under a chunk capacity, the first `capacity` chunks holding an active
    pixel, in flat order (JAX _chunk_compact's nonzero(size=capacity));
    a rank by cumsum, no host sync."""
    h, w = active.shape
    if (h * w) % CHUNK_PX:
        raise ValueError("a chunk capacity needs H * W % 128 == 0")
    any_ = active.reshape(-1, CHUNK_PX).any(1)
    return any_ & (torch.cumsum(any_, 0) <= capacity)


def chunk_overflow(active, capacity: int):
    """0-dim int: how many chunks with an active pixel exceed `capacity`
    (resolve.py chunk_overflow)."""
    n = active.reshape(-1, CHUNK_PX).any(1).sum()
    return torch.clamp(n - capacity, min=0)


def _keep_pixels(keep, shape):
    """(H, W) bool of chunk_keep's flags."""
    return keep[:, None].expand(-1, CHUNK_PX).reshape(shape)


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


def _interp_lod_aniso(scene, mat_id, interp, max_aniso: float):
    """(lod, major): the mip of the footprint's minor axis, clamped so the
    implied tap count stays at most max_aniso, and the (..., 2) uv per
    pixel of its major axis, along which the single tap is jittered
    (resolve.py _interp_lod_aniso)."""
    meta = tex_mod.stack_meta_lookup(scene.mat_stack, mat_id)
    size_f = meta[..., 1].to(torch.float32)
    dudx, dudy, dvdx, dvdy = interp[10], interp[11], interp[12], interp[13]
    rx = torch.sqrt(dudx * dudx + dvdx * dvdx)
    ry = torch.sqrt(dudy * dudy + dvdy * dvdy)
    rmax = torch.maximum(rx, ry)
    rmin = torch.minimum(rx, ry)
    rho = torch.maximum(rmin, rmax / max_aniso) * size_f
    lod = torch.log2(torch.clamp(rho, min=1e-8))
    x_major = rx >= ry
    major = torch.stack([torch.where(x_major, dudx, dudy),
                         torch.where(x_major, dvdx, dvdy)], dim=-1)
    return lod, major


def _stochastic_lod(scene, mat_id, interp, uv, frame, max_aniso, lod_mult,
                    row0, half_cell=None):
    """The stochastic paths' (lod, uv): the dithered mip floor(lod + xi)
    and, with max_aniso > 1, the minor-axis mip and uv moved along the
    major axis by (xi' - 0.5) (its step clamped to +-half_cell where
    given, the alpha test's)."""
    shape, dev = mat_id.shape, mat_id.device
    if max_aniso > 1.0:
        lod, major = _interp_lod_aniso(scene, mat_id, interp, max_aniso)
        xi = frame_noise(shape, frame, N_ANISO, dev, row0)
        if half_cell is not None:
            major = torch.clamp(major, -half_cell, half_cell)
        uv = uv + major * (xi - 0.5)[..., None]
    else:
        lod = _interp_lod(scene, mat_id, interp)
    lod = torch.floor(lod + frame_noise(shape, frame, lod_mult, dev, row0))
    return lod, uv


def _texel_jitter(shape, frame, device, row0):
    """(H, W, 2) uniforms of the one-texel fetch (uv_dither)."""
    return torch.stack([frame_noise(shape, frame, N_JX, device, row0),
                        frame_noise(shape, frame, N_JY, device, row0)], -1)


def _role(mip_dither, uv_dither, checker_on=False) -> int:
    if mip_dither is None:
        return 0
    return R_DITHER | (R_JITTER if uv_dither else 0) \
        | (R_CHECKER if checker_on else 0)


def role_name(role: int, chunks: bool) -> str:
    """A K5 / K6 launch's role, the name its launches count under."""
    name = ("exact" if not role & R_DITHER else
            "dither" if not role & R_JITTER else
            "jitter_checker" if role & R_CHECKER else "jitter")
    return name + ("+chunks" if chunks else "")


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


def masked_alpha(scene, tri, interp, row0: int = 0, mip_dither=None,
                 uv_dither: bool = False, max_aniso: float = 16.0,
                 coverage_capacity=None):
    """Per-pixel opacity + pass threshold for a masked layer: MASK prims
    clip at alphaCutoff; BLEND prims get the screen-door threshold, hashed
    from the pixel's position in the whole frame (row0: the first row's)
    and seeded by the frame index where mip_dither gives one
    (resolve.py:107-181). mip_dither / uv_dither / max_aniso: the
    stochastic mip and texel, the mip capped at half an amask cell and
    the major-axis step at half a cell's uv. coverage_capacity: only the
    first that many covered chunks fetch, the others read alpha 1.0.
    Fragment survives iff alpha >= thresh. K6 on CUDA tensors, the twin on
    CPU ones."""
    if not interp.is_cuda:
        return masked_alpha_plain(scene, tri, interp, row0, mip_dither,
                                  uv_dither, max_aniso, coverage_capacity)
    dev = interp.device
    h, w = tri.shape
    _check("interp", interp, torch.float32, (16, h, w), dev)
    if row0 < 0:
        raise ValueError("masked_alpha: need row0 >= 0")
    _check_tables(scene, dev, alpha=True)
    st = scene.mat_stack
    keep = None
    if coverage_capacity is not None:
        keep = chunk_keep(tri >= 0, coverage_capacity).to(torch.uint8)
    role = _role(mip_dither, uv_dither)
    alpha = torch.empty((h, w), dtype=torch.float32, device=dev)
    thresh = torch.empty((h, w), dtype=torch.float32, device=dev)
    K6(ptr(interp), ptr(st.meta), st.meta.shape[0], ptr(scene.mat_params),
       scene.mat_params.shape[0], ptr(st.alpha), st.alpha.shape[0],
       ptr(alpha), ptr(thresh), w, h, int(row0), role,
       int(mip_dither or 0), float(max_aniso), ptr(keep),
       name=role_name(role, keep is not None))
    return alpha, thresh


def masked_alpha_plain(scene, tri, interp, row0: int = 0, mip_dither=None,
                       uv_dither: bool = False, max_aniso: float = 16.0,
                       coverage_capacity=None):
    """K6's twin: masked_alpha in torch operations."""
    mat_id = interp[9].to(torch.int32)
    uv = torch.stack([interp[0], interp[1]], dim=-1)
    jitter = None
    if mip_dither is not None:
        lod, uv = _stochastic_lod(
            scene, mat_id, interp, uv, mip_dither, max_aniso, N_ALPHA_LOD,
            row0, half_cell=0.5 / tex_mod.AMASK_CELLS)
        if uv_dither:
            jitter = _texel_jitter(tri.shape, mip_dither, tri.device, row0)
    else:
        lod = _interp_lod(scene, mat_id, interp)
    # no coarser than half an amask cell (the in-race reject bound)
    meta = tex_mod.stack_meta_lookup(scene.mat_stack, mat_id)
    lod_max = torch.log2(torch.clamp(
        meta[..., 1].to(torch.float32) / (2.0 * tex_mod.AMASK_CELLS),
        min=1.0))
    lod = torch.minimum(lod, lod_max)
    a_tex = tex_mod.sample_stack_alpha(scene.mat_stack, mat_id, uv, lod=lod,
                                       jitter=jitter)
    if coverage_capacity is not None:
        keep = _keep_pixels(chunk_keep(tri >= 0, coverage_capacity),
                            tri.shape)
        a_tex = torch.where(keep, a_tex, 1.0)
    fac = mu.gather_rows(scene.mat_params, mat_id)
    alpha = fac[..., 6] * a_tex
    blend_noise = frame_noise(tri.shape, mip_dither or 0, N_BLEND,
                              tri.device, row0)
    thresh = torch.where(fac[..., 12] >= 2.0,
                         torch.clamp(blend_noise, min=1e-3), fac[..., 11])
    return alpha, thresh


@dataclasses.dataclass
class PeelState:
    """The masked depth peels' accumulators (renderer/frame.py): the first
    fragment whose alpha test passed, per pixel, and what the next peel
    needs."""
    tri: torch.Tensor             # (H, W) i32, -1 where none passed yet
    depth: torch.Tensor           # (H, W)
    interp: torch.Tensor          # (16, H, W)
    z_limit: torch.Tensor         # (H, W): the next peel's depth limit
    chunk_overflow: torch.Tensor  # () int64: the peels' chunk overflow, a
    #                               running max
    overflow: torch.Tensor        # () int64: the pixels the latest peel
    #                               left to the next (failed, none passed)


def peel_state(tri, depth, interp) -> PeelState:
    """The accumulators before the first peel, shaped as the opaque
    layer's tri, depth and interp: nothing passed, no depth limit (2.0),
    the counts 0."""
    counts = torch.zeros(2, dtype=torch.int64, device=tri.device)
    return PeelState(tri=torch.full_like(tri, -1),
                     depth=torch.zeros_like(depth),
                     interp=torch.zeros_like(interp),
                     z_limit=torch.full_like(depth, 2.0),
                     chunk_overflow=counts[0], overflow=counts[1])


# K6's peel-step scratch per (device, stream), which K5's decal step
# shares: int64 words each kernel leaves zero (csrc/resolve.cu
# k6_peel_kernel, k5_decal_kernel): the ticket, the finished blocks, the
# two sums, then a look-back word a block of K6_BLOCK_PX pixels
# (build.zero_scratch).
_K6_STATE_WORDS = 4
K6_BLOCK_PX = 8 * CHUNK_PX          # csrc/resolve.cu K6_WARPS chunks
_K6_SCRATCH: dict = {}


def _k6_scratch(dev, pixels: int):
    """K6's peel-step scratch for a layer of `pixels` pixels."""
    return zero_scratch(_K6_SCRATCH, dev,
                        _K6_STATE_WORDS + -(-pixels // K6_BLOCK_PX),
                        torch.int64)


def masked_peel(scene, m_tri, m_depth, m_interp, state: PeelState,
                row0: int = 0, mip_dither=None, uv_dither: bool = False,
                max_aniso: float = 16.0, coverage_capacity=None) -> PeelState:
    """One masked depth peel's step (renderer/frame.py's peel loop,
    frame.py:255-271 in JAX): the peel's winners (m_tri, m_depth,
    m_interp) alpha-tested as masked_alpha tests them (row0, mip_dither,
    uv_dither, max_aniso, coverage_capacity as there); a pixel whose
    fragment passes where none has passed yet takes the peel's triangle,
    depth and interp channels; one whose fragment fails there continues:
    its next z_limit is the fragment's depth, every other pixel's 0. The
    chunk overflow under coverage_capacity is folded into the running
    max, and overflow counts the continuing pixels. Updates state in
    place and returns it: K6's peel step on CUDA tensors, the twin on CPU
    ones."""
    if not m_tri.is_cuda:
        return masked_peel_plain(scene, m_tri, m_depth, m_interp, state,
                                 row0, mip_dither, uv_dither, max_aniso,
                                 coverage_capacity)
    dev = m_tri.device
    h, w = m_tri.shape
    _check("m_tri", m_tri, torch.int32, (h, w), dev)
    _check("m_depth", m_depth, torch.float32, (h, w), dev)
    _check("m_interp", m_interp, torch.float32, (16, h, w), dev)
    _check("state.tri", state.tri, torch.int32, (h, w), dev)
    _check("state.depth", state.depth, torch.float32, (h, w), dev)
    _check("state.interp", state.interp, torch.float32, (16, h, w), dev)
    _check("state.z_limit", state.z_limit, torch.float32, (h, w), dev)
    _check("state.chunk_overflow", state.chunk_overflow, torch.int64, (),
           dev)
    _check("state.overflow", state.overflow, torch.int64, (), dev)
    if row0 < 0:
        raise ValueError("masked_peel: need row0 >= 0")
    if coverage_capacity is not None and ((h * w) % CHUNK_PX
                                          or coverage_capacity < 0):
        raise ValueError("a chunk capacity must be >= 0 and needs H * W "
                         "% 128 == 0")
    _check_tables(scene, dev, alpha=True)
    st = scene.mat_stack
    scratch = _k6_scratch(dev, h * w)
    role = _role(mip_dither, uv_dither)
    chunks = coverage_capacity is not None
    K6(ptr(m_tri), ptr(m_depth), ptr(m_interp), ptr(st.meta),
       st.meta.shape[0], ptr(scene.mat_params), scene.mat_params.shape[0],
       ptr(st.alpha), st.alpha.shape[0], ptr(state.tri), ptr(state.depth),
       ptr(state.interp), ptr(state.z_limit), ptr(state.chunk_overflow),
       ptr(state.overflow), ptr(scratch), scratch.numel(), w, h, int(row0),
       role, int(mip_dither or 0), float(max_aniso),
       int(coverage_capacity) if chunks else -1,
       variant="k6_masked_peel", name="step_" + role_name(role, chunks))
    return state


def masked_peel_plain(scene, m_tri, m_depth, m_interp, state: PeelState,
                      row0: int = 0, mip_dither=None, uv_dither: bool = False,
                      max_aniso: float = 16.0,
                      coverage_capacity=None) -> PeelState:
    """K6's peel step's twin: peel_plain's new state written into state,
    as the kernel writes it -> state."""
    new = peel_plain(scene, m_tri, m_depth, m_interp, state, row0,
                     mip_dither, uv_dither, max_aniso, coverage_capacity)
    for f in dataclasses.fields(state):
        getattr(state, f.name).copy_(getattr(new, f.name))
    return state


def peel_plain(scene, m_tri, m_depth, m_interp, state: PeelState,
               row0: int = 0, mip_dither=None, uv_dither: bool = False,
               max_aniso: float = 16.0,
               coverage_capacity=None) -> PeelState:
    """The peel loop's torch code (JAX frame.py:255-271), its alpha test
    through masked_alpha: a new state, the one given left as it was."""
    alpha, thresh = masked_alpha(
        scene, m_tri, m_interp, row0, mip_dither=mip_dither,
        uv_dither=uv_dither, max_aniso=max_aniso,
        coverage_capacity=coverage_capacity)
    chunk_over = state.chunk_overflow
    if coverage_capacity is not None:
        chunk_over = torch.maximum(
            chunk_over, chunk_overflow(m_tri >= 0, coverage_capacity))
    hit = m_tri >= 0
    passed = hit & (alpha >= thresh)
    newly = passed & (state.tri < 0)
    acc_tri = torch.where(newly, m_tri, state.tri)
    acc_depth = torch.where(newly, m_depth, state.depth)
    acc_interp = torch.where(newly[None], m_interp, state.interp)
    cont = hit & ~passed & (acc_tri < 0)
    return PeelState(tri=acc_tri, depth=acc_depth, interp=acc_interp,
                     z_limit=torch.where(cont, m_depth, 0.0),
                     chunk_overflow=chunk_over, overflow=cont.sum())


def resolve_gbuffer(tri, depth, scene, interp, inv_view_proj,
                    width: int, height: int, return_normal3: bool = False,
                    mip_dither=None, uv_dither: bool = False,
                    max_aniso: float = 16.0, coverage_capacity=None,
                    checker_parity=None, row0: int = 0):
    """tri (H, W) i32 (-1 = background), interp (16, H, W) -> GBuffer
    (resolve.py:242-376); with return_normal3 also the (H, W, 3) mapped
    world normal before its octahedral encoding. Exact trilinear fetch,
    or with mip_dither (the frame index) the stochastic single mip, with
    uv_dither one jittered texel of it, with checker_parity (and
    uv_dither, an even width) the checkerboard half-rate fetch, with
    coverage_capacity only the first that many covered chunks fetch (the
    others read zero channels). row0: the first row's index in the whole
    frame, for the noise and the parity. K5 on CUDA tensors, the twin on
    CPU ones."""
    if not tri.is_cuda:
        return resolve_gbuffer_plain(tri, depth, scene, interp,
                                     inv_view_proj, width, height,
                                     return_normal3, mip_dither, uv_dither,
                                     max_aniso, coverage_capacity,
                                     checker_parity, row0)
    dev = tri.device
    shape = (height, width)
    _check("tri", tri, torch.int32, shape, dev)
    _check("depth", depth, torch.float32, shape, dev)
    _check("interp", interp, torch.float32, (16,) + shape, dev)
    _check("inv_view_proj", inv_view_proj, torch.float32, (4, 4), dev)
    if row0 < 0:
        raise ValueError("resolve_gbuffer: need row0 >= 0")
    _check_tables(scene, dev, alpha=False)
    st = scene.mat_stack
    keep = None
    if coverage_capacity is not None:
        keep = chunk_keep(tri >= 0, coverage_capacity).to(torch.uint8)
    role = _role(mip_dither, uv_dither, _checker_on(
        checker_parity, uv_dither, width, coverage_capacity))

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
       width, height, role, int(mip_dither or 0), float(max_aniso),
       int(checker_parity or 0) & 1, int(row0), ptr(keep),
       name=role_name(role, keep is not None))
    return (gb, n3) if return_normal3 else gb


def _checker_on(checker_parity, uv_dither, width, coverage_capacity):
    """resolve.py's condition for the checkerboard stack fetch (a chunk
    capacity takes precedence)."""
    return (coverage_capacity is None and checker_parity is not None
            and bool(uv_dither) and width % 2 == 0)


def resolve_gbuffer_plain(tri, depth, scene, interp, inv_view_proj,
                          width: int, height: int,
                          return_normal3: bool = False, mip_dither=None,
                          uv_dither: bool = False, max_aniso: float = 16.0,
                          coverage_capacity=None, checker_parity=None,
                          row0: int = 0):
    """K5's twin: resolve_gbuffer in torch operations."""
    mask = tri >= 0
    uv = torch.stack([interp[0], interp[1]], dim=-1)
    wn = torch.stack([interp[2], interp[3], interp[4]], dim=-1)
    wt = torch.stack([interp[5], interp[6], interp[7]], dim=-1)
    sign = interp[8][..., None]
    mat_id = interp[9].to(torch.int32)

    n = mu.normalize(wn)
    t = mu.normalize(wt)
    b = mu.normalize(mu.cross3(n, t) * sign)

    jitter = None
    trilinear = True
    if mip_dither is not None:
        lod, uv = _stochastic_lod(scene, mat_id, interp, uv, mip_dither,
                                  max_aniso, N_LOD, row0)
        trilinear = False
        if uv_dither:
            jitter = _texel_jitter(tri.shape, mip_dither, tri.device, row0)
    else:
        lod = _interp_lod(scene, mat_id, interp)

    def fetch(m, u, l, j):
        return tex_mod.sample_material_stack(scene.mat_stack, m, u, lod=l,
                                             trilinear=trilinear, jitter=j)

    if coverage_capacity is not None:
        keep = _keep_pixels(chunk_keep(mask, coverage_capacity), mask.shape)
        chans = torch.where(keep[..., None], fetch(mat_id, uv, lod, jitter),
                            0.0)
    elif _checker_on(checker_parity, jitter is not None, tri.shape[1],
                     None):
        cp = int(checker_parity) & 1

        def half(a):
            return checker.compact(cp, a, row0)
        chans = checker.expand(cp, fetch(half(mat_id), half(uv), half(lod),
                                         half(jitter)), row0)
    else:
        chans = fetch(mat_id, uv, lod, jitter)
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


def _oct_decode(f):
    """mathutils.oct_decode with its norm the square root of a dot3 sum,
    (x + y) + z, as K5's decal step sums it (torch's vector_norm reduces
    in its own order on the card)."""
    f = f * 2.0 - 1.0
    nz = 1.0 - torch.abs(f[..., 0]) - torch.abs(f[..., 1])
    t = torch.clamp(-nz, 0.0, 1.0)[..., None]
    nxy = f + torch.where(f >= 0.0, -t, t)
    n = torch.cat([nxy, nz[..., None]], dim=-1)
    return n / torch.sqrt(mu.dot3(n, n, keepdim=True))


def decal_step(scene, d_tri, d_depth, d_interp, depth, gb: GBuffer, n3,
               inv_view_proj, width: int, height: int,
               coverage_capacity=None, mip_dither=None,
               uv_dither: bool = False, max_aniso: float = 16.0,
               row0: int = 0):
    """The decal layer's step (renderer/frame.py; JAX frame.py:325-359):
    the decal layer (d_tri, d_depth, d_interp) resolved as
    resolve_gbuffer resolves it (coverage_capacity, mip_dither,
    uv_dither, max_aniso, row0 as there; no checkerboard), tested
    GREATER_EQUAL against the scene's depth (d_depth >= depth - 1e-5),
    and composited into gb: the base colour blended by the decal's
    opacity a, the normals and mrao replaced where a > 0.5, and n3 (the
    forward path's mapped normal; None: none) replaced there by the
    decal normal's octahedral decode. Updates gb.base_color, gb.normals,
    gb.mrao and n3 in place and returns the decal overflow, a 0-dim int64
    (chunk_overflow of the layer under the capacity, 0 without one),
    with no host sync. K5's decal step on CUDA tensors (one launch),
    the twin on CPU ones."""
    if not d_tri.is_cuda:
        return decal_step_plain(scene, d_tri, d_depth, d_interp, depth, gb,
                                n3, inv_view_proj, width, height,
                                coverage_capacity, mip_dither, uv_dither,
                                max_aniso, row0)
    dev = d_tri.device
    shape = (height, width)
    _check("d_tri", d_tri, torch.int32, shape, dev)
    _check("d_depth", d_depth, torch.float32, shape, dev)
    _check("d_interp", d_interp, torch.float32, (16,) + shape, dev)
    _check("depth", depth, torch.float32, shape, dev)
    _check("gb.base_color", gb.base_color, torch.float32, shape + (4,), dev)
    _check("gb.normals", gb.normals, torch.float32, shape + (2,), dev)
    _check("gb.mrao", gb.mrao, torch.float32, shape + (4,), dev)
    if n3 is not None:
        _check("n3", n3, torch.float32, shape + (3,), dev)
    if row0 < 0:
        raise ValueError("decal_step: need row0 >= 0")
    chunks = coverage_capacity is not None
    if chunks and ((height * width) % CHUNK_PX or coverage_capacity < 0):
        raise ValueError("a chunk capacity must be >= 0 and needs H * W "
                         "% 128 == 0")
    _check_tables(scene, dev, alpha=False)
    st = scene.mat_stack
    scratch = _k6_scratch(dev, height * width)
    overflow = torch.empty((), dtype=torch.int64, device=dev)
    role = _role(mip_dither, uv_dither)
    K5(ptr(d_tri), ptr(d_depth), ptr(d_interp), ptr(depth), ptr(st.flat),
       st.flat.shape[0], ptr(st.extra), st.extra.shape[0], ptr(st.meta),
       st.meta.shape[0], ptr(scene.mat_params), scene.mat_params.shape[0],
       ptr(gb.base_color), ptr(gb.normals), ptr(gb.mrao), ptr(n3),
       ptr(overflow), ptr(scratch), scratch.numel(), width, height, role,
       int(mip_dither or 0), float(max_aniso), int(row0),
       int(coverage_capacity) if chunks else -1,
       variant="k5_decal_step", name="decal_" + role_name(role, chunks))
    return overflow


def decal_step_plain(scene, d_tri, d_depth, d_interp, depth, gb: GBuffer,
                     n3, inv_view_proj, width: int, height: int,
                     coverage_capacity=None, mip_dither=None,
                     uv_dither: bool = False, max_aniso: float = 16.0,
                     row0: int = 0):
    """K5's decal step's twin: the frame's decal code in torch
    (resolve_gbuffer_plain of the layer, chunk_overflow, the composite),
    written into gb and n3 -> the overflow. Pixels the decal does not
    cover keep their values as they were (the composite's gb * 1 + 0 * 0
    would turn a -0.0 into +0.0), and so do those of a chunk past the
    capacity, whose zero channels blend nothing."""
    d_gb = resolve_gbuffer_plain(d_tri, d_depth, scene, d_interp,
                                 inv_view_proj, width, height,
                                 mip_dither=mip_dither, uv_dither=uv_dither,
                                 max_aniso=max_aniso,
                                 coverage_capacity=coverage_capacity,
                                 row0=row0)
    covers = d_gb.mask & (d_depth >= depth - 1e-5)
    if coverage_capacity is not None:
        overflow = chunk_overflow(d_gb.mask, coverage_capacity)
        covers &= _keep_pixels(chunk_keep(d_gb.mask, coverage_capacity),
                               covers.shape)
    else:
        overflow = torch.zeros((), dtype=torch.int64, device=d_tri.device)
    a = torch.where(covers, d_gb.base_color[..., 3], 0.0)[..., None]
    opaque = a > 0.5
    rgb = gb.base_color[..., :3]
    rgb.copy_(torch.where(covers[..., None],
                          rgb * (1 - a) + d_gb.base_color[..., :3] * a, rgb))
    gb.normals.copy_(torch.where(opaque, d_gb.normals, gb.normals))
    gb.mrao.copy_(torch.where(opaque, d_gb.mrao, gb.mrao))
    if n3 is not None:
        n3.copy_(torch.where(opaque, _oct_decode(d_gb.normals), n3))
    return overflow


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
