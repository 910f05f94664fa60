"""The raster frame (port of incarnation_tpu/renderer/frame.py).

Pass graph: frustum + meshlet cull -> triangle setup -> one layered binning
-> K1 opaque raster -> masked depth peels (K1 masked + z_limit roles) ->
gbuffer resolve -> decal layer (K1) -> light clusters -> sky IBL + sun +
clustered lights (K2) -> sky background -> forward blend layers (K1
z_limit peels, shaded and composited front to back) -> TAA (K3) -> view
mode / tonemap -> debug draws. The sun shadow map (K1's depth-only role)
is rendered once per frame before shading when sun_shadow_mode is "map".

With a scene BVH (kernels/bvh.py), sun_shadow_mode "auto" or "rt" traces
one any-hit sun ray per covered pixel (K4 on the card) in place of the
shadow map, and enable_hbao adds ray-traced AO and bent normals to the sky
lighting. sun_shadow_mode "auto" with no scene BVH means no shadows, as in
the JAX package. render_pathtrace is the second renderer: one progressive
path-traced sample per call (kernels/pathtrace.py).

render_frame runs two phases, render_hdr (everything up to the frame's
HDR) and finish_frame (TAA, view mode, tonemap, debug draws): the band
sharder (dist/sharding.py) renders every band's HDR before any band's TAA,
which reads halo rows of its neighbours' history and HDR.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import Config, EnvSkyMode, ViewMode
from ..core import mathutils as mu
from ..device import resolve_device
from ..kernels import (clustered, cull, hbao, ibl, pathtrace, post, raster,
                       resolve, shading, skylight, taa)
from ..kernels import shadow as shadow_mod
from ..scene import lights as lights_mod


@dataclasses.dataclass
class FrameConstants:
    """Per-frame constants. Matrices live on the device; the host keeps
    numpy copies of the two the TAA dispatch reads, and the host-side
    scalars."""
    view_proj: torch.Tensor       # (4, 4)
    inv_view_proj: torch.Tensor   # (4, 4)
    proj: torch.Tensor            # (4, 4)
    eye: torch.Tensor             # (3,)
    scene_rotation: torch.Tensor  # (4, 4)
    exposure: float               # EV100
    sun_dir: torch.Tensor         # (3,) toward the sun
    sun_color_intensity: torch.Tensor  # (4,) rgb + intensity (<= 0: no sun)
    sky_brightness: float
    prev_view_proj: torch.Tensor  # (4, 4)
    history_valid: bool
    frame_index: int
    inv_view_proj_np: np.ndarray  # host copies for the TAA dispatch
    prev_view_proj_np: np.ndarray
    sun_view_proj: torch.Tensor   # (4, 4) ortho sun-view VP of the shadow
    #   map (identity when make() was given no shadow_bounds)
    camera_right: torch.Tensor    # (3,) camera basis (thin-lens aperture)
    camera_up: torch.Tensor       # (3,)
    aperture: float               # path-tracer aperture
    focal_length: float           # path-tracer focal length
    inv_scene_rotation: torch.Tensor  # (4, 4): rays are inverse-rotated
    #   into the BVH's unrotated world space instead of rebuilding it
    turbidity: float

    @staticmethod
    def make(view, config: Config, sun_dir=None, sun_color_intensity=None,
             scene_rotation=None, jitter=None, prev_view_proj=None,
             history_valid=False, frame_index=0, shadow_bounds=None,
             device=None):
        """shadow_bounds: optional (center (3,), radius) world bounding
        sphere; builds the sun shadow-map projection (rotation-invariant,
        so scene_rotation needs only the center rotated)."""
        device = resolve_device(device)
        vp = view.view_proj(jitter)
        inv_vp = np.linalg.inv(vp).astype(np.float32)
        prev = np.asarray(vp if prev_view_proj is None else prev_view_proj,
                          np.float32)
        sun_np = np.asarray(
            lights_mod.DEFAULT_SUN_DIR if sun_dir is None else sun_dir,
            np.float32)
        sun_vp = np.eye(4, dtype=np.float32)
        if config.sun_shadow_mode == "map" and shadow_bounds is None:
            raise ValueError(
                "sun_shadow_mode='map' needs shadow_bounds=(center, radius): "
                "pass the SceneHost's bounds to FrameConstants.make")
        if shadow_bounds is not None:
            center, radius = shadow_bounds
            center = np.asarray(center, np.float32)
            if scene_rotation is not None:
                center = (np.append(center, 1.0)
                          @ np.asarray(scene_rotation))[:3]
            sun_vp = shadow_mod.sun_view_proj(sun_np, center, radius)

        def dev(x):
            return torch.tensor(np.asarray(x, np.float32), device=device)

        return FrameConstants(
            view_proj=dev(vp), inv_view_proj=dev(inv_vp),
            proj=dev(view.projection_transform()),
            eye=dev(view.position),
            scene_rotation=dev(np.eye(4, dtype=np.float32)
                               if scene_rotation is None else scene_rotation),
            exposure=float(config.exposure),
            sun_dir=dev(sun_np),
            sun_color_intensity=dev([1.0, 1.0, 1.0, 0.0]
                                    if sun_color_intensity is None
                                    else sun_color_intensity),
            sky_brightness=float(config.sky_brightness),
            prev_view_proj=dev(prev),
            history_valid=bool(history_valid),
            frame_index=int(frame_index),
            inv_view_proj_np=inv_vp, prev_view_proj_np=prev,
            sun_view_proj=dev(sun_vp),
            camera_right=dev(view.right), camera_up=dev(view.up),
            aperture=float(config.pathtracing_camera_aperture),
            focal_length=float(config.pathtracing_camera_focal_length),
            inv_scene_rotation=dev(np.linalg.inv(
                np.eye(4, dtype=np.float32) if scene_rotation is None
                else np.asarray(scene_rotation, np.float32))),
            turbidity=float(config.turbidity))


def render_frame(scene, fc: FrameConstants, *, config: Config,
                 params: raster.RasterParams, probe=None, env_brdf=None,
                 history=None, scene_bvh=None):
    """Full raster-path frame. probe + env_brdf enable the sky-lighting
    pass. Returns dict with 'color' (H, W, 3) uint8 sRGB, 'hdr',
    'accumulation', 'tri', 'depth', 'gbuffer' and 'stats' (tensors).
    scene_bvh: the scene's BVH, for RT sun shadows ("auto" / "rt") and
    HBAO. A band-sharded frame is dist.sharding.render_frame_sharded."""
    return finish_frame(render_hdr(scene, fc, config=config, params=params,
                                   probe=probe, env_brdf=env_brdf,
                                   scene_bvh=scene_bvh), history)


def render_hdr(scene, fc: FrameConstants, *, config: Config,
               params: raster.RasterParams, probe=None, env_brdf=None,
               scene_bvh=None, band_row: int = 0) -> dict:
    """render_frame's first phase: the frame up to its HDR (raster layers,
    gbuffer, decals, shadows, lighting, sky, blend layers). -> the state
    finish_frame takes. band_row: a band of a sharded frame (fc carrying
    its band matrix) passes its first row in the whole frame, where the
    BLEND screen-door noise starts (the single frame's noise, so the bands
    put together are the single frame)."""
    dev = scene.tri_prim.device
    prim_visible = torch.ones_like(scene.prim_is_decal, dtype=torch.bool)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    culled_prims = culled_meshlets = zero
    meshlet_visible = None
    if config.frustum_culling:
        inside, culled_prims = cull.cull_primitives(
            scene.prim_bsphere, scene.prim_mesh, scene.mesh_transforms,
            scene.mesh_visible, fc.scene_rotation, fc.view_proj)
        prim_visible &= inside
        if config.use_meshlets:
            meshlet_visible, culled_meshlets = cull.cull_primitives(
                scene.meshlet_bsphere, scene.meshlet_mesh,
                scene.mesh_transforms, scene.mesh_visible,
                fc.scene_rotation, fc.view_proj)

    prep = raster.prepare_geometry(scene, fc.scene_rotation, fc.view_proj,
                                   prim_visible, params,
                                   meshlet_visible=meshlet_visible)

    # Raster layers: 0 opaque, then masked depth peels, decals and the
    # forward path's blend layers, all binned by one sort.
    tri_ok = scene.tri_prim >= 0
    safe_prim = torch.clamp(scene.tri_prim, min=0).long()
    tri_alpha = scene.prim_alpha_mode[safe_prim]
    tri_decal = (scene.prim_is_decal[safe_prim] > 0) & tri_ok
    has_blend_layer = config.forward_lighting and scene.meta.has_blend
    if has_blend_layer:
        # Forward: BLEND prims skip the screen-door peel; they are shaded
        # per layer and alpha-composited below.
        tri_masked = (tri_alpha == 1) & tri_ok & ~tri_decal
        tri_blend = (tri_alpha >= 2) & tri_ok & ~tri_decal
    else:
        tri_masked = (tri_alpha > 0) & tri_ok & ~tri_decal
        tri_blend = None
    n_layers = 1
    masked_idx = decal_idx = blend_idx = None
    lyr = torch.zeros_like(scene.tri_prim)
    if scene.meta.has_masked:
        masked_idx = n_layers
        n_layers += 1
        lyr = torch.where(tri_masked, masked_idx, lyr)
    if scene.meta.has_decals:
        decal_idx = n_layers
        n_layers += 1
        lyr = torch.where(tri_decal, decal_idx, lyr)
    if has_blend_layer:
        blend_idx = n_layers
        n_layers += 1
        lyr = torch.where(tri_blend, blend_idx, lyr)
    layer_bins = raster.bin_triangles_layered(
        prep, params, layer=(lyr if n_layers > 1 else None),
        n_layers=n_layers)

    tri, depth, interp = raster.rasterize_tiles(layer_bins[0], params,
                                                name="raster_opaque")
    stats = dict(
        bin_overflow=layer_bins[0].overflow,
        big_overflow=sum(b.big_overflow for b in layer_bins),
        culled_triangles=torch.sum(~prep.valid),
        peel_overflow=torch.zeros((), dtype=torch.int64, device=dev))
    if scene.meta.has_masked:
        # Masked depth peels: K1 drops certainly-transparent fragments in
        # the race; each peel's winners are alpha-tested exactly, and a
        # failed test exposes the next fragment behind it (strict z_limit).
        amask_tab = scene.mat_stack.amask
        acc_tri = torch.full_like(tri, -1)
        acc_depth = torch.zeros_like(depth)
        acc_interp = torch.zeros_like(interp)
        zlim = torch.full(depth.shape, 2.0, dtype=torch.float32, device=dev)
        cont = None
        for _ in range(max(1, config.masked_depth_peels)):
            m_tri, m_depth, m_interp = raster.rasterize_tiles(
                layer_bins[masked_idx], params, z_limit=zlim,
                mask_table=amask_tab, name="raster_peel")
            alpha, thresh = resolve.masked_alpha(scene, m_tri, m_interp,
                                                 band_row)
            hit = m_tri >= 0
            passed = hit & (alpha >= thresh)
            newly = passed & (acc_tri < 0)
            acc_tri = torch.where(newly, m_tri, acc_tri)
            acc_depth = torch.where(newly, m_depth, acc_depth)
            acc_interp = torch.where(newly[None], m_interp, acc_interp)
            cont = hit & ~passed & (acc_tri < 0)
            zlim = torch.where(cont, m_depth, 0.0)
        stats["peel_overflow"] = cont.sum()
        win = (acc_tri >= 0) & (acc_depth > depth)
        tri = torch.where(win, acc_tri, tri)
        depth = torch.where(win, acc_depth, depth)
        interp = torch.where(win[None], acc_interp, interp)
    stats["culled_primitives"] = culled_prims
    stats["culled_meshlets"] = culled_meshlets

    # Forward mode shades from the exact mapped normal (no octahedral round
    # trip, ref: forward-pass.hlsl:108-114); deferred decodes the gbuffer.
    n3 = None
    if config.forward_lighting:
        gb, n3 = resolve.resolve_gbuffer(
            tri, depth, scene, interp, fc.inv_view_proj, params.width,
            params.height, return_normal3=True)
    else:
        gb = resolve.resolve_gbuffer(tri, depth, scene, interp,
                                     fc.inv_view_proj, params.width,
                                     params.height)

    if scene.meta.has_decals:
        # Decals: GREATER_EQUAL against the scene depth; base color
        # alpha-blended, normals / metal-rough replaced where opaque.
        d_tri, d_depth, d_interp = raster.rasterize_tiles(
            layer_bins[decal_idx], params, name="raster_decal")
        d_gb = resolve.resolve_gbuffer(d_tri, d_depth, scene, d_interp,
                                       fc.inv_view_proj, params.width,
                                       params.height)
        covers = d_gb.mask & (d_depth >= depth - 1e-5)
        a = torch.where(covers, d_gb.base_color[..., 3], 0.0)[..., None]
        opaque = a > 0.5
        gb = dataclasses.replace(
            gb,
            base_color=torch.cat([
                gb.base_color[..., :3] * (1 - a)
                + d_gb.base_color[..., :3] * a,
                gb.base_color[..., 3:]], -1),
            normals=torch.where(opaque, d_gb.normals, gb.normals),
            mrao=torch.where(opaque, d_gb.mrao, gb.mrao))
        if n3 is not None:
            n3 = torch.where(opaque, mu.oct_decode(d_gb.normals), n3)

    # Sun shadow map, rendered once per frame and sampled by every shaded
    # surface (the raster frame's stand-in for the reference's per-pixel
    # DXR sun shadow ray, ref: lighting/common.hlsli:91-116).
    sun_shadow_map = None
    if config.sun_shadow_mode == "map" and config.enable_direct_lighting:
        sun_shadow_map, sm_stats = shadow_mod.render_sun_shadow_map(
            scene, fc.scene_rotation, fc.sun_view_proj,
            shadow_mod.shadow_params(config.shadow_map_resolution, config))
        stats["shadow_bin_overflow"] = sm_stats["bin_overflow"]

    mask_grid = None
    if config.enable_direct_lighting and scene.meta.num_lights > 0:
        mask_grid, culled_lights = clustered.build_light_clusters(
            scene.lights, config, fc.proj, fc.inv_view_proj,
            config.camera_near_plane)
        stats["culled_lights"] = culled_lights

    n = n3 if n3 is not None else mu.oct_decode(gb.normals)
    shade = dict(config=config, params=params, probe=probe,
                 env_brdf=env_brdf, scene_bvh=scene_bvh, mask_grid=mask_grid,
                 sun_shadow_map=sun_shadow_map)
    hdr, bent_normals, v = _shade_surface(scene, gb, n, depth, fc, **shade)

    if config.env_sky_mode == EnvSkyMode.DYNAMIC_SKY:
        hdr = hdr + skylight.environment_background(
            gb.mask, fc.eye, fc.inv_view_proj, params.width, params.height,
            sun_dir=fc.sun_dir, turbidity=config.turbidity, dynamic_sky=True)
    elif probe is not None:
        hdr = hdr + skylight.environment_background(
            gb.mask, fc.eye, fc.inv_view_proj, params.width, params.height,
            probe=probe, sky_brightness=fc.sky_brightness, dynamic_sky=False)

    if has_blend_layer:
        # Forward alpha-composited BLEND layers: depth-peel the blend
        # geometry front to back (one z_limit peel per configured masked
        # layer), forward-shade each layer and under-composite radiance.
        c_acc = torch.zeros_like(hdr)
        transmit = torch.ones(hdr.shape[:2] + (1,), dtype=torch.float32,
                              device=dev)
        bzlim = torch.full(depth.shape, 2.0, dtype=torch.float32, device=dev)
        for _ in range(max(1, config.masked_depth_peels)):
            b_tri, b_depth, b_interp = raster.rasterize_tiles(
                layer_bins[blend_idx], params, z_limit=bzlim,
                name="raster_blend")
            bzlim = torch.where(b_tri >= 0, b_depth, 0.0)
            gb_b, n3_b = resolve.resolve_gbuffer(
                b_tri, b_depth, scene, b_interp, fc.inv_view_proj,
                params.width, params.height, return_normal3=True)
            hdr_b, _, _ = _shade_surface(scene, gb_b, n3_b, b_depth, fc,
                                         **shade)
            # only fragments in front of the opaque winner contribute
            # (reverse-Z: larger z = closer)
            vis_b = gb_b.mask & (b_depth > depth)
            a = torch.where(vis_b, gb_b.base_color[..., 3], 0.0)[..., None]
            c_acc = c_acc + transmit * a * hdr_b
            transmit = transmit * (1.0 - a)
        hdr = c_acc + transmit * hdr

    return dict(scene=scene, fc=fc, config=config, params=params,
                probe=probe, hdr=hdr, tri=tri, depth=depth, gb=gb, n=n, v=v,
                bent_normals=bent_normals, mask_grid=mask_grid,
                prim_visible=prim_visible, stats=stats)


def finish_frame(st: dict, history=None, hdr_halo=None) -> dict:
    """render_frame's second phase on render_hdr's state: TAA against
    `history`, the view mode, tonemap and the debug draws -> render_frame's
    dict. A band of a sharded frame passes its history with halo rows of
    its neighbours above and below, and hdr_halo, their HDR rows next to
    the band (kernels/taa.py taa_resolve)."""
    scene, fc, config, params = st["scene"], st["fc"], st["config"], \
        st["params"]
    hdr, depth, tri, gb, n = st["hdr"], st["depth"], st["tri"], st["gb"], \
        st["n"]
    stats = st["stats"]
    mask_grid = st["mask_grid"]
    dev = depth.device
    accumulation = hdr
    if config.enable_taa and history is not None:
        m_np = (fc.inv_view_proj_np.astype(np.float32)
                @ fc.prev_view_proj_np.astype(np.float32))
        accumulation = taa.taa_resolve(hdr, history, depth, m_np,
                                       fc.history_valid, params.width,
                                       params.height, hdr_halo=hdr_halo)

    color = _apply_viewmode(config, scene, gb, n, depth, tri, accumulation,
                            fc, v=st["v"], probe=st["probe"],
                            bent_normals=st["bent_normals"])
    color_u8 = post.to_uint8(color)

    # Device-appended debug draws (ref: debug-drawing/common.hlsli:33-95):
    # the cull pass's and the light culling's own results append wireframe
    # rows to a device buffer, expanded and splatted depth-tested.
    if config.show_light_bounds or config.show_object_bounds:
        from . import debugdraw
        dbuf, dcount = debugdraw.ddraw_new(device=dev)
        if config.show_light_bounds and mask_grid is not None:
            rows, rmask = debugdraw.light_bounds_rows(scene.lights,
                                                      mask_grid)
            dbuf, dcount = debugdraw.ddraw_append(dbuf, dcount, rows, rmask)
        if config.show_object_bounds:
            rows, rmask = debugdraw.object_bounds_rows(
                scene, fc.scene_rotation, st["prim_visible"])
            dbuf, dcount = debugdraw.ddraw_append(dbuf, dcount, rows, rmask)
        color_u8 = debugdraw.ddraw_render(color_u8, depth, dbuf, dcount,
                                          fc.view_proj)
        stats["debug_draws"] = dcount

    return dict(color=color_u8, hdr=hdr,
                accumulation=accumulation, tri=tri, depth=depth,
                gbuffer=gb, stats=stats)


def _shade_surface(scene, gb, n, depth, fc, *, config: Config, params,
                   probe, env_brdf, scene_bvh, mask_grid,
                   sun_shadow_map=None):
    """Emissive + sky IBL (with HBAO when asked for and a BVH is given) +
    sun (shadow-mapped or ray-traced) + clustered punctual lights, shared
    by the deferred frame, the forward frame and the forward blend layers.
    -> (hdr, bent normals or None, v)."""
    hdr = gb.emissive
    v = mu.normalize(fc.eye - gb.world_pos)
    # ray-traced HBAO and bent normals (ref: render-jobs/hbao.inl)
    ao_map = bent_normals = None
    if config.enable_hbao and scene_bvh is not None:
        ao_map, bent_oct = hbao.hbao(scene_bvh, gb, depth, fc,
                                     params.width, params.height)
        if config.use_bent_normals:
            bent_normals = mu.oct_decode(bent_oct)
    if probe is not None and config.enable_sky_lighting \
            and env_brdf is not None:
        hdr = hdr + skylight.sky_lighting(
            gb, n, v, probe, env_brdf, fc.sky_brightness,
            hbao=ao_map, bent_normals=bent_normals,
            diffuse_ibl=config.enable_diffuse_ibl,
            specular_ibl=config.enable_specular_ibl,
            lighting_only=(config.viewmode == ViewMode.LIGHTING_ONLY),
            extras=(gb.extras if scene.meta.has_extras else None),
            analytic_env_brdf=config.analytic_env_brdf)
    if config.enable_direct_lighting:
        radiance_in = shading.directional_light_radiance(
            fc.sun_color_intensity[:3], fc.sun_color_intensity[3])
        sun_vis = 1.0
        rt_shadows = (scene_bvh is not None
                      and config.sun_shadow_mode in ("auto", "rt"))
        if sun_shadow_map is not None and not rt_shadows:
            ndl = torch.sum(n * fc.sun_dir, -1)
            sun_vis = shadow_mod.sun_visibility(
                gb.world_pos, ndl, sun_shadow_map, fc.sun_view_proj,
                config.shadow_map_resolution)[..., None]
        elif rt_shadows:
            sun_vis = rt_sun_visibility(scene, scene_bvh, gb, fc)[..., None]
        has_x = scene.meta.has_extras
        sun = shading.brdf_response(
            gb.base_color[..., :3], gb.mrao[..., 0], gb.mrao[..., 1], n, v,
            fc.sun_dir, radiance_in, visibility=sun_vis,
            transmission=gb.extras[..., 0] if has_x else None,
            clearcoat=gb.extras[..., 1] if has_x else None,
            cc_roughness=gb.extras[..., 2] if has_x else None)
        hdr = hdr + torch.where(gb.mask[..., None], sun, 0.0)
    if mask_grid is not None:
        hdr = hdr + clustered.clustered_lighting(
            gb, n.contiguous(), v.contiguous(), depth.contiguous(),
            scene.lights, mask_grid, config, config.camera_near_plane,
            params.width, params.height)
    return hdr, bent_normals, v


def rt_sun_visibility(scene, scene_bvh, gb, fc):
    """(H, W) f32 sun visibility, 1 lit and 0 occluded: one any-hit ray
    toward the sun from each covered pixel (ref: lighting/common.hlsli:
    91-116; TMin 0.1, TMax 1000), alpha-tested through cutouts with the
    frame index as the BLEND noise seed, traced in the BVH's unrotated
    space. Uncovered pixels read 1."""
    inv = fc.inv_scene_rotation
    r3 = inv[:3, :3]
    mask = gb.mask.reshape(-1)
    idx = torch.nonzero(mask).squeeze(1)
    origins = gb.world_pos.reshape(-1, 3)[idx] @ r3 + inv[3, :3]
    dirs = (fc.sun_dir @ r3).expand(origins.shape)
    occ = pathtrace._trace_alpha(scene, scene_bvh, origins, dirs, 0.1,
                                 1000.0, fc.frame_index, any_hit=True,
                                 role="rt_sun")["tri"] >= 0
    vis = torch.ones(mask.shape, dtype=torch.float32, device=mask.device)
    vis[idx] = 1.0 - occ.to(torch.float32)
    return vis.reshape(gb.mask.shape)


def _apply_viewmode(config: Config, scene, gb, n, depth, tri, hdr, fc,
                    v=None, probe=None, bent_normals=None):
    """Debug visualization modes (ref: postprocess/debug-visualization.hlsl,
    inc/demo.h:7-23). -> (H, W, 3) f32 colour in [0, 1]."""
    vm = config.viewmode
    m3 = gb.mask[..., None]
    if vm == ViewMode.REFLECTIONS and v is not None and probe is not None:
        # mirror reflection of the prefiltered envmap at mip 0
        # (ref: geo-raster/forward-pass.hlsl:121-130 VIEWMODE == 7)
        r = mu.normalize(2.0 * torch.sum(n * v, -1, keepdim=True) * n - v)
        refl = ibl.sample_cube(probe.prefiltered, r) * fc.sky_brightness
        return post.tonemap(torch.where(m3, refl, hdr), fc.exposure)
    if vm == ViewMode.BENT_NORMALS:
        # bent normals x0.5+0.5 (ref: debug-visualization.hlsl:193-199);
        # the shading normal when HBAO or bent normals are off
        bn = n if bent_normals is None else bent_normals
        return torch.where(m3, bn * 0.5 + 0.5, 0.0)
    if vm == ViewMode.NAN_CHECK:
        return post.tonemap(hdr, fc.exposure, nan_check=True)
    if vm == ViewMode.BASE_COLOR:
        return gb.base_color[..., :3]
    if vm == ViewMode.ROUGHNESS:
        return gb.mrao[..., 1:2].expand(-1, -1, 3)
    if vm == ViewMode.METALLIC:
        return gb.mrao[..., 0:1].expand(-1, -1, 3)
    if vm == ViewMode.EMISSIVE:
        return post.tonemap(gb.emissive, fc.exposure)
    if vm == ViewMode.NORMALMAP:
        return n * 0.5 + 0.5
    if vm == ViewMode.AMBIENT_OCCLUSION:
        return gb.mrao[..., 2:3].expand(-1, -1, 3)
    if vm in (ViewMode.OBJECT_IDS, ViewMode.TRIANGLE_IDS):
        vis = raster.visibility_from_tri(tri, scene)
        prim, ltri = mu.decode_primitive_visibility(
            torch.where(gb.mask, vis, 0))
        key = prim if vm == ViewMode.OBJECT_IDS else ltri
        return torch.where(m3, _hash_color(key), 0.0)
    if vm == ViewMode.LIGHT_CLUSTER_SLICES:
        # colour by exponential depth slice (ref: debug-visualization.hlsl
        # cluster-slices mode)
        h, w = depth.shape
        cid = clustered.pixel_cluster_id(depth, config,
                                         config.camera_near_plane, w, h)
        gxy = config.light_cluster_dim_x * config.light_cluster_dim_y
        return torch.where(m3, _hash_color(cid // gxy), 0.0)
    # NORMAL, LIGHTING_ONLY (and REFLECTIONS without a probe)
    return post.tonemap(hdr, fc.exposure)


def pick(scene, tri_map, x: int, y: int):
    """Mouse picking: (primitive id, local triangle id, meshlet id) under a
    pixel, -1s when no geometry (ref: debug-visualization.hlsl:94-150; the
    triangle-index buffer is read back directly)."""
    t = int(tri_map[y, x])
    if t < 0:
        return -1, -1, -1
    prim = int(scene.tri_prim[t])
    local = t - int(scene.prim_tri_offset[prim])
    meshlet = int(scene.tri_meshlet[t])
    return prim, local, meshlet


def highlight(color_u8, tri_map, scene, prim_id: int):
    """White overlay on the picked primitive's pixels
    (ref: render-jobs/highlight-pass.inl + geo-raster/highlight-pass.hlsl)."""
    safe = torch.clamp(tri_map, min=0).long()
    m = (tri_map >= 0) & (scene.tri_prim[safe] == prim_id)
    blended = (color_u8.to(torch.float32) * 0.35
               + 255.0 * 0.65).to(torch.uint8)
    return torch.where(m[..., None], blended, color_u8)


def _hash_color(key):
    """Integer id -> pseudo-random rgb (ref: debug-visualization.hlsl hashes
    ids to colours for the id view modes). uint32 arithmetic, carried in
    int64 and reduced modulo 2^32."""
    h = (((key.to(torch.int64) & 0xFFFFFFFF) + 1) * 2654435761
         & 0xFFFFFFFF) >> 8
    r = (h & 0xFF).to(torch.float32) / 255.0
    g = ((h >> 8) & 0xFF).to(torch.float32) / 255.0
    b = ((h >> 16) & 0xFF).to(torch.float32) / 255.0
    return torch.stack([r, g, b], dim=-1)


def pathtrace_inputs(scene, fc):
    """The camera, sun and lights moved into the BVH's unrotated space, and
    the unrotated world vertex normals and tangents -> (scene_b, fc_b,
    world_n_v, world_t_v). Pair with sky_rot3 = fc.scene_rotation[:3, :3],
    so that environment fetches stay in world space."""
    inv = fc.inv_scene_rotation
    r3 = inv[:3, :3]
    fc_b = dataclasses.replace(
        fc, eye=fc.eye @ r3 + inv[3, :3],
        camera_right=fc.camera_right @ r3, camera_up=fc.camera_up @ r3,
        sun_dir=fc.sun_dir @ r3, inv_view_proj=fc.inv_view_proj @ inv)
    scene_b = dataclasses.replace(
        scene, lights=dataclasses.replace(
            scene.lights, transform=scene.lights.transform @ inv))
    world_n_v, world_t_v = resolve.vertex_world_attributes(
        scene, torch.eye(4, device=inv.device))
    return scene_b, fc_b, world_n_v, world_t_v


def render_pathtrace(scene, bvh, fc, history, sample_index, *,
                     config: Config, width: int, height: int, probe=None):
    """One progressive path-traced sample (or a batch, for a sequence of
    sample indices) + accumulation + tonemap (ref: renderer.cpp:1679-1710:
    PathTracing, pathtrace-integrate and the tonemap on the history).
    -> dict(color (H, W, 3) u8, history (H, W, 3) f32, rays: counted rays,
    a 0-dim f32 tensor). The BVH holds the unrotated scene: the camera,
    sun and lights are moved into its space for the trace, and sky fetches
    stay in world space."""
    scene_b, fc_b, world_n_v, world_t_v = pathtrace_inputs(scene, fc)
    current, rays = pathtrace.trace_sample(
        scene_b, bvh, world_n_v, world_t_v, fc_b, probe, sample_index,
        width, height,
        sqrt_sample_count=int(np.sqrt(config.max_sample_count)),
        dynamic_sky=(config.env_sky_mode == EnvSkyMode.DYNAMIC_SKY),
        turbidity=config.turbidity, viewmode=config.viewmode,
        sky_rot3=fc.scene_rotation[:3, :3], sun_dir_world=fc.sun_dir,
        return_rays=True)
    first = (sample_index[0] if isinstance(sample_index, (list, tuple))
             else torch.as_tensor(sample_index).reshape(-1)[0])
    accumulated = pathtrace.integrate(history, current, int(first))
    color = post.tonemap(accumulated, fc.exposure,
                         nan_check=(config.viewmode == ViewMode.NAN_CHECK))
    return dict(color=post.to_uint8(color), history=accumulated, rays=rays)
