"""Runtime configuration.

Mirror of the reference's FConfig defaults (ref: inc/common.h:6-48), expressed
as a frozen dataclass. A copy of ``incarnation_tpu/config.py``: the PyTorch
port imports nothing of the JAX package, and its defaults are the JAX
package's, so Config() is the same frame in both.
"""

from __future__ import annotations

import dataclasses
import math


class ViewMode:
    """Debug visualization modes (ref: inc/demo.h:7-23)."""
    NORMAL = 0
    NAN_CHECK = 1
    LIGHTING_ONLY = 2
    ROUGHNESS = 3
    METALLIC = 4
    BASE_COLOR = 5
    EMISSIVE = 6
    REFLECTIONS = 7
    OBJECT_IDS = 8
    TRIANGLE_IDS = 9
    NORMALMAP = 10
    AMBIENT_OCCLUSION = 11
    BENT_NORMALS = 12
    LIGHT_CLUSTER_SLICES = 13


class EnvSkyMode:
    """Environment sky source (ref: inc/demo.h:25-29)."""
    ENVIRONMENT_MAP = 0
    DYNAMIC_SKY = 1


@dataclasses.dataclass(frozen=True)
class Config:
    # Content
    model_filename: str = "DamagedHelmet.gltf"
    hdri_filename: str = "lilienstein.hdr"
    use_content_cache: bool = True

    # Camera (ref: common.h:17-20)
    fov: float = 0.25 * math.pi
    exposure: float = 13.0          # EV100
    camera_speed: float = 5.0
    camera_near_plane: float = 1.0

    # Modes
    viewmode: int = ViewMode.NORMAL
    env_sky_mode: int = EnvSkyMode.DYNAMIC_SKY
    sky_brightness: float = 25000.0

    # Feature toggles (ref: common.h:24-38)
    enable_direct_lighting: bool = True
    enable_sky_lighting: bool = True
    enable_diffuse_ibl: bool = True
    enable_specular_ibl: bool = True
    path_trace: bool = False
    forward_lighting: bool = False
    frustum_culling: bool = True
    enable_taa: bool = True
    enable_hbao: bool = False
    use_bent_normals: bool = False
    use_meshlets: bool = True
    freeze_culling: bool = False
    show_light_bounds: bool = False
    show_object_bounds: bool = False

    # Clustered lighting (ref: common.h:34-38)
    light_cluster_dim_x: int = 16
    light_cluster_dim_y: int = 9
    light_cluster_dim_z: int = 24
    max_lights_per_cluster: int = 64
    cluster_depth_extent: float = 200.0

    # Path tracing (ref: common.h:39-42)
    max_sample_count: int = 256
    pathtracing_camera_aperture: float = 0.01
    pathtracing_camera_focal_length: float = 7.0

    # Sky / time-of-day (ref: common.h:43-47)
    turbidity: float = 2.0
    tod_enable: bool = True
    tod_decimal_hours: float = 11.0
    tod_julian_date: int = 200
    tod_latitude: float = 42.5
    envmap_resolution: int = 256

    # --- Software-rasterizer and filtering knobs (no reference equivalent) ---
    # Screen tile of the binner and the fine raster, TILE_H x TILE_W pixels;
    # K1 runs one thread block per tile (at most 2048 pixels a tile).
    raster_tile_h: int = 32
    raster_tile_w: int = 128
    # Total (tile, triangle) pairs the binner keeps per frame. Pairs beyond
    # it are dropped and counted in the bin_overflow stat. Binning replaces
    # the reference's GPU atomic-append of indirect draws (ref:
    # culling/batch-culling.hlsl).
    pair_capacity: int = 1 << 20
    # Pair capacity of the sun shadow depth pass, which bins every caster
    # triangle of the scene into the sun view's tiles. Pairs beyond it are
    # dropped and counted in the shadow_bin_overflow stat. Every face casts
    # (kernels/shadow.py), so the atrium's 1024 x 1024 sun pass bins
    # 341,735 pairs (JAX's 163,840, sized for front faces only, would drop
    # 177,895); 2^19 leaves half as much again.
    shadow_pair_capacity: int = 1 << 19
    # Most screen tiles one binned triangle may span before it goes to the
    # per-frame "big triangle" list that every tile walks; big triangles
    # beyond big_tri_capacity are dropped and counted in big_overflow.
    bin_max_span: int = 16
    big_tri_capacity: int = 512
    # Texture resolution cap (textures are resized to at most this).
    texture_max_dim: int = 2048
    # Stochastic texture filtering while TAA accumulates (a frame rendered
    # with a history): stochastic_mip dithers to one mip level (the
    # material stack, the alpha test and the specular probe),
    # stochastic_bilinear jitters the bilinear footprint to one texel, and
    # the TAA accumulation converges both to the filtered result. A frame
    # without a history stays exact (trilinear).
    stochastic_mip: bool = True
    stochastic_bilinear: bool = True
    # Anisotropy limit of the stochastic tap (reference: 16x aniso static
    # samplers, src/demo.cpp:445-493): the mip follows the footprint's
    # minor axis (at most this many taps across the major one) and the
    # single tap is jittered along the major axis. Read only by the
    # stochastic filters.
    max_anisotropy: int = 16
    # Alpha-masked geometry: number of depth-peel layers rastered for
    # MASK/BLEND primitives (a failed alpha test exposes the next fragment
    # behind it, ref: visibility-pass.hlsl clip), and for the forward
    # path's BLEND layers. Pixels still unresolved after the last peel are
    # counted in the peel_overflow stat.
    masked_depth_peels: int = 2
    # Chunk capacities of the peel alpha tests and the decal resolve, in
    # 128-pixel chunks (rows of the flat image): only the first `capacity`
    # chunks holding a covered pixel, in flat order, fetch their textures.
    # Later chunks read alpha 1.0 on a peel (the fragment passes) and zero
    # texture channels on the decal layer, counted in the
    # peel_chunk_overflow and decal_overflow stats. The peels take a
    # falling ladder (cap, 2 cap / 3, then max(5 cap >> (l + 2), 512)). 0,
    # or a capacity of at least the frame's chunk count, fetches every
    # pixel.
    peel_chunk_capacity: int = 6144
    decal_chunk_capacity: int = 1024
    # Analytic split-sum env-BRDF (a 16x16 Chebyshev tensor fitted to the
    # reference integration, mimicking the reference's inverted-row fetch
    # quirk) in place of the LUT fetch, at <= 0.5% absolute error in the
    # specular scale (kernels/ibl.py env_brdf_approx). On by default; the
    # LUT path remains bit-parity with the reference's
    # sky-lighting.hlsl:124 behavior.
    analytic_env_brdf: bool = True
    # Sun shadows. The reference always traces a per-pixel DXR shadow ray
    # toward the sun (ref: lighting/common.hlsli:91-116). Modes:
    #   "auto" - "rt" when a scene BVH is supplied, else no shadows
    #   "map"  - rasterized orthographic sun shadow map, one tap per pixel
    #            (kernels/shadow.py; the bench frame)
    #   "rt"   - exact BVH shadow rays
    #   "off"  - sun always visible
    sun_shadow_mode: str = "auto"
    # Side of the square sun shadow map in texels; the depth bias of the
    # visibility test scales with 2 / resolution.
    shadow_map_resolution: int = 1024
    # Half-rate checkerboard fetch while the stochastic filters run and the
    # width is even: half the pixels (alternating with the row and the
    # frame) fetch the sun-shadow sample, the specular probe and (with
    # stochastic_bilinear) the opaque layer's material stack; each other
    # pixel takes the mean of its two horizontal neighbours' fetches
    # (kernels/checker.py).
    checkerboard_gathers: bool = True
    # Stochastic single-texel TAA history fetch in place of the bilinear
    # one.
    stochastic_taa: bool = False

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
