#!/usr/bin/env python3
"""Smoke run of the PyTorch port (incarnation_tpu_torch) on one CUDA card.

    python3 chip_smoke.py             # what the port's chip check runs
    python3 chip_smoke.py --profile   # + a torch.profiler table of a frame

It builds the hand-written CUDA kernels from incarnation_tpu_torch/csrc,
builds the procedural atrium (289k triangles, 41 materials, 66 lights,
masked foliage, decals) onto the card and renders 8 TAA frames at 1920x1088
through render_frame, the port's raster frame in the bench configuration
(bench.py's Config(sun_shadow_mode="map", masked_depth_peels=8), the JAX
package's defaults otherwise, a history of zeros on frame 0 as bench.py
gives it): the frustum cull of the primitives and the meshlets (K13,
one launch for both lists),
triangle setup (K9) and layered binning (K10) of the camera
and sun passes, opaque raster, 8 masked depth peels, each with one
launch of K6's peel step (the alpha test of a jittered texel of a
dithered mip under the chunk-capacity ladder, the chunk rank, and the
accumulate; nothing else launches between one peel's K1 call and the
next's), the material resolve of the opaque layer (K5: a checkerboard
of jittered texels), the decal layer (K1, then K5's decal step: its
jittered texels under its chunk capacity, the depth test and the
composite into the GBuffer in one launch, nothing else launching before
the sun pass), the 1024 x 1024 sun shadow map (K1's
depth-only role, every face casting), the light-cluster grid (K11),
sky IBL (K8: a checkerboard of jittered RGBE probe texels), the sun's
direct term (K15, whose map role taps the map itself, jittered and
checkerboarded, at the pixels the sun lights: K14's tap inside its
launch), clustered lights (K2), the sky background written into the
frame's HDR (K12's accumulate role), the TAA resolve (K3's resolve
role: the reprojected fetch, the 3x3 clamp and the blend in one launch)
and tonemap. The camera is the atrium's glTF
camera with Halton jitter and a small orbit every frame. Every zero gate
must read 0 on every frame (peel_chunk_overflow and decal_overflow
among them), each launch of K3, K5, K6, K8 and K15 counts under its
role, and K14 launches on no frame. Then the same 8 frames with the
estimators off (the exact roles of K5, K6, K8 and K15's tap on every
frame): both sequences' frame times and the
last frames' PSNR. It checks that the shadow map darkens the frame, on a
frame without the map and with the stochastic history fetch (K15's role
without a visibility, K3's resolve of a given prev_color), whose K15 and
K3 launches it holds to their twins.

Then it captures each kernel's inputs from one more frame of each
sequence, runs each kernel and its plain PyTorch twin on those inputs on
the card (a row per role of K5, K6 and K8), compares them, times both on
the card's clock (device_ms), prints each kernel's bound (the work its
inputs need) and work diagnostics (K8's checkerboard row: its fetching
lanes, halos included, beside the twin's fetches; K14's rows: its tap
alone, the "+nl" roles on the inputs of K15's map role; K15's map role
also on a view whose sun lights at least half of the covered pixels,
each beside the two launches it replaced, K14 then K15 on the tap's
visibility, and K12's accumulate role beside K12 and the eager add, in
turns; K5's decal step, on that frame and on a view whose decal layer
covers at least 10,000 pixels, beside the K5 decal launch it replaced
and beside that launch with the frame's eager decal code; K13's two
lists beside two one-list launches),
renders that frame
again with every kernel swapped for its twin and compares the images,
and prints the frame's time by phase (phase_breakdown). The frame's two
binnings run once more under torch.cuda.set_sync_debug_mode("error"):
K10 makes the host wait for nothing. Inside the light-cluster grid, the
sky background, the frustum cull of both lists, the decal step, the sun
term and the TAA resolve of one more frame, nothing but K11's, K12's,
K13's, K5's, K15's and K3's one launch each runs on the card: no eager torch operator, no copy from host
memory, no synchronize; and no eager operator reads the sky background's
output before the TAA resolve, so nothing adds it to the HDR again
(host_free_phases).

A second, small path (512x256, the port's scene/testing.py scene with a
BLEND quad, TAA off: the exact roles) renders one forward-lighting frame
with blend layers and both debug draws, holds its blend-layer launches
of K1 and every K5, K6, K8, K9, K10, K11, K12, K13 and K15 launch to
their twins (K14 alone on each K15 map launch's inputs), renders a frame of the scene with transmission and
clearcoat on its materials (K15's extras role, K5's and K8's with
extras), renders one frame per view mode (the lighting-only mode's K8
launch held to its twin) and checks pick and highlight.

Then the BVH paths on the atrium: (a) the scene BVH built on the host;
(b) the path tracer (render_pathtrace) at the JAX bench's 640x360, one
warm-up sample and 8 timed ones, counted rays per second, K4 launches per
sample by role; (c) K4 against its twin on one sample's primary, bounce
and shadow traces (identical hits), timed, with its bound and steps per
ray; (d) one sample with K4 swapped for its twin (identical radiance);
(e) one 1920x1088 render_frame with RT sun shadows and HBAO through the
same BVH (RT shadows darken the frame, AO in [0, 1], unit bent normals,
the share of covered pixels where RT and shadow-map visibility agree; its
K5, K6, K8 (with HBAO and bent normals), K9, K10, K11, K12, K13 and K15
(its given visibility) launches against their twins).

Then the rest of the port: (g) the atrium's binary BVH (merged table) and
K4's binary role on the captured primary, bounce and shadow rays, against
its twin and against the wide layout's hits; (h) tools/pt_step_bench.py's
six traces at 640x360, K4's alpha role (pathtrace.AlphaFilter) against its
twin; (i) the CLI in-process on the atrium's glTF: 8 raster frames at
1920x1088 (the PNG equals render_frame on what the CLI built), an RT
shadow + HBAO frame, and a 4-sample path trace at 640x360 checkpointed
after 2 and resumed (equal to the uninterrupted run); (j) the web viewer
serving the atrium at 959x540 (the frame after an orbit input differs;
an odd width, so the frame's stochastic roles run without the
checkerboard, and K8's tile kernel and K14's `dither` role (on the
inputs of K15's map role) get rows of their own);
(k) band sharding over two devices (two cards if the machine shows them,
else cuda:0 twice): a 1920x1088 frame and a second TAA frame against the
single frame, a band-sharded path-traced sample (identical) and an
SPP-sharded round (the batch-mean rule within 1e-6). (i)-(k) capture
their K1, K2, K3 (its resolve: the CLI's static camera takes its shift
role), K5, K6, K8, K9, K10, K11, K12, K13 and K15 launches and hold
each to its twin (the bands' K15 map launches from row 544, with K14
alone on their inputs; their K3 resolves with the halo rows).

It prints one JSON line of kernel figures; the last line is
{"ok": true, "device": {...}}. Any failed phase raises, and the script
exits non-zero without printing that line. It needs CUDA and the
repository around it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
ATRIUM_DIR = ROOT / ".content_cache" / "torch" / "atrium"

W, H = 1920, 1088
FRAMES = 8
PEELS = 8
ORBIT_RAD = 0.001          # camera yaw about a point ahead, per frame
SMALL_W, SMALL_H = 512, 256  # the forward / view-mode / debug-draw path
SMALL_PEELS = 4

# H100 SXM peaks (NVIDIA data sheet): HBM rate and float32 outside the
# tensor cores. Every kernel here is f32 CUDA-core work.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float operations per unit of work, counted from the kernel sources
# (add, sub, mul, div, sqrt, min and max count one each; compares none):
# K1: 4 planes (3 edges + depth) x (2 mul + 2 add) per (pair, pixel) that
# the pair's triangle covers -- the tests no sub-tile rejection can avoid
K1_OPS_PER_PAIR_PIXEL = 16
# K2, per (covered pixel, light of its cluster), in the order csrc/
# clustered.cu spends them: distance 9; range falloff 6 (ranged lights);
# direction 4; spot window 11 (spot lights); NoL 7; the rest of the
# radiance and the BRDF 96. A light skipped as zero stops after the test
# that skips it.
K2_OPS_DIST, K2_OPS_RANGE, K2_OPS_DIR = 9, 6, 4
K2_OPS_SPOT, K2_OPS_NOL, K2_OPS_BRDF = 11, 7, 96
K3_OPS_PER_PIXEL = 45          # 3x4 reprojection, divide, 3-channel bilerp
# K5, counted from csrc/resolve.cu (pow and log2 count one each), per
# covered pixel: the two bilinear levels 310 and their 8 core texel
# decodes 44 each (662 in all); LOD 16; the TBN basis 45; sRGB decode 30;
# the factors 14; normal mapping 38; octahedral encoding 13; world
# position 41 -- and 264 more where the material has extras blocks (8
# decodes of 33). An empty pixel costs none. Bytes: tri and uv of every
# pixel, 13 more floats of a covered one (depth, 12 interp channels), 85
# B of GBuffer planes written per pixel (97 with the mapped normal), each
# stack block and material row touched read once.
K5_OPS_PER_COVERED = 859
K5_OPS_PER_EXTRAS = 264
K5_OUT_BYTES = 85
# K5's stochastic roles, counted from csrc/resolve.cu, per covered pixel:
# the work but the texture fetch and the LOD, 181 (TBN 45, sRGB 30, the
# factors 14, normal mapping 38, octahedral encoding 13, world position
# 41); the anisotropic LOD 15, the uv step 5, floor(lod + xi) 2, four
# noises to floats 8 (211 in all); per fetch, bilinear one level of 4
# texels (155 and 4 decodes of 44, 331) or one jittered texel (its
# address 11 and one decode of 44, 55), and 33 per extras decode; a
# covered pixel of the checkerboard's other parity fills its 14 channels
# with 28. Integer operations: the four noise hashes, 9 each, at every
# pixel (a pixel's uv moves whether it is covered or not).
K5S_OPS_PER_COVERED = 211
K5S_OPS_BILINEAR, K5S_OPS_POINT, K5S_OPS_FILL = 331, 55, 28
K5S_INT_OPS = 36
# K5's checkerboard role (k5_checker_kernel), whose filling pixels compute
# only their moved uv: every pixel its uv step (the footprint's two axes
# 8, the step 5, its noise 2: 15) and one noise hash (9 integer
# operations); a fetching pixel with a covered pixel among it and its
# neighbours the rest of its mip and its jitter (the minor axis and the
# log2 7, floor(lod + xi) 2, three noises 6: 15), its texel (55) and three
# hashes (27); a covered pixel the shading (181) and, filling, the fill
# (28)
K5C_OPS_UV, K5C_OPS_LOD, K5C_OPS_SHADE = 15, 15, 181
K5C_INT_OPS_UV, K5C_INT_OPS_FETCH = 9, 27
# K6, per pixel of the peel: LOD 12, its cap 4, the clamps 2, the bilinear
# alpha fetch 26, alpha 1, the BLEND threshold 2 (43, on every pixel, hit
# or not); bytes: 7 interp channels in, alpha and threshold out.
K6_OPS_PER_PIXEL = 43
K6_PIXEL_BYTES = 7 * 4 + 8
# K6's stochastic roles, per pixel: the anisotropic LOD 15, the clamped
# major axis 4, the uv step 5, floor(lod + xi) 2, five noises to floats
# 10, the cap 4, the clamps 2, the jittered texel's address 8, alpha 1,
# the threshold 2 (53); the five noise hashes 45 integer operations;
# bytes: u, v, the material and 4 derivatives in, alpha and the
# threshold out
K6S_OPS_PER_PIXEL = 53
K6S_INT_OPS = 45
K6S_PIXEL_BYTES = 7 * 4 + 8
# K6's peel step (masked_peel), per pixel of the peel: a miss pixel reads
# its triangle and writes its z_limit (8 B); a hit pixel of a kept chunk
# takes the alpha test, the K6 or K6S operations above, and reads its 7
# interp channels and its accumulated triangle (32 B), where none has
# passed yet also its depth (4 B); a hit pixel of a dropped chunk takes
# alpha = mat_params[6] and the threshold, 3 operations and the BLEND hash
# (9 integer ones), and reads its material and accumulated triangle (8 B);
# a newly passing pixel copies its depth and 16 interp channels and writes
# its triangle (108 B: the other 9 channels read, all 16 written, the
# depth and the triangle written; the 7 channels the alpha test reads are
# counted under K6P_HIT_BYTES, the depth read under K6P_OPEN_BYTES, and
# the kernel's second read of the 7 from cache not at all). Under a capacity a block writes its look-back word
# and a later block reads it (16 B); the material, meta and alpha-mirror
# rows touched read once.
K6P_PIXEL_BYTES, K6P_HIT_BYTES, K6P_OPEN_BYTES = 8, 32, 4
K6P_DROPPED_BYTES, K6P_NEWLY_BYTES, K6P_BLOCK_BYTES = 8, 108, 16
K6P_DROPPED_OPS, K6P_BLEND_INT_OPS = 3, 9
# K5's decal step (k5_decal_kernel), counted from csrc/resolve.cu: every
# pixel's d_tri read (4 B); a decal pixel of a chunk the capacity keeps
# reads d_depth and depth (8 B); one that passes the depth test reads its
# 7 interp channels and reads and writes the base colour's rgb (28 + 24
# B), and where its decal is opaque reads the 7 TBN channels and writes
# the normals and mrao (28 + 8 + 16 B) and n3 where given (12 B); under a
# capacity a block writes its look-back word and a later one reads it (16
# B); the overflow 8 B; each stack block and material row touched read
# once. Operations of a passing pixel: its fetch (the exact role K5's LOD
# 16 and two bilinear levels 662, 264 more with extras blocks; the
# stochastic roles' LOD, uv step and noises 30 and one bilinear level 331
# (4 extras decodes of 33) or one jittered texel 55 (one, 33)), then the
# sRGB decode of 3 channels 15, the factors 4, the blend 10 and the test
# 1; an opaque one the TBN basis 45, normal mapping 38, the octahedral
# encoding 13, the mrao factors 2 and the decode into n3 22. Integer
# operations: the stochastic roles' four noise hashes, 9 each.
K5D_PIXEL_BYTES, K5D_DECAL_BYTES, K5D_PASS_BYTES = 4, 8, 28 + 24
K5D_OPAQUE_BYTES, K5D_N3_BYTES, K5D_BLOCK_BYTES = 28 + 8 + 16, 12, 16
K5D_OPS_PASS, K5D_OPS_OPAQUE, K5D_OPS_N3 = 30, 98, 22
K5D_OPS_FETCH = {"exact": 678, "dither": 361, "jitter": 85}
K5D_OPS_EXTRAS = {"exact": 264, "dither": 132, "jitter": 33}
K5D_INT_OPS = 36
K5_RTOL = 1e-5             # K5 against its twin: see _k5_error
# K8, counted from csrc/skylight.cu (pow, sqrt and abs count one each, a
# fused multiply-add two), per covered pixel: the diffuse lobe 111 (the SH
# basis 25, its 27 fused multiply-adds 54, albedo, AO blend), +4 with
# extras; the specular lobe 162 (NoV and the reflected direction 29, the
# cube face 11, the trilinear fetch 88, f0 and the AO blend 34) and one
# env-BRDF evaluation: the analytic fit 1,198 (two 16x16 Chebyshev tensor
# sums of 527 and their recurrences, every multiply-add fused) or the LUT
# 32; the clearcoat lobe with extras 115 (another fetch 88) and another
# evaluation; the HBAO scale 3. Bytes: the
# mask and the output of every pixel (13), base colour, mrao, n and v of
# a covered one (56), +12 for bent normals, +4 for HBAO, +12 for extras;
# the SH, the prefiltered cube and the LUT read once each, whole.
K8_OPS_DIFFUSE, K8_OPS_DIFFUSE_EXTRAS = 111, 4
K8_OPS_SPECULAR, K8_OPS_CLEARCOAT = 162, 115
K8_OPS_ANALYTIC, K8_OPS_LUT = 1198, 32
K8_OPS_HBAO = 3
K8_TOL = 1e-5              # K8 against its twin: see _k8_error
# K8's stochastic roles, per covered pixel: the specular lobe's set-up 74
# (NoV and the reflected direction 29, the cube face 11, f0 and the AO
# blend 34) and one env-BRDF evaluation (the picked lobe's); the lobe
# pick with extras 11; per probe fetch one dithered level (the lod 3,
# bilinear 42) or one RGBE texel (the lod 3, its address 8, the decode
# 6); the checkerboard's fill 6; four noises to floats 8. Integer
# operations: the noise hashes, 9 each. Bytes: the mask and output of
# every pixel, a covered pixel's inputs, the inputs of the fetching
# pixels that are not covered (n, v, mrao, extras: 52), and the RGBE
# table (or the cube) once, whole.
K8S_OPS_SPECULAR, K8S_OPS_LOBE = 82, 11
K8S_OPS_BILINEAR, K8S_OPS_POINT, K8S_OPS_FILL = 45, 17, 6
K8S_INT_OPS = 36
# K9, counted from csrc/setup.cu, per triangle: the corners' clip positions
# 72, screen mapping 24, edge functions and det 32, the visibility, sign
# and depth plane 33, the clipped bbox 89 (250 in the depth-only role);
# with attributes the world normals and tangents 90 and the 29 planes
# 126; per mesh the two 4x4 products, local_to_world and local_to_clip,
# 224 (the work the function needs; K9 forms them in every thread).
# Bytes: 144 B of corners (the positions, 36, depth-only),
# tri_mesh and tri_prim 8 (+4 tri_meshlet, +1 tri_visible), 69 B out
# (setup, bbox, id, valid) + 116 of planes; each mesh transform (64 B),
# primitive row (9) and meshlet row (5) and the two 4x4 matrices (128 B)
# read once.
K9_OPS_DEPTH, K9_OPS_ATTR, K9_OPS_PER_MESH = 250, 216, 224
# K10, counted from csrc/bin.cu in integer operations: per triangle its
# tier (four floor divisions, the spans and their product, the tier tests)
# and its first bucket, 17; per pair its bucket, 6. Bytes: each triangle's
# bbox (16), valid flag (1) and layer (4, where given) read once; pair_tri
# (4 x (pair_capacity + 1)), a tile's start and count (8), each layer's big
# list (4 x big_tri_capacity) and its three counters written once.
K10_OPS_PER_TRI, K10_OPS_PER_PAIR = 17, 6
# K11, counted from csrc/clustered.cu, per cluster: its corners' NDC x and
# y 8, the two slices' view depth (the exponent 2, powf 1, the scaling 1)
# and NDC z (a 4-term product 7 each for z and w, the division 1) 38, 8
# corners' 4x4 products (28), the +0.0 of each coordinate (3) and the
# division by w (3) 272, 6 planes (the two edges 6, the cross product 9,
# the offset 5, |n| 6) 156: 474; per (cluster, light, plane) the test n.p
# 5, + d 1, |n| r 1 and the sum 1: 8. Bytes: the two matrices (128), each
# light's position, range and type (20), the words and the count.
K11_OPS_PER_CLUSTER, K11_OPS_PER_TEST = 474, 8
# K12, counted from csrc/skylight.cu (acosf, cosf and expf count one
# each), per uncovered pixel: NDC 8, the 4x4 product 28, the division by w
# and the eye 7, normalize 11, theta and gamma 11, Perez 39 (cos theta and
# its clamp, cos gamma, then 12 a channel), the ratio to the zenith's 6,
# Yxy to RGB and the scale 24: 134. Bytes: the mask byte and the 12-byte
# output of every pixel, the matrix, eye and sun once.
K12_OPS_PER_SKY = 134
# K13, counted from csrc/cull.cu, per sphere: the centre ([c, 1] by the
# world rows, 4 mul + 3 add a coordinate) 21, the three row norms (3 mul,
# 2 add, sqrt) 18, their largest 2, the radius and its negation 2, six
# plane distances (3 mul + 3 add) 36: 79; per mesh the world matrix's
# rows 0-3, columns 0-2 that the test reads (4 mul + 3 add each) 84; the
# planes once (5 sums of 4, 6 norms of 6 with the floor, 24 divisions)
# 86. Bytes: each sphere (16), mesh id (4) and mask byte (1), each mesh's
# transform (64) and visibility (4), the two matrices (128), the count.
K13_OPS_PER_SPHERE, K13_OPS_PER_MESH, K13_OPS_PLANES = 79, 84, 86
K13_SPHERE_BYTES, K13_MESH_BYTES = 21, 68
# K14, counted from csrc/shadow.cu, per fetching pixel: the sun-space
# product (3 x (3 mul + 3 add)) 18, u and v 6, their clamps 4, the bias
# (clamp 2, 4 more) 6, sz + bias 1: 35; with dither two noises to floats
# and their steps (convert, scale, - 0.5, x 2, add) 10, and 18 integer
# operations (two hashes of 9); the texel's address 2 integer operations;
# a filling pixel's tent 2. Bytes: a fetching pixel's position and n.l
# (16), every pixel's output (4), each map texel a launch reads (4, the
# distinct ones) and sun_vp's rows (48).
K14_OPS_TAP, K14_OPS_DITHER, K14_OPS_FILL = 35, 10, 2
K14_INT_OPS_TAP, K14_INT_OPS_DITHER = 2, 18
K14_FETCH_BYTES, K14_PIXEL_BYTES = 16, 4
# K14's "+nl" roles: a fetching pixel reads its normal (12) in n.l's place
# (4) and forms n.l (3 mul + 2 add); sun_dir once (12)
K14_NL_BYTES, K14_NL_OPS = 8, 5
# K15's map role (csrc/shading.cu with csrc/k14_tap.cuh) in place of the
# visibility plane: each tap the rule needs (_k15_taps) K14's operations
# (K14_OPS_TAP + K14_NL_OPS, + K14_OPS_DITHER and the integer ones with
# dither), a lit filling pixel's tent (K14_OPS_FILL); bytes: the 32-byte
# sectors of world_pos and of the map that the taps touch, each once, and
# the normal (12) of a tapped pixel that is not covered
SECTOR_BYTES = 32
# K15, counted from csrc/shading.cu: every pixel its HDR add (3); a
# covered pixel n.l and its clamp (7); one whose n.l > 0 the rest: n.v,
# n.h, v.h with their clamps (21), the half vector (3 adds, its dot 5,
# + eps, sqrt, reciprocal, 3 scalings: 14), 1 - metallic (1), GGX D (11),
# the Schlick weight (4), Smith G (17), the denominator (3), the
# radiance's scale (1) and per channel f0 3, albedo 1, F 3, the specular
# 3, the diffuse 1, their sum 3, the radiance and n.l 3, the visibility 1
# (54): 133; with extras 48 more (the clearcoat roughness's clamp 1, its
# Fresnel 4, D 11, G 17, its term 3, and per channel the transmission 1
# and the layering 3). Bytes: every pixel its mask, HDR and output (25); a
# covered pixel its normal (12); a lit one its view vector (12), base
# colour and mrao (16 each: whole pixels), visibility (4) and extras (12)
K15_OPS_PIXEL, K15_OPS_COVERED, K15_OPS_LIT, K15_OPS_EXTRAS = 3, 7, 133, 48
K15_PIXEL_BYTES, K15_COVERED_BYTES, K15_LIT_BYTES = 25, 12, 44
K15_VIS_BYTES, K15_EXTRAS_BYTES = 4, 12
# K3's resolve, counted from csrc/taa.cu, per pixel: the fetch (the
# reprojection K3_OPS_PER_PIXEL; the shift's 3-channel bilerp 18; a given
# prev_color 0), the 3x3 min and max of 3 channels (48), the clamp (6),
# two luminance weights (7 each), their scalings and sum (3), the blend
# (12): 83. Bytes: the current HDR (12) and the output (12) of every
# pixel; the fetch's depth (4, reprojection) and history or prev_color
# texel (12); the halo rows (2 x 12 W) and m (64) once.
K3R_OPS_RESOLVE, K3R_OPS_SHIFT = 83, 18
# K1's depth-only role, counted from csrc/raster.cu, per (pair, pixel)
# whose test passes: the 16 float operations of K1_OPS_PER_PAIR_PIXEL and
# 5 integer ones (the key's high word, an and; the 64-bit compare 2 and
# select 2)
K1D_INT_OPS_PER_PAIR_PIXEL = 5
# K10's launches a binning, by entry (kernels/raster.py K10)
K10_LAUNCHES = ("k10_count", "k10_scan", "k10_scatter")
# H100 SXM int32 rate: 64 INT32 lanes an SM (NVIDIA's Hopper white paper)
# x 132 SMs x 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# K4, counted from csrc/bvh.cu (a fused multiply-add counts two), for the
# slots these inputs fill: a triangle test 46 per filled leaf slot the ray
# must test (two cross products at 9, four dot products at 5, the
# reciprocal 1, o - v0 3, three scalings by the reciprocal 3, u + v 1;
# with any hit, up to the accepted slot); a box test 24 per filled child
# the ray must test (per axis 2 subtractions, 2 multiplications, a min and
# a max, and the two running bounds): in the wide layout the children up
# to and including the first one hit in the ray's octant order, all filled
# ones where none is hit (the twin's box_tests_to_hit; box_tests, every
# filled child, gives a looser bound, logged beside it), one box per
# binary internal row; and 1 per internal row for its limit. A ray reads 24 bytes
# (origin, direction) and writes 16 (t, tri, u, v). The table's bytes:
# each visited row's flag and one octant's (iperm, miss) or (hit, miss)
# pair, 12, and each box (6 floats, 24, and a wide child's id, 4) and leaf
# slot (9 floats, id and double-sided flag, 44) that some ray tested, read
# once.
K4_OPS_TRI = 46
K4_OPS_BOX = 24
K4_OPS_INTERNAL = 1
K4_RAY_BYTES = 24 + 16
K4_ROW_BYTES, K4_BOX_BYTES, K4_SLOT_BYTES = 12, 24, 44
PT_W, PT_H = 640, 360      # the JAX bench's path-tracing size (bench.py:156)
# the web viewer's frame: an odd width, at which the frame takes no
# checkerboard (renderer/frame.py), so the viewer runs the stochastic
# roles without it (K8's tile kernel)
VIEW_W, VIEW_H = 959, 540
BAND_TRI_SHARE = 1e-3      # band_phase: see there
K2_RTOL = 1e-5             # K2 against its twin: see compare_kernels
PT_SAMPLES = 8             # timed samples, after one warm-up
# K4 launches per path-traced sample, by role (kernels/pathtrace.py): one
# primary trace, a closest-hit trace for each of the 3 further bounces,
# one any-hit shadow batch per bounce; up to 2 alpha continuations of each
# closest-hit trace and 1 of each shadow batch
PT_LAUNCHES = {"pt_primary": (1, 1), "pt_bounce": (3, 3),
               "pt_shadow": (4, 4), "pt_primary_peel": (0, 2),
               "pt_bounce_peel": (0, 6), "pt_shadow_peel": (0, 4)}
# cycles a spin kernel runs per second at the H100 SXM's highest SM clock
# (1.98 GHz): at a lower clock the spin lasts longer, never shorter
SPIN_CYCLES_PER_S = 2.0e9


def _log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def device_ms(fn, reps: int) -> float:
    """Mean ms per fn() call on the card's clock: CUDA events around reps
    back-to-back calls, queued behind a spin kernel that holds the stream
    for three times the host's time to launch them, so the card runs them
    back to back and a small launch is not timed by the host that launches
    it. The time between the events is every kernel's, memset's and copy's,
    and the gaps between them. A call that synchronises inside (a plain
    twin reading a count) waits for the card there, and then its time
    includes the host's. A warm-up call first, then one batch whose time
    on the host sets the spin's; L2 is not flushed."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (3.0 * host_s + 2e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Mean ms of the host's work per fn() call (its wrapper's checks, the
    ctypes call, the launch): the host clock around reps back-to-back
    calls queued behind a spin kernel, so that no call waits for the
    card. A call that waits for the card itself (a synchronize, a copy
    from pageable host memory) waits for the spin too, and then the time
    is not its host work. A warm-up call first."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * 0.05))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host_s * 1e3 / reps


def once_ms(fn) -> float:
    """ms of one fn() call between CUDA events, for a twin that takes
    seconds (K4's): its host time dominates, and it has just run once for
    its check, so device_ms's warm-up and its spin's sizing batch (two
    more calls) would only add seconds to the run."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def bench_view(host, width, height):
    """The scene's first glTF camera (the atrium ships one), else a default
    look-at, as the JAX bench frames it."""
    from incarnation_tpu_torch.core.view import View
    if host.cameras:
        c = host.cameras[0]
        return View(position=np.asarray(c["position"], np.float32),
                    right=np.asarray(c["right"], np.float32),
                    up=np.asarray(c["up"], np.float32),
                    look=np.asarray(c["look"], np.float32),
                    aspect=width / height)
    return View.from_lookat([0.0, 4.0, -14.0], [0.0, 0.0, 0.0],
                            aspect=width / height)


def orbit(view0, angle: float, radius: float = 6.0):
    """view0 yawed by `angle` about a vertical axis `radius` ahead of it."""
    import dataclasses
    v = dataclasses.replace(view0)
    pivot = view0.position + radius * view0.look
    v.rotate(yaw=angle)
    v.position = (pivot - radius * v.look).astype(np.float32)
    return v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one frame with torch.profiler")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from incarnation_tpu_torch.core import mathutils as mu
    from incarnation_tpu_torch.kernels import (build, bvh, clustered, cull,
                                               raster, resolve, shading,
                                               shadow, skylight, taa)
    # the port's small matmuls (the band matrix, the RT frame's rotated
    # rays, the debug draws) need full f32
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls are on: the port's 4x4 products "
                           "need full f32")

    # 1. the card
    dev = torch.device("cuda")
    card = card_line()
    _log(f"card: {card}")
    kind = torch.cuda.get_device_name(0)

    # 2. kernels, one nvcc per source, all started together
    secs, logs = build.timed_build(verbose=True)
    _log(f"kernels built in {secs:.1f} s")
    K4_RESOURCES.update(k4_resources(build, logs.get("bvh")))
    K5_RESOURCES.update(kernel_resources(build, "resolve",
                                         "k5_resolve_kernel",
                                         logs.get("resolve")))
    for kernel in ("k5_checker_kernel", "k5_decal_kernel",
                   "k6_masked_alpha_kernel", "k6_peel_kernel"):
        K5_RESOURCES.update(kernel_resources(build, "resolve", kernel,
                                             logs.get("resolve")))
    _log(f"K5 and K6 (k5_resolve_kernel, k5_checker_kernel, "
         f"k5_decal_kernel, k6_masked_alpha_kernel, k6_peel_kernel, by "
         f"role): "
         f"{json.dumps(K5_RESOURCES)}")
    K8_RESOURCES.update(kernel_resources(build, "skylight", "k8_sky_",
                                         logs.get("skylight")))
    K9_RESOURCES.update(kernel_resources(build, "setup", "k9_setup_kernel",
                                         logs.get("setup")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "clustered", "k11_light_grid_kernel", logs.get("clustered")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "skylight", "k12_sky_background_kernel",
        logs.get("skylight")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "cull", "k13_cull", logs.get("cull")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "shadow", "k14_", logs.get("shadow")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "shading", "k15_", logs.get("shading")))
    K11_K15_RESOURCES.update(kernel_resources(
        build, "taa", "k3_", logs.get("taa")))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    # 3-5. the atrium and the bench configuration
    path = atrium_path(dev)
    scene, run, make_fc = path.scene, path.run, path.make_fc
    cfg = path.cfg

    # two warm-up frames, the second with a history, load every kernel
    # library and torch's own lazily loaded code before anything is timed
    fc0 = make_fc(0, None)
    warm = run(fc0, torch.zeros((H, W, 3), device=dev))
    run(make_fc(1, fc0.view_proj.cpu().numpy()), warm["accumulation"])
    torch.cuda.synchronize()

    kernels = (raster.K1, clustered.K2, taa.K3, bvh.K4, resolve.K5,
               resolve.K6, skylight.K8, raster.K9, raster.K10, clustered.K11,
               skylight.K12, cull.K13, shadow.K14, shading.K15)
    for k in kernels:
        k.reset()
    # the main path: bench.py's frame, JAX's default Config, its history
    # zeros on frame 0 (as bench.py gives it), so every frame runs the
    # stochastic filters
    seq = run_sequence(run, make_fc, dev, kernels)
    frame_ms, outs, outs_history = seq.frame_ms, seq.stats, seq.histories
    per_frame, out, fc, prev_vp = seq.per_frame, seq.out, seq.fc, seq.prev_vp
    history = out["accumulation"]
    launches = {k.fn: k.launches for k in kernels}
    if launches.pop("k4_trace"):
        raise RuntimeError("the raster frame launched K4")
    k1_by_layer = dict(raster.K1.by_name)
    k10_steps = dict(raster.K10.by_name)
    roles = {k.fn: dict(k.by_name) for k in (
        resolve.K5, resolve.K6, skylight.K8, shadow.K14, taa.K3,
        shading.K15)}
    _log(f"launches on the main path: {launches}, K1 by layer "
         f"{k1_by_layer}, K10 by launch {k10_steps}, K3, K5, K6, K8, K14 "
         f"and K15 by role {roles}")
    _log("frame ms: " + ", ".join(f"{t:.2f}" for t in frame_ms))
    # JAX's default frame: K5 fetches the opaque layer's stack by the
    # checkerboard of jittered texels, and its decal step the decal
    # layer's jittered texels under its chunk capacity, K6's peel step tests every peel's alpha under the
    # chunk ladder and accumulates it, K8 the probe by the checkerboard;
    # K15 shades the sun, tapping the map by the checkerboard itself (K14
    # launches on no frame); K3 resolves every frame with a history, the
    # camera moving, by its reprojected fetch
    want_roles = {"k5_resolve": {"jitter_checker": FRAMES,
                                 "decal_jitter+chunks": FRAMES},
                  "k6_masked_alpha": {"step_jitter+chunks": PEELS * FRAMES},
                  "k8_sky_lighting": {"jitter_checker": FRAMES},
                  "k14_sun_tap": {},
                  "k3_taa_resolve": {"reproject": FRAMES - 1},
                  "k15_sun_term": {"map": FRAMES}}
    if roles != want_roles:
        raise RuntimeError(f"K3, K5, K6, K8, K14, K15 roles {roles} != "
                           f"{want_roles}")

    for i, st in enumerate(outs):
        for key in ZERO_STATS:
            if int(st[key]) != 0:
                raise RuntimeError(f"frame {i}: {key} = {int(st[key])}")
    last = outs[-1]
    _log("stats of the last frame: "
         + json.dumps({k: int(v) for k, v in last.items()}))
    hdr = out["hdr"]
    if tuple(hdr.shape) != (H, W, 3) or not bool(torch.isfinite(hdr).all()):
        raise RuntimeError("hdr is not a finite (H, W, 3) image")
    if tuple(out["color"].shape) != (H, W, 3) \
            or out["color"].dtype != torch.uint8:
        raise RuntimeError("color is not an (H, W, 3) uint8 image")
    covered = float((out["tri"] >= 0).float().mean())
    _log(f"covered pixels {covered:.4f}; mean colour "
         f"{out['color'].float().mean().item():.2f}")
    if covered < 0.5:
        raise RuntimeError("the atrium frame is mostly empty")
    # per frame: K1 for the opaque layer, each peel, the decals and the
    # shadow map, K2 once, K3 on every frame with a history (all but
    # frame 0), K4 never (no BVH on this path), K5 for the opaque layer
    # and the decal layer's step, K6 for each peel, K8 once, K9 and K10's
    # launches for the camera and the sun pass (K10: K10_LAUNCHES a
    # binning), K11 and K12 once, K13 once for the primitives and the
    # meshlets, K14 never (K15 taps the map), K15 once; K6 is the peel
    # step, K3 the whole resolve
    want = [[3 + PEELS, 1, int(i > 0), 0, 2, PEELS, 1, 2,
             2 * len(K10_LAUNCHES), 1, 1, 1, 0, 1] for i in range(FRAMES)]
    if per_frame != want:
        raise RuntimeError(f"launches per frame (K1, K2, K3, K4, K5, K6, K8, "
                           f"K9, K10, K11, K12, K13, K14, K15) {per_frame} "
                           f"!= {want}")
    if k10_steps != {k: 2 * FRAMES for k in K10_LAUNCHES}:
        raise RuntimeError(f"K10 launches {k10_steps}: not two binnings a "
                           f"frame of {len(K10_LAUNCHES)} launches each")
    if k1_by_layer != {"raster_opaque": FRAMES, "raster_decal": FRAMES,
                       "raster_peel": FRAMES * PEELS,
                       "raster_shadow_depth": FRAMES}:
        raise RuntimeError(f"K1 layers {k1_by_layer}")

    # 5a. the same sequence with the estimators off (the parent's frame:
    # exact trilinear fetches, no checkerboard, no chunk capacity), its
    # K5, K6 and K8 launches the exact roles' on every frame; the two
    # sequences' frame times and their last frames' PSNR
    def run_exact(fc, history, config=exact_config(cfg), scene_bvh=None):
        return run(fc, history, config, scene_bvh)

    for k in kernels:
        k.reset()
    ex = run_sequence(run_exact, make_fc, dev, kernels)
    exact_roles = {k.fn: dict(k.by_name) for k in (
        resolve.K5, resolve.K6, skylight.K8, shadow.K14, taa.K3,
        shading.K15)}
    want = {"k5_resolve": {"exact": FRAMES, "decal_exact": FRAMES},
            "k6_masked_alpha": {"step_exact": PEELS * FRAMES},
            "k8_sky_lighting": {"exact": FRAMES},
            "k14_sun_tap": {},
            "k3_taa_resolve": {"reproject": FRAMES - 1},
            "k15_sun_term": {"map": FRAMES}}
    if exact_roles != want or ex.per_frame != per_frame:
        raise RuntimeError(f"the exact sequence's launches {ex.per_frame}, "
                           f"roles {exact_roles}")
    for i, st in enumerate(ex.stats):
        for key in ZERO_STATS:
            if int(st[key]) != 0:
                raise RuntimeError(f"exact frame {i}: {key} = {int(st[key])}")
    psnr = _psnr(out["color"], ex.out["color"])
    _log("frames on vs off (ms, frames 1-7; median, min, max): estimators "
         f"on {_spread(frame_ms[1:])}, off {_spread(ex.frame_ms[1:])}; "
         f"frame {FRAMES - 1} on against off: u8 PSNR {psnr:.2f} dB")
    _log("frame ms with the estimators off: "
         + ", ".join(f"{t:.2f}" for t in ex.frame_ms))
    if not 20.0 < psnr < float("inf"):
        raise RuntimeError(f"the stochastic frame is {psnr:.2f} dB from the "
                           "exact one")
    exact_launches = {k.fn: k.launches for k in kernels}

    # 5b. the shadow map does something: some, not all, covered pixels of
    # the last frame are in shadow, and the frame is darker than the same
    # frame without the map
    gb = out["gbuffer"]
    smap, _ = shadow.render_sun_shadow_map(
        scene, fc.scene_rotation, fc.sun_view_proj,
        shadow.shadow_params(cfg.shadow_map_resolution, cfg))
    vis = shadow.sun_visibility(
        gb.world_pos, None, smap, fc.sun_view_proj,
        cfg.shadow_map_resolution,
        normal=mu.oct_decode(gb.normals).contiguous(), sun_dir=fc.sun_dir)
    shadowed = float((vis[gb.mask] == 0).float().mean())
    # the same frame without the map (K15 with no visibility) and with the
    # stochastic history fetch (K3's resolve of a given prev_color)
    off_calls = []
    with _capturing(off_calls, raster, clustered, taa):
        unshadowed = run(fc, outs_history[-1], cfg.replace(
            sun_shadow_mode="off", stochastic_taa=True))["hdr"]
    torch.cuda.synchronize()
    check_twins("the frame without the map, stochastic TAA",
                [c for c in off_calls if c[0] in ("k3r", "k15")], raster,
                clustered, taa, need=("k3r", "k15"))
    mean_on, mean_off = float(hdr.mean()), float(unshadowed.mean())
    _log(f"sun shadow map: {shadowed:.4f} of the covered pixels in shadow; "
         f"mean hdr {mean_on:.2f} with the map, {mean_off:.2f} without")
    if not 0.0 < shadowed < 1.0:
        raise RuntimeError("the shadow map shadows none or all of the frame")
    if not mean_on < mean_off:
        raise RuntimeError("the shadow map does not darken the frame")

    # 6. each kernel against its twin on one frame's real inputs: the
    # stochastic roles on the main path's next frame, the exact roles on
    # the exact sequence's
    fc = make_fc(FRAMES, prev_vp)
    calls = capture_frame(run, fc, history, raster, clustered, taa)
    exact_calls = capture_frame(run_exact, fc, ex.out["accumulation"],
                                raster, clustered, taa)
    rows = compare_kernels(calls, raster, clustered, taa, launches,
                           k1_by_layer)
    rows += [k5_row(resolve, exact_calls, exact_roles["k5_resolve"]["exact"],
                    role="exact"),
             k6_row(resolve, exact_calls,
                    exact_launches["k6_masked_alpha"],
                    name="k6_masked_peel[step_exact]", role="step_exact"),
             k8_row(skylight, exact_calls,
                    exact_launches["k8_sky_lighting"], role="exact")]
    rows += [k5_row(resolve, calls, n, name=f"k5_resolve[{r}]", role=r)
             for r, n in roles["k5_resolve"].items()
             if not r.startswith("decal_")]
    # K5's decal step on the frame (its decal layer empty at bench.py's
    # view), the exact sequence's, and a view whose decal layer covers at
    # least 10,000 pixels, each timed in turns against the K5 decal launch
    # it replaced
    decal_calls, decal_exact = decal_view(path, run_exact, prev_vp, history,
                                          ex.out["accumulation"])
    rows += [k5d_row(resolve, calls,
                     roles["k5_resolve"]["decal_jitter+chunks"]),
             k5d_row(resolve, exact_calls,
                     exact_roles["k5_resolve"]["decal_exact"],
                     name="k5_decal_step[exact]"),
             k5d_row(resolve, decal_calls, 0,
                     name="k5_decal_step[decal_view]"),
             k5d_row(resolve, decal_exact, 0,
                     name="k5_decal_step[decal_view_exact]")]
    rows += [k6_row(resolve, calls, n, name=f"k6_masked_peel[{r}]", role=r)
             for r, n in roles["k6_masked_alpha"].items()]
    rows += [k8_row(skylight, calls, n, name=f"k8_sky_lighting[{r}]",
                    role=r) for r, n in roles["k8_sky_lighting"].items()]
    rows += k9_rows(raster, calls, launches["k9_setup"])
    rows += k10_rows(raster, calls, launches["k10_scatter"])
    rows += [k11_row(clustered, calls, launches["k11_light_grid"]),
             k12_row(skylight, calls, launches["k12_sky_background"])]
    rows += k13_rows(cull, calls, launches["k13_cull"])
    # K14 alone on the inputs of K15's map role (0 launches on the path)
    rows += [k14_row(shadow, calls, launches["k14_sun_tap"],
                     role="dither_checker+nl"),
             k14_row(shadow, exact_calls, exact_launches["k14_sun_tap"],
                     name="k14_sun_tap[exact]", role="exact+nl")]
    # K15's map role on the frame (about 2% of its pixels lit), the exact
    # sequence's, and a view whose sun lights at least half of the covered
    # pixels
    lit_calls, lit_exact = half_lit_view(run, run_exact, make_fc, calls,
                                         prev_vp, history,
                                         ex.out["accumulation"])
    rows += [k15_row(shading, calls, launches["k15_sun_term"], role="map"),
             k15_row(shading, exact_calls, exact_launches["k15_sun_term"],
                     name="k15_sun_term[exact]", role="map"),
             k15_row(shading, lit_calls, 0, name="k15_sun_term[lit_half]",
                     role="map"),
             k15_row(shading, lit_exact, 0,
                     name="k15_sun_term[lit_half_exact]", role="map"),
             k15_row(shading, off_calls, 0, name="k15_sun_term[none]",
                     role="none"),
             k3r_row(taa, calls, launches["k3_taa_resolve"],
                     role="reproject"),
             k3r_row(taa, off_calls, 0, name="k3_taa_resolve[given]",
                     role="given")]
    check_twins("the exact sequence's next frame",
                [c for c in exact_calls
                 if c[0] in ("k3r", "k5d", "k11", "k12", "k13", "k14",
                             "k15")],
                raster, clustered, taa,
                need=("k3r", "k5d", "k11", "k12", "k13", "k14", "k15"))
    check_twins("the decal view", [c for c in decal_calls + decal_exact
                                   if c[0] in ("k5", "k5d", "k13")],
                raster, clustered, taa, need=("k5", "k5d", "k13"))
    check_twins("the half-lit view", [c for c in lit_calls + lit_exact
                                      if c[0] in ("k12", "k15")],
                raster, clustered, taa, need=("k12", "k14", "k15"))
    k10_no_sync(raster, calls)
    check_twin_frame(run, fc, history, raster, clustered, taa)
    phase_breakdown(run, fc, history)
    # between one peel's K1 launch and the next's: K6's step, nothing
    # else
    per, names, launched = peel_launches(run, fc, history, raster, kernels)
    _log(f"eager torch launches per masked peel beyond K1's and K6's "
         f"(between one peel's K1 call and the next's, {len(per)} "
         f"windows): {per}, the first window's by operator "
         f"{json.dumps(names)}; hand-written kernels launched per window "
         f"{launched}")
    if any(per) or any(w != {"k1_raster": 1, "k6_masked_alpha": 1}
                       for w in launched):
        raise RuntimeError("the peel loop launches more than K1's peel and "
                           "K6's step per peel")
    # from K1's decal layer to the sun pass: K5's decal step, nothing else
    ops, names, launched = decal_launches(run, fc, history, raster, kernels)
    _log(f"eager torch launches of the decal layer (from K1's decal call "
         f"to the sun pass): {ops}, by operator {json.dumps(names)}; "
         f"hand-written kernels launched there {launched}")
    if ops or launched != {"k5_resolve": 1}:
        raise RuntimeError("the decal layer launches more than K5's decal "
                           "step")
    host_free_phases(run, fc, history, kernels)
    if args.profile:
        profile_frame(run, fc, history)

    # 7. the small path: forward lighting with blend layers and the debug
    # draws, every view mode, pick and highlight
    rows[4:4] = small_path(dev, raster, clustered, taa)

    # 8. the BVH paths: the path tracer, then RT shadows and HBAO
    bvh_rows, pt = bvh_paths(dev, path, args.profile)
    rows += bvh_rows

    # 9. the rest of the port: the binary BVH and the alpha role of K4,
    # the CLI, the web viewer and band sharding
    rows += binary_phase(dev, path, pt)
    rows += alpha_phase(dev, path, pt)
    rows += cli_phase(dev, path)
    rows += viewer_phase(dev, path)
    rows += band_phase(dev, path, pt)
    # a bound counts the least work the inputs need: no kernel beats it
    shares = {r["name"]: r["bound_ms"] / r["ms"] for r in rows}
    _log("bound share (bound ms / ms): " + json.dumps(
        {k: round(v, 4) for k, v in shares.items()}))
    over = {k: v for k, v in shares.items() if v > 1.0}
    if over:
        raise RuntimeError(f"kernels faster than their bound: {over}")
    _log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
         " GiB")
    _log(json.dumps({"kernels": rows}))
    _log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# the stats every frame of the main path holds at 0: nothing dropped by a
# capacity, no pixel left on an alpha-failed peel
ZERO_STATS = ("bin_overflow", "big_overflow", "peel_overflow",
              "shadow_bin_overflow", "peel_chunk_overflow", "decal_overflow")


def exact_config(cfg):
    """cfg with the stochastic estimators off: exact trilinear fetches, no
    checkerboard, no chunk capacity (the frame before the JAX package's
    defaults were ported)."""
    return cfg.replace(stochastic_mip=False, stochastic_bilinear=False,
                       checkerboard_gathers=False, peel_chunk_capacity=0,
                       decal_chunk_capacity=0)


def _psnr(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _spread(ms) -> str:
    return (f"{float(np.median(ms)):.2f} ({min(ms):.2f}-{max(ms):.2f})")


def run_sequence(run, make_fc, dev, kernels):
    """FRAMES TAA frames of run(fc, history), the camera's small orbit and
    Halton jitter, from a history of zeros (bench.py's _frame_loop), each
    timed by CUDA events -> namespace(frame_ms, stats, histories (each
    frame's input history), per_frame (launches of each kernel per frame),
    out (the last frame), fc, prev_vp)."""
    import types
    import torch
    history = torch.zeros((H, W, 3), device=dev)
    prev_vp, frame_ms, stats, per_frame, histories = None, [], [], [], []
    for i in range(FRAMES):
        before = [k.launches for k in kernels]
        fc = make_fc(i, prev_vp)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = run(fc, history)
        end.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(end))
        stats.append(out["stats"])
        histories.append(history)
        history = out["accumulation"]
        prev_vp = fc.view_proj.cpu().numpy()
        per_frame.append([k.launches - n for k, n in zip(kernels, before)])
    return types.SimpleNamespace(frame_ms=frame_ms, stats=stats,
                                 histories=histories, per_frame=per_frame,
                                 out=out, fc=fc, prev_vp=prev_vp)


def atrium_path(dev):
    """The main path's set-up: the atrium built on the host and moved to the
    card, the sky probe and env BRDF, and the bench configuration's frame.
    -> namespace(host, scene, cfg, params, run(fc, history[, config]),
    make_fc(i, prev_view_proj))."""
    import types
    import torch
    from incarnation_tpu_torch.config import Config
    from incarnation_tpu_torch.core import mathutils as mu
    from incarnation_tpu_torch.kernels import ibl, raster, sky
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import cache, stress
    cfg = Config(sun_shadow_mode="map", masked_depth_peels=PEELS)
    t0 = time.perf_counter()
    path = stress.build_atrium(ATRIUM_DIR)
    host = cache.load_scene_cached(path, texture_max_dim=cfg.texture_max_dim,
                                   device=dev)
    torch.cuda.synchronize()
    scene = host.scene
    meta = scene.meta
    _log(f"scene: {meta.num_triangles} triangles, {meta.num_lights} lights, "
         f"{scene.mat_params.shape[0]} materials, "
         f"{scene.nbytes() / 2**20:.1f} MiB on the card, host build + load "
         f"{time.perf_counter() - t0:.1f} s")
    if not (meta.has_masked and meta.has_decals and meta.num_lights > 0):
        raise RuntimeError("the atrium lost its masked, decal or light layer")

    # sky probe and env BRDF, as the JAX bench builds them
    t0 = time.perf_counter()
    sun = scene.sun_dir.cpu().numpy()
    probe = cache.load_probe_cached(
        lambda: ibl.build_probe(
            sky.sky_latlong(scene.sun_dir, cfg.turbidity, 256, 128),
            envmap_size=cfg.envmap_resolution),
        key=f"sky:{sun.round(4).tolist()}:{cfg.turbidity}:"
            f"{cfg.envmap_resolution}", device=dev)
    env_brdf = ibl.pack_env_brdf(ibl.env_brdf_lut(128, device=dev))
    torch.cuda.synchronize()
    _log(f"probe + env BRDF built in {time.perf_counter() - t0:.1f} s")

    # the bench configuration, sun shadow map on
    params = raster.RasterParams(width=W, height=H, pair_capacity=1 << 18,
                                 bin_max_span=8)
    view0 = bench_view(host, W, H)
    jitters = mu.halton_jitter_table(16)
    shadow_bounds = (host.bounds_center,
                     float(np.linalg.norm(host.bounds_extent)) + 1e-3)

    def make_fc(i, prev_vp, sun_dir=None, view=None):
        return frame.FrameConstants.make(
            orbit(view0, ORBIT_RAD * i) if view is None else view, cfg,
            sun_dir=sun if sun_dir is None else sun_dir,
            sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
            jitter=jitters[i % 16] * 2.0 / np.array([W, H]),
            prev_view_proj=prev_vp, history_valid=i > 0, frame_index=i,
            shadow_bounds=shadow_bounds, device=dev)

    def run(fc, history, config=cfg, scene_bvh=None):
        return frame.render_frame(scene, fc, config=config, params=params,
                                  probe=probe, env_brdf=env_brdf,
                                  history=history, scene_bvh=scene_bvh)

    return types.SimpleNamespace(host=host, scene=scene, cfg=cfg,
                                 params=params, run=run, make_fc=make_fc,
                                 probe=probe, env_brdf=env_brdf, sun=sun,
                                 shadow_bounds=shadow_bounds)


def capture_frame(run, fc, history, raster, clustered, taa):
    """Run one frame with each kernel wrapper wrapped to record its
    arguments; returns [(kind, args, kwargs)] in launch order."""
    import torch
    calls = []
    with _capturing(calls, raster, clustered, taa):
        run(fc, history)
    torch.cuda.synchronize()
    return calls


@contextlib.contextmanager
def _capturing(calls, raster, clustered, taa, limit=None):
    """For the duration of the block, each K1, K2, K3 (its fetch, k3, and
    its resolve, k3r), K5 (k5, and its decal step, k5d), K6, K8, K9, K10,
    K11, K12, K13 (cull_lists), K14 and K15 wrapper call appends (kind,
    args, kwargs) to calls, at most `limit` per kind. K6 is the peel step
    (masked_peel), recorded before its launch by name (_k6_args) with a
    copy of the state it updates; a masked peel's z_limit, which the step
    overwrites, is copied too; the decal step is recorded before its
    launch by name (_k5d_args) with copies of the planes and n3 it
    updates."""
    from incarnation_tpu_torch.kernels import (cull, resolve, shading, shadow,
                                               skylight)

    def room(kind):
        return limit is None or sum(c[0] == kind for c in calls) < limit

    def keep(kind):
        def after(out, *a, **kw):
            if room(kind):
                if kw.get("z_limit") is not None:
                    kw = dict(kw, z_limit=kw["z_limit"].clone())
                calls.append((kind, a, kw))
        return after
    step = resolve.masked_peel

    def peel_step(*a, **kw):
        if room("k6"):
            x = _k6_args(a, kw)
            calls.append(("k6", (), dict(x, state=_peel_clone(x["state"]))))
        return step(*a, **kw)
    dstep = resolve.decal_step

    def decal_step(*a, **kw):
        if room("k5d"):
            calls.append(("k5d", (), _k5d_clone(_k5d_args(a, kw))))
        return dstep(*a, **kw)
    with contextlib.ExitStack() as stack:
        for mod, name, kind in ((raster, "rasterize_tiles", "k1"),
                                (clustered, "clustered_lighting", "k2"),
                                (taa, "history_fetch", "k3"),
                                (taa, "taa_resolve", "k3r"),
                                (shading, "sun_term", "k15"),
                                (resolve, "resolve_gbuffer", "k5"),
                                (skylight, "sky_lighting", "k8"),
                                (raster, "prepare_geometry", "k9"),
                                (raster, "bin_triangles_layered", "k10"),
                                (clustered, "build_light_clusters", "k11"),
                                (skylight, "environment_background",
                                 "k12"),
                                (cull, "cull_lists", "k13"),
                                (shadow, "sun_visibility", "k14")):
            stack.enter_context(_hooked(mod, name, keep(kind)))
        stack.enter_context(_swapped(resolve, "masked_peel", peel_step))
        stack.enter_context(_swapped(resolve, "decal_step", decal_step))
        yield calls


def _k1_bound(bins, params, z_limit, mask_table):
    """(bound ms, 'bytes' | 'operations', the operations' ms) of one K1
    launch on these bins:
    the pair lists, setup and attribute rows of the triangles they name and
    the z limits read once, 72 B/px of outputs written once (the depth-only
    role: no attribute rows, 8 B/px); 16 operations per (pair, tile pixel)
    that the pair's triangle covers (raster.covered_pair_pixels: the exact
    edge and depth test, z_limit and amask tests set aside, over the tiles
    that run -- a peel skips tiles whose limits are all 0)."""
    import torch
    from incarnation_tpu_torch.kernels import raster
    p = params
    counts = bins.counts.long()
    nt = p.num_tiles
    nbig = int(bins.big_count[0])
    live = torch.ones(nt, dtype=torch.bool, device=counts.device)
    if z_limit is not None:
        live = raster._tile_limits(z_limit, p).amax(dim=1) > 0.0
    counts = torch.where(live, counts, 0)
    n_live = int(live.sum())
    tiles = torch.repeat_interleave(torch.arange(nt, device=counts.device),
                                    counts)
    first = torch.cumsum(counts, 0) - counts
    pos = bins.starts.long()[tiles] + torch.arange(
        tiles.shape[0], device=counts.device) - first[tiles]
    used = torch.cat([bins.pair_tri.long()[pos],
                      bins.big_tri.long()[:nbig if n_live else 0]])
    n_tris = int(torch.unique(used).numel())
    rows, chans = ((raster.SETUP_ROWS, 0) if p.depth_only else
                   (raster.SETUP_ROWS + raster.ATTR_ROWS,
                    raster.INTERP_CHANNELS))
    nbytes = (4 * (int(counts.sum()) + nbig) + 8 * nt + 4 * n_tris * rows
              + p.width * p.height * (4 + 4 + 4 * chans))
    if z_limit is not None:
        nbytes += 4 * p.width * p.height
    if mask_table is not None:
        nbytes += mask_table.numel() * 4
    covered = raster.covered_pair_pixels(bins, p, z_limit)
    ops = K1_OPS_PER_PAIR_PIXEL * covered
    # the depth-only role's integer operations (its key race) counted too
    int_ops = K1D_INT_OPS_PER_PAIR_PIXEL * covered if p.depth_only else 0
    return (*_bound(nbytes, ops, int_ops), _bound(0, ops, int_ops)[0])


def _bound(nbytes, ops, int_ops=0):
    """(the least ms, 'bytes' | 'operations'): bytes over the HBM rate, or
    the float operations over the f32 rate, or the integer operations
    over the int32 rate (an SM issues the two kinds on separate units),
    whichever is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def compare_kernels(calls, raster, clustered, taa, launches, k1_by_layer):
    """Each captured call: kernel vs twin on the card (error, both times,
    the bound); returns the JSON rows."""
    import torch
    rows = []
    k1_calls = [c for c in calls if c[0] == "k1"]
    layers = {}
    for kind, a, kw in k1_calls:
        layers.setdefault(kw.get("name", "fine_raster"), []).append((a, kw))
    want = ["raster_decal", "raster_opaque", "raster_peel",
            "raster_shadow_depth"]
    if sorted(layers) != want:
        raise RuntimeError(f"captured K1 layers {sorted(layers)}")
    (sa, _), = layers["raster_shadow_depth"]
    _log(f"sun shadow pass: {int(sa[0].counts.sum())} tile pairs of a "
         f"capacity of {sa[1].pair_capacity}")
    for layer in ("raster_opaque", "raster_peel", "raster_decal",
                  "raster_shadow_depth"):
        rows.append(k1_row(raster, layer, layers[layer], k1_by_layer[layer]))

    (_, a, kw), = [c for c in calls if c[0] == "k2"]
    got = clustered.clustered_lighting(*a, **kw)
    ref = clustered.clustered_lighting_plain(*a, **kw)
    # the same light sums and dot products in the same order
    # (mathutils.dot3); K2 takes D x G / (4 NoV NoL) in one division where
    # the twin divides three times, a few ulps after the ulp-sensitive NoH
    err, rel = _close("K2", got, ref, rtol=K2_RTOL, atol_frac=1e-5,
                      where=a[0].mask)
    _log(f"K2: max abs err {err:.3e}, max relative err {rel:.3e} "
         f"(peak {float(ref.abs().max()):.3e})")
    k2_ops, k2_diag = _k2_work(*a, **kw)
    _log("K2 work: " + json.dumps(k2_diag))
    rows.append(dict(
        name="k2_clustered", route="cuda",
        source="incarnation_tpu_torch/csrc/clustered.cu",
        replaces="incarnation_tpu/kernels/clustered.py:526",
        launches=launches["k2_clustered"], max_abs_err=err, max_rel_err=rel,
        ms=device_ms(lambda: clustered.clustered_lighting(*a, **kw), 20),
        plain_ms=device_ms(lambda: clustered.clustered_lighting_plain(
            *a, **kw), 3),
        **dict(zip(("bound_ms", "bound_by"), _k2_bound(k2_ops, *a, **kw))),
        library_ms=None))

    # K3's fetch alone, on the inputs of the frame's resolve: no path
    # launches it since the resolve took the fetch in (0 launches)
    x, = _k3r_calls(taa, calls)
    rows.append(k3_row(taa, _k3_fetch_args(x), "k3_taa_fetch", 0))
    return rows


def k3_row(taa, a, name, n_launches):
    """K3's fetch alone (history_fetch, the k3_taa_fetch entry) against its
    twin on one fetch (history, depth, m, w, h and, for a band, its y_off
    halo rows; the main path's resolve makes it inside its one launch),
    both timed, with its bound and grid_sample's time on the same fetch ->
    the JSON row."""
    import torch
    history, depth, m, w, h, *rest = a
    y_off = rest[0] if rest else 0
    got = taa.history_fetch(*a)
    ref = taa.history_fetch_plain(*a)
    # the same f32 operations in the same order (K3 built --fmad=false)
    err, rel = _close(name, got, ref, rtol=1e-6, atol_frac=1e-7)
    _log(f"{name}: {w}x{h}, {y_off} halo rows each way; max abs err "
         f"{err:.3e}, max relative err {rel:.3e} (peak "
         f"{float(ref.abs().max()):.3e})")
    uv = taa.reproject_uv(depth, m, w, h)
    # the halo rows extend the image grid_sample clamps at its border
    gy = (uv[..., 1] * h + y_off) / (h + 2 * y_off)
    grid = (2.0 * torch.stack([uv[..., 0], gy], -1) - 1.0)[None]
    img = history.permute(2, 0, 1)[None].contiguous()

    def library():
        return torch.nn.functional.grid_sample(
            img, grid, mode="bilinear", padding_mode="border",
            align_corners=False)

    lib_err = float((library()[0].permute(1, 2, 0) - ref).abs().max())
    _log(f"{name} library yardstick (grid_sample on the reprojected grid): "
         f"max abs diff from the twin {lib_err:.3e}")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/taa.cu",
        replaces="incarnation_tpu/kernels/taa.py:195",
        launches=n_launches, max_abs_err=err, max_rel_err=rel,
        ms=device_ms(lambda: taa.history_fetch(*a), 50),
        plain_ms=device_ms(lambda: taa.history_fetch_plain(*a), 10),
        **dict(zip(("bound_ms", "bound_by"), _bound(
            w * h * (12 + 4 + 12) + 64, K3_OPS_PER_PIXEL * w * h))),
        library_ms=device_ms(library, 50))


def _k3r_calls(taa, calls) -> list:
    """The captured taa_resolve calls that launched K3's resolve (a history
    to resolve against, CUDA tensors), their arguments by name."""
    xs = [_bound_args(taa.taa_resolve_plain, a, kw)
          for kind, a, kw in calls if kind == "k3r"]
    return [x for x in xs if x["history_valid"] and x["current_hdr"].is_cuda]


def _k3r_role(taa, x) -> str:
    """K3's resolve role of a captured call: given (the stochastic
    history), shift (a static camera) or reproject."""
    if x["dither"] is not None:
        return "given"
    return "shift" if taa.static_shift(x["m_np"], x["width"],
                                       x["height"]) else "reproject"


def _k3_fetch_args(x):
    """history_fetch's arguments for a resolve's fetch: its history, depth,
    m as a tensor, the size and the halo rows."""
    import torch
    h = x["height"]
    return (x["history"], x["depth"],
            torch.as_tensor(x["m_np"], dtype=torch.float32,
                            device=x["depth"].device),
            x["width"], h, (x["history"].shape[0] - h) // 2)


def _same_or_nan(what, got, ref):
    """Raises unless got equals ref bit for bit where ref is a number and is
    NaN where ref is NaN (a NaN's payload is the instruction's)."""
    import torch
    if got.dtype != ref.dtype or got.shape != ref.shape:
        raise RuntimeError(f"{what} gave {got.dtype} {tuple(got.shape)}")
    nan = torch.isnan(ref)
    same = torch.where(nan, 0.0, got).view(torch.int32) \
        == torch.where(nan, 0.0, ref).view(torch.int32)
    bad = int((~same | (torch.isnan(got) != nan)).sum())
    if bad:
        raise RuntimeError(f"{what} differs from its twin on {bad} of "
                           f"{ref.numel()} values")


def _k3r_bound(taa, x):
    """(bound ms, by) of one K3 resolve: the current HDR and the output of
    every pixel, the fetch's depth and texel, the halo rows and m; its
    operations (K3R_*)."""
    w, h, role = x["width"], x["height"], _k3r_role(taa, x)
    px = w * h
    nbytes = px * (12 + 12 + 12 + (4 if role == "reproject" else 0)) + 64
    if x["hdr_halo"] is not None:
        nbytes += 2 * 12 * w
    fetch = {"reproject": K3_OPS_PER_PIXEL, "shift": K3R_OPS_SHIFT,
             "given": 0}[role]
    return _bound(nbytes, px * (K3R_OPS_RESOLVE + fetch))


def k3r_row(taa, calls, n_launches, name="k3_taa_resolve", role=None,
            halo=False):
    """K3's resolve against its twin (taa_resolve_plain), bit for bit (NaN
    for NaN), on a captured launch of `role` (with the band's halo rows if
    halo), timed, with its bound and registers -> the JSON row. The given
    role's time is its kernel's device time (torch.profiler): its call
    runs the stochastic history fetch in torch first."""
    xs = [x for x in _k3r_calls(taa, calls) if _k3r_role(taa, x) == role
          and (x["hdr_halo"] is not None) == halo]
    if not xs:
        raise RuntimeError(f"{name}: no K3 resolve of role {role} captured")
    x = xs[0]
    _same_or_nan(name, taa.taa_resolve(**x), taa.taa_resolve_plain(**x))
    bound, by = _k3r_bound(taa, x)
    if role == "given":
        ms = _k10_steps_ms(lambda: taa.taa_resolve(**x), prefix="k3_")[
            "k3_taa_resolve_kernel"]
    else:
        ms = device_ms(lambda: taa.taa_resolve(**x), 50)
    plain = device_ms(lambda: taa.taa_resolve_plain(**x), 10)
    host = host_ms(lambda: taa.taa_resolve(**x), 50)
    res = next((v for k, v in K11_K15_RESOURCES.items()
                if "k3_taa_resolve" in k), {})
    y_off = (x["history"].shape[0] - x["height"]) // 2
    _log(f"{name}: {x['width']}x{x['height']}, {role} fetch, {y_off} "
         f"history halo rows each way, HDR halo rows "
         f"{x['hdr_halo'] is not None}; {ms:.4f} ms a launch against the "
         f"bound {bound:.4f} ms ({by}), the host's work {host:.4f} ms a "
         f"call; twin {plain:.3f} ms; identical to the twin; "
         f"{res.get('registers')} registers, "
         f"{res.get('spill_bytes')} bytes spilled")
    return dict(
        name=name, route="cuda", source="incarnation_tpu_torch/csrc/taa.cu",
        replaces="incarnation_tpu/kernels/taa.py:195",
        launches=n_launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, host_ms=host,
        registers=res.get("registers"), spill_bytes=res.get("spill_bytes"))


def _k15_role(x) -> str:
    """K15's role of a captured sun_term call (its arguments by name):
    map, given or none, +extras."""
    src = ("map" if x["shadow_map"] is not None else
           "given" if x["visibility"] is not None else "none")
    return src + ("+extras" if x["extras"] is not None else "")


def _k14_from_k15(x) -> dict:
    """sun_visibility's arguments by name (the "+nl" form) for the tap of
    a captured sun_term call with a map (x: its arguments by name)."""
    return dict(world_pos=x["gb"].world_pos, n_dot_l=None,
                shadow_depth=x["shadow_map"], sun_vp=x["sun_vp"],
                resolution=x["resolution"], dither=x["dither"],
                checker_parity=x["checker_parity"], row0=x["row0"],
                normal=x["n"], sun_dir=x["sun_dir"])


def _k15_lit(x):
    """(H, W) bool: the covered pixels whose n.l > 0 (the twin's dot3 and
    clamp), where K15's visibility counts."""
    import torch
    from incarnation_tpu_torch.core import mathutils as mu
    no_l = torch.clamp(mu.dot3(x["n"], x["sun_dir"]), 0.0, 1.0)
    return x["gb"].mask & (no_l > 0.0)


def _k15_taps(shadow, x):
    """The taps K15's map role needs on these inputs (x: a sun_term call's
    arguments by name): -> (flat indices of the tapped pixels, their flat
    texel indices, the lit filling pixels). Without the checkerboard a lit
    pixel taps itself; with it, pair i's fetching pixel is tapped when
    pair i holds a lit pixel or the pair whose fill reads it (i - 1 where
    lane 0 fetches, i + 1 where lane 1 does) has a lit filling pixel."""
    import torch
    from incarnation_tpu_torch.kernels import checker
    lit = _k15_lit(x)
    h, w = lit.shape
    wp, row0, dither = x["gb"].world_pos, x["row0"], x["dither"]
    cp = x["checker_parity"]
    if cp is None:
        _, _, lin = shadow.sun_map_tap(wp, x["sun_vp"], x["resolution"],
                                       dither, row0)
        px = torch.nonzero(lit.reshape(-1)).squeeze(1)
        return px, lin.reshape(-1)[px], 0
    cp = int(cp) & 1
    fetch = checker.fetch_mask((h, w), cp, lit.device, row0)
    lit_f = lit[fetch].view(h, w // 2)
    lit_n = lit[~fetch].view(h, w // 2)
    rp = (torch.arange(row0, row0 + h, device=lit.device)[:, None]
          + cp) & 1
    off = torch.zeros_like(lit_n)
    reader = torch.where(rp == 0, torch.cat([off[:, :1], lit_n[:, :-1]], 1),
                         torch.cat([lit_n[:, 1:], off[:, :1]], 1))
    need = lit_f | lit_n | reader
    px = torch.nonzero(fetch.reshape(-1)).squeeze(1).view(h, w // 2)[need]
    _, _, lin = shadow.sun_map_tap(checker.compact(cp, wp, row0),
                                   x["sun_vp"], x["resolution"], dither,
                                   row0)
    return px, lin[need], int(lit_n.sum())


def _k15_bound(x, visibility: bool, taps=None):
    """(bound ms, by, covered pixels, lit pixels) of one K15 launch on these
    inputs: K15_* bytes and operations by pixel class, a lit pixel covered
    with n.l > 0 (the twin's dot3 and clamp); with the map role's taps
    (_k15_tap_work) in place of a visibility plane."""
    gb = x["gb"]
    px = gb.mask.numel()
    covered = int(gb.mask.sum())
    lit = int(_k15_lit(x).sum())
    extras = x["extras"] is not None
    lit_bytes = K15_LIT_BYTES + (K15_VIS_BYTES if visibility else 0) \
        + (K15_EXTRAS_BYTES if extras else 0)
    tap_bytes, tap_ops = taps or (0, 0)
    bound, by = _bound(
        px * K15_PIXEL_BYTES + covered * K15_COVERED_BYTES + lit * lit_bytes
        + 28 + tap_bytes, px * K15_OPS_PIXEL + covered * K15_OPS_COVERED
        + lit * (K15_OPS_LIT + (K15_OPS_EXTRAS if extras else 0)) + tap_ops)
    return bound, by, covered, lit


def _k15_tap_work(shadow, x):
    """(bytes, float operations, taps, sectors of world_pos, sectors of the
    map, distinct texels) of K15's map role's taps on these inputs: each
    32-byte sector of world_pos and of the map that the taps touch once,
    the normal of a tapped pixel that is not covered, K14's operations a
    tap and a lit filling pixel's tent; sun_vp's rows once."""
    import torch
    px, lin, fills = _k15_taps(shadow, x)
    wp_sec = torch.unique(torch.cat([(12 * px) // SECTOR_BYTES,
                                     (12 * px + 11) // SECTOR_BYTES]))
    map_sec = torch.unique((4 * lin) // SECTOR_BYTES)
    uncovered = int((~x["gb"].mask.reshape(-1)[px]).sum())
    n = int(px.numel())
    dither = x["dither"] is not None
    nbytes = SECTOR_BYTES * (int(wp_sec.numel()) + int(map_sec.numel())) \
        + 12 * uncovered + 48
    ops = n * (K14_OPS_TAP + K14_NL_OPS + dither * K14_OPS_DITHER) \
        + fills * K14_OPS_FILL
    return (nbytes, ops, n, int(wp_sec.numel()), int(map_sec.numel()),
            int(torch.unique(lin).numel()))


def k15_row(shading, calls, n_launches, name="k15_sun_term", role=None):
    """K15 against its twin on a captured sun_term launch of `role`, bit
    for bit (NaN for NaN), timed, with its bound and registers -> the JSON
    row. The map role's row also times, in turns with it (fused, two, two,
    fused), the two launches it replaced: K14's tap alone, then K15 on that
    visibility (two_launch_ms), and counts its taps."""
    from incarnation_tpu_torch.kernels import shadow
    xs = [x for x in (_bound_args(shading.sun_term_plain, a, kw)
                      for kind, a, kw in calls if kind == "k15")
          if _k15_role(x) == role]
    if not xs:
        raise RuntimeError(f"{name}: no K15 launch of role {role} captured")
    x = xs[0]
    _same_or_nan(name, shading.sun_term(**x), shading.sun_term_plain(**x))
    host = host_ms(lambda: shading.sun_term(**x), 50)
    extra, note = {}, ""
    if x["shadow_map"] is not None:
        nbytes, ops, n_taps, wp_sec, map_sec, texels = _k15_tap_work(shadow,
                                                                     x)
        bound, by, covered, lit = _k15_bound(x, False, (nbytes, ops))
        given = dict(x, shadow_map=None)

        def two():
            return shading.sun_term(**dict(given, visibility=(
                shadow.sun_visibility(**_k14_from_k15(x)))))
        _same_or_nan(f"{name} (K14 + K15)", two(),
                     shading.sun_term_plain(**x))
        runs = [device_ms(f, 50) for f in (
            lambda: shading.sun_term(**x), two, two,
            lambda: shading.sun_term(**x))]
        ms, two_ms = min(runs[0], runs[3]), min(runs[1], runs[2])
        extra = dict(two_launch_ms=two_ms, lit_pixels=lit, taps=n_taps)
        note = (f"; {n_taps} taps ({wp_sec} sectors of world_pos, "
                f"{map_sec} of the map, {texels} distinct texels); K14 + "
                f"K15 on its visibility {two_ms:.4f} ms in turns")
    else:
        bound, by, covered, lit = _k15_bound(x, x["visibility"] is not None)
        ms = device_ms(lambda: shading.sun_term(**x), 50)
    plain = device_ms(lambda: shading.sun_term_plain(**x), 5)
    # the compiled kernel of this role: the map's pair a thread under the
    # checkerboard, else a thread a pixel with or without the map's tap
    kernel = ("k15_sun_checker" if x["shadow_map"] is not None
              and x["checker_parity"] is not None else
              f"k15_sun_term_kernelILb{int(x['shadow_map'] is not None)}")
    res = next((v for k, v in K11_K15_RESOURCES.items() if kernel in k), {})
    h, w = x["gb"].mask.shape
    _log(f"{name}: {w}x{h}, {role} role (dither {x['dither']}, checker "
         f"{x['checker_parity']}), {covered} covered pixels, {lit} with "
         f"n.l > 0; {ms:.4f} ms a launch against the bound {bound:.4f} ms "
         f"({by}){note}; the call's host work {host:.4f} ms; twin "
         f"{plain:.3f} ms; identical to the twin; {kernel}: "
         f"{json.dumps(res)}")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/shading.cu",
        replaces="incarnation_tpu/kernels/shading.py:77",
        launches=n_launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, host_ms=host,
        registers=res.get("registers"), spill_bytes=res.get("spill_bytes"),
        **extra)


def half_lit_view(run, run_exact, make_fc, calls, prev_vp, history,
                  exact_history):
    """The main path's next frame lit by another sun: of 256 directions
    over the upper hemisphere, the one whose n.l > 0 at the largest share
    of the frame's covered pixels (every 16th of them, from the captured
    normals), which must be at least half; its frame rendered with the
    estimators on and off, each captured -> (calls, exact calls)."""
    import torch
    from incarnation_tpu_torch.kernels import clustered, raster, shading, taa
    x = next(_bound_args(shading.sun_term_plain, a, kw)
             for kind, a, kw in calls if kind == "k15")
    k = torch.arange(256, dtype=torch.float64)
    y = 0.05 + 0.95 * (k + 0.5) / 256
    r = torch.sqrt(1.0 - y * y)
    phi = k * (np.pi * (3.0 - np.sqrt(5.0)))
    dirs = torch.stack([r * torch.cos(phi), y, r * torch.sin(phi)], -1).to(
        device=x["n"].device, dtype=torch.float32)
    mask = x["gb"].mask
    share = ((x["n"][mask][::16] @ dirs.T) > 0.0).float().mean(0)
    best = int(torch.argmax(share))
    sun = dirs[best].cpu().numpy()
    _log(f"half-lit view: the sun {sun.round(4).tolist()} faces "
         f"{float(share[best]):.4f} of the covered pixels sampled (the "
         f"frame's sun {float(_k15_lit(x)[mask].float().mean()):.4f})")
    if float(share[best]) < 0.5:
        raise RuntimeError("no sun direction lights half of the covered "
                           "pixels")
    fc = make_fc(FRAMES, prev_vp, sun_dir=sun)
    return (capture_frame(run, fc, history, raster, clustered, taa),
            capture_frame(run_exact, fc, exact_history, raster, clustered,
                          taa))


def _k5_args(a, kw):
    """A captured resolve_gbuffer call -> its arguments by name, defaults
    filled (tri, depth, scene, interp, inv_view_proj, width, height,
    return_normal3 and the stochastic roles' mip_dither, uv_dither,
    max_aniso, coverage_capacity, checker_parity, row0)."""
    from incarnation_tpu_torch.kernels import resolve
    return dict(_bound_args(resolve.resolve_gbuffer_plain, a, kw))


def _k5_role(x) -> str:
    """The role name a resolve_gbuffer call counts under (_k5_args)."""
    from incarnation_tpu_torch.kernels import resolve
    cap = x["coverage_capacity"]
    return resolve.role_name(resolve._role(
        x["mip_dither"], x["uv_dither"], resolve._checker_on(
            x["checker_parity"], x["uv_dither"], x["width"], cap)),
        cap is not None)


def _k8_role(x) -> str:
    """The role name a sky_lighting call counts under (_bound_args)."""
    if x["dither"] is None:
        return "exact"
    return ("jitter" if x["uv_dither"] and x["probe"].prefiltered.packed
            else "dither") + ("_checker" if x["checker_parity"] is not None
                              else "")


def _k5_error(got, ref):
    """(max abs error, max relative error) of one K5 launch against its
    twin; raises past the tolerance. The mask and uv must be identical and
    every float plane must agree per element to K5_RTOL of the twin's
    value + 1e-5 of its median: K5 repeats the twin's operations in order
    (--fmad=false) but for torch.cross and torch.matmul, which round in
    their own order on the card."""
    import torch
    if isinstance(got, tuple):
        (got, g3), (ref, r3) = got, ref
        planes = [("normal3", g3, r3)]
    else:
        planes = []
    if not (torch.equal(got.mask, ref.mask) and torch.equal(got.uv, ref.uv)):
        raise RuntimeError("K5 mask or uv differs from its twin")
    planes += [(f, getattr(got, f), getattr(ref, f))
               for f in ("base_color", "normals", "mrao", "emissive",
                         "world_pos", "extras")]
    err = rel = 0.0
    for name, g, r in planes:
        e, q = _close(f"K5 {name}", g, r, rtol=K5_RTOL, atol_frac=1e-5)
        err, rel = max(err, e), max(rel, q)
    return err, rel


def _rows_touched(fn, tables):
    """Runs fn (a twin) with mathutils.gather_rows recording the rows it
    gathers from each table of `tables` ({name: (table, pixel mask or
    None)}), the rows of masked pixels only; a mask may be a tuple of
    masks of several shapes (a checkerboard's whole and compacted
    layers), the one whose shape leads the gather's indices applies.
    -> {name: distinct rows}."""
    import torch
    from incarnation_tpu_torch.core import mathutils as mu
    seen = {name: [] for name in tables}
    gather = mu.gather_rows

    def rec(table, idx):
        for name, (t, where) in tables.items():
            if table is t:
                i = torch.clamp(idx, 0, t.shape[0] - 1)
                if where is not None:
                    m = where if not isinstance(where, tuple) else next(
                        w for w in where
                        if tuple(i.shape[:w.dim()]) == tuple(w.shape))
                    i = i[m.reshape(m.shape + (1,) * (i.dim() - m.dim()))
                          .expand(i.shape)]
                seen[name].append(i.reshape(-1))
        return gather(table, idx)
    with _swapped(mu, "gather_rows", rec):
        fn()
    return {name: int(torch.unique(torch.cat(v)).numel()) if v else 0
            for name, v in seen.items()}


def _k5_bound(resolve, x):
    """(bound ms, 'bytes' | 'operations') of one K5 launch (_k5_args): see
    K5_OPS_* and, for the stochastic roles, K5S_* (the checkerboard's
    K5C_*). The texture blocks and
    rows are those the twin gathers for the pixels that fetch: the
    covered ones, or under the checkerboard the fetching parity's pixels
    with a covered pixel among them and their horizontal neighbours."""
    from incarnation_tpu_torch.kernels import checker
    tri, scene, interp = x["tri"], x["scene"], x["interp"]
    w, h, n3 = x["width"], x["height"], bool(x["return_normal3"])
    st = scene.mat_stack
    cov = tri >= 0
    role = _k5_role(x)
    fetch = cov
    if "checker" in role:
        near = cov.clone()
        near[:, 1:] |= cov[:, :-1]
        near[:, :-1] |= cov[:, 1:]
        fetch = near & checker.fetch_mask(cov.shape, x["checker_parity"],
                                          tri.device, x["row0"])
    if x["coverage_capacity"] is not None:
        fetch = fetch & resolve._keep_pixels(
            resolve.chunk_keep(cov, x["coverage_capacity"]), cov.shape)
    mat = interp[9].to(dtype=tri.dtype).clamp(0, st.meta.shape[0] - 1)
    has_ex = (st.meta[mat.long(), 4] >= 0) & (st.extra.shape[0] > 1)
    masks = {"flat": fetch, "extra": fetch & has_ex, "meta": cov | fetch}
    if "checker" in role:
        # the twin gathers the texels at the compacted (H, W / 2) layer
        masks = {k: (m, checker.compact(x["checker_parity"], m, x["row0"]))
                 for k, m in masks.items()}
    rows = _rows_touched(
        lambda: resolve.resolve_gbuffer_plain(**x),
        {"flat": (st.flat, masks["flat"]), "extra": (st.extra, masks["extra"]),
         "meta": (st.meta, masks["meta"]),
         "params": (scene.mat_params, cov)})
    n_cov, n_fetch = int(cov.sum()), int(fetch.sum())
    n_ex = int((fetch & has_ex).sum())
    tables = (64 + 32 * rows["flat"] + 24 * rows["extra"]
              + 24 * rows["meta"] + 64 * rows["params"])
    out = w * h * (K5_OUT_BYTES + 12 * n3)
    if role == "exact":
        return _bound(w * h * (4 + 8) + out + n_cov * 13 * 4 + tables,
                      n_cov * K5_OPS_PER_COVERED + n_ex * K5_OPS_PER_EXTRAS)
    # every pixel reads tri, uv, its material and derivatives (its uv
    # moves along its major axis), a covered one depth and 7 TBN channels;
    # the chunk flags a byte a chunk
    nbytes = (w * h * (4 + 8 + 20) + out + n_cov * 8 * 4 + tables
              + (w * h // 128 if x["coverage_capacity"] is not None else 0))
    n_fill = int((cov & ~fetch).sum()) if "checker" in role else 0
    if "checker" in role:
        ops = (w * h * K5C_OPS_UV + n_fetch * (K5C_OPS_LOD + K5S_OPS_POINT)
               + n_ex * (K5_OPS_PER_EXTRAS // 8) + n_cov * K5C_OPS_SHADE
               + n_fill * K5S_OPS_FILL)
        return _bound(nbytes, ops, w * h * K5C_INT_OPS_UV
                      + n_fetch * K5C_INT_OPS_FETCH)
    texel = K5S_OPS_POINT if "jitter" in role else K5S_OPS_BILINEAR
    ops = (n_cov * K5S_OPS_PER_COVERED + n_fetch * texel
           + n_ex * (K5_OPS_PER_EXTRAS // 8) * (1 if "jitter" in role else 4)
           + n_fill * K5S_OPS_FILL)
    return _bound(nbytes, ops, w * h * K5S_INT_OPS)


def k5_footprints(resolve, tri, scene, interp, warp_px: int = 32) -> dict:
    """What K5's texture work is on one launch's inputs, from the twin's
    LOD and addressing (textures.py sample_material_stack): the share of
    covered pixels whose second level K5 skips (its weight frac is 0), the
    share of warps (K5's rows of warp_px pixels) with a covered pixel in
    which every covered pixel skips it, and the mean number of distinct
    4x4 blocks per bilinear footprint K5 fetches and per warp and level
    (level 0, and level 1 where not skipped)."""
    import torch
    from incarnation_tpu_torch.scene import textures as tex
    h, w = tri.shape
    cov = tri >= 0
    if not bool(cov.any()):
        return dict(skipped_share=0.0, skipped_warp_share=0.0,
                    blocks_per_footprint=0.0, blocks_per_warp_level=0.0)
    mat = interp[9].to(torch.int32)
    meta = tex.stack_meta_lookup(scene.mat_stack, mat)
    size, levels, mode = meta[..., 1], meta[..., 2], meta[..., 3]
    lod = torch.minimum(
        torch.clamp(resolve._interp_lod(scene, mat, interp), min=0.0),
        (levels - 1).to(torch.float32))
    l0 = torch.floor(lod).to(torch.int32)
    skip = (lod - l0) == 0
    xw = torch.arange(w, device=tri.device) // warp_px
    warp = (torch.arange(h, device=tri.device)[:, None]
            * ((w + warp_px - 1) // warp_px) + xw[None, :])

    def footprint(level, where):
        s = torch.clamp(size >> level, min=1)
        s4 = torch.clamp(s >> 2, min=1)
        base = meta[..., 0] + tex._level_offset_blocks(size, levels, level)
        x0 = torch.floor(interp[0] * s - 0.5).to(torch.int32)
        y0 = torch.floor(interp[1] * s - 0.5).to(torch.int32)
        cols = [tex._address(x, s, mode) >> 2 for x in (x0, x0 + 1)]
        rows = [tex._address(y, s, mode) >> 2 for y in (y0, y0 + 1)]
        n = (1 + (cols[0] != cols[1]).int()) * (1 + (rows[0] != rows[1]).int())
        ids = torch.stack([base + r * s4 + c for r in rows for c in cols])
        keys = (warp[None].to(torch.int64) << 32) + ids.to(torch.int64)
        return n[where], torch.unique(keys[:, where]), torch.unique(
            warp[where])

    n0, k0, w0 = footprint(l0, cov)
    n1, k1, w1 = footprint(torch.minimum(l0 + 1, levels - 1), cov & ~skip)
    n_warps = int(torch.unique(warp[cov]).numel())
    return dict(
        skipped_share=float(skip[cov].float().mean()),
        skipped_warp_share=1.0 - int(w1.numel()) / n_warps,
        blocks_per_footprint=float(torch.cat([n0, n1]).float().mean()),
        blocks_per_warp_level=(k0.numel() + k1.numel())
        / (w0.numel() + w1.numel()))


def k5_row(resolve, calls, n_launches, name="k5_resolve", role=None):
    """K5 against its twin on each captured resolve_gbuffer launch of
    `role` (all where None): error, both times and the bound, each the
    mean over the launches; the time and bound of each launch, K5's
    registers and spills, and per launch k5_footprints' skipped share and
    blocks per footprint -> the JSON row."""
    launches = [x for x in (_k5_args(a, kw) for kind, a, kw in calls
                            if kind == "k5")
                if role is None or _k5_role(x) == role]
    if not launches:
        raise RuntimeError(f"{name}: no K5 launch was captured")
    errs, ms, plain_ms, bounds, bound_by = [], [], [], [], set()
    feet = []
    for x in launches:
        feet.append(k5_footprints(resolve, x["tri"], x["scene"],
                                  x["interp"]))
        errs.append(_k5_error(resolve.resolve_gbuffer(**x),
                              resolve.resolve_gbuffer_plain(**x)))
        ms.append(device_ms(lambda: resolve.resolve_gbuffer(**x), 20))
        plain_ms.append(device_ms(
            lambda: resolve.resolve_gbuffer_plain(**x), 2))
        b, by = _k5_bound(resolve, x)
        bounds.append(b)
        bound_by.add(by)
    _log(f"{name}: per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; twin ms " + ", ".join(f"{t:.2f}" for t in plain_ms)
         + "; bound ms " + ", ".join(f"{t:.4f}" for t in bounds)
         + "; covered share " + ", ".join(
             f"{float((x['tri'] >= 0).float().mean()):.4f}"
             for x in launches)
         + "; max abs err " + ", ".join(f"{e[0]:.3e}" for e in errs)
         + ", max relative err " + ", ".join(f"{e[1]:.3e}" for e in errs))
    res = role_resources("k5", role or "exact")
    _log(f"{name}: texture work per launch {json.dumps(feet)}; "
         f"{res.get('registers')} registers, "
         f"{res.get('spill_bytes')} bytes spilled")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/resolve.cu",
        replaces="incarnation_tpu/kernels/resolve.py:242",
        launches=n_launches, max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs),
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        library_ms=None, ms_per_launch=ms, bound_ms_per_launch=bounds,
        registers=res.get("registers"),
        spill_bytes=res.get("spill_bytes"),
        skipped_share=[f["skipped_share"] for f in feet],
        blocks_per_footprint=[f["blocks_per_footprint"] for f in feet])


def _k5d_args(a, kw):
    """A captured decal_step call -> its arguments by name, defaults
    filled (scene, d_tri, d_depth, d_interp, depth, gb, n3,
    inv_view_proj, width, height, coverage_capacity, mip_dither,
    uv_dither, max_aniso, row0)."""
    from incarnation_tpu_torch.kernels import resolve
    return dict(_bound_args(resolve.decal_step_plain, a, kw))


def _k5d_clone(x):
    """x (_k5d_args) with copies of the planes and n3 the decal step
    updates in place."""
    import dataclasses
    gb = x["gb"]
    return dict(x, gb=dataclasses.replace(
        gb, base_color=gb.base_color.clone(), normals=gb.normals.clone(),
        mrao=gb.mrao.clone()),
        n3=None if x["n3"] is None else x["n3"].clone())


def _k5d_role(x) -> str:
    """The role name a decal_step call counts under (_k5d_args)."""
    from incarnation_tpu_torch.kernels import resolve
    return "decal_" + resolve.role_name(
        resolve._role(x["mip_dither"], x["uv_dither"]),
        x["coverage_capacity"] is not None)


def _k5d_run(step, x):
    """step (decal_step or its twin) on fresh copies of x's planes ->
    (overflow, base_color, normals, mrao, n3)."""
    y = _k5d_clone(x)
    over = step(**y)
    gb = y["gb"]
    return over, gb.base_color, gb.normals, gb.mrao, y["n3"]


def _k5d_pixels(resolve, x) -> dict:
    """The decal step's pixels on x's layer: (H, W) bool masks of the
    decal pixels (decal), those of chunks the capacity keeps (kept), those
    that pass the depth test (passing) and those whose decal is opaque
    there (opaque, from the twin's opacity)."""
    import torch
    dec = x["d_tri"] >= 0
    cap = x["coverage_capacity"]
    kept = dec if cap is None else dec & resolve._keep_pixels(
        resolve.chunk_keep(dec, cap), dec.shape)
    passing = kept & (x["d_depth"] >= x["depth"] - 1e-5)
    d_gb = resolve.resolve_gbuffer_plain(
        x["d_tri"], x["d_depth"], x["scene"], x["d_interp"],
        x["inv_view_proj"], x["width"], x["height"],
        mip_dither=x["mip_dither"], uv_dither=x["uv_dither"],
        max_aniso=x["max_aniso"], coverage_capacity=cap, row0=x["row0"])
    opaque = passing & (d_gb.base_color[..., 3] > 0.5)
    return dict(decal=dec, kept=kept, passing=passing, opaque=opaque)


def _k5d_error(resolve, x) -> int:
    """Raises unless one decal step equals its twin bit for bit: the
    overflow, the base colour, normals, mrao and n3 it writes (NaN
    payloads included). -> the decal pixels that pass the depth test."""
    import torch
    got = _k5d_run(resolve.decal_step, x)
    ref = _k5d_run(resolve.decal_step_plain, x)
    if got[0].dtype != torch.int64 or got[0].shape != () \
            or int(got[0]) != int(ref[0]):
        raise RuntimeError(f"K5's decal step: overflow {got[0]}, its twin "
                           f"{int(ref[0])}")
    for name, g, r in zip(("base_color", "normals", "mrao", "n3"), got[1:],
                          ref[1:]):
        if g is None and r is None:
            continue
        if not torch.equal(g.view(torch.int32), r.view(torch.int32)):
            raise RuntimeError(f"K5's decal step: {name} differs from its "
                               f"twin on {int((g != r).sum())} elements")
    return int(((x["d_tri"] >= 0)
                & (x["d_depth"] >= x["depth"] - 1e-5)).sum())


def _k5d_bound(resolve, x):
    """((bound ms, 'bytes' | 'operations'), pixel counts) of one decal
    step (_k5d_args): see K5D_*. The texture blocks and material rows are
    those the twin gathers for the passing pixels."""
    import torch
    w, h = x["width"], x["height"]
    px = _k5d_pixels(resolve, x)
    n = {k: int(v.sum()) for k, v in px.items()}
    st, scene = x["scene"].mat_stack, x["scene"]
    mat = x["d_interp"][9].to(torch.int32).clamp(0, st.meta.shape[0] - 1)
    has_ex = (st.meta[mat.long(), 4] >= 0) & (st.extra.shape[0] > 1)
    n_ex = int((px["passing"] & has_ex).sum())
    rows = _rows_touched(
        lambda: resolve.resolve_gbuffer_plain(
            x["d_tri"], x["d_depth"], scene, x["d_interp"],
            x["inv_view_proj"], w, h, mip_dither=x["mip_dither"],
            uv_dither=x["uv_dither"], max_aniso=x["max_aniso"],
            coverage_capacity=x["coverage_capacity"], row0=x["row0"]),
        {"flat": (st.flat, px["passing"]),
         "extra": (st.extra, px["passing"] & has_ex),
         "meta": (st.meta, px["passing"]),
         "params": (scene.mat_params, px["passing"])})
    role = _k5d_role(x).removeprefix("decal_").split("+")[0]
    n3 = x["n3"] is not None
    blocks = -(-w * h // (8 * 128))
    nbytes = (w * h * K5D_PIXEL_BYTES + n["kept"] * K5D_DECAL_BYTES
              + n["passing"] * K5D_PASS_BYTES
              + n["opaque"] * (K5D_OPAQUE_BYTES + K5D_N3_BYTES * n3)
              + 32 * rows["flat"] + 24 * rows["extra"] + 24 * rows["meta"]
              + 64 * rows["params"] + 8
              + (blocks * K5D_BLOCK_BYTES
                 if x["coverage_capacity"] is not None else 0))
    ops = (n["passing"] * (K5D_OPS_FETCH[role] + K5D_OPS_PASS)
           + n_ex * K5D_OPS_EXTRAS[role]
           + n["opaque"] * (K5D_OPS_OPAQUE + K5D_OPS_N3 * n3))
    int_ops = n["passing"] * K5D_INT_OPS if role != "exact" else 0
    return _bound(nbytes, ops, int_ops), n


def _k5d_parent(resolve, x):
    """The frame's decal code before K5's decal step, on x: K5's launch
    on the decal layer (resolve_gbuffer under the capacity), the chunk
    overflow and the eager composite -> (overflow, base_color, normals,
    mrao, n3), new tensors."""
    import torch
    from incarnation_tpu_torch.core import mathutils as mu
    cap, gb, n3 = x["coverage_capacity"], x["gb"], x["n3"]
    d_gb = resolve.resolve_gbuffer(
        x["d_tri"], x["d_depth"], x["scene"], x["d_interp"],
        x["inv_view_proj"], x["width"], x["height"],
        coverage_capacity=cap, mip_dither=x["mip_dither"],
        uv_dither=x["uv_dither"], max_aniso=x["max_aniso"], row0=x["row0"])
    over = (resolve.chunk_overflow(x["d_tri"] >= 0, cap) if cap is not None
            else None)
    covers = d_gb.mask & (x["d_depth"] >= x["depth"] - 1e-5)
    a = torch.where(covers, d_gb.base_color[..., 3], 0.0)[..., None]
    opaque = a > 0.5
    base = torch.cat([gb.base_color[..., :3] * (1 - a)
                      + d_gb.base_color[..., :3] * a,
                      gb.base_color[..., 3:]], -1)
    normals = torch.where(opaque, d_gb.normals, gb.normals)
    mrao = torch.where(opaque, d_gb.mrao, gb.mrao)
    if n3 is not None:
        n3 = torch.where(opaque, mu.oct_decode(d_gb.normals), n3)
    return over, base, normals, mrao, n3


def k5d_row(resolve, calls, n_launches, name="k5_decal_step"):
    """K5's decal step against its twin (bit for bit) on each captured
    decal_step launch, timed in turns (step, K5, K5 + glue, K5 + glue,
    K5, step; the smaller of each's two times) against the K5 decal
    launch it replaced (resolve_gbuffer on the layer under its capacity)
    and against that launch with the frame's eager decal code around it
    (_k5d_parent), with its twin's time, its bound (K5D_*, of the step's
    own work) and its registers -> the JSON row (means over the
    launches)."""
    launches = [kw for kind, _, kw in calls if kind == "k5d"]
    if not launches:
        raise RuntimeError(f"{name}: no decal step was captured")
    ms, k5_ms, glue_ms, plain_ms, bounds, bound_by, counts = \
        [], [], [], [], [], set(), []
    for x in launches:
        _k5d_error(resolve, x)
        y = _k5d_clone(x)
        fns = (lambda: resolve.decal_step(**y),
               lambda: resolve.resolve_gbuffer(
                   x["d_tri"], x["d_depth"], x["scene"], x["d_interp"],
                   x["inv_view_proj"], x["width"], x["height"],
                   coverage_capacity=x["coverage_capacity"],
                   mip_dither=x["mip_dither"], uv_dither=x["uv_dither"],
                   max_aniso=x["max_aniso"], row0=x["row0"]),
               lambda: _k5d_parent(resolve, x))
        t = [device_ms(fns[i], 20) for i in (0, 1, 2, 2, 1, 0)]
        ms.append(min(t[0], t[5]))
        k5_ms.append(min(t[1], t[4]))
        glue_ms.append(min(t[2], t[3]))
        z = _k5d_clone(x)
        plain_ms.append(device_ms(lambda: resolve.decal_step_plain(**z), 2))
        (b, by), n = _k5d_bound(resolve, x)
        bounds.append(b)
        bound_by.add(by)
        counts.append(n)
    res = role_resources("k5", _k5d_role(launches[0]))
    _log(f"{name} ({', '.join(sorted({_k5d_role(x) for x in launches}))}): "
         "per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; the K5 decal launch it replaced ms "
         + ", ".join(f"{t:.4f}" for t in k5_ms)
         + "; K5 and the frame's eager decal code ms "
         + ", ".join(f"{t:.4f}" for t in glue_ms)
         + "; twin ms " + ", ".join(f"{t:.3f}" for t in plain_ms)
         + "; bound ms " + ", ".join(f"{t:.5f}" for t in bounds)
         + f"; pixels (decal, in kept chunks, passing the depth test, "
         f"opaque) {[tuple(c.values()) for c in counts]}; identical to the "
         f"twin; {res.get('registers')} registers, "
         f"{res.get('spill_bytes')} bytes spilled")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/resolve.cu",
        replaces="incarnation_tpu/renderer/frame.py:329",
        launches=n_launches, max_abs_err=0.0,
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        library_ms=None, k5_decal_launch_ms=float(np.mean(k5_ms)),
        k5_and_glue_ms=float(np.mean(glue_ms)), ms_per_launch=ms,
        passing_pixels=[c["passing"] for c in counts],
        registers=res.get("registers"), spill_bytes=res.get("spill_bytes"))


def decal_view(path, run_exact, prev_vp, history, exact_history):
    """A view of the atrium whose decal layer covers at least 10,000
    pixels that pass its depth test: for each decal primitive (its
    bounding sphere's world centre), a camera 2 and then 3.5 units above
    it and behind it, looking at it, the first whose frame (estimators on,
    captured) has that many; its frame rendered with the estimators on and
    off, each captured -> (calls, exact calls)."""
    import torch
    from incarnation_tpu_torch.core import mathutils as mu
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.kernels import clustered, raster, taa
    scene = path.scene
    fc = path.make_fc(FRAMES, prev_vp)
    decal = torch.nonzero(scene.prim_is_decal > 0).flatten()
    world = mu.rows_mat(scene.mesh_transforms, fc.scene_rotation)
    xf = world[scene.prim_mesh.long()[decal]]
    c = scene.prim_bsphere[decal, :3]
    centers = (c[:, 0:1] * xf[:, 0, :3] + c[:, 1:2] * xf[:, 1, :3]
               + c[:, 2:3] * xf[:, 2, :3] + xf[:, 3, :3]).cpu().numpy()
    tried = []
    for height in (2.0, 3.5):
        for k, center in enumerate(centers):
            # the glTF camera's handedness (bench_view): right = look x up
            pos = (center + np.float32([0.0, height, -0.6 * height])) \
                .astype(np.float32)
            look = (center - pos) / np.linalg.norm(center - pos)
            right = np.cross(look, [0.0, 1.0, 0.0])
            right /= np.linalg.norm(right)
            view = View(position=pos, right=right.astype(np.float32),
                        up=np.cross(right, look).astype(np.float32),
                        look=look.astype(np.float32), aspect=W / H)
            fc = path.make_fc(FRAMES, prev_vp, view=view)
            calls = capture_frame(path.run, fc, history, raster, clustered,
                                  taa)
            x, = [kw for kind, _, kw in calls if kind == "k5d"]
            covered = int(((x["d_tri"] >= 0)
                           & (x["d_depth"] >= x["depth"] - 1e-5)).sum())
            tried.append((int(decal[k]), height, covered))
            if covered >= 10_000:
                _log(f"decal view: decal primitive {int(decal[k])} from "
                     f"{height} units above, {covered} decal pixels pass "
                     f"the depth test (tried: primitive, height, pixels "
                     f"{tried})")
                return calls, capture_frame(run_exact, fc, exact_history,
                                            raster, clustered, taa)
    raise RuntimeError(f"no view of a decal covers 10,000 pixels: {tried}")


def decal_launches(run, fc, history, raster, kernels):
    """What the frame launches for its decal layer beside K1's: every
    eager torch operator that runs work on the card (_launches_work)
    from the return of K1's decal call (rasterize_tiles, name
    raster_decal) to the sun pass (shadow.render_sun_shadow_map), counted
    by a TorchDispatchMode over one frame, and the hand-written kernels
    launched there. -> (operators, operators by name, kernel launches by
    kernel)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from incarnation_tpu_torch.kernels import shadow
    ops, marks = [], []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _launches_work(func):
                ops.append(func.name())
            return func(*args, **(kwargs or {}))
    k1, smap = raster.rasterize_tiles, shadow.render_sun_shadow_map

    def mark():
        marks.append((len(ops), [k.launches for k in kernels]))

    def k1_marked(*a, **kw):
        out = k1(*a, **kw)
        if kw.get("name") == "raster_decal":
            mark()
        return out

    def sun_marked(*a, **kw):
        if len(marks) == 1:
            mark()
        return smap(*a, **kw)
    with _swapped(raster, "rasterize_tiles", k1_marked), \
            _swapped(shadow, "render_sun_shadow_map", sun_marked), Count():
        run(fc, history)
    torch.cuda.synchronize()
    if len(marks) != 2:
        raise RuntimeError("the frame has no decal layer before its sun pass")
    (o0, n0), (o1, n1) = marks
    names = {}
    for op in ops[o0:o1]:
        names[op] = names.get(op, 0) + 1
    return o1 - o0, names, {k.fn: b - a for k, a, b in zip(kernels, n0, n1)
                            if b > a}


def _peel_clone(state):
    """A copy of a PeelState: K6's peel step updates its argument in
    place."""
    import dataclasses
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)})


def _k6_args(a, kw):
    """A captured masked_peel call -> its arguments by name, defaults
    filled (scene, m_tri, m_depth, m_interp, state (a copy taken before
    the call), row0 and the stochastic roles')."""
    from incarnation_tpu_torch.kernels import resolve
    return dict(_bound_args(resolve.masked_peel_plain, a, kw))


def _k6_role(x) -> str:
    """The role name a masked_peel call counts under (_k6_args)."""
    from incarnation_tpu_torch.kernels import resolve
    return "step_" + resolve.role_name(
        resolve._role(x["mip_dither"], x["uv_dither"]),
        x["coverage_capacity"] is not None)


def _k6_alpha_args(x) -> dict:
    """The alpha test of a captured peel step as a masked_alpha call (K6's
    standalone role) on the peel's layer."""
    return dict(scene=x["scene"], tri=x["m_tri"], interp=x["m_interp"],
                row0=x["row0"], mip_dither=x["mip_dither"],
                uv_dither=x["uv_dither"], max_aniso=x["max_aniso"],
                coverage_capacity=x["coverage_capacity"])


def _k6_step(resolve, x):
    """K6's peel step on a copy of the captured state -> the new state."""
    return resolve.masked_peel(**dict(x, state=_peel_clone(x["state"])))


def _peel_twin(resolve, x):
    """The peel step's twin in torch throughout (masked_peel_plain with
    its alpha test by masked_alpha_plain) on a copy of the captured
    state -> the new state."""
    with _swapped(resolve, "masked_alpha", resolve.masked_alpha_plain):
        return resolve.masked_peel_plain(
            **dict(x, state=_peel_clone(x["state"])))


def _k6_alpha_error(got, ref, tri):
    """(max abs error, max relative error, elements not identical) of one
    launch of K6's standalone role (masked_alpha) against its twin. The
    pass/fail decision alpha >= thresh must be the twin's on every hit
    pixel (it picks the peel's fragment), and alpha and the threshold
    must agree to 1e-6 relative; K6 repeats the twin's operations in
    order, so both are expected to be identical."""
    (ga, gt), (ra, rt) = got, ref
    hit = tri >= 0
    flips = int(((ga >= gt) != (ra >= rt))[hit].sum())
    if flips:
        raise RuntimeError(f"K6 decides {flips} hit pixels otherwise than "
                           "its twin")
    err = rel = 0.0
    for what, g, r in (("alpha", ga, ra), ("threshold", gt, rt)):
        e, q = _close(f"K6 {what}", g, r, rtol=1e-6, atol_frac=1e-7)
        err, rel = max(err, e), max(rel, q)
    return err, rel, int((ga != ra).sum() + (gt != rt).sum())


def _k6_error(resolve, x):
    """Holds one captured peel step of K6 to its twin, every accumulator,
    the z_limit and both counts identical, and K6's standalone role
    (masked_alpha) on the same layer to its twin (_k6_alpha_error);
    raises otherwise. -> (max abs error of the step's floats, pixels that
    passed where none had, pixels left to the next peel)."""
    import dataclasses
    got, ref = _k6_step(resolve, x), _peel_twin(resolve, x)
    differ = {}
    for f in dataclasses.fields(ref):
        g, r = getattr(got, f.name), getattr(ref, f.name)
        if g.dtype != r.dtype or g.shape != r.shape:
            differ[f.name] = f"{g.dtype} {tuple(g.shape)}"
            continue
        n = int((g.view(_int_of(g)) != r.view(_int_of(r))).sum())
        if n:
            differ[f.name] = n
    if differ:
        raise RuntimeError(f"K6's peel step differs from its twin: elements "
                           f"not identical by field {differ}")
    a = _k6_alpha_args(x)
    _k6_alpha_error(resolve.masked_alpha(**a), resolve.masked_alpha_plain(**a),
                    a["tri"])
    newly = int(((ref.tri >= 0) & (x["state"].tri < 0)).sum())
    return 0.0, newly, int(ref.overflow)


def _int_of(t):
    """The integer dtype of t's width, to compare floats bit for bit."""
    import torch
    return {1: torch.uint8, 4: torch.int32, 8: torch.int64}[t.element_size()]


def _k6_bound(resolve, x):
    """(bound ms, 'bytes' | 'operations') of one launch of K6's peel step
    (_k6_args): see K6P_*, and K6_OPS_PER_PIXEL or K6S_* a hit pixel of a
    kept chunk; each alpha-mirror, meta and material row the kept hit
    pixels touch read once."""
    scene, tri, state = x["scene"], x["m_tri"], x["state"]
    st = scene.mat_stack
    hit = tri >= 0
    cap = x["coverage_capacity"]
    kept = hit
    if cap is not None:
        kept = hit & resolve._keep_pixels(resolve.chunk_keep(hit, cap),
                                          tri.shape)
    ref = _peel_twin(resolve, x)
    a = _k6_alpha_args(x)
    rows = _rows_touched(
        lambda: resolve.masked_alpha_plain(**a),
        {"alpha": (st.alpha, kept), "meta": (st.meta, kept),
         "params": (scene.mat_params, hit)})
    n_kept, n_hit = int(kept.sum()), int(hit.sum())
    n_open = int((hit & (state.tri < 0)).sum())
    n_newly = int(((ref.tri >= 0) & (state.tri < 0)).sum())
    blocks = -(-tri.numel() // resolve.K6_BLOCK_PX)
    nbytes = (tri.numel() * K6P_PIXEL_BYTES + n_kept * K6P_HIT_BYTES
              + (n_hit - n_kept) * K6P_DROPPED_BYTES + n_open * K6P_OPEN_BYTES
              + n_newly * K6P_NEWLY_BYTES
              + (blocks * K6P_BLOCK_BYTES if cap is not None else 0)
              + 16 * rows["alpha"] + 24 * rows["meta"] + 64 * rows["params"])
    stoch = x["mip_dither"] is not None
    ops = (n_kept * (K6S_OPS_PER_PIXEL if stoch else K6_OPS_PER_PIXEL)
           + (n_hit - n_kept) * K6P_DROPPED_OPS)
    int_ops = (n_kept * (K6S_INT_OPS if stoch else K6P_BLEND_INT_OPS)
               + (n_hit - n_kept) * K6P_BLEND_INT_OPS)
    return _bound(nbytes, ops, int_ops)


def _step_ms(step, x, reps: int) -> float:
    """device_ms of a peel step (masked_peel or its twin) on the captured
    inputs, each call on a fresh copy of the captured state (a step
    updates it in place, and a second step on it would find its pixels
    already passed); the copies are made before the timing."""
    states = iter([_peel_clone(x["state"]) for _ in range(2 * reps + 1)])
    return device_ms(lambda: step(**dict(x, state=next(states))), reps)


def k6_row(resolve, calls, n_launches, name="k6_masked_peel", role=None):
    """K6's peel step against its twin on each captured masked_peel launch
    of `role` (all where None), and K6's standalone role (masked_alpha)
    on the same layers against its own twin: identical accumulators and
    counts, both times and the bound of the step, each the mean over the
    launches -> the JSON row."""
    launches = [x for x in (_k6_args(a, kw) for kind, a, kw in calls
                            if kind == "k6")
                if role is None or _k6_role(x) == role]
    if not launches:
        raise RuntimeError(f"{name}: no K6 launch was captured")
    errs, ms, plain_ms, bounds, bound_by = [], [], [], [], set()
    for x in launches:
        errs.append(_k6_error(resolve, x))
        ms.append(_step_ms(resolve.masked_peel, x, 10))
        with _swapped(resolve, "masked_alpha", resolve.masked_alpha_plain):
            plain_ms.append(_step_ms(resolve.masked_peel_plain, x, 2))
        b, by = _k6_bound(resolve, x)
        bounds.append(b)
        bound_by.add(by)
    _log(f"{name}: per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; twin ms " + ", ".join(f"{t:.2f}" for t in plain_ms)
         + "; bound ms " + ", ".join(f"{t:.4f}" for t in bounds)
         + "; hit pixels " + ", ".join(
             str(int((x["m_tri"] >= 0).sum())) for x in launches)
         + "; newly passed " + ", ".join(str(e[1]) for e in errs)
         + "; left to the next peel " + ", ".join(str(e[2]) for e in errs)
         + "; every accumulator and count identical to the twin's")
    res = role_resources("k6", role or "step_exact")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/resolve.cu",
        replaces="incarnation_tpu/kernels/resolve.py:107",
        launches=n_launches, max_abs_err=max(e[0] for e in errs),
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        library_ms=None, ms_per_launch=ms, bound_ms_per_launch=bounds,
        registers=res.get("registers"), spill_bytes=res.get("spill_bytes"))


def _bound_args(fn, a, kw) -> dict:
    """The arguments of a captured call of fn by name, defaults filled."""
    import inspect
    b = inspect.signature(fn).bind(*a, **kw)
    b.apply_defaults()
    return b.arguments


def _k8_error(got, ref, mask):
    """(max abs error, that error over the twin's peak radiance) of one K8
    launch; raises where an uncovered pixel is not 0 or the error passes
    K8_TOL of the peak. K8 repeats the twin's operations in order
    (--fmad=false; the env-BRDF fit's and the SH irradiance's
    multiply-adds fused in both), so the error is 0 where measured."""
    if bool(got[~mask].any()) or bool(ref[~mask].any()):
        raise RuntimeError("K8 or its twin lit an uncovered pixel")
    if not bool(mask.any()):
        return 0.0, 0.0
    peak = float(ref[mask].abs().max())
    err = float((got - ref)[mask].abs().max())
    if not err <= K8_TOL * peak:
        raise RuntimeError(f"K8 is {err:.3e} from its twin, over {K8_TOL} "
                           f"of its peak radiance {peak:.3e}")
    return err, err / peak if peak else 0.0


def _k8_bound(skylight, a, kw):
    """(bound ms, 'bytes' | 'operations') of one K8 launch: see K8_OPS_*
    and, for the stochastic roles, K8S_*."""
    x = _bound_args(skylight.sky_lighting_plain, a, kw)
    if x["dither"] is not None:
        return _k8s_bound(x)
    mask = x["gb"].mask
    cov = int(mask.sum())
    diffuse, spec = x["diffuse_ibl"], x["specular_ibl"]
    bent, hbao, extras = (x[k] is not None for k in ("bent_normals", "hbao",
                                                     "extras"))
    analytic = x["analytic_env_brdf"]
    per_px = 32 - 16 * x["lighting_only"] \
        + 12 * (spec or (diffuse and not bent)) + 12 * spec \
        + 12 * (diffuse and bent) + 4 * hbao + 12 * extras
    nbytes = mask.numel() * 13 + cov * per_px + 108
    if spec:
        nbytes += x["probe"].prefiltered.flat.numel() * 4
        if not analytic:
            nbytes += x["env_brdf"].numel() * 4
    env = K8_OPS_ANALYTIC if analytic else K8_OPS_LUT
    ops = (diffuse * (K8_OPS_DIFFUSE + K8_OPS_DIFFUSE_EXTRAS * extras)
           + spec * (K8_OPS_SPECULAR + env
                     + extras * (K8_OPS_CLEARCOAT + env))
           + K8_OPS_HBAO * hbao)
    return _bound(nbytes, cov * ops)


def _k8s_bound(x):
    """_k8_bound of a stochastic role (x: the call's arguments by name)."""
    from incarnation_tpu_torch.kernels import checker
    mask = x["gb"].mask
    n_cov = int(mask.sum())
    diffuse, spec = x["diffuse_ibl"], x["specular_ibl"]
    bent, hbao, extras = (x[k] is not None for k in ("bent_normals", "hbao",
                                                     "extras"))
    fetch = mask
    if x["checker_parity"] is not None:
        near = mask.clone()
        near[:, 1:] |= mask[:, :-1]
        near[:, :-1] |= mask[:, 1:]
        fetch = near & checker.fetch_mask(mask.shape, x["checker_parity"],
                                          mask.device, x["row0"])
    n_fetch = int(fetch.sum()) if spec else 0
    n_fill = int((mask & ~fetch).sum()) if spec else 0
    per_px = 32 - 16 * x["lighting_only"] \
        + 12 * (spec or (diffuse and not bent)) + 12 * spec \
        + 12 * (diffuse and bent) + 4 * hbao + 12 * extras
    nbytes = (mask.numel() * 13 + n_cov * per_px + 108
              + int((fetch & ~mask).sum()) * 52 * spec)
    jitter = _k8_role(x).startswith("jitter")
    if spec:
        cube = x["probe"].prefiltered
        nbytes += (cube.rgbe_table().numel() * 4 if jitter
                   else cube.flat.numel() * 4)
        if not x["analytic_env_brdf"]:
            nbytes += x["env_brdf"].numel() * 4
    env = K8_OPS_ANALYTIC if x["analytic_env_brdf"] else K8_OPS_LUT
    ops = (n_cov * (diffuse * (K8_OPS_DIFFUSE + K8_OPS_DIFFUSE_EXTRAS * extras)
                    + spec * (K8S_OPS_SPECULAR + env + 8
                              + K8S_OPS_LOBE * extras)
                    + K8_OPS_HBAO * hbao)
           + n_fetch * (K8S_OPS_POINT if jitter else K8S_OPS_BILINEAR)
           + n_fill * K8S_OPS_FILL)
    return _bound(nbytes, ops, mask.numel() * K8S_INT_OPS * spec)


def k8_row(skylight, calls, n_launches, name="k8_sky_lighting", role=None):
    """K8 against its twin on each captured sky_lighting launch of `role`
    (all where None): error, both times and the bound, each the mean over
    the launches; K8's registers and spills -> the JSON row."""
    launches = [(a, kw) for kind, a, kw in calls if kind == "k8"
                and (role is None or _k8_role(
                    _bound_args(skylight.sky_lighting_plain, a, kw)) == role)]
    if not launches:
        raise RuntimeError(f"{name}: no K8 launch was captured")
    errs, ms, plain_ms, bounds, bound_by = [], [], [], [], set()
    lanes, twin_fetches = [], []
    for a, kw in launches:
        x = _bound_args(skylight.sky_lighting_plain, a, kw)
        if x["checker_parity"] is not None and x["specular_ibl"]:
            # the checkerboard kernel's fetching lanes (halos included,
            # counted on the host from the mask) beside the twin's
            # fetches, half the layer: a diagnostic, not in the row
            lanes.append(skylight.checker_fetch_lanes(
                x["gb"].mask, int(x["checker_parity"]) & 1, x["row0"]))
            twin_fetches.append(x["gb"].mask.numel() // 2)
        errs.append(_k8_error(skylight.sky_lighting(*a, **kw),
                              skylight.sky_lighting_plain(*a, **kw),
                              a[0].mask))
        ms.append(device_ms(lambda: skylight.sky_lighting(*a, **kw), 20))
        plain_ms.append(device_ms(
            lambda: skylight.sky_lighting_plain(*a, **kw), 2))
        b, by = _k8_bound(skylight, a, kw)
        bounds.append(b)
        bound_by.add(by)
    res = role_resources("k8", role or "exact")
    _log(f"{name}: per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; twin ms " + ", ".join(f"{t:.2f}" for t in plain_ms)
         + "; bound ms " + ", ".join(f"{t:.4f}" for t in bounds)
         + " (" + "/".join(sorted(bound_by)) + "); covered share "
         + ", ".join(f"{float(a[0].mask.float().mean()):.4f}"
                     for a, _ in launches)
         + "; max abs err " + ", ".join(f"{e[0]:.3e}" for e in errs)
         + ", over the twin's peak " + ", ".join(f"{e[1]:.3e}" for e in errs)
         + f"; {res.get('registers')} registers, {res.get('spill_bytes')} "
         "bytes spilled"
         + ("; fetching lanes (halos included) " + ", ".join(map(str, lanes))
            + " against the twin's fetches "
            + ", ".join(map(str, twin_fetches)) if lanes else ""))
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/skylight.cu",
        replaces="incarnation_tpu/kernels/skylight.py:19",
        launches=n_launches, max_abs_err=max(e[0] for e in errs),
        max_err_over_peak=max(e[1] for e in errs),
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        library_ms=None, registers=res.get("registers"),
        spill_bytes=res.get("spill_bytes"))


def _k9_error(got, ref):
    """Raises unless one K9 launch equals its twin bit for bit in setup,
    ids, valid, bbox and attr (the same operations in the same order;
    K1's keys and tie-breaks downstream need the exact values)."""
    import torch
    for f in ref._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if (g is None) != (r is None):
            raise RuntimeError(f"K9 and its twin disagree on writing {f}")
        if g is None:
            continue
        if g.dtype == torch.float32:
            g, r = g.view(torch.int32), r.view(torch.int32)
        if g.shape != r.shape or not torch.equal(g, r):
            n = int((g != r).sum()) if g.shape == r.shape else -1
            raise RuntimeError(f"K9 {f} differs from its twin on {n} values")


def _k9_bound(raster, a, kw):
    """(bound ms, 'bytes' | 'operations') of one K9 launch: see K9_OPS_*."""
    x = _bound_args(raster.prepare_geometry_plain, a, kw)
    scene = x["scene"]
    t = scene.tri_corner.shape[1]
    attrs = x["emit_attributes"]
    ml = x["meshlet_visible"] is not None
    per_tri = (144 if attrs else 36) + 8 + 4 * ml \
        + (x["tri_visible"] is not None) + 69 + 116 * attrs
    n_mesh = scene.mesh_transforms.shape[0]
    nbytes = t * per_tri + 64 * n_mesh + 128 \
        + 9 * x["prim_visible"].shape[0] \
        + (5 * x["meshlet_visible"].shape[0] if ml else 0)
    return _bound(nbytes, t * (K9_OPS_DEPTH + K9_OPS_ATTR * attrs)
                  + n_mesh * K9_OPS_PER_MESH)


def k9_rows(raster, calls, n_launches):
    """K9 against its twin, bit for bit, on each captured prepare_geometry
    launch, timed, with its bound and registers: one JSON row for the
    camera pass (attribute planes) and one for the sun's depth-only pass.
    A launch's ms is the wrapper's, one K9 launch: the two 4x4 products
    per mesh run inside it."""
    roles = {"k9_setup[camera]": [], "k9_setup[sun_depth_only]": []}
    for kind, a, kw in calls:
        if kind == "k9":
            attrs = _bound_args(raster.prepare_geometry_plain, a,
                                kw)["emit_attributes"]
            roles["k9_setup[camera]" if attrs
                  else "k9_setup[sun_depth_only]"].append((a, kw))
    rows = []
    for name, launches in roles.items():
        if not launches:
            raise RuntimeError(f"{name}: no K9 launch was captured")
        ms, plain_ms, bounds, bound_by = [], [], [], set()
        for a, kw in launches:
            _k9_error(raster.prepare_geometry(*a, **kw),
                      raster.prepare_geometry_plain(*a, **kw))
            ms.append(device_ms(lambda: raster.prepare_geometry(*a, **kw),
                                20))
            plain_ms.append(device_ms(
                lambda: raster.prepare_geometry_plain(*a, **kw), 2))
            b, by = _k9_bound(raster, a, kw)
            bounds.append(b)
            bound_by.add(by)
        attrs = name.endswith("[camera]")
        res = next((v for k, v in K9_RESOURCES.items()
                    if ("ILb1E" in k) == attrs), {})
        _log(f"{name}: {launches[0][0][0].tri_corner.shape[1]} triangles; "
             "per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
             + "; twin ms "
             + ", ".join(f"{t:.2f}" for t in plain_ms) + "; bound ms "
             + ", ".join(f"{t:.4f}" for t in bounds)
             + f"; identical to the twin on {len(launches)} launches; "
             f"{res.get('registers')} registers, {res.get('spill_bytes')} "
             "bytes spilled")
        rows.append(dict(
            name=name, route="cuda",
            source="incarnation_tpu_torch/csrc/setup.cu",
            replaces="incarnation_tpu/kernels/raster.py:1207",
            launches=n_launches // 2, max_abs_err=0.0, max_rel_err=0.0,
            ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
            bound_ms=float(np.mean(bounds)),
            bound_by="operations" if "operations" in bound_by else "bytes",
            library_ms=None,
            registers=res.get("registers"),
            spill_bytes=res.get("spill_bytes")))
    return rows


_K10_FIELDS = ("pair_tri", "starts", "counts", "big_tri", "big_count",
               "overflow", "big_overflow")


def _k10_error(got, ref):
    """Raises unless one K10 binning equals its twin's in every output of
    every layer (shapes, dtypes and values: the tile lists are integers,
    and K1's races downstream read them as they are)."""
    import torch
    if len(got) != len(ref):
        raise RuntimeError(f"K10 gave {len(got)} layers, its twin {len(ref)}")
    for l, (g, r) in enumerate(zip(got, ref)):
        for f in _K10_FIELDS:
            a, b = getattr(g, f), getattr(r, f)
            if a.dtype != b.dtype or a.shape != b.shape \
                    or not torch.equal(a, b):
                n = int((a != b).sum()) if a.shape == b.shape else -1
                raise RuntimeError(f"K10 layer {l} {f} differs from its twin "
                                   f"on {n} values")


def _k10_work(raster, a, kw, ref):
    """(triangles, pairs emitted, buckets, bound ms, 'bytes' | 'operations')
    of one binning, its pairs from the twin's outputs (kept + cut): see
    K10_*."""
    prep, p = a[0], a[1]
    nl = kw.get("n_layers", 1)
    t = prep.bbox.shape[0]
    pairs = int(ref[0].overflow) + sum(
        int(b.counts.sum()) + int(b.big_count[0]) + int(b.big_overflow)
        for b in ref)
    nbytes = t * (16 + 1 + 4 * (kw.get("layer") is not None)) \
        + 4 * (p.pair_capacity + 1) + 8 * nl * p.num_tiles \
        + 4 * nl * p.big_tri_capacity + 4 * (2 * nl + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (t * K10_OPS_PER_TRI + pairs * K10_OPS_PER_PAIR) \
        / INT32_OPS_PER_S * 1e3
    return (t, pairs, nl + nl * p.num_tiles, max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _k10_steps_ms(fn, reps: int = 10, prefix: str = "k10_") -> dict:
    """Device ms of each K10 kernel (each kernel whose name starts with
    prefix) in one fn() call (torch.profiler's CUDA times, the mean over
    reps calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.key.startswith(prefix):
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            out[e.key.split("(")[0]] = us / reps / 1e3
    return out


def k10_launch_ms() -> float:
    """Device ms of one launch of csrc/bin.cu's empty kernel, back to back
    (device_ms): the fixed cost each of K10's launches pays whatever its
    work."""
    import ctypes

    import torch
    from incarnation_tpu_torch.kernels import build
    f = build.library("bin").k10_empty
    f.argtypes, f.restype = [ctypes.c_void_p], ctypes.c_int

    def launch():
        if f(torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("k10_empty launch failed")
    return device_ms(launch, 200)


def k10_rows(raster, calls, n_launches):
    """K10 against its twin, every output equal, on each captured binning of
    the frame, timed (all its launches, one call of the wrapper), with its
    bound and each launch's device time (torch.profiler): one JSON row for
    the camera pass (every raster layer) and one for the sun's depth-only
    pass. Beside them, a torch.sort of as many
    int64 keys as the binning emits pairs (the twin's sort alone;
    `sort_ms`, not a yardstick: no PyTorch call bins), and the floor of
    K10's launches (`launch_floor_ms`: an empty kernel's time back to back,
    times K10_LAUNCHES), which no design of as many launches goes below."""
    import torch
    floor = k10_launch_ms() * len(K10_LAUNCHES)
    _log(f"K10: an empty launch {floor / len(K10_LAUNCHES):.4f} ms back to "
         f"back; {len(K10_LAUNCHES)} launches a binning, a floor of "
         f"{floor:.4f} ms")
    roles = {"k10_bin[camera]": [], "k10_bin[sun_depth_only]": []}
    for kind, a, kw in calls:
        if kind == "k10":
            roles["k10_bin[sun_depth_only]" if a[1].depth_only
                  else "k10_bin[camera]"].append((a, kw))
    rows = []
    for name, launches in roles.items():
        if not launches:
            raise RuntimeError(f"{name}: no K10 launch was captured")
        ms, plain_ms, sort_ms, bounds, bound_by, work, steps = \
            [], [], [], [], set(), [], []
        for a, kw in launches:
            ref = raster.bin_triangles_layered_plain(*a, **kw)
            _k10_error(raster.bin_triangles_layered(*a, **kw), ref)
            ms.append(device_ms(
                lambda: raster.bin_triangles_layered(*a, **kw), 20))
            plain_ms.append(device_ms(
                lambda: raster.bin_triangles_layered_plain(*a, **kw), 2))
            t, pairs, nb, b, by = _k10_work(raster, a, kw, ref)
            keys = torch.randint(0, nb * max(t, 1), (pairs,),
                                 dtype=torch.int64, device=a[0].bbox.device)
            sort_ms.append(device_ms(lambda: torch.sort(keys), 20))
            steps.append(_k10_steps_ms(
                lambda: raster.bin_triangles_layered(*a, **kw)))
            bounds.append(b)
            bound_by.add(by)
            work.append((t, pairs, nb))
        _log(f"{name}: (triangles, pairs emitted, buckets) "
             f"{sorted(set(work))}; per launch ms (all steps) "
             + ", ".join(f"{x:.4f}" for x in ms) + "; twin ms "
             + ", ".join(f"{x:.2f}" for x in plain_ms) + "; bound ms "
             + ", ".join(f"{x:.4f}" for x in bounds) + "; torch.sort of "
             "the pairs' int64 keys ms "
             + ", ".join(f"{x:.4f}" for x in sort_ms)
             + f"; identical to the twin on {len(launches)} launches; "
             "device ms by launch (profiler) " + json.dumps(
                 {k: round(v, 4) for k, v in steps[0].items()}))
        rows.append(dict(
            name=name, route="cuda", source="incarnation_tpu_torch/csrc/bin.cu",
            replaces="incarnation_tpu/kernels/raster.py:384",
            launches=n_launches // 2, max_abs_err=0.0, max_rel_err=0.0,
            ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
            bound_ms=float(np.mean(bounds)),
            bound_by="operations" if "operations" in bound_by else "bytes",
            library_ms=None, sort_ms=float(np.mean(sort_ms)),
            launches_per_binning=len(K10_LAUNCHES), launch_floor_ms=floor,
            steps_ms=steps[0],
            triangles=work[0][0], pairs=work[0][1], buckets=work[0][2]))
    return rows


def k10_no_sync(raster, calls):
    """One frame's binnings (the camera's and the sun's, as captured) again
    under torch.cuda.set_sync_debug_mode("error"): none may wait for the
    card. Then K1's partial-key buffer of each pass, sized from the bins'
    shapes (raster.k1_max_items), is logged."""
    import torch
    binnings = [(a, kw) for kind, a, kw in calls if kind == "k10"]
    if len(binnings) != 2:
        raise RuntimeError(f"{len(binnings)} binnings captured in a frame")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for a, kw in binnings:
            raster.bin_triangles_layered(*a, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    sizes = []
    for kind, a, kw in calls:
        if kind == "k1" and kw.get("name") in ("raster_opaque",
                                               "raster_shadow_depth"):
            items = raster.k1_max_items(a[0], a[1])
            sizes.append(f"{kw['name']} {items} items, "
                         f"{items * raster.K1_TILE_PX * 8 / 1e6:.1f} MB")
    _log("K10: the frame's two binnings ran under sync debug mode "
         "\"error\" without a host synchronisation; K1's partial keys "
         "(k1_max_items, from shapes): " + "; ".join(sizes))


def _k11_error(got, ref):
    """Raises unless one K11 launch equals its twin: every word and the
    culled count (the same float tests in the same order; a word is a
    discrete result, and K2 reads it as it is)."""
    import torch
    (words, culled), (ref_words, ref_culled) = got, ref
    if words.dtype != torch.int32 or words.shape != ref_words.shape \
            or culled.dtype != torch.int64:
        raise RuntimeError(f"K11 gave {words.dtype} {tuple(words.shape)} "
                           f"words and a {culled.dtype} count")
    if not torch.equal(words, ref_words):
        raise RuntimeError(f"K11 differs from its twin in "
                           f"{int((words != ref_words).sum())} words")
    if int(culled) != int(ref_culled):
        raise RuntimeError(f"K11 culled {int(culled)}, its twin "
                           f"{int(ref_culled)}")


def _k12_error(got, ref):
    """Raises unless one K12 launch equals its twin bit for bit, NaN where
    the twin is NaN (the same operations in the same order, the
    transcendentals the functions torch calls; +0.0 where covered, or the
    HDR plus +0.0 in the accumulate role)."""
    import torch
    if got.dtype != torch.float32 or got.shape != ref.shape:
        raise RuntimeError(f"K12 gave {got.dtype} {tuple(got.shape)}")
    nan = torch.isnan(ref)
    if not (torch.equal(torch.isnan(got), nan) and torch.equal(
            torch.where(nan, 0.0, got).view(torch.int32),
            torch.where(nan, 0.0, ref).view(torch.int32))):
        diff = (got - ref).abs()
        raise RuntimeError(
            f"K12 differs from its twin on {int((got != ref).sum())} values "
            f"(max abs {float(diff.nan_to_num(float('inf')).max()):.3e})")


def k11_row(clustered, calls, n_launches):
    """K11 against its twin, identical in every word and the count, on the
    captured build_light_clusters launch, timed, with its bound, the
    launch floor (K10's empty kernel) and its registers -> the JSON row."""
    launches = [(a, kw) for kind, a, kw in calls if kind == "k11"]
    if len(launches) != 1:
        raise RuntimeError(f"k11: {len(launches)} launches captured")
    (a, kw), = launches
    _k11_error(clustered.build_light_clusters(*a, **kw),
               clustered.build_light_clusters_plain(*a, **kw))
    x = _bound_args(clustered.build_light_clusters_plain, a, kw)
    gx, gy, gz = clustered.cluster_grid_shape(x["config"])
    c, n_lights = gx * gy * gz, x["lights"].type.shape[0]
    w32 = (n_lights + 31) // 32
    bound, by = _bound(128 + 20 * n_lights + 4 * c * w32 + 8,
                       c * (K11_OPS_PER_CLUSTER
                            + 6 * n_lights * K11_OPS_PER_TEST))
    floor = k10_launch_ms()
    ms = device_ms(lambda: clustered.build_light_clusters(*a, **kw), 50)
    plain = device_ms(lambda: clustered.build_light_clusters_plain(*a, **kw),
                      5)
    res = next((v for k, v in K11_K15_RESOURCES.items() if "k11" in k), {})
    _log(f"k11_light_grid: {gx}x{gy}x{gz} clusters, {n_lights} lights; "
         f"{ms:.4f} ms a launch against the launch floor {floor:.4f} ms "
         f"(an empty kernel, back to back) and the bound {bound:.6f} ms "
         f"({by}); twin {plain:.3f} ms; identical to the twin; "
         f"{res.get('registers')} registers, {res.get('spill_bytes')} "
         "bytes spilled")
    return dict(
        name="k11_light_grid", route="cuda",
        source="incarnation_tpu_torch/csrc/clustered.cu",
        replaces="incarnation_tpu/kernels/clustered.py:103",
        launches=n_launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, launch_floor_ms=floor, library_ms=None,
        registers=res.get("registers"), spill_bytes=res.get("spill_bytes"))


def k12_row(skylight, calls, n_launches):
    """K12 against its twin, bit for bit, on the captured dynamic-sky
    environment_background launch (the frame's accumulate role: the HDR
    given), timed in turns (K12, the background alone then the eager add,
    twice, K12) beside the two launches it replaced (with_add_ms), with its
    bound and registers -> the JSON row."""
    launches = [(a, kw) for kind, a, kw in calls if kind == "k12"]
    if len(launches) != 1:
        raise RuntimeError(f"k12: {len(launches)} launches captured")
    (a, kw), = launches
    x = _bound_args(skylight.environment_background_plain, a, kw)
    hdr = x["hdr"]
    if hdr is None:
        raise RuntimeError("k12: the frame's sky background was not given "
                           "the HDR")
    _k12_error(skylight.environment_background(*a, **kw),
               skylight.environment_background_plain(*a, **kw))
    alone = dict(x, hdr=None)

    def with_add():
        return hdr + skylight.environment_background(**alone)
    _k12_error(with_add(), skylight.environment_background_plain(**x))
    mask = x["mask"]
    sky = int((~mask).sum())
    # the mask byte, the HDR read and written; the matrix, eye and sun once
    bound, by = _bound(mask.numel() * 25 + 64 + 24,
                       sky * K12_OPS_PER_SKY + 3 * mask.numel())
    runs = [device_ms(f, 20) for f in (
        lambda: skylight.environment_background(*a, **kw), with_add,
        with_add, lambda: skylight.environment_background(*a, **kw))]
    ms, add_ms = min(runs[0], runs[3]), min(runs[1], runs[2])
    plain = device_ms(
        lambda: skylight.environment_background_plain(*a, **kw), 3)
    # a one-launch wrapper's host work, beside K3's and K15's
    host = host_ms(lambda: skylight.environment_background(*a, **kw), 50)
    res = next((v for k, v in K11_K15_RESOURCES.items() if "k12" in k), {})
    _log(f"k12_sky_background: {x['width']}x{x['height']}, {sky} uncovered "
         f"pixels ({sky / mask.numel():.4f}), the HDR accumulated; {ms:.4f} "
         f"ms a launch against the bound {bound:.4f} ms ({by}); K12 alone "
         f"and the eager add {add_ms:.4f} ms in turns; the host's work "
         f"{host:.4f} ms a call; twin {plain:.3f} ms; identical to the "
         f"twin; {res.get('registers')} registers, "
         f"{res.get('spill_bytes')} bytes spilled")
    return dict(
        name="k12_sky_background", route="cuda",
        source="incarnation_tpu_torch/csrc/skylight.cu",
        replaces="incarnation_tpu/kernels/skylight.py:159",
        launches=n_launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None, host_ms=host,
        with_add_ms=add_ms, registers=res.get("registers"),
        spill_bytes=res.get("spill_bytes"))


def _k13_error(got, ref):
    """Raises unless one K13 launch equals its twin: every mask bit and the
    culled count (the same float tests in the same order)."""
    import torch
    (inside, culled), (ref_inside, ref_culled) = got, ref
    if inside.dtype != torch.bool or inside.shape != ref_inside.shape \
            or culled.dtype != torch.int64 or culled.shape != ():
        raise RuntimeError(f"K13 gave {inside.dtype} {tuple(inside.shape)} "
                           f"and a {culled.dtype} count")
    if not torch.equal(inside, ref_inside):
        raise RuntimeError(f"K13 differs from its twin on "
                           f"{int((inside != ref_inside).sum())} spheres")
    if int(culled) != int(ref_culled):
        raise RuntimeError(f"K13 culled {int(culled)}, its twin "
                           f"{int(ref_culled)}")


def _k14_role(x) -> str:
    """The K14 role ("+nl") of sun_visibility's arguments by name."""
    from incarnation_tpu_torch.kernels import shadow
    return shadow.role_name(x["dither"], x["checker_parity"], True)


def _k14_error(got, ref):
    """Raises unless one K14 launch equals its twin bit for bit."""
    import torch
    if got.dtype != torch.float32 or got.shape != ref.shape:
        raise RuntimeError(f"K14 gave {got.dtype} {tuple(got.shape)}")
    if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
        raise RuntimeError(f"K14 differs from its twin on "
                           f"{int((got != ref).sum())} pixels")


def k13_rows(cull, calls, n_launches):
    """K13 against its twin, identical in every mask bit and each list's
    count, on the frame's captured cull_lists launch (the primitives and
    the meshlets in one launch), timed in turns against the two one-list
    launches of the same kernel that the frame made before
    (`two_launch_ms`), with the bound (K13_*), the launch floor (K10's
    empty kernel) and K13's registers -> [the row k13_cull]."""
    launches = [(a, kw) for kind, a, kw in calls if kind == "k13"]
    if len(launches) != 1 or n_launches != FRAMES:
        raise RuntimeError(f"k13: {len(launches)} launches captured, "
                           f"{n_launches} on the main path")
    (a, kw), = launches
    x = dict(_bound_args(cull.cull_lists_plain, a, kw))
    ref = cull.cull_lists_plain(**x)
    for got, r in zip(cull.cull_lists(**x), ref):
        _k13_error(got, r)
    rest = [x[k] for k in ("mesh_transforms", "mesh_visible",
                           "scene_rotation", "view_proj")]
    fns = {"one": lambda: cull.cull_lists(**x),
           "two": lambda: [cull.cull_primitives(b, m, *rest)
                           for b, m in x["lists"]]}
    order = ("one", "two", "two", "one")
    t = [device_ms(fns[k], 50) for k in order]
    ms = {k: min(v for o, v in zip(order, t) if o == k) for k in fns}
    plain = device_ms(lambda: cull.cull_lists_plain(**x), 5)
    floor = k10_launch_ms()
    sizes = [b.shape[0] for b, _ in x["lists"]]
    p, m = sum(sizes), x["mesh_transforms"].shape[0]
    bound, by = _bound(K13_SPHERE_BYTES * p + K13_MESH_BYTES * m + 136,
                       K13_OPS_PER_SPHERE * p + K13_OPS_PER_MESH * m
                       + K13_OPS_PLANES)
    res = next((v for k, v in K11_K15_RESOURCES.items() if "k13" in k), {})
    _log(f"k13_cull: lists of {sizes} spheres of {m} meshes, "
         f"{[int(c) for _, c in ref]} culled; {ms['one']:.4f} ms a launch "
         f"(the two one-list launches {ms['two']:.4f} ms) against the "
         f"launch floor {floor:.4f} ms (an empty kernel, back to back) and "
         f"the bound {bound:.6f} ms ({by}); twin {plain:.3f} ms; identical "
         f"to the twin; {res.get('registers')} registers, "
         f"{res.get('spill_bytes')} bytes spilled")
    return [dict(
        name="k13_cull", route="cuda",
        source="incarnation_tpu_torch/csrc/cull.cu",
        replaces="incarnation_tpu/kernels/cull.py:34", launches=n_launches,
        max_abs_err=0.0, ms=ms["one"], plain_ms=plain, bound_ms=bound,
        bound_by=by, launch_floor_ms=floor, library_ms=None,
        two_launch_ms=ms["two"], registers=res.get("registers"),
        spill_bytes=res.get("spill_bytes"))]


def _k14_bound(shadow, x):
    """(bound ms, by, fetching pixels, distinct texels) of one K14 launch
    (a "+nl" role): each fetching pixel's position and normal read once,
    every output written once, each texel the launch reads read once,
    sun_vp's rows and sun_dir once, K14_OPS_* and K14_INT_OPS_* a fetching
    pixel, K14_OPS_FILL a filling one."""
    import torch
    from incarnation_tpu_torch.kernels import checker
    wp, cp, row0 = x["world_pos"], x["checker_parity"], x["row0"]
    pixels = wp.shape[0] * wp.shape[1]
    if cp is not None:
        wp = checker.compact(int(cp) & 1, wp, row0)
    _, _, lin = shadow.sun_map_tap(wp, x["sun_vp"], x["resolution"],
                                   x["dither"], row0)
    fetch, texels = lin.numel(), int(torch.unique(lin).numel())
    dither = x["dither"] is not None
    bound, by = _bound(
        (K14_FETCH_BYTES + K14_NL_BYTES) * fetch + K14_PIXEL_BYTES * pixels
        + 4 * texels + 60,
        fetch * (K14_OPS_TAP + dither * K14_OPS_DITHER + K14_NL_OPS)
        + (pixels - fetch) * K14_OPS_FILL,
        fetch * (K14_INT_OPS_TAP + dither * K14_INT_OPS_DITHER))
    return bound, by, fetch, texels


def _k14_calls(calls) -> list:
    """K14's "+nl" calls by name on a path: the tap of each captured
    sun_term call with a map (no frame launches K14 itself)."""
    from incarnation_tpu_torch.kernels import shading
    return [_k14_from_k15(x) for x in (
        _bound_args(shading.sun_term_plain, a, kw)
        for kind, a, kw in calls if kind == "k15")
        if x["shadow_map"] is not None]


def k14_row(shadow, calls, n_launches, name="k14_sun_tap", role=None):
    """K14's tap alone against its twin, bit for bit, on the inputs of a
    captured sun_term call of the map in `role` (n_launches: K14's
    launches on the path, 0 since K15 taps the map), timed, with its bound
    and registers -> the JSON row."""
    launches = [x for x in _k14_calls(calls) if _k14_role(x) == role]
    if not launches:
        raise RuntimeError(f"{name}: no K15 map launch of role {role} "
                           "captured")
    x = launches[0]
    _k14_error(shadow.sun_visibility(**x), shadow.sun_visibility_plain(**x))
    bound, by, fetch, texels = _k14_bound(shadow, x)
    h, w = x["world_pos"].shape[:2]
    ms = device_ms(lambda: shadow.sun_visibility(**x), 20)
    plain = device_ms(lambda: shadow.sun_visibility_plain(**x), 3)
    kernel = "checker" if x["checker_parity"] is not None else "tap"
    res = next((v for k, v in K11_K15_RESOURCES.items()
                if f"k14_{kernel}" in k), {})
    # the whole map, and the planes as 32-byte sectors: the fetching lanes
    # of the checkerboard touch every sector of world_pos and the normals
    whole_map, _ = _bound((K14_FETCH_BYTES + K14_NL_BYTES) * fetch
                          + K14_PIXEL_BYTES * h * w
                          + 4 * x["resolution"] ** 2 + 60, 0)
    sectors, _ = _bound(2 * 12 * h * w + K14_PIXEL_BYTES * h * w
                        + 4 * texels + 60, 0)
    _log(f"{name}: {w}x{h}, map {x['resolution']}^2, {fetch} fetching "
         f"pixels, {texels} distinct texels; {ms:.4f} ms a launch against "
         f"the bound {bound:.4f} ms ({by}; the whole map counted: "
         f"{whole_map:.4f}; world_pos and the normals read whole, as "
         f"their 32-byte sectors: {sectors:.4f}); twin {plain:.3f} ms; "
         f"identical to the twin; k14_{kernel}_kernel "
         f"{res.get('registers')} registers, {res.get('spill_bytes')} bytes "
         "spilled")
    return dict(
        name=name, route="cuda",
        source="incarnation_tpu_torch/csrc/shadow.cu",
        replaces="incarnation_tpu/kernels/shadow.py:103",
        launches=n_launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
        bound_ms=bound, bound_by=by, library_ms=None,
        bound_sectors_ms=sectors, registers=res.get("registers"),
        spill_bytes=res.get("spill_bytes"))


# the functions host_free_phases watches: (module, function, the kernels
# each call launches once, calls a frame)
_HOST_FREE = (("clustered", "build_light_clusters", ("k11_light_grid",), 1),
              ("skylight", "environment_background", ("k12_sky_background",),
               1),
              ("cull", "cull_lists", ("k13_cull",), 1),
              ("resolve", "decal_step", ("k5_resolve",), 1),
              ("shading", "sun_term", ("k15_sun_term",), 1),
              ("taa", "taa_resolve", ("k3_taa_resolve",), 1))


def host_free_phases(run, fc, history, kernels):
    """Inside build_light_clusters, environment_background, cull_lists
    (both lists), decal_step, sun_term and taa_resolve on one frame: every
    eager torch operator that runs work on the card (_launches_work,
    counted by a TorchDispatchMode), the hand-written kernels launched,
    and, under torch.cuda.set_sync_debug_mode("error"), any synchronize or
    copy from pageable host memory (which raises). Raises unless each call
    is its kernel's one launch (K11, K12, K13, K5's decal step, K15 with
    the map's tap, K3) and nothing else, and unless no eager operator reads the sky
    background's output between its return and the TAA resolve (the frame
    adds nothing to it: K12's launch wrote the HDR)."""
    import importlib
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    seen, active = [], []
    sky = {"out": None, "readers": []}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _launches_work(func):
                for ops in active:
                    ops.append(func.name())
                out = sky["out"]
                if out is not None and any(
                        isinstance(t, torch.Tensor)
                        and t.data_ptr() == out.data_ptr()
                        for t in (*args, *(kwargs or {}).values())):
                    sky["readers"].append(func.name())
            return func(*args, **(kwargs or {}))

    def watched(fn, what):
        def call(*a, **kw):
            before = [k.launches for k in kernels]
            active.append([])
            if what == "taa_resolve":
                sky["out"] = None
            if len(active) == 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*a, **kw)
                if what == "environment_background":
                    sky["out"] = out
                return out
            finally:
                if len(active) == 1:
                    torch.cuda.set_sync_debug_mode(0)
                seen.append((what, active.pop(), {
                    k.fn: k.launches - n for k, n in zip(kernels, before)
                    if k.launches > n}))
        return call
    with contextlib.ExitStack() as stack:
        for mod_name, fn_name, _, _ in _HOST_FREE:
            mod = importlib.import_module(
                f"incarnation_tpu_torch.kernels.{mod_name}")
            stack.enter_context(_swapped(mod, fn_name, watched(
                getattr(mod, fn_name), fn_name)))
        stack.enter_context(Count())
        run(fc, history)
    torch.cuda.synchronize()
    _log("inside the light-cluster grid, the sky background, the frustum "
         "cull, the decal step, the sun term and the TAA resolve (eager "
         "operators running "
         "on the card, kernels launched; no synchronize and no copy from "
         "host memory under set_sync_debug_mode): " + json.dumps(seen)
         + "; eager operators reading the sky background's output before "
         f"the TAA resolve: {sky['readers']}")
    want = {fn: {k: 1 for k in ks} for _, fn, ks, _ in _HOST_FREE}
    calls = sorted(fn for _, fn, _, n in _HOST_FREE for _ in range(n))
    if sorted(w for w, _, _ in seen) != calls \
            or any(o or k != want[w] for w, o, k in seen):
        raise RuntimeError("build_light_clusters, environment_background, "
                           "cull_lists, decal_step, sun_term or "
                           "taa_resolve ran more on the card than its "
                           "kernel's one launch")
    if sky["readers"]:
        raise RuntimeError(f"eager operators {sky['readers']} read the sky "
                           "background's output before the TAA resolve")


def k1_row(raster, layer, launches_captured, n_launches):
    """Kernel-vs-twin on the captured K1 launches of one raster layer
    (error, both times and the bound, each the mean over the launches;
    the operations' bound beside it, bound_ops_ms) -> the layer's JSON
    row."""
    errs, ms, plain_ms, bounds, bound_by = [], [], [], [], set()
    op_bounds = []
    for a, kw in launches_captured:
        bins, p = a
        zl, mt = kw.get("z_limit"), kw.get("mask_table")
        got = raster.rasterize_tiles(bins, p, z_limit=zl, mask_table=mt)
        ref = raster.rasterize_tiles_plain(bins, p, z_limit=zl,
                                           mask_table=mt)
        errs.append(_k1_error(got, ref))
        ms.append(device_ms(lambda: raster.rasterize_tiles(
            bins, p, z_limit=zl, mask_table=mt), 10))
        plain_ms.append(device_ms(lambda: raster.rasterize_tiles_plain(
            bins, p, z_limit=zl, mask_table=mt), 2))
        b, by, b_ops = _k1_bound(bins, p, zl, mt)
        bounds.append(b)
        op_bounds.append(b_ops)
        bound_by.add(by)
    bins, p = launches_captured[0][0]
    items, largest = raster.k1_work_items(bins, p)
    _log(f"K1 {layer}: per launch ms " + ", ".join(f"{t:.4f}" for t in ms)
         + "; bound ms " + ", ".join(f"{t:.4f}" for t in bounds)
         + " (operations alone " + ", ".join(f"{t:.4f}" for t in op_bounds)
         + "); tri mismatch share "
         + ", ".join(f"{e[2]:.2e}" for e in errs)
         + f"; {int(bins.counts.sum())} pairs in {p.num_tiles} tiles of "
         f"{p.tile_h}x{p.tile_w}, at most {int(bins.counts.max())} in one, "
         f"+ {int(bins.big_count[0])} big triangles in every tile; "
         f"{items} work items of at most {raster.K1_ITEM_PAIRS} pairs, the "
         f"largest {largest} (first launch)")
    return dict(
        name=f"k1_raster[{layer}]", route="cuda",
        source="incarnation_tpu_torch/csrc/raster.cu",
        replaces="incarnation_tpu/kernels/raster.py:1077",
        launches=n_launches,
        max_abs_err=max(e[0] for e in errs),
        max_rel_err=max(e[1] for e in errs),
        ms=float(np.mean(ms)), plain_ms=float(np.mean(plain_ms)),
        bound_ms=float(np.mean(bounds)),
        bound_by="operations" if "operations" in bound_by else "bytes",
        bound_ops_ms=float(np.mean(op_bounds)), library_ms=None)


def small_renderer(dev, extras: bool = False):
    """The small path's scene (the port's scene/testing.py scene with a
    BLEND quad; with extras, every material given transmission 0.3,
    clearcoat 0.6 and clearcoat roughness 0.25), lit by a small sky probe,
    and render(**Config overrides) of one 512x256 frame. -> (scene,
    render)."""
    import dataclasses
    import torch
    from incarnation_tpu_torch.config import Config
    from incarnation_tpu_torch.core.view import View
    from incarnation_tpu_torch.kernels import ibl, raster, sky
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import testing
    w, h = SMALL_W, SMALL_H
    scene = testing.make_rich_scene(device=dev, blend_quad=True)
    if not scene.meta.has_blend:
        raise RuntimeError("the small scene lost its BLEND quad")
    if extras:
        # mat_params columns 13-15: transmission, clearcoat, its roughness
        mp = scene.mat_params.clone()
        mp[:, 13], mp[:, 14], mp[:, 15] = 0.3, 0.6, 0.25
        scene = dataclasses.replace(
            scene, mat_params=mp,
            meta=dataclasses.replace(scene.meta, has_extras=True))
    params = raster.RasterParams(width=w, height=h, pair_capacity=4096,
                                 bin_max_span=8, big_tri_capacity=64)
    base = dict(masked_depth_peels=SMALL_PEELS, sun_shadow_mode="map",
                shadow_map_resolution=256, enable_taa=False)
    sun = np.asarray([0.2, 0.8, -0.55], np.float32)
    sun = sun / np.linalg.norm(sun)
    view = View.from_lookat([0.0, 1.0, 1.0], [0.0, 0.0, 7.0], aspect=w / h)
    probe = ibl.build_probe(
        sky.sky_latlong(torch.tensor(sun, device=dev), 2.0, 64, 32),
        envmap_size=32, num_samples=256)
    env_brdf = ibl.pack_env_brdf(ibl.env_brdf_lut(32, 256, device=dev))

    def render(**kw):
        cfg = Config(**dict(base, **kw))
        fc = frame.FrameConstants.make(
            view, cfg, sun_dir=sun,
            sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
            shadow_bounds=([0.0, 0.75, 8.0], 13.0), device=dev)
        return frame.render_frame(scene, fc, config=cfg, params=params,
                                  probe=probe, env_brdf=env_brdf)

    return scene, render


def small_path(dev, raster, clustered, taa):
    """The forward / view-mode / debug-draw path on the port's own test
    scene with a BLEND quad, 512x256, every launch on the card. Returns the
    k1_raster[raster_blend] row and the row of the forward frame's K5
    launches (opaque with the mapped normal, each blend layer; the decal
    layer is K5's decal step, held to its twin); their launches are this
    path's."""
    import torch
    from incarnation_tpu_torch.config import ViewMode
    from incarnation_tpu_torch.kernels import (cull, resolve, shading, shadow,
                                               skylight)
    from incarnation_tpu_torch.renderer import frame
    w, h = SMALL_W, SMALL_H
    scene, render = small_renderer(dev)

    def check_color(out, what):
        c = out["color"]
        if tuple(c.shape) != (h, w, 3) or c.dtype != torch.uint8:
            raise RuntimeError(f"{what}: colour is not an (H, W, 3) uint8")
        for key in ("hdr", "accumulation"):
            if not bool(torch.isfinite(out[key]).all()):
                raise RuntimeError(f"{what}: {key} is not finite")

    # forward lighting with blend layers and both debug draws
    fwd = dict(forward_lighting=True, show_light_bounds=True,
               show_object_bounds=True)
    render(**fwd)                               # warm-up
    kernels = (raster.K1, clustered.K2, taa.K3, resolve.K5, resolve.K6,
               skylight.K8, raster.K9, raster.K10, clustered.K11,
               skylight.K12, cull.K13, shadow.K14, shading.K15)
    for k in kernels:
        k.reset()
    calls = capture_frame(lambda fc, history: render(**fwd), None, None,
                          raster, clustered, taa)
    k11_k15 = [clustered.K11.launches, skylight.K12.launches,
               cull.K13.launches, shadow.K14.launches, shading.K15.launches]
    by_name, k2_launches = dict(raster.K1.by_name), clustered.K2.launches
    k5_launches, k6_launches = resolve.K5.launches, resolve.K6.launches
    k5_decal = {r: n for r, n in resolve.K5.by_name.items()
                if r.startswith("decal_")}
    k8_launches, k9_launches = skylight.K8.launches, raster.K9.launches
    k10_binnings = raster.K10.by_name.get("k10_scatter", 0)
    out = render(**fwd)
    check_color(out, "forward frame")
    stats = {k: int(v) for k, v in out["stats"].items()}
    _log(f"small path, forward frame: K1 by layer {by_name}, K2 "
         f"{k2_launches}, K5 {k5_launches}, K6 {k6_launches}, K8 "
         f"{k8_launches}, K9 {k9_launches} launches, K10 {k10_binnings} "
         f"binnings; stats {json.dumps(stats)}")
    if by_name.get("raster_blend") != SMALL_PEELS:
        raise RuntimeError(f"raster_blend launches {by_name}")
    # K2 and K8 shade the opaque surface and each blend layer; K5 resolves
    # the opaque and blend layers and steps the decal layer, K6 tests each
    # masked peel, K9 sets up and K10 bins the camera and the sun pass,
    # K13 culls the primitives and the meshlets in one launch, K15 shades
    # the sun for the opaque surface and each blend layer, tapping the map
    # itself (no K14)
    if by_name.get("raster_shadow_depth") != 1 \
            or k2_launches != 1 + SMALL_PEELS \
            or k5_launches != 2 + SMALL_PEELS or k6_launches != SMALL_PEELS \
            or k5_decal != {"decal_exact": 1} \
            or k8_launches != 1 + SMALL_PEELS or k9_launches != 2 \
            or k10_binnings != 2 \
            or k11_k15 != [1, 1, 1, 0, 1 + SMALL_PEELS]:
        raise RuntimeError(f"small path launches {by_name}, K2 "
                           f"{k2_launches}, K5 {k5_launches}, K6 "
                           f"{k6_launches}, K8 {k8_launches}, K9 "
                           f"{k9_launches}, K10 {k10_binnings} binnings, "
                           f"K11-K15 {k11_k15}")
    check_twins("small path, forward frame", calls, raster, clustered, taa,
                need=("k1", "k2", "k5", "k5d", "k6", "k8", "k9", "k10",
                      "k11", "k12", "k13", "k14", "k15"))
    if stats["debug_draws"] <= 0:
        raise RuntimeError("no debug draw was appended")
    for key in ("bin_overflow", "big_overflow", "peel_overflow",
                "shadow_bin_overflow"):
        if stats[key] != 0:
            raise RuntimeError(f"small path: {key} = {stats[key]}")
    no_wires = render(forward_lighting=True)
    wires = int((out["color"] != no_wires["color"]).any(-1).sum())
    blend = int(((out["hdr"] - render(forward_lighting=False)["hdr"]).abs()
                 .sum(-1) > 0).sum())
    _log(f"small path: {wires} wireframe pixels, {blend} pixels differ "
         "between the forward (blend layers) and the deferred frame")
    if wires == 0 or blend == 0:
        raise RuntimeError("the debug draws or the blend layers drew nothing")
    blends = [(a, kw) for kind, a, kw in calls
              if kind == "k1" and kw.get("name") == "raster_blend"]
    if len(blends) != SMALL_PEELS or blends[0][1].get("mask_table") \
            is not None or blends[0][1].get("z_limit") is None:
        raise RuntimeError("the blend layers are not z_limit peels")
    rows = [k1_row(raster, "raster_blend", blends, by_name["raster_blend"]),
            k5_row(resolve, calls, k5_launches - 1,
                   name="k5_resolve[small_path]")]

    # the scene with transmission and clearcoat: K15's extras role (and
    # K5's and K8's), forward lighting with the blend layers
    _, render_x = small_renderer(dev, extras=True)
    render_x(**fwd)                             # warm-up
    shading.K15.reset()
    x_calls = []
    with _capturing(x_calls, raster, clustered, taa):
        out_x = render_x(**fwd)
    torch.cuda.synchronize()
    check_color(out_x, "extras frame")
    x_roles = dict(shading.K15.by_name)
    _log(f"small path, extras frame: K15 by role {x_roles}")
    if x_roles != {"map+extras": 1 + SMALL_PEELS}:
        raise RuntimeError(f"the extras frame's K15 roles {x_roles}")
    if float((out_x["hdr"] - out["hdr"]).abs().max()) == 0.0:
        raise RuntimeError("transmission and clearcoat changed nothing")
    check_twins("small path, extras frame",
                [c for c in x_calls if c[0] in ("k5", "k5d", "k8", "k15")],
                raster, clustered, taa, need=("k5", "k5d", "k8", "k15"))
    rows.append(k15_row(shading, x_calls, x_roles["map+extras"],
                        name="k15_sun_term[extras]", role="map+extras"))

    # one frame per view mode
    modes = {n: v for n, v in vars(ViewMode).items()
             if isinstance(v, int) and not n.startswith("_")}
    if len(modes) != 14:
        raise RuntimeError(f"{len(modes)} view modes")
    means = {}
    for name, vm in sorted(modes.items(), key=lambda kv: kv[1]):
        if name == "LIGHTING_ONLY":
            lit_calls = []
            with _capturing(lit_calls, raster, clustered, taa):
                o = render(viewmode=vm)
            if not all(_bound_args(skylight.sky_lighting_plain, a, kw)[
                    "lighting_only"] for k, a, kw in lit_calls if k == "k8"):
                raise RuntimeError("LIGHTING_ONLY shaded with base colour")
            check_twins("small path, LIGHTING_ONLY", lit_calls, raster,
                        clustered, taa, need=("k8",))
        else:
            o = render(viewmode=vm)
        check_color(o, f"view mode {name}")
        means[name] = round(float(o["color"].float().mean()), 2)
        if name == "OBJECT_IDS":
            covered = o["tri"] >= 0
            if not bool(o["color"][covered].sum(-1).min() > 0):
                raise RuntimeError("OBJECT_IDS is black on geometry")
            ids = o
    _log(f"small path, mean u8 colour per view mode: {json.dumps(means)}")

    # pick at a covered pixel, highlight of that primitive
    ys, xs = torch.nonzero(ids["tri"] >= 0, as_tuple=True)
    mid = ys.numel() // 2
    x, y = int(xs[mid]), int(ys[mid])
    prim, local, meshlet = frame.pick(scene, ids["tri"], x, y)
    if prim < 0 or local < 0 or meshlet < 0:
        raise RuntimeError(f"pick({x}, {y}) found nothing on a covered pixel")
    if frame.pick(scene, torch.full_like(ids["tri"], -1), x, y) \
            != (-1, -1, -1):
        raise RuntimeError("pick on an empty map found something")
    lit = frame.highlight(ids["color"], ids["tri"], scene, prim)
    changed = (lit != ids["color"]).any(-1)
    owner = scene.tri_prim[ids["tri"].clamp(min=0).long()]
    own = (ids["tri"] >= 0) & (owner == prim)
    _log(f"small path: pick({x}, {y}) = prim {prim}, triangle {local}, "
         f"meshlet {meshlet}; highlight changed {int(changed.sum())} of its "
         f"{int(own.sum())} pixels")
    if not bool(changed.any()) or bool((changed & ~own).any()):
        raise RuntimeError("highlight changed other pixels than the picked "
                           "primitive's")
    torch.cuda.synchronize()
    return rows


def bvh_paths(dev, path, profile: bool):
    """Phases (a)-(e) on the atrium: the scene BVH, the path tracer at
    PT_W x PT_H, K4 against its twin, a sample with the twin, and the RT
    shadow + HBAO frame at W x H. Returns (K4's JSON rows, one per role;
    namespace(sbvh, calls: the captured K4 launches of one sample by role,
    fc: the path tracer's constants, history: its accumulation))."""
    import types
    import torch
    from incarnation_tpu_torch.kernels import (bvh, clustered, hbao,
                                               pathtrace, raster, shading,
                                               shadow, skylight, taa)
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.core import mathutils as mu

    # (a) the scene BVH, built on the host and moved to the card
    t0 = time.perf_counter()
    sbvh = bvh.build_scene_bvh(path.scene, device=dev)
    torch.cuda.synchronize()
    rows_np = sbvh.rows[:, bvh._W_FLAG].cpu()
    n_leaf = int((rows_np > 0.5).sum())
    _log(f"(a) atrium BVH: {sbvh.rows.shape[0]} rows ({n_leaf} leaves, "
         f"{sbvh.rows.shape[0] - n_leaf} 8-wide internal), "
         f"{sbvh.nbytes() / 2**20:.2f} MiB on the card, built on the host "
         f"in {time.perf_counter() - t0:.1f} s")

    # (b) the path tracer, as the JAX bench runs it (bench.py:145-190)
    cfg = path.cfg
    fc = fc_pt = frame.FrameConstants.make(
        bench_view(path.host, PT_W, PT_H), cfg, sun_dir=path.sun,
        sun_color_intensity=[1.0, 1.0, 1.0, 100.0],
        shadow_bounds=path.shadow_bounds, device=dev)

    def sample(i, history):
        return frame.render_pathtrace(path.scene, sbvh, fc, history, i,
                                      config=cfg, width=PT_W, height=PT_H,
                                      probe=path.probe)

    truncs = []
    with _hooked(bvh, "trace", lambda out, *a, **kw: truncs.append(
            out["trunc"])):
        history = sample(0, torch.zeros((PT_H, PT_W, 3), device=dev))[
            "history"]
        torch.cuda.synchronize()
        bvh.K4.reset()
        rays, per_sample = [], []
        t0 = time.perf_counter()
        for i in range(1, 1 + PT_SAMPLES):
            before = dict(bvh.K4.by_name)
            out = sample(i, history)
            history = out["history"]
            rays.append(out["rays"])
            per_sample.append({k: bvh.K4.by_name.get(k, 0) - before.get(k, 0)
                               for k in bvh.K4.by_name})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pt_launches = dict(bvh.K4.by_name)
    n_rays = float(torch.stack(rays).sum())
    _log(f"(b) path tracer {PT_W}x{PT_H}: {PT_SAMPLES} samples in "
         f"{wall * 1e3:.1f} ms ({wall / PT_SAMPLES * 1e3:.1f} ms per "
         f"sample), counted rays per sample "
         + ", ".join(f"{float(r):.0f}" for r in rays)
         + f"; {n_rays / wall / 1e6:.4f} Mray/s")
    _log(f"(b) K4 launches per sample by role: {json.dumps(per_sample)}")
    for i, got in enumerate(per_sample):
        for role, (lo, hi) in PT_LAUNCHES.items():
            if not lo <= got.get(role, 0) <= hi:
                raise RuntimeError(f"sample {i}: {got.get(role, 0)} K4 "
                                   f"launches as {role}, not in [{lo}, {hi}]")
        if set(got) - set(PT_LAUNCHES):
            raise RuntimeError(f"sample {i}: K4 roles {sorted(got)}")
    bad = [int(t) for t in truncs if int(t) != 0]
    _log(f"(b) trunc over the {len(truncs)} traces: {sum(bad)}")
    if bad:
        raise RuntimeError(f"{len(bad)} traces stopped rays at the step "
                           f"budget: {bad}")
    color = out["color"]
    neg = int((history < 0).any(-1).sum())
    _log(f"(b) history: min {float(history.min()):.4g}, max "
         f"{float(history.max()):.4g}, mean {float(history.mean()):.4g}, "
         f"{neg} pixels with a negative channel; mean u8 colour "
         f"{float(color.float().mean()):.2f}")
    if not bool(torch.isfinite(history).all()) or neg:
        raise RuntimeError("the path-traced history is not finite and >= 0")
    if float(color.float().mean()) < 2.0:
        raise RuntimeError("the path-traced image is black")

    # (c) K4 against its twin on one sample's launches
    pt_history = history
    calls = {}

    def keep(out, bvh_, o, d, tmin=0.0, tmax=1e30, any_hit=False,
             role=None, alpha_of=None, **kw):
        calls.setdefault(role, (bvh_, o, d, tmin, tmax, any_hit, alpha_of))
    with _hooked(bvh, "trace_k4", keep):
        sample(PT_SAMPLES + 1, history)
    rows = [k4_row(bvh, calls[role], role, pt_launches.get(role, 0))
            for role in ("pt_primary", "pt_bounce", "pt_shadow",
                         "pt_primary_peel") if role in calls]

    # (d) one sample with K4 swapped for its twin
    got = sample(PT_SAMPLES + 1, history)["history"]
    with _swapped(bvh, "trace_k4", _k4_twin(bvh)):
        ref = sample(PT_SAMPLES + 1, history)["history"]
    torch.cuda.synchronize()
    diff = float((got - ref).abs().max())
    _log(f"(d) a sample with K4 against the same sample with its twin: "
         f"identical {bool(torch.equal(got, ref))}, max abs diff {diff:.3e}")
    if not torch.equal(got, ref):
        raise RuntimeError("the sample with K4 differs from the twin's")
    if profile:
        profile_pt(sample, history, bvh, pathtrace)

    # (e) the raster frame with RT sun shadows and HBAO, W x H
    rt_cfg = cfg.replace(sun_shadow_mode="rt", enable_hbao=True,
                         use_bent_normals=True)
    fc = path.make_fc(0, None)
    hist0 = torch.zeros((H, W, 3), device=dev)
    path.run(fc, hist0, rt_cfg, sbvh)                    # warm-up
    for k in (bvh.K4, shading.K15):
        k.reset()
    rt_calls, raster_calls = {}, []
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with _hooked(bvh, "trace_k4", lambda out, bvh_, o, d, tmin=0.0,
                 tmax=1e30, any_hit=False, role=None, alpha_of=None, **kw:
                 rt_calls.setdefault(role, (bvh_, o, d, tmin, tmax,
                                            any_hit, alpha_of))), \
            _capturing(raster_calls, raster, clustered, taa):
        start.record()
        out = path.run(fc, hist0, rt_cfg, sbvh)
        end.record()
        torch.cuda.synchronize()
    rt_launches = dict(bvh.K4.by_name)
    k15_rt = dict(shading.K15.by_name)
    _log(f"(e) RT shadow + HBAO frame {W}x{H}: {start.elapsed_time(end):.2f}"
         f" ms, K4 launches by role {json.dumps(rt_launches)}, K15 by role "
         f"{json.dumps(k15_rt)}")
    if rt_launches.get("rt_sun") != 1 or not 1 <= rt_launches.get(
            "hbao", 0) <= 2 * hbao.NUM_SLICES * hbao.MAX_TRACES_PER_SLICE:
        raise RuntimeError(f"RT frame K4 launches {rt_launches}")
    # K15 on the RT visibility: one launch of its given role a frame
    if k15_rt != {"given": 1}:
        raise RuntimeError(f"RT frame K15 launches by role {k15_rt}")
    for key in ("bin_overflow", "big_overflow", "peel_overflow"):
        if int(out["stats"][key]) != 0:
            raise RuntimeError(f"RT frame: {key} = {int(out['stats'][key])}")
    hdr = out["hdr"]
    off = path.run(fc, hist0, rt_cfg.replace(sun_shadow_mode="off"),
                   sbvh)["hdr"]
    gb = out["gbuffer"]
    ao, bent = hbao.hbao(sbvh, gb, out["depth"], fc, W, H)
    m = gb.mask
    ao_mean = float(ao[m].mean())
    bent_len = torch.linalg.vector_norm(mu.oct_decode(bent)[m], dim=-1)
    vis_rt = frame.rt_sun_visibility(path.scene, sbvh, gb, fc)
    smap, _ = shadow.render_sun_shadow_map(
        path.scene, fc.scene_rotation, fc.sun_view_proj,
        shadow.shadow_params(cfg.shadow_map_resolution, cfg))
    vis_map = shadow.sun_visibility(
        gb.world_pos, None, smap, fc.sun_view_proj,
        cfg.shadow_map_resolution,
        normal=mu.oct_decode(gb.normals).contiguous(), sun_dir=fc.sun_dir)
    agree = float(((vis_rt[m] > 0.5) == (vis_map[m] > 0.5)).float().mean())
    _log(f"(e) mean hdr {float(hdr.mean()):.2f} with RT shadows, "
         f"{float(off.mean()):.2f} without; RT shadow share "
         f"{float((vis_rt[m] < 0.5).float().mean()):.4f}, map shadow share "
         f"{float((vis_map[m] < 0.5).float().mean()):.4f}, RT and map agree "
         f"on {agree:.4f} of the covered pixels; AO mean {ao_mean:.4f} "
         f"(min {float(ao.min()):.4f}, max {float(ao.max()):.4f}); bent "
         f"normal length {float(bent_len.min()):.6f}-"
         f"{float(bent_len.max()):.6f}")
    if not bool(torch.isfinite(hdr).all()):
        raise RuntimeError("the RT frame is not finite")
    if not float(hdr.mean()) < float(off.mean()):
        raise RuntimeError("RT shadows do not darken the frame")
    if not (float(ao.min()) >= 0.0 and float(ao.max()) <= 1.0
            and 0.0 < ao_mean < 1.0):
        raise RuntimeError("AO outside [0, 1] or its mean not inside it")
    if float((bent_len - 1.0).abs().max()) > 1e-4:
        raise RuntimeError("the bent normals are not unit length")
    k8_hbao = [_bound_args(skylight.sky_lighting_plain, a, kw)
               for k, a, kw in raster_calls if k == "k8"]
    if not k8_hbao or any(x["hbao"] is None or x["bent_normals"] is None
                          for x in k8_hbao):
        raise RuntimeError("(e) K8 was not given the HBAO and bent normals")
    check_twins("(e) RT frame", [c for c in raster_calls
                                 if c[0] in ("k5", "k5d", "k6", "k8", "k9",
                                             "k10", "k11", "k12", "k13",
                                             "k15")],
                raster, clustered, taa,
                need=("k5", "k5d", "k6", "k8", "k9", "k10", "k11", "k12",
                      "k13",
                      "k15"))
    rows += [k4_row(bvh, rt_calls[role], role, rt_launches.get(role, 0))
             for role in ("hbao", "rt_sun")]
    rows.append(k15_row(shading, raster_calls, k15_rt["given"],
                        name="k15_sun_term[given]", role="given"))
    return rows, types.SimpleNamespace(sbvh=sbvh, calls=calls, fc=fc_pt,
                                       history=pt_history)


def binary_phase(dev, path, pt):
    """(g) The atrium's binary BVH (wide=False: the merged table), K4's
    binary role on the captured primary, bounce and shadow rays of (c)
    through bvh.trace, against its twin, and its closest hits against the
    wide layout's. Returns the role's JSON rows."""
    import torch
    from incarnation_tpu_torch.kernels import bvh
    t0 = time.perf_counter()
    bb = bvh.build_scene_bvh(path.scene, wide=False, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n_leaf = int((bb.rows[:bb.nodes, 12] > 0.5).sum())
    _log(f"(g) atrium binary BVH ({'merged' if bb.merged else 'split'}): "
         f"{bb.nodes} nodes ({n_leaf} leaves), {bb.rows.shape[0]} rows, "
         f"{bb.nbytes() / 2**20:.2f} MiB on the card, built on the host in "
         f"{secs:.1f} s")
    roles = {"pt_primary": "binary_primary", "pt_bounce": "binary_bounce",
             "pt_shadow": "binary_shadow"}
    bvh.K4.reset()
    outs = {}
    for src, role in roles.items():
        _, o, d, tmin, tmax, any_hit, _ = pt.calls[src]
        outs[role] = bvh.trace(bb, o, d, tmin=tmin, tmax=tmax,
                               any_hit=any_hit, role=role)
    launches = dict(bvh.K4.by_name)
    _log(f"(g) K4 launches by role: {json.dumps(launches)}")
    if launches != {role: 1 for role in roles.values()}:
        raise RuntimeError(f"binary K4 launches {launches}")
    rows = []
    for src, role in roles.items():
        wb, o, d, tmin, tmax, any_hit, _ = pt.calls[src]
        got = outs[role]
        wide = bvh.trace_k4(wb, o, d, tmin, tmax, any_hit,
                            return_steps=True)
        if any_hit:
            differ = (got["tri"] >= 0) != (wide["tri"] >= 0)
            what = "occlusion"
        else:
            # the same nearest depth; where it ties the layouts may keep
            # different triangles
            differ = (got["tri"] != wide["tri"]) & (got["t"] != wide["t"])
            what = "closest hit"
        ties = int(((got["tri"] != wide["tri"]) & ~differ).sum())
        if int(differ.sum()):
            raise RuntimeError(f"(g) {role}: {what} differs from the wide "
                               f"layout's on {int(differ.sum())} rays")
        row = k4_row(bvh, (bb, o, d, tmin, tmax, any_hit, None), role,
                     launches[role])
        _log(f"(g) {role}: {what} as the wide layout's ({ties} rays keep "
             f"another triangle at a tied depth); steps per ray "
             f"{row['steps_mean']:.2f} binary, "
             f"{float(wide['steps'].double().mean()):.2f} wide")
        rows.append(row)
    return rows


# tools/pt_step_bench.py's cases (:47-56): label, any_hit, filter
ALPHA_CASES = (("closest_primary", False, False),
               ("closest_primary", False, True),
               ("closest_incoherent", False, False),
               ("closest_incoherent", False, True),
               ("anyhit", True, False), ("anyhit", True, True))


def alpha_phase(dev, path, pt):
    """(h) tools/pt_step_bench.py's six traces through bvh.trace on the
    wide BVH, each without and with the path tracer's opacity test
    (pathtrace.AlphaFilter, noise 0, as the bench's alpha_of): closest and
    any hit of PT_W x PT_H rays from the eye (0, 4, -14) in seeded
    directions, and closest hits of incoherent rays. The bench's
    incoherent cases trace the eye rays under another traversal profile;
    the port has one walk, so its incoherent rays are the path tracer's
    own bounce rays from (c). The filtered traces (K4's alpha role)
    against the twin. Returns their rows."""
    import torch
    from incarnation_tpu_torch.kernels import bvh, pathtrace
    r = PT_W * PT_H
    rng = np.random.default_rng(0)
    dirs = rng.standard_normal((r, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d = torch.tensor(dirs, device=dev)
    o = torch.tensor(np.float32([0.0, 4.0, -14.0]), device=dev).expand(
        r, 3).contiguous()
    _, bo, bd, btmin, btmax, _, _ = pt.calls["pt_bounce"]
    rays = {"closest_primary": (o, d, 0.0, 1e30),
            "closest_incoherent": (bo, bd, btmin, btmax),
            "anyhit": (o, d, 0.0, 1e30)}
    filters = {k: pathtrace.AlphaFilter(path.scene, torch.zeros(
        v[0].shape[0], device=dev)) for k, v in rays.items()}
    bvh.K4.reset()
    outs = []
    for label, any_hit, filtered in ALPHA_CASES:
        role = f"alpha_{label}" if filtered else f"bare_{label}"
        ro, rd, tmin, tmax = rays[label]
        outs.append(bvh.trace(pt.sbvh, ro, rd, tmin=tmin, tmax=tmax,
                              any_hit=any_hit,
                              alpha_of=filters[label] if filtered else None,
                              role=role))
    launches = dict(bvh.K4.by_name)
    _log(f"(h) K4 launches by role: {json.dumps(launches)}")
    rows = []
    for (label, any_hit, filtered), out in zip(ALPHA_CASES, outs):
        role = f"alpha_{label}" if filtered else f"bare_{label}"
        ro, rd, tmin, tmax = rays[label]
        flt = filters[label] if filtered else None
        if int(out["trunc"]):
            raise RuntimeError(f"(h) {role}: trunc {int(out['trunc'])}")
        ms = device_ms(lambda: bvh.trace_k4(pt.sbvh, ro, rd, tmin, tmax,
                                            any_hit, alpha_of=flt), 5)
        _log(f"(h) {role}: {int((out['tri'] >= 0).sum())} accepted hits of "
             f"{ro.shape[0]} rays, {ms:.4f} ms")
        if filtered:
            rows.append(k4_row(bvh, (pt.sbvh, ro, rd, tmin, tmax, any_hit,
                                     flt), role, launches[role]))
    return rows


def _png_check(png_path, w, h):
    """The PNG decodes at (h, w) and is not black -> its pixels."""
    from incarnation_tpu_torch.utils import imageio
    img = imageio.load_png(png_path)
    if img.shape != (h, w, 3) or float(img.mean()) < 2.0:
        raise RuntimeError(f"{png_path}: shape {img.shape}, mean "
                           f"{float(img.mean()):.2f}")
    return img


def cli_phase(dev, path):
    """(i) The CLI in-process (cli.main) on the atrium's glTF: a raster
    run of 8 TAA frames at W x H, equal to render_frame on the Config,
    View and constants the CLI built; an RT shadow + HBAO frame; a
    path-traced run of 4 samples at PT_W x PT_H checkpointed after 2 and
    resumed, equal to an uninterrupted run. Every PNG decodes and is not
    black. Returns the row of K3's resolve in its shift role, which only
    this path launches."""
    import torch
    from incarnation_tpu_torch.app import cli
    from incarnation_tpu_torch.kernels import bvh, clustered, raster, taa
    from incarnation_tpu_torch.renderer import frame
    from incarnation_tpu_torch.scene import stress
    out_dir = ROOT / "build" / "smoke_cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    model = str(stress.build_atrium(ATRIUM_DIR))
    base = ["--model", model, "--sun", "100"]
    kernels = (raster.K1, clustered.K2, taa.K3, bvh.K4)
    for k in kernels:
        k.reset()
    calls = []
    with _capturing(calls, raster, clustered, taa, limit=8):
        res = cli.main(base + ["--width", str(W), "--height", str(H),
                               "--frames", str(FRAMES), "--out",
                               str(out_dir / "raster.png")])
    counts = [k.launches for k in kernels]
    _log(f"(i) CLI raster {W}x{H}: frame ms " + ", ".join(
        f"{t:.2f}" for t in res["frame_ms"]) + f"; launches K1-K4 {counts}")
    # the CLI's camera is static (jitter only): K3's resolve takes the
    # constant shift
    if 0 in counts[:3] or taa.K3.by_name.get("shift", 0) != FRAMES - 1:
        raise RuntimeError(f"(i) the CLI's frames skipped a kernel: "
                           f"{counts}, K3 by role {taa.K3.by_name}")
    k3r = check_twins("(i) CLI raster", calls, raster, clustered, taa,
                      need=("k1", "k2", "k3r", "k5", "k5d", "k6", "k8",
                            "k9", "k10", "k11", "k12", "k13", "k14",
                            "k15"))
    img = _png_check(out_dir / "raster.png", W, H)
    ref = frame.render_frame(res["scene"], res["fc"], config=res["config"],
                             params=res["params"], probe=res["probe"],
                             env_brdf=res["env_brdf"],
                             history=res["history"])["color"]
    same = bool(np.array_equal(img, ref.cpu().numpy()))
    _log(f"(i) CLI PNG equals render_frame on the CLI's Config, View and "
         f"last frame's constants and history: {same}")
    if not same:
        raise RuntimeError("(i) the CLI's PNG differs from render_frame's")
    if {_k3r_role(taa, x) for x in k3r} != {"shift"}:
        raise RuntimeError("(i) the CLI's resolves took another role than "
                           "the static shift")
    row = k3r_row(taa, calls, FRAMES - 1, name="k3_taa_resolve[shift]",
                  role="shift")

    for k in kernels:
        k.reset()
    res = cli.main(base + ["--width", str(W), "--height", str(H),
                           "--shadows", "rt", "--hbao", "--out",
                           str(out_dir / "rt.png")])
    _log(f"(i) CLI --shadows rt --hbao: {res['frame_ms'][0]:.1f} ms with "
         f"the BVH build; K4 launches {dict(bvh.K4.by_name)}")
    if not bvh.K4.by_name.get("rt_sun") or not bvh.K4.by_name.get("hbao"):
        raise RuntimeError("(i) the RT frame did not trace")
    _png_check(out_dir / "rt.png", W, H)

    pt = base + ["--width", str(PT_W), "--height", str(PT_H), "--pathtrace"]
    ck = out_dir / "pt.npz"
    ck.unlink(missing_ok=True)
    bvh.K4.reset()
    full = cli.main(pt + ["--spp", "4", "--out", str(out_dir / "pt4.png")])
    _log(f"(i) CLI --pathtrace --spp 4: K4 launches "
         f"{dict(bvh.K4.by_name)}; counted rays per sample "
         + ", ".join(f"{x:.0f}" for x in full["rays"]))
    cli.main(pt + ["--spp", "2", "--pt-checkpoint", str(ck), "--out",
                   str(out_dir / "pt2.png")])
    resumed = cli.main(pt + ["--spp", "4", "--pt-checkpoint", str(ck),
                             "--resume", "--out",
                             str(out_dir / "pt_resumed.png")])
    same = bool(torch.equal(resumed["history"], full["history"]))
    _log(f"(i) CLI path trace resumed after 2 of 4 samples equals the "
         f"uninterrupted run: {same}")
    if not same:
        raise RuntimeError("(i) the resumed path trace differs")
    a = _png_check(out_dir / "pt4.png", PT_W, PT_H)
    if not np.array_equal(a, _png_check(out_dir / "pt_resumed.png", PT_W,
                                        PT_H)):
        raise RuntimeError("(i) the resumed PNG differs")
    return [row]


def viewer_phase(dev, path):
    """(j) The web viewer serving the atrium at VIEW_W x VIEW_H on a free
    port: the
    page, two frames, an orbit input after which the next frame differs,
    then /quit, which ends the render loop. -> the rows of K8's and K14's
    stochastic roles without the checkerboard (`jitter`, `dither`: K14
    alone on the inputs of K15's map role, which taps the map itself),
    which only this path takes."""
    import threading
    import urllib.request
    from incarnation_tpu_torch.app import viewer
    from incarnation_tpu_torch.kernels import (clustered, raster, shadow,
                                               skylight, taa)
    from incarnation_tpu_torch.scene import png
    w, h = VIEW_W, VIEW_H
    from incarnation_tpu_torch.kernels import shading
    for k in (raster.K1, clustered.K2, skylight.K8, shadow.K14,
              shading.K15):
        k.reset()
    calls = []
    with _capturing(calls, raster, clustered, taa, limit=8):
        server, state = viewer.serve(path.host, path.cfg, w, h, port=0,
                                     block=False)
        loop = threading.Thread(target=viewer.render_loop,
                                args=(path.host, path.cfg, state, w, h),
                                daemon=True)
        loop.start()
        port = server.server_address[1]

        def get(p):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{p}",
                                        timeout=120) as r:
                return r.read(), dict(r.headers)

        def post(p, obj):
            req = urllib.request.Request(f"http://127.0.0.1:{port}{p}",
                                         data=json.dumps(obj).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.read()

        try:
            page, _ = get("/")
            f1, h1 = get("/frame.png?seq=0")
            f2, h2 = get(f"/frame.png?seq={h1['X-Seq']}")
            if state.error:
                raise RuntimeError(f"(j) viewer: {state.error}")
            if png.png_size(f1) != (w, h) \
                    or h1["Content-Type"] != "image/png":
                raise RuntimeError("(j) the frame is not a PNG of the size")
            seq = int(h2["X-Seq"])
            post("/input", {"cmd": "orbit", "dx": 80, "dy": 0})
            t0 = time.perf_counter()
            f3, h3 = get(f"/frame.png?seq={seq}")
            while int(h3["X-Seq"]) <= seq + 1 \
                    and time.perf_counter() - t0 < 60:
                f3, h3 = get(f"/frame.png?seq={h3['X-Seq']}")
            st = json.loads(get("/state")[0])
            moved = not np.array_equal(png.decode_png(f3),
                                       png.decode_png(f2))
            _log(f"(j) viewer {w}x{h}: page {len(page)} B, frames "
                 f"{h1['X-Seq']}, {h2['X-Seq']}, {h3['X-Seq']}; "
                 f"{st['panel']['fps']} fps; the frame after the orbit "
                 f"input differs: {moved}; launches K1 "
                 f"{raster.K1.launches}, K2 {clustered.K2.launches}")
            if b"incarnation_tpu" not in page or not moved:
                raise RuntimeError("(j) the viewer's frame did not advance")
        finally:
            post("/quit", {})
            loop.join(timeout=120)
            server.shutdown()
            server.server_close()
    if loop.is_alive() or state.error:
        raise RuntimeError(f"(j) the render loop did not end cleanly: "
                           f"{state.error}")
    n14, k15_roles = shadow.K14.launches, dict(shading.K15.by_name)
    check_twins("(j) viewer", calls, raster, clustered, taa,
                need=("k1", "k2", "k3r", "k5", "k5d", "k6", "k8", "k9",
                      "k10", "k11", "k12", "k13", "k14", "k15"))
    n = skylight.K8.by_name.get("jitter", 0)
    if not n:
        raise RuntimeError(f"(j) the viewer's frames launched K8's roles "
                           f"{skylight.K8.by_name}, not `jitter`")
    if n14 or not k15_roles.get("map", 0) \
            or not any(_k14_role(x) == "dither+nl"
                       for x in _k14_calls(calls)):
        raise RuntimeError(f"(j) the viewer's frames launched K14 {n14} "
                           f"times, K15 {k15_roles}: not K15's map role "
                           "with the `dither` tap alone")
    return [k8_row(skylight, calls, n, name="k8_sky_lighting[jitter]",
                   role="jitter"),
            k14_row(shadow, calls, n14, name="k14_sun_tap[dither]",
                    role="dither+nl")]


def band_phase(dev, path, pt):
    """(k) Band sharding over two devices (two cards when the machine shows
    them, else cuda:0 twice): a W x H frame equal to the single frame, a
    second TAA frame through the halos, a band-sharded path-traced sample
    bit-identical to the single one and an SPP-sharded round by the
    batch-mean rule."""
    import torch
    from incarnation_tpu_torch.dist import sharding
    from incarnation_tpu_torch.kernels import clustered, pathtrace, raster
    from incarnation_tpu_torch.kernels import taa
    from incarnation_tpu_torch.renderer import frame
    n_cards = torch.cuda.device_count()
    devices = ["cuda:0", "cuda:1"] if n_cards > 1 else ["cuda:0", "cuda:0"]
    _log(f"(k) band sharding on {devices} ({n_cards} cards visible)")
    kw = dict(config=path.cfg, params=path.params, probe=path.probe,
              env_brdf=path.env_brdf)
    hist0 = torch.zeros((H, W, 3), device=dev)
    fc0 = path.make_fc(0, None)
    fc1 = path.make_fc(1, fc0.view_proj.cpu().numpy())
    s0 = path.run(fc0, hist0)
    s1 = path.run(fc1, s0["accumulation"])
    sharding.render_frame_sharded(path.scene, fc0, devices=devices,
                                  history=hist0, **kw)      # warm-up
    for k in (raster.K1, clustered.K2, taa.K3):
        k.reset()
    # the second frame's launches are captured, to hold each against its
    # twin at the band's shapes (K3 with its halo rows) once counted
    calls = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b0 = sharding.render_frame_sharded(path.scene, fc0, devices=devices,
                                       history=hist0, **kw)
    with _capturing(calls, raster, clustered, taa):
        b1 = sharding.render_frame_sharded(
            path.scene, fc1, devices=devices, history=b0["accumulation"],
            **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 2
    counts = [raster.K1.launches, clustered.K2.launches, taa.K3.launches]
    # A band renders through view_proj @ J, which rounds apart from the
    # single frame's view_proj at the last bit: a pixel centre on a
    # triangle edge, or two surfaces at one depth, may go the other way.
    # So tri may differ on at most BAND_TRI_SHARE of the pixels, and the
    # u8 colour must hold 50 dB.
    for i, (b, s) in enumerate(((b0, s0), (b1, s1))):
        share = float((b["tri"] != s["tri"]).float().mean())
        mse = float(((b["color"].double() - s["color"].double()) ** 2)
                    .mean())
        psnr = float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        acc = float((b["accumulation"] - s["accumulation"]).abs().max())
        _log(f"(k) band frame {i}: tri differs from the single frame's on "
             f"{share:.2e} of the pixels, u8 colour PSNR {psnr:.2f} dB, "
             f"accumulation max abs diff {acc:.3e}")
        if share > BAND_TRI_SHARE or psnr < 50.0:
            raise RuntimeError(f"(k) band frame {i} differs from the single")
    _log(f"(k) band frames: {ms:.2f} ms each (host clock, 2 frames), "
         f"launches K1, K2, K3 {counts}")
    if 0 in counts:
        raise RuntimeError(f"(k) the band frames skipped a kernel: {counts}")
    k3r = check_twins("(k) band frame", calls, raster, clustered, taa,
                      need=("k1", "k2", "k3r", "k5", "k5d", "k6", "k8",
                            "k9", "k10", "k11", "k12", "k13", "k14",
                            "k15"))
    k14_rows0 = {(x["row0"], _k14_role(x)) for x in _k14_calls(calls)}
    if k14_rows0 != {(0, "dither_checker+nl"),
                     (H // 2, "dither_checker+nl")}:
        raise RuntimeError(f"(k) the bands' K15 map taps (first row, role) "
                           f"{sorted(k14_rows0)}: not the checkerboard from "
                           "rows 0 and H / 2")
    if {_k6_args(a, kw)["row0"] for kind, a, kw in calls if kind == "k6"} \
            != {0, H // 2}:
        raise RuntimeError("(k) the bands' K6 launches do not start at "
                           "rows 0 and H / 2")
    if len(k3r) != 2 or any(x["hdr_halo"] is None or _k3_fetch_args(x)[5]
                            <= 0 for x in k3r) \
            or {x["row0"] for x in k3r} != {0, H // 2}:
        raise RuntimeError("(k) a band's K3 resolve had no halo rows")
    rows = [k3r_row(taa, calls, counts[2], name="k3_taa_resolve[band_halo]",
                    role="reproject", halo=True),
            k3_row(taa, _k3_fetch_args(k3r[0]), "k3_taa_fetch[band_halo]",
                   0)]

    hist = pt.history
    single = frame.render_pathtrace(path.scene, pt.sbvh, pt.fc, hist, 20,
                                    config=path.cfg, width=PT_W,
                                    height=PT_H, probe=path.probe)
    band = sharding.pathtrace_band_sharded(
        path.scene, pt.sbvh, pt.fc, hist, 20, config=path.cfg, width=PT_W,
        height=PT_H, devices=devices, probe=path.probe)
    same = bool(torch.equal(band["history"], single["history"]))
    _log(f"(k) band-sharded path-traced sample {PT_W}x{PT_H}: identical "
         f"{same}, counted rays {float(band['rays']):.0f} "
         f"(single {float(single['rays']):.0f})")
    if not same or float(band["rays"]) != float(single["rays"]):
        raise RuntimeError("(k) the band-sharded sample differs")
    spp = sharding.pathtrace_spp_sharded(
        path.scene, pt.sbvh, pt.fc, hist, 21, config=path.cfg, width=PT_W,
        height=PT_H, devices=devices, probe=path.probe)
    scene_b, fc_b, wn, wt = frame.pathtrace_inputs(path.scene, pt.fc)
    cur = pathtrace.trace_sample(
        scene_b, pt.sbvh, wn, wt, fc_b, path.probe, [21, 22], PT_W, PT_H,
        sqrt_sample_count=int(np.sqrt(path.cfg.max_sample_count)),
        turbidity=path.cfg.turbidity, sky_rot3=pt.fc.scene_rotation[:3, :3],
        sun_dir_world=pt.fc.sun_dir)
    want = pathtrace.integrate(hist, cur, 21)
    err = float(((spp - want).abs() / (want.abs() + 1e-6)).max())
    _log(f"(k) SPP-sharded round (samples 21, 22): max relative diff "
         f"{err:.3e} from the batch-mean rule")
    if err > 1e-6:
        raise RuntimeError("(k) the SPP-sharded round misses the rule")
    return rows


def check_twins(what, calls, raster, clustered, taa, need):
    """Each captured K1, K2, K3, K5, K6, K8, K9, K10, K11, K12, K13 and
    K15 launch against its twin, at compare_kernels' tolerances (K1 via
    _k1_error, K2 K2_RTOL, K3's fetch 1e-6 relative, K5 via _k5_error,
    K5's decal step via _k5d_error (bit for bit), K6's peel step via
    _k6_error, K8 via _k8_error, K9-K15 and K3's resolve exactly, NaN for
    NaN), and K14's tap alone on the inputs of
    each K15 launch with a map (kind k14), at the shapes the path gave
    it; raises if a kind in `need` was not captured, or if the path
    launched K14 itself. Returns the K3 resolves' arguments by name."""
    from incarnation_tpu_torch.kernels import (cull, resolve, shading, shadow,
                                               skylight)
    if any(c[0] == "k14" for c in calls):
        raise RuntimeError(f"{what}: the path launched K14 (K15 taps the "
                           "map)")
    kinds = {k: [c for c in calls if c[0] == k]
             for k in ("k1", "k2", "k3", "k5", "k5d", "k6", "k8", "k9",
                       "k10", "k11", "k13", "k15")}
    kinds["k14"] = _k14_calls(calls)
    # taa_resolve launches K3's resolve only with a history on the card
    kinds["k3r"] = [c for c in calls if c[0] == "k3r"
                    and _k3r_calls(taa, [c])]
    # environment_background's envmap role is torch on every device
    kinds["k12"] = [c for c in calls if c[0] == "k12" and _bound_args(
        skylight.environment_background_plain, c[1], c[2])["dynamic_sky"]]
    if not all(kinds[k] for k in need):
        raise RuntimeError(f"{what}: captured launches per kernel "
                           f"{ {k: len(v) for k, v in kinds.items()} }")
    worst = (0.0, 0.0, 0.0)
    for _, a, kw in kinds["k1"]:
        bins, p = a
        zl, mt = kw.get("z_limit"), kw.get("mask_table")
        e = _k1_error(raster.rasterize_tiles(bins, p, z_limit=zl,
                                             mask_table=mt),
                      raster.rasterize_tiles_plain(bins, p, z_limit=zl,
                                                   mask_table=mt))
        worst = tuple(max(x, y) for x, y in zip(worst, e))
    shapes = sorted({(c[1][1].width, c[1][1].height, c[1][1].pair_capacity)
                     for c in kinds["k1"]})
    if shapes:
        _log(f"{what}: K1 x{len(kinds['k1'])} at (width, height, pair "
             f"capacity) {shapes} against the twin: max abs err "
             f"{worst[0]:.3e}, max relative err {worst[1]:.3e}, tri "
             f"mismatch share {worst[2]:.2e}")
    for i, (_, a, kw) in enumerate(kinds["k2"]):
        err, rel = _close(f"{what} K2",
                          clustered.clustered_lighting(*a, **kw),
                          clustered.clustered_lighting_plain(*a, **kw),
                          rtol=K2_RTOL, atol_frac=1e-5, where=a[0].mask)
        _log(f"{what}: K2 {i} ({a[8]}x{a[9]}) against the twin: max abs "
             f"err {err:.3e}, max relative err {rel:.3e}")
    for i, (_, a, kw) in enumerate(kinds["k3"]):
        err, rel = _close(f"{what} K3", taa.history_fetch(*a),
                          taa.history_fetch_plain(*a), rtol=1e-6,
                          atol_frac=1e-7)
        _log(f"{what}: K3 {i} ({a[3]}x{a[4]}, "
             f"{a[5] if len(a) > 5 else 0} halo rows each way) against the "
             f"twin: max abs err {err:.3e}, max relative err {rel:.3e}")
    k5_args = [_k5_args(a, kw) for _, a, kw in kinds["k5"]]
    k5 = [_k5_error(resolve.resolve_gbuffer(**x),
                    resolve.resolve_gbuffer_plain(**x)) for x in k5_args]
    k6_args = [_k6_args(a, kw) for _, a, kw in kinds["k6"]]
    k6 = [_k6_error(resolve, x) for x in k6_args]
    k5d = [kw for _, _, kw in kinds["k5d"]]
    covers = [_k5d_error(resolve, x) for x in k5d]
    if k5d:
        _log(f"{what}: K5's decal step x{len(k5d)} (roles "
             f"{sorted({_k5d_role(x) for x in k5d})}, first rows "
             f"{sorted({x['row0'] for x in k5d})}, decal pixels passing "
             f"the depth test {covers}): the overflow, base colour, "
             f"normals, mrao and n3 identical to the twin's")
    if k5 or k6:
        _log(f"{what}: K5 x{len(k5)} (roles "
             f"{sorted({_k5_role(x) for x in k5_args})}) against the twin: "
             f"max abs err {max([e[0] for e in k5], default=0.0):.3e}, max "
             f"relative err {max([e[1] for e in k5], default=0.0):.3e}; K6 "
             f"x{len(k6)} (peel steps, roles "
             f"{sorted({_k6_role(x) for x in k6_args})}, first rows "
             f"{sorted({x['row0'] for x in k6_args})}): every accumulator, "
             f"z_limit and count identical to the twin's, pixels newly "
             f"passed {[e[1] for e in k6]}, left to the next peel "
             f"{[e[2] for e in k6]}; the standalone role on each peel's "
             f"layer as its twin")
    k8 = [_k8_error(skylight.sky_lighting(*a, **kw),
                    skylight.sky_lighting_plain(*a, **kw), a[0].mask)
          for _, a, kw in kinds["k8"]]
    for _, a, kw in kinds["k9"]:
        _k9_error(raster.prepare_geometry(*a, **kw),
                  raster.prepare_geometry_plain(*a, **kw))
    if k8 or kinds["k9"]:
        given = [_bound_args(skylight.sky_lighting_plain, a, kw)
                 for _, a, kw in kinds["k8"]]
        roles = sorted({(", ".join(k for k in ("hbao", "bent_normals",
                                               "extras") if x[k] is not None)
                         or "no optional input") + f" [{_k8_role(x)}]"
                        for x in given})
        _log(f"{what}: K8 x{len(k8)} ({'; '.join(roles)}) against the twin: "
             f"max abs err {max([e[0] for e in k8], default=0.0):.3e}, "
             f"{max([e[1] for e in k8], default=0.0):.3e} of the peak; K9 "
             f"x{len(kinds['k9'])} identical to the twin")
    for _, a, kw in kinds["k10"]:
        _k10_error(raster.bin_triangles_layered(*a, **kw),
                   raster.bin_triangles_layered_plain(*a, **kw))
    if kinds["k10"]:
        shapes = sorted({(a[0].bbox.shape[0], a[1].width, a[1].height,
                          kw.get("n_layers", 1)) for _, a, kw in kinds["k10"]})
        _log(f"{what}: K10 x{len(kinds['k10'])} at (triangles, width, "
             f"height, layers) {shapes} identical to the twin")
    for _, a, kw in kinds["k11"]:
        _k11_error(clustered.build_light_clusters(*a, **kw),
                   clustered.build_light_clusters_plain(*a, **kw))
    for _, a, kw in kinds["k12"]:
        _k12_error(skylight.environment_background(*a, **kw),
                   skylight.environment_background_plain(*a, **kw))
    if kinds["k11"] or kinds["k12"]:
        grids = sorted({(*clustered.cluster_grid_shape(x["config"]),
                         x["lights"].type.shape[0]) for x in (
            _bound_args(clustered.build_light_clusters_plain, a, kw)
            for _, a, kw in kinds["k11"])})
        _log(f"{what}: K11 x{len(kinds['k11'])} (gx, gy, gz, lights "
             f"{grids}) and K12 x{len(kinds['k12'])} (frames "
             f"{sorted({(a[3], a[4]) for _, a, _ in kinds['k12']})}) "
             "identical to the twin")
    for _, a, kw in kinds["k13"]:
        for got, ref in zip(cull.cull_lists(*a, **kw),
                            cull.cull_lists_plain(*a, **kw)):
            _k13_error(got, ref)
    k14 = kinds["k14"]
    for x in k14:
        _k14_error(shadow.sun_visibility(**x),
                   shadow.sun_visibility_plain(**x))
    if kinds["k13"] or k14:
        spheres = sorted({tuple(b.shape[0] for b, _ in a[0])
                          for _, a, _ in kinds["k13"]})
        taps = sorted({(_k14_role(x), x["row0"],
                        tuple(x["world_pos"].shape[:2])) for x in k14})
        _log(f"{what}: K13 x{len(kinds['k13'])} (spheres a list "
             f"{spheres}) and "
             f"K14 alone x{len(k14)} on K15's map inputs (roles, first "
             f"rows and shapes {taps}) identical to the twin")
    k15 = [_bound_args(shading.sun_term_plain, a, kw)
           for _, a, kw in kinds["k15"]]
    for x in k15:
        _same_or_nan(f"{what} K15", shading.sun_term(**x),
                     shading.sun_term_plain(**x))
    k3r = _k3r_calls(taa, kinds["k3r"])
    for x in k3r:
        _same_or_nan(f"{what} K3 resolve", taa.taa_resolve(**x),
                     taa.taa_resolve_plain(**x))
    if k15 or k3r:
        roles15 = sorted({(_k15_role(x), x["row0"],
                           tuple(x["gb"].mask.shape)) for x in k15})
        roles3 = sorted({(_k3r_role(taa, x), x["row0"], x["width"],
                          x["height"], x["hdr_halo"] is not None)
                         for x in k3r})
        _log(f"{what}: K15 x{len(k15)} (roles, first rows and shapes "
             f"{roles15}) and K3's resolve x{len(k3r)} (roles, first rows, "
             f"sizes and HDR halos {roles3}) identical to the twin")
    return k3r


def k4_row(bvh, call, role, n_launches):
    """K4 against its twin on one captured launch (identical tri, t, u, v,
    steps and trunc, or it raises), both timed, the bound from the twin's
    walk -> the role's JSON row. A launch with an alpha filter is bounded
    by its walk alone: the opacity tests' fetches and operations are not
    counted, so its bound is looser than the others'."""
    import torch
    b, o, d, tmin, tmax, any_hit, alpha_of = call
    got = bvh.trace_k4(b, o, d, tmin, tmax, any_hit, return_steps=True,
                       alpha_of=alpha_of)
    ref = bvh.trace_plain(b, o, d, tmin, tmax, any_hit, return_steps=True,
                          alpha_of=alpha_of)
    for k in ("tri", "t", "u", "v", "steps"):
        if not torch.equal(got[k], ref[k]):
            n = int((got[k] != ref[k]).sum())
            raise RuntimeError(f"K4 {role}: {k} differs from its twin on "
                               f"{n} of {got[k].numel()} rays")
    if int(got["trunc"]) != int(ref["trunc"]) or int(got["trunc"]):
        raise RuntimeError(f"K4 {role}: trunc {int(got['trunc'])}, twin "
                           f"{int(ref['trunc'])}")
    r = o.shape[0]
    steps = ref["steps"].double()
    leaf = ref["leaf_steps"].double()
    n_rows = int(ref["visited"].sum())
    ray_bytes = r * (K4_RAY_BYTES + (4 if torch.is_tensor(tmin) else 0)
                     + (4 if alpha_of is not None else 0))
    n_links = int(ref["visited_links"].sum()) if "visited_links" in ref \
        else 0
    # the looser count: whole rows, every filled child of a visited row
    lanes = bvh.WIDE_LANES if b.wide else bvh.ROW_LANES
    bytes_all = ray_bytes + n_rows * lanes * 4 + 8 * n_links
    ops_all = float(ref["tri_tests"].double().sum()) * K4_OPS_TRI \
        + float(ref["box_tests"].double().sum()) * K4_OPS_BOX \
        + float((steps - leaf).sum()) * K4_OPS_INTERNAL
    # the walk in octant order: the children up to the first hit
    vrows = ref["visited"]
    is_leaf = b.rows[:, bvh._W_FLAG if b.wide else 12] > 0.5
    slots = ref["visited_slots"]
    n_box = int(slots[vrows & ~is_leaf].sum())
    n_slot = int(slots[vrows & is_leaf].sum())
    nbytes = ray_bytes + n_box * (K4_BOX_BYTES + 4 * b.wide) \
        + n_slot * K4_SLOT_BYTES \
        + (n_rows * 4 + n_links * 8 if n_links else n_rows * K4_ROW_BYTES)
    ops = ops_all + float((ref["box_tests_to_hit"]
                           - ref["box_tests"]).double().sum()) * K4_OPS_BOX
    bound_ms, bound_by = _bound(nbytes, ops)
    bound_all_ms, bound_all_by = _bound(bytes_all, ops_all)
    hits = float((got["tri"] >= 0).float().mean())
    ms = device_ms(lambda: bvh.trace_k4(b, o, d, tmin, tmax, any_hit,
                                        alpha_of=alpha_of), 5)
    plain_ms = once_ms(lambda: bvh.trace_plain(
        b, o, d, tmin, tmax, any_hit, alpha_of=alpha_of))
    regs, spill = K4_RESOURCES.get(
        (bool(any_hit), b.layout, alpha_of is not None), (None, None))
    _log(f"K4 {role}: {r} rays ({'any' if any_hit else 'closest'} hit, "
         f"{'alpha filter, ' if alpha_of is not None else ''}"
         f"{'wide' if b.wide else 'binary'} layout, "
         f"{hits:.4f} hit), steps per ray mean {float(steps.mean()):.2f} "
         f"max {int(steps.max())} (leaf {float(leaf.mean()):.2f}), "
         f"filled slots tested per ray: "
         f"{float(ref['tri_tests'].double().mean()):.2f} triangles, "
         f"{float(ref['box_tests'].double().mean()):.2f} boxes, "
         f"{float(ref['box_tests_to_hit'].double().mean()):.2f} boxes to "
         f"the first hit, {n_rows} distinct rows; {ms:.4f} ms, twin "
         f"{plain_ms:.2f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
         f"{nbytes / 1e6:.2f} MB, {ops / 1e9:.3f} GFLOP; every filled "
         f"child: {bound_all_ms:.4f} ms, {bound_all_by}); {regs} "
         f"registers, {spill} bytes spilled; identical to the twin")
    return dict(
        name=f"k4_trace[{role}]", route="cuda",
        source="incarnation_tpu_torch/csrc/bvh.cu",
        replaces="incarnation_tpu/kernels/bvh.py:1108",
        launches=n_launches, max_abs_err=0.0, max_rel_err=0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, bound_all_filled_ms=bound_all_ms,
        steps_mean=float(steps.mean()), steps_max=int(steps.max()),
        box_tests_mean=float(ref["box_tests"].double().mean()),
        box_tests_to_hit_mean=float(
            ref["box_tests_to_hit"].double().mean()),
        registers=regs, spill_bytes=spill, trunc=int(got["trunc"]))


# (any_hit, layout, alpha) -> (registers, spill bytes) of K4's kernel in
# each compiled role, from ptxas (k4_resources); filled by main()
K4_RESOURCES: dict = {}
# K5's and K6's registers, spill and shared-memory bytes by compiled
# instance (role_resources); K8's and
# K9's by compiled entry (kernel_resources); filled by main()
K5_RESOURCES: dict = {}
K8_RESOURCES: dict = {}
K9_RESOURCES: dict = {}
K11_K15_RESOURCES: dict = {}


def _ptxas_log(build_mod, source: str, log=None) -> str:
    """ptxas's -v report of csrc/<source>.cu: `log`, that report from a
    build, or, where the build was cached, a compile of its own with
    build_mod's flags."""
    import os
    import tempfile
    if log and log != "(cached)":
        return log
    build_mod.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_mod.BUILD_DIR)
    os.close(fd)
    try:
        return subprocess.run(
            [build_mod._nvcc(), *build_mod._FLAGS, "-Xptxas", "-v", "-o",
             tmp, str(build_mod.CSRC / f"{source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            check=True, timeout=600).stdout
    finally:
        os.unlink(tmp)


def k4_resources(build_mod, log=None) -> dict:
    """(any_hit, layout, alpha) -> (registers, bytes of spill stores) of
    csrc/bvh.cu's k4_trace_kernel in each role (the larger of a role's
    instantiations), parsed from ptxas's -v report (_ptxas_log)."""
    import re
    log = _ptxas_log(build_mod, "bvh", log)
    out, role, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*k4_trace_kernel"
                      r"ILb([01])ELi(\d)ELb([01])E", line)
        if m:
            role = (m.group(1) == "1", int(m.group(2)), m.group(3) == "1")
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and role is not None:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and role is not None:
            regs, spilled = out.get(role, (0, 0))
            out[role] = (max(regs, int(m.group(1))), max(spilled, spill or 0))
            role, spill = None, None
    return out


def kernel_resources(build_mod, source: str, kernel: str, log=None) -> dict:
    """{compiled entry: registers, bytes of spill stores and of static
    shared memory} of each entry of csrc/<source>.cu whose name holds
    `kernel` (a template's instantiations apart), parsed from ptxas's -v
    report (_ptxas_log)."""
    import re
    lines = _ptxas_log(build_mod, source, log).splitlines()
    out = {}
    for j, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w*" + kernel + r"\w*)'",
                      line)
        if m:
            text = " ".join(lines[j + 1:j + 4])

            def num(pattern):
                found = re.search(pattern, text)
                return int(found.group(1)) if found else 0
            out[m.group(1)] = dict(
                registers=num(r"Used (\d+) registers"),
                spill_bytes=num(r"(\d+) bytes spill stores"),
                smem_bytes=num(r"(\d+) bytes smem"))
    if not out:
        raise RuntimeError(f"ptxas reported no {kernel}")
    return out


# the template argument of each K5 role's instance (csrc/resolve.cu K5_*),
# as the compiled entry's name spells it; the checkerboard role is a
# kernel of its own
_K5_INSTANCE = {"exact": "ILi0E", "dither": "ILi1E", "jitter": "ILi2E",
                "jitter_checker": "k5_checker_kernel"}


def k5_resources(build_mod, log=None) -> dict:
    """kernel_resources of csrc/resolve.cu's k5_resolve_kernel: its exact
    role's instance, or the one kernel of a tree without roles."""
    found = kernel_resources(build_mod, "resolve", "k5_resolve_kernel", log)
    return next((v for k, v in found.items()
                 if _K5_INSTANCE["exact"] in k), next(iter(found.values())))


def role_resources(kind: str, role: str) -> dict:
    """K5_RESOURCES' or K8_RESOURCES' entry of a K5, K6 or K8 role's
    compiled instance ({} where none matches)."""
    base = role.split("+")[0]
    if kind == "k8":
        # the checkerboard roles have a kernel of their own
        want = ("k8_sky_kernel" if base == "exact" else "checker"
                if base.endswith("_checker") else "stochastic")
        table = K8_RESOURCES
    elif kind == "k5":
        # the decal step's roles are instances of k5_decal_kernel
        decal = base.startswith("decal_")
        want = _K5_INSTANCE.get(base.removeprefix("decal_"), "")
        table = {k: v for k, v in K5_RESOURCES.items()
                 if "k5" in k and ("k5_decal" in k) == decal}
    else:
        # K6's peel step (step_* roles) or its standalone role, each
        # instance templated on STOCH
        step = base.startswith("step_")
        want = ("ILb0E" if base.removeprefix("step_") == "exact"
                else "ILb1E")
        table = {k: v for k, v in K5_RESOURCES.items()
                 if ("k6_peel" if step else "k6_masked_alpha") in k}
    return next((v for k, v in table.items() if want in k), {})


def _k4_twin(bvh):
    def twin(b, o, d, tmin=0.0, tmax=1e30, any_hit=False,
             max_steps=bvh.MAX_STEPS, return_steps=False, role=None,
             alpha_of=None):
        return bvh.trace_plain(b, o, d, tmin, tmax, any_hit, max_steps,
                               return_steps, alpha_of)
    return twin


@contextlib.contextmanager
def _swapped(mod, name, fn):
    """mod.name replaced by fn for the duration of the block."""
    saved = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield
    finally:
        setattr(mod, name, saved)


def _hooked(mod, name, after):
    """mod.name calls after(result, *args, **kwargs) on each call, for the
    duration of the block."""
    fn = getattr(mod, name)

    def hooked(*a, **kw):
        out = fn(*a, **kw)
        after(out, *a, **kw)
        return out
    return _swapped(mod, name, hooked)


def profile_pt(sample, history, bvh, pathtrace):
    """ms of one path-traced sample by phase (a synchronize around each):
    traversal by K4 role, the alpha tests of the peels, the material fetch
    (hit attributes + textures), and the rest (shading, sampling, host);
    then a torch.profiler table of one sample."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    spent = {}

    def timed(key_of, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            key = key_of(*a, **kw)
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    with _swapped(bvh, "trace_k4", timed(
            lambda *a, role=None, **kw: f"traversal[{role}]",
            bvh.trace_k4)), \
            _swapped(pathtrace, "_alpha_at_hit", timed(
                lambda *a, **kw: "alpha tests", pathtrace._alpha_at_hit)), \
            _swapped(pathtrace, "_eval_material", timed(
                lambda *a, **kw: "material fetch",
                pathtrace._eval_material)), \
            _swapped(pathtrace, "_hit_attributes", timed(
                lambda *a, **kw: "hit attributes",
                pathtrace._hit_attributes)):
        sample(1, history)
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sample(1, history)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) * 1e3
    ms = {k: v * 1e3 for k, v in spent.items()}
    ms["shading, sampling, host"] = total - sum(ms.values())
    _log(f"PT sample by phase, {total:.2f} ms with a synchronize around "
         "each phase: " + json.dumps(
             {k: round(v, 3) for k, v in sorted(ms.items(),
                                                key=lambda kv: -kv[1])}))
    sample(1, history)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sample(1, history)
        torch.cuda.synchronize()
    _log(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def _close(what, got, ref, rtol, atol_frac, where=None):
    """Holds got to ref per element: |got - ref| <= rtol |ref| + atol, with
    atol = atol_frac x the median nonzero |ref| (over the pixels `where`
    selects, if given); raises otherwise. Returns (max abs error, max of
    |got - ref| / (|ref| + atol))."""
    if where is not None:
        got, ref = got[where], ref[where]
    mag = ref.abs()
    nonzero = mag[mag > 0]
    atol = atol_frac * float(nonzero.median()) if nonzero.numel() else 0.0
    diff = (got - ref).abs()
    if diff.numel() == 0:
        return 0.0, 0.0
    bad = int((diff > rtol * mag + atol).sum())
    max_abs = float(diff.max())
    max_rel = float((diff / (mag + atol).clamp(min=1e-30)).max())
    if bad:
        raise RuntimeError(
            f"{what} disagrees with its twin on {bad} of {diff.numel()} "
            f"elements: |err| > {rtol} |ref| + {atol:.3e} (max abs err "
            f"{max_abs:.3e}, max relative err {max_rel:.3e})")
    return max_abs, max_rel


def _k1_error(got, ref):
    """(max abs error, max relative error, tri mismatch share) of one K1
    launch against its twin; raises past the tolerance. tri may differ on
    at most 1e-4 of the pixels (the twin's edge tests round as the
    kernel's, so 0 is expected); where tri agrees, depth and every interp
    channel must agree per pixel to 1e-6 (depth) and 1e-5 (interp) of the
    twin's value: the same plane equations in the same order."""
    tri_k, dep_k, int_k = got
    tri_r, dep_r, int_r = ref
    same = tri_k == tri_r
    share = 1.0 - float(same.float().mean())
    if share > 1e-4:
        raise RuntimeError(f"K1 tri differs from its twin on {share:.2e} "
                           "of the pixels")
    err, rel = _close("K1 depth", dep_k, dep_r, rtol=1e-6, atol_frac=1e-7,
                      where=same)
    if (int_k is None) != (int_r is None):
        raise RuntimeError("K1 and its twin disagree on writing interp")
    for c in range(0 if int_k is None else int_k.shape[0]):
        e, r = _close(f"K1 interp channel {c}", int_k[c], int_r[c],
                      rtol=1e-5, atol_frac=1e-6, where=same)
        err, rel = max(err, e), max(rel, r)
    return err, rel, share


def _k2_work(gb, n, v, depth, lights, cluster_mask, config, near, width,
             height):
    """Operations K2's inputs need and the diagnostics of its work, from
    the exact-zero tests of every (covered pixel, light of its cluster)
    pair (clustered.zero_light_tests, the twin's arithmetic): a skipped
    light is charged up to the test that skips it, a contributing one the
    whole evaluation (see K2_OPS_*). -> (ops, diagnostics)."""
    import torch
    from incarnation_tpu_torch.kernels import clustered
    from incarnation_tpu_torch.scene import lights as lights_mod
    cid = clustered.pixel_cluster_id(depth, config, near, width, height)
    words = cluster_mask[cid.long()]
    in_cluster = torch.zeros(depth.shape, dtype=torch.int64,
                             device=depth.device)
    contrib = torch.zeros_like(in_cluster)
    ops = 0
    why = dict(beyond_range=0, outside_cone=0, behind_surface=0)
    for i in range(lights.type.shape[0]):
        on = (((words[..., i // 32] >> (i % 32)) & 1) > 0) & gb.mask
        beyond, outside, behind = clustered.zero_light_tests(
            lights, i, gb.world_pos, n)
        ranged = bool(lights.range[i] > 0.0)
        spot = bool(lights.type[i] == lights_mod.LIGHT_SPOT)
        n_on = int(on.sum())
        n_beyond = int((on & beyond).sum())
        n_outside = int((on & outside).sum())
        n_behind = int((on & behind).sum())
        lit = on & ~beyond & ~outside & ~behind
        in_cluster += on
        contrib += lit
        why["beyond_range"] += n_beyond
        why["outside_cone"] += n_outside
        why["behind_surface"] += n_behind
        dist = K2_OPS_DIST + K2_OPS_RANGE * ranged
        cone = dist + K2_OPS_DIR + K2_OPS_SPOT * spot
        ops += (dist * n_on + (cone - dist) * (n_on - n_beyond)
                + K2_OPS_NOL * (n_on - n_beyond - n_outside)
                + K2_OPS_BRDF * int(lit.sum()))

    def warp_sum_max(count, bw, bh):
        """Sum over warps of bw x bh pixels of the largest lane count."""
        hp, wp = -(-height // bh) * bh, -(-width // bw) * bw
        pad = torch.zeros((hp, wp), dtype=count.dtype, device=count.device)
        pad[:height, :width] = count
        return int(pad.reshape(hp // bh, bh, wp // bw, bw)
                   .amax(dim=(1, 3)).sum())

    pairs = int(in_cluster.sum())
    diag = dict(
        cluster_light_pairs=pairs, contributing=int(contrib.sum()),
        skipped_share=(pairs - int(contrib.sum())) / max(pairs, 1),
        skipped_by=why,
        warp_sum_of_mean_lane=pairs / 32,
        warp_sum_of_max_lane_32x1=warp_sum_max(in_cluster, 32, 1),
        warp_sum_of_max_lane_8x4=warp_sum_max(in_cluster, 8, 4),
        warp_sum_of_max_contributing_32x1=warp_sum_max(contrib, 32, 1),
        warp_sum_of_max_contributing_8x4=warp_sum_max(contrib, 8, 4),
        ops=ops)
    return ops, diag


def _k2_bound(ops, gb, n, v, depth, lights, cluster_mask, config, near,
              width, height):
    """Bytes: the gbuffer planes K2 reads (base colour and mrao as 4-float
    rows, normal, view, world position, mask, depth) and its output, once;
    operations: those _k2_work counts."""
    px = width * height
    nbytes = px * (16 + 16 + 12 + 12 + 12 + 1 + 4 + 12) \
        + cluster_mask.numel() * 4 + lights.type.shape[0] * 64
    return _bound(nbytes, ops)


def check_twin_frame(run, fc, history, raster, clustered, taa):
    """The same frame with every kernel swapped for its plain twin: the
    images must agree (tri on all but 1e-4 of the pixels, u8 colour
    >= 50 dB PSNR)."""
    import torch
    from incarnation_tpu_torch.kernels import (cull, resolve, shading,
                                               skylight)
    got = run(fc, history)
    def raster_plain(bins, params, z_limit=None, mask_table=None,
                     name=None):
        return raster.rasterize_tiles_plain(bins, params, z_limit,
                                            mask_table)

    with _swapped(raster, "rasterize_tiles", raster_plain), \
            _swapped(clustered, "clustered_lighting",
                     clustered.clustered_lighting_plain), \
            _swapped(taa, "taa_resolve", taa.taa_resolve_plain), \
            _swapped(shading, "sun_term", shading.sun_term_plain), \
            _swapped(resolve, "resolve_gbuffer",
                     resolve.resolve_gbuffer_plain), \
            _swapped(resolve, "masked_alpha", resolve.masked_alpha_plain), \
            _swapped(resolve, "masked_peel", resolve.masked_peel_plain), \
            _swapped(resolve, "decal_step", resolve.decal_step_plain), \
            _swapped(skylight, "sky_lighting", skylight.sky_lighting_plain), \
            _swapped(raster, "prepare_geometry",
                     raster.prepare_geometry_plain), \
            _swapped(raster, "bin_triangles_layered",
                     raster.bin_triangles_layered_plain), \
            _swapped(clustered, "build_light_clusters",
                     clustered.build_light_clusters_plain), \
            _swapped(skylight, "environment_background",
                     skylight.environment_background_plain), \
            _swapped(cull, "cull_lists", cull.cull_lists_plain):
        ref = run(fc, history)
    torch.cuda.synchronize()
    share = float((got["tri"] != ref["tri"]).float().mean())
    mse = float(((got["color"].double() - ref["color"].double()) ** 2)
                .mean())
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    hdr_err = float((got["hdr"] - ref["hdr"]).abs().max())
    _log(f"frame with kernels vs frame with twins: tri mismatch share "
         f"{share:.2e}, u8 PSNR {psnr:.2f} dB, hdr max abs diff {hdr_err:.3e}")
    if share > 1e-4 or psnr < 50.0:
        raise RuntimeError("the kernels' frame disagrees with the twins'")


# (module, function) pairs render_frame calls, timed by phase_breakdown
_PHASES = (("cull", "cull_lists"), ("raster", "prepare_geometry"),
           ("raster", "bin_triangles_layered"), ("raster", "rasterize_tiles"),
           ("shadow", "render_sun_shadow_map"), ("resolve", "masked_peel"), ("resolve", "masked_alpha"),
           ("resolve", "resolve_gbuffer"), ("resolve", "decal_step"),
           ("clustered", "build_light_clusters"),
           ("clustered", "clustered_lighting"), ("skylight", "sky_lighting"),
           ("shading", "sun_term"),
           ("skylight", "environment_background"), ("taa", "taa_resolve"),
           ("post", "tonemap"), ("post", "to_uint8"))


def phase_breakdown(run, fc, history, reps: int = 3):
    """ms of each render_frame phase: every call of the functions in
    _PHASES is wrapped in synchronize + host clock; the rest of the frame
    is the glue between them. A phase called inside another (the shadow
    map's own triangle setup, binning and K1 launch) counts to the outer
    one. Mean over reps frames."""
    import importlib
    import torch
    spent = {}
    saved = {}
    depth = [0]
    for mod_name, fn_name in _PHASES:
        mod = importlib.import_module(f"incarnation_tpu_torch.kernels."
                                      f"{mod_name}")
        fn = getattr(mod, fn_name)
        saved[(mod, fn_name)] = fn
        key = f"{mod_name}.{fn_name}"

        def timed(*a, _fn=fn, _key=key, **kw):
            if depth[0]:
                return _fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            depth[0] += 1
            try:
                out = _fn(*a, **kw)
            finally:
                depth[0] -= 1
            torch.cuda.synchronize()
            spent[_key] = spent.get(_key, 0.0) + time.perf_counter() - t0
            return out
        setattr(mod, fn_name, timed)
    try:
        run(fc, history)
        spent.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run(fc, history)
        torch.cuda.synchronize()
        total = (time.perf_counter() - t0) / reps * 1e3
    finally:
        for (mod, fn_name), fn in saved.items():
            setattr(mod, fn_name, fn)
    ms = {k: v / reps * 1e3 for k, v in spent.items()}
    ms["glue"] = total - sum(ms.values())
    _log(f"phase breakdown of one frame, {total:.2f} ms with a synchronize "
         "around each phase: " + json.dumps(
             {k: round(v, 3) for k, v in sorted(ms.items(),
                                                key=lambda kv: -kv[1])}))
    return ms


# operators that launch nothing on the card: allocations (views launch
# nothing either, _launches_work)
_NO_LAUNCH = {"aten::empty.memory_format", "aten::empty_strided",
              "aten::empty_like", "aten::lift_fresh"}


def _launches_work(func) -> bool:
    """Whether an ATen operator runs work on the card: not a view (an
    output that aliases an input without writing it), not an
    allocation."""
    if func.name() in _NO_LAUNCH:
        return False
    return not any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)


def peel_launches(run, fc, history, raster, kernels):
    """What the frame launches per masked peel beside K1's peel: every
    eager torch operator that runs work on the card (_launches_work)
    between one peel's K1 call (rasterize_tiles, name raster_peel) and the
    next's, outside K1's wrapper, counted by a TorchDispatchMode over one
    frame, and the hand-written kernels' launches in the same windows
    (K1's own among them). -> (operators per window, the first window's
    operators by name, kernel launches per window by kernel)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    ops, marks, inside = [], [], [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not inside[0] and _launches_work(func):
                ops.append(func.name())
            return func(*args, **(kwargs or {}))
    k1 = raster.rasterize_tiles

    def k1_marked(*a, **kw):
        if kw.get("name") == "raster_peel":
            marks.append((len(ops), [k.launches for k in kernels]))
        inside[0] += 1
        try:
            return k1(*a, **kw)
        finally:
            inside[0] -= 1
    with _swapped(raster, "rasterize_tiles", k1_marked), Count():
        run(fc, history)
    torch.cuda.synchronize()
    per = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    names = {}
    for op in ops[marks[0][0]:marks[1][0]] if len(marks) > 1 else []:
        names[op] = names.get(op, 0) + 1
    launched = [{k.fn: n1 - n0 for k, n0, n1 in zip(kernels, a[1], b[1])
                 if n1 > n0} for a, b in zip(marks, marks[1:])]
    return per, names, launched


def profile_frame(run, fc, history):
    """torch.profiler over one frame: CUDA time by kernel, top 40,
    printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run(fc, history)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(fc, history)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    _log(table)


if __name__ == "__main__":
    sys.exit(main())
