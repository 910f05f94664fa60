"""The masked depth-peel ladder of render_frame, port against JAX, peel by
peel.

Each package's render_frame runs with its raster and alpha-test functions
wrapped so that every peel's winners and alpha test are recorded; the frame
stops after the last peel. A pixel "carries on" past a peel when that
peel's winner failed its alpha test and no earlier peel found a winner that
passed; carrying on past the last peel is peel_overflow. The port's K1
tests each masked fragment against its own material's amask row, JAX's
against the tile's primary material's row only (fragments of other
materials keep), and both rejections are conservative. So per peel, the
pixels the port carries on are a subset of JAX's, and the port needs no
more peels than JAX, but for the odd pixel where the two rasterizers pick
different winners among fragments of equal depth (the port's tie-break is
deterministic, JAX's follows pair order).

As a test: make_rich_scene at 256x128. As a script, the procedural atrium
at one frame of chip_smoke.py's orbit (its view and Halton jitter), at a
resolution below the card's 1920x1088:

    python tests/test_torch_peel_ladder.py W H ORBIT_RAD FRAME [FRAME ...]

prints, per peel, the pixels each package's ladder hits and carries on.
"""

import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    import jax
    jax.config.update("jax_platforms", "cpu")

from incarnation_tpu.config import Config as JConfig
from incarnation_tpu.core import mathutils as jmu
from incarnation_tpu.core.view import View as JView
from incarnation_tpu.kernels import raster as jraster
from incarnation_tpu.kernels import resolve as jresolve
from incarnation_tpu.renderer import frame as jframe
from incarnation_tpu_torch.config import Config as TConfig
from incarnation_tpu_torch.core.view import View as TView
from incarnation_tpu_torch.kernels import raster as traster
from incarnation_tpu_torch.kernels import resolve as tresolve
from incarnation_tpu_torch.renderer import frame as tframe
from incarnation_tpu_torch.scene import loader as tloader

torch.set_num_threads(1)

# the stochastic estimators off in the JAX Config too; no sun shadow map
CFG = dict(stochastic_mip=False, stochastic_bilinear=False,
           checkerboard_gathers=False, peel_chunk_capacity=0,
           decal_chunk_capacity=0, sun_shadow_mode="off")


class _LadderDone(Exception):
    pass


def ladder(raster_mod, resolve_mod, render, peels):
    """(hit count, carry-on mask) per peel of one render() call, whose
    frame is stopped after its last peel's alpha test."""
    rec = []
    rasterize, alpha_test = raster_mod.rasterize_tiles, \
        resolve_mod.masked_alpha

    def rasterize_rec(*a, **kw):
        out = rasterize(*a, **kw)
        if kw.get("name") == "raster_peel":
            rec.append([np.asarray(out[0])])
        return out

    def alpha_rec(*a, **kw):
        out = alpha_test(*a, **kw)
        rec[-1] += [np.asarray(out[0]), np.asarray(out[1])]
        if len(rec) == peels:
            raise _LadderDone
        return out

    raster_mod.rasterize_tiles = rasterize_rec
    resolve_mod.masked_alpha = alpha_rec
    try:
        render()
    except _LadderDone:
        pass
    finally:
        raster_mod.rasterize_tiles = rasterize
        resolve_mod.masked_alpha = alpha_test
    assert len(rec) == peels
    found = None
    hits, carry = [], []
    for tri, alpha, thresh in rec:
        hit = tri >= 0
        passed = hit & (alpha >= thresh)
        found = passed if found is None else found | passed
        hits.append(int(hit.sum()))
        carry.append(hit & ~passed & ~found)
    return hits, carry


def both_ladders(jscene, tscene, view, width, height, jitter, peels,
                 frame_index=0, raster=None):
    """The ladders of both packages' render_frame at one view (a port
    View, copied to JAX's), the same scene in both."""
    jview = JView(position=view.position, right=view.right, up=view.up,
                  look=view.look, aspect=width / height)
    kw = dict(sun_dir=np.asarray(jscene.sun_dir),
              sun_color_intensity=[1.0, 1.0, 1.0, 100.0], jitter=jitter,
              prev_view_proj=None, history_valid=False,
              frame_index=frame_index)
    jcfg = JConfig(masked_depth_peels=peels, **CFG)
    tcfg = TConfig(masked_depth_peels=peels, **CFG)
    rp = dict(width=width, height=height, **(raster or {}))
    jfc = jframe.FrameConstants.make(jview, jcfg, **kw)
    tfc = tframe.FrameConstants.make(view, tcfg, device="cpu", **kw)
    j = ladder(jraster, jresolve, lambda: jframe.render_frame(
        jscene, jfc, config=jcfg, params=jraster.RasterParams(**rp)), peels)
    t = ladder(traster, tresolve, lambda: tframe.render_frame(
        tscene, tfc, config=tcfg, params=traster.RasterParams(**rp)), peels)
    return j, t


def test_port_ladder_carries_on_no_more_than_jax():
    """make_rich_scene (a masked quad whose checkerboard alpha fails on
    half its pixels): per peel the same pixels hit, and the port's
    carry-on pixels are JAX's, to the pixel."""
    from incarnation_tpu.scene.testing import make_rich_scene
    w, h = 256, 128
    jscene = make_rich_scene()
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(jscene), "cpu")
    view = TView.from_lookat([0.0, 1.0, 3.5], [0.0, -1.5, 6.0], aspect=w / h)
    jitter = np.asarray(jmu.halton_jitter_table(16))[1] * 2.0 / [w, h]
    (jh, jc), (th, tc) = both_ladders(
        jscene, tscene, view, w, h, jitter, peels=3,
        raster=dict(pair_capacity=4096, bin_max_span=8, big_tri_capacity=64))
    assert th == jh and th[0] > 0
    assert tc[0].sum() > 0
    # one masked material: the two rejections are the same test here
    for j, t in zip(jc, tc):
        assert (t == j).all()


def main(argv):
    """The atrium at frames of chip_smoke.py's orbit, both packages."""
    import chip_smoke
    from incarnation_tpu.scene import loader as jloader
    from incarnation_tpu_torch.scene import stress
    width, height, rate = int(argv[0]), int(argv[1]), float(argv[2])
    frames = [int(a) for a in argv[3:]]
    torch.set_num_threads(4)
    host = jloader.load_scene(stress.build_atrium(chip_smoke.ATRIUM_DIR),
                              texture_max_dim=2048)
    tscene = tloader.scene_from_arrays(*tloader.scene_arrays(host.scene),
                                       "cpu")
    c = host.cameras[0]
    view0 = TView(**{k: np.asarray(c[k], np.float32)
                     for k in ("position", "right", "up", "look")},
                  aspect=width / height)
    jitters = np.asarray(jmu.halton_jitter_table(16))
    for i in frames:
        (jh, jc), (th, tc) = both_ladders(
            host.scene, tscene, chip_smoke.orbit(view0, rate * i), width,
            height, jitters[i % 16] * 2.0 / np.array([width, height]),
            chip_smoke.PEELS, frame_index=i,
            raster=dict(pair_capacity=1 << 18, bin_max_span=8))
        print(f"atrium {width}x{height}, frame {i} of a {rate} rad orbit "
              f"(yaw {rate * i:.4f} rad), peels 1..{chip_smoke.PEELS}:")
        print("  hit       jax ", jh)
        print("  hit       port", th)
        print("  carry on  jax ", [int(x.sum()) for x in jc])
        print("  carry on  port", [int(x.sum()) for x in tc])
        print("  port carries on where jax does not",
              [int((t & ~j).sum()) for j, t in zip(jc, tc)], flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
