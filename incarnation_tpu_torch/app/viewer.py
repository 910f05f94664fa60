"""Interactive web viewer: orbit camera + live parameter editing (port of
incarnation_tpu/app/viewer.py).

The replacement for the reference's interactive Win32 loop + ImGui panels
(ref: source/demo-exe/main.cpp WndProc mouse orbit/pan/dolly, src/ui.cpp
light-editing and debug panels): a local HTTP server renders frames on the
card and streams them to a browser as PNG (the JAX viewer sends JPEG; the
port carries no JPEG codec); mouse and panel edits map onto the per-frame
constants (camera basis, exposure EV100, sun direction and intensity,
per-light colour and intensity), the view mode and TAA.

Controls (browser):  drag = orbit, shift-drag = pan, wheel = dolly,
click = pick primitive (highlighted, like the reference's visibility-buffer
picking), panel = exposure / time-of-day / sun intensity / viewmode / TAA /
per-light edits / model and environment switch.

Usage:
  python -m incarnation_tpu_torch.app.viewer --model <scene.gltf>
      [--port 8600] [--width 960 --height 544] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..config import Config
from ..core.view import View
from ..device import resolve_device
from ..scene import png

_IDLE_ACCUM_FRAMES = 48      # keep refining TAA this long after last input
_POLL_S = 0.05


@dataclasses.dataclass
class ViewerState:
    """Shared between the HTTP threads (producers of `inputs`) and the
    render loop (sole consumer; sole writer of the published frame)."""
    inputs: "queue.Queue[dict]"
    lock: threading.Lock
    frame_png: bytes = b""
    frame_seq: int = 0
    frame_cond: threading.Condition = None
    stats: dict = dataclasses.field(default_factory=dict)
    panel: dict = dataclasses.field(default_factory=dict)
    # scene/HDRI load progress (ref: scene.h:131-142 progress accumulators
    # feeding the ImGui load bar, ui.cpp:40-52): {"stage", "frac"} or {}
    progress: dict = dataclasses.field(default_factory=dict)
    # panel preview tiles (ref: ui.cpp:40-185 envmap + SH irradiance
    # preview renders): name -> PNG bytes; previews_seq bumps on rebuild
    previews: dict = dataclasses.field(default_factory=dict)
    previews_seq: int = 0
    quit: bool = False
    error: str = ""

    def publish(self, frame_png: bytes, stats: dict, panel: dict):
        with self.frame_cond:
            self.frame_png = frame_png
            self.frame_seq += 1
            self.stats = stats
            self.panel = panel
            self.frame_cond.notify_all()

    def set_progress(self, stage: str, frac: float):
        with self.lock:
            self.progress = ({} if stage == "done"
                             else {"stage": stage, "frac": round(frac, 3)})

    def set_previews(self, previews: dict):
        with self.lock:
            self.previews = previews
            self.previews_seq += 1


class Orbit:
    """Orbit camera: target + (distance, yaw, pitch) -> View."""

    def __init__(self, target, distance, yaw=0.0, pitch=0.25):
        self.target = np.asarray(target, np.float64).copy()
        self.distance = float(distance)
        self.yaw = float(yaw)
        self.pitch = float(pitch)

    def view(self, aspect, fov, near) -> View:
        cp, sp = np.cos(self.pitch), np.sin(self.pitch)
        cy, sy = np.cos(self.yaw), np.sin(self.yaw)
        eye = self.target + self.distance * np.array(
            [cp * sy, sp, -cp * cy])
        return View.from_lookat(eye.astype(np.float32),
                                self.target.astype(np.float32),
                                aspect=aspect, fov=fov, near=near)

    def apply(self, ev: dict):
        k = ev["cmd"]
        if k == "orbit":
            self.yaw += ev["dx"] * 0.005
            self.pitch = float(np.clip(self.pitch + ev["dy"] * 0.005,
                                       -1.5, 1.5))
        elif k == "pan":
            v = self.view(1.0, 0.8, 0.1)
            self.target -= (np.asarray(v.right) * ev["dx"]
                            - np.asarray(v.up) * ev["dy"]) \
                * 0.0015 * self.distance
        elif k == "dolly":
            self.distance = float(np.clip(
                self.distance * (1.15 ** ev["f"]),
                1e-3, 1e6))


# Additional content roots scanned by discover_content (tests and
# embedders append here before starting the render loop).
EXTRA_CONTENT_DIRS: list = []


def discover_content(extra_dirs=()):
    """Enumerate switchable models (*.gltf/*.glb) and HDRIs (*.hdr) — the
    analogue of the reference's content-browser combos, which enumerate
    the models/ and hdri/ folders (ref: ui.cpp:366-430 ModelsDir listing):
    the port's built atrium under the repository's content cache, then
    EXTRA_CONTENT_DIRS and extra_dirs. Returns (models, hdris) as lists of
    absolute path strings."""
    roots = [pathlib.Path(__file__).resolve().parents[2]
             / ".content_cache" / "torch" / "atrium",
             *map(pathlib.Path, EXTRA_CONTENT_DIRS),
             *map(pathlib.Path, extra_dirs)]
    models, hdris = [], []
    for root in roots:
        if not root.exists():
            continue
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() in (".gltf", ".glb"):
                models.append(str(p))
            elif p.suffix.lower() == ".hdr":
                hdris.append(str(p))
    return models, hdris


def _to_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (fast zlib level: a frame a refresh)."""
    return png.encode_png(np.ascontiguousarray(img[..., :3]), level=1)


def _probe_previews(cfg: Config, sun_dir, probe, device, hdri=None):
    """Panel preview tiles: the environment map and its SH-projected
    irradiance, as small tonemapped PNGs (ref: ui.cpp:40-185 renders the
    envmap and SH preview textures into the Debug panel)."""
    from ..core import mathutils as mu
    from ..kernels import ibl, sky
    from ..utils import imageio as io_mod

    w, h = 192, 96
    if hdri:
        ll = io_mod.load_hdr(hdri)[..., :3]
        sy = max(1, ll.shape[0] // h)
        sx = max(1, ll.shape[1] // w)
        env = torch.tensor(np.ascontiguousarray(ll[::sy, ::sx][:h, :w]),
                           device=device)
    else:
        env = sky.sky_latlong(torch.tensor(np.asarray(sun_dir, np.float32),
                                           device=device),
                              cfg.turbidity, w, h)
    us = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    vs = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    uv = torch.stack(torch.meshgrid(us, vs, indexing="xy"), -1)
    d = mu.latlong_uv_to_direction(uv)
    irr = ibl.sh_irradiance(d, probe.sh) / np.pi

    def tile(img):
        x = img[..., :3].cpu().numpy().astype(np.float32)
        x = x / (1.0 + x.mean() * 4.0 + 1e-9)     # auto-exposed Reinhard
        x = np.clip(x / max(x.max(), 1e-9), 0.0, 1.0) ** (1 / 2.2)
        return _to_png((x * 255).astype(np.uint8))

    return {"env": tile(env), "irr": tile(irr)}


def render_loop(host, cfg: Config, state: ViewerState, width: int,
                height: int, hdri=None, device=None):
    """Owns all device work. Consumes state.inputs; publishes PNG frames.
    Exceptions land in state.error and end the loop (the HTTP threads keep
    serving /state so clients see the failure). device: None = the card,
    "cpu" on request."""
    try:
        _render_loop(host, cfg, state, width, height, hdri,
                     resolve_device(device))
    except Exception as e:                    # noqa: BLE001
        import traceback
        state.error = f"{e}\n{traceback.format_exc()}"
        state.quit = True
        with state.frame_cond:
            state.frame_cond.notify_all()
        raise


def _render_loop(host, cfg, state, width, height, hdri, device):
    from ..core import mathutils as mu
    from ..kernels.raster import RasterParams
    from ..renderer import frame as frame_mod
    from ..scene import lights as lights_mod
    from ..scene.cache import load_scene_cached
    from .cli import build_probe

    scene = host.scene
    ext = float(np.linalg.norm(np.asarray(host.bounds_extent))) + 1e-6
    orbit = Orbit(host.bounds_center, 2.1 * ext)
    params = RasterParams(width=width, height=height)
    shadow_bounds = None
    if cfg.sun_shadow_mode == "map":
        shadow_bounds = (host.bounds_center, ext)

    def scene_sun(scene, host):
        sd = scene.sun_dir.cpu().numpy()
        si = 0.0
        if host.directional_light_index >= 0:
            si = float(scene.lights.intensity[host.directional_light_index])
        return sd, si

    def new_probe():
        """The probe for the current sun and HDRI, its previews published."""
        if not cfg.enable_sky_lighting:
            return None, None
        probe_, brdf_ = build_probe(cfg, sun_dir, device, hdri=hdri)
        state.set_previews(_probe_previews(cfg, sun_dir, probe_, device,
                                           hdri))
        return probe_, brdf_

    sun_dir, sun_int = scene_sun(scene, host)
    tod = None
    viewmode = cfg.viewmode
    exposure = cfg.exposure
    taa_on = cfg.enable_taa
    picked = -1
    jitters = mu.halton_jitter_table(16)
    models, hdris = discover_content()
    model_path = str(getattr(host, "source_path", "")) or None
    tex_dim = cfg.texture_max_dim
    probe, env_brdf = new_probe()

    history = None
    prev_vp = None
    frame_i = 0
    idle = 0
    last_tri = None
    fps = 0.0

    while not state.quit:
        # ---- drain inputs --------------------------------------------
        moved = False
        light_edit = False
        while True:
            try:
                ev = state.inputs.get_nowait()
            except queue.Empty:
                break
            c = ev.get("cmd")
            if c in ("orbit", "pan", "dolly"):
                orbit.apply(ev)
                moved = True
            elif c == "set":
                k, v = ev["key"], ev["value"]
                if k == "exposure":
                    exposure = float(v)
                elif k == "viewmode":
                    viewmode = int(v)
                elif k == "taa":
                    taa_on = bool(v)
                    moved = True
                elif k == "sun_intensity":
                    sun_int = float(v)
                elif k == "tod":
                    tod = float(v)
                    sun_dir = lights_mod.sun_direction_tod(
                        tod, cfg.tod_julian_date, cfg.tod_latitude)
                    probe, env_brdf = new_probe()
                    moved = True
            elif c == "light":
                li = int(ev["index"])
                lt = scene.lights
                if 0 <= li < int(lt.count):
                    inten = lt.intensity.clone()
                    color = lt.color.clone()
                    if "intensity" in ev:
                        inten[li] = float(ev["intensity"])
                    if "color" in ev:
                        color[li] = torch.tensor(
                            np.asarray(ev["color"], np.float32),
                            device=color.device)
                    scene = dataclasses.replace(
                        scene, lights=dataclasses.replace(
                            lt, intensity=inten, color=color))
                    light_edit = True
            elif c == "rescan":
                models, hdris = discover_content()
                light_edit = True       # republish the panel with the list
            elif c == "load_model":
                # Runtime model switching (ref: ui.cpp:366-430 model combo
                # triggers an async scene reload with a progress bar): the
                # load runs here in the render thread; progress callbacks
                # publish to /state so the browser shows the bar.
                path = str(ev.get("path", ""))
                if path in models:
                    try:
                        host = load_scene_cached(
                            path, texture_max_dim=tex_dim,
                            progress=state.set_progress, device=device)
                        scene = host.scene
                        ext = float(np.linalg.norm(
                            np.asarray(host.bounds_extent))) + 1e-6
                        orbit = Orbit(host.bounds_center, 2.1 * ext)
                        if cfg.sun_shadow_mode == "map":
                            shadow_bounds = (host.bounds_center, ext)
                        sun_dir, sun_int = scene_sun(scene, host)
                        tod = None
                        picked = -1
                        model_path = path
                        probe, env_brdf = new_probe()
                        moved = True
                    except Exception as e:        # noqa: BLE001
                        state.error = f"model load failed: {e}"
                    finally:
                        state.set_progress("done", 1.0)
            elif c == "load_hdri":
                # Runtime HDRI switching (ref: ui.cpp:430-478 hdri combo
                # re-runs FTextureCache::CacheHDRI); empty path = the
                # procedural Preetham sky.
                path = str(ev.get("path", ""))
                if path in hdris or path == "":
                    try:
                        state.set_progress("hdri", 0.2)
                        hdri = path or None
                        probe, env_brdf = new_probe()
                        moved = True
                    except Exception as e:        # noqa: BLE001
                        state.error = f"hdri load failed: {e}"
                    finally:
                        state.set_progress("done", 1.0)
            elif c == "pick" and last_tri is not None:
                x = int(np.clip(ev["x"], 0, width - 1))
                y = int(np.clip(ev["y"], 0, height - 1))
                prim, _, _ = frame_mod.pick(scene, last_tri, x, y)
                picked = int(prim)
            elif c == "quit":
                state.quit = True

        if moved or light_edit:
            idle = 0
            if moved:
                history = None           # camera cut: restart accumulation
                prev_vp = None
        elif idle > _IDLE_ACCUM_FRAMES:
            time.sleep(_POLL_S)          # converged; don't burn the card
            continue
        idle += 1

        # ---- render one frame ----------------------------------------
        run_cfg = cfg.replace(viewmode=viewmode, enable_taa=taa_on)
        view = orbit.view(width / height, cfg.fov, cfg.camera_near_plane)
        j = None
        if taa_on:
            j = jitters[frame_i % 16] * 2.0 / np.array([width, height])
            if history is None:
                history = torch.zeros((height, width, 3), device=device)
        sun_ci = [1.0, 1.0, 1.0, sun_int] if sun_int > 0 else None
        fc = frame_mod.FrameConstants.make(
            view, run_cfg.replace(exposure=exposure), sun_dir=sun_dir,
            sun_color_intensity=sun_ci, jitter=j, prev_view_proj=prev_vp,
            history_valid=(history is not None and prev_vp is not None),
            frame_index=frame_i, shadow_bounds=shadow_bounds, device=device)
        t0 = time.time()
        out = frame_mod.render_frame(scene, fc, config=run_cfg,
                                     params=params, probe=probe,
                                     env_brdf=env_brdf, history=history)
        color = out["color"]
        if picked >= 0:
            color = frame_mod.highlight(color, out["tri"], scene, picked)
        rgb = color.cpu().numpy()
        dt = time.time() - t0
        fps = (0.9 * fps + 0.1 / max(dt, 1e-6)) if fps else 1.0 / max(
            dt, 1e-6)
        last_tri = out["tri"]
        if taa_on:
            history = out["accumulation"]
            prev_vp = fc.view_proj.cpu().numpy()
        frame_i += 1

        lt = scene.lights
        inten = lt.intensity.cpu().numpy()
        colors = lt.color.cpu().numpy()
        panel = dict(
            exposure=exposure, viewmode=int(viewmode), taa=bool(taa_on),
            sun_intensity=sun_int, tod=tod, picked=picked, fps=round(fps, 2),
            width=width, height=height,
            models=models, hdris=hdris,
            model=model_path, hdri=hdri or "",
            lights=[dict(index=i, type=int(lt.type[i]),
                         intensity=float(inten[i]),
                         color=[round(float(x), 4) for x in colors[i]])
                    for i in range(int(lt.count))][:64])
        state.publish(_to_png(rgb),
                      {k: int(v) for k, v in out["stats"].items()}, panel)


_PAGE = """<!doctype html>
<html><head><title>incarnation_tpu viewer</title><style>
body{margin:0;background:#15171a;color:#ddd;font:13px system-ui;display:flex}
#img{cursor:grab;image-rendering:auto;max-width:calc(100vw - 290px)}
#panel{width:280px;padding:10px;background:#1d2024;overflow-y:auto;
height:100vh;box-sizing:border-box}
label{display:block;margin:8px 0 2px;color:#9ab}
input[type=range]{width:100%}select,button{width:100%;margin:2px 0}
.light{border-top:1px solid #333;padding:4px 0}
#stats{white-space:pre-wrap;color:#7a8;font:11px monospace}
</style></head><body>
<img id="img"><div id="panel">
<b>incarnation_tpu</b><div id="fps"></div>
<label>exposure (EV100) <span id="ev"></span></label>
<input type=range id=exposure min=5 max=20 step=0.1>
<label>time of day (h)</label>
<input type=range id=tod min=5 max=19 step=0.25 value=12>
<label>sun intensity</label>
<input type=range id=sun min=0 max=200 step=1>
<label>view mode</label><select id=viewmode>
<option value=0>Lit</option><option value=2>Lighting only</option>
<option value=3>Roughness</option><option value=4>Metallic</option>
<option value=5>Base color</option><option value=6>Emissive</option>
<option value=7>Reflections</option><option value=8>Object ids</option>
<option value=9>Triangle ids</option><option value=10>Normal map</option>
<option value=11>Ambient occlusion</option></select>
<label><input type=checkbox id=taa checked> TAA</label>
<label>model</label><select id=model></select>
<label>environment</label><select id=hdri></select>
<div id=progwrap style="display:none;background:#333;height:8px;
border-radius:4px;margin:6px 0"><div id=progbar style="background:#4a8;
height:8px;border-radius:4px;width:0%"></div></div>
<div id=progtext style="color:#7a8;font:11px monospace"></div>
<label>envmap / SH irradiance</label>
<div><img id=prevenv width=128 style="margin-right:4px">
<img id=previrr width=128></div>
<div id=lights></div><div id=stats></div></div>
<script>
const img=document.getElementById('img');let seq=0;
async function pump(){for(;;){try{
const r=await fetch('/frame.png?seq='+seq);seq=+r.headers.get('x-seq');
const b=await r.blob();img.src=URL.createObjectURL(b);}catch(e){
await new Promise(s=>setTimeout(s,300));}}}
function send(o){fetch('/input',{method:'POST',body:JSON.stringify(o)});}
let drag=null;img.onmousedown=e=>{drag=[e.clientX,e.clientY,e.shiftKey];
e.preventDefault()};
window.onmouseup=e=>{if(drag&&Math.abs(e.clientX-drag[0])<3&&
Math.abs(e.clientY-drag[1])<3){const r=img.getBoundingClientRect();
send({cmd:'pick',x:Math.round((e.clientX-r.left)*img.naturalWidth/r.width),
y:Math.round((e.clientY-r.top)*img.naturalHeight/r.height)})}drag=null};
window.onmousemove=e=>{if(!drag)return;
send({cmd:drag[2]?'pan':'orbit',dx:e.clientX-drag[0],dy:e.clientY-drag[1]});
drag=[e.clientX,e.clientY,drag[2]]};
img.onwheel=e=>{e.preventDefault();send({cmd:'dolly',f:Math.sign(e.deltaY)})};
exposure.oninput=()=>{ev.textContent=exposure.value;
send({cmd:'set',key:'exposure',value:+exposure.value})};
tod.onchange=()=>send({cmd:'set',key:'tod',value:+tod.value});
sun.oninput=()=>send({cmd:'set',key:'sun_intensity',value:+sun.value});
viewmode.onchange=()=>send({cmd:'set',key:'viewmode',value:+viewmode.value});
taa.onchange=()=>send({cmd:'set',key:'taa',value:taa.checked});
model.onchange=()=>send({cmd:'load_model',path:model.value});
hdri.onchange=()=>send({cmd:'load_hdri',path:hdri.value});
let pseq=-1;
function fillSel(sel,items,cur,blank){if(sel.dataset.n==items.length)
{sel.value=cur;return}sel.innerHTML='';if(blank!==undefined){
const o=document.createElement('option');o.value='';o.textContent=blank;
sel.append(o)}for(const m of items){const o=document.createElement(
'option');o.value=m;o.textContent=m.split('/').slice(-1)[0];sel.append(o)}
sel.dataset.n=items.length;sel.value=cur}
async function poll(){for(;;){try{
const s=await(await fetch('/state')).json();
fps.textContent=s.panel.fps+' fps  frame '+s.seq;
document.getElementById('stats').textContent=
JSON.stringify(s.stats,null,1);
fillSel(model,s.panel.models||[],s.panel.model||'');
fillSel(hdri,s.panel.hdris||[],s.panel.hdri||'','(dynamic sky)');
const pw=document.getElementById('progwrap');
if(s.progress&&s.progress.stage){pw.style.display='block';
progbar.style.width=(100*s.progress.frac)+'%';
progtext.textContent='loading '+s.progress.stage+' '+
Math.round(100*s.progress.frac)+'%'}else{pw.style.display='none';
progtext.textContent=''}
if(s.previews_seq!==pseq){pseq=s.previews_seq;
prevenv.src='/preview/env.png?s='+pseq;
previrr.src='/preview/irr.png?s='+pseq;}
const L=document.getElementById('lights');
if(L.childElementCount!==s.panel.lights.length){L.innerHTML='';
for(const l of s.panel.lights){const d=document.createElement('div');
d.className='light';d.innerHTML='light '+l.index+' <input type=range '+
'min=0 max='+Math.max(100,l.intensity*2)+' step=0.5 value='+l.intensity+
' data-i='+l.index+'>';
d.querySelector('input').oninput=e=>send({cmd:'light',
index:+e.target.dataset.i,intensity:+e.target.value});L.append(d)}}
}catch(e){}await new Promise(s=>setTimeout(s,500))}}
pump();poll();
</script></body></html>"""

def make_server(state: ViewerState, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):        # quiet
            pass

        def _send(self, code, body, ctype="application/json", extra=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame.png":
                want = 0
                if "seq=" in self.path:
                    try:
                        want = int(self.path.split("seq=")[1].split("&")[0])
                    except ValueError:
                        pass
                with state.frame_cond:
                    state.frame_cond.wait_for(
                        lambda: state.frame_seq > want or state.quit,
                        timeout=30.0)
                    frame, seq = state.frame_png, state.frame_seq
                self._send(200, frame, "image/png",
                           extra=[("X-Seq", str(seq)),
                                  ("Cache-Control", "no-store")])
            elif path == "/state":
                with state.lock:
                    body = json.dumps(dict(seq=state.frame_seq,
                                           stats=state.stats,
                                           panel=state.panel,
                                           progress=state.progress,
                                           previews_seq=state.previews_seq,
                                           error=state.error)).encode()
                self._send(200, body)
            elif path.startswith("/preview/"):
                name = path[len("/preview/"):].split(".")[0]
                with state.lock:
                    tile = state.previews.get(name, b"")
                self._send(200 if tile else 404, tile, "image/png",
                           extra=[("Cache-Control", "no-store")])
            else:
                self._send(404, b"{}")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b"{}"
            if self.path == "/input":
                try:
                    state.inputs.put(json.loads(body))
                except json.JSONDecodeError:
                    self._send(400, b"{}")
                    return
                self._send(200, b"{}")
            elif self.path == "/quit":
                state.quit = True
                state.inputs.put({"cmd": "quit"})
                with state.frame_cond:
                    state.frame_cond.notify_all()
                self._send(200, b"{}")
            else:
                self._send(404, b"{}")

    return ThreadingHTTPServer(("127.0.0.1", port), Handler)


def serve(host, cfg: Config, width: int, height: int, port: int,
          hdri=None, block: bool = True, device=None):
    """Start the HTTP server (+ the render loop when block=True). port 0
    takes a free port (server.server_address[1])."""
    state = ViewerState(inputs=queue.Queue(), lock=threading.Lock())
    state.frame_cond = threading.Condition(state.lock)
    server = make_server(state, port)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    print(f"[viewer] http://127.0.0.1:{server.server_address[1]}/ "
          f"({width}x{height})", flush=True)
    if block:
        try:
            render_loop(host, cfg, state, width, height, hdri=hdri,
                        device=device)
        finally:
            server.shutdown()
    return server, state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True)
    ap.add_argument("--port", type=int, default=8600)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=544)
    ap.add_argument("--texture-max-dim", type=int, default=2048)
    ap.add_argument("--hdri", default=None)
    ap.add_argument("--shadows", default="map", choices=["off", "map"])
    ap.add_argument("--cpu", action="store_true",
                    help="render on the host CPU (the kernels' twins)")
    args = ap.parse_args(argv)

    from ..scene.cache import load_scene_cached
    device = resolve_device("cpu" if args.cpu else None)
    host = load_scene_cached(args.model,
                             texture_max_dim=args.texture_max_dim,
                             device=device)
    print(f"[scene] {host.name}: {host.scene.meta.num_triangles} tris")
    cfg = Config(sun_shadow_mode=args.shadows
                 if args.shadows != "off" else "auto")
    serve(host, cfg, args.width, args.height, args.port, hdri=args.hdri,
          device=device)


if __name__ == "__main__":
    main()
