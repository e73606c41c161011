"""Interactive web viewer for trained scenes.

Port of `wast3d_tpu/viewer/web.py`: a stdlib `http.server` that serves an
orbit-camera page (drag = orbit, wheel = zoom) to any browser and renders
each `/frame?yaw&pitch&radius&res` request through `api.render` on the
card (K1f with the bf16 tier's settings, `cli.view`'s default; K1 with
`--no-fast`). Frames are PNGs from the port's own encoder
(`utils/png.encode_png`), not PIL. Renders are serialised with a lock (one
card; concurrent tabs queue). `viewer/network_gui.py` is the SIBR
wire-protocol server for live training views; this serves a browser with
no client install.

Usage:
    python -m wast3d_tpu_torch.cli.view -m <model_path> [--port 8090]
or programmatically: serve_scene(scene, port=8090).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from wast3d_tpu_torch.device import DeviceLike
from wast3d_tpu_torch.utils.png import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>wast3d_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ccc;font:13px monospace;overflow:hidden}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:6px 8px;border-radius:4px}
img{width:100vw;height:100vh;object-fit:contain;display:block}
</style></head><body>
<img id="v" draggable="false"><div id="hud"></div>
<script>
let yaw=0.6,pitch=0.3,radius=4.0,res=512,busy=false,dirty=true;
const img=document.getElementById('v'),hud=document.getElementById('hud');
function tick(){
  if(dirty&&!busy){busy=true;dirty=false;
    const u=`/frame?yaw=${yaw.toFixed(4)}&pitch=${pitch.toFixed(4)}&radius=${radius.toFixed(3)}&res=${res}`;
    const t0=performance.now();
    fetch(u).then(r=>r.blob()).then(b=>{
      img.src=URL.createObjectURL(b);
      hud.textContent=`yaw ${yaw.toFixed(2)} pitch ${pitch.toFixed(2)} r ${radius.toFixed(2)} | ${(performance.now()-t0).toFixed(0)} ms`;
      busy=false;});}
  requestAnimationFrame(tick);}
let drag=null;
img.addEventListener('pointerdown',e=>{drag=[e.clientX,e.clientY]});
window.addEventListener('pointerup',()=>{drag=null});
window.addEventListener('pointermove',e=>{if(!drag)return;
  yaw+=(e.clientX-drag[0])*0.008;pitch+=(e.clientY-drag[1])*0.008;
  pitch=Math.max(-1.5,Math.min(1.5,pitch));drag=[e.clientX,e.clientY];dirty=true;});
window.addEventListener('wheel',e=>{radius*=Math.exp(e.deltaY*0.001);dirty=true;});
tick();
</script></body></html>"""


def orbit_camera(yaw: float, pitch: float, radius: float, res: int,
                 target=(0.0, 0.0, 0.0), fov: float = 0.9, device: DeviceLike = None):
    """Orbit-parameterised viewpoint around `target` (y-down world, the
    package's look_at convention), on `device` (None means CUDA)."""
    from wast3d_tpu_torch.core.camera import look_at_camera

    t = np.asarray(target, np.float64)
    eye = t + radius * np.array([
        np.cos(pitch) * np.sin(yaw),
        np.sin(pitch),
        -np.cos(pitch) * np.cos(yaw),
    ])
    return look_at_camera(eye=eye.tolist(), target=t.tolist(), up=[0, -1, 0],
                          fovx=fov, fovy=fov, width=res, height=res, device=device)


def render_orbit_frame(scene, yaw, pitch, radius, res, settings=None,
                       bg=(0.0, 0.0, 0.0), target=(0.0, 0.0, 0.0),
                       device: DeviceLike = None) -> np.ndarray:
    """One viewer frame as a uint8 RGB array, rendered on `device`."""
    from wast3d_tpu_torch.ops.rasterizer import api

    settings = settings or api.RasterizeSettings(renderer="pallas")
    cam = orbit_camera(yaw, pitch, radius, res, target=target, device=device)
    with torch.no_grad():
        out = api.render(cam, scene, torch.as_tensor(bg, dtype=torch.float32),
                         settings=settings, device=device)
        img = torch.clamp(out["render"], 0, 1).cpu().numpy()
    return (img * 255).astype(np.uint8)


def make_handler(scene, settings=None, target=(0.0, 0.0, 0.0), device: DeviceLike = None):
    """Request handler bound to a scene. Rendering is serialised with a
    lock (one card; concurrent browser tabs queue)."""
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, ctype, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
                return
            if u.path == "/frame":
                q = parse_qs(u.query)

                def f(name, d):
                    return float(q.get(name, [d])[0])

                res = max(64, min(1024, int(f("res", 512))))
                with lock:
                    rgb = render_orbit_frame(
                        scene, f("yaw", 0.0), f("pitch", 0.0), f("radius", 4.0), res,
                        settings=settings, target=target, device=device)
                self._send(200, "image/png", encode_png(rgb))
                return
            if u.path == "/info":
                n = int(scene.num_active)
                self._send(200, "application/json",
                           json.dumps({"num_gaussians": n}).encode())
                return
            self._send(404, "text/plain", b"not found")

    return Handler


def serve_scene(scene, port: int = 8090, settings=None, target=(0.0, 0.0, 0.0),
                background: bool = False, device: DeviceLike = None):
    """Serve the interactive viewer. background=True returns the server
    (call .shutdown()); otherwise blocks."""
    srv = ThreadingHTTPServer(("0.0.0.0", port), make_handler(scene, settings, target, device))
    if background:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv
    print(f"viewer: http://localhost:{port}/")
    srv.serve_forever()
