"""Interactive mesh viewer over HTTP (port of unitex_tpu/render/viewer.py).

A dependency-free stdlib ``http.server`` app: the browser page drags to
orbit (azimuth / elevation / distance), picks the render mode (rgb /
normal / ccm / alpha) and fetches frames that the server renders on
demand through the port's ``render_views`` on the viewer's device, one
render at a time.  The same page, routes and PNG bytes as the JAX
package's viewer.

    python -m unitex_torch.scripts.view_mesh mesh.glb --port 7860 [--cpu]
"""

from __future__ import annotations

import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..camera.generator import generate_intrinsics, lookat_to_matrix
from ..geometry.io.mesh_io import load_mesh
from ..utils.image_io import to_uint8
from ..utils.precision import resolve_device
from .renderer import Mesh, render_views

MODES = ("rgb", "normal", "ccm", "alpha")

_PAGE = """<!doctype html>
<html><head><title>unitex_tpu viewer</title><style>
body { font-family: sans-serif; margin: 1em; background: #181818; color: #ddd; }
#frame { border: 1px solid #444; cursor: grab; touch-action: none; }
select, input { margin-right: 1em; }
</style></head><body>
<h3>unitex_tpu mesh viewer</h3>
<div>
 mode <select id="mode">
  <option>rgb</option><option>normal</option><option>ccm</option>
  <option>alpha</option></select>
 size <select id="size"><option>256</option><option selected>512</option>
  <option>1024</option></select>
 distance <input id="dist" type="range" min="1.2" max="6" step="0.1"
  value="2.8">
 <span id="status"></span>
</div>
<img id="frame" width="512" height="512"/>
<script>
let az = 0, el = 20, drag = null, inflight = false, dirty = true;
const img = document.getElementById('frame');
function refresh() {
  if (inflight) { dirty = true; return; }
  inflight = true; dirty = false;
  const q = `az=${az.toFixed(1)}&el=${el.toFixed(1)}` +
    `&dist=${document.getElementById('dist').value}` +
    `&mode=${document.getElementById('mode').value}` +
    `&size=${document.getElementById('size').value}`;
  const t0 = performance.now();
  fetch('/render?' + q).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    document.getElementById('status').textContent =
      `az ${az.toFixed(0)} el ${el.toFixed(0)} ` +
      `${(performance.now() - t0).toFixed(0)} ms`;
    inflight = false;
    if (dirty) refresh();
  });
}
img.addEventListener('pointerdown', e => { drag = [e.clientX, e.clientY]; });
window.addEventListener('pointerup', () => { drag = null; });
window.addEventListener('pointermove', e => {
  if (!drag) return;
  az -= (e.clientX - drag[0]) * 0.5;
  el = Math.max(-85, Math.min(85, el + (e.clientY - drag[1]) * 0.5));
  drag = [e.clientX, e.clientY];
  refresh();
});
for (const id of ['mode', 'size', 'dist'])
  document.getElementById(id).addEventListener('input', refresh);
refresh();
</script></body></html>"""


class MeshViewer:
    """Owns the loaded mesh (on ``device``) and renders single frames on
    demand."""

    def __init__(self, mesh_path: str, fov_deg: float = 49.1,
                 background: float = 1.0, device="cuda"):
        self.device = resolve_device(device)
        hm = load_mesh(mesh_path)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(self.device)

        kw = {}
        if hm.uv is not None and hm.faces_uv is not None:
            kw = {"uv": put(hm.uv, np.float32),
                  "faces_uv": put(hm.faces_uv, np.int64)}
        self.mesh = Mesh(put(hm.vertices, np.float32), put(hm.faces, np.int64), **kw)
        self.texture = None
        if hm.texture is not None and hm.uv is not None:
            self.texture = put(hm.texture[..., :3], np.float32) / 255.0
        self.fov_deg = fov_deg
        self.background = background
        self._lock = threading.Lock()

    @torch.no_grad()
    def render_frame(self, azimuth_deg: float, elevation_deg: float,
                     distance: float, mode: str = "rgb",
                     size: int = 512) -> np.ndarray:
        """-> [size, size, 3] uint8."""
        az = math.radians(azimuth_deg)
        el = math.radians(elevation_deg)
        eye = torch.tensor([[distance * math.cos(el) * math.cos(az),
                             distance * math.cos(el) * math.sin(az),
                             distance * math.sin(el)]], dtype=torch.float32,
                           device=self.device)
        c2w = lookat_to_matrix(eye)
        intr = generate_intrinsics(self.fov_deg, self.fov_deg, fov=True,
                                   degree=True, device=self.device)
        want_tex = mode == "rgb" and self.texture is not None
        with self._lock:  # one device render at a time
            out = render_views(
                self.mesh, c2w, intr, (size, size), perspective=True,
                map_attr=self.texture if want_tex else None,
                render_uv=want_tex, render_map_attr=want_tex,
                render_world_normal=mode == "normal" or
                (mode == "rgb" and not want_tex),
                render_world_position=mode == "ccm",
            )
            if mode == "alpha":
                rgb = out.alpha[..., :1].repeat(1, 1, 1, 3)
            elif mode == "ccm":
                rgb = out.world_position * 0.5 + 0.5
            elif want_tex:
                rgb = out.map_attr
            else:
                rgb = out.world_normal * 0.5 + 0.5
            if mode != "alpha":
                rgb = rgb * out.alpha + self.background * (1.0 - out.alpha)
            return to_uint8(rgb[0].cpu().numpy())


def _encode_png(arr: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def make_handler(viewer: MeshViewer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html")
                return
            if url.path == "/render":
                q = parse_qs(url.query)

                def f(name, default):
                    return float(q.get(name, [default])[0])

                mode = q.get("mode", ["rgb"])[0]
                if mode not in MODES:
                    self._send(400, b"bad mode", "text/plain")
                    return
                size = max(64, min(int(f("size", 512)), 2048))
                try:
                    frame = viewer.render_frame(
                        f("az", 0.0), f("el", 20.0), f("dist", 2.8), mode, size)
                except Exception as e:  # noqa: BLE001 -- shown on the page
                    self._send(500, str(e).encode(), "text/plain")
                    return
                self._send(200, _encode_png(frame), "image/png")
                return
            if url.path == "/info":
                body = json.dumps({
                    "n_vertices": int(viewer.mesh.vertices.shape[0]),
                    "n_faces": int(viewer.mesh.faces.shape[0]),
                    "textured": viewer.texture is not None,
                }).encode()
                self._send(200, body, "application/json")
                return
            self._send(404, b"not found", "text/plain")

    return Handler


def serve(mesh_path: str, port: int = 7860, host: str = "127.0.0.1",
          poll: Optional[float] = None, device="cuda") -> ThreadingHTTPServer:
    """Start the viewer server on ``device``: blocking unless ``poll`` is
    set, in which case the caller drives the server (``handle_request``,
    or ``serve_forever`` on a thread) and closes it."""
    viewer = MeshViewer(mesh_path, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(viewer))
    if poll is None:
        print(f"viewer at http://{host}:{port}/  (ctrl-c to stop)", flush=True)
        try:
            httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            httpd.server_close()
    return httpd
