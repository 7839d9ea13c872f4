"""Minimal HTTP status service: the serving counterpart of the
reference's ROS query/response channel (port of
orb_slam_cuda_tpu/io/serve.py: the same routes and JSON keys; the map
renders through the port's numpy viewer).

The reference answers map-change queries over ROS topics
(Examples/ROS/ROS_WS/src/mono/src/ros_mono.cc:148-159 AnswerQuery ->
System::MapChanged, polled by ros_orb_controller.cc:46-75 at 0.5 Hz).
Here the same two queries are served over plain HTTP so any client can
poll a running engine without a ROS stack:

  GET /status       -> JSON health snapshot (tracking state, frames,
                       tracked ratio, keyframes, reloc/loop counters)
  GET /map_changed  -> {"map_changed": bool}, edge-triggered per the
                       reference's MapChanged semantics (true once per
                       map mutation epoch, src/System.cc:123-125)
  GET /map.png      -> top-view map render (points, keyframes,
                       covisibility edges, current camera) — the live
                       viewer frame (reference MapDrawer,
                       src/MapDrawer.cc:44-233)
  GET /             -> auto-refreshing HTML live view (map + status) —
                       the server-side counterpart of the Pangolin
                       window (reference src/Viewer.cc:54-170)

The handler reads plain host-side Python attributes only (ints, enums
— GIL-atomic), never the device map or the mapping queue, so it is
safe to run on its own thread next to the tracking loop; the
reference's AnswerQuery similarly reads mutex-guarded scalars on the
ROS spinner thread.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def snapshot(system) -> dict:
    """Lock-free health snapshot (System.get_status without draining the
    mapping queue, which must only run on the tracking thread)."""
    return {
        "state": system.tracking_state.name,
        "frames": system.stats.n_frames,
        "tracked_ratio": round(system.tracked_ratio(), 4),
        "keyframes": system.stats.n_keyframes,
        "live_keyframes": len(system.kf_order),
        "relocalizations": system.stats.n_reloc,
        "loops_closed": (
            system.loop_closer.n_loops_closed if system.loop_closer else 0
        ),
        "localization_only": system.localization_only,
    }


_LIVE_HTML = b"""<!doctype html>
<html><head><title>orb_slam_cuda_tpu_torch live view</title><style>
body{font-family:monospace;background:#111;color:#ddd;margin:1em}
img{max-width:92vw;border:1px solid #444}
pre{color:#8c8}
</style></head><body>
<h3>orb_slam_cuda_tpu_torch &mdash; live map</h3>
<pre id="st">loading...</pre>
<img id="map" src="/map.png">
<script>
async function tick(){
  try{
    const s = await (await fetch('/status')).json();
    document.getElementById('st').textContent = JSON.stringify(s);
    document.getElementById('map').src = '/map.png?' + Date.now();
  }catch(e){}
}
setInterval(tick, 2000); tick();
</script></body></html>
"""


class StatusServer:
    """Background HTTP server bound to a System.

    Usage:
        srv = StatusServer(slam, port=0)   # 0 = ephemeral
        srv.start()
        ... track frames ...
        srv.stop()
    """

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0):
        self.system = system
        self._epoch_lock = threading.Lock()
        self._last_epoch = -1
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, data: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                self.path = self.path.split("?")[0]
                if self.path == "/status":
                    body = snapshot(outer.system)
                elif self.path == "/map_changed":
                    body = {"map_changed": outer._map_changed()}
                elif self.path == "/map.png":
                    self._send(outer._render_map(), "image/png")
                    return
                elif self.path in ("/", "/view"):
                    self._send(_LIVE_HTML, "text/html")
                    return
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                data = json.dumps(body).encode()
                self._send(data, "application/json")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _render_map(self) -> bytes:
        """Live-viewer frame: render the CURRENT map snapshot to PNG.
        `system.state` is a NamedTuple of tensors rebound by the tracking
        thread, so grabbing one local reference gives a consistent map;
        the device->host copies happen on this handler thread (the
        reference's viewer thread reads mutex-guarded copies the same
        way, src/Viewer.cc:54-170). A failed render is reported on stderr
        and answered with an empty body: the server keeps running."""
        from ..utils import viewer

        st = self.system.state
        pose = getattr(self.system, "last_pose", None)
        try:
            return viewer.render_map_png(st, covis=st.covis,
                                         current_pose=pose)
        except Exception:
            traceback.print_exc(file=sys.stderr)
            return b""

    def _map_changed(self) -> bool:
        """Edge-triggered map-mutation flag (reference System::MapChanged
        semantics) with its own epoch cursor so polling the HTTP endpoint
        does not consume the System's in-process cursor."""
        s = self.system
        epoch = s.stats.n_keyframes + (
            s.loop_closer.n_loops_closed if s.loop_closer else 0
        )
        with self._epoch_lock:
            changed = epoch != self._last_epoch
            self._last_epoch = epoch
        return changed

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "StatusServer":
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)
