"""Live render preview over HTTP — the headless analog of ``dynamic_gui``
(a copy of ``another_raytracer_tpu.utils.liveview`` on the port's own
``imageio``).

The reference opens an X11 window that repaints as rows/squares complete
(gui.cpp:25-58, engine.h:88,307,353).  A render on a GPU server runs on a machine with
no display, so the live-progress capability maps to a localhost HTTP
endpoint: a background thread serves the most recent frame as PNG plus a
self-refreshing page; any browser (or curl loop) is the window.  Rendering
math never depends on it, same as the reference (the GUI stub compiles to a
no-op when disabled, gui.h:36-43).

    viewer = LiveViewer(port=0)          # 0 = pick a free port
    viewer.start()
    ...
    viewer.update(img_uint8)             # called between passes
    ...
    viewer.stop()

``gui::display``'s blocking final view (gui.cpp:13-23) maps to
``viewer.serve_forever()`` — keep serving the finished frame until ^C.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = b"""<!doctype html>
<html><head><title>another_raytracer_tpu_torch live render</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;height:100vh}
img{image-rendering:pixelated;max-width:96vw;max-height:90vh}
#s{color:#888;font:12px monospace;position:fixed;top:8px;left:8px}</style></head>
<body><div id="s"></div><img id="f" src="/frame.png">
<script>
let n=0;
setInterval(()=>{const i=document.getElementById('f');
 i.src='/frame.png?'+(n++);
 fetch('/status').then(r=>r.json()).then(j=>{
  document.getElementById('s').textContent=
   `pass ${j.updates} \xc2\xb7 ${j.samples_done} samples`;});},1000);
</script></body></html>"""


class LiveViewer:
    """Serve the latest frame at http://127.0.0.1:<port>/ from a daemon
    thread.  ``update`` is cheap when no client ever connects: the PNG is
    encoded lazily on request."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._host = host
        self._port = port
        self._lock = threading.Lock()
        self._img = np.zeros((1, 1, 3), np.uint8)
        self._png = None  # lazily (re)encoded
        self._updates = 0
        self._samples_done = 0
        self._server = None
        self._thread = None

    # --- producer side ------------------------------------------------------

    def update(self, image_uint8, samples_done: int = 0) -> None:
        with self._lock:
            self._img = np.ascontiguousarray(np.asarray(image_uint8, np.uint8))
            self._png = None
            self._updates += 1
            self._samples_done = samples_done

    def _frame_png(self) -> bytes:
        from another_raytracer_tpu_torch.utils import imageio

        with self._lock:
            if self._png is None:
                self._png = imageio.encode_png(self._img)
            return self._png

    # --- server lifecycle ---------------------------------------------------

    def start(self) -> int:
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/frame.png":
                    body, ctype = viewer._frame_png(), "image/png"
                elif path == "/status":
                    import json

                    with viewer._lock:
                        body = json.dumps({
                            "updates": viewer._updates,
                            "samples_done": viewer._samples_done,
                        }).encode()
                    ctype = "application/json"
                elif path == "/":
                    body, ctype = _PAGE, "text/html"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._port = self._server.server_port
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="liveview-http")
        self._thread.start()
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self._port}/"

    def serve_forever(self) -> None:
        """Blocking final display (gui.cpp:13-23 analog): keep serving the
        finished frame until interrupted."""
        try:
            self._thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
