"""Render GUI: a localhost web app consuming the IILE control protocol.

The reference ships an Electron app (ref: gui/main.js + gui/static/
root.js + gui/static/mainController.js) that spawns `bin/pbrt
--iileControl=<dir>`, watches the control directory for
out_{indirect,direct,combined}.pfm, tonemaps them with tools/cpfm, and
tracks progress through the `#INDPROGRESS!p` / `#DIRECTPROGRESS!p` /
`#REFRESH!` / `#FINISH!` stdout tokens (iispt.cpp:749-787).

This module is the same application as a zero-dependency web server:
  python -m pbrt_v3_iile_tpu.cli.gui [--port 8790]
then open http://localhost:8790, pick a scene, render.  Endpoints:
  POST /start     {"scene": path, "indirect": n, "direct": n, ...}
  GET  /status    progress + token log (JSON)
  GET  /image/<which>.png?exposure=E   tonemapped latest PFM
  POST /gain      {"gain": g} -> writes control_gain_XXX (Doc.md "GUI")
  POST /stop
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import urlparse, parse_qs

import numpy as np


class RenderSession:
    """Owns one renderer subprocess + its control directory."""

    def __init__(self):
        self.proc = None
        self.control_dir = None
        self.progress = {"indirect": 0.0, "direct": 0.0, "finished": False}
        self.refresh_count = 0
        self.log: list = []
        self.lock = threading.Lock()

    def start(self, scene: str, indirect: int = 4, direct: int = 4,
              integrator: str = "iispt", extra=None):
        self.stop()
        self.control_dir = tempfile.mkdtemp(prefix="iile_gui_")
        out = os.path.join(self.control_dir, "out.exr")
        cmd = [sys.executable, "-m", "pbrt_v3_iile_tpu.cli.main", scene,
               out, "--integrator", integrator,
               "--iileIndirect", str(indirect),
               "--iileDirect", str(direct),
               "--iileControl", self.control_dir]
        if extra:
            cmd += list(extra)
        self.progress = {"indirect": 0.0, "direct": 0.0, "finished": False}
        self.refresh_count = 0
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.DEVNULL, text=True)
        threading.Thread(target=self._pump, daemon=True).start()
        return self.control_dir

    def _pump(self):
        """Token parser — the root.js stdout watcher equivalent
        (ref: gui/static/root.js progress handling)."""
        proc = self.proc
        for line in proc.stdout:
            line = line.strip()
            with self.lock:
                self.log.append(line)
                m = re.match(r"#INDPROGRESS!([\d.eE+-]+)", line)
                if m:
                    self.progress["indirect"] = float(m.group(1))
                m = re.match(r"#DIRECTPROGRESS!([\d.eE+-]+)", line)
                if m:
                    self.progress["direct"] = float(m.group(1))
                if line.startswith("#REFRESH!"):
                    self.refresh_count += 1
                if line.startswith("#FINISH!"):
                    self.progress["finished"] = True
        proc.wait()
        with self.lock:
            self.progress["finished"] = True

    def set_gain(self, gain: float):
        """Exposure control file (Doc.md "GUI": control_gain_XXX)."""
        if not self.control_dir:
            return
        for f in os.listdir(self.control_dir):
            if f.startswith("control_gain_"):
                try:
                    os.unlink(os.path.join(self.control_dir, f))
                except OSError:
                    pass
        open(os.path.join(self.control_dir, f"control_gain_{gain:g}"),
             "w").close()

    def image_png(self, which: str, exposure: float = 0.0) -> bytes:
        """Tonemap the latest out_<which>.pfm (the cpfm role)."""
        from ..utils import image as imglib

        path = os.path.join(self.control_dir or ".", f"out_{which}.pfm")
        if not self.control_dir or not os.path.exists(path):
            return b""
        img = imglib.read_pfm(path)
        gain = 2.0 ** exposure
        mean = float(img.mean())
        scale = gain / max(mean * 4.0, 1e-6)
        tm = np.clip((img * scale) ** (1.0 / 2.2), 0.0, 1.0)
        import io

        buf = io.BytesIO()
        imglib.write_png(buf, (tm * 255).astype(np.uint8))
        return buf.getvalue()

    def status(self) -> dict:
        with self.lock:
            return dict(progress=dict(self.progress),
                        refresh=self.refresh_count,
                        running=self.proc is not None
                        and self.proc.poll() is None,
                        control_dir=self.control_dir,
                        log_tail=self.log[-20:])

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        self.proc = None


INDEX_HTML = """<!doctype html>
<html><head><title>pbrt-v3-IILE (JAX)</title><style>
body{font-family:sans-serif;margin:2em;background:#111;color:#eee}
input,button,select{font-size:1em;margin:.2em}
.bar{height:14px;background:#333;width:420px;border-radius:7px}
.fill{height:100%;background:#4a9;border-radius:7px;width:0}
img{border:1px solid #444;max-width:90vw}
</style></head><body>
<h2>pbrt-v3-IILE &mdash; JAX renderer</h2>
<div>
 Scene <input id=scene size=60 placeholder="/path/to/scene.pbrt">
 Indirect <input id=ind type=number value=4 style="width:4em">
 Direct <input id=dir type=number value=4 style="width:4em">
 <button onclick="start()">Render</button>
 <button onclick="fetch('/stop',{method:'POST'})">Stop</button>
</div>
<div>Indirect <div class=bar><div class=fill id=pi></div></div>
     Direct <div class=bar><div class=fill id=pd></div></div></div>
<div>View <select id=which onchange="refresh()">
 <option>combined</option><option>indirect</option><option>direct</option>
</select> Exposure <input id=exp type=range min=-6 max=6 step=0.5 value=0
 onchange="gain(this.value)"></div>
<img id=view width=700>
<script>
let seenRefresh = -1;
function start(){
  fetch('/start',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({scene:scene.value,indirect:+ind.value,
                         direct:+dir.value})});
}
function gain(v){fetch('/gain',{method:'POST',body:JSON.stringify({gain:Math.pow(2,+v)})});refresh();}
function refresh(){
  view.src='/image/'+which.value+'.png?exposure='+exp.value+'&t='+Date.now();
}
setInterval(async()=>{
  const s=await (await fetch('/status')).json();
  pi.style.width=(100*s.progress.indirect)+'%';
  pd.style.width=(100*s.progress.direct)+'%';
  if(s.refresh!==seenRefresh){seenRefresh=s.refresh;refresh();}
},2000);
</script></body></html>"""


def make_server(port: int = 8790):
    session = RenderSession()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path in ("/", "/index.html"):
                self._send(200, INDEX_HTML.encode(), "text/html")
            elif u.path == "/status":
                self._send(200, json.dumps(session.status()).encode())
            elif u.path.startswith("/image/"):
                which = u.path.split("/")[-1].replace(".png", "")
                q = parse_qs(u.query)
                exp = float(q.get("exposure", ["0"])[0])
                png = session.image_png(which, exp)
                if png:
                    self._send(200, png, "image/png")
                else:
                    self._send(404, b"not ready", "text/plain")
            else:
                self._send(404, b"?", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/start":
                d = session.start(body["scene"],
                                  int(body.get("indirect", 4)),
                                  int(body.get("direct", 4)),
                                  body.get("integrator", "iispt"),
                                  body.get("extra"))
                self._send(200, json.dumps({"control_dir": d}).encode())
            elif self.path == "/gain":
                session.set_gain(float(body.get("gain", 1.0)))
                self._send(200, b"{}")
            elif self.path == "/stop":
                session.stop()
                self._send(200, b"{}")
            else:
                self._send(404, b"?", "text/plain")

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    server.session = session
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(prog="pbrt-gui")
    ap.add_argument("--port", type=int, default=8790)
    args = ap.parse_args(argv)
    server = make_server(args.port)
    print(f"IILE GUI on http://127.0.0.1:{args.port}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.session.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
