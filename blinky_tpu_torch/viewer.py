"""Interactive browser viewer: the optional vid-layer analog.

The port of :mod:`blinky_tpu.viewer`: the same page, token, endpoints,
console, shortcut keys, pose-track follow, ``/record.gif``, time-sliced
lens switches and warm contracts, on the port's :class:`Session`.  Its cold
start is the port's own: the kernel library's ``nvcc`` build, the native
host library's build, the CUDA context and the first K1 launch, paid by
:meth:`Viewer.start_background_warm` on its thread (which enters the
session's card through ``kernels._build.on_device`` and never touches the
shared Session) while ``Session.render_host`` answers.  A failed warm is
printed and shown on ``/state`` as ``device_error`` beside
``device_ready``, and retried after a 30 s backoff.

The reference is an interactive program — ``VID_Update`` blits the
8-bit framebuffer to a window (``include/vid.h:141``), ``Key_Event``
feeds binds (``common/keys.c``), and the whole fisheye surface is driven
live from the console.  SURVEY.md §2.5 scopes the video backend out as
"framework emits arrays/files; optional viewer" — this module is that
viewer: a single-threaded ``http.server`` that renders demo frames
through the live :class:`~blinky_tpu_torch.api.Session` on request and serves
a page with

* drag-to-look (``setviewangles`` — the reference pans by re-rendering
  plates from ``cl.viewangles``, ``fisheye.c:750``; with recorded plates
  the rotation composes into the lensmap for inverse lenses, while
  forward-only and scalar-only ``.lua`` lenses — whose exact composed
  rebuild is seconds-scale host work PER POSE — render through the
  static-ray posed pipeline (:mod:`blinky_tpu_torch.kernels.static_ray`), the
  reference's own pose/lensmap decoupling),
* the reference's shortcut keys (``f_shortcutkeys``: 1-9 lenses,
  y/u/i/o/p globes, ``fisheye.c:984-997``) forwarded to
  :meth:`Session.press_key`,
* a console box speaking the full ``f_*`` vocabulary, and
* frame playback over the demo container.

Single-threaded by design: ``HTTPServer`` (not the threading variant)
serializes requests, so the Session and the device are never touched
concurrently.  Binds to localhost by default; PNG encoding is the
stdlib-only codec in :mod:`blinky_tpu_torch.io.png`.
"""

from __future__ import annotations

import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from blinky_tpu_torch.io.png import encode_png
from blinky_tpu_torch.kernels.remap import host_array as _host


def _entered(device):
    """The warm threads' way onto *device*: the kernel wrappers' own
    helper, which makes a card the thread's current device (a new thread
    starts on card 0); a CPU device needs nothing."""
    from blinky_tpu_torch.kernels import _build

    return _build.on_device(device) if device.type == "cuda" else contextlib.nullcontext()

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>blinky-tpu</title><style>
 body { background:#111; color:#ddd; font:14px monospace; margin:16px; }
 #frame { image-rendering:pixelated; cursor:grab; border:1px solid #333; }
 #console { width:640px; background:#000; color:#8f8; border:1px solid #333;
            padding:4px; font:13px monospace; }
 #log { width:640px; height:10em; overflow-y:scroll; background:#000;
        border:1px solid #333; padding:4px; white-space:pre-wrap; }
 #hud { color:#888; margin:4px 0; }
 button { background:#222; color:#ddd; border:1px solid #444; }
</style></head><body>
<div id="hud">loading…</div>
<img id="frame" draggable="false">
<div id="hud2">
 <button id="play">pause</button>
 <label id="followbox" style="display:none">
   <input type="checkbox" id="follow"> follow pose track</label>
 <a id="rec" href="/record.gif?t=%TOKEN%" download="blinky.gif"
    style="color:#8cf">&#9660; gif</a>
 keys: 1-9 lenses, y/u/i/o/p globes (f_shortcutkeys) — drag to look
</div>
<div id="log"></div>
<input id="console" placeholder="console: f_lens quincuncial; f_fov 360 …">
<script>
const img = document.getElementById('frame');
const log = document.getElementById('log');
const hud = document.getElementById('hud');
let n = 1, fps = 10, playing = true, t0 = Date.now(), base = 0;
let pitch = 0, yaw = 0, busy = false;
function logLines(lines) {
  if (!lines || !lines.length) return;
  log.textContent += lines.join('\\n') + '\\n';
  log.scrollTop = log.scrollHeight;
}
async function refresh() {
  if (busy) return;           // never queue device work
  busy = true;
  const i = playing ? Math.floor(base + (Date.now()-t0)/1000*fps) % n : base % n;
  const fl = document.getElementById('follow').checked
    ? '&follow=1&t=%TOKEN%' : '';
  document.getElementById('rec').href =
    '/record.gif?t=%TOKEN%&d=' + Math.max(2, Math.round(100/fps)) + fl;
  try {
    const r = await fetch('/frame.png?i=' + i + fl, {cache:'no-store'});
    const blob = await r.blob();
    const url = URL.createObjectURL(blob);
    // revoke via BOTH handlers: an error response (403/500 text) never
    // fires onload, and at 20 Hz an unrevoked URL per poll is a leak
    img.onload = () => URL.revokeObjectURL(url);
    img.onerror = () => URL.revokeObjectURL(url);
    img.src = url;
    hud.textContent = r.headers.get('X-Status') || '';
  } finally { busy = false; }
}
async function state() {
  const s = await (await fetch('/state?t=%TOKEN%')).json();
  n = Math.max(1, s.frames);
  if (s.has_poses) document.getElementById('followbox').style.display = '';
  logLines(s.console);
}
async function cmd(c) {
  const s = await (await fetch('/cmd?t=%TOKEN%&c=' + encodeURIComponent(c))).json();
  logLines(s.console);
}
// drag-to-look coalescing: at most one setviewangles in flight; only the
// newest angles are sent when the previous request completes
let lookBusy = false, lookPending = null;
async function look(p, y) {
  lookPending = 'setviewangles ' + p.toFixed(1) + ' ' + y.toFixed(1) + ' 0';
  if (lookBusy) return;
  lookBusy = true;
  try {
    while (lookPending) {
      const c = lookPending; lookPending = null;
      await cmd(c);
    }
  } finally { lookBusy = false; }
}
document.getElementById('console').addEventListener('keydown', e => {
  if (e.key === 'Enter' && e.target.value.trim()) {
    logLines(['> ' + e.target.value]);
    cmd(e.target.value); e.target.value = '';
  }
  e.stopPropagation();
});
document.addEventListener('keydown', async e => {
  if (e.target.id === 'console' || e.key.length !== 1) return;
  const s = await (await fetch('/key?t=%TOKEN%&k=' + encodeURIComponent(e.key))).json();
  logLines(s.console);
});
document.getElementById('play').onclick = e => {
  if (playing) { base = Math.floor(base + (Date.now()-t0)/1000*fps); }
  else { t0 = Date.now(); }
  playing = !playing;
  e.target.textContent = playing ? 'pause' : 'play';
};
let drag = null;
img.addEventListener('pointerdown', e => {
  drag = {x: e.clientX, y: e.clientY, pitch, yaw};
  img.setPointerCapture(e.pointerId);
});
img.addEventListener('pointermove', e => {
  if (!drag) return;
  yaw = drag.yaw + (e.clientX - drag.x) * 0.4;
  pitch = Math.max(-90, Math.min(90, drag.pitch - (e.clientY - drag.y) * 0.4));
  look(pitch, yaw);
});
img.addEventListener('pointerup', () => drag = null);
state().then(() => setInterval(refresh, 50));
</script></body></html>
"""


class Viewer:
    """Serve a :class:`Session` + demo frames over HTTP for live viewing.

    ``frames``: [N, P, S, S] u8 (a demo container's frames) or one
    [P, S, S] cubemap.  All rendering happens in the request handler —
    one frame per ``/frame.png`` — through ``session.render``.
    """

    def __init__(self, session, frames, poses=None, host: str = "127.0.0.1",
                 port: int = 0, device_warm: bool = True, pose_scale=1):
        import secrets

        frames = np.asarray(frames)
        if frames.dtype != np.uint32:  # u32 = packed-RGBA true color
            frames = frames.astype(np.uint8, copy=False)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.ndim != 4:
            raise ValueError("Viewer frames must be [N, P, S, S] or [P, S, S]")
        if len(frames) == 0:
            raise ValueError("Viewer needs at least one frame")
        self.session = session
        # bind-first cold serve (fisheye.c:306-322 — the loop never
        # blocks): until this event is set, /frame.png renders through
        # Session.render_host (pure NumPy, bit-equal to the device
        # kernel) so a cold process serves its first frame immediately
        # while start_background_warm() pays the device compiles off the
        # request path.  device_warm=True starts in warm mode (tests and
        # embedders that warmed the device themselves).
        self.device_ready = threading.Event()
        if device_warm:
            self.device_ready.set()
        # the last background warm's failure ("" when none): printed, and
        # served on /state beside device_ready, never hidden
        self.device_error = ""
        if session.build_budget_s is None:
            # interactive host: never block the page on a seconds-scale
            # exact build — time-slice it like the reference's frame
            # loop (1/60 s, fisheye.c:645) and paint the preview
            session.build_budget_s = 1 / 60
        self.frames = frames
        # optional demo pose track: /frame.png?follow=1 applies pose i
        # before rendering (the demo-playback camera, cl_demo.c)
        self.poses = None if poses is None or len(poses) == 0 else (
            np.asarray(poses, np.float32).reshape(-1, 3))
        # render_scale for the static-ray posed preview (forward-only /
        # scalar-only lenses under a view rotation): int k, or "auto"
        # for the session's dynamic-resolution probe (PERF §6).
        # Validated HERE, not just in `cli serve`: a non-int non-"auto"
        # value would silently bypass the warmth gate (isinstance-int
        # checks) and then 500 deep inside render_posed — embedders
        # should fail at construction instead.
        if pose_scale != "auto":
            if isinstance(pose_scale, bool) or not isinstance(pose_scale, int):
                raise ValueError(
                    f"pose_scale must be an int or 'auto', got "
                    f"{pose_scale!r}")
            from blinky_tpu_torch.kernels.posed import check_render_scale

            check_render_scale(session.width_px, session.height_px,
                               pose_scale)
        self.pose_scale = pose_scale
        self._posed_src = {}  # (i, rubix, palette_gen) -> posed source
        self._posed_preview = False  # last /frame.png took the posed path
        # warmth gate for the posed pipeline (the round-3 discipline:
        # never block an interactive request on a cold first run):
        # keys whose compiled pipeline has executed, threads compiling
        # one now, and the last posed screen to serve while they do
        self._posed_warm_keys = set()
        self._posed_warming = {}
        # failed posed warms retry with a backoff (mirrors the device
        # warm): key -> monotonic time before which no new warm spawns.
        # A transient device error must not pin a key to inline compiles
        # (or permanent staleness) for the process lifetime.
        self._posed_warm_retry_at = {}
        # ...but a DETERMINISTIC warm failure must not stale-serve +
        # respawn forever either: after this many consecutive failures
        # on one key the drag path compiles inline so the real error
        # surfaces as a 500 (the pre-backoff behavior)
        self._posed_warm_fails = {}
        self.POSED_WARM_MAX_FAILS = 3
        # bound on joining an in-flight posed warm before a blocking
        # render: past it we 500 rather than dispatch concurrently with
        # the still-running warm thread (see _render_posed_frame)
        self.POSED_JOIN_TIMEOUT = 600.0
        self._posed_stale = False
        self._last_posed = None
        # warm-failure retry: a transient device error during the device
        # warm must not pin the viewer to host renders for the process
        # lifetime — cold-phase requests respawn the warm (bounded by a
        # backoff) once the previous attempt's thread has died
        self._warm_thread = None
        self._warm_retry_at = 0.0
        self._drained = 0  # console lines already delivered to the page
        # State-changing endpoints (/cmd, /key) require this token, which
        # only the served page knows: a cross-origin page can fire a GET
        # at localhost but cannot READ "/" to learn the token (CORS), so
        # drive-by command execution is blocked.
        self.token = secrets.token_urlsafe(16)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet access log
                pass

            def _send(self, code, body, ctype, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _console_json(self):
                return json.dumps({"console": viewer.drain_console()}).encode()

            def do_GET(self):
                try:
                    url = urlparse(self.path)
                    q = parse_qs(url.query)
                    if url.path == "/":
                        page = _PAGE.replace("%TOKEN%", viewer.token)
                        self._send(200, page.encode(), "text/html")
                    elif url.path == "/frame.png":
                        i = int(q.get("i", ["0"])[0]) % len(viewer.frames)
                        follow = q.get("follow", ["0"])[0] == "1"
                        # follow=1 mutates session state (setviewangles in
                        # _render_screen) — token-gated like /cmd and /key
                        if follow and q.get("t", [""])[0] != viewer.token:
                            self._send(403, b"bad token", "text/plain")
                            return
                        png, status = viewer.render_png(i, follow=follow)
                        self._send(200, png, "image/png",
                                   extra=[("X-Status", status)])
                    elif url.path in ("/cmd", "/key"):
                        if q.get("t", [""])[0] != viewer.token:
                            self._send(403, b"bad token", "text/plain")
                            return
                        if url.path == "/cmd":
                            viewer.session.cmd(q.get("c", [""])[0])
                        else:
                            viewer.session.press_key(q.get("k", [""])[0])
                        self._send(200, self._console_json(),
                                   "application/json")
                    elif url.path == "/record.gif":
                        # token-gated like /cmd and /key: the capture can
                        # mutate session state (setviewangles via
                        # follow=1) and device-renders the whole loop —
                        # not for drive-by cross-origin GETs
                        if q.get("t", [""])[0] != viewer.token:
                            self._send(403, b"bad token", "text/plain")
                            return
                        start = int(q.get("from", ["0"])[0])
                        count = q.get("n", [None])[0]
                        count = int(count) if count is not None else None
                        follow = q.get("follow", ["0"])[0] == "1"
                        delay = int(q.get("d", ["10"])[0])
                        fast = q.get("fast", ["0"])[0] == "1"
                        gif = viewer.render_gif(start, count, follow=follow,
                                                delay_cs=delay, fast=fast)
                        self._send(200, gif, "image/gif")
                    elif url.path == "/state":
                        drain = q.get("t", [""])[0] == viewer.token
                        self._send(200, viewer.state_json(drain=drain),
                                   "application/json")
                    else:
                        self._send(404, b"not found", "text/plain")
                except BrokenPipeError:
                    pass
                except Exception as e:  # surface errors to the page
                    self._send(500, f"{type(e).__name__}: {e}".encode(),
                               "text/plain")

        # single-threaded: serializes Session/device access
        self._httpd = HTTPServer((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start_background_warm(self):
        """Pay the device's cold-start costs on a daemon thread while the
        bound server keeps answering with host renders: the kernel
        library's ``nvcc`` build, the native host library's build, the
        CUDA context, a float32 device build of the active lens (K8) and
        the first K1 launch; flips ``device_ready`` when the device path
        has run.

        The thread enters the session's device (``kernels._build.on_device``)
        and touches only its OWN lensmap and kernel objects, never the
        shared Session (the single-threaded HTTP handler owns it).  The
        lens/globe references read at start are a snapshot: a lens switch
        mid-warm is served like any cold lens.  On failure the event stays
        unset, ``device_error`` says why (it is printed and served on
        ``/state``), and the viewer keeps serving host renders until a
        retry, 30 s later, succeeds.
        """
        if self.device_ready.is_set():
            return None
        sess = self.session
        frame0 = self.frames[0]
        device = sess.device

        def work():
            try:
                with _entered(device):
                    self._warm_device(sess, frame0, device)
            except Exception as e:  # keep serving host renders
                self.device_error = f"{type(e).__name__}: {e}"
                print(f"device warm failed ({self.device_error}); "
                      "viewer stays on host renders")

        import time

        t = threading.Thread(target=work, name="blinky-device-warm",
                             daemon=True)
        self._warm_thread = t
        self._warm_retry_at = time.monotonic() + 30.0  # backoff from start
        t.start()
        return t

    def _warm_device(self, sess, frame0, device) -> None:
        """The body of the background warm (see
        :meth:`start_background_warm`), on the warm thread."""
        from blinky_tpu_torch import native
        from blinky_tpu_torch.kernels import _build
        from blinky_tpu_torch.kernels.remap import RemapKernel
        from blinky_tpu_torch.lensmap import build_lensmap, calc_scale

        native.available()  # the host library's build, if it is stale
        if device.type == "cuda":
            _build.library()  # nvcc, if the kernel library is stale
        lens, globe = sess.lens, sess.globe
        jit_ok = (sess.lens_valid and sess.globe_valid
                  and getattr(lens, "map_type", "inverse") == "inverse"
                  and sess._jittable())
        try:
            scale = calc_scale(sess.zoom, lens, sess.width_px,
                               sess.height_px)
        except Exception:
            scale = 1.0  # any scale: the builder takes it as a value
        lm = build_lensmap(
            lens, globe, scale, sess.width_px, sess.height_px,
            sess.platesize, numcells=sess.rubix_numcells,
            cell_size=sess.rubix_cell_size,
            pad_size=sess.rubix_pad_size,
            backend="torch" if jit_ok else "numpy", device=device,
        )
        k = RemapKernel(lm, sess.palette, device=device)
        _host(k(frame0))  # the CUDA context, K1's first launch, a copy back
        self.device_error = ""
        self.device_ready.set()
        if jit_ok or not (sess.lens_valid and sess.globe_valid):
            return
        if not getattr(globe, "jittable", True):
            return  # scalar-only globe: no posed preview to warm
            # (_posed_preview_active is False: drags rebuild)
        try:
            # drag-look on this lens takes the static-ray posed path
            # (_posed_preview_active): pre-pay its first run too (K7 and
            # K6), on our OWN kernel objects.  With pose_scale="auto"
            # this covers k=1 only: the auto probes run on the first drag.
            from blinky_tpu_torch.kernels.remap import expand_rubix_source

            src = frame0[..., None]
            if sess.rubix_enabled:
                src = expand_rubix_source(src, sess.palette)
            pk = self._posed_pipeline_key(src, globe=globe)
            # register THIS thread under the key so a first drag arriving
            # mid-warm joins it instead of running the same warm
            # concurrently on two threads.  setdefault: a lazy warm may
            # have registered the key after device_ready flipped; it owns
            # the slot then
            me = threading.current_thread()
            if self._posed_warming.setdefault(pk, me) is me:
                try:
                    self._compile_posed_pipeline(
                        pk, src, lens, globe, scale, lensmap=lm)
                finally:
                    # pop only OUR registration (never a lazy warm's)
                    if self._posed_warming.get(pk) is me:
                        self._posed_warming.pop(pk, None)
        except Exception as e:  # the drag path warms lazily then
            print(f"posed-pipeline warm failed "
                  f"({type(e).__name__}: {e})")

    def _maybe_retry_warm(self) -> None:
        """Respawn a FAILED background warm (thread dead, device still
        cold) after a 30 s backoff — a transient device error at serve
        start must not pin the process to host renders forever.  No-op
        while a warm is in flight or if none was ever started (an
        embedder that manages device_ready itself)."""
        import time

        t = self._warm_thread
        if t is None or t.is_alive() or self.device_ready.is_set():
            return
        now = time.monotonic()
        if now < self._warm_retry_at:
            return
        self._warm_retry_at = now + 30.0
        print("device warm failed earlier; retrying in the background")
        self.start_background_warm()

    def _posed_pipeline_key(self, src, globe=None):
        """Identity of the static-ray pipeline a posed render of ``src``
        runs (the JAX package's compiled-executable key: globe, shape,
        source kind, render_scale) plus the
        source dtype (each dtype is its own first run).  The lens is NOT in
        it — lens switches reuse the warm executable by design.  The
        key holds the Globe OBJECT (identity-eq/hash), not ``id()``:
        a freed globe's id can be reused and mark a genuinely cold
        pipeline warm (the _posed_cache pitfall, api.py)."""
        sess = self.session
        k = self.pose_scale if isinstance(self.pose_scale, int) else 1
        return (globe if globe is not None else sess.globe,
                sess.width_px, sess.height_px, src.shape[1],
                src.shape[0], src.dtype.str, k)

    def _compile_posed_pipeline(self, pk, src, lens, globe, scale,
                                lensmap=None) -> None:
        """Run the static-ray posed pipeline for ``pk`` once (the ray table,
        K7 and K6) on throwaway kernel objects on the session's device (the
        shared Session is never touched), then mark the key warm."""
        from blinky_tpu_torch.kernels.posed import bases_from_pose_track
        from blinky_tpu_torch.kernels.static_ray import StaticRayPosedKernel

        sess = self.session
        background = None
        if src.dtype == np.uint32:
            # prep_posed_inputs demands an RGBA background for RGBA
            # frames; zeros suffice for compiling (background is a
            # traced ARG, only its dtype/shape shape the executable)
            background = np.zeros((sess.height_px, sess.width_px),
                                  np.uint32)
        with _entered(sess.device):
            sk = StaticRayPosedKernel(
                lens, globe, sess.width_px, sess.height_px, scale,
                platesize=src.shape[1], numcells=sess.rubix_numcells,
                cell_size=sess.rubix_cell_size, pad_size=sess.rubix_pad_size,
                background=background,
                render_scale=(self.pose_scale
                              if isinstance(self.pose_scale, int) else 1),
                lensmap=lensmap, device=sess.device,
            )
            _host(sk(src, bases_from_pose_track([[0, 0, 0]])))
        self._posed_warm_keys.add(pk)

    def _ensure_posed_warming(self, pk, src) -> None:
        """Kick one background compile for a cold posed-pipeline key
        (f_rubix toggled, globe switched, true-color source appeared …)
        so the single-threaded request path can keep serving the last
        posed frame instead of blocking on the cold first run."""
        import time

        t = self._posed_warming.get(pk)
        if t is not None and t.is_alive():
            return
        if time.monotonic() < self._posed_warm_retry_at.get(pk, 0.0):
            return  # backoff after a failed warm; serve the stale frame
        sess = self.session
        lens, globe = sess.lens, sess.globe
        from blinky_tpu_torch.lensmap import calc_scale

        scale = calc_scale(sess.zoom, lens, sess.width_px, sess.height_px)

        def work():
            try:
                self._compile_posed_pipeline(pk, src, lens, globe, scale)
                self._posed_warm_retry_at.pop(pk, None)
                self._posed_warm_fails.pop(pk, None)
            except Exception as e:
                # retry-at backoff (the device-warm pattern): the next
                # poll after 30 s respawns the warm; meanwhile requests
                # keep serving the last posed frame instead of blocking
                # the single-threaded server on an inline compile.
                # Consecutive failures are counted: past the cap the
                # drag path stops stale-serving and compiles inline so
                # a DETERMINISTIC failure surfaces as a 500 instead of
                # an infinite stale-frame/retry loop.
                n = self._posed_warm_fails.get(pk, 0) + 1
                self._posed_warm_fails[pk] = n
                more = ("; next request will compile inline and surface "
                        "the error"
                        if n >= self.POSED_WARM_MAX_FAILS
                        else "; retrying in 30 s")
                print(f"posed-pipeline warm failed "
                      f"({type(e).__name__}: {e}){more}")
                self._posed_warm_retry_at[pk] = time.monotonic() + 30.0
            finally:
                # prune: dead Thread objects must not accumulate one per
                # distinct pipeline key for the viewer's lifetime —
                # but pop only OUR OWN registration (the startup warm
                # may legitimately own the slot for this key)
                if self._posed_warming.get(pk) is t:
                    self._posed_warming.pop(pk, None)

        t = threading.Thread(target=work, name="blinky-posed-warm",
                             daemon=True)
        if self._posed_warming.setdefault(pk, t) is not t:
            return  # another thread registered this key meanwhile
        t.start()

    def _posed_preview_active(self) -> bool:
        """True when the current view rotation cannot compose into the
        lensmap on-device: a forward-only lens (its exact composed
        rebuild is one host rasterization PER POSE, seconds at
        production sizes) or a scalar-only ``.lua`` that fails the trace
        probe (exact f64 host build per pose).  Those render through
        the static-ray posed pipeline instead — the reference's own
        pose/lensmap decoupling (``fisheye.c:750,2427-2450`` vs
        ``2346-2397``: a view rotation never touches its lensmap), at
        device rate for every lens.  Inverse jittable lenses keep the
        ms-scale f32 device rebuild (the pinned drag-look path)."""
        sess = self.session
        if sess.view_angles is None or not (
                sess.fisheye_enabled and sess.lens_valid and sess.globe_valid):
            return False
        if not getattr(sess.globe, "jittable", True):
            # a scalar-only .lua GLOBE can't trace the per-pose plate
            # resolve, so the static-ray pipeline is unavailable
            # (render_posed would take its exact host path per frame —
            # no faster than the drag path's own exact composed rebuild)
            return False
        if getattr(sess.lens, "map_type", "inverse") != "inverse":
            return True
        return not sess._jittable()

    def _posed_source(self, i: int) -> np.ndarray:
        """The [P, S, S, 1] posed source for frame ``i``: rubix rides
        the source on every posed path, so the frame is
        expanded (raw||tinted) when the grid is on — cached per
        (frame, rubix, palette) in a small FIFO pool so neither a 20 Hz
        drag nor follow-playback over a short loop re-expands, while a
        long demo can't pin unbounded host RAM."""
        sess = self.session
        key = (i, bool(sess.rubix_enabled), getattr(sess, "_palette_gen", 0))
        src = self._posed_src.get(key)
        if src is None:
            src = self.frames[i][..., None]
            if sess.rubix_enabled:
                from blinky_tpu_torch.kernels.remap import expand_rubix_source

                src = expand_rubix_source(src, sess.palette)
            while len(self._posed_src) >= 8:  # FIFO bound (~8 frames)
                self._posed_src.pop(next(iter(self._posed_src)))
            self._posed_src[key] = src
        return src

    def _render_posed_frame(self, i: int, block: bool = False) -> np.ndarray:
        """Frame ``i`` at the session's view angles through
        ``Session.render_posed`` (static-ray, B=1).  A cold compiled
        pipeline (f_rubix toggle, globe switch, first u32 frame …)
        compiles on a background thread while the LAST posed frame keeps
        serving — the never-block discipline (warmth-gated previews,
        round 3).  With ``pose_scale="auto"`` the gate is bypassed: the
        auto probes time the device inline by design.  ``block=True``
        (fast captures) also bypasses it: a one-shot export is not
        latency-sensitive, and serving the stale last frame would bake N
        copies of the pre-capture pose into the GIF — compile inline
        instead."""
        sess = self.session
        src = self._posed_source(i)
        if isinstance(self.pose_scale, int):
            pk = self._posed_pipeline_key(src)
            if pk not in self._posed_warm_keys:
                gave_up = (self._posed_warm_fails.get(pk, 0)
                           >= self.POSED_WARM_MAX_FAILS)
                if self._last_posed is not None and not block and not gave_up:
                    self._ensure_posed_warming(pk, src)
                    self._posed_stale = True
                    return self._last_posed
                # about to compile inline (first-ever drag the startup
                # warm didn't cover, or a blocking fast capture) — if a
                # background warm for this very key is mid-compile (a
                # /frame.png poll kicked it just before the capture),
                # join it instead of tracing the same executable on two
                # threads (same latency, no duplicated compile and no
                # concurrent device dispatch against the warm thread)
                t = self._posed_warming.get(pk)
                if t is not None and t.is_alive():
                    # bounded join: a hung warm must not hang
                    # the single-threaded HTTP server forever.  If the
                    # warm is STILL alive after the (generous) bound,
                    # error out (a 500) rather than render inline — an
                    # inline dispatch would run concurrently with the
                    # warm thread's in-flight compile, the exact
                    # concurrent-device-dispatch race the join exists
                    # to prevent.  A later request re-joins (the warm
                    # may have landed by then).
                    t.join(timeout=self.POSED_JOIN_TIMEOUT)
                    if t.is_alive():
                        raise RuntimeError(
                            "posed pipeline compile still running after "
                            f"{self.POSED_JOIN_TIMEOUT:g} s; refusing a "
                            "concurrent inline render — retry after the "
                            "background compile finishes")
        self._posed_stale = False
        pose = np.asarray([sess.view_angles], np.float64)
        out = _host(sess.render_posed(
            src, pose, render_scale=self.pose_scale))[0]
        if isinstance(self.pose_scale, int):
            pk = self._posed_pipeline_key(src)
            self._posed_warm_keys.add(pk)
            self._posed_warm_fails.pop(pk, None)  # inline compile landed
        self._last_posed = out
        return out

    def _render_screen(self, i: int, follow: bool,
                       exact: bool = False,
                       block_posed: bool = False) -> np.ndarray:
        """One frame through the live session (the shared body of
        render_png and render_gif): apply the pose track's frame-``i``
        camera when following (clamping past the end, like ``reproject
        --follow-poses``), expand u32 sources for rubix, render.

        ``exact=True`` (captures) skips the static-ray posed preview:
        every frame blocks for the exact composed build, whatever the
        lens (the /record.gif contract)."""
        sess = self.session
        if follow and self.poses is not None:
            # format without exponent notation: the console's Q_atof has
            # no 'e' syntax (faithful to the C), so '6.1e-05' would parse
            # as 6.1 — round through the same fixed-point text the
            # command carries, keeping the no-op equality check stable
            # across 20 Hz polls
            p, y, r = (float(f"{float(v):.9f}") for v in
                       self.poses[min(i, len(self.poses) - 1)])
            if sess.view_angles != (p, y, r):
                sess.cmd(f"setviewangles {p:.9f} {y:.9f} {r:.9f}")
        if not self.device_ready.is_set():
            self._maybe_retry_warm()
            # cold phase: the HOST path — never touches the device, so
            # the background warm's compiles can't stall a request and
            # the first frame costs one host gather.  Poses composed via
            # the setviewangles above; render_host's forced-numpy
            # rebuild keeps even those host-side.
            self._posed_preview = False
            return _host(sess.render_host(self.frames[i]))
        if not exact and self._posed_preview_active():
            self._posed_preview = True
            return self._render_posed_frame(i, block=block_posed)
        self._posed_preview = False
        # rubix on a u32 source: the kernel tints AFTER the gather
        # (kernels.remap.remap_gather_tint_impl) — no per-frame host
        # expansion needed
        return _host(sess.render(self.frames[i]))

    def render_png(self, i: int, follow: bool = False):
        """Render frame ``i`` through the live session -> (PNG bytes,
        one-line status)."""
        sess = self.session
        screen = self._render_screen(i, follow)
        if screen.dtype == np.uint32:  # packed-RGBA true-color output
            from blinky_tpu_torch.kernels.remap import unpack_rgb

            png = encode_png(unpack_rgb(screen))
        else:
            png = encode_png(sess.palette[screen])
        status = (f"frame {i}/{len(self.frames)}  "
                  f"{sess.width_px}x{sess.height_px}  "
                  f"f_lens {sess.lens_name}  f_globe {sess.globe_name}  "
                  f"{sess.zoom.command() or ''}")
        prog = sess.build_progress
        if prog is not None:  # exact build still landing behind the preview
            status += f"  [exact build {prog * 100:.0f}%]"
        if self._posed_preview:
            status += "  [static-ray pose]"
            if self._posed_stale:
                status += "  [compiling posed pipeline]"
        if not self.device_ready.is_set():
            status += "  [host renders: device warming]"
        return png, status

    def render_gif(self, start: int = 0, count=None, follow: bool = False,
                   delay_cs: int = 10, fast: bool = False) -> bytes:
        """Render frames ``start..start+count`` through the live session
        (current lens/globe/zoom/rubix state) into one animated GIF —
        the viewer's capture/export surface.  Lossless for the engine's
        palettized frames; true-color (u32) sources are quantized with
        one median-cut palette over the whole capture
        (``palette.quantize_rgb``).

        ``fast=True`` (``/record.gif?fast=1``) captures what the
        interactive viewer SHOWS — the static-ray posed path for
        forward-only / scalar-only lenses, previews included — instead
        of the default exact capture, whose per-pose exact composed
        build makes a followed forward-lens recording ~20 s/frame at
        1080p (PERF §6)."""
        n = len(self.frames)
        count = n if count is None else max(1, min(int(count), n))
        if fast:
            # block_posed: a cold posed-pipeline key (rubix toggled since
            # the last drag, globe switch …) must compile inline here —
            # the interactive stale-frame fallback would record N copies
            # of the pre-capture frame and the one-shot export can't
            # recover on a later poll the way the live viewer does
            shots = [self._render_screen((start + k) % n, follow,
                                         block_posed=True)
                     for k in range(count)]
            return self._encode_gif(shots, delay_cs)
        # captures are EXACT: suspend time-slicing for the whole capture
        # (follow=1 rebuilds per frame via setviewangles — each of those
        # must block to completion too, not record a partial preview),
        # and finish any already-pending build first
        budget, self.session.build_budget_s = self.session.build_budget_s, None
        try:
            _ = self.session.lensmap
            shots = [self._render_screen((start + k) % n, follow, exact=True)
                     for k in range(count)]
        finally:
            self.session.build_budget_s = budget
        return self._encode_gif(shots, delay_cs)

    def _encode_gif(self, shots, delay_cs: int) -> bytes:
        from blinky_tpu_torch.io.gif import encode_gif, encode_gif_u32

        if shots[0].dtype == np.uint32:
            return encode_gif_u32(shots, delay_cs=delay_cs)
        return encode_gif(np.stack(shots, axis=-1), self.session.palette,
                          delay_cs=delay_cs)

    def drain_console(self) -> list:
        """Console lines added since the last drain (delivered once)."""
        lines = self.session.console[self._drained:]
        self._drained = len(self.session.console)
        return lines

    def state_json(self, drain: bool = True) -> bytes:
        """Session state as JSON.  ``drain=False`` keeps the console
        cursor: draining is a mutation, so the handler only drains for
        the token-bearing page (a drive-by cross-origin GET must not
        consume console lines the real page would then miss)."""
        sess = self.session
        lines = self.drain_console() if drain else []
        return json.dumps({
            "frames": len(self.frames),
            "has_poses": self.poses is not None,
            "width": sess.width_px, "height": sess.height_px,
            "lens": sess.lens_name, "globe": sess.globe_name,
            "zoom": sess.zoom.command(),
            "device_ready": self.device_ready.is_set(),
            "device_error": self.device_error,
            "console": lines,
        }).encode()

    def start(self) -> str:
        """Serve in a daemon thread; returns the URL."""
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self.address

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
