"""Session: the console-semantics API surface.

The port of :class:`blinky_tpu.api.Session`: the ``F_Init`` defaults
(``engine/NQ/fisheye.c:668-672``), the console tokenizer and every console
command of the JAX package (the lens/globe/zoom/rubix commands,
``setviewangles``, the ``fov`` cvar, ``f_saveglobe``, ``f_dumppal``, the key
bindings and ``f_shortcutkeys``, ``stuffcmds``, ``exec``, ``alias``), the
change-driven lensmap rebuild of ``F_RenderView`` (``fisheye.c:698-811``) on
the exact float64 host builder or, for a rotated view or on request
(``backend="torch"``), on the float32 device builder, time-sliced exact
builds behind a preview (``build_budget_s``), the remap of frame batches on a
device through :class:`blinky_tpu_torch.kernels.remap.RemapKernel`, the
``fisheye 0`` plain rectilinear view, and :meth:`Session.render_posed`,
every frame at its own view rotation through
:class:`blinky_tpu_torch.kernels.static_ray.StaticRayPosedKernel`::

    sess = Session(1920, 1080)                   # panini + cube, f_fov 180, on "cuda"
    out = sess.render(frames)                    # [6, S, S, B] u8 -> [H, W, B] u8
    posed = sess.render_posed(frames, poses)     # + [B, 3] degrees -> [B, H, W] u8

The device defaults to ``"cuda"``; nothing probes and nothing falls back,
so on a machine without a card a render with the default raises.  Lens and
globe script directories (``lens_dirs``, ``globe_dirs``) hold ``.py`` and
``.lua`` drop-ins (:mod:`blinky_tpu_torch.lua_bridge`), which take every
path a built-in takes.  The 360-video path (:meth:`Session.render_equirect`)
and the supersampled render (:meth:`Session.render_aa`) run on the device
through :mod:`blinky_tpu_torch.kernels.ingest` and
:func:`blinky_tpu_torch.kernels.remap.downsample_rgba`; the sharded render
(:meth:`Session.render_sharded`) over a device mesh through
:mod:`blinky_tpu_torch.parallel`.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from blinky_tpu_torch import globes as globes_mod
from blinky_tpu_torch import lenses as lenses_mod
from blinky_tpu_torch import palette as palette_mod
from blinky_tpu_torch.budget import feasible_batch, posed_bytes_per_lane
from blinky_tpu_torch.io.cubemap import save_globe_pcx
from blinky_tpu_torch.kernels.remap import (
    RemapKernel, expanded_flat_idx, frames_tensor, frames_to_rgba, host_remap,
)
from blinky_tpu_torch.lensmap import (
    Zoom, ZoomError, build_lensmap, calc_scale, device_builder_warm,
)
from blinky_tpu_torch.utils.timing import span, spanned

HELP_TEXT = """-----------------------------
Welcome to the FISHEYE ADDON!
-> fisheye 1    (ENABLE)
-> fisheye 0    (DISABLE)

-> f_lens <tab>    (CHANGE LENS)
-> f_fov <degrees> (SET FOV)

-> f_<tab>         (MORE COMMANDS)
-----------------------------"""

# fisheye.c:984-997: the shortcut preset table
SHORTCUT_BINDINGS = {
    "1": "f_lens panini",
    "2": "f_lens stereographic",
    "3": "f_lens hammer",
    "4": "f_lens winkeltripel",
    "5": "f_lens fisheye1",
    "6": "f_lens mercator",
    "7": "f_lens quincuncial",
    "8": "f_lens cube",
    "9": "f_lens debug",
    "y": "f_globe cube",
    "u": "f_globe cube_edge",
    "i": "f_globe trism",
    "o": "f_globe tetra",
    "p": "f_globe fast",
}

_SINGLE_CHARS = "{})(':"  # common/common.c:1063 — NQ splits these alone

_DECODE_CHUNK = 1 << 26  # u8 pixels a palette decode on the device takes at once


def _c_is_space(ch: str) -> bool:
    """C's ``*data <= ' '`` with a SIGNED char: control chars and every
    byte >= 0x80 (negative as signed char) count as whitespace."""
    o = ord(ch)
    return o <= 32 or o >= 128


def com_parse(data: str, pos: int):
    """``COM_Parse`` transliterated (``common/common.c:1066-1141``, the
    NQ arm: ``split_single_chars`` true).  Returns ``(token, new_pos)``;
    token None = end of data.  Semantics the console depends on: ``//``
    and ``/* */`` comments skip, ``"..."`` strings run to the closing
    quote or end WITHOUT escape processing, the ``{})(':`` characters
    split as single-char tokens, words end at whitespace or a single
    char, tokens cap at 1023 chars (``com_tokenbuf``)."""
    n = len(data)
    while True:
        # NUL is hard end-of-data (common.c:1080), not skippable space
        while pos < n and _c_is_space(data[pos]):
            if data[pos] == "\0":
                return None, pos
            pos += 1
        if pos >= n:
            return None, pos
        c = data[pos]
        if c == "/" and pos + 1 < n and data[pos + 1] == "/":
            while pos < n and data[pos] not in ("\n", "\0"):
                pos += 1
            continue
        if c == "/" and pos + 1 < n and data[pos + 1] == "*":
            pos += 2
            while (pos < n and data[pos] != "\0"
                   and not (data[pos] == "*" and pos + 1 < n
                            and data[pos + 1] == "/")):
                pos += 1
            if pos < n and data[pos] != "\0":
                pos += 2
            continue
        break
    buf = []
    if c == '"':
        pos += 1
        while pos < n:
            c = data[pos]
            if c == "\0":  # ends the token, NUL not consumed (common.c:1104-1110)
                break
            pos += 1
            if c == '"':
                break
            if len(buf) < 1023:
                buf.append(c)
        return "".join(buf), pos
    if c in _SINGLE_CHARS:
        return c, pos + 1
    while True:
        if len(buf) < 1023:
            buf.append(data[pos])
        pos += 1
        if pos >= n:
            break
        c = data[pos]
        if c in _SINGLE_CHARS:
            break
        if _c_is_space(c):
            break
    return "".join(buf), pos


def tokenize_console(line: str) -> list:
    """``Cmd_TokenizeString`` (``common/cmd.c:531-571``): whitespace
    (sans newline) skipped between tokens, a newline ends the command,
    80-arg cap."""
    argv = []
    pos, n = 0, len(line)
    while True:
        # `while (*text && *text <= ' ' && *text != '\n')` — NUL stops
        # the skip, and `if (!*text) return` ends the command (cmd.c:545-551)
        while (pos < n and line[pos] not in ("\n", "\0")
               and _c_is_space(line[pos])):
            pos += 1
        if pos >= n or line[pos] == "\n" or line[pos] == "\0":
            break
        tok, pos = com_parse(line, pos)
        if tok is None:
            break
        if len(argv) < 80:
            argv.append(tok)
    return argv


def split_console_lines(text: str) -> list:
    """``Cbuf_Execute``'s line splitter (``common/cmd.c:181-210``):
    ``"`` counts quotes, an UNQUOTED ``;`` breaks, ``\\n`` breaks
    regardless (each scan restarts its quote count), and the extracted
    line is capped at ``sizeof(line)`` = 1024: an unbroken run caps at
    1023 chars with byte 1023 consumed as the pseudo-terminator
    (``if (i == sizeof(line)) i--``, cmd.c:189-196)."""
    parts = []
    pos, remaining = 0, len(text)
    while remaining:
        quotes = 0
        maxlen = min(remaining, 1024)
        ln = 0
        while ln < maxlen:
            ch = text[pos + ln]
            if ch == '"':
                quotes += 1
            if not (quotes & 1) and ch == ";":
                break
            if ch == "\n":
                break
            ln += 1
        if ln == 1024:
            ln -= 1
        parts.append(text[pos:pos + ln])
        if ln == remaining:
            remaining = 0
        else:
            ln += 1  # skip the terminator (or the dropped cap byte)
            remaining -= ln
            pos += ln
    return parts


def _c_char(ch: str) -> int:
    """A byte as C's SIGNED char (the ``'c`` constant path reads it)."""
    o = ord(ch)
    return o - 256 if o >= 128 else o


def _atof(s: str) -> float:
    """``Q_atof`` transcription (``common/common.c:252-315``): optional
    ``-``, ``0x`` hex, ``'c`` char constant, else digits with a single
    honored ``.`` — parsing stops at the first other character, so
    "nan"/"inf" parse to 0 and "9e99" to 9.  The C computes in double but
    RETURNS float: the final f32 truncation is part of the contract."""
    i, sign = 0, 1.0
    if s.startswith("-"):
        sign, i = -1.0, 1
    t = s[i:]

    def f32(v):
        with np.errstate(over="ignore"):  # overlong digit runs hit f32 inf
            return float(np.float32(v))

    if t[:1] == "0" and t[1:2] in ("x", "X"):
        val = 0.0
        for ch in t[2:]:
            d = "0123456789abcdef".find(ch.lower())
            if d < 0:
                break
            val = val * 16 + d
        return f32(val * sign)
    if t[:1] == "'":
        return f32(sign * _c_char(t[1])) if len(t) > 1 else 0.0
    val = 0.0
    decimal = -1
    total = 0
    for ch in t:
        if ch == ".":
            decimal = total
            continue
        if not "0" <= ch <= "9":
            break
        val = val * 10 + (ord(ch) - 48)
        total += 1
    if decimal == -1:
        return f32(val * sign)
    while total > decimal:
        val /= 10
        total -= 1
    return f32(val * sign)


def _c_int(v: float) -> int:
    """C ``(int)`` cast of a float (the ``(int)Q_atof(...)`` console
    sites, e.g. ``cmd_fov`` ``fisheye.c:1043``): truncation toward zero;
    NaN/±inf/out-of-int32-range produce INT_MIN (x86 ``cvttsd2si``)."""
    if v != v or v == float("inf") or v == float("-inf"):
        return -0x80000000
    t = int(v)
    if not -0x80000000 <= t <= 0x7FFFFFFF:
        return -0x80000000
    return t


def _i32(v: int) -> int:
    """C ``int`` wraparound: ``Q_atoi`` accumulates in a 32-bit int, so
    overlong digit strings wrap (e.g. "9999999999" -> 1410065407)."""
    v &= 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _atoi(s: str) -> int:
    """``Q_atoi`` transcription (``common/common.c:200-249``): the same
    grammar integer-only ("2abc" parses to 2, "abc" to 0) — the
    ``fisheye`` toggle's parse (``cmd_fisheye``, ``fisheye.c:975``)."""
    i, sign = 0, 1
    if s.startswith("-"):
        sign, i = -1, 1
    t = s[i:]
    if t[:1] == "0" and t[1:2] in ("x", "X"):
        val = 0
        for ch in t[2:]:
            d = "0123456789abcdef".find(ch.lower())
            if d < 0:
                break
            val = _i32(val * 16 + d)
        return _i32(val * sign)
    if t[:1] == "'":
        return sign * _c_char(t[1]) if len(t) > 1 else 0
    val = 0
    for ch in t:
        if not "0" <= ch <= "9":
            break
        val = _i32(val * 10 + (ord(ch) - 48))
    return _i32(val * sign)


class Session:
    """The console state of one view: lens, globe, zoom and rubix, a
    lensmap rebuilt lazily on change, and the kernels that render frame
    batches on *device* (``torch.device`` or its name, ``"cuda"`` unless
    the caller asks for another).

    *backend* picks the lensmap builder.  ``"auto"`` (the default): static
    builds (no view rotation) use the exact float64 host builder, so
    :attr:`lensmap` bit-equals the reference, while a pose-tracked view
    (``setviewangles``) switches to the float32 builder on the device,
    whose rebuilds cost milliseconds.  ``"numpy"`` / ``"torch"`` force one
    path.  A lens or globe that does not evaluate on tensors (a ``.lua``
    script that needs per-lane control, ``jittable`` False) builds on the
    exact host path under every backend.

    *lens_dirs* and *globe_dirs*: directories searched, in order, for a
    ``<name>.py`` then a ``<name>.lua`` drop-in when ``f_lens`` /
    ``f_globe`` names no built-in.

    *build_budget_s*: seconds of exact-build work per render call (the
    reference's time-sliced builder, ``fisheye.c:306-322``; an interactive
    host sets about 1/60).  None, the default, blocks until the exact
    table is built.  *cmdline_cmds*: the command-line commands that
    ``stuffcmds`` runs again.
    """

    def __init__(
        self,
        width: int,
        height: int,
        platesize: Optional[int] = None,
        palette: Optional[np.ndarray] = None,
        *,
        device="cuda",
        backend: str = "auto",
        echo: bool = False,
        defaults: bool = True,
        lens_dirs=(),
        globe_dirs=(),
        build_budget_s: Optional[float] = None,
        cmdline_cmds=(),
    ):
        if backend not in ("auto", "numpy", "torch"):
            raise ValueError(f"unknown lensmap backend {backend!r}: "
                             "expected 'auto', 'numpy' or 'torch'")
        self.device = torch.device(device)
        self.backend = backend
        self.lens_dirs = [Path(p) for p in lens_dirs]
        self.globe_dirs = [Path(p) for p in globe_dirs]
        self._lens_cache: dict = {}  # (name or path, globe generation, mtime) -> LensDef
        self._globe_gen = 0  # bumped at every globe load
        self.width_px = int(width)
        self.height_px = int(height)
        self.platesize = int(platesize) if platesize else min(width, height)
        self._kernel = None
        self._plain_cache = None  # (key, RemapKernel) of the fisheye-0 view
        self._plain_lm_cache = None  # (key, its lensmap)
        self._palette_gen = 0
        self._aa_cache = None  # {state: hi-res Session}, at most 4
        self._equirect_cache = None  # (key, EquirectIngest)
        self._equirect_fused = None  # {key: (composed chain, its RemapKernel)}
        self.palette = palette if palette is not None else palette_mod.default_palette()
        self.echo = echo
        self.console: list = []
        self.cmdline_cmds = list(cmdline_cmds)
        self._in_stuffcmds = False

        self.fisheye_enabled = False
        self.fov = 90.0  # the engine "fov" cvar (scr_fov, NQ/view.c:116)
        self.view_angles = None  # (pitch, yaw, roll) deg, None = identity
        self.shortcutkeys_enabled = False
        self.bindings: dict = {}
        self.aliases: dict = {}  # name -> command string (common/cmd.c:373)
        self._alias_depth = 0  # bounds self-referential alias expansion
        self.lens_name = ""
        self.lens = None
        self.lens_valid = False
        self.globe_name = ""
        self.globe = None
        self.globe_valid = False
        self.zoom = Zoom("none")
        self.rubix_enabled = False  # fisheye.c:647
        self.rubix_numcells = 10
        self.rubix_cell_size = 4.0
        self.rubix_pad_size = 1.0
        self.save_request = None  # (name, with_margins) of a pending f_saveglobe

        self._changed = True
        self._lensmap = None
        self._lensmap_np = None  # the table as NumPy arrays, made on request
        self._lensmap_meta = None  # (lens, globe, view_is_identity)
        self._background = None
        self._background_gen = 0
        # time-sliced exact builds: seconds of build work a render call
        self.build_budget_s = build_budget_s
        self._pending_build = None  # the ProgressiveHostBuild in flight
        self._preview_is_partial = False  # the preview is its partial table
        self._posed_cache = None  # (key, StaticRayPosedKernel)
        self._posed_scale = None  # ((zoom, lens, width, height), zoom scale)
        self._posed_cap = None  # ((key, planes), batch cap)
        self._posed_async = None  # the one background table build
        self._posed_async_fail = None  # (key, failures, error)
        self._ray_tables = None  # (generation, {render_scale: RayTable})
        self._auto_scale_probes = None  # (key, (t21, t81, t2h, k_hi))

        self._commands = {
            "fov": self._cmd_plainfov,
            "fisheye": self._cmd_fisheye,
            "f_help": self._cmd_help,
            "f_lens": self._cmd_lens,
            "f_globe": self._cmd_globe,
            "f_fov": self._cmd_fov,
            "f_vfov": self._cmd_vfov,
            "f_cover": self._cmd_cover,
            "f_contain": self._cmd_contain,
            "f_rubix": self._cmd_rubix,
            "f_rubixgrid": self._cmd_rubixgrid,
            "f_saveglobe": self._cmd_saveglobe,
            "f_dumppal": self._cmd_dumppal,
            "f_shortcutkeys": self._cmd_shortcutkeys,
            "impulse": lambda argv: None,  # game-sim command: no-op here
            "stuffcmds": self._cmd_stuffcmds,
            "setviewangles": self._cmd_setviewangles,
            "bind": self._cmd_bind,
            "unbind": self._cmd_unbind,
            "unbindall": self._cmd_unbindall,
            "exec": self._cmd_exec,
            "alias": self._cmd_alias,
            "echo": self._cmd_echo,
            # Cmd_Wait_f defers the rest of the buffer to the next frame
            # (common/cmd.c:119-130); with no frame loop here every
            # command runs to completion, so wait is a no-op
            "wait": lambda argv: None,
        }
        if defaults:
            # F_Init defaults, fisheye.c:668-672.
            for c in (
                "fisheye 1",
                "f_globe cube",
                "f_lens panini",
                "f_fov 180",
                "f_rubixgrid 10 4 1",
            ):
                self.cmd(c)

    # ------------------------------------------------------------------ io
    def _print(self, msg: str) -> None:
        self.console.append(msg)
        if self.echo:
            print(msg)

    # ------------------------------------------------------- command layer
    def cmd(self, line: str) -> None:
        """Execute one console command line (the ``Cbuf_Execute`` ->
        ``Cmd_ExecuteString`` path): :func:`split_console_lines`, then
        :func:`tokenize_console` per command."""
        for part in split_console_lines(line):
            argv = tokenize_console(part)
            if not argv:
                continue
            handler = self._commands.get(argv[0])
            if handler is None:
                # aliases expand only after real commands miss
                # (Cmd_ExecuteString order, common/cmd.c:758-775)
                value = self.aliases.get(argv[0])
                if value is not None:
                    # Cbuf_InsertText(a->value): the alias body replaces
                    # the whole line; args after the alias name drop.
                    # The reference's Cbuf would spin forever on a
                    # self-referential alias — bound the depth instead.
                    if self._alias_depth >= 16:
                        self._print(f'alias loop through "{argv[0]}"')
                        continue
                    self._alias_depth += 1
                    try:
                        self.cmd(value)
                    finally:
                        self._alias_depth -= 1
                    continue
                self._print(f'Unknown command "{argv[0]}"')
                continue
            handler(argv)

    def _cmd_fisheye(self, argv):
        if len(argv) < 2:
            self._print("Currently: ")
            self._print(f"fisheye {int(self.fisheye_enabled)}")
            self._print("\nTry F_HELP for more options and commands.")
            return
        # fisheye_enabled = Q_atoi(Cmd_Argv(1)) — "will return 0 if not
        # valid" (cmd_fisheye, fisheye.c:975); "2abc" is truthy there
        self.fisheye_enabled = bool(_atoi(argv[1]))

    def _cmd_plainfov(self, argv):
        """The engine ``fov`` cvar: horizontal FOV of the normal
        (fisheye-off) view, clamped to 10..170 (``SCR_CalcRefdef``,
        ``common/screen.c:589-592``)."""
        if len(argv) < 2:
            self._print(f'"fov" is "{self.fov:g}"')
            return
        self.fov = min(170.0, max(10.0, _atof(argv[1])))

    def _cmd_setviewangles(self, argv):
        """Rotate the view within recorded plates: ``setviewangles <pitch>
        <yaw> <roll>`` (degrees).  The reference gets viewangles from game
        input and re-renders the plates (``F_RenderView``,
        ``fisheye.c:750``); with recorded cubemaps the rotation composes
        into the lensmap instead.  ``setviewangles`` with no args resets."""
        if len(argv) < 4:
            self.view_angles = None
        else:
            self.view_angles = (_atof(argv[1]), _atof(argv[2]), _atof(argv[3]))
        self._changed = True

    def _jittable(self) -> bool:
        """Device builds need both the lens map and the globe's plate
        resolver to evaluate on tensors (decided at load, lua_bridge)."""
        return (getattr(self.lens, "jittable", True)
                and getattr(self.globe, "jittable", True))

    def _resolved_backend(self) -> str:
        """See the backend policy in the class's note."""
        if self.backend == "auto":
            # a rotated view takes the device builder; a lens or globe that
            # does not evaluate on tensors takes the host builder, which
            # composes the view basis too (build_lensmap routes it, as it
            # routes a forward lens to the host rasterizer)
            return "torch" if self.view_angles is not None and self._jittable() else "numpy"
        return self.backend

    def _view_basis(self):
        if self.view_angles is None:
            return None
        from blinky_tpu_torch.camera import view_basis_from_angles

        return view_basis_from_angles(*self.view_angles)

    def _cmd_help(self, argv):
        self._print(HELP_TEXT)

    def _cmd_lens(self, argv):
        if len(argv) < 2:
            self._print("f_lens <name>: use a new lens")
            self._print(f"Currently: {self.lens_name}")
            return
        self._changed = True
        self.lens_name = argv[1]
        self._print(f"f_lens {self.lens_name}")
        self.lens_valid = self._load_lens()
        if not self.lens_valid:
            self.lens_name = ""
            self._print("not a valid lens")
            return
        if self.lens.onload:
            self.cmd(self.lens.onload)
            self._print(f"; {self.lens.onload}")

    def _cmd_globe(self, argv):
        if len(argv) < 2:
            self._print("f_globe <name>: use a new globe")
            self._print(f"Currently: {self.globe_name}")
            return
        self._changed = True
        self.globe_name = argv[1]
        self._print(f"f_globe {self.globe_name}")
        self.globe_valid = self._load_globe()
        if not self.globe_valid:
            self.globe_name = ""
            self._print("not a valid globe")

    def _cmd_fov(self, argv):
        if len(argv) < 2:
            self._print("f_fov <degrees>: set horizontal FOV")
            self._print(f"Zoom currently: {self.zoom.command() or 'none'}")
            return
        self.zoom = Zoom("fov", _c_int(_atof(argv[1])))
        self._changed = True

    def _cmd_vfov(self, argv):
        if len(argv) < 2:
            self._print("f_vfov <degrees>: set vertical FOV")
            self._print(f"Zoom currently: {self.zoom.command() or 'none'}")
            return
        self.zoom = Zoom("vfov", _c_int(_atof(argv[1])))
        self._changed = True

    def _cmd_cover(self, argv):
        self.zoom = Zoom("cover")
        self._changed = True

    def _cmd_contain(self, argv):
        self.zoom = Zoom("contain")
        self._changed = True

    def _cmd_rubix(self, argv):
        self.rubix_enabled = not self.rubix_enabled
        self._print(f"Rubix is {'ON' if self.rubix_enabled else 'OFF'}")

    def _cmd_rubixgrid(self, argv):
        if len(argv) == 4:
            self.rubix_numcells = _c_int(_atof(argv[1]))
            self.rubix_cell_size = _atof(argv[2])
            self.rubix_pad_size = _atof(argv[3])
            self._changed = True  # need to recompute lens to update grid
        else:
            self._print("RubixGrid <numcells> <cellsize> <padsize>")
            self._print(f"   numcells (default 10) = {self.rubix_numcells}")
            self._print(f"   cellsize (default  4) = {self.rubix_cell_size:f}")
            self._print(f"   padsize  (default  1) = {self.rubix_pad_size:f}")

    def _cmd_saveglobe(self, argv):
        """``f_saveglobe <name> [full]``: queue a screenshot of the globe
        plates, written by the next render of a frame
        (``cmd_saveglobe``, ``fisheye.c:1120-1136``)."""
        if len(argv) < 2:
            self._print("f_saveglobe <name> [full flag=0]: screenshot the globe plates")
            return
        # with_margins = Q_atoi(Cmd_Argv(2)), fisheye.c:1130
        with_margins = _atoi(argv[2]) if len(argv) >= 3 else 0
        self.save_request = (argv[1][:32], with_margins)

    def _cmd_dumppal(self, argv):
        """``f_dumppal``: write the palette as text to ``./palette``
        (``fisheye.c:916-931``)."""
        Path("palette").write_text(palette_mod.save_dumppal(self.palette))

    def _cmd_shortcutkeys(self, argv):
        """``cmd_shortcutkeys`` (``fisheye.c:979-1016``): toggle the preset
        bindings of keys 1-9 (lenses) and Y, U, I, O, P (globes)."""
        self.shortcutkeys_enabled = not self.shortcutkeys_enabled
        if self.shortcutkeys_enabled:
            self._print("Enabled Fisheye shortcut keys: 1-9 = Lenses, Y,U,I,O,P = Globes")
            for key, command in SHORTCUT_BINDINGS.items():
                self.bindings[key] = command
        else:
            self._print("Disabled Fisheye shortcut keys")
            for key in "12345678":
                self.bindings[key] = f"impulse {key}"
            for key in ("9", "y", "u", "i", "o", "p"):
                self.bindings.pop(key, None)

    def _cmd_bind(self, argv):
        """``Key_Bind_f`` (``common/keys.c:661-703``): exactly ``bind <key>``
        (query) or ``bind <key> <command>`` (set; one quoted token, the
        reference rejects argc > 3)."""
        if len(argv) not in (2, 3):
            self._print("bind <key> [command] : attach a command to a key")
            return
        if len(argv) == 2:
            if argv[1] in self.bindings:
                self._print(f'"{argv[1]}" = "{self.bindings[argv[1]]}"')
            else:
                self._print(f'"{argv[1]}" is not bound')
            return
        self.bindings[argv[1]] = argv[2]

    def _cmd_unbind(self, argv):
        """``Key_Unbind_f`` (``common/keys.c:628-644``)."""
        if len(argv) != 2:
            self._print("unbind <key> : remove commands from a key")
            return
        self.bindings.pop(argv[1], None)

    def _cmd_unbindall(self, argv):
        """``Key_Unbindall_f`` (``common/keys.c:647-656``): clear every
        binding, the first line of an engine-written config."""
        self.bindings.clear()

    def _cmd_stuffcmds(self, argv):
        """``Cmd_StuffCmds_f`` (``common/cmd.c:236-296``): run the
        command-line commands again, so that a config ending in
        ``stuffcmds`` lets them win over its own settings (quake.rc's
        order: exec defaults, exec config.cfg, stuffcmds)."""
        if len(argv) != 1:
            # common/cmd.c:253-256: usage, nothing executed
            self._print("stuffcmds : execute command line parameters")
            return
        if self._in_stuffcmds:
            # the C engine consumes the command line through a one-shot
            # buffer; here a command-line exec of a config that ends in
            # stuffcmds would recurse for ever
            self._print("stuffcmds: ignoring recursive call")
            return
        self._in_stuffcmds = True
        try:
            for c in self.cmdline_cmds:
                self.cmd(c)
        finally:
            self._in_stuffcmds = False

    def _cmd_exec(self, argv):
        """``Cmd_Exec_f``: run a config file; one that cannot be read or
        decoded prints ``couldn't exec`` and the console goes on
        (``common/cmd.c:325``)."""
        if len(argv) >= 2:
            try:
                self.exec_config(argv[1])
            except (OSError, UnicodeDecodeError):
                self._print(f"couldn't exec {argv[1]}")

    def press_key(self, key: str) -> None:
        """Run the command bound to *key* (the shortcut-key surface)."""
        if key in self.bindings:
            self.cmd(self.bindings[key])

    def _cmd_alias(self, argv):
        """``Cmd_Alias_f`` (``common/cmd.c:373-432``): no args lists the
        aliases; else ``alias <name> <value...>`` stores argv[2:] joined
        with single spaces."""
        if len(argv) == 1:
            self._print("Current alias commands:")
            for name, value in self.aliases.items():
                self._print(f"{name} : {value}")
            return
        name = argv[1]
        if len(name) >= 32:  # MAX_ALIAS_NAME, common/cmd.c:42
            self._print("Alias name is too long")
            return
        self.aliases[name] = " ".join(argv[2:])

    def _cmd_echo(self, argv):
        """``Cmd_Echo_f`` (``common/cmd.c:343-350``)."""
        self._print(" ".join(argv[1:]))

    # ------------------------------------------------------ lens/globe load
    def _load_lens(self) -> bool:
        """Load the active lens for the current globe (``LUA_load_lens``
        semantics: the metadata is re-evaluated per globe,
        ``fisheye.c:734-737``): a built-in, else ``<name>.py`` then
        ``<name>.lua`` in the lens directories.  An unknown name is not a
        valid lens.

        As in the JAX package, a reload is observable only when the globe
        or the script changed, so the loaded ``LensDef`` is cached on
        (name or path, globe generation, script mtime): a zoom or pose
        change reuses it (a ``.lua`` drop-in's reload is a script run).  The
        cache holds every lens visited (at most 64); an evicted lens's
        ``release`` unwinds its parked coroutines unless it is still in use."""
        try:
            cache = self._lens_cache

            def _hit(key, load):
                lens = cache.get(key)
                if lens is None:
                    lens = load()
                    if len(cache) >= 64:
                        evicted = cache.pop(next(iter(cache)))
                        rel = getattr(evicted, "release", None)
                        pend = self._posed_async
                        pend_lens = pend["key"][0] if pend is not None else None
                        if (rel is not None and evicted is not self.lens
                                and evicted is not pend_lens):
                            rel()
                    cache[key] = lens
                self.lens = lens
                return True

            ggen = self._globe_gen
            if self.lens_name in lenses_mod.BUILTIN_LENSES:
                return _hit((self.lens_name, ggen, None),
                            lambda: lenses_mod.get(self.lens_name, self.globe))
            for d in self.lens_dirs:
                for ext in (".py", ".lua"):  # .lua = reference drop-ins
                    p = d / f"{self.lens_name}{ext}"
                    if p.exists():
                        return _hit((str(p), ggen, p.stat().st_mtime_ns),
                                    lambda: lenses_mod.load_lens_module(p, self.globe))
        except Exception as e:  # loader diagnostics, fisheye.c:1671-1677
            self._print(f"could not load lens: {e}")
        return False

    def _load_globe(self) -> bool:
        try:
            if self.globe_name in globes_mod.names():
                self.globe = globes_mod.get(self.globe_name)
                self._globe_gen += 1
                return True
            for d in self.globe_dirs:
                for ext in (".py", ".lua"):
                    p = d / f"{self.globe_name}{ext}"
                    if p.exists():
                        self.globe = globes_mod.load_globe_module(p)
                        self._globe_gen += 1
                        return True
        except Exception as e:
            self._print(f"could not load globe: {e}")
        return False

    # -------------------------------------------------------- completion
    def complete_lens(self, prefix: str = "") -> list:
        """Tab-completion analog (``cmdarg_lens`` -> ``COM_ScanDir``,
        ``fisheye.c:1106-1118``): built-ins plus user script dirs."""
        names = set(lenses_mod.names())
        for d in self.lens_dirs:
            names.update(p.stem for p in d.glob("*.py"))
            names.update(p.stem for p in d.glob("*.lua"))
        return sorted(n for n in names if n.startswith(prefix))

    def complete_globe(self, prefix: str = "") -> list:
        names = set(globes_mod.names())
        for d in self.globe_dirs:
            names.update(p.stem for p in d.glob("*.py"))
            names.update(p.stem for p in d.glob("*.lua"))
        return sorted(n for n in names if n.startswith(prefix))

    # ------------------------------------------------------------ pipeline
    def _rebuild(self) -> None:
        """Change-driven lensmap rebuild (``F_RenderView``,
        ``fisheye.c:730-746``): reload the lens (its metadata may depend on
        the globe), re-solve the zoom, rebuild the gather table on the
        builder the backend policy picks, with the view rotation composed
        in.  A float32 build leaves its tables on the session's device,
        where the remap kernel takes them without a trip through the
        host.

        With :attr:`build_budget_s` set and an exact host build ahead, the
        build is time-sliced (the reference's resumable builder,
        ``fisheye.c:306-322``): a preview is installed now, the float32
        device build when the lens evaluates on tensors and its builder is
        warm on this device, else the growing partial table, and each
        render advances the exact build by the budget until it swaps in,
        bit-identical to the blocking build."""
        self._lensmap = None
        self._lensmap_np = None
        self._lensmap_meta = None
        self._kernel = None
        self._pending_build = None
        self._preview_is_partial = False
        if not (self.lens_valid and self.globe_valid):
            self._changed = False
            return
        self.lens_valid = self._load_lens()
        if not self.lens_valid:
            self.lens_name = ""
            self._print("not a valid lens")
            self._changed = False
            return
        try:
            scale = calc_scale(self.zoom, self.lens, self.width_px, self.height_px)
        except ZoomError as e:
            self._print(str(e))
            self._changed = False
            return
        backend = self._resolved_backend()
        # what the table is built FROM, recorded now rather than inferred
        # later: consumers that need an identity-view table at a known scale
        # check this, not the session's mutable state (a pending
        # setviewangles must not hide a reusable earlier build)
        self._lensmap_meta = (self.lens, self.globe, self._view_basis() is None)
        if (self.build_budget_s is not None and backend == "numpy"
                and self.lens.map_type == "inverse"):
            from blinky_tpu_torch.lensmap.progressive import ProgressiveHostBuild

            pb = ProgressiveHostBuild(
                self.lens, self.globe, scale, self.width_px, self.height_px,
                self.platesize, numcells=self.rubix_numcells,
                cell_size=self.rubix_cell_size, pad_size=self.rubix_pad_size,
                view_basis=self._view_basis())
            self._pending_build = pb
            if self._jittable() and device_builder_warm(
                    self.lens, self.globe, self.width_px, self.height_px,
                    self.platesize, device=self.device):
                # the float32 device preview, milliseconds once warm; a
                # cold builder would stall on its first run, so a cold lens
                # paints the growing partial table instead
                backend = "torch"
            else:
                pb.step(self.build_budget_s)  # the first slice right away
                self._lensmap = pb.partial()
                self._preview_is_partial = True
                self._changed = False
                return
        self._lensmap = build_lensmap(
            self.lens,
            self.globe,
            scale,
            self.width_px,
            self.height_px,
            self.platesize,
            numcells=self.rubix_numcells,
            cell_size=self.rubix_cell_size,
            pad_size=self.rubix_pad_size,
            backend=backend,
            view_basis=self._view_basis(),
            device=self.device,
        )
        self._changed = False

    def _advance_build(self, budget_s=None) -> None:
        """One time slice of a pending exact build (``resume_lensmap``,
        ``fisheye.c:744-746,2074``); swaps the exact table in when it lands.
        ``budget_s=None`` finishes the build."""
        pb = self._pending_build
        if pb is None:
            return
        pb.step(float("inf") if budget_s is None else budget_s)
        if pb.done:
            self._lensmap = pb.result()
            self._pending_build = None
            self._preview_is_partial = False
        elif self._preview_is_partial:
            self._lensmap = pb.partial()  # pixels appear
        else:
            return
        self._lensmap_np = None
        self._kernel = None

    @property
    def build_progress(self):
        """Exact-build progress 0..1 while a time-sliced build is pending,
        else None."""
        pb = self._pending_build
        return None if pb is None else pb.progress

    def warm_device_builder(self) -> bool:
        """Run the float32 device builder for the active lens and globe at
        this session's shapes now (the kernels' build and the device's first
        allocations), so the first interactive pose change does not stall on
        them.  Returns True if a device builder is now warm (an
        inverse-mapped lens; forward lenses have no device builder)."""
        if not (self.lens_valid and self.globe_valid):
            return False
        self.lens_valid = self._load_lens()
        if not (self.lens_valid and self._jittable() and self.lens.map_type == "inverse"):
            return False
        try:
            scale = calc_scale(self.zoom, self.lens, self.width_px, self.height_px)
        except ZoomError:
            scale = 1.0  # any scale: the builder takes it as a value
        build_lensmap(
            self.lens, self.globe, scale, self.width_px, self.height_px,
            self.platesize, numcells=self.rubix_numcells,
            cell_size=self.rubix_cell_size, pad_size=self.rubix_pad_size,
            backend="torch", view_basis=self._view_basis(), device=self.device,
        )
        return True

    @property
    def lensmap(self):
        """The current lensmap with NumPy arrays (a float32 build's tables
        are copied from the device once a build).  A pending time-sliced
        build is finished first: this is the exact table."""
        if self._changed or self._lensmap is None:
            self._rebuild()
        self._advance_build(budget_s=None)
        return self._lensmap_numpy()

    def _lensmap_numpy(self):
        lm = self._lensmap
        if lm is None or not isinstance(lm.flat_idx, torch.Tensor):
            return lm
        if self._lensmap_np is None:
            self._lensmap_np = lm.to_numpy()
        return self._lensmap_np

    @property
    def palette(self) -> np.ndarray:
        return self._palette

    @palette.setter
    def palette(self, pal) -> None:
        # the remap kernel bakes the palette's LUTs in at construction
        self._palette = np.asarray(pal, dtype=np.uint8)
        # a generation counter, not id(): a freed array's id can be reused
        self._palette_gen += 1
        self._kernel = None
        self._plain_cache = None
        self._posed_cache = None  # its RGBA background decodes the palette
        self._aa_cache = None  # hi-res sessions bake the palette in
        self._rgba_lut = None  # the palette's RGBA LUT on the device

    def set_background(self, background) -> None:
        """Set the underlay shown where the lensmap is unmapped (the
        reference's ``Draw_TileClear`` tile, ``fisheye.c:802``)."""
        self._background = np.asarray(background, dtype=np.uint8)
        # a generation counter, not id(): a freed array's id can be reused
        self._background_gen += 1
        self._kernel = None  # rebuilt lazily in render() from the lensmap
        self._plain_cache = None
        self._posed_cache = None

    def set_size(self, width: int, height: int, platesize: Optional[int] = None) -> None:
        self.width_px = int(width)
        self.height_px = int(height)
        self.platesize = int(platesize) if platesize else min(width, height)
        if self._background is not None and self._background.shape[:2] != (
                self.height_px, self.width_px):
            # a screen-sized underlay can't survive a resize (the reference
            # re-tiles its background per frame, fisheye.c:802)
            self._background = None
            self._background_gen += 1
        self._changed = True  # sizechange, fisheye.c:709

    def _sync_platesize(self, frames) -> None:
        S = frames.shape[1]
        if S != self.platesize:
            self.platesize = S
            self._changed = True

    def _background_np(self) -> np.ndarray:
        if self._background is None:
            return np.zeros((self.height_px, self.width_px), np.uint8)
        return self._background

    def _background_screen(self, frames):
        """The background on the device, one screen a frame of *frames*."""
        bg = torch.from_numpy(self._background_np()).to(self.device)
        if frames.ndim == 4:
            return bg[..., None].expand(-1, -1, frames.shape[-1])
        return bg

    def _service_save(self, frames) -> None:
        """Write a pending ``f_saveglobe`` from frame 0 of *frames* (the
        frame itself when there is one), copied to the host; packed-RGBA
        plates write their low byte, as ``blinky_tpu`` writes them."""
        if self.save_request is None:
            return
        name, with_margins = self.save_request
        self.save_request = None
        fr = frames if frames.ndim == 3 else frames[..., 0]
        if isinstance(fr, torch.Tensor):
            fr = (fr.view(torch.int32).cpu().numpy().view(np.uint32)
                  if fr.dtype == torch.uint32 else fr.cpu().numpy())
        for p in save_globe_pcx(name, fr, self.globe, self.palette, bool(with_margins)):
            self._print(f"Wrote {p}")

    @spanned("session.render")
    def render(self, frames, rubix: Optional[bool] = None, decode_rgb: bool = False):
        """Remap a cubemap frame ([P, S, S]) or batch ([P, S, S, B]), a
        NumPy array or a tensor, through the current lensmap on the
        session's device.  Returns a tensor there: [H, W] / [H, W, B] u8
        (u32 for packed-RGBA frames, RGB [..., 3] with ``decode_rgb``).
        Returns the background when the current lens/zoom is invalid (the
        reference keeps running and shows the cleared screen).

        Under ``fisheye 0`` the frames go through the plain rectilinear
        view at the ``fov`` cvar, without rubix (V_RenderView's non-fisheye
        branch, ``NQ/view.c:947-952``); the warped lensmap is neither built
        nor consulted, and a pending ``f_saveglobe`` stays queued until
        fisheye is on again, as in the reference, where only
        ``F_RenderView`` services it.  A pending time-sliced build advances
        by one budget slice a call."""
        if not hasattr(frames, "ndim"):
            frames = np.asarray(frames)
        self._sync_platesize(frames)
        if not self.fisheye_enabled:
            kernel = self._plain_view_kernel()
            if kernel is None:
                return self._background_screen(frames)
            return kernel(frames, rubix=False, decode_rgb=decode_rgb)
        if self._changed or self._lensmap is None:
            self._rebuild()
        self._advance_build(budget_s=self.build_budget_s)
        lm = self._lensmap
        self._service_save(frames)
        if lm is None:
            return self._background_screen(frames)
        if self._kernel is None:  # e.g. invalidated by set_background
            self._kernel = RemapKernel(lm, self.palette, self._background,
                                       device=self.device)
        rubix = self.rubix_enabled if rubix is None else rubix
        return self._kernel(frames, rubix=rubix, decode_rgb=decode_rgb)

    def render_sharded(self, frames, mesh, rubix=None, decode_rgb: bool = False):
        """:meth:`render` over a device mesh
        (:func:`blinky_tpu_torch.parallel.make_mesh`, or
        :func:`~blinky_tpu_torch.parallel.make_slice_mesh` for two levels):
        the frame batch splits on B over the mesh's data axes, the lensmap
        rows over "space", and every device gathers locally
        (:func:`blinky_tpu_torch.parallel.remap_sharded`).  Bit-equal to
        :meth:`render` on the same table; returns a
        :class:`~blinky_tpu_torch.parallel.ShardedArray`.  Uses the exact
        lensmap: a pending time-sliced build is finished first (a sharded
        batch is offline throughput work, not the interactive preview)."""
        from blinky_tpu_torch.parallel import remap_sharded

        if not hasattr(frames, "ndim"):
            frames = np.asarray(frames)
        self._sync_platesize(frames)
        if not self.fisheye_enabled:
            raise ValueError("render_sharded needs fisheye enabled "
                             "(the plain view is single-device)")
        if self._changed or self._lensmap is None:
            self._rebuild()
        if self.lensmap is None:  # the property finishes a pending sliced build
            raise ValueError("no valid lensmap (check lens/zoom state)")
        if self._kernel is None:
            self._kernel = RemapKernel(self._lensmap, self.palette, self._background,
                                       device=self.device)
        rubix = self.rubix_enabled if rubix is None else rubix
        return remap_sharded(self._kernel, frames, mesh, rubix=rubix,
                             decode_rgb=decode_rgb)

    def render_host(self, frames, rubix=None, decode_rgb: bool = False):
        """Render ONE [P, S, S] NumPy frame entirely on the host, with
        :func:`blinky_tpu_torch.kernels.remap.host_remap`, which is
        bit-equal to the device remap on the same table.  It runs
        :meth:`render`'s state machine (the plain view, a rebuild on
        change, one budget slice of a pending build, ``f_saveglobe``) with
        the host builder."""
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError("render_host takes one [P, S, S] frame")
        self._sync_platesize(frames)
        # host-side only: even a setviewangles rebuild takes the host builder
        saved_backend, self.backend = self.backend, "numpy"
        try:
            if not self.fisheye_enabled:
                plain = self._plain_view_lensmap()
                if plain is None:
                    return self._background_np()
                return host_remap(plain, frames, self.palette, self._background,
                                  rubix=False, decode_rgb=decode_rgb)
            if self._changed or self._lensmap is None:
                self._rebuild()
            self._advance_build(budget_s=self.build_budget_s)
        finally:
            self.backend = saved_backend
        lm = self._lensmap_numpy()
        self._service_save(frames)
        if lm is None:
            return self._background_np()
        rubix = self.rubix_enabled if rubix is None else rubix
        return host_remap(lm, frames, self.palette, self._background,
                          rubix=rubix, decode_rgb=decode_rgb)

    def _plain_view_lensmap(self):
        """The lensmap of the normal (fisheye-off) rectilinear view at the
        ``fov`` cvar, from the current globe's plates, on the builder the
        backend policy picks (a rotated view: the float32 device builder);
        cached per (fov, size, plate size, globe, view angles, backend)."""
        if not self.globe_valid:
            return None
        backend = self._resolved_backend()
        key = (self.fov, self.width_px, self.height_px, self.platesize,
               self.globe, self.view_angles, backend)
        if self._plain_lm_cache is not None and self._plain_lm_cache[0] == key:
            return self._plain_lm_cache[1]
        try:
            lens = lenses_mod.get("rectilinear", self.globe)
            scale = calc_scale(Zoom("fov", self.fov), lens, self.width_px, self.height_px)
            lm = build_lensmap(
                lens, self.globe, scale, self.width_px, self.height_px,
                self.platesize, backend=backend, view_basis=self._view_basis(),
                device=self.device)
        except Exception as e:  # the plain view's diagnostics, as blinky_tpu prints them
            self._print(f"plain view unavailable: {e}")
            return None
        self._plain_lm_cache = (key, lm)
        return lm

    def _plain_view_kernel(self):
        """The remap kernel over :meth:`_plain_view_lensmap`, cached with it
        and dropped by a palette or background change."""
        lm = self._plain_view_lensmap()
        if lm is None:
            return None
        key = self._plain_lm_cache[0]
        if self._plain_cache is None or self._plain_cache[0] != key:
            self._plain_cache = (key, RemapKernel(lm, self.palette, self._background,
                                                  device=self.device))
        return self._plain_cache[1]

    # ------------------------------------------------------ true colour
    def _rgba_screen(self, screen):
        """A render's output as packed RGBA: a u8 screen (the background of
        an invalid lens) is decoded through the session palette on the
        device, a ``torch.uint32`` one passes."""
        if screen.dtype == torch.uint32:
            return screen
        if self._rgba_lut is None or self._rgba_lut.device != screen.device:
            lut = palette_mod.rgba_lut(self.palette).view(np.int32)
            self._rgba_lut = torch.from_numpy(lut).to(screen.device)
        # in pieces, so the int32 copy of the indices stays small beside the
        # output (a whole batch of plates would double it)
        flat = screen.reshape(-1)
        out = torch.empty(flat.shape, dtype=torch.int32, device=screen.device)
        for lo in range(0, flat.numel(), _DECODE_CHUNK):
            torch.index_select(self._rgba_lut, 0, flat[lo:lo + _DECODE_CHUNK].int(),
                               out=out[lo:lo + _DECODE_CHUNK])
        return out.view(screen.shape).view(torch.uint32)

    @spanned("session.render_aa")
    def render_aa(self, frames, factor: int = 2, rubix: Optional[bool] = None):
        """Supersampled (anti-aliased) true-color rendering.

        Renders through a lensmap built at ``factor`` times the session size
        and box-averages back down on the device
        (:func:`blinky_tpu_torch.kernels.remap.downsample_rgba`, K11): an
        extension: the reference's software renderer is aliased by nature
        (one palette index per pixel), but true-color output can resolve
        the lens distortions' edge aliasing properly.

        ``frames``: u8 palette plates (decoded via the session palette),
        packed-RGBA u32 plates, or either one's expanded raw||tinted
        layout for rubix; a NumPy array or a tensor (one on the session's
        device is decoded and rendered there).  Returns a [H, W(, B)]
        ``torch.uint32`` tensor on the session's device.

        The hi-res session mirrors this session's state (config replay +
        view angles); its lensmap build is cached per (state, factor), at
        most four at a time.
        """
        from blinky_tpu_torch.kernels.remap import downsample_rgba

        factor = int(factor)
        if factor < 1:
            raise ValueError("factor must be >= 1")
        if not hasattr(frames, "ndim"):
            frames = np.asarray(frames)
        if not _is_rgba(frames):
            if isinstance(frames, torch.Tensor):
                with span("aa.decode"):
                    frames = self._rgba_screen(frames.to(torch.uint8))
            else:
                frames = frames_to_rgba(frames, self.palette)
        rubix = self.rubix_enabled if rubix is None else bool(rubix)
        if rubix and frames.shape[0] != 2 * palette_mod.MAX_PLATES:
            raise ValueError(
                "rubix AA needs the expanded raw||tinted layout "
                "(expand_frames_tinted[_rgba])")

        S = int(frames.shape[1])  # the frames' actual plate size (render
        # syncs self.platesize from it lazily; key on S so differing
        # sources get their own hi-res session instead of thrashing one)
        state = (self.config_str(), self.view_angles, self.width_px,
                 self.height_px, S, self._palette_gen, self._background_gen,
                 factor)
        if self._aa_cache is None:
            self._aa_cache = {}
        cache = self._aa_cache
        hi_sess = cache.get(state)
        if hi_sess is None:
            hi_sess = Session(self.width_px * factor, self.height_px * factor,
                              platesize=S, palette=self.palette,
                              device=self.device, backend=self.backend,
                              lens_dirs=self.lens_dirs, globe_dirs=self.globe_dirs)
            for line in self.config_str().splitlines():
                hi_sess.cmd(line)
            if self.view_angles is not None:
                hi_sess.cmd("setviewangles %s %s %s" % self.view_angles)
            if self._background is not None:
                # Nearest-neighbor upscale: each source background pixel
                # covers a factor x factor block, so the box downsample
                # hands it back unchanged where the lens leaves gaps.
                hi_sess.set_background(np.repeat(
                    np.repeat(self._background, factor, 0), factor, 1))
            while len(cache) >= 4:  # hi-res sessions hold big tables
                cache.pop(next(iter(cache)))
            cache[state] = hi_sess
        hi = self._rgba_screen(hi_sess.render(frames, rubix=rubix))
        return downsample_rgba(hi, factor) if factor > 1 else hi

    @spanned("session.render_equirect")
    def render_equirect(self, panos, bilinear: bool = True,
                        mode: str = "compact"):
        """Warp equirectangular panoramas end-to-end on the device.

        ``panos``: [H, W, B] packed-RGBA uint32 (batch-innermost), one
        [H, W] u32 pano, or one [H, W, 3] u8 RGB pano; a NumPy array, or a
        ``torch.uint32`` tensor, which is used where it lies (one on the
        session's device never visits the host).  Resamples to the current
        globe's plates at the session platesize and remaps through the
        current lens.  Returns a [H_out, W_out, B] ``torch.uint32`` tensor on
        the session's device ([H_out, W_out] for a single pano), as
        :meth:`render` does; ``blinky_tpu``'s method returns a NumPy array.

        ``mode`` picks the pipeline formulation; all three are bit-equal:

        * ``"compact"`` (default): texel-compacted two-stage: resample
          ONLY the sorted unique texels the lensmap references (K10), then
          the compacted remap (K1)
          (:class:`~blinky_tpu_torch.kernels.ingest.CompactEquirectChain`).
        * ``"fused"``: the ingest's K-tap tables composed THROUGH the
          lensmap: ONE gather+blend (K10), no faces intermediate
          (:class:`~blinky_tpu_torch.kernels.ingest.EquirectScreenKernel`).
        * ``"faces"``: full two-stage via the materialized
          ``[P, S, S, B]`` faces (K10, then :meth:`render`'s K1), which
          feeds SEVERAL lenses from one ingest.

        compact/fused step aside to "faces" whenever the materialized
        faces are needed: ``fisheye 0`` (the plain view renders them), an
        invalid lens or zoom (the background shows), a pending
        ``f_saveglobe`` (it saves the ingested faces' lane 0) or a pending
        time-sliced build (the preview table changes under a composed chain
        every slice).
        """
        from blinky_tpu_torch.kernels.ingest import (
            CompactEquirectChain, EquirectIngest, EquirectScreenKernel,
        )
        from blinky_tpu_torch.kernels.remap import pack_rgba

        if mode not in ("compact", "fused", "faces"):
            raise ValueError(f"mode must be compact|fused|faces, got {mode!r}")

        squeeze = False
        if (not isinstance(panos, torch.Tensor) and getattr(panos, "ndim", 0) == 3
                and panos.shape[2] == 3 and np.asarray(panos).dtype == np.uint8):
            panos = pack_rgba(np.asarray(panos))
        if getattr(panos, "ndim", 0) == 2:
            panos = (panos if isinstance(panos, torch.Tensor)
                     else np.asarray(panos, np.uint32))[..., None]
            squeeze = True
        key = (tuple(panos.shape[:2]), self.platesize, self.globe,
               bool(bilinear))
        if self._equirect_cache is None or self._equirect_cache[0] != key:
            kern = EquirectIngest(panos.shape[0], panos.shape[1],
                                  self.platesize, globe=self.globe,
                                  bilinear=bilinear, device=self.device)
            self._equirect_cache = (key, kern)
        ingest = self._equirect_cache[1]

        if mode != "faces" and self.fisheye_enabled and self.save_request is None:
            # the rebuild sequence render() runs before gathering, but not
            # the time slice: with a build pending this falls through to the
            # faces, whose render() advances the one slice
            if self._changed or self._lensmap is None:
                self._rebuild()
            if (self._lensmap is not None and self._pending_build is None
                    and self._kernel is None):
                self._kernel = RemapKernel(self._lensmap, self.palette,
                                           self._background, device=self.device)
            if (self._kernel is not None and self._pending_build is None
                    and self._lensmap.platesize == self.platesize):
                fkey = (key, bool(bilinear), mode)
                # a small dict, not a single slot: alternating compact/fused
                # (mode comparisons, a faces caller in between) keeps BOTH
                # composed chains warm instead of re-running compact_texels
                # and the table composition per switch.  Validity includes
                # the RemapKernel IDENTITY (held strongly, so `is` cannot
                # alias a freed object): any lens/zoom/background/palette
                # change makes a new kernel, and stale-kernel entries are
                # dropped so dead generations can't pin device tables
                if self._equirect_fused is None:
                    self._equirect_fused = {}
                fcache = self._equirect_fused
                ent = fcache.get(fkey)
                if ent is None or ent[1] is not self._kernel:
                    for k in [k for k, v in fcache.items()
                              if v[1] is not self._kernel]:
                        fcache.pop(k)
                    while len(fcache) >= 4:  # composed tables live on the
                        # device: bound the live generation too
                        fcache.pop(next(iter(fcache)))
                    cls = (CompactEquirectChain if mode == "compact"
                           else EquirectScreenKernel)
                    ent = (cls(ingest, self._kernel), self._kernel)
                    fcache[fkey] = ent
                out = ent[0](panos, rubix=self.rubix_enabled)
                return out[..., 0] if squeeze else out

        faces = ingest(panos)  # [P, S, S, B] u32 on the device
        # rubix on the u32 faces: the remap kernel tints AFTER the gather,
        # so the face batch is not expanded on the device.  An invalid lens
        # returns the u8 palette background: decode it so the u32 contract
        # holds.  The plain view of fisheye 0 renders the faces too
        out = self._rgba_screen(self.render(faces))
        return out[..., 0] if squeeze else out

    # ------------------------------------------------------------- config
    def config_str(self) -> str:
        """``Host_WriteConfiguration`` (``NQ/host.c:272-291``): the key binds
        (``Key_WriteBindings``, which leads with ``unbindall`` so that a
        replay starts clean, ``keys.c:715-724``), the aliases (an extension:
        the reference loses them on restart), the ``fov`` cvar, then the
        fisheye state block (``F_WriteConfig``, ``fisheye.c:683-696``); the
        lines of ``blinky_tpu``'s, in its order."""
        lines = ["unbindall"]
        lines += [f'bind "{k}" "{v}"' for k, v in self.bindings.items()]
        lines += [f'alias "{n}" "{v}"' for n, v in self.aliases.items()]
        lines += [
            f"fov {self.fov:g}",
            f"fisheye {int(self.fisheye_enabled)}",
            f'f_lens "{self.lens_name}"',
            f'f_globe "{self.globe_name}"',
            f"f_rubixgrid {self.rubix_numcells} {self.rubix_cell_size:f} {self.rubix_pad_size:f}",
        ]
        zc = self.zoom.command()
        if zc:
            lines.append(zc)
        return "\n".join(lines) + "\n"

    def write_config(self, path) -> None:
        Path(path).write_text(self.config_str())

    def exec_config(self, path) -> None:
        for line in Path(path).read_text().splitlines():
            line = line.strip()
            if line and not line.startswith("//"):
                self.cmd(line)

    # ---------------------------------------------------------------- posed
    @spanned("session.render_posed")
    def render_posed(self, frames, poses, render_scale=1,
                     target_fps: float = 60.0, exact: bool = False,
                     block: bool = True):
        """Per-frame-pose playback: every frame gets its own view rotation.

        ``frames``: [P, S, S, B] (u8 plates, the expanded [12, ...] rubix
        layout, or packed RGBA u32), a NumPy array or a tensor; ``poses``:
        [B, 3] (pitch, yaw, roll) degrees or precomputed [B, 3, 3] bases.
        Bases given as a float32 tensor on the session's device are used in
        place, so a caller that makes a track's bases once on the card
        pays no upload a call (the exact and auto routes copy them to the
        host).
        Returns a [B, H, W] tensor on the session's device (``torch.uint32``
        for RGBA).  Rubix rides the source: an expanded source renders
        tinted, a raw one untinted; the ``f_rubix`` flag is not consulted.

        The path is the static-ray recomposition
        (:mod:`blinky_tpu_torch.kernels.static_ray`): one camera-ray table
        per (lens, zoom, size), then per pose a lens-free rotate, plate
        resolve and gather, fused in one CUDA kernel on a card.  A
        forward-only lens's table holds the texel-centre rays of its host
        rasterization at the build grid (at render_scale k, ``W/k`` by
        ``H/k`` with the zoom scale times k); the session's static lensmap
        seeds it at k = 1.

        ``render_scale`` k > 1 builds at 1/k of the screen and
        nearest-upsamples, with the full-resolution background.
        ``render_scale="auto"`` probes the pipeline on this device (cached
        per lens, size and source kind), fits ``d + B(c + b/k²)`` and takes
        the smallest k predicted to sustain *target_fps* at this batch.

        ``exact=True`` builds every pose's lensmap on the exact float64
        host path instead (the table a static render at those angles
        uses; a forward-only lens rasterizes each pose's basis), then
        gathers all poses in one launch of
        :func:`blinky_tpu_torch.kernels.posed.gather_posed`.  A globe whose
        plate resolver does not evaluate on tensors (a scalar-only ``.lua``
        ``globe_plate``) always takes this route, as in the JAX package; a
        lens that does not builds its ray table on the host.

        ``block=False`` makes a first call for a new (lens, zoom, size,
        scale) return at once: the table builds on a background thread
        while the call renders a coarser-scale preview of the same poses.
        :attr:`posed_pending` says when the build is done; the next call
        swaps it in.  A failed build re-raises on the next call, and after
        three failures on one key the error sticks.  ``exact=True``
        ignores ``block``.
        """
        from blinky_tpu_torch.kernels.posed import (
            bases_from_pose_track, check_render_scale,
        )
        from blinky_tpu_torch.lensmap.builder import plate_resolver_mode

        if not (self.fisheye_enabled and self.lens_valid and self.globe_valid):
            raise ValueError("render_posed needs fisheye enabled and a valid lens/globe")
        if not hasattr(frames, "ndim"):
            frames = np.asarray(frames)
        if frames.ndim != 4:
            raise ValueError("render_posed takes a frame batch [P, S, S, B]")
        S = frames.shape[1]
        if isinstance(poses, torch.Tensor) and poses.ndim == 3:
            # bases given as a tensor stay where they lie: bases made once
            # on the card cost a call no upload and no wait for the card
            bases = poses
        else:
            poses = np.asarray(poses, dtype=np.float64)
            bases = poses if poses.ndim == 3 else bases_from_pose_track(poses)
        # the zoom is re-solved only when what it depends on was replaced
        # (Zoom and lenses are immutable)
        zkey = (self.zoom, self.lens, self.width_px, self.height_px)
        if self._posed_scale is None or self._posed_scale[0] != zkey:
            self._posed_scale = (zkey, calc_scale(*zkey))
        scale = self._posed_scale[1]
        B = frames.shape[-1]
        if bases.shape != (B, 3, 3):
            raise ValueError(f"bases must be [B={B}, 3, 3], got {bases.shape}")
        is_rgba = _is_rgba(frames)
        if B == 0:
            # nothing to build or gather, but bad arguments still fail
            if render_scale != "auto":
                check_render_scale(self.width_px, self.height_px, int(render_scale))
            return torch.empty((0, self.height_px, self.width_px),
                               dtype=torch.uint32 if is_rgba else torch.uint8,
                               device=self.device)
        if not getattr(self.globe, "jittable", True):
            # the per-pose plate resolve needs the resolver on tensors: a
            # scalar-only script globe resolves on the exact host path
            exact = True
        if isinstance(bases, torch.Tensor) and (exact or render_scale == "auto"):
            bases = bases.detach().cpu().numpy().astype(np.float64)  # host paths
        if render_scale == "auto":
            render_scale = 1 if exact else self._auto_render_scale(
                frames, bases, scale, float(target_fps))
        k = int(render_scale)
        if exact:
            return self._render_posed_exact(frames, bases, scale, k)
        key = (self.lens, self.globe, scale, self.width_px, self.height_px, S,
               self.rubix_numcells, self.rubix_cell_size, self.rubix_pad_size,
               self._background_gen, is_rgba, k)
        # a batch larger than the device holds splits; every chunk reuses
        # the same kernel.  Free memory is read again only for a new key or
        # a batch above the cap last read
        ckey = (key, frames.shape[0])
        if self._posed_cap is None or self._posed_cap[0] != ckey or B > self._posed_cap[1]:
            script = plate_resolver_mode(self.globe) == "script"
            self._posed_cap = (ckey, feasible_batch(posed_bytes_per_lane(
                S, frames.shape[0], self.width_px, self.height_px, rgba=is_rgba,
                script=script), 0, device=self.device))
        cap = self._posed_cap[1]
        if B > cap:
            return torch.cat([
                self.render_posed(frames[..., i:i + cap], bases[i:i + cap],
                                  render_scale=k, block=block)
                for i in range(0, B, cap)])
        if self._posed_cache is None or self._posed_cache[0] != key:
            tables = self._ray_table_stash(scale, S)
            if block:
                kernel = self._posed_kernel(scale, S, k, is_rgba, tables)
                tables[k] = kernel.ray_table
            else:
                kernel = self._posed_async_kernel(key, scale, S, k, is_rgba, tables)
                if kernel is None:
                    # the build is in flight: a coarse preview, whose kernel
                    # caches under its own key
                    pk = self._posed_preview_scale(k)
                    if pk is not None:
                        return self.render_posed(frames, bases, render_scale=pk)
                    kernel = self._posed_async_join(key, scale, S, k, is_rgba, tables)
            self._posed_cache = (key, kernel)
        return self._posed_cache[1](frames, bases)

    @property
    def posed_pending(self) -> bool:
        """True while a ``render_posed(block=False)`` background table
        build is still running (previews are being served)."""
        pend = self._posed_async
        return bool(pend is not None and pend["thread"].is_alive())

    def _posed_kernel(self, scale, S, k, is_rgba, tables):
        from blinky_tpu_torch.kernels.static_ray import StaticRayPosedKernel

        return StaticRayPosedKernel(
            self.lens, self.globe, self.width_px, self.height_px, scale,
            platesize=S, numcells=self.rubix_numcells,
            cell_size=self.rubix_cell_size, pad_size=self.rubix_pad_size,
            background=self._posed_background(is_rgba), render_scale=k,
            ray_table=tables.get(k),
            lensmap=self._reusable_static_lensmap(scale, S, k),
            device=self.device)

    def _posed_preview_scale(self, render_scale):
        """The coarsest valid render_scale above the requested one: the
        preview's resolution while the native table builds."""
        from blinky_tpu_torch.kernels.posed import check_render_scale

        for k in (4, 3, 2):
            if k <= int(render_scale):
                break
            try:
                check_render_scale(self.width_px, self.height_px, k)
                return k
            except ValueError:
                continue
        return None

    def _posed_async_kernel(self, key, scale, S, render_scale, is_rgba, tables):
        """The finished kernel when the background build for *key* has
        landed, else start that build (once) and return None.  One async
        slot per session: while a build for a stale key runs, none other
        starts.  A failed build re-raises here, and after three failures
        on one key the error re-raises with no new build."""
        import threading

        pend = self._posed_async
        if pend is not None and pend["key"] == key:
            if pend["thread"].is_alive():
                return None
            self._posed_async = None
            if pend["error"] is not None:
                last = self._posed_async_fail
                n = last[1] + 1 if (last and last[0] == key) else 1
                self._posed_async_fail = (key, n, pend["error"])
                raise pend["error"]
            self._posed_async_fail = None
            kernel = pend["result"]
            tables[render_scale] = kernel.ray_table
            return kernel
        if pend is not None:
            if pend["thread"].is_alive():
                return None
            self._posed_async = None
        last = self._posed_async_fail
        if last is not None and last[0] == key and last[1] >= 3:
            raise last[2]
        holder = {"key": key, "result": None, "error": None}

        def build():
            try:
                holder["result"] = self._posed_kernel(scale, S, render_scale,
                                                      is_rgba, tables)
            except BaseException as e:  # re-raised on the caller's thread
                holder["error"] = e

        holder["thread"] = threading.Thread(target=build, name="posed-table-build",
                                            daemon=True)
        self._posed_async = holder
        holder["thread"].start()
        return None

    def _posed_async_join(self, key, scale, S, render_scale, is_rgba, tables):
        """Block until the build for *key* lands and return its kernel; a
        build for a stale key in flight is joined first, never run beside
        ours."""
        while True:
            kernel = self._posed_async_kernel(key, scale, S, render_scale,
                                              is_rgba, tables)
            if kernel is not None:
                return kernel
            self._posed_async["thread"].join()

    def _ray_table_stash(self, scale, platesize):
        """``{render_scale: RayTable}`` for the current (lens, globe, zoom,
        size) generation, shared by the auto-scale probes and the real
        kernel; one generation only, replaced on any change (the tables
        live on the device)."""
        gen = (self.lens, self.globe, float(scale), self.width_px,
               self.height_px, platesize)
        if self._ray_tables is None or self._ray_tables[0] != gen:
            self._ray_tables = (gen, {})
        return self._ray_tables[1]

    def _reusable_static_lensmap(self, scale, platesize, render_scale):
        """The session's built static lensmap when it can seed a ray table:
        finished (no pending time-sliced build, no partial preview), built
        from this lens and globe with no view rotation composed in
        (``_lensmap_meta``), at this size, plate size and zoom scale, for a
        full-resolution posed grid."""
        lm, meta = self._lensmap, self._lensmap_meta
        if (lm is None or meta is None or render_scale != 1
                or self._pending_build is not None or self._preview_is_partial):
            return None
        if not (meta[0] is self.lens and meta[1] is self.globe and meta[2]):
            return None
        if (lm.width_px, lm.height_px, lm.platesize) != (
                self.width_px, self.height_px, platesize):
            return None
        return lm if lm.scale == float(scale) else None

    def _auto_render_scale(self, frames, bases, scale, target_fps):
        """Dynamic resolution: time the posed pipeline at (B=2, k=1),
        (B=8, k=1) and (B=2, k=max), the best of two runs each, fit
        ``chunk_cost(B, k) = d + B(c + b/k²)`` and return the smallest
        valid k whose predicted per-pose cost at this batch meets
        *target_fps*.  The probes are cached per (lens, globe, size, source
        kind, rubix grid, background); their tables land in the ray-table
        stash for the real kernel."""
        import time

        from blinky_tpu_torch.kernels.posed import check_render_scale

        S, B = frames.shape[1], frames.shape[-1]
        is_rgba = _is_rgba(frames)
        candidates = []
        for k in (1, 2, 3, 4, 6, 8):
            try:
                check_render_scale(self.width_px, self.height_px, k)
            except ValueError:
                continue
            candidates.append(k)
        if len(candidates) < 2:
            return candidates[0] if candidates else 1
        key = (self.lens, self.globe, self.width_px, self.height_px, S, is_rgba,
               self.rubix_numcells, self.rubix_cell_size, self.rubix_pad_size,
               self._background_gen)
        if self._auto_scale_probes is not None and self._auto_scale_probes[0] == key:
            t21, t81, t2h, k_hi = self._auto_scale_probes[1]
        else:
            k_hi = candidates[-1]
            first, _ = frames_tensor(frames[..., :1])
            first = first.to(self.device)
            base_b = np.ascontiguousarray(bases[:1]).astype(np.float32)
            pf = {n: first.repeat(1, 1, 1, n) for n in (2, 8)}
            if is_rgba:
                pf = {n: f.view(torch.uint32) for n, f in pf.items()}
            pb = {n: np.repeat(base_b, n, axis=0) for n in (2, 8)}
            tables = self._ray_table_stash(scale, S)
            on_card = self.device.type == "cuda"

            def probe(n, k):
                kernel = self._posed_kernel(scale, S, k, is_rgba, tables)
                tables[k] = kernel.ray_table
                best = np.inf
                for i in range(3):  # a warm-up, then the best of two
                    t0 = time.perf_counter()
                    kernel(pf[n], pb[n])
                    if on_card:
                        torch.cuda.synchronize(self.device)
                    if i:
                        best = min(best, time.perf_counter() - t0)
                return best  # seconds a chunk

            t21, t81, t2h = probe(2, 1), probe(8, 1), probe(2, k_hi)
            self._auto_scale_probes = (key, (t21, t81, t2h, k_hi))
        cb = max(0.0, (t81 - t21) / 6.0)  # c + b: a pose at k=1
        d = max(0.0, t21 - 2.0 * cb)  # a call's floor
        b = min(max(0.0, (t21 - t2h) / (2.0 * (1.0 - 1.0 / (k_hi * k_hi)))), cb)
        c = cb - b
        budget = 1.0 / target_fps if target_fps > 0 else np.inf
        for k in candidates:
            if d / B + c + b / (k * k) <= budget:
                return k
        return candidates[-1]

    def _posed_background(self, is_rgba):
        """The posed screens' background: the session's (or zeros),
        decoded through the session palette for RGBA sources."""
        bg = self._background_np()
        return frames_to_rgba(bg, self.palette) if is_rgba else bg

    def _render_posed_exact(self, frames, bases, scale, k):
        """``render_posed(exact=True)``: one float64 host build per pose,
        with the pose's basis composed in (the table a static render at
        those angles uses), then every pose's gather in one launch of
        :func:`blinky_tpu_torch.kernels.posed.gather_posed`, which
        nearest-upsamples by *k* under the upsampled validity mask."""
        from blinky_tpu_torch.kernels.posed import (
            check_render_scale, gather_posed, prep_posed_inputs,
        )
        from blinky_tpu_torch.kernels.static_ray import background_tensor

        check_render_scale(self.width_px, self.height_px, k)
        W, H = self.width_px // k, self.height_px // k
        S = frames.shape[1]
        is_rgba = _is_rgba(frames)
        bg = background_tensor(self._posed_background(is_rgba), self.height_px,
                               self.width_px, self.device)
        src, _, expanded = prep_posed_inputs(frames, bases, S, bg, self.device)
        idx = np.empty((len(bases), H, W), np.int32)
        valid = np.empty((len(bases), H, W), bool)
        for b, basis in enumerate(np.asarray(bases, np.float64)):
            lm = build_lensmap(
                self.lens, self.globe, scale * k, W, H, S,
                numcells=self.rubix_numcells, cell_size=self.rubix_cell_size,
                pad_size=self.rubix_pad_size, backend="numpy",
                view_basis=(basis[0], basis[1], basis[2]))
            # rubix rides the source: the expanded layout's tinted half
            idx[b] = expanded_flat_idx(lm) if expanded else lm.flat_idx
            valid[b] = lm.valid
        out = gather_posed(src, torch.from_numpy(idx).to(self.device),
                           torch.from_numpy(valid).to(self.device), bg, k)
        return out.view(torch.uint32) if is_rgba else out


def _is_rgba(frames) -> bool:
    """Whether *frames* (NumPy or tensor) hold packed RGBA words."""
    if isinstance(frames, torch.Tensor):
        return frames.dtype == torch.uint32
    return frames.dtype == np.uint32
