"""The rest of the port's Session surface (blinky_tpu_torch.api) against
blinky_tpu's, with tests/test_session.py as the model: the key, config and
command-line commands, the ``fisheye 0`` plain view, ``f_saveglobe`` and
``f_dumppal``, and the small helpers that came with them.  The same command
script into ``blinky_tpu.api.Session(64, 48, backend="numpy")`` and the
port's ``Session(64, 48, device="cpu")`` gives bit-equal screens, console
lines, ``config_str`` text and file bytes (tolerance 0: all are integers or
text).  The one exception is a rotated plain view under ``backend="auto"``,
where each package takes its float32 builder: held by that builder's
boundary tolerance, 0.15 of the pixels at 64x48
(tests/test_lensmap_parity.py:96)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from blinky_tpu import camera as jcamera
from blinky_tpu import geometry as jgeometry
from blinky_tpu import globes as jglobes
from blinky_tpu.api import SHORTCUT_BINDINGS as JSHORTCUTS
from blinky_tpu.api import Session as JSession
from blinky_tpu.kernels.remap import expand_frames_tinted as jexpand
from blinky_tpu.kernels.remap import frames_to_rgba as jrgba
from blinky_tpu.kernels.remap import remap_frames as jremap_frames
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu_torch import camera, geometry, globes, lenses
from blinky_tpu_torch.api import SHORTCUT_BINDINGS, Session
from blinky_tpu_torch.kernels.remap import (
    expand_frames_tinted, frames_to_rgba, remap_frames,
)
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale


def _pair(script=(), backend="numpy", **kw):
    j = JSession(64, 48, backend=backend, **kw)
    p = Session(64, 48, device="cpu", backend=backend, **kw)
    for line in script:
        j.cmd(line)
        p.cmd(line)
    return j, p


def _frames(B, size=48, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (6, size, size) + ((B,) if B else ()), dtype=np.uint8)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _rgba_np(t):
    return t.view(torch.int32).numpy().view(np.uint32)


def _same_state(j, p):
    assert p.console == j.console
    assert p.bindings == j.bindings
    assert p.config_str() == j.config_str()
    for f in ("lens_name", "globe_name", "fisheye_enabled", "fov", "shortcutkeys_enabled",
              "aliases", "rubix_enabled"):
        assert getattr(p, f) == getattr(j, f), f
    assert p.zoom.command() == j.zoom.command()


# ------------------------------------------------------- keys and bindings

BIND_SCRIPTS = {
    "set_query": ['bind 3 "f_lens hammer"', "bind 3", "bind 4"],
    "arity": ["bind", "bind 5 f_fov 90", "bind 5", 'bind 6 "f_fov 90" extra', "bind 6"],
    "unbind": ['bind 3 "f_lens hammer"', "unbind", "unbind 3 4", "unbind 3", "bind 3",
               "unbind nosuch"],
    "unbindall": ['bind 3 "f_lens hammer"; bind x "f_globe tetra"', "unbindall", "bind x",
                  "unbindall extra"],
    "quoting": ['bind "a b" "f_lens stereographic; f_fov 200"', 'bind "a b"',
                "bind ; x", 'bind 7 "unterminated'],
    "shortcut_on_off": ["f_shortcutkeys", "bind 4", "f_shortcutkeys", "bind 1", "bind 9",
                        "f_shortcutkeys extra"],
}


@pytest.mark.parametrize("name", list(BIND_SCRIPTS))
def test_bind_unbind_unbindall(name):
    """Key_Bind_f, Key_Unbind_f, Key_Unbindall_f and cmd_shortcutkeys
    (keys.c:628-703, fisheye.c:979-1016): the same bindings, usage lines and
    config text, with their exact arity rules."""
    j, p = _pair(BIND_SCRIPTS[name])
    _same_state(j, p)


def test_shortcut_table_and_press_key():
    """f_shortcutkeys binds the preset table; press_key runs a binding (and
    nothing for an unbound key), and the screens follow."""
    assert SHORTCUT_BINDINGS == JSHORTCUTS
    j, p = _pair(["f_shortcutkeys"])
    assert p.bindings == SHORTCUT_BINDINGS
    frames = _frames(2, seed=4)
    for key in ("4", "i", "3", "p", "y", "1", "q", "9"):
        j.press_key(key)
        p.press_key(key)
        _same(p.render(frames), j.render(frames))
    assert p.lens_name == "debug" and p.globe_name == "cube"
    for s in (j, p):
        s.cmd("f_shortcutkeys")
        s.press_key("9")  # unbound again
        s.press_key("2")  # "impulse 2", a no-op
    _same_state(j, p)
    assert p.bindings["2"] == "impulse 2" and "9" not in p.bindings


# -------------------------------------------------- stuffcmds and exec

def test_stuffcmds_reapplies_cmdline(tmp_path):
    """Cmd_StuffCmds_f (cmd.c:236-296): a config that ends in ``stuffcmds``
    lets the command-line commands win; without any it does nothing."""
    cfg = tmp_path / "config.cfg"
    cfg.write_text("f_lens panini\nstuffcmds\n")
    for cmdline in (["f_lens hammer", "f_fov 150"], []):
        j, p = _pair(cmdline_cmds=cmdline)
        for s in (j, p):
            s.exec_config(cfg)
        _same_state(j, p)
        assert p.lens_name == ("hammer" if cmdline else "panini")
        frames = _frames(1, seed=5)
        _same(p.render(frames), j.render(frames))


@pytest.mark.parametrize("case", ["arity", "recursion", "self", "alias"])
def test_stuffcmds_arity_and_recursion(tmp_path, case):
    """cmd.c:253-256: extra arguments print the usage and run nothing; a
    command-line exec of a config ending in ``stuffcmds``, a ``stuffcmds``
    among the command-line commands and one behind an alias are held by the
    recursion guard."""
    rc = tmp_path / "rc.cfg"
    rc.write_text("f_lens panini\nstuffcmds\n")
    cmdline, script = {
        "arity": (["f_lens hammer"], ["stuffcmds extra", "stuffcmds"]),
        "recursion": ([f"exec {rc}", "f_lens fisheye1"], ["stuffcmds"]),
        "self": (["f_fov 120", "stuffcmds", "f_lens mercator"], ["stuffcmds", "stuffcmds"]),
        "alias": (['alias s "stuffcmds"', "s", "f_globe tetra"], ["stuffcmds", "s"]),
    }[case]
    j, p = _pair(script, cmdline_cmds=cmdline)
    _same_state(j, p)
    assert p._in_stuffcmds is False
    frames = _frames(1, seed=6)
    _same(p.render(frames), j.render(frames))


@pytest.mark.parametrize("what", ["missing", "undecodable", "directory", "good", "no_arg"])
def test_exec(tmp_path, monkeypatch, what):
    """Cmd_Exec_f: a file that is missing, undecodable or a directory prints
    ``couldn't exec`` and the console goes on; a good one runs its lines,
    ``//`` comments and unterminated quotes included."""
    monkeypatch.chdir(tmp_path)
    bad = tmp_path / "bad.cfg"
    bad.write_bytes(b"\xff\xfe\x00garbage\nf_lens panini\n")
    good = tmp_path / "good.cfg"
    good.write_text('// a comment\nf_lens hammer\nf_fov "90\nbind 3 "f_lens debug"\n')
    (tmp_path / "sub").mkdir()
    arg = {"missing": "nosuch.cfg", "undecodable": "bad.cfg", "directory": "sub",
           "good": "good.cfg", "no_arg": ""}[what]
    j, p = _pair([f"exec {arg}", "f_fov"])
    _same_state(j, p)
    if what in ("missing", "undecodable", "directory"):
        assert f"couldn't exec {arg}" in p.console
    _same(p.render(_frames(1, seed=7)), j.render(_frames(1, seed=7)))


# ---------------------------------------------------------------- f_dumppal

@pytest.mark.parametrize("palette", ["default", "reversed"])
def test_dumppal_writes_the_same_file(tmp_path, monkeypatch, palette):
    """f_dumppal writes ./palette (fisheye.c:916-931) byte for byte as
    blinky_tpu does, for the session's palette."""
    files = {}
    for name, cls, kw in (("j", JSession, dict(backend="numpy")), ("p", Session,
                                                                    dict(device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        s = cls(64, 48, **kw)
        if palette == "reversed":
            s.palette = s.palette[::-1].copy()
        s.cmd("f_dumppal")
        files[name] = (d / "palette").read_bytes()
    assert files["p"] == files["j"] and files["p"].count(b"\n") == 256


# ------------------------------------------------------------ config replay

CONFIG_SCRIPTS = {
    "defaults": [],
    "binds_fov": ['bind 3 "f_lens hammer"', "fov 120", 'alias z "f_fov 100"'],
    "shortcuts_off": ["f_shortcutkeys", "f_shortcutkeys", "fisheye 0", "fov 200"],
    "stereo_cover_grid": ["f_lens stereographic", "f_cover", "f_rubixgrid 5 3 2",
                          "f_globe tetra", "fov 45.5"],
}


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("name", list(CONFIG_SCRIPTS))
def test_config_replays_across_packages(tmp_path, name, direction):
    """A config written by either package replays into a fresh Session of
    the other, ``unbindall`` clearing a stale binding: the same state, the
    same config text and the same screens."""
    j, p = _pair(CONFIG_SCRIPTS[name])
    assert p.config_str() == j.config_str()
    cfg = tmp_path / "config.cfg"
    (j if direction == "jax_to_port" else p).write_config(cfg)
    jf = JSession(64, 48, backend="numpy", defaults=False)
    pf = Session(64, 48, device="cpu", defaults=False)
    for s in (jf, pf):
        s.cmd('bind 9 "f_lens debug"')  # cleared by the config's unbindall
        s.cmd(f"exec {cfg}")
    assert pf.config_str() == jf.config_str() == p.config_str()
    assert pf.bindings == p.bindings and "9" not in pf.bindings
    frames = _frames(2, seed=8)
    _same(pf.render(frames), jf.render(frames))
    _same(pf.render(frames), p.render(frames))


# ---------------------------------------------------------------- fisheye 0

@pytest.mark.parametrize("fov", ["90", "10", "170", "5", "500", "45.5", "nan", "-30"])
def test_plain_view_at_fov(fov):
    """fisheye 0 renders the normal rectilinear view at the ``fov`` cvar,
    clamped to 10..170 (SCR_CalcRefdef): every source kind, decode_rgb,
    render_host and one frame, bit-equal to blinky_tpu; the console query
    prints the clamped value."""
    j, p = _pair(["fisheye 0", f"fov {fov}", "fov"])
    assert p.fov == j.fov and 10.0 <= p.fov <= 170.0
    frames = _frames(3, seed=len(fov))
    _same(p.render(frames), j.render(frames))
    _same(p.render(frames, decode_rgb=True), j.render(frames, decode_rgb=True))
    _same(p.render(frames, rubix=True), j.render(frames, rubix=True))  # no rubix in the plain view
    _same(p.render(frames_to_rgba(frames, p.palette)), j.render(jrgba(frames, j.palette)))
    _same(p.render(expand_frames_tinted(frames, p.palette)),
          j.render(jexpand(frames, j.palette)))
    _same(p.render(frames[..., 1]), j.render(frames[..., 1]))
    _same(p.render_host(frames[..., 2]), j.render_host(frames[..., 2]))
    _same(p.render_host(frames[..., 2], decode_rgb=True),
          j.render_host(frames[..., 2], decode_rgb=True))
    _same_state(j, p)


def test_plain_view_is_the_rectilinear_lens():
    """The plain view is the rectilinear lens at the fov cvar on the exact
    host builder; its screens change with fov, and the lensmap of the
    fisheye view is neither built nor consulted."""
    p = Session(96, 72, device="cpu")
    frames = _frames(0, size=p.platesize, seed=9)
    p.cmd("fisheye 0")
    out = p.render(frames).numpy()
    g = globes.get("cube")
    lens = lenses.get("rectilinear", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("fov", 90), lens, 96, 72), 96, 72, p.platesize)
    _same(out, np.where(lm.valid, frames[np.clip(lm.plate, 0, 5), lm.py, lm.px], 0))
    assert p._lensmap is None  # the fisheye view was never built
    p.cmd("fov 60")
    assert (p.render(frames).numpy() != out).any()


@pytest.mark.parametrize("script", [
    ["f_globe tetra", "fisheye 0", "fov 100"],
    ["f_globe fast", "fisheye 0"],
    ["fisheye 0", "f_globe nosuch"],
    ["fisheye 0", "f_lens nosuch", "fov 120"],
    ["f_rubix", "fisheye 0", "fov 75", "f_rubix"],
], ids=["tetra", "fast", "bad_globe", "bad_lens", "rubix"])
def test_plain_view_globes_and_invalid_state(script):
    """The plain view on other globes; an invalid globe shows the
    background, an invalid fisheye lens does not matter to it."""
    j, p = _pair(script)
    frames = _frames(2, seed=len(script))
    _same(p.render(frames), j.render(frames))
    _same(p.render_host(frames[..., 0]), j.render_host(frames[..., 0]))
    _same_state(j, p)


def test_plain_view_background_palette_and_toggle():
    """The plain kernel is dropped by set_background and a palette change,
    and fisheye 1 returns to the warped view."""
    j, p = _pair(["f_globe fast", "fisheye 0", "fov 150"])
    frames = _frames(2, seed=11)
    _same(p.render(frames), j.render(frames))
    bg = np.random.default_rng(1).integers(0, 256, (48, 64), dtype=np.uint8)
    pal = p.palette[::-1].copy()
    for s in (j, p):
        s.set_background(bg)
    _same(p.render(frames), j.render(frames))
    for s in (j, p):
        s.palette = pal
    _same(p.render(frames, decode_rgb=True), j.render(frames, decode_rgb=True))
    for s in (j, p):
        s.cmd("fisheye 1")
    _same(p.render(frames), j.render(frames))
    for s in (j, p):
        s.set_size(61, 37)
        s.cmd("fisheye 0")
    small = _frames(2, size=37, seed=12)
    _same(p.render(small), j.render(small))


@pytest.mark.parametrize("angles", ["10 30 0", "-20 200 15", "89 0 45"])
def test_plain_view_rotated(angles):
    """setviewangles turns the plain view too: on the exact host builder
    (backend="numpy") bit-equal; under "auto" each package's float32
    builder, within the builder's boundary tolerance."""
    script = ["fisheye 0", "fov 100", f"setviewangles {angles}"]
    frames = _frames(2, seed=13)
    j, p = _pair(script)
    _same(p.render(frames), j.render(frames))
    _same(p.render_host(frames[..., 1]), j.render_host(frames[..., 1]))
    j, p = _pair(script, backend="auto")
    lm = p._plain_view_lensmap()
    assert isinstance(lm.flat_idx, torch.Tensor)  # the float32 device builder
    got, want = p.render(frames).numpy(), np.asarray(j.render(frames))
    assert got.shape == want.shape and float((got != want).mean()) <= 0.15
    # render_host builds the plain view on the host: exact on both sides
    _same(p.render_host(frames[..., 1]), j.render_host(frames[..., 1]))
    for s in (j, p):
        s.cmd("setviewangles")
    _same(p.render(frames), j.render(frames))


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("source", ["u8", "rgba"])
def test_plain_view_render_aa(factor, source):
    """render_aa under fisheye 0: the hi-res session replays fisheye 0 and
    the fov cvar from config_str, then K11 resolves."""
    j, p = _pair(["fisheye 0", "fov 110"])
    frames = _frames(2, seed=14)
    src = frames if source == "u8" else frames_to_rgba(frames, p.palette)
    got = p.render_aa(src, factor=factor)
    assert got.dtype == torch.uint32
    _same(_rgba_np(got), j.render_aa(src, factor=factor))


EQ = dict(pano=(32, 64), screen=(48, 36), platesize=24)


def _eq_pair(script=()):
    W, H = EQ["screen"]
    j = JSession(W, H, platesize=EQ["platesize"], backend="numpy")
    p = Session(W, H, platesize=EQ["platesize"], device="cpu")
    for line in script:
        j.cmd(line)
        p.cmd(line)
    return j, p


def _eq_panos(B, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, EQ["pano"] + (B,), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("mode", ["compact", "fused", "faces"])
def test_plain_view_render_equirect(mode):
    """render_equirect under fisheye 0 steps aside to the faces and renders
    them through the plain view; the u32 contract holds, and fisheye 1
    returns to the requested mode."""
    j, p = _eq_pair(["fisheye 0", "fov 120"])
    panos = _eq_panos(3, seed=15)
    got = p.render_equirect(panos, mode=mode)
    assert got.dtype == torch.uint32
    _same(_rgba_np(got), j.render_equirect(panos, mode=mode))
    one = panos[..., 0]
    _same(_rgba_np(p.render_equirect(one, mode=mode)), j.render_equirect(one, mode=mode))
    for s in (j, p):
        s.cmd("fisheye 1")
    _same(_rgba_np(p.render_equirect(panos, mode=mode)), j.render_equirect(panos, mode=mode))


def test_render_posed_refuses_the_plain_view():
    p = Session(64, 48, device="cpu")
    p.cmd("fisheye 0")
    with pytest.raises(ValueError, match="fisheye"):
        p.render_posed(_frames(2), np.zeros((2, 3)))


# ---------------------------------------------------------------- f_saveglobe

def _pcx_files(d):
    return {f.name: f.read_bytes() for f in sorted(Path(d).glob("*.pcx"))}


def _in_dirs(tmp_path, monkeypatch, fn):
    """Runs fn(session) for blinky_tpu's and the port's Session, each in its
    own working directory; returns both sessions and both file sets."""
    out = {}
    for name, make in (("j", lambda: JSession(64, 48, backend="numpy")),
                       ("p", lambda: Session(64, 48, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        s = make()
        res = fn(s)
        out[name] = (s, res, _pcx_files(d))
    return out["j"], out["p"]


@pytest.mark.parametrize("margins", ["", " 0", " 1", " 2abc"])
@pytest.mark.parametrize("via", ["render", "render_batch", "render_host", "render_rgba"])
def test_saveglobe(tmp_path, monkeypatch, via, margins):
    """f_saveglobe writes <name><i>.pcx for each plate at the next render,
    masked to the plate's own texels unless "full" (fisheye.c:1120-1136,
    1467-1486): the port's files equal blinky_tpu's byte for byte, through
    render (one frame, a batch's frame 0, packed RGBA's low byte) and
    render_host, with and without margins."""
    frames = _frames(3, seed=16)

    def run(s):
        s.cmd(f"f_saveglobe shot{margins}")
        if via == "render":
            return np.asarray(s.render(frames[..., 1]))
        if via == "render_batch":
            return np.asarray(s.render(frames))
        if via == "render_host":
            return np.asarray(s.render_host(frames[..., 2]))
        rgba = frames_to_rgba(frames, s.palette)
        out = s.render(rgba if isinstance(s, Session) else jrgba(frames, s.palette))
        return _rgba_np(out) if isinstance(out, torch.Tensor) else np.asarray(out)

    (js, jout, jfiles), (ps, pout, pfiles) = _in_dirs(tmp_path, monkeypatch, run)
    _same(pout, jout)
    assert len(pfiles) == 6 and pfiles == jfiles
    assert ps.console == js.console and ps.console[-1] == "Wrote shot5.pcx"
    assert ps.save_request is None


@pytest.mark.parametrize("mode", ["compact", "fused", "faces"])
def test_saveglobe_through_render_equirect(tmp_path, monkeypatch, mode):
    """A pending f_saveglobe makes render_equirect take the faces route and
    save lane 0 of the ingested u32 faces, their low byte, as blinky_tpu
    writes them; the next call returns to the requested mode."""
    W, H = EQ["screen"]
    panos = _eq_panos(2, seed=17)
    outs = {}
    for name, make in (("j", lambda: JSession(W, H, platesize=EQ["platesize"],
                                              backend="numpy")),
                       ("p", lambda: Session(W, H, platesize=EQ["platesize"],
                                             device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        s = make()
        s.cmd("f_saveglobe eq 1")
        out = s.render_equirect(panos, mode=mode)
        outs[name] = (s, _rgba_np(out) if isinstance(out, torch.Tensor) else np.asarray(out),
                      _pcx_files(d))
    (js, jout, jfiles), (ps, pout, pfiles) = outs["j"], outs["p"]
    _same(pout, jout)
    assert len(pfiles) == 6 and pfiles == jfiles and ps.console == js.console
    # the files hold the faces' low byte
    from blinky_tpu_torch.io.cubemap import load_globe_pcx

    monkeypatch.chdir(tmp_path / "p")
    back, _ = load_globe_pcx("eq", 6)
    faces = ps._equirect_cache[1](panos)
    _same(back, (_rgba_np(faces[..., 0]) & 0xFF).astype(np.uint8))
    _same(_rgba_np(ps.render_equirect(panos, mode=mode)), js.render_equirect(panos, mode=mode))


def test_saveglobe_waits_for_fisheye_and_usage(tmp_path, monkeypatch):
    """Under fisheye 0 a pending f_saveglobe stays queued (only the fisheye
    view services it); the bare command prints its usage; a long name is
    cut to 32 characters."""
    frames = _frames(1, seed=18)
    long = "n" * 40

    def run(s):
        s.cmd("f_saveglobe")
        s.cmd(f"fisheye 0; f_saveglobe {long} 1")
        s.render(frames)
        queued = s.save_request
        s.cmd("fisheye 1")
        s.render(frames)
        return queued

    (js, jq, jfiles), (ps, pq, pfiles) = _in_dirs(tmp_path, monkeypatch, run)
    assert pq == jq == ("n" * 32, 1)
    assert ps.console == js.console and pfiles == jfiles and len(pfiles) == 6


# ------------------------------------------------------------- the helpers

def test_remap_frames_equals_jax():
    g = globes.get("cube")
    lens = lenses.get("stereographic", g)
    lm = build_lensmap(lens, g, calc_scale(Zoom("fov", 200), lens, 64, 48), 64, 48, 48)
    jg = jglobes.get("cube")
    from blinky_tpu import lenses as jlenses

    jl = jlenses.get("stereographic", jg)
    jlm = jbuild(jl, jg, calc_scale(Zoom("fov", 200), lens, 64, 48), 64, 48, 48,
                 backend="numpy")
    frames = _frames(3, seed=19)
    bg = np.random.default_rng(2).integers(0, 256, (48, 64), dtype=np.uint8)
    pal = Session(64, 48, device="cpu").palette
    for kw in ({}, dict(rubix=True), dict(decode_rgb=True)):
        got = remap_frames(lm, frames, pal, bg, device="cpu", **kw)
        _same(got, jremap_frames(jlm, frames, pal, bg, **kw))


@pytest.mark.parametrize("globe", ["cube", "tetra", "trism", "fast"])
def test_plate_world_basis_equals_jax(globe):
    rng = np.random.default_rng(20)
    angles = rng.uniform(-180, 180, (5, 3))
    f, r, u = camera.angle_vectors(angles[:, 0], angles[:, 1], angles[:, 2])
    got = camera.plate_world_basis(globes.get(globe), f, r, u)
    want = jcamera.plate_world_basis(jglobes.get(globe), f, r, u)
    for a, b in zip(got, want):
        assert a.shape == (5, globes.get(globe).numplates, 3)
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("globe", ["cube", "tetra", "trism", "cube_edge"])
def test_ray_to_plate_index_and_uv_equal_jax(globe):
    """Both on NumPy float64 rays (ties included: a ray on a plate seam
    takes the first plate); the index on float32 tensors too."""
    g, jg = globes.get(globe), jglobes.get(globe)
    rng = np.random.default_rng(21)
    v = rng.normal(size=(3, 40, 7))
    v[:, 0, 0] = (1.0, 0.0, 1.0)  # on the seam of two cube plates
    v[:, 0, 1] = (0.0, 0.0, 0.0)
    x, y, z = v
    idx = geometry.ray_to_plate_index(x, y, z, g.forward)
    _same(idx, np.asarray(jgeometry.ray_to_plate_index(x, y, z, jg.forward)))
    t = [torch.from_numpy(a.astype(np.float32)) for a in v]
    _same(geometry.ray_to_plate_index(*t, g.forward).numpy(),
          np.asarray(jgeometry.ray_to_plate_index(*(a.astype(np.float32) for a in v),
                                                  jg.forward.astype(np.float32))))
    pf, pr, pu = (np.asarray(a)[idx] for a in (g.forward, g.right, g.up))
    fov = np.asarray(g.fov_rad)[idx]
    got = geometry.ray_to_plate_uv(x, y, z, pf, pr, pu, fov)
    want = jgeometry.ray_to_plate_uv(x, y, z, pf, pr, pu, fov)
    for a, b in zip(got, want):
        _same(a, np.asarray(b))
