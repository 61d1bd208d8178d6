"""The port's Lua bridge (blinky_tpu_torch.lua_bridge) against blinky_tpu's.

On the four drop-ins of ``blinky_tpu_torch/bench/lua_drop_ins.py``
(``lpanini``, ``lnewton`` and ``scat`` lenses, the ``lfast`` globe) at
64x48 with 32-pixel plates:

* the exact host builds of each script equal ``blinky_tpu``'s builds of the
  same script bit for bit, and the transcriptions (``lpanini``, ``lfast``)
  equal the built-in panini and fast on every backend;
* the float32 builds on tensors (``backend="torch"``, on the CPU through
  K8's plain version) lie within the reference's float32 boundary tolerance
  of ``blinky_tpu``'s ``backend="jax"`` builds (at most 0.15 of the pixels,
  ``px``/``py`` within one texel where both chose the same plate);
* ``jittable`` ("evaluates on tensors") is decided as ``blinky_tpu``
  decides it, for every script, and a scalar-only script routes to the
  exact host path;
* the Session with ``lens_dirs`` / ``globe_dirs`` and the completion
  lists equal ``blinky_tpu``'s; ``render_posed`` on the script globe lies
  within the posed path's Session tolerance (0.02 of the pixels,
  ``tests/test_torch_posed.py``) of the JAX package's; the zoom sweep on
  it equals its per-step loop bit for bit;
* the host paths are thread-safe and ``release`` unwinds parked
  coroutines, as ``tests/test_lua_bridge.py`` holds the JAX bridge;
* the bridge imports neither jax nor blinky_tpu.
"""

import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blinky_tpu import globes as jglobes
from blinky_tpu import lenses as jlenses
from blinky_tpu.api import Session as JSession
from blinky_tpu.lensmap import Zoom as JZoom
from blinky_tpu.lensmap import build_lensmap as jbuild
from blinky_tpu.lensmap import calc_scale as jcalc
from blinky_tpu.lua_bridge import load_lua_globe as jload_globe
from blinky_tpu.lua_bridge import load_lua_lens as jload_lens
from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import lua_drop_ins
from blinky_tpu_torch.io.cubemap import synthetic_cubemap, synthetic_cubemap_batch
from blinky_tpu_torch.kernels import posed, static_ray
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.lensmap import builder
from blinky_tpu_torch.lua_bridge import load_lua_globe, load_lua_lens

W, H, S = 64, 48, 32
FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
F32_SHARE = 0.15
LENS_SCRIPTS = sorted(lua_drop_ins.LENSES)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    return lua_drop_ins.write_scripts(tmp_path_factory.mktemp("lua"))


def _globes(name, scripts):
    """(JAX globe, port globe): a built-in by name, or the lfast script."""
    if name == "lfast":
        return jload_globe(scripts / "lfast.lua"), load_lua_globe(scripts / "lfast.lua")
    return jglobes.get(name), globes.get(name)


def _lenses(name, scripts, jg, g):
    if name in lua_drop_ins.LENSES:
        path = scripts / f"{name}.lua"
        return jload_lens(path, jg), load_lua_lens(path, g)
    return jlenses.get(name, jg), lenses.get(name, g)


def _setup(lens_name, globe_name, scripts):
    jg, g = _globes(globe_name, scripts)
    jl, lens = _lenses(lens_name, scripts, jg, g)
    jscale = jcalc(JZoom("fov", 180), jl, W, H)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    assert scale == jscale
    return jg, jl, g, lens, scale


def _equal(got, want, what):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f"{what}: {f}")


def _within_f32_tolerance(got, want, what):
    share = float((np.asarray(got.flat_idx) != np.asarray(want.flat_idx)).mean())
    print(f"{what}: flat_idx differs on {share:.4f} of the pixels")
    assert share <= F32_SHARE, (what, share)
    same = got.valid & want.valid & (got.plate == want.plate)
    for f in ("px", "py"):
        d = np.abs(getattr(got, f) - getattr(want, f))[same]
        assert d.max(initial=0) <= 1, (what, f, int(d.max()))


CASES = [(n, g) for n in LENS_SCRIPTS for g in ("cube", "fast", "lfast")] + [
    ("panini", "lfast")]


@pytest.mark.parametrize("lens_name,globe_name", CASES)
def test_jittable_and_metadata_equal_jax(lens_name, globe_name, scripts):
    jg, jl, g, lens, scale = _setup(lens_name, globe_name, scripts)
    assert (lens.jittable, g.jittable) == (jl.jittable, jg.jittable)
    for f in ("name", "map_type", "width", "height", "max_fov", "max_vfov", "onload"):
        assert getattr(lens, f) == getattr(jl, f), f
    for f in ("forward", "right", "up", "fov_rad", "dist"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
    assert lens.jittable == (lens_name != "scat")


@pytest.mark.parametrize("lens_name,globe_name", CASES)
def test_exact_build_bit_equal_jax(lens_name, globe_name, scripts):
    jg, jl, g, lens, scale = _setup(lens_name, globe_name, scripts)
    got = build_lensmap(lens, g, scale, W, H, S)
    assert isinstance(got.flat_idx, np.ndarray)
    _equal(got, jbuild(jl, jg, scale, W, H, S, backend="numpy"), f"{lens_name} on {globe_name}")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("globe_name", ["cube", "fast", "lfast"])
def test_transcriptions_equal_the_builtins(backend, globe_name, scripts):
    """lpanini and lfast follow panini's and fast's operation order, so
    their builds equal the built-ins' bit for bit on both builders, with
    and without a view rotation."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    _, _, g, lens, scale = _setup("lpanini", globe_name, scripts)
    bg = globes.get("fast" if globe_name == "lfast" else globe_name)
    bl = lenses.get("panini", bg)
    for vb in (None, view_basis_from_angles(10.0, 30.0, 0.0)):
        got = build_lensmap(lens, g, scale, W, H, S, backend=backend, device="cpu",
                            view_basis=vb).to_numpy()
        want = build_lensmap(bl, bg, scale, W, H, S, backend=backend, device="cpu",
                             view_basis=vb).to_numpy()
        _equal(got, want, f"{globe_name} {backend} {vb is not None}")


@pytest.mark.parametrize("lens_name,globe_name", CASES)
def test_torch_build_within_f32_tolerance_of_jax(lens_name, globe_name, scripts):
    from blinky_tpu_torch.camera import view_basis_from_angles

    jg, jl, g, lens, scale = _setup(lens_name, globe_name, scripts)
    for vb in (None, view_basis_from_angles(10.0, 30.0, 0.0)):
        got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu",
                            view_basis=vb).to_numpy()
        want = jbuild(jl, jg, scale, W, H, S, backend="jax", dtype=jnp.float32,
                      view_basis=vb).to_numpy()
        if not (lens.jittable and g.jittable):
            # both route to the exact host path
            _equal(got, want, f"{lens_name} on {globe_name}")
            continue
        _within_f32_tolerance(got, want, f"{lens_name} on {globe_name}, view {vb is not None}")


def test_lens_stage_stays_float32(scripts):
    """The Lua lens stage on float32 tensors gives float32 rays, and the
    script resolver int32 plates, with no float64 on the way."""
    g = load_lua_globe(scripts / "lfast.lua")
    for name in ("lpanini", "lnewton"):
        lens = load_lua_lens(scripts / f"{name}.lua", g)
        vx, vy, vz, ok = builder.lens_rays_torch(lens, 0.05, W, H, torch.device("cpu"))
        raw = lens.inverse(*(torch.linspace(-2, 2, 12).reshape(3, 4),) * 2)
        assert [t.dtype for t in raw] == [torch.float32] * 3 + [torch.bool], name
        assert vx.dtype == torch.float32 and ok.dtype == torch.bool
    x = torch.linspace(-1, 1, 12).reshape(3, 4)
    plates = g.plate_resolver(x, x.flip(0), x.abs(), g)
    assert plates.dtype == torch.int32
    want = g.plate_resolver(x.double().numpy(), x.flip(0).double().numpy(),
                            x.abs().double().numpy(), g)
    np.testing.assert_array_equal(plates.numpy(), want)


def test_script_resolver_plain_mode_equals_given_plates(scripts):
    """K8's plain version with the script's plates given equals the one
    that evaluates them, and both give the rotate pre-pass's rays to the
    script: rotate_rays on the CPU is rotate_normalize_torch."""
    g = load_lua_globe(scripts / "lfast.lua")
    lens = load_lua_lens(scripts / "lpanini.lua", g)
    rays = builder.lens_rays_torch(lens, 0.05, W, H, torch.device("cpu"))
    basis = np.asarray([[0.1, 0.0, 0.99], [0.99, 0.0, -0.1], [0.0, 1.0, 0.0]])
    b = torch.from_numpy(basis.astype(np.float32))
    nx, ny, nz = builder.rotate_rays(*rays[:3], b[None])
    plate = builder.script_plates(g, nx[0], ny[0], nz[0])
    got = builder.lensmap_resolve(g, *rays, S, 10.0, 4.0, 1.0, basis, plate=plate)
    want = builder.lensmap_resolve(g, *rays, S, 10.0, 4.0, 1.0, basis)
    for f in FIELDS:
        assert torch.equal(got[f], want[f]), f
    assert set(np.unique(plate.numpy())) <= {-1, 0, 1}
    for a, c in zip((nx[0], ny[0], nz[0]), builder.rotate_normalize_torch(*rays[:3], b)):
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="int32"):
        builder.lensmap_resolve(g, *rays, S, 10.0, 4.0, 1.0, basis, plate=plate.long())


def _session_pair(scripts, lines, **kw):
    j = JSession(W, H, platesize=S, lens_dirs=[scripts], globe_dirs=[scripts], **kw)
    p = Session(W, H, platesize=S, device="cpu", lens_dirs=[scripts],
                globe_dirs=[scripts], **kw)
    for line in lines:
        j.cmd(line)
        p.cmd(line)
    return j, p


@pytest.mark.parametrize("lines", [
    ["f_lens lpanini"], ["f_lens lnewton"], ["f_lens scat"], ["f_globe lfast"],
    ["f_globe lfast", "f_lens lnewton"], ["f_globe lfast", "f_lens scat"],
    ["f_lens nosuch"], ["f_globe nosuch"],
])
def test_session_round_trip(lines, scripts):
    """Script directories load .lua drop-ins as blinky_tpu's Session does:
    the same console, validity, jittable decisions and routing, and on the
    exact host path the same screens bit for bit."""
    j, p = _session_pair(scripts, lines)
    assert p.console == j.console
    assert (p.lens_name, p.lens_valid, p.globe_name, p.globe_valid) == (
        j.lens_name, j.lens_valid, j.globe_name, j.globe_valid)
    assert p._jittable() == j._jittable()
    assert p.complete_lens("l") == j.complete_lens("l")
    assert p.complete_globe() == j.complete_globe()
    assert "lpanini" in p.complete_lens("lp") and p.complete_globe("lf") == ["lfast"]
    frames = synthetic_cubemap(S)
    np.testing.assert_array_equal(p.render(frames).numpy(), np.asarray(j.render(frames)))
    p.cmd("setviewangles 10 30 0")
    j.cmd("setviewangles 10 30 0")
    assert p._resolved_backend() == ("torch" if j._resolved_backend() == "jax" else "numpy")
    got, want = p.render(frames).numpy(), np.asarray(j.render(frames))
    if p._resolved_backend() == "numpy":
        np.testing.assert_array_equal(got, want)
    else:
        assert float((got != want).mean()) <= 0.02


def test_session_caches_script_lenses(scripts):
    """A zoom or view change reuses the loaded LensDef (the JAX package's
    cache on path, globe generation and mtime); a globe change reloads."""
    p = Session(W, H, platesize=S, device="cpu", lens_dirs=[scripts], globe_dirs=[scripts])
    p.cmd("f_lens lnewton")
    p.lensmap
    first = p.lens
    p.cmd("f_fov 120; setviewangles 5 5 0")
    p.lensmap
    assert p.lens is first
    p.cmd("f_globe lfast")
    p.lensmap
    assert p.lens is not first and p.lens.name == "lnewton"


@pytest.mark.parametrize("k", [1, 2])
def test_render_posed_script_globe_within_posed_tolerance(k, scripts):
    """render_posed on lfast: per pose the rotate pre-pass, the script on
    the rotated rays as tensors and K6's plain version in mode 2, against
    the JAX package's jitted pipeline with the traced resolver (0.02 of
    the pixels, the posed Session bound), and bit-equal to the same
    Session on the built-in fast globe."""
    B = 4
    frames = synthetic_cubemap_batch(S, B)
    poses = np.asarray([(0.0, 0.0, 0.0), (5.0, -12.0, 0.0), (-20.0, 33.0, 10.0),
                        (0.0, 181.0, -45.0)])
    j, p = _session_pair(scripts, ["f_globe lfast"])
    got = p.render_posed(frames, poses, render_scale=k).numpy()
    want = np.asarray(j.render_posed(frames, poses, render_scale=k))
    assert got.shape == want.shape == (B, H, W)
    print(f"k={k}: {float((got != want).mean()):.4f} of the pixels differ")
    assert float((got != want).mean()) <= 0.02
    ref = Session(W, H, platesize=S, device="cpu")
    ref.cmd("f_globe fast")
    np.testing.assert_array_equal(got, ref.render_posed(frames, poses, render_scale=k).numpy())
    np.testing.assert_array_equal(p.render_posed(frames, poses, exact=True).numpy(),
                                  ref.render_posed(frames, poses, exact=True).numpy())


def test_scalar_only_scripts_route_to_the_host(scripts, tmp_path):
    """scat (a lens) builds its ray table on the host; a scalar-only globe
    renders every pose on the exact path, bit-equal to exact=True, as the
    JAX package routes them."""
    frames = synthetic_cubemap_batch(S, 2)
    poses = np.asarray([(0.0, 0.0, 0.0), (5.0, 30.0, 0.0)])
    j, p = _session_pair(scripts, ["f_lens scat"])
    assert not p.lens.jittable
    table = static_ray.build_ray_table(p.lens, p.globe, 0.05, W, H, device="cpu")
    assert isinstance(table.vx, np.ndarray)
    got = p.render_posed(frames, poses).numpy()
    assert float((got != np.asarray(j.render_posed(frames, poses))).mean()) <= 0.02
    (tmp_path / "scatglobe.lua").write_text("""
plates = {
{ {0,0,1}, {0,1,0}, 90 },
{ {0,0,1}, {0,1,0}, 160 }
}
acc = {}
function globe_plate(x,y,z)
  local k = math.floor(math.abs(x) * 3) + 1
  acc[k] = z          -- lane-varying table WRITE: per-lane control
  if x > 0 then return 0 end
  return 1
end
""")
    p = Session(W, H, platesize=16, device="cpu", globe_dirs=[tmp_path])
    p.cmd("f_globe scatglobe")
    assert p.globe_valid and not p.globe.jittable
    with pytest.raises(ValueError, match="jittable"):
        builder.plate_resolver_mode(p.globe)
    frames = synthetic_cubemap(16)[:2][..., None].repeat(2, -1)
    posed_ = p.render_posed(frames, poses).numpy()
    np.testing.assert_array_equal(posed_, p.render_posed(frames, poses, exact=True).numpy())
    p.cmd("setviewangles 5 30 0")
    assert p._resolved_backend() == "numpy"
    assert isinstance(p.lensmap.flat_idx, np.ndarray)


def test_zoom_sweep_on_script_globe_equals_per_step_loop(scripts):
    """K9's plain version in mode 2 (the script on each step's normalized
    rays) equals the per-step Session(backend="torch") loop bit for bit."""
    frame = synthetic_cubemap(S)
    sess = Session(W, H, platesize=S, device="cpu", backend="torch",
                   globe_dirs=[scripts])
    sess.cmd("f_globe lfast")
    scales, want = [], []
    for fov in (100, 180, 260):
        sess.cmd(f"f_fov {fov}")
        want.append(sess.render(frame).numpy())
        scales.append(sess.lensmap.scale)
    got = posed.zoom_sweep_remap(sess.lens, sess.globe, scales, frame, W, H, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_host_paths_are_thread_safe(scripts):
    """Concurrent host evaluations of one .lua LensDef serialize on the
    script lock and give the serial result (tests/test_lua_bridge.py:402)."""
    g = globes.get("cube")
    for name in ("lnewton", "lpanini"):
        lua = load_lua_lens(scripts / f"{name}.lua", g)
        X, Y = np.meshgrid(np.linspace(-3.4, 3.4, 41), np.linspace(-2.2, 2.2, 39))
        with np.errstate(all="ignore"):
            ref = lua.inverse(X, Y)
        results, errors = [None] * 8, []

        def worker(i):
            try:
                with np.errstate(all="ignore"):
                    results[i] = lua.inverse(X, Y)
            except Exception as e:  # pragma: no cover - the failure mode
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for r in results:
            for got, exp in zip(r, ref):
                np.testing.assert_array_equal(np.asarray(got), np.asarray(exp))


def test_release_unwinds_parked_coroutines(tmp_path):
    """LensDef.release unwinds the threads a script parked in its scalar
    interpreters, idempotently, and the lens still works afterwards
    (tests/test_lua_bridge.py:445)."""
    src = '''
max_fov = 360
max_vfov = 180
lens_width = 2 * pi
lens_height = pi
gen = coroutine.create(function()
  coroutine.yield(2 * pi)
  coroutine.yield(pi)
end)
local _, w = coroutine.resume(gen)
lens_width = w
function lens_inverse(x, y)
  local keep = coroutine.create(function() coroutine.yield() end)
  coroutine.resume(keep)
  return cos(y) * sin(x), sin(y), cos(y) * cos(x)
end
'''
    path = tmp_path / "parked.lua"
    path.write_text(src)
    jl = jload_lens(path, jglobes.get("cube"))
    jittable = jl.jittable
    jl.release()
    before = threading.active_count()
    deadline = time.time() + 10
    while time.time() < deadline:  # the JAX lens's threads unwind
        time.sleep(0.05)
        if threading.active_count() == before:
            break
        before = threading.active_count()
    ld = load_lua_lens(path, globes.get("cube"))
    assert ld.jittable is False and ld.release is not None
    assert ld.jittable == jittable
    assert threading.active_count() >= before + 1
    out = ld.inverse(0.1, 0.2)
    assert len(out) == 4
    ld.release()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
    ld.release()
    out2 = ld.inverse(0.1, 0.2)
    np.testing.assert_array_equal(np.asarray(out2[0]), np.asarray(out[0]))
    ld.release()


def test_bridge_imports_neither_jax_nor_blinky_tpu():
    code = ("import sys; import blinky_tpu_torch.lua_bridge, blinky_tpu_torch.api; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'blinky_tpu' or m.startswith('blinky_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


LANE_PLATE = """
-- a plate index that varies by lane, as debug.lua's layout does
lens_width = 6
lens_height = 4
function lens_inverse(x, y)
  local i = math.floor(x + 3)
  local u = x + 3 - i
  local v = (y + 2) / 4
  return plate_to_ray(i, u, v)
end
"""


@pytest.mark.parametrize("globe_name", ["cube", "tetra"])
def test_lane_varying_plate_to_ray_on_tensors(globe_name, tmp_path):
    """plate_to_ray with a lane-varying plate on tensors: float64 tensors
    give the NumPy path's rays and nil lanes (plates out of range) bit for
    bit; the float32 build lies within the boundary tolerance of the JAX
    package's traced build of the same script."""
    path = tmp_path / "lanes.lua"
    path.write_text(LANE_PLATE)
    jg, g = jglobes.get(globe_name), globes.get(globe_name)
    jl, lens = jload_lens(path, jg), load_lua_lens(path, g)
    assert lens.jittable and jl.jittable
    X, Y = np.meshgrid(np.linspace(-3.6, 3.6, 53), np.linspace(-2.2, 2.2, 31))
    want = lens.inverse(X, Y)
    got = lens.inverse(torch.from_numpy(X), torch.from_numpy(Y))
    ok = np.asarray(want[3])
    assert 0 < ok.sum() < ok.size
    np.testing.assert_array_equal(got[3].numpy(), ok)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a.numpy()[ok], np.asarray(b)[ok])
    scale = 0.0931  # off the texel edges that 6 / W would sample exactly
    got = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu").to_numpy()
    want = jbuild(jl, jg, scale, W, H, S, backend="jax", dtype=jnp.float32).to_numpy()
    _within_f32_tolerance(got, want, f"lane-varying plates on {globe_name}")
