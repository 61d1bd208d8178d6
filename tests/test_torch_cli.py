"""The port's CLI (blinky_tpu_torch.cli) against blinky_tpu's, subcommand by
subcommand, with tests/test_cli_pipeline.py as the model.

Each case runs the same argument list through ``blinky_tpu.cli.main`` and
through ``blinky_tpu_torch.cli.main([... "--device", "cpu"])`` and compares
what they write and print.  Tolerance 0 (byte-equal files, equal arrays in
an ``.npz``, equal stdout and exit codes) wherever both packages render
through the exact float64 host lensmap, which is every subcommand but
these, each held to the rule the port's tests already state for its path:

* ``reproject --follow-poses``: ``Session.render_posed`` on both sides takes
  the float32 lens stage (torch's against XLA:CPU's), 0.02 of the pixels of
  the run (tests/test_torch_posed.py);
* ``sweep``: the fused ramp (``zoom_sweep_remap``, the float32 builder on
  both sides), 0.06 of a step's pixels (tests/test_torch_posed.py), and the
  plain view of ``fisheye 0`` on the float32 builder, 0.15 of the pixels
  (tests/test_torch_lensmap.py's ``F32_SHARE``);
* ``parity --backend torch``: the float32 builder's count of mismatches
  against the oracle is its own (the JAX ``--backend jax`` count is
  XLA:CPU's); both exit 1 with the same keys.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from blinky_tpu import cli as jcli
from blinky_tpu.io.gif import decode_gif
from blinky_tpu_torch import cli

POSED_SHARE = 0.02
SWEEP_SHARE = 0.06
F32_SHARE = 0.15


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(argv, jdir=None, pdir=None, out_flag="--outdir"):
    """(JAX (rc, stdout), port (rc, stdout)) of one argument list, each
    writing under its own directory (*out_flag*); the paths in the printed
    lines are made the same."""
    ja = argv + ([out_flag, str(jdir)] if jdir is not None else [])
    pa = argv + ([out_flag, str(pdir)] if pdir is not None else []) + ["--device", "cpu"]
    j, p = _run(jcli.main, ja), _run(cli.main, pa)
    if jdir is not None:
        p = (p[0], p[1].replace(str(pdir), str(jdir)))
    return j, p


def _same_files(a, b):
    fa, fb = sorted(a.iterdir()), sorted(b.iterdir())
    assert [f.name for f in fa] == [f.name for f in fb]
    for x, y in zip(fa, fb):
        if x.suffix == ".npz":
            with np.load(x) as za, np.load(y) as zb:
                assert sorted(za.files) == sorted(zb.files)
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{x.name}:{k}")
        else:
            assert x.read_bytes() == y.read_bytes(), x.name
    return len(fa)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    d = tmp_path_factory.mktemp("demo")
    path = d / "demo.npz"
    assert jcli.main(["demo-synth", "--frames", "6", "--platesize", "48",
                      "--out", str(path)]) == 0
    return path


def test_ppm_roundtrip():
    from blinky_tpu_torch.io.ppm import decode_ppm, encode_ppm

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (33, 47, 3), np.uint8)
    assert np.array_equal(decode_ppm(encode_ppm(img)), img)


@pytest.mark.parametrize("frames,S", [(5, 48), (3, 32)])
def test_demo_synth(tmp_path, frames, S):
    (jrc, jout), (prc, pout) = _both(["demo-synth", "--frames", str(frames), "--platesize",
                                      str(S)], tmp_path / "j.npz", tmp_path / "p.npz",
                                     out_flag="--out")
    assert jrc == prc == 0 and jout == pout
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["frames", "palette", "poses"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


REPROJECT = {
    "ppm-fisheye1": ["--batch", "3", "--cmd", "f_lens fisheye1", "--format", "ppm"],
    "npz": ["--batch", "4", "--format", "npz"],
    "pcx-rubix": ["--batch", "4", "--rubix", "--format", "pcx"],
    "png-cmd-rubix": ["--batch", "2", "--cmd", "f_rubix", "--format", "png"],
    "gif": ["--batch", "6", "--format", "gif", "--gif-delay", "7"],
    "aa-png": ["--batch", "2", "--cmd", "f_lens fisheye1", "--aa", "2", "--format", "png"],
    "pose-ppm": ["--batch", "3", "--pose", "10,20,0", "--format", "ppm"],
    "shard-one-device": ["--batch", "3", "--shard", "--rubix", "--format", "npz"],
    "batch0": ["--batch", "0", "--format", "npz"],
}


@pytest.mark.parametrize("case", list(REPROJECT))
def test_reproject_equals_jax(tmp_path, demo, case):
    argv = ["reproject", "--demo", str(demo), "--width", "64", "--height", "48"]
    argv += REPROJECT[case]
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j", tmp_path / "p")
    assert jrc == prc == 0
    n = _same_files(tmp_path / "j", tmp_path / "p")
    assert n == (1 if case in ("npz", "gif", "shard-one-device", "batch0") else 6)
    if case == "shard-one-device":
        # the port's device list under --device cpu is one CPU device (the
        # JAX CLI here sees its 8 virtual ones and shards)
        assert "--shard: 1 device visible; running unsharded" in pout.splitlines()
        return
    # the console echo and the summary lines, less the clock's report
    assert ([ln for ln in jout.splitlines() if not ln.endswith("fps")]
            == [ln for ln in pout.splitlines() if not ln.endswith("fps")])


@pytest.mark.parametrize("lens", ["fisheye1", "panini"])
def test_reproject_follow_poses(tmp_path, demo, lens):
    argv = ["reproject", "--demo", str(demo), "--width", "64", "--height", "48",
            "--batch", "2", "--cmd", f"f_lens {lens}", "--follow-poses", "--format", "npz"]
    (jrc, _), (prc, _) = _both(argv, tmp_path / "j", tmp_path / "p")
    assert jrc == prc == 0
    with np.load(tmp_path / "j" / "warped.npz") as a, np.load(tmp_path / "p" / "warped.npz") as b:
        ja, pa = a["screen"], b["screen"]
    assert ja.shape == pa.shape == (6, 48, 64)
    share = float((ja != pa).mean())
    print(f"{lens} --follow-poses: {share:.4f} of the pixels differ from the JAX CLI's")
    assert share <= POSED_SHARE
    # and the pose track moved the view, as in the JAX test
    static = tmp_path / "s"
    assert cli.main(["reproject", "--demo", str(demo), "--width", "64", "--height", "48",
                     "--batch", "2", "--cmd", f"f_lens {lens}", "--format", "npz",
                     "--outdir", str(static), "--device", "cpu"]) == 0
    with np.load(static / "warped.npz") as z:
        assert (z["screen"][-1] != pa[-1]).any()


@pytest.mark.parametrize("extra", [
    ["--aa", "2", "--format", "pcx"],
    ["--aa", "2", "--follow-poses", "--format", "png"],
    ["--format", "gif", "--gif-delay", "70000"],
    ["--pose-scale", "5"],
    ["--shard", "--follow-poses"],
], ids=["aa-pcx", "aa-poses", "gif-delay", "pose-scale", "shard-poses"])
def test_reproject_refusals(tmp_path, demo, extra):
    argv = ["reproject", "--demo", str(demo), "--width", "64", "--height", "48"] + extra
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j", tmp_path / "p")
    assert jrc == prc == 2
    assert jout.splitlines()[-1] == pout.splitlines()[-1]


def test_reproject_shard_matches_unsharded(tmp_path, monkeypatch):
    """--shard over the port's device list made [cpu] * 8 (the JAX CLI's
    8 virtual CPU devices): the frames equal the unsharded run's and the
    JAX --shard run's; --batch 0 derives a chunk that splits evenly."""
    from blinky_tpu_torch import parallel

    demo = tmp_path / "demo.npz"
    jcli.main(["demo-synth", "--frames", "6", "--platesize", "48", "--out", str(demo)])
    monkeypatch.setattr(parallel, "visible_devices",
                        lambda kind="cuda": [torch.device("cpu")] * 8)
    common = ["reproject", "--demo", str(demo), "--width", "64", "--height", "48",
              "--rubix", "--format", "npz"]
    assert cli.main(common + ["--batch", "6", "--outdir", str(tmp_path / "a"),
                              "--device", "cpu"]) == 0
    (jrc, jout), (prc, pout) = _both(common + ["--batch", "0", "--shard"],
                                     tmp_path / "jb", tmp_path / "b")
    assert jrc == prc == 0
    for line in ("shard: data-parallel over 8 devices", "auto batch: 6",
                 "--shard: batch rounded up to 8 (multiple of 8 devices)"):
        assert line in jout.splitlines() and line in pout.splitlines(), line
    with np.load(tmp_path / "a" / "warped.npz") as za, \
            np.load(tmp_path / "b" / "warped.npz") as zb:
        np.testing.assert_array_equal(za["screen"], zb["screen"])
    _same_files(tmp_path / "jb", tmp_path / "b")


def test_load_palette_dispatch(tmp_path):
    from blinky_tpu_torch.palette import default_palette, save_dumppal

    pal = default_palette()
    lmp = tmp_path / "palette.lmp"
    lmp.write_bytes(pal.tobytes())
    np.testing.assert_array_equal(cli._load_palette(str(lmp)), pal)
    txt = tmp_path / "palette"
    txt.write_text(save_dumppal(pal))
    np.testing.assert_array_equal(cli._load_palette(str(txt)), pal)
    np.testing.assert_array_equal(cli._load_palette(str(txt)), jcli._load_palette(str(txt)))
    assert cli._load_palette(None) is None


@pytest.mark.parametrize("ext", ["pcx", "png", "ppm", "npz"])
@pytest.mark.parametrize("cmds", [["--cmd", "f_lens hammer"], ["--rubix"],
                                  ["--cmd", "f_lens eckert1", "--cmd", "f_contain"]],
                         ids=["hammer", "rubix", "eckert1"])
def test_remap_equals_jax(tmp_path, ext, cmds):
    argv = ["remap", "--width", "64", "--height", "48"] + cmds
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / f"j.{ext}", tmp_path / f"p.{ext}",
                                     out_flag="--out")
    assert jrc == prc == 0 and jout == pout
    a, b = tmp_path / f"j.{ext}", tmp_path / f"p.{ext}"
    if ext == "npz":
        with np.load(a) as za, np.load(b) as zb:
            for k in ("screen", "palette"):
                np.testing.assert_array_equal(za[k], zb[k])
    else:
        assert a.read_bytes() == b.read_bytes()


def test_remap_from_saveglobe_frames_and_palette(tmp_path):
    """remap --frames (an f_saveglobe PCX prefix) with a --palette file."""
    from blinky_tpu_torch import globes
    from blinky_tpu_torch.io import cubemap
    from blinky_tpu_torch.palette import default_palette, save_dumppal

    cubemap.save_globe_pcx(tmp_path / "glb", cubemap.synthetic_cubemap(32),
                           globes.get("cube"), default_palette(), with_margins=True)
    (tmp_path / "pal.txt").write_text(save_dumppal(default_palette()[::-1].copy()))
    argv = ["remap", "--frames", str(tmp_path / "glb"), "--width", "64", "--height", "48",
            "--palette", str(tmp_path / "pal.txt")]
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j.png", tmp_path / "p.png",
                                     out_flag="--out")
    assert jrc == prc == 0 and jout == pout
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "p.png").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--poses"], ["--numplates", "6"]],
                         ids=["plain", "poses", "numplates"])
def test_demo_import_saveglobe(tmp_path, flags):
    from blinky_tpu_torch import globes
    from blinky_tpu_torch.io import cubemap
    from blinky_tpu_torch.palette import default_palette

    dumps = tmp_path / "dumps"
    dumps.mkdir()
    for i in range(3):
        cubemap.save_globe_pcx(dumps / f"frame{i:04d}_",
                               np.roll(cubemap.synthetic_cubemap(16), i, axis=2),
                               globes.get("cube"), default_palette(), with_margins=True)
    if flags == ["--poses"]:
        (tmp_path / "track.txt").write_text("0 0 0\n5 10 0\n")
        flags = ["--poses", str(tmp_path / "track.txt")]
    argv = ["demo-import", str(dumps)] + flags
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j.npz", tmp_path / "p.npz",
                                     out_flag="--out")
    assert jrc == prc == 0 and jout == pout
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_demo_import_exclusive_flags(tmp_path):
    for extra in (["--poses", "a", "--dem", "b"], ["--rgb", "--equirect", "8"]):
        (jrc, jout), (prc, pout) = _both(["demo-import", str(tmp_path)] + extra)
        assert jrc == prc == 2 and jout == pout


@pytest.mark.parametrize("cmd", ["lenses", "globes", "help"])
def test_listing_subcommands_print_the_same(cmd):
    (jrc, jout), (prc, pout) = _both([cmd])
    assert jrc == prc == 0 and jout == pout and jout.strip()


@pytest.mark.parametrize("lens", ["panini", "eckert1", "stereographic"])
def test_parity_numpy_equals_jax(lens):
    argv = ["parity", "--lens", lens, "--globe", "cube", "--width", "48", "--height", "36"]
    (jrc, jout), (prc, pout) = _both(argv)
    assert jrc == prc == 0 and jout == pout
    assert json.loads(pout)["total"] == 0


def test_parity_torch_backend():
    argv = ["parity", "--lens", "panini", "--width", "48", "--height", "36"]
    jrc, jout = _run(jcli.main, argv + ["--backend", "jax"])
    prc, pout = _run(cli.main, argv + ["--backend", "torch", "--device", "cpu"])
    j, p = json.loads(jout), json.loads(pout)
    assert sorted(j) == sorted(p) and p["backend"] == "torch"
    assert sorted(j["mismatches"]) == sorted(p["mismatches"])
    # both float32 builders disagree with the float64 oracle on boundary
    # texels only, so both exit 1 (the count is not zero)
    assert jrc == prc == (1 if p["total"] else 0)
    assert p["total"] <= F32_SHARE * 48 * 36 * 6


def test_parity_user_scripts(tmp_path):
    lua = tmp_path / "ortho.lua"
    lua.write_text(
        "max_fov = 180\nmax_vfov = 180\n"
        "lens_width = 2\nlens_height = 2\n"
        "onload = \"f_contain\"\n"
        "function lens_inverse(x,y)\n"
        "   local r2 = x*x + y*y\n"
        "   if r2 > 1 then return nil end\n"
        "   return x, y, sqrt(1-r2)\n"
        "end\n"
        "function lens_forward(x,y,z)\n"
        "   if z < 0 then return nil end\n"
        "   return x, y\n"
        "end\n")
    argv = ["parity", "--lens", str(lua), "--globe", "cube", "--width", "48", "--height", "36"]
    (jrc, jout), (prc, pout) = _both(argv)
    assert jrc == prc == 0 and jout == pout
    py = tmp_path / "ortho.py"
    py.write_text(
        "from blinky_tpu_torch import xmath as m\n"
        "def make(ctx):\n"
        "    def lens_inverse(x, y):\n"
        "        r2 = x*x + y*y\n"
        "        return x, y, m.sqrt(1-r2), r2 <= 1\n"
        "    def lens_forward(x, y, z):\n"
        "        return x, y, z >= 0\n"
        "    return dict(lens_inverse=lens_inverse, lens_forward=lens_forward,\n"
        "                max_fov=180, max_vfov=180, lens_width=2,\n"
        "                lens_height=2, onload='f_contain')\n")
    rc, out = _run(cli.main, ["parity", "--lens", str(py), "--globe", "cube", "--width",
                              "48", "--height", "36", "--device", "cpu"])
    assert rc == 0 and json.loads(out)["total"] == 0


@pytest.mark.parametrize("fmt,html", [("png", True), ("ppm", False)])
def test_gallery_equals_jax(tmp_path, monkeypatch, fmt, html):
    from blinky_tpu import lenses as jlenses
    from blinky_tpu_torch import lenses

    names = ["panini", "hammer", "debug", "eckert1"]
    monkeypatch.setattr(lenses, "names", lambda: names)
    monkeypatch.setattr(jlenses, "names", lambda: names)
    argv = ["gallery", "--width", "48", "--height", "36", "--format", fmt, "--rubix"]
    argv += ["--html"] if html else []
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j", tmp_path / "p")
    assert jrc == prc == 0 and jout == pout
    assert _same_files(tmp_path / "j", tmp_path / "p") == len(names) + html


def test_gallery_every_lens(tmp_path):
    """All 31 lenses at 32x24: the same images and the same skip/zoom lines."""
    argv = ["gallery", "--width", "32", "--height", "24"]
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j", tmp_path / "p")
    assert jrc == prc == 0 and jout == pout
    assert _same_files(tmp_path / "j", tmp_path / "p") == len(jout.splitlines())


SWEEPS = {
    "fused": (["--steps", "4", "--start", "120", "--stop", "300"], SWEEP_SHARE),
    "fused-bounce-vfov": (["--steps", "3", "--start", "60", "--stop", "150", "--bounce",
                           "--vfov"], SWEEP_SHARE),
    "fused-rubix": (["--steps", "3", "--start", "140", "--stop", "220", "--rubix"],
                    SWEEP_SHARE),
    "plain-view": (["--steps", "3", "--start", "120", "--stop", "300", "--cmd", "fisheye 0"],
                   F32_SHARE),
    "forward-per-step": (["--steps", "3", "--lens", "eckert1", "--start", "120",
                          "--stop", "300"], 0.0),
}


@pytest.mark.parametrize("case", list(SWEEPS))
def test_sweep_gif(tmp_path, case):
    extra, share = SWEEPS[case]
    argv = ["sweep", "--width", "64", "--height", "48"] + extra
    (jrc, jout), (prc, pout) = _both(argv, tmp_path / "j.gif", tmp_path / "p.gif",
                                     out_flag="--out")
    assert jrc == prc == 0
    jf, jpal, jd = decode_gif((tmp_path / "j.gif").read_bytes())
    pf, ppal, pd = decode_gif((tmp_path / "p.gif").read_bytes())
    assert jf.shape == pf.shape and jd == pd
    np.testing.assert_array_equal(jpal, ppal)
    worst = max(float((jf[..., i] != pf[..., i]).mean()) for i in range(jf.shape[-1]))
    print(f"sweep {case}: at most {worst:.4f} of a step's pixels differ from the JAX CLI's")
    assert worst <= share
    if share == 0:
        assert (tmp_path / "j.gif").read_bytes() == (tmp_path / "p.gif").read_bytes()
    if "--bounce" in extra:
        np.testing.assert_array_equal(pf[..., 1], pf[..., -1])  # the mirror
    assert [ln for ln in jout.splitlines() if "fps" not in ln] == \
        [ln for ln in pout.splitlines() if "fps" not in ln]


def test_sweep_invalid_lens_and_session_rubix(tmp_path):
    (jrc, jout), (prc, pout) = _both(["sweep", "--lens", "nosuch"], tmp_path / "j.gif",
                                     tmp_path / "p.gif", out_flag="--out")
    assert jrc == prc == 2 and jout.splitlines()[-1] == pout.splitlines()[-1]
    args = ["sweep", "--width", "64", "--height", "48", "--steps", "3", "--start", "140",
            "--stop", "220", "--device", "cpu"]
    for name, extra in (("plain", []), ("tinted", ["--cmd", "f_rubix"]),
                        ("explicit", ["--rubix"])):
        assert cli.main(args + extra + ["--out", str(tmp_path / f"{name}.gif")]) == 0
    got = {n: decode_gif((tmp_path / f"{n}.gif").read_bytes())[0]
           for n in ("plain", "tinted", "explicit")}
    assert (got["plain"] != got["tinted"]).any()
    np.testing.assert_array_equal(got["explicit"], got["tinted"])


def test_bench_quick_keys(monkeypatch):
    """bench --quick at a toy shape (the JAX and the port measurement each
    made small): the port prints the JAX keys, and more."""
    import functools

    from blinky_tpu.bench import throughput as jthroughput
    from blinky_tpu_torch.bench import throughput

    for mod in (jthroughput, throughput):
        monkeypatch.setattr(mod, "run_throughput", functools.partial(
            mod.run_throughput, width=64, height=48, platesize=32))
    (jrc, jout), (prc, pout) = _both(["bench", "--quick"])
    assert jrc == prc == 0
    j, p = json.loads(jout.splitlines()[-1]), json.loads(pout.splitlines()[-1])
    assert set(j) <= set(p) and p["equal"] is True


def test_device_flag():
    """--device is every subcommand's; a card that is not there raises."""
    rc, out = _run(cli.main, ["lenses", "--device", "cpu"])
    assert rc == 0 and "panini" in out.split()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["remap", "--width", "32", "--height", "24", "--out", "x.pcx"])
