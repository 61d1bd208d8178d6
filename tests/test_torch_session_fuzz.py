"""The port's console fuzz, with tests/test_session_fuzz.py as the model:
random lines from that file's word list, every command of the surface among
them, go into blinky_tpu's Session and the port's, with command-line
commands that hold a ``stuffcmds`` so that its recursion guard is reached.
Neither may raise, and the console output, the state, the config text and
the periodic renders must be equal (tolerance 0).  Both Sessions build on
the exact host path (``backend="numpy"``), so that ``setviewangles`` in the
storm stays bit-for-bit comparable; ``f_saveglobe`` and ``f_dumppal`` write
into a temporary working directory."""

import numpy as np
import pytest

from blinky_tpu.api import Session as JSession
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.io.cubemap import synthetic_cubemap

WORDS = ["f_lens", "f_globe", "f_fov", "f_vfov", "f_cover", "f_contain",
         "f_rubix", "f_rubixgrid", "fisheye", "fov", "bind", "unbind",
         "exec", "setviewangles", "f_saveglobe", "f_dumppal", "f_help",
         "f_shortcutkeys", "panini", "nosuchlens", "cube", "-3", "9e99",
         "nan", "inf", "0", "1", "361", ";", "", "xyz", "--", "1e-9",
         '"quoted"', "\t", "zzz.lua", "../escape",
         "alias", "echo", "wait", 'alias a "f_fov 90"', "a",
         'alias b "b"', "b", '"semi; colon"', "unbindall",
         "9" * 39, "-" + "9" * 45, "0x" + "f" * 34, "1" * 400,
         "f_fov\x0090", "x\x00y", "stuffcmds", "stuffcmds extra"]


def _pair():
    kw = dict(platesize=16, backend="numpy", cmdline_cmds=["f_fov 120", "stuffcmds"])
    return JSession(48, 36, **kw), Session(48, 36, device="cpu", **kw)


def _same_state(j, p):
    assert p.console == j.console
    assert p.config_str() == j.config_str()
    assert (p.lens_valid, p.globe_valid, p.view_angles, p.save_request) == (
        j.lens_valid, j.globe_valid, j.view_angles, j.save_request)


@pytest.mark.parametrize("seed", list(range(8)))
def test_console_fuzz_same_in_both(tmp_path, monkeypatch, seed):
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(seed)
    j, p = _pair()
    frames = synthetic_cubemap(16)
    for i in range(300):
        n = int(rng.integers(1, 5))
        line = " ".join(str(WORDS[int(rng.integers(len(WORDS)))]) for _ in range(n))
        j.cmd(line)
        p.cmd(line)
        _same_state(j, p)
        if i % 25 == 0:
            want = np.asarray(j.render(frames))
            got = p.render(frames).numpy()
            assert got.shape == want.shape == (36, 48)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(p.render_host(frames), j.render_host(frames))
            _same_state(j, p)
    # after the storm both recover to a known-good state
    for s in (j, p):
        s.cmd("fisheye 1; f_globe cube; f_lens panini; f_fov 180")
        s.cmd("setviewangles")
    out = p.render(frames).numpy()
    assert p.lens_valid and p.globe_valid and out.any()
    np.testing.assert_array_equal(out, np.asarray(j.render(frames)))
    _same_state(j, p)


def test_config_roundtrip_after_fuzz(tmp_path):
    """Whatever the state, write_config / exec_config round-trips it into
    either package's Session (F_WriteConfig, fisheye.c:683-696)."""
    j, p = _pair()
    for line in ("f_lens hammer", "f_rubixgrid 7 2 1", "f_vfov 90", "f_rubix", "fov 77",
                 'bind 3 "f_lens fisheye1"', 'alias q "f_globe tetra"'):
        j.cmd(line)
        p.cmd(line)
    cfg = tmp_path / "config.cfg"
    p.write_config(cfg)
    j2 = JSession(48, 36, platesize=16, backend="numpy")
    p2 = Session(48, 36, platesize=16, device="cpu")
    for s in (j2, p2):
        s.exec_config(cfg)
    assert p2.config_str() == j2.config_str() == j.config_str()
    # the rubix toggle is not persisted, as in F_WriteConfig
    assert not p2.rubix_enabled and p2.rubix_numcells == 7 and p2.fov == 77.0
