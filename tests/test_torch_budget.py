"""The supersampled render's memory model, ``budget.aa_bytes_per_lane``, and
``reproject --batch 0 --aa K``'s plan with it, on the CPU with a budget
given in place of the free memory."""

import contextlib
import io
import re

import pytest

from blinky_tpu import cli as jcli
from blinky_tpu_torch import budget, cli
from blinky_tpu_torch.palette import MAX_PLATES


@pytest.mark.parametrize("rgba", [False, True], ids=["u8", "rgba"])
@pytest.mark.parametrize("factor", [1, 2, 3])
def test_aa_bytes_are_the_four_buffers(factor, rgba):
    S, P, W, H = 48, 6, 64, 48
    texels = P * S * S
    source = texels * (4 if rgba else 1)
    decoded = 0 if rgba else 4 * texels
    screen = (factor * W) * (factor * H) * 4
    output = W * H * 4
    assert budget.aa_bytes_per_lane(S, P, W, H, factor, rgba=rgba) == \
        source + decoded + screen + output


def test_aa_bytes_at_1080p():
    """The u8 batch cell's lane at factor 2: 7.0 MB of planes, 28.0 MB
    decoded, the 3840x2160 screen's 33.2 MB and the 8.3 MB output, eight
    times the u8 render's 9.1 MB."""
    lane = budget.aa_bytes_per_lane(1080, 6, 1920, 1080, 2)
    assert lane == 6_998_400 + 27_993_600 + 33_177_600 + 8_294_400
    u8 = budget.planes_bytes_per_lane(1080, 6) + budget.screen_bytes_per_lane(1920, 1080)
    assert lane > 8 * u8


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    path = tmp_path_factory.mktemp("demo") / "demo.npz"
    assert jcli.main(["demo-synth", "--frames", "6", "--platesize", "48",
                      "--out", str(path)]) == 0
    return path


@pytest.mark.parametrize("rubix", [False, True], ids=["plain", "rubix"])
def test_batch_zero_aa_plans_within_its_budget(tmp_path, monkeypatch, demo, rubix):
    S, W, H, k = 48, 64, 48, 2
    planes = 2 * MAX_PLATES if rubix else MAX_PLATES
    lane = budget.aa_bytes_per_lane(S, planes, W, H, k)
    given = int(3.5 * lane)
    monkeypatch.setattr(budget, "free_budget_bytes", lambda device: given)
    argv = ["reproject", "--demo", str(demo), "--width", str(W), "--height", str(H),
            "--batch", "0", "--aa", str(k), "--format", "npz", "--outdir", str(tmp_path),
            "--device", "cpu"] + (["--rubix"] if rubix else [])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    batch = int(re.search(r"^auto batch: (\d+)$", buf.getvalue(), re.M).group(1))
    assert batch == 3 and batch * lane <= given
    # the u8 render's model, which the plan took before, would fill the
    # budget several times over
    u8 = budget.planes_bytes_per_lane(S, 6, expanded=rubix) + budget.screen_bytes_per_lane(W, H)
    assert min(given // u8, 6) * lane > given
