"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no jax, so it runs on a machine with only PyTorch and the CUDA
toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance 0 throughout: every output is an integer.
"""

import numpy as np
import pytest
import torch

from blinky_tpu_torch import globes, lenses
from blinky_tpu_torch.api import Session
from blinky_tpu_torch.bench import sol
from blinky_tpu_torch.io.cubemap import synthetic_cubemap_batch
from blinky_tpu_torch.kernels import ingest, posed, remap, static_ray
from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
from blinky_tpu_torch.lensmap import builder
from blinky_tpu_torch.palette import default_palette, tint_lut


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels build and run only there")
    return torch.device("cuda")


def _equal(a, b):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def _case(B, dtype, seed, device):
    """src [96, B], idx (a third out of range either side), valid, bg."""
    rng = np.random.default_rng(seed)
    R, n = 96, 7 * 9
    if dtype == torch.int32:
        src = rng.integers(-2**31, 2**31, (R, B), dtype=np.int64).astype(np.int32)
        bg = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    else:
        src = rng.integers(0, 256, (R, B), dtype=np.uint8)
        bg = rng.integers(0, 256, n, dtype=np.uint8)
    idx = rng.integers(-2 * R - 3, 2 * R + 3, n).astype(np.int32)
    valid = rng.random(n) < 0.8
    return (torch.from_numpy(a).to(device) for a in (src, idx, valid, bg))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 5, 16, 64, 300])
def test_remap_kernels_equal_plain(cuda_device, B):
    """K1 (clip, fill, tint; 16-byte and scalar paths) and K2 (each table
    alone and both, each rule)."""
    pal = torch.from_numpy(default_palette()).to(cuda_device)
    tl = torch.from_numpy(tint_lut(default_palette())).to(cuda_device)
    for dtype in (torch.uint8, torch.int32):
        src, idx, valid, bg = _case(B, dtype, B, cuda_device)
        for fill in (False, True):
            _equal(remap.remap_gather(src, idx, valid, bg, fill=fill),
                   remap.remap_gather_plain(src, idx, valid, bg, fill=fill))
        if dtype == torch.int32:
            tr = torch.randint(-2**31, 2**31 - 1, idx.shape, dtype=torch.int32,
                               device=cuda_device)
            tm = valid & (torch.arange(idx.numel(), device=cuda_device) % 3 > 0)
            _equal(remap.remap_gather(src, idx, valid, bg, tint_rgb=tr, tint_mask=tm),
                   remap.remap_gather_plain(src, idx, valid, bg, tint_rgb=tr,
                                            tint_mask=tm))
            continue
        tint = (idx.abs() % 256).to(torch.uint8)
        for luts in ((tl, None), (None, pal), (tl, pal)):
            for fill in (False, True):
                _equal(remap.remap_lut(src, idx, valid, tint, bg, *luts, fill=fill),
                       remap.remap_lut_plain(src, idx, valid, tint, bg, *luts,
                                             fill=fill))
    # a source that starts off a 16-byte boundary takes the scalar path
    src, idx, valid, bg = _case(B + 1, torch.uint8, 99, cuda_device)
    view = src.reshape(-1)[1:1 + 96 * B].reshape(96, B)
    _equal(remap.remap_gather(view, idx, valid, bg),
           remap.remap_gather_plain(view, idx, valid, bg))
    torch.cuda.synchronize()


# K2 (remap_lut) on its edges: B, pixels N, source rows R, and what is
# special.  B % 16 == 0 with aligned pointers takes 16-texel vectors, any
# other B (or a source that starts off a 16-byte boundary) single texels;
# B >= 4096 makes rows longer than a block's 256 threads, and more than
# 1,024 items per pixel (4 per thread) makes the block walk a pixel in
# several passes, the last one ragged.
LUT_CASES = {
    "B16": (16, 500, 96, ""),
    "B32": (32, 500, 96, ""),
    "B64": (64, 500, 96, ""),
    "B256": (256, 300, 96, ""),
    "B4112": (4112, 40, 96, ""),      # 257 vectors per pixel
    "B16400": (16400, 7, 24, ""),     # 1,025 vectors: a second pass of one
    "B21184": (21184, 5, 24, ""),     # 1,324 vectors: a second pass ends mid-warp
    "B1": (1, 3000, 96, ""),
    "B15": (15, 500, 96, ""),
    "B17": (17, 500, 96, ""),
    "B300": (300, 300, 96, ""),
    "B1100": (1100, 20, 48, ""),      # a second pass of 76 texels
    "B2600": (2600, 9, 48, ""),       # three passes, the last of 552 texels
    "B64_off16": (64, 500, 96, "offset"),  # src 1 byte off 16: single texels
    "tint_0_255": (32, 2560, 96, "tint_all"),
    "src_every_u8": (16, 600, 256, "src_all"),
    "all_invalid": (64, 500, 96, "invalid"),
    "N1": (64, 1, 96, ""),
    "N2100000_B16": (16, 2_100_000, 1000, ""),  # several chunks per block
}


def _lut_case(case, device):
    B, n, R, kind = LUT_CASES[case]
    rng = np.random.default_rng(len(case) * 104729 + n + B)
    flat = rng.integers(0, 256, R * B + 16, dtype=np.uint8)
    if kind == "src_all":  # row r holds r, r + 1, ...: every value in every lane
        flat[:R * B] = ((np.arange(R)[:, None] + np.arange(B)[None, :]) % 256).reshape(-1)
    flat = torch.from_numpy(flat).to(device)
    src = (flat[1:1 + R * B] if kind == "offset" else flat[:R * B]).reshape(R, B)
    assert (src.data_ptr() % 16 != 0) == (kind == "offset")
    idx = rng.integers(-2 * R - 3, 2 * R + 3, n).astype(np.int32)
    valid = rng.random(n) < (0.0 if kind == "invalid" else 0.8)
    tint = (np.arange(n) % 256 if kind == "tint_all"
            else rng.integers(0, 256, n)).astype(np.uint8)
    bg = rng.integers(0, 256, n, dtype=np.uint8)
    return (src, *(torch.from_numpy(a).to(device) for a in (idx, valid, tint, bg)))


def _lut_equals_plain(src, idx, valid, tint, bg, device):
    """K2 against its plain version for every table combination under both
    out-of-range rules; each call launches the kernel once."""
    pal = torch.from_numpy(default_palette()).to(device)
    tl = torch.from_numpy(tint_lut(default_palette())).to(device)
    n0 = remap.remap_lut.launches
    for luts in ((tl, None), (None, pal), (tl, pal)):
        for fill in (False, True):
            got = remap.remap_lut(src, idx, valid, tint, bg, *luts, fill=fill)
            torch.cuda.synchronize()
            _equal(got, remap.remap_lut_plain(src, idx, valid, tint, bg, *luts, fill=fill))
    assert remap.remap_lut.launches == n0 + 6


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LUT_CASES))
def test_remap_lut_edges_equal_plain(cuda_device, case):
    _lut_equals_plain(*_lut_case(case, cuda_device), cuda_device)


@pytest.mark.cuda
def test_remap_lut_random_frames_1080p(cuda_device):
    """The 1080p main path's operands with uniformly random source bytes at
    B=64: the table lookups' worst case for shared-memory bank conflicts."""
    k = remap.RemapKernel(Session(1920, 1080, device="cpu").lensmap, default_palette(),
                          device=cuda_device)
    g = torch.Generator(cuda_device).manual_seed(3)
    src = torch.randint(0, 256, (6 * 1080 * 1080, 64), dtype=torch.uint8,
                        device=cuda_device, generator=g)
    _lut_equals_plain(src, k.flat_idx, k.valid, k.tint, k.background, cuda_device)


@pytest.mark.cuda
def test_probe_kernels_equal_plain(cuda_device):
    rng = np.random.default_rng(5)
    for W, T, R, B in ((2, 16, 32, 128), (3, 40, 70, 200), (1, 5, 3, 7)):
        idx = torch.from_numpy(rng.integers(-2, R + 2, (W, T)).astype(np.int32))
        src = torch.from_numpy(rng.integers(0, 256, (W, R, B)).astype(np.uint8))
        idx, src = idx.to(cuda_device), src.to(cuda_device)
        _equal(sol.onehot_gather(idx, src), sol.onehot_gather_plain(idx, src))
    for rows in (1, 37, 10240):
        x = torch.from_numpy(rng.integers(0, 256, (rows, 1024), dtype=np.uint8))
        x = x.to(cuda_device)
        _equal(sol.stream_read(x), sol.stream_read_plain(x))
    x = torch.full((10240, 1024), 255, dtype=torch.uint8, device=cuda_device)
    _equal(sol.stream_read(x), sol.stream_read_plain(x))  # the sum wraps int32
    torch.cuda.synchronize()


# K3 (onehot_gather) on its edges: W, T, R, B, source kind, index kind.
# Its tiles are 192 rows t by 128 columns b, its chunks 128 source rows r.
ONEHOT_CASES = {
    "T191": (2, 191, 300, 128, "u8", "mixed"),
    "T192": (2, 192, 300, 128, "u8", "mixed"),
    "T193": (2, 193, 300, 128, "u8", "mixed"),
    "R127": (2, 100, 127, 128, "u8", "mixed"),
    "R128": (2, 100, 128, 128, "u8", "mixed"),
    "R129": (2, 100, 129, 128, "u8", "mixed"),
    "B127": (2, 100, 300, 127, "u8", "mixed"),  # not a multiple of 16: plain loads
    "B128": (2, 100, 300, 128, "u8", "mixed"),  # TMA
    "B129": (2, 100, 300, 129, "u8", "mixed"),
    "B144": (2, 100, 300, 144, "u8", "mixed"),  # TMA, a ragged second b tile
    "B32_off16": (2, 70, 300, 32, "u8_offset", "mixed"),  # src 1 byte off 16: plain loads
    "R1": (2, 50, 1, 32, "u8", "mixed"),
    "idx_out_of_range": (2, 100, 64, 64, "u8", "out_of_range"),
    "src_0_255": (2, 200, 260, 256, "u8", "mixed"),
    "src_all_255": (2, 200, 260, 256, "255", "mixed"),
    "many_tiles_tma": (70, 384, 520, 256, "u8", "mixed"),    # several tiles per block
    "many_tiles_plain": (70, 390, 300, 200, "u8", "mixed"),
    "W70000": (70_000, 1, 2, 1, "u8", "mixed"),   # once over the grid's z limit
    "T2100000": (1, 2_100_000, 2, 1, "u8", "mixed"),  # once over 65535 blocks of 32 rows
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ONEHOT_CASES))
def test_onehot_gather_edges_equal_plain(cuda_device, case):
    W, T, R, B, src_kind, idx_kind = ONEHOT_CASES[case]
    rng = np.random.default_rng(len(case) * 7919 + T)
    if idx_kind == "out_of_range":
        idx = rng.choice(np.array([-1, R, 2**31 - 1], np.int32), (W, T))
    else:
        idx = rng.integers(-2, R + 2, (W, T)).astype(np.int32)
    n = W * R * B
    if src_kind == "255":
        flat = torch.full((n,), 255, dtype=torch.uint8, device=cuda_device)
    else:
        flat = torch.from_numpy(rng.integers(0, 256, n + 16, dtype=np.uint8)).to(cuda_device)
        flat = flat[1:1 + n] if src_kind == "u8_offset" else flat[:n]
    src = flat.reshape(W, R, B)
    assert (src.data_ptr() % 16 != 0) == (src_kind == "u8_offset")
    idx = torch.from_numpy(idx).to(cuda_device)
    n0 = sol.onehot_gather.launches
    got = sol.onehot_gather(idx, src)
    torch.cuda.synchronize()
    assert sol.onehot_gather.launches == n0 + 1
    _equal(got, sol.onehot_gather_plain(idx, src))


@pytest.mark.cuda
def test_launch_counters_count_launches(cuda_device):
    src, idx, valid, bg = _case(8, torch.uint8, 1, cuda_device)
    n0 = remap.remap_gather.launches
    remap.remap_gather(src, idx, valid, bg)
    remap.remap_gather_plain(src, idx, valid, bg)
    remap.remap_gather(src.cpu(), idx.cpu(), valid.cpu(), bg.cpu())
    assert remap.remap_gather.launches == n0 + 1


@pytest.mark.cuda
def test_session_on_card_equals_host(cuda_device):
    """The slice end to end at a small size: Session.render on the card
    (through K1, and K2 for rubix and decode) equals render_host."""
    sess = Session(64, 48, device=cuda_device)
    frames = synthetic_cubemap_batch(48, 3)
    n1, n2 = remap.remap_gather.launches, remap.remap_lut.launches
    out = sess.render(frames)
    assert remap.remap_gather.launches == n1 + 1
    assert out.device.type == "cuda"
    for b in range(3):
        np.testing.assert_array_equal(out[..., b].cpu().numpy(),
                                      sess.render_host(frames[..., b]))
    sess.cmd("f_rubix")
    out = sess.render(frames, decode_rgb=True)
    assert remap.remap_lut.launches == n2 + 1
    np.testing.assert_array_equal(out[..., 1, :].cpu().numpy(),
                                  sess.render_host(frames[..., 1], decode_rgb=True))
    with pytest.raises(ValueError, match="no kernel|must be a contiguous"):
        remap.remap_gather(torch.zeros((4, 2), dtype=torch.uint8, device=cuda_device),
                           torch.zeros(3, dtype=torch.int32),
                           torch.zeros(3, dtype=torch.bool),
                           torch.zeros(3, dtype=torch.uint8))


# ------------------------------------------------------------- the posed path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32])
@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 5, 300])
def test_posed_gather_equals_plain(cuda_device, dtype, k, B):
    """K5 on a ragged 7x9 build grid, indices out of range either side,
    holes in the mask, a per-pixel background."""
    rng = np.random.default_rng(B * 10 + k)
    N, hb, wb = 50, 7, 9
    int32 = dtype == torch.int32
    src = _texels(int32, (B, N), rng, cuda_device)
    bg = _texels(int32, (hb * k, wb * k), rng, cuda_device)
    idx = rng.integers(-N - 3, 2 * N + 3, (B, hb, wb)).astype(np.int32)
    valid = rng.random((B, hb, wb)) < 0.8
    args = [src] + [torch.from_numpy(a).to(cuda_device) for a in (idx, valid)] + [bg]
    n0 = posed.gather_posed.launches
    got = posed.gather_posed(*args, k)
    assert posed.gather_posed.launches == n0 + 1
    _equal(got, posed.gather_posed_plain(*args, k))


def _gather_tables(B, hb, wb, N, mask, rng, device):
    """K5's index and mask tables: indices out of range either side, and a
    random, all-valid or all-invalid mask."""
    idx = rng.integers(-N - 3, 2 * N + 3, (B, hb, wb)).astype(np.int32)
    valid = {"random": rng.random((B, hb, wb)) < 0.8, "all": np.ones((B, hb, wb), bool),
             "none": np.zeros((B, hb, wb), bool)}[mask]
    return torch.from_numpy(idx).to(device), torch.from_numpy(valid).to(device)


def _misaligned(t, offset):
    """The same values in a contiguous slice of a larger tensor, *offset*
    elements past its start (offset 1: a pointer off 16 bytes)."""
    if not offset:
        return t
    flat = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 17, 65, 300])
@pytest.mark.parametrize("mask", ["random", "all", "none"])
@pytest.mark.parametrize("bg_offset", [0, 1], ids=["bg", "bg+1"])
def test_posed_gather_vector_equals_plain(cuda_device, dtype, k, B, mask, bg_offset):
    """K5 on an 8x12 build grid (a width that is a multiple of four: the
    vector kernel at k = 1 and 2, the scalar one at k = 4 and for a
    background one element off its alignment), every batch edge of a
    block's poses and pose group, masks all valid and all invalid."""
    rng = np.random.default_rng(B * 100 + k * 10 + bg_offset)
    N, hb, wb = 61, 8, 12
    int32 = dtype == torch.int32
    src = _texels(int32, (B, N), rng, cuda_device)
    bg = _misaligned(_texels(int32, (hb * k, wb * k), rng, cuda_device), bg_offset)
    idx, valid = _gather_tables(B, hb, wb, N, mask, rng, cuda_device)
    n0 = posed.gather_posed.launches
    got = posed.gather_posed(src, idx, valid, bg, k)
    assert posed.gather_posed.launches == n0 + 1
    _equal(got, posed.gather_posed_plain(src, idx, valid, bg, k))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_posed_gather_1080(cuda_device, dtype, k):
    """K5 on a 270x480 build grid (1080p at k = 4), 17 poses of a 1080p
    frame set."""
    rng = np.random.default_rng(k)
    B, hb, wb, N = 17, 270, 480, 6 * 1080 * 1080
    int32 = dtype == torch.int32
    gen = torch.Generator(cuda_device).manual_seed(k)
    src = torch.randint(-2**31 if int32 else 0, 2**31 if int32 else 256, (B, N), dtype=dtype,
                        device=cuda_device, generator=gen)
    bg = _texels(int32, (hb * k, wb * k), rng, cuda_device)
    idx, valid = _gather_tables(B, hb, wb, N, "random", rng, cuda_device)
    _equal(posed.gather_posed(src, idx, valid, bg, k),
           posed.gather_posed_plain(src, idx, valid, bg, k))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_posed_gather_source_past_int32(cuda_device, k):
    """B * N >= 2^31: 3 poses of 800,000,000 u8 texels (2.4 GB).  The last
    pose reads past element 2^31."""
    B, N, hb, wb = 3, 800_000_000, 8, 12
    assert not posed.flat_gather_safe(B, N)
    rng = np.random.default_rng(k)
    gen = torch.Generator(cuda_device).manual_seed(k)
    src = torch.randint(0, 256, (B, N), dtype=torch.uint8, device=cuda_device, generator=gen)
    bg = _texels(False, (hb * k, wb * k), rng, cuda_device)
    idx, valid = _gather_tables(B, hb, wb, N, "random", rng, cuda_device)
    _equal(posed.gather_posed(src, idx, valid, bg, k),
           posed.gather_posed_plain(src, idx, valid, bg, k))


def _posed_table(globe_name, hb, wb, device, odd_rays=True):
    """The panini ray table of a globe on a ragged build grid, with NaN,
    inf and zero-length rays planted in it."""
    g = globes.get(globe_name)
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, wb, hb)
    t = static_ray.ray_table_from_lens(lens, scale, wb, hb)
    if odd_rays:
        vx, vy, vz = (np.array(a) for a in (t.vx, t.vy, t.vz))
        # zero, NaN and inf rays; lengths whose square underflows, is
        # denormal or nears the float32 maximum; denormal components
        odd = [(0.0, 0.0, 0.0), (np.nan, 0.3, 1.0), (np.inf, 0.0, 1.0),
               (0.0, -np.inf, np.inf), (1e-30, 0.0, 0.0), (0.0, 0.0, -1.0),
               (1e-20, 0.0, 1e-20), (3e-39, -1e-21, 2e-45), (1e19, -1e19, 1e19),
               (-4e-39, 0.0, 1e-38)]
        for i, ray in enumerate(odd):
            y, x = divmod(i * 7 + 3, wb)
            vx[y, x], vy[y, x], vz[y, x] = ray
        t = static_ray.RayTable(wb, hb, vx, vy, vz, np.asarray(t.lens_valid))
    return g, t.device(device)


def _texels(int32, shape, rng, device):
    """Random u8 texels, or int32 ones (packed RGBA bits)."""
    if int32:
        a = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    else:
        a = rng.integers(0, 256, shape, dtype=np.uint8)
    return torch.from_numpy(a).to(device)


def _posed_source(kind, B, S, rng, device):
    planes = 12 if kind == "expanded" else 6
    return _texels(kind == "int32", (B, planes * S * S), rng, device)


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["cube", "cube_corner", "cube_edge", "fast",
                                        "tetra", "trism"])
@pytest.mark.parametrize("kind", ["u8", "expanded", "int32"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_static_ray_posed_equals_plain(cuda_device, globe_name, kind, k):
    """K6 against rays_to_lensmap_torch + gather_posed_plain on the card:
    every globe and source kind, a ragged 37x23 build grid with NaN, inf
    and zero rays, a non-default rubix grid, poses over the sphere."""
    rng = np.random.default_rng(len(globe_name) * 9 + k)
    hb, wb, S, B = 23, 37, 32, 11
    g, table = _posed_table(globe_name, hb, wb, cuda_device)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    poses[0] = 0.0
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    src = _posed_source(kind, B, S, rng, cuda_device)
    bg = _texels(kind == "int32", (hb * k, wb * k), rng, cuda_device)
    grid = (7.0, 2.5, 1.5)
    args = (src, table, bases, g, S, *grid, kind == "expanded", bg, k)
    n0 = static_ray.static_ray_posed.launches
    got = static_ray.static_ray_posed(*args)
    assert static_ray.static_ray_posed.launches == n0 + 1
    _equal(got, static_ray.static_ray_posed_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["cube", "cube_corner", "cube_edge", "fast",
                                        "tetra", "trism"])
@pytest.mark.parametrize("kind", ["u8", "expanded", "int32"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_static_ray_posed_vector_equals_plain(cuda_device, globe_name, kind, k):
    """K6's vector kernels (a build width that is a multiple of the four
    pixels a thread takes; k = 3 takes the scalar kernel) against the plain
    version: every globe and source kind, the odd rays, 11 poses (not a
    multiple of a block's poses or of a pose group)."""
    rng = np.random.default_rng(len(globe_name) * 7 + k)
    hb, wb, S, B = 24, 40, 32, 11
    g, table = _posed_table(globe_name, hb, wb, cuda_device)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    src = _posed_source(kind, B, S, rng, cuda_device)
    bg = _texels(kind == "int32", (hb * k, wb * k), rng, cuda_device)
    args = (src, table, bases, g, S, 7.0, 2.5, 1.5, kind == "expanded", bg, k)
    n0 = static_ray.static_ray_posed.launches
    got = static_ray.static_ray_posed(*args)
    assert static_ray.static_ray_posed.launches == n0 + 1
    _equal(got, static_ray.static_ray_posed_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(10.0, 4.0, 1.0), (7.0, 4.0, 1.0), (0.0, 0.0, 0.0)],
                         ids=["default", "exact-edges", "no-grid"])
def test_static_ray_posed_grid_lines_1080(cuda_device, grid):
    """The expanded source's grid test, read from the host's line table,
    at 1080p plates: the default grid, one whose unit is a whole 30 pixels
    (px / unit lands on block edges exactly), and f_rubixgrid 0 0 0."""
    rng = np.random.default_rng(5)
    hb, wb, S, B = 48, 64, 1080, 3
    g, table = _posed_table("cube", hb, wb, cuda_device, odd_rays=False)
    poses = np.stack([rng.uniform(-60, 60, B), rng.uniform(0, 360, B), np.zeros(B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    src = _posed_source("expanded", B, S, rng, cuda_device)
    bg = torch.zeros((hb, wb), dtype=torch.uint8, device=cuda_device)
    args = (src, table, bases, g, S, *grid, True, bg, 1)
    _equal(static_ray.static_ray_posed(*args), static_ray.static_ray_posed_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 17, 300])
def test_static_ray_posed_batch_edges(cuda_device, B):
    """One pose, and batches that are not a multiple of a block's poses
    (17 also leaves a short pose group)."""
    rng = np.random.default_rng(B)
    hb, wb, S = 24, 32, 24
    g, table = _posed_table("cube", hb, wb, cuda_device)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    src = _posed_source("expanded", B, S, rng, cuda_device)
    bg = torch.full((hb, wb), 7, dtype=torch.uint8, device=cuda_device)
    args = (src, table, bases, g, S, 10.0, 4.0, 1.0, True, bg, 1)
    _equal(static_ray.static_ray_posed(*args), static_ray.static_ray_posed_plain(*args))


@pytest.mark.cuda
def test_static_ray_posed_source_past_int32(cuda_device):
    """B * N >= 2^31: 160 poses of an expanded 1080p source (2.24 GB of
    u8).  The last pose reads past byte 2^31 and equals the plain version
    of that pose alone."""
    B, S = 160, 1080
    N = 12 * S * S
    assert B * N >= 2**31 and not posed.flat_gather_safe(B, N)
    hb, wb = 48, 64
    g, table = _posed_table("cube", hb, wb, cuda_device, odd_rays=False)
    gen = torch.Generator(cuda_device).manual_seed(0)
    src = torch.randint(0, 256, (B, N), dtype=torch.uint8, device=cuda_device,
                        generator=gen)
    poses = np.stack([np.linspace(-60, 60, B), np.linspace(0, 350, B), np.zeros(B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    bg = torch.zeros((hb, wb), dtype=torch.uint8, device=cuda_device)
    got = static_ray.static_ray_posed(src, table, bases, g, S, 10.0, 4.0, 1.0, True, bg, 1)
    for b in (0, B - 1):
        ref = static_ray.static_ray_posed_plain(src[b:b + 1].contiguous(), table,
                                                bases[b:b + 1], g, S, 10.0, 4.0, 1.0,
                                                True, bg, 1)
        _equal(got[b:b + 1], ref)


def _host_tables(monkeypatch):
    """Both sessions take the float64 host ray table: the float32 lens
    stage's transcendentals differ between the card and the CPU in their
    last bits, which is held by a tolerance elsewhere, while this file's
    session comparisons are bit for bit."""
    def host_table(lens, globe, scale, w, h, platesize=None, lensmap=None, device=None):
        return static_ray.ray_table_from_lens(lens, scale, w, h, backend="numpy")

    monkeypatch.setattr(static_ray, "build_ray_table", host_table)


# screen W, H, platesize and the render scales valid for it: a ragged build
# width (62, and 100 / 2 = 50, are no multiple of the four pixels a thread of
# K6 takes), k = 2 build grids, a plate smaller than the screen
POSED_SIZES = {"64x48": (64, 48, 48, (1, 2)), "62x46": (62, 46, 32, (1,)),
               "72x40": (72, 40, 40, (1, 2)), "100x60": (100, 60, 24, (1, 2))}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
@pytest.mark.parametrize("size", list(POSED_SIZES))
def test_session_render_posed_on_card_equals_cpu(cuda_device, monkeypatch, size, kind, seed):
    """render_posed end to end at small sizes: the card's session (K7, K6,
    and K5 for exact=True) equals the CPU session's plain versions, for
    u8, expanded and RGBA sources, ragged and k = 2 build grids, and seeded
    pose sets that hold the identity, a pole and a half turn."""
    _host_tables(monkeypatch)
    W, H, S, scales = POSED_SIZES[size]
    rng = np.random.default_rng(seed * 31 + len(size))
    B = int(rng.integers(3, 20))
    frames = rng.integers(0, 256, (6, S, S, B), dtype=np.uint8)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(-360, 360, B),
                      rng.uniform(-180, 180, B)], 1)
    poses[0] = (0.0, 0.0, 0.0)
    poses[1] = (89.0, 180.0, 0.0)
    poses[2] = (-90.0, 0.0, 0.0)
    card = Session(W, H, platesize=S, device=cuda_device)
    cpu = Session(W, H, platesize=S, device="cpu")
    if seed == 1:
        bg = rng.integers(0, 256, (H, W), dtype=np.uint8)
        for sess in (card, cpu):
            sess.cmd("f_fov 150; f_rubixgrid 7 2.5 1.5")
            sess.set_background(bg)
    fr = {"u8": frames, "expanded": remap.expand_frames_tinted(frames, card.palette),
          "rgba": remap.frames_to_rgba(frames, card.palette)}[kind]
    for k in scales:
        n6 = static_ray.static_ray_posed.launches
        n7 = posed.posed_layout.launches
        got = card.render_posed(fr, poses, render_scale=k)
        assert static_ray.static_ray_posed.launches == n6 + 1
        assert posed.posed_layout.launches == n7 + 1
        assert got.device.type == "cuda"
        _equal(got.cpu(), cpu.render_posed(fr, poses, render_scale=k))
    n5 = posed.gather_posed.launches
    got = card.render_posed(fr[..., :2], poses[:2], exact=True)
    assert posed.gather_posed.launches == n5 + 1
    _equal(got.cpu(), cpu.render_posed(fr[..., :2], poses[:2], exact=True))


# the twelve lenses that came with the forward rasterizer
NEW_LENSES = ["debug", "eckert1", "eckert5", "gins8", "kavrayskiy7", "larrivee",
              "polyconic", "quincuncial", "sinusoidal", "wagner6", "winkel1", "winkel2"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", NEW_LENSES)
def test_new_lens_renders_on_card_equal_cpu(cuda_device, name):
    """Each of the twelve lenses through Session.render on the card (K1, K2
    for rubix) equals the CPU session: the exact host build on both sides.
    quincuncial and debug also take the float32 builder on the card (the
    lens stage, K8), whose render equals host_remap of its own table."""
    frames = synthetic_cubemap_batch(48, 3)
    card = Session(64, 48, device=cuda_device)
    cpu = Session(64, 48, device="cpu")
    for sess in (card, cpu):
        sess.cmd(f"f_lens {name}")
    assert card.lens_valid
    n1, n2 = remap.remap_gather.launches, remap.remap_lut.launches
    _equal(card.render(frames).cpu(), cpu.render(frames))
    _equal(card.render(frames, rubix=True).cpu(), cpu.render(frames, rubix=True))
    assert remap.remap_gather.launches == n1 + 1 and remap.remap_lut.launches == n2 + 1
    if card.lens.map_type == "forward":
        return
    dev = Session(64, 48, device=cuda_device, backend="torch")
    dev.cmd(f"f_lens {name}")
    n8 = builder.lensmap_resolve.launches
    out = dev.render(frames)
    assert builder.lensmap_resolve.launches == n8 + 1
    assert isinstance(dev._lensmap.flat_idx, torch.Tensor)
    for b in range(3):
        np.testing.assert_array_equal(out[..., b].cpu().numpy(),
                                      dev.render_host(frames[..., b]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
def test_forward_lens_render_posed_on_card_equals_cpu(cuda_device, kind):
    """eckert1's render_posed on the card (K7, K6 on the rasterized table's
    texel-centre rays; K5 for exact=True) equals the CPU session at render
    scales 1 and 2 and with exact=True."""
    rng = np.random.default_rng(7)
    B = 9
    frames = rng.integers(0, 256, (6, 48, 48, B), dtype=np.uint8)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(-360, 360, B),
                      rng.uniform(-180, 180, B)], 1)
    poses[0] = (0.0, 0.0, 0.0)
    card = Session(64, 48, device=cuda_device)
    cpu = Session(64, 48, device="cpu")
    for sess in (card, cpu):
        sess.cmd("f_lens eckert1")
    fr = {"u8": frames, "expanded": remap.expand_frames_tinted(frames, card.palette),
          "rgba": remap.frames_to_rgba(frames, card.palette)}[kind]
    for k in (1, 2):
        n6 = static_ray.static_ray_posed.launches
        got = card.render_posed(fr, poses, render_scale=k)
        assert static_ray.static_ray_posed.launches == n6 + 1
        assert card._posed_cache[1].ray_table.source == "lensmap"
        _equal(got.cpu(), cpu.render_posed(fr, poses, render_scale=k))
    n5 = posed.gather_posed.launches
    got = card.render_posed(fr[..., :2], poses[:2], exact=True)
    assert posed.gather_posed.launches == n5 + 1
    _equal(got.cpu(), cpu.render_posed(fr[..., :2], poses[:2], exact=True))


# ------------------------------------------------------ K7, the posed layout


def _frames(dtype, P, S, B, rng, device):
    int32 = dtype == torch.int32
    return _texels(int32, (P, S, S, B), rng, device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("P", [1, 3, 6, 12])
@pytest.mark.parametrize("B", [1, 3, 16, 63, 64, 65, 200])
@pytest.mark.parametrize("S", [5, 64])
def test_posed_layout_equals_plain(cuda_device, dtype, P, B, S):
    """K7 bit-equal to its plain version and to permute().contiguous():
    u8 and int32, P < 6 padded with zero planes, every batch edge of the
    vector path (B a multiple of 16 u8 or 4 RGBA words) and the scalar one."""
    rng = np.random.default_rng(P * 1000 + B * 10 + S)
    frames = _frames(dtype, P, S, B, rng, cuda_device)
    planes = 12 if P == 12 else 6
    n0 = posed.posed_layout.launches
    got = posed.posed_layout(frames, planes)
    assert posed.posed_layout.launches == n0 + 1
    _equal(got, posed.posed_layout_plain(frames, planes))
    _equal(got[:, :P * S * S], frames.permute(3, 0, 1, 2).reshape(B, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("P,B", [(6, 64), (12, 1), (3, 65), (6, 63)])
def test_posed_layout_1080(cuda_device, dtype, P, B):
    """K7 at 1080p plates: the main path's shape, the expanded source at
    one pose, zero planes with a ragged batch, a ragged batch."""
    S = 1080
    gen = torch.Generator(cuda_device).manual_seed(P + B)
    frames = torch.randint(0, 256, (P, S, S, B), dtype=torch.uint8, device=cuda_device,
                           generator=gen)
    if dtype == torch.int32:
        frames = frames.int() * 16843009  # every byte of the word set
    planes = 12 if P == 12 else 6
    _equal(posed.posed_layout(frames, planes), posed.posed_layout_plain(frames, planes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("lo,hi", [(1, 65), (16, 32), (3, 4), (0, 64)])
def test_posed_layout_batch_slices(cuda_device, dtype, lo, hi):
    """A batch slice of a wider array: a row stride above B, an unaligned
    pointer (lo not a multiple of 16 bytes) and one pose of many."""
    rng = np.random.default_rng(lo * 100 + hi)
    frames = _frames(dtype, 6, 24, 80, rng, cuda_device)[..., lo:hi]
    got = posed.posed_layout(frames, 6)
    _equal(got, posed.posed_layout_plain(frames, 6))
    rgba = dtype == torch.int32  # RGBA frames enter the Session's path as uint32
    src, _, _ = posed.prep_posed_inputs(
        frames.view(torch.uint32) if rgba else frames, np.tile(np.eye(3), (hi - lo, 1, 1)),
        24, torch.zeros((8, 8), dtype=dtype, device=cuda_device), cuda_device)
    _equal(src, got)


def _layout_equal(frames, planes):
    """K7 once, bit-equal to its plain version and to permute().contiguous()."""
    P, S, _, B = frames.shape
    n0 = posed.posed_layout.launches
    got = posed.posed_layout(frames, planes)
    assert posed.posed_layout.launches == n0 + 1
    _equal(got, posed.posed_layout_plain(frames, planes))
    _equal(got[:, :P * S * S], frames.permute(3, 0, 1, 2).contiguous().reshape(B, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("P", [3, 6, 12])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 15, 17, 63, 100])
@pytest.mark.parametrize("S", [5, 64, 1080])
def test_posed_layout_contiguous_batches(cuda_device, dtype, P, B, S):
    """K7 on contiguous batches: the span tiles (rows up to 256 bytes that
    are no multiple of 16), the vector path where B allows it, and the
    chunked tiles of RGBA's 100 poses."""
    gen = torch.Generator(cuda_device).manual_seed(P * 1000 + B * 10 + S)
    frames = torch.randint(0, 256, (P, S, S, B), dtype=torch.uint8, device=cuda_device,
                           generator=gen)
    if dtype == torch.int32:
        frames = frames.int() * 16843009 + torch.arange(B, device=cuda_device, dtype=torch.int32)
    _layout_equal(frames, 12 if P == 12 else 6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("width", [1, 2, 5, 8, 40])
@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("S", [24, 1080])
def test_posed_layout_slices(cuda_device, dtype, width, offset, S):
    """K7 on batch slices frames[..., lo:lo + width] of a 64-pose batch:
    the one-pose column path, the slice tiles (render_posed's chunks), and
    their prep_posed_inputs."""
    gen = torch.Generator(cuda_device).manual_seed(width * 10 + offset + S)
    full = torch.randint(0, 256, (6, S, S, 64), dtype=torch.uint8, device=cuda_device,
                         generator=gen)
    if dtype == torch.int32:
        full = full.int() * 16843009
    frames = full[..., offset:offset + width]
    _layout_equal(frames, 6)
    rgba = dtype == torch.int32
    src, _, _ = posed.prep_posed_inputs(
        frames.view(torch.uint32) if rgba else frames, np.tile(np.eye(3), (width, 1, 1)), S,
        torch.zeros((8, 8), dtype=dtype, device=cuda_device), cuda_device)
    _equal(src, posed.posed_layout_plain(frames, 6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("B", [1, 3, 16, 63, 64])
@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "slice"])
def test_posed_layout_misaligned_base(cuda_device, dtype, B, sliced):
    """K7 on frames whose base pointer is off 16 bytes (a contiguous view
    one element into a larger tensor), whole or as the slice [..., 1:B]."""
    rng = np.random.default_rng(B * 2 + sliced)
    frames = _misaligned(_frames(dtype, 6, 24, B + 1, rng, cuda_device), 1)
    assert frames.data_ptr() % 16
    _layout_equal(frames[..., 1:] if sliced else frames, 6)


def _strided(frames, layout):
    """The same frames [P, S, S, B] in another memory layout: the plate
    axes swapped in memory, or stored pose-major ([B, P, S, S] permuted)."""
    if layout == "transpose12":
        return frames.transpose(1, 2).contiguous().transpose(1, 2)
    return frames.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32], ids=["u8", "int32"])
@pytest.mark.parametrize("P,B", [(6, 8), (3, 5), (12, 33), (6, 1)])
def test_posed_layout_takes_uneven_strides(cuda_device, dtype, P, B):
    """Texels that are not evenly strided go through K7's strided path and
    equal the plain version: the plate axes swapped in memory, every other
    column of a wider array, and a pose-major array with too few planes."""
    rng = np.random.default_rng(P * 100 + B)
    S = 24
    frames = _frames(dtype, P, S, B, rng, cuda_device)
    planes = 12 if P == 12 else 6
    wide = _frames(dtype, P, S, 2 * S, rng, cuda_device)[:, :, :, :B]
    for fr in (_strided(frames, "transpose12"), _strided(frames, "pose_major"),
               _frames(dtype, P, S * 2, B, rng, cuda_device)[:, ::2, ::2], wide.transpose(1, 2)):
        n0 = posed.posed_layout.launches
        got = posed.posed_layout(fr, planes)
        assert posed.posed_layout.launches == n0 + 1
        _equal(got, posed.posed_layout_plain(fr, planes))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
@pytest.mark.parametrize("layout", ["transpose12", "pose_major"])
def test_posed_entry_points_take_strided_frames(cuda_device, monkeypatch, kind, layout):
    """Frames whose plate axes are swapped in memory, and frames stored
    pose-major, render through render_posed, render_posed(exact=True) and
    StaticRayPosedKernel.__call__ on the card, equal to the CPU session on
    the same strided frames.  The pose-major tensor is used in place: K7 is
    not launched for it."""
    _host_tables(monkeypatch)
    W, H, S, B = 64, 48, 48, 5
    frames = synthetic_cubemap_batch(S, B)
    poses = np.array([(0.0, 0.0, 0.0), (5.0, -12.0, 0.0), (-20.0, 33.0, 10.0),
                      (89.0, 180.0, 0.0), (0.0, 271.0, -45.0)])
    card = Session(W, H, platesize=S, device=cuda_device)
    cpu = Session(W, H, platesize=S, device="cpu")
    fr = {"u8": frames, "expanded": remap.expand_frames_tinted(frames, card.palette),
          "rgba": remap.frames_to_rgba(frames, card.palette)}[kind]
    rgba = kind == "rgba"
    t = torch.from_numpy(fr.view(np.int32) if rgba else fr)

    def laid_out(device):
        x = _strided(t.to(device), layout)
        assert not x.is_contiguous()
        return x.view(torch.uint32) if rgba else x

    on_card, on_cpu = laid_out(cuda_device), laid_out("cpu")
    n7 = posed.posed_layout.launches
    want = cpu.render_posed(on_cpu, poses)
    _equal(card.render_posed(on_card, poses).cpu(), want)
    _equal(want, cpu.render_posed(fr, poses))  # the layout changes nothing
    assert posed.posed_layout.launches == n7 + (0 if layout == "pose_major" else 1)
    _equal(card.render_posed(on_card[..., :2], poses[:2], exact=True).cpu(),
           cpu.render_posed(on_cpu[..., :2], poses[:2], exact=True))
    scale = calc_scale(card.zoom, card.lens, W, H)
    bg = np.zeros((H, W), np.uint32 if rgba else np.uint8)
    kerns = [static_ray.StaticRayPosedKernel(card.lens, card.globe, W, H, scale, platesize=S,
                                             background=bg, device=d)
             for d in (cuda_device, "cpu")]
    bases = posed.bases_from_pose_track(poses)
    _equal(kerns[0](on_card, bases).cpu(), kerns[1](on_cpu, bases))


@pytest.mark.cuda
@pytest.mark.parametrize("P", [6, 12])
def test_prep_posed_inputs_one_pose_is_a_view(cuda_device, P):
    """One pose of 6 or 12 contiguous planes: the pose-major array is the
    frames themselves, with no launch; 3 planes still pad through K7."""
    frames = torch.arange(P * 24 * 24, device=cuda_device).to(torch.uint8).reshape(
        P, 24, 24, 1)
    bg = torch.zeros((8, 8), dtype=torch.uint8, device=cuda_device)
    n0 = posed.posed_layout.launches
    src, _, _ = posed.prep_posed_inputs(frames, np.eye(3)[None], 24, bg, cuda_device)
    assert posed.posed_layout.launches == n0
    assert src.data_ptr() == frames.data_ptr()
    _equal(src, posed.posed_layout_plain(frames, P))
    src3, _, _ = posed.prep_posed_inputs(frames[:3], np.eye(3)[None], 24, bg, cuda_device)
    assert posed.posed_layout.launches == n0 + 1
    _equal(src3, posed.posed_layout_plain(frames[:3], 6))


# ------------------------------------------- K8, the float32 builder's resolve

FIELDS = ("plate", "px", "py", "valid", "tint", "flat_idx", "plates_used")
BASES = {"identity": (0.0, 0.0, 0.0), "yawed": (10.0, 30.0, 0.0), "rolled": (-75.0, 200.0, 33.0)}


def _tables_equal(got, want):
    for f in FIELDS:
        assert got[f].dtype == want[f].dtype and got[f].shape == want[f].shape, f
        assert torch.equal(got[f], want[f]), f


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["cube", "cube_corner", "cube_edge", "fast",
                                        "tetra", "trism"])
@pytest.mark.parametrize("basis", list(BASES))
@pytest.mark.parametrize("grid", [(10.0, 4.0, 1.0), (7.0, 2.5, 1.5), (0.0, 0.0, 0.0)],
                         ids=["default", "odd-grid", "no-grid"])
def test_lensmap_resolve_equals_plain(cuda_device, globe_name, basis, grid):
    """K8 against rays_to_lensmap_torch on the same rays on the card, every
    table bit for bit: every globe, a ragged 37x23 grid with NaN, inf, zero
    and denormal rays, three view bases, three rubix grids."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    hb, wb, S = 23, 37, 32
    g, t = _posed_table(globe_name, hb, wb, cuda_device)
    vb = view_basis_from_angles(*BASES[basis])
    n0 = builder.lensmap_resolve.launches
    got = builder.lensmap_resolve(g, t.vx, t.vy, t.vz, t.lens_valid, S, *grid, vb)
    torch.cuda.synchronize()
    assert builder.lensmap_resolve.launches == n0 + 1
    want = builder.rays_to_lensmap_torch(
        g, t.vx, t.vy, t.vz, t.lens_valid, S, *grid,
        view_basis=torch.from_numpy(np.asarray(vb, np.float64)).to(cuda_device))
    _tables_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", lenses.BUILTIN_LENSES)
@pytest.mark.parametrize("size", [(64, 48, 48), (61, 37, 40), (32, 24, 1080)],
                         ids=["64x48", "61x37", "S1080"])
def test_build_lensmap_torch_on_card(cuda_device, name, size):
    """build_lensmap(backend="torch") on the card for every lens: an
    inverse lens's tables equal the plain version's on the lens stage's own
    rays (the NaN and inf the lenses leave to IEEE among them), and lie
    within the boundary tolerance of the CPU's float32 build (the card's
    float32 transcendentals differ from the CPU's in their last bits).  A
    forward-only lens has no float32 builder: it rasterizes on the host,
    NumPy tables equal to the exact build, and launches no K8."""
    W, H, S = size
    g = globes.get("cube")
    lens = lenses.get(name, g)
    zoom = (lens.onload or "f_fov 180").split()
    scale = calc_scale(Zoom(zoom[0][2:], *map(int, zoom[1:])), lens, W, H)
    vb = np.eye(3)[[2, 0, 1]]  # the identity: forward z, right x, up y
    n0 = builder.lensmap_resolve.launches
    lm = build_lensmap(lens, g, scale, W, H, S, backend="torch", device=cuda_device)
    if lens.map_type == "forward":
        assert builder.lensmap_resolve.launches == n0
        exact = build_lensmap(lens, g, scale, W, H, S)
        for f in FIELDS:
            assert isinstance(getattr(lm, f), np.ndarray), f
            np.testing.assert_array_equal(getattr(lm, f), getattr(exact, f), err_msg=f)
        return
    assert builder.lensmap_resolve.launches == n0 + 1
    assert lm.flat_idx.device.type == "cuda"
    rays = builder.lens_rays_torch(lens, scale, W, H, cuda_device)
    want = builder.rays_to_lensmap_torch(g, *rays, S, 10, 4.0, 1.0,
                                         view_basis=torch.from_numpy(vb).to(cuda_device))
    _tables_equal({f: getattr(lm, f) for f in FIELDS}, want)
    cpu = build_lensmap(lens, g, scale, W, H, S, backend="torch", device="cpu")
    drift = float((lm.to_numpy().flat_idx != cpu.to_numpy().flat_idx).mean())
    assert drift <= 0.15, drift  # tests/test_lensmap_parity.py's share for float32 noise


@pytest.mark.cuda
def test_lensmap_resolve_1080(cuda_device):
    """K8 at the main path's size, panini + cube and the fast globe, the
    identity and a rotated basis."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    for globe_name in ("cube", "fast"):
        g = globes.get(globe_name)
        lens = lenses.get("panini", g)
        scale = calc_scale(Zoom("fov", 180), lens, 1920, 1080)
        rays = builder.lens_rays_torch(lens, scale, 1920, 1080, cuda_device)
        for angles in BASES.values():
            vb = view_basis_from_angles(*angles)
            got = builder.lensmap_resolve(g, *rays, 1080, 10, 4.0, 1.0, vb)
            want = builder.rays_to_lensmap_torch(
                g, *rays, 1080, 10, 4.0, 1.0,
                view_basis=torch.from_numpy(np.asarray(vb, np.float64)).to(cuda_device))
            _tables_equal(got, want)


def _odd_ray_planes(device):
    """[1, 4, 8] ray planes whose components are infinite, NaN, zero or
    denormal, beside ordinary ones."""
    odd = [(np.inf, 0.0, 1.0), (0.0, np.inf, 1.0), (0.2, 0.1, np.inf), (-np.inf, 0.0, 1.0),
           (np.nan, 0.3, 1.0), (0.0, 0.0, 0.0), (1e-30, 0.0, 0.0), (3e-39, -1e-21, 2e-45),
           (0.1, 0.2, 1.0), (0.0, 0.0, 1.0), (1e19, -1e19, 1e19), (0.0, 0.0, -1.0)]
    rays = np.array((odd * 3)[:32], np.float32).T.reshape(3, 1, 4, 8)
    vx, vy, vz = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in rays)
    return vx, vy, vz, torch.ones((1, 4, 8), dtype=torch.bool, device=device)


@pytest.mark.cuda
def test_rotation_by_identity_is_not_no_rotation(cuda_device):
    """K8 always rotates and K9 never does.  For a ray with an infinite
    component the identity rotation makes the other components NaN
    (inf * 0) where no rotation leaves them; each kernel equals its plain
    version on such rays bit for bit.  The normalize turns the infinite
    component itself into NaN either way (inf * (1 / inf)), so both call
    these pixels invalid, and the finite rays resolve alike."""
    g = globes.get("cube")
    S = 16
    vx, vy, vz, lv = _odd_ray_planes(cuda_device)
    ident = torch.from_numpy(np.eye(3)[[2, 0, 1]]).to(cuda_device)
    k8 = builder.lensmap_resolve(g, vx[0], vy[0], vz[0], lv[0], S, 10, 4.0, 1.0, ident)
    _tables_equal(k8, builder.rays_to_lensmap_torch(g, vx[0], vy[0], vz[0], lv[0], S, 10, 4.0,
                                                     1.0, view_basis=ident))
    plain = builder.rays_to_lensmap_torch(g, vx[0], vy[0], vz[0], lv[0], S, 10, 4.0, 1.0)
    _tables_equal(k8, plain)
    assert bool(plain["valid"].any()) and not bool(plain["valid"][0, :5].any())
    src = torch.arange(6 * S * S, device=cuda_device).to(torch.uint8)
    bg = torch.full((4, 8), 255, dtype=torch.uint8, device=cuda_device)
    k9 = posed.sweep_remap(src, vx, vy, vz, lv, g, S, 10.0, 4.0, 1.0, False, bg)
    _equal(k9, posed.sweep_remap_plain(src, vx, vy, vz, lv, g, S, 10.0, 4.0, 1.0, False, bg))
    want = torch.where(plain["valid"], src[plain["flat_idx"].long()], bg)
    _equal(k9[0], want)


# ------------------------------------------------------- K9, the fused sweep


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["cube", "cube_corner", "cube_edge", "fast",
                                        "tetra", "trism"])
@pytest.mark.parametrize("kind", ["u8", "expanded", "int32"])
@pytest.mark.parametrize("size", [(23, 37), (24, 40)], ids=["ragged", "vector"])
def test_sweep_remap_equals_plain(cuda_device, globe_name, kind, size):
    """K9 against its plain version on the card: every globe and source
    kind, a ragged screen (the scalar kernel) and one whose pixels are a
    multiple of four (the vector kernel), five zoom steps each with NaN,
    inf and zero rays, a non-default rubix grid, holes in the lens mask."""
    hb, wb = size
    rng = np.random.default_rng(len(globe_name) * 5 + hb)
    S, steps = 32, 5
    tables = []
    for n in range(steps):
        g, t = _posed_table(globe_name, hb, wb, cuda_device)
        f = 0.6 + 0.35 * n
        tables.append((t.vx * f, t.vy * f, t.vz, t.lens_valid
                       & (torch.rand((hb, wb), device=cuda_device) > 0.1)))
    vx, vy, vz, lv = (torch.stack(p).contiguous() for p in zip(*tables))
    src = _posed_source(kind, 1, S, rng, cuda_device)[0]
    bg = _texels(kind == "int32", (hb, wb), rng, cuda_device)
    for grid in ((7.0, 2.5, 1.5), (0.0, 0.0, 0.0)):
        args = (src, vx, vy, vz, lv, g, S, *grid, kind == "expanded", bg)
        n0 = posed.sweep_remap.launches
        got = posed.sweep_remap(*args)
        torch.cuda.synchronize()
        assert posed.sweep_remap.launches == n0 + 1
        _equal(got, posed.sweep_remap_plain(*args))
    # a view that starts off a 16-byte boundary takes the scalar kernel
    off = torch.empty(vx.numel() + 1, device=cuda_device)[1:].reshape(vx.shape).copy_(vx)
    _equal(posed.sweep_remap(src, off, vy, vz, lv, g, S, 10.0, 4.0, 1.0, kind == "expanded", bg),
           posed.sweep_remap_plain(src, off, vy, vz, lv, g, S, 10.0, 4.0, 1.0,
                                   kind == "expanded", bg))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["panini", "fisheye1", "winkeltripel", "cube"])
@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
def test_zoom_sweep_remap_equals_per_step_loop(cuda_device, name, kind):
    """The fused sweep on the card equals a per-step loop of
    Session(backend="torch") on the card bit for bit: the lens stage is
    elementwise, and the identity rotation of the Session's build changes
    no pixel (test_rotation_by_identity_is_not_no_rotation)."""
    W, H, S = 64, 48, 48
    sess = Session(W, H, platesize=S, device=cuda_device, backend="torch")
    sess.cmd(f"f_lens {name}")
    frame = synthetic_cubemap_batch(S, 1)[..., 0]
    fr = {"u8": frame, "expanded": remap.expand_frames_tinted(frame, sess.palette),
          "rgba": remap.frames_to_rgba(frame, sess.palette)}[kind]
    bg = np.random.default_rng(2).integers(0, 256, (H, W), dtype=np.uint8)
    sess.set_background(bg)
    fovs = [60, 100, 140, 179] if sess.lens.max_fov <= 180 else [100, 180, 250, 330]
    scales, loop = [], []
    for fov in fovs:
        sess.cmd(f"f_fov {fov}")
        loop.append(sess.render(fr, rubix=kind == "expanded"))
        scales.append(sess.lensmap.scale)
    n9 = posed.sweep_remap.launches
    got = posed.zoom_sweep_remap(
        sess.lens, sess.globe, scales, fr, W, H,
        background=remap.frames_to_rgba(bg, sess.palette) if kind == "rgba" else bg,
        device=cuda_device)
    assert posed.sweep_remap.launches == n9 + 1
    want = torch.stack(loop)
    assert got.dtype == want.dtype
    bits = (lambda x: x.view(torch.int32) if x.dtype == torch.uint32 else x)
    _equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "expanded", "rgba"])
@pytest.mark.parametrize("k", [1, 2])
def test_posed_remap_kernel_on_card(cuda_device, kind, k):
    """PosedRemapKernel on the card (the float32 lens stage, K7, K6)
    bit-equals its plain version on the card on the same ray table."""
    W, H, S, B = 64, 48, 48, 7
    g = globes.get("cube")
    lens = lenses.get("panini", g)
    scale = calc_scale(Zoom("fov", 180), lens, W, H)
    frames = synthetic_cubemap_batch(S, B)
    pal = default_palette()
    fr = {"u8": frames, "expanded": remap.expand_frames_tinted(frames, pal),
          "rgba": remap.frames_to_rgba(frames, pal)}[kind]
    rng = np.random.default_rng(k)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    bases = posed.bases_from_pose_track(poses)
    bg = np.zeros((H, W), np.uint32 if kind == "rgba" else np.uint8)
    kern = posed.PosedRemapKernel(lens, g, W, H, scale, platesize=S, background=bg,
                                  render_scale=k, device=cuda_device)
    n6 = static_ray.static_ray_posed.launches
    got = kern(fr, bases)
    assert static_ray.static_ray_posed.launches == n6 + 1
    src, b32, expanded = posed.prep_posed_inputs(fr, bases, S, kern.background, cuda_device)
    want = static_ray.static_ray_posed_plain(src, kern.ray_table, b32, g, S, 10.0, 4.0, 1.0,
                                             expanded, kern.background, k)
    _equal(got.view(torch.int32) if kind == "rgba" else got, want)


@pytest.mark.cuda
def test_session_backend_torch_on_card(cuda_device):
    """Session(backend="torch") and setviewangles under "auto" on the card:
    the lensmap is built there through K8 and feeds K1 without a trip
    through the host; the screens equal host_remap of the same table."""
    frames = synthetic_cubemap_batch(48, 3)
    for backend, cmds in (("torch", []), ("auto", ["setviewangles 10 30 0"])):
        sess = Session(64, 48, device=cuda_device, backend=backend)
        for c in cmds:
            sess.cmd(c)
        n8, n1 = builder.lensmap_resolve.launches, remap.remap_gather.launches
        out = sess.render(frames)
        assert builder.lensmap_resolve.launches == n8 + 1
        assert remap.remap_gather.launches == n1 + 1
        assert sess._lensmap.flat_idx.device.type == "cuda"
        lm = sess.lensmap
        assert isinstance(lm.flat_idx, np.ndarray)
        for b in range(3):
            np.testing.assert_array_equal(out[..., b].cpu().numpy(),
                                          remap.host_remap(lm, frames[..., b], sess.palette))
        sess.cmd("f_rubix")
        rub = sess.render(frames)
        np.testing.assert_array_equal(
            rub[..., 1].cpu().numpy(),
            remap.host_remap(lm, frames[..., 1], sess.palette, rubix=True))
        assert sess.warm_device_builder()


# ---------------------- the plain view, time-sliced builds and f_saveglobe


def _host_rays(monkeypatch):
    """The float32 lens stage computed on the CPU and moved to the card, so
    that K8's tables on the card and its plain version's on the CPU come
    from the same rays (the stage's transcendentals differ between the
    card and the CPU in their last bits)."""
    lens_rays = builder.lens_rays_torch

    def host_rays(lens, scale, w, h, device, dtype=torch.float32):
        return tuple(t.to(device) for t in lens_rays(lens, scale, w, h, torch.device("cpu"),
                                                     dtype))

    monkeypatch.setattr(builder, "lens_rays_torch", host_rays)


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["u8", "rgba"])
def test_plain_view_on_card_equals_cpu(cuda_device, monkeypatch, source):
    """fisheye 0 on the card: the plain view's K1, and K2 for decode_rgb,
    equal the CPU session's plain versions at two fov values; a rotated
    plain view builds through K8 and equals the CPU's float32 build."""
    _host_rays(monkeypatch)
    frames = synthetic_cubemap_batch(48, 3)
    card = Session(64, 48, device=cuda_device)
    cpu = Session(64, 48, device="cpu")
    fr = frames if source == "u8" else remap.frames_to_rgba(frames, card.palette)
    view = (lambda t: t.view(torch.int32)) if source == "rgba" else (lambda t: t)
    for cmd in ("fisheye 0; fov 90", "fov 110", "setviewangles 10 30 0"):
        for sess in (card, cpu):
            sess.cmd(cmd)
        n1, n2, n8 = (remap.remap_gather.launches, remap.remap_lut.launches,
                      builder.lensmap_resolve.launches)
        got = card.render(fr)
        assert remap.remap_gather.launches == n1 + 1
        assert builder.lensmap_resolve.launches == n8 + cmd.startswith("setviewangles")
        assert got.device.type == "cuda"
        _equal(view(got).cpu(), view(cpu.render(fr)))
        if source == "u8":
            rgb = card.render(fr, decode_rgb=True)
            assert remap.remap_lut.launches == n2 + 1
            _equal(rgb.cpu(), cpu.render(fr, decode_rgb=True))
        assert card._lensmap is None  # the fisheye view was never built


@pytest.mark.cuda
def test_sliced_build_device_preview_on_card(cuda_device, monkeypatch):
    """Session(build_budget_s=...) on the card: warm on the card, a lens
    switch previews through the float32 builder there (K8, then K1), equal
    to the CPU session's preview warmed on the CPU; both swap to the exact
    table, equal to a blocking build."""
    _host_rays(monkeypatch)
    frames = synthetic_cubemap_batch(32, 2)
    sessions = {}
    for dev in (cuda_device, torch.device("cpu")):
        sess = Session(64, 48, platesize=32, device=dev, build_budget_s=0.0005)
        sess.cmd("f_lens winkeltripel")
        sess.lensmap
        assert sess.warm_device_builder()
        sess.cmd("f_fov 140")
        sessions[dev.type] = sess
    card, cpu = sessions["cuda"], sessions["cpu"]
    n8 = builder.lensmap_resolve.launches
    got = card.render(frames)
    assert builder.lensmap_resolve.launches == n8 + 1
    assert card.build_progress is not None and not card._preview_is_partial
    assert card._lensmap.flat_idx.device.type == "cuda"
    _equal(got.cpu(), cpu.render(frames))
    for f in ("flat_idx", "valid", "tint", "plates_used"):
        _equal(getattr(card._lensmap, f).cpu(), getattr(cpu._lensmap, f))
    while card.build_progress is not None:
        got = card.render(frames)
    assert isinstance(card._lensmap.flat_idx, np.ndarray)
    blocking = Session(64, 48, platesize=32, device="cpu")
    blocking.cmd("f_lens winkeltripel; f_fov 140")
    _equal(got.cpu(), blocking.render(frames))


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["u8", "rgba"])
def test_saveglobe_from_frames_on_card(cuda_device, tmp_path, monkeypatch, source):
    """f_saveglobe from a batch on the card: frame 0 is copied to the host
    (a torch.uint32 batch through int32) and the files equal save_globe_pcx
    of that frame from the host, byte for byte."""
    from blinky_tpu_torch.io.cubemap import save_globe_pcx

    monkeypatch.chdir(tmp_path)
    frames = synthetic_cubemap_batch(48, 3)
    sess = Session(64, 48, device=cuda_device)
    fr = frames if source == "u8" else remap.frames_to_rgba(frames, sess.palette)
    t = torch.from_numpy(fr.view(np.int32) if source == "rgba" else fr).to(cuda_device)
    if source == "rgba":
        t = t.view(torch.uint32)
    sess.cmd("f_saveglobe shot")
    sess.render(t)
    got = {i: (tmp_path / f"shot{i}.pcx").read_bytes() for i in range(6)}
    (tmp_path / "host").mkdir()
    monkeypatch.chdir(tmp_path / "host")
    save_globe_pcx("shot", fr[..., 0], sess.globe, sess.palette)
    for i in range(6):
        assert got[i] == (tmp_path / "host" / f"shot{i}.pcx").read_bytes(), i


# ------------------------------------- the 360-video path and the AA resolve


def _gather_case(K, B, n, rows, rng, device, extreme=False):
    """src [rows, B] int32, idx [K, n], w [K, n] (None for one tap) and the
    per-output operands of both epilogues."""
    src = rng.integers(-2**31, 2**31, (rows, B), dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, rows, (K, n)).astype(np.int32)
    if extreme:  # weights at 0 and 1, past 1 (the clamp) and on the .5 tie
        w = rng.choice(np.array([0.0, 1.0, 0.5, 0.25, 2.0, 1e-30, 0.99999994],
                                np.float32), (K, n))
        src[:3] = np.array([0, -1, 0x00FF00FF], np.int64).astype(np.uint32).view(
            np.int32)[:, None]
    else:
        f = rng.random((2, n), dtype=np.float32)
        w = np.stack([(1 - f[0]) * (1 - f[1]), f[0] * (1 - f[1]), (1 - f[0]) * f[1],
                      f[0] * f[1]]).astype(np.float32)[:K]
    word = lambda: rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)  # noqa: E731
    ops = dict(plate_mask=np.where(rng.random(n) < 0.7, -1, 0).astype(np.int32),
               valid=rng.random(n) < 0.8, bg=word(), tint_rgb=word(),
               tint_mask=rng.random(n) < 0.5)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return t(src), t(idx), (t(w) if K == 4 else None), {k: t(v) for k, v in ops.items()}


EPILOGUES = {"none": (), "plate_mask": ("plate_mask",), "screen": ("valid", "bg"),
             "screen_tint": ("valid", "bg", "tint_rgb", "tint_mask")}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("B", [1, 3, 4, 5, 128, 129])
@pytest.mark.parametrize("epilogue", list(EPILOGUES))
def test_equirect_gather_equals_plain(cuda_device, K, B, epilogue):
    """K10 against its plain version: both tap counts, every epilogue, the
    vector path (B % 4 == 0) and the scalar one, n not a multiple of the
    pixels a block takes, ordinary and extreme weights."""
    rng = np.random.default_rng(K * 1000 + B)
    for n, extreme in ((1, False), (1037, False), (515, True)):
        src, idx, w, ops = _gather_case(K, B, n, 97, rng, cuda_device, extreme)
        kw = {k: ops[k] for k in EPILOGUES[epilogue]}
        n0 = ingest.equirect_gather.launches
        got = ingest.equirect_gather(src, idx, w, **kw)
        assert ingest.equirect_gather.launches == n0 + 1
        _equal(got, ingest.equirect_gather_plain(src, idx, w, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_equirect_gather_misaligned_and_long_rows(cuda_device, K):
    """A batch slice whose rows start off a 16-byte boundary takes the
    scalar path; a row longer than a block's 256 vectors is walked by the
    whole block; indices outside the source are clipped."""
    rng = np.random.default_rng(K)
    src, idx, w, ops = _gather_case(K, 8, 300, 50, rng, cuda_device)
    flat = torch.cat([src.reshape(-1), src.reshape(-1)[:1]])
    view = flat[1:].reshape(50, 8)
    assert view.data_ptr() % 16 != 0
    _equal(ingest.equirect_gather(view, idx, w, plate_mask=ops["plate_mask"]),
           ingest.equirect_gather_plain(view, idx, w, plate_mask=ops["plate_mask"]))
    src, idx, w, ops = _gather_case(K, 4 * 300, 9, 20, rng, cuda_device)
    _equal(ingest.equirect_gather(src, idx, w, valid=ops["valid"], bg=ops["bg"]),
           ingest.equirect_gather_plain(src, idx, w, valid=ops["valid"], bg=ops["bg"]))
    src, idx, w, ops = _gather_case(K, 1100, 9, 20, rng, cuda_device)  # scalar, 5 passes
    idx[:, ::3] = torch.tensor([-5, 20, 2**31 - 1], dtype=torch.int32,
                               device=cuda_device)[rng.integers(0, 3)]
    _equal(ingest.equirect_gather(src, idx, w), ingest.equirect_gather_plain(src, idx, w))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 4])
def test_equirect_gather_source_past_int32(cuda_device, K):
    """A source of 2^31 + 2^20 int32 elements (8.6 GB): rows past element
    2^31 and past byte 2^32 are read at 64-bit offsets."""
    B = 128
    rows = 2**24 + 2**13
    assert rows * B > 2**31
    src = torch.empty((rows, B), dtype=torch.int32, device=cuda_device)
    step = 2**20
    gen = torch.Generator(cuda_device).manual_seed(K)
    for r0 in range(0, rows, step):
        src[r0:r0 + step] = torch.randint(-2**31, 2**31 - 1, (min(step, rows - r0), B),
                                          dtype=torch.int32, device=cuda_device,
                                          generator=gen)
    rng = np.random.default_rng(7)
    n = 4096
    idx = np.concatenate([rng.integers(0, rows, (K, n - 8)),
                          np.full((K, 8), rows - 1)], 1).astype(np.int32)
    idx[:, :8] = 2**24 + np.arange(8)  # just past element 2^31
    f = rng.random((4, n), dtype=np.float32)
    w = (f / f.sum(0)).astype(np.float32)[:K]
    idx, w = (torch.from_numpy(a).to(cuda_device) for a in (idx, w))
    w = w if K == 4 else None
    _equal(ingest.equirect_gather(src, idx, w), ingest.equirect_gather_plain(src, idx, w))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4, 6])
@pytest.mark.parametrize("rest", [(), (1,), (3,), (4,), (5,), (64,), (130,)],
                         ids=lambda r: "B" + "x".join(map(str, r)) if r else "single")
def test_downsample_rgba_equals_plain(cuda_device, k, rest):
    """K11 against its plain version: every k of the CPU tests, a single
    screen and ragged and vector batches."""
    gen = torch.Generator(cuda_device).manual_seed(k)
    hi = torch.randint(-2**31, 2**31 - 1, (k * 7, k * 9) + rest, dtype=torch.int32,
                       device=cuda_device, generator=gen)
    n0 = remap.downsample_rgba.launches
    got = remap.downsample_rgba(hi, k)
    assert remap.downsample_rgba.launches == n0 + 1 and got.dtype == torch.uint32
    _equal(got.view(torch.int32), remap.downsample_rgba_plain(hi, k))
    _equal(remap.downsample_rgba(hi.view(torch.uint32), k).view(torch.int32),
           got.view(torch.int32))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 16])
def test_downsample_rgba_every_sum(cuda_device, k):
    """Every channel sum a k x k block can have (the .5 ties among them), in
    all three channels, through the kernel."""
    sums = np.arange(255 * k * k + 1)
    q, r = np.divmod(sums, k * k)
    blocks = q[:, None] + (np.arange(k * k)[None, :] < r[:, None])
    hi = blocks.reshape(-1, k, k).transpose(1, 0, 2).reshape(k, -1).astype(np.uint32)
    hi = torch.from_numpy((hi | (hi << 8) | (hi << 16)).view(np.int32)).to(cuda_device)
    _equal(remap.downsample_rgba(hi, k).view(torch.int32),
           remap.downsample_rgba_plain(hi, k))


@pytest.mark.cuda
@pytest.mark.parametrize("plates", [1, 2, 6])
@pytest.mark.parametrize("rest", [(3, 3), (5, 5, 1), (4, 4, 3), (8, 8, 4), (16, 16, 130)],
                         ids=lambda r: "x".join(map(str, r)))
def test_tint_expand_rgba_equals_plain(cuda_device, plates, rest):
    """K12 against its plain version: 1, 2 and 6 plates, planes whose size is
    and is not a multiple of four texels."""
    gen = torch.Generator(cuda_device).manual_seed(plates)
    frames = torch.randint(-2**31, 2**31 - 1, (plates,) + rest, dtype=torch.int32,
                           device=cuda_device, generator=gen)
    frames.reshape(plates, -1)[:, 0] = -1  # c = 255 against tints of 0: t < c
    n0 = remap.tint_expand_rgba.launches
    got = remap.tint_expand_rgba(frames)
    assert remap.tint_expand_rgba.launches == n0 + 1
    assert tuple(got.shape) == (12,) + rest
    _equal(got, remap.tint_expand_rgba_plain(frames))
    _equal(remap.expand_frames_tinted_rgba(frames.view(torch.uint32)).view(torch.int32), got)
    np.testing.assert_array_equal(
        got.cpu().numpy().view(np.uint32),
        remap.expand_frames_tinted_rgba(frames.cpu().numpy().view(np.uint32)))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_u8_frames_on_card_decode_there_and_never_come_down(cuda_device, monkeypatch):
    """The palette decode of a u8 tensor on the card, whole and in pieces,
    equals the host's; the host-only u8 rubix expansion raises for it."""
    from blinky_tpu_torch import api

    sess = Session(32, 24, platesize=16, device=cuda_device)
    frames = np.random.default_rng(3).integers(0, 256, (6, 9, 9, 5), dtype=np.uint8)
    on_card = torch.from_numpy(frames).to(cuda_device)
    want = remap.frames_to_rgba(frames, sess.palette)
    for chunk in (1 << 26, 11):
        monkeypatch.setattr(api, "_DECODE_CHUNK", chunk)
        got = sess._rgba_screen(on_card)
        assert got.device.type == "cuda" and got.dtype == torch.uint32
        np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy().view(np.uint32), want)
    with pytest.raises(TypeError, match="host-only"):
        remap.expand_rubix_source(on_card, sess.palette)


@pytest.mark.cuda
@pytest.mark.parametrize("script", [(), ("f_rubix",), ("f_lens hammer", "f_contain"),
                                    ("f_globe tetra", "f_rubix")],
                         ids=["defaults", "rubix", "hammer_contain", "tetra_rubix"])
@pytest.mark.parametrize("B", [1, 5, 128])
def test_session_render_equirect_on_card_equals_cpu(cuda_device, script, B):
    """render_equirect on the card (K10, and K1 for compact and faces)
    equals the device="cpu" Session on the same exact host lensmap, in all
    three modes, bilinear and nearest, panos as NumPy and on the card."""
    rng = np.random.default_rng(B)
    panos = rng.integers(0, 2**32, (32, 64, B), dtype=np.uint64).astype(np.uint32)
    card = Session(48, 36, platesize=24, device=cuda_device)
    cpu = Session(48, 36, platesize=24, device="cpu")
    for line in script:
        card.cmd(line)
        cpu.cmd(line)
    on_card = torch.from_numpy(panos).to(cuda_device)
    for bilinear in (True, False):
        want = cpu.render_equirect(panos, bilinear=bilinear, mode="faces")
        for mode in ("compact", "fused", "faces"):
            n10, n1 = ingest.equirect_gather.launches, remap.remap_gather.launches
            got = card.render_equirect(on_card, bilinear=bilinear, mode=mode)
            assert got.device.type == "cuda" and got.dtype == torch.uint32
            assert ingest.equirect_gather.launches == n10 + 1
            assert remap.remap_gather.launches == n1 + (mode != "fused")
            _equal(got.cpu().view(torch.int32), want.view(torch.int32))
        _equal(card.render_equirect(panos, bilinear=bilinear).cpu().view(torch.int32),
               want.view(torch.int32))
    one = card.render_equirect(panos[..., 0])
    _equal(one.cpu().view(torch.int32),
           cpu.render_equirect(panos[..., 0]).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("factor", [1, 2, 3])
@pytest.mark.parametrize("source", ["u8", "u32_batch", "expanded_on_card"])
def test_session_render_aa_on_card_equals_cpu(cuda_device, factor, source):
    """render_aa on the card (K1 at factor times the size, then K11; K12
    for the expansion of faces on the card) equals the device="cpu"
    Session."""
    rng = np.random.default_rng(factor)
    card = Session(64, 48, platesize=32, device=cuda_device)
    cpu = Session(64, 48, platesize=32, device="cpu")
    for s in (card, cpu):
        s.cmd("f_lens fisheye1; f_contain")
        s.set_background(np.full((48, 64), 251, np.uint8))
    if source == "u8":
        frames = rng.integers(0, 256, (6, 32, 32), dtype=np.uint8)
        got, want = card.render_aa(frames, factor=factor), cpu.render_aa(frames, factor=factor)
    elif source == "u32_batch":
        frames = rng.integers(0, 2**32, (6, 32, 32, 5), dtype=np.uint64).astype(np.uint32)
        got = card.render_aa(torch.from_numpy(frames).to(cuda_device), factor=factor)
        want = cpu.render_aa(frames, factor=factor)
    else:
        faces = rng.integers(0, 2**32, (6, 32, 32, 4), dtype=np.uint64).astype(np.uint32)
        n12 = remap.tint_expand_rgba.launches
        expanded = remap.expand_frames_tinted_rgba(torch.from_numpy(faces).to(cuda_device))
        assert remap.tint_expand_rgba.launches == n12 + 1
        for s in (card, cpu):
            s.cmd("f_rubix")
        n11 = remap.downsample_rgba.launches
        got = card.render_aa(expanded, factor=factor)
        assert remap.downsample_rgba.launches == n11 + (factor > 1)
        want = cpu.render_aa(remap.expand_frames_tinted_rgba(faces), factor=factor)
    assert got.device.type == "cuda" and got.dtype == torch.uint32
    _equal(got.cpu().view(torch.int32), want.view(torch.int32))


# ------------------------------------------------ script globes: resolver mode 2

# a script resolver that gives every kind of plate: a NaN (-> -1), nil
# (-> -1), values below 0 and past the last plate, and in-range ones
ODD_RESOLVER = """
plates = { {{0, 0, 1}, {0, 1, 0}, 90} }
function globe_plate(x, y, z)
  if x > 0.6 then return 0 / 0 end
  if y > 0.55 then return nil end
  return math.floor((x + 1) * 4 + z) - 1
end
"""


def _script_globe(globe_name, src, tmp_path):
    """The built-in globe's plates with a .lua script's resolver."""
    import dataclasses

    from blinky_tpu_torch.lua_bridge import load_lua_globe

    path = tmp_path / f"r_{globe_name}.lua"
    path.write_text(src)
    lua = load_lua_globe(path)
    assert lua.jittable
    return dataclasses.replace(globes.get(globe_name), plate_resolver=lua.plate_resolver,
                               name=f"{globe_name}+script")


def _maxdot_resolver(globe_name):
    """A Lua resolver that picks the strict first maximum of the forward
    dots, as the max-dot kernels do, with the globe's float32 forwards."""
    g = globes.get(globe_name)
    rows = ", ".join("{" + ", ".join(repr(float(c)) for c in f) + "}" for f in g.forward)
    return f"""
plates = {{ {{{{0, 0, 1}}, {{0, 1, 0}}, 90}} }}
F = {{{rows}}}
function globe_plate(x, y, z)
  local best = x * F[1][1] + y * F[1][2] + z * F[1][3]
  local p = 0
  for k = 2, #F do
    local d = x * F[k][1] + y * F[k][2] + z * F[k][3]
    if d > best then
      best = d
      p = k - 1
    end
  end
  return p
end
"""


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["fast", "trism", "tetra", "cube"])
@pytest.mark.parametrize("basis", list(BASES))
def test_lensmap_resolve_given_plates_equal_plain(cuda_device, globe_name, basis, tmp_path):
    """K8 in resolver mode 2 against rays_to_lensmap_torch on the same rays
    and plates, every table bit for bit: globes of 2-6 plates, plates from
    a script (NaN and nil -> -1, below 0, past the last plate) and random
    int32 plates, a ragged 37x23 grid with the odd rays, three bases."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    hb, wb, S = 23, 37, 32
    _, t = _posed_table(globe_name, hb, wb, cuda_device)
    g = _script_globe(globe_name, ODD_RESOLVER, tmp_path)
    vb = view_basis_from_angles(*BASES[basis])
    vbt = torch.from_numpy(np.asarray(vb, np.float64)).to(cuda_device)
    n0 = builder.lensmap_resolve.given_launches
    got = builder.lensmap_resolve(g, t.vx, t.vy, t.vz, t.lens_valid, S, 7.0, 2.5, 1.5, vb)
    torch.cuda.synchronize()
    assert builder.lensmap_resolve.given_launches == n0 + 1
    want = builder.rays_to_lensmap_torch(g, t.vx, t.vy, t.vz, t.lens_valid, S, 7.0, 2.5, 1.5,
                                         view_basis=vbt)
    _tables_equal(got, want)
    gen = torch.Generator(device=cuda_device).manual_seed(len(globe_name))
    plate = torch.randint(-3, g.numplates + 3, (hb, wb), generator=gen, device=cuda_device,
                          dtype=torch.int32)
    got = builder.lensmap_resolve(g, t.vx, t.vy, t.vz, t.lens_valid, S, 10, 4.0, 1.0, vb,
                                  plate=plate)
    want = builder.rays_to_lensmap_torch(g, t.vx, t.vy, t.vz, t.lens_valid, S, 10, 4.0, 1.0,
                                         view_basis=vbt, plate=plate)
    _tables_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["cube", "trism"])
def test_given_maxdot_plates_equal_the_maxdot_kernels(cuda_device, globe_name, tmp_path):
    """The rotate pre-pass (K13) gives a script the rays K6 and K8 rotate
    inside: a script that picks the strict first max of the forward dots on
    K13's rays gives, through K6 and K8 in mode 2, the very tables and
    screens of their max-dot mode, odd rays included."""
    from blinky_tpu_torch.camera import view_basis_from_angles

    rng = np.random.default_rng(3)
    hb, wb, S, B = 24, 40, 32, 7
    g0, table = _posed_table(globe_name, hb, wb, cuda_device)
    g = _script_globe(globe_name, _maxdot_resolver(globe_name), tmp_path)
    for angles in BASES.values():
        vb = view_basis_from_angles(*angles)
        got = builder.lensmap_resolve(g, table.vx, table.vy, table.vz, table.lens_valid, S,
                                      10, 4.0, 1.0, vb)
        want = builder.lensmap_resolve(g0, table.vx, table.vy, table.vz, table.lens_valid, S,
                                       10, 4.0, 1.0, vb)
        _tables_equal(got, want)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    for kind, k in (("u8", 1), ("expanded", 2), ("int32", 3)):
        src = _posed_source(kind, B, S, rng, cuda_device)
        bg = _texels(kind == "int32", (hb * k, wb * k), rng, cuda_device)
        args = (src, table, bases)
        rest = (S, 7.0, 2.5, 1.5, kind == "expanded", bg, k)
        _equal(static_ray.static_ray_posed(*args, g, *rest),
               static_ray.static_ray_posed(*args, g0, *rest))


@pytest.mark.cuda
@pytest.mark.parametrize("globe_name", ["fast", "trism", "tetra", "cube"])
@pytest.mark.parametrize("kind", ["u8", "expanded", "int32"])
@pytest.mark.parametrize("size", [(23, 37, 1), (24, 40, 1), (24, 40, 2), (23, 37, 2)],
                         ids=["ragged-k1", "vec-k1", "vec-k2", "ragged-k2"])
@pytest.mark.parametrize("B", [11, 1, 15, 16, 17, 63])
def test_static_ray_posed_given_plates_equal_plain(cuda_device, globe_name, kind, size, B,
                                                   tmp_path):
    """K6 in resolver mode 2 (a pose's int8 plate a build pixel) against its
    plain version on the same plates: globes of 2-6 plates, the script's
    plates (-1, out of range, NaN-derived), random ones over [-1, 6] with
    the int8 extremes -128 and 127, and the same plates through a view off
    4 bytes (byte loads); the scalar and the vector kernels at k = 1 and 2;
    B around the 16 poses of a block, a short last block included."""
    hb, wb, k = size
    rng = np.random.default_rng(hb + wb + k + len(kind) + (0 if B == 11 else B))
    S = 32
    _, table = _posed_table(globe_name, hb, wb, cuda_device)
    g = _script_globe(globe_name, ODD_RESOLVER, tmp_path)
    poses = np.stack([rng.uniform(-90, 90, B), rng.uniform(0, 360, B),
                      rng.uniform(-45, 45, B)], 1)
    bases = torch.from_numpy(posed.bases_from_pose_track(poses)).float().to(cuda_device)
    src = _posed_source(kind, B, S, rng, cuda_device)
    bg = _texels(kind == "int32", (hb * k, wb * k), rng, cuda_device)
    args = (src, table, bases, g, S, 7.0, 2.5, 1.5, kind == "expanded", bg, k)
    plates = static_ray.script_pose_plates(table, bases, g)
    assert plates.dtype == torch.int8 and set(plates.unique().tolist()) >= {-1, 0}
    n0 = static_ray.static_ray_posed.given_launches
    got = static_ray.static_ray_posed(*args)
    assert static_ray.static_ray_posed.given_launches == n0 + 1
    _equal(got, static_ray.static_ray_posed_plain(*args, plates=plates))
    values = np.array([-128, -1, 0, 1, 2, 3, 4, 5, 6, 127], np.int8)
    rand = torch.from_numpy(values[rng.integers(0, values.size, (B, hb, wb))]).to(cuda_device)
    want = static_ray.static_ray_posed_plain(*args, plates=rand)
    _equal(static_ray.static_ray_posed(*args, plates=rand), want)
    buf = torch.empty(rand.numel() + 1, dtype=torch.int8, device=cuda_device)
    off = buf[1:].view(rand.shape)
    off.copy_(rand)
    assert off.is_contiguous() and off.data_ptr() % 4 == 1
    _equal(static_ray.static_ray_posed(*args, plates=off), want)


def _k13_poses_a_thread():
    """K13_POSES, the poses a K13 thread takes, from csrc/lensmap.cu."""
    import re
    from pathlib import Path

    src = (Path(builder.__file__).resolve().parents[1] / "csrc" / "lensmap.cu").read_text()
    return int(re.search(r"#define K13_POSES (\d+)", src).group(1))


# K13's ray tables: npix a multiple of 4 and 1, 2, 3 past one, an input
# view off 16 bytes, the [4, 8] planes of odd rays
K13_SHAPES = {"23x37": (23, 37), "24x40": (24, 40), "13x17": (13, 17), "11x18": (11, 18),
              "offset": (24, 40), "4x8": None}


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 11, 70000, "P-1", "P", "P+1", 63, 64])
@pytest.mark.parametrize("shape", list(K13_SHAPES))
def test_rotate_rays_equals_plain(cuda_device, B, shape):
    """K13 against rotate_normalize_torch on the card, with the odd rays:
    rotated by each pose (B around the poses a thread, and past the grid's
    65535 blocks), and normalized with no rotation (a table a step); npix a
    multiple of four (the vector kernel), 1-3 past one (its scalar tail at
    one pose, the one-pixel runs past it), and an input view whose storage
    offset puts it off 16 bytes (scalar loads)."""
    if isinstance(B, str):
        P = _k13_poses_a_thread()
        B = max(1, P + int(B[1:]) if len(B) > 1 else P)
    if K13_SHAPES[shape] is None:
        vx, vy, vz, _ = (p[0] for p in _odd_ray_planes(cuda_device))
    else:
        _, t = _posed_table("cube", *K13_SHAPES[shape], cuda_device)
        vx, vy, vz = t.vx, t.vy, t.vz
    if shape == "offset":
        def off(a):  # a contiguous view one float past a 16-byte boundary
            buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
            v = buf[1:].view(a.shape)
            v.copy_(a)
            return v

        vx, vy, vz = off(vx), off(vy), off(vz)
        assert vx.is_contiguous() and vx.data_ptr() % 16 == 4
    rng = np.random.default_rng(B)
    bases = torch.from_numpy(rng.normal(size=(B, 3, 3)).astype(np.float32)).to(cuda_device)
    n0 = builder.rotate_rays.launches
    got = builder.rotate_rays(vx, vy, vz, bases)
    assert builder.rotate_rays.launches == n0 + 1
    # the odd rays give NaN components, equal as NaN (their payloads are
    # the arithmetic's, not compared)
    for a, b in zip(got, builder.rotate_normalize_torch(vx, vy, vz, bases)):
        assert a.shape == (B,) + tuple(vx.shape)
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    del got
    steps = torch.stack([vx, vy * 2, vz]).contiguous()
    for a, b in zip(builder.rotate_rays(steps, steps.flip(0).contiguous(), steps),
                    builder.rotate_normalize_torch(steps, steps.flip(0), steps)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    # the unrotated mode with one table a step, at the batch's own step count
    if B <= 100:
        steps = torch.stack([vx * (1 + 0.25 * n) for n in range(B)]).contiguous()
        for a, b in zip(builder.rotate_rays(steps, steps, steps),
                        builder.rotate_normalize_torch(steps, steps, steps)):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "expanded", "int32"])
def test_sweep_remap_given_plates_equal_plain(cuda_device, kind, tmp_path):
    """K9 in resolver mode 2 against its plain version: the script on each
    step's normalized rays, and random int8 plates."""
    rng = np.random.default_rng(len(kind))
    hb, wb, S, steps = 24, 40, 32, 4
    g = _script_globe("trism", ODD_RESOLVER, tmp_path)
    tables = []
    for n in range(steps):
        _, t = _posed_table("trism", hb, wb, cuda_device)
        f = 0.6 + 0.35 * n
        tables.append((t.vx * f, t.vy * f, t.vz, t.lens_valid))
    vx, vy, vz, lv = (torch.stack(p).contiguous() for p in zip(*tables))
    src = _posed_source(kind, 1, S, rng, cuda_device)[0]
    bg = _texels(kind == "int32", (hb, wb), rng, cuda_device)
    args = (src, vx, vy, vz, lv, g, S, 7.0, 2.5, 1.5, kind == "expanded", bg)
    plates = builder.script_plates(g, *builder.rotate_rays(vx, vy, vz)).clamp(-1, 6).to(
        torch.int8)
    n0 = posed.sweep_remap.given_launches
    got = posed.sweep_remap(*args)
    assert posed.sweep_remap.given_launches == n0 + 1
    _equal(got, posed.sweep_remap_plain(*args, plates=plates))
    rand = torch.from_numpy(rng.integers(-1, 7, (steps, hb, wb), dtype=np.int8)).to(cuda_device)
    _equal(posed.sweep_remap(*args, plates=rand), posed.sweep_remap_plain(*args, plates=rand))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_lua_drop_ins_on_card_equal_cpu(cuda_device, k, tmp_path):
    """The four drop-ins through a Session on the card: lpanini and lfast
    equal the built-in panini and fast on the card bit for bit (render,
    rotated view, render_posed); scat renders on the exact host path and
    its poses through a host ray table; on the CPU's float32 ray table the
    card's posed screens equal the CPU Session's."""
    from blinky_tpu_torch.bench import lua_drop_ins

    d = lua_drop_ins.write_scripts(tmp_path)
    frames = synthetic_cubemap_batch(32, 5)
    poses = np.stack([np.linspace(-40, 40, 5), np.linspace(0, 300, 5), np.zeros(5)], 1)
    for lines, ref_lines in ((["f_lens lpanini"], ["f_lens panini"]),
                             (["f_globe lfast"], ["f_globe fast"]),
                             (["f_globe lfast", "f_lens lpanini"], ["f_globe fast"])):
        for backend in ("torch", "auto"):
            lua = Session(64, 48, platesize=32, device=cuda_device, backend=backend,
                          lens_dirs=[d], globe_dirs=[d])
            ref = Session(64, 48, platesize=32, device=cuda_device, backend=backend)
            for s, ls in ((lua, lines), (ref, ref_lines)):
                for line in ls + ["setviewangles 10 30 0"]:
                    s.cmd(line)
            _equal(lua.render(frames), ref.render(frames))
            _equal(lua.render_posed(frames, poses, render_scale=k),
                   ref.render_posed(frames, poses, render_scale=k))
    scat = Session(64, 48, platesize=32, device=cuda_device, lens_dirs=[d])
    scat.cmd("f_lens scat")
    assert not scat.lens.jittable
    cpu = Session(64, 48, platesize=32, device="cpu", lens_dirs=[d])
    cpu.cmd("f_lens scat")
    _equal(scat.render(frames).cpu(), cpu.render(frames))
    _equal(scat.render_posed(frames, poses, render_scale=k).cpu(),
           cpu.render_posed(frames, poses, render_scale=k))


def _replay_frames(n, S):
    """n rolled copies of the synthetic cubemap, [N, P, S, S] (a recorded demo)."""
    base = synthetic_cubemap_batch(S, 1)[..., 0]
    return np.stack([np.roll(base, i, axis=2) for i in range(n)])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["u8", "u32"])
@pytest.mark.parametrize("rubix,decode_rgb", [(None, False), (True, False), (None, True)])
def test_timedemo_on_card_equals_cpu(cuda_device, kind, rubix, decode_rgb):
    """timedemo through K1 (K2 for rubix or decode_rgb on u8 frames) on the
    card: the last, padded batch equals the CPU Session's, and the clock
    counts the valid frames."""
    from blinky_tpu_torch.io import dataset

    frames = _replay_frames(10, 32)
    if kind == "u32":
        frames = remap.frames_to_rgba(frames, default_palette())
    card = Session(64, 48, platesize=32, device=cuda_device)
    cpu = Session(64, 48, platesize=32, device="cpu")
    n1, n2 = remap.remap_gather.launches, remap.remap_lut.launches
    out, clock = dataset.timedemo(card, frames, batch=4, rubix=rubix, decode_rgb=decode_rgb)
    want, _ = dataset.timedemo(cpu, frames, batch=4, rubix=rubix, decode_rgb=decode_rgb)
    assert out.device.type == "cuda" and clock.frames == 10
    _equal(out.cpu(), want)
    lut = kind == "u8" and (rubix or decode_rgb)
    assert remap.remap_lut.launches - n2 == (3 if lut else 0)
    assert remap.remap_gather.launches - n1 == (0 if lut else 3)
    assert card.console[-1].startswith("10 frames")


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(10, 4), (5, 8), (6, 3)])
def test_frame_batch_iterator_renders_on_card_equal_cpu(cuda_device, n, batch):
    """Every batch of the prefetching iterator through Session.render on
    the card, the padded last one included, equals the CPU Session's; the
    padding lanes render frame zeros."""
    from blinky_tpu_torch.io import dataset

    frames = _replay_frames(n, 24)
    card = Session(64, 48, platesize=24, device=cuda_device)
    cpu = Session(64, 48, platesize=24, device="cpu")
    seen = 0
    for fr, n_valid in dataset.FrameBatchIterator(frames, batch):
        got = card.render(fr)
        _equal(got.cpu(), cpu.render(fr))
        if n_valid < batch:
            zero = card.render(np.zeros_like(fr[..., :1]))
            _equal(got[..., n_valid:], zero.expand(*zero.shape[:-1], batch - n_valid))
        seen += n_valid
    assert seen == n


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_render_posed_from_dem_track_on_card_equals_cpu(cuda_device, monkeypatch, tmp_path, k):
    """A .dem camera track, read and resampled by lerp_pose_track to the
    frame count, drives render_posed on the card (K7, K6): equal to the CPU
    Session's on the host ray table."""
    from blinky_tpu_torch.io import demfile

    _host_tables(monkeypatch)
    track = np.array([[0, 0, 0], [10, 90, 0], [-30, 200, 15], [0, 350, 0], [5, 10, 0]],
                     np.float32)
    demfile.write_dem(tmp_path / "t.dem", track)
    dem = demfile.read_dem(tmp_path / "t.dem")
    np.testing.assert_array_equal(dem.poses, track)
    B = 9
    poses = demfile.lerp_pose_track(dem.poses, B)
    frames = np.moveaxis(_replay_frames(B, 32), 0, -1).copy()
    card = Session(64, 48, platesize=32, device=cuda_device)
    cpu = Session(64, 48, platesize=32, device="cpu")
    n6, n7 = static_ray.static_ray_posed.launches, posed.posed_layout.launches
    got = card.render_posed(frames, poses, render_scale=k)
    assert static_ray.static_ray_posed.launches == n6 + 1
    assert posed.posed_layout.launches == n7 + 1
    _equal(got.cpu(), cpu.render_posed(frames, poses, render_scale=k))
