"""Python models of two CUDA kernels' work splits, run on the CPU.

The kernels themselves run only on a card.  What decides whether every
output is written once and every input read where it should be is their
index arithmetic, which these models repeat line for line, with the
tuning constants read from the ``.cu`` sources (so that the tests follow a
retune):

* K13, ``blinky_rotate_rays`` (``csrc/lensmap.cu``): runs of four pixels
  with float4 loads and stores, a scalar tail, a kernel of one-pixel runs for
  rotated rows off 16 bytes, and blocks of ``K13_POSES`` poses in a
  block-stride loop past the grid's 65535 blocks;
* K6 in resolver mode 2 (``csrc/posed.cu``): the shared tile of a block's
  plates, one 4-byte word a pose and run in the vector kernels, the run's
  bytes in the scalar kernel and off 4 bytes;
* K10's ring (``csrc/ingest.cu``): runs of outputs and pieces of long rows,
  the producers' bulk copies of each output's taps (a pair of horizontal
  neighbours in one copy) into a stage, the consumers' walk of the stage's
  vectors and the run's bulk store.
"""

import re
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parents[1] / "blinky_tpu_torch" / "csrc"
GRID_Y_MAX = 65535


def _const(source, name):
    """The value a ``#define NAME n`` or ``constexpr int NAME = n;`` gives."""
    text = (CSRC / source).read_text()
    m = (re.search(rf"#define {name} (\d+)", text)
         or re.search(rf"constexpr int {name} = (\d+);", text))
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def _ceil(a, b):
    return -(-a // b)


# --------------------------------------------------------------------- K13


def k13_model(npix, batch, rot, in_offset=0, out_offset=0, y_max=GRID_Y_MAX):
    """The element accesses of one ``blinky_rotate_rays`` launch.

    *in_offset* / *out_offset*: the inputs' and outputs' byte offsets from
    16 bytes.  Returns (writes, vector writes, reads): arrays of the flat
    output indices each thread-pose stores (one entry per element), of the
    first index of each float4 store, and of the input indices it loads,
    with the vector loads' first indices apart."""
    T, P = _const("lensmap.cu", "K13_THREADS"), _const("lensmap.cu", "K13_POSES")
    n = npix if rot else npix * batch
    rows = batch if rot else 1
    vec = (n % 4 == 0 or rows == 1) and out_offset % 16 == 0
    vload = in_offset % 16 == 0
    M = 4 if vec else 1
    blocks = _ceil(_ceil(n, M), T)
    Pk = P if rot else 1
    gy = min(_ceil(rows, Pk), y_max)
    p0 = np.arange(blocks * T, dtype=np.int64) * M
    m = np.clip(n - p0, 0, M)
    whole = (m == 4) if M == 4 else np.zeros_like(m, dtype=bool)
    vload_run = whole & vload
    reads_vec = p0[vload_run]
    reads = np.concatenate([p0[m > i][~vload_run[m > i]] + i for i in range(M)]
                           + [p0[vload_run] + i for i in range(4) if M == 4])
    poses = []
    for by in range(gy):  # the block-stride loop of every block row
        b0 = by * Pk
        while b0 < rows:
            nb = min(Pk, rows - b0)
            poses.extend(range(b0, b0 + nb))
            b0 += gy * Pk
    poses = np.asarray(poses, dtype=np.int64)
    live = m > 0
    q = poses[:, None] * (n if rot else 0) + p0[None, live]
    mm = np.broadcast_to(m[live], q.shape)
    vw = np.broadcast_to(whole[live], q.shape)
    vec_writes = q[vw]
    writes = np.concatenate([q[vw] + i for i in range(4) if M == 4]
                            + [q[(mm > i) & ~vw] + i for i in range(M)])
    return writes, vec_writes, reads, reads_vec, n, rows


def _k13_check(npix, batch, rot, in_offset=0, out_offset=0, y_max=GRID_Y_MAX):
    writes, vec_writes, reads, reads_vec, n, rows = k13_model(
        npix, batch, rot, in_offset, out_offset, y_max)
    total = rows * n
    # every (pose, pixel) pair, or every unrotated element, exactly once
    assert writes.size == total
    assert np.array_equal(np.sort(writes), np.arange(total))
    # a float4 store lies inside one output row, on 16 bytes
    assert np.all((vec_writes * 4 + out_offset) % 16 == 0)
    assert np.all(vec_writes % n + 3 < n)
    # every input element is read by exactly one run, float4 loads on 16 bytes
    assert np.array_equal(np.sort(reads), np.arange(n))
    assert np.all((reads_vec * 4 + in_offset) % 16 == 0)
    return writes, vec_writes


@pytest.mark.parametrize("npix", [32, 33, 34, 35, 851, 1024, 2073])
@pytest.mark.parametrize("batch", [1, "P-1", "P", "P+1", 63, 64])
@pytest.mark.parametrize("rot", [True, False], ids=["rotated", "unrotated"])
def test_k13_writes_each_pose_pixel_once(npix, batch, rot):
    """Every (pose, pixel) pair written once, inside its plane; the vector
    body and the scalar tail meet without a gap or an overlap."""
    P = _const("lensmap.cu", "K13_POSES")
    if isinstance(batch, str):
        batch = max(1, P + int(batch[1:]) if len(batch) > 1 else P)
    writes, vec_writes = _k13_check(npix, batch, rot)
    n = npix if rot else npix * batch
    rows = batch if rot else 1
    if n % 4 == 0 or rows == 1:  # the vector kernel, with its tail
        tail = n % 4
        assert vec_writes.size == rows * (n // 4)
        covered = np.zeros(rows * n, dtype=np.int64)
        for i in range(4):
            np.add.at(covered, vec_writes + i, 1)
        row_pos = np.arange(rows * n) % n
        assert np.all(covered[row_pos < n - tail] == 1)  # the body
        assert np.all(covered[row_pos >= n - tail] == 0)  # the tail, stored a pixel at a time
    else:  # rotated rows off 16 bytes: runs of one pixel
        assert vec_writes.size == 0


@pytest.mark.parametrize("in_offset", [0, 4, 8, 12])
@pytest.mark.parametrize("npix", [32, 35, 1024])
@pytest.mark.parametrize("batch", [1, 9])
def test_k13_input_offsets(in_offset, npix, batch):
    """An input view off 16 bytes (a storage offset) loads a pixel at a
    time and still stores whole float4s."""
    writes, vec_writes = _k13_check(npix, batch, True, in_offset=in_offset)
    if npix % 4 == 0 or batch == 1:
        assert vec_writes.size == batch * (npix // 4)


@pytest.mark.parametrize("out_offset", [4, 8])
def test_k13_outputs_off_16_bytes_take_one_pixel_runs(out_offset):
    writes, vec_writes = _k13_check(64, 5, True, out_offset=out_offset)
    assert vec_writes.size == 0


@pytest.mark.parametrize("batch", [70000, "grid+5"])
def test_k13_pose_blocks_past_the_grid(batch):
    """More blocks of poses than the grid's 65535 rows: the block-stride
    loop covers every pose once."""
    P = _const("lensmap.cu", "K13_POSES")
    if batch == "grid+5":
        batch = GRID_Y_MAX * P + 5
    _k13_check(3, batch, True)
    _k13_check(4, batch, True)


@pytest.mark.parametrize("y_max", [1, 2, 3, 7])
@pytest.mark.parametrize("batch", [1, 17, 40, 64])
def test_k13_block_stride_loop(y_max, batch):
    """The same loop with a smaller grid: every pose once, whatever the
    number of block rows."""
    _k13_check(40, batch, True, y_max=y_max)
    _k13_check(41, batch, True, y_max=y_max)


# ------------------------------------------------------------- K6 mode 2


def k6_given_model(hb, wb, B, given_offset=0):
    """The plate tile of one ``blinky_static_ray_posed`` launch in resolver
    mode 2: for every (block, thread, pose of the block) whose run is on the
    screen, the bytes of the plates array its tile word holds (-1 for a
    byte past a short run) and the tile slot it fills.  Returns (pose, y,
    x0, tile slot numbered across blocks, byte addresses [.., 4], word
    loads) over all of them."""
    T = _const("posed.cu", "K6_THREADS")
    PB = _const("posed.cu", "K6_POSES_PER_BLOCK")
    kRun = _const("posed.cu", "kRun")
    runs = _ceil(wb, kRun)
    vec = wb % kRun == 0  # the vector kernels (every other pointer aligned)
    plane = hb * wb
    words = vec and given_offset % 4 == 0 and plane % 4 == 0
    bx = _ceil(hb * runs, T)
    gy = _ceil(B, PB)
    q = np.arange(bx * T, dtype=np.int64)
    tid = q % T
    on = q < hb * runs
    q, tid = q[on], tid[on]
    y = q // runs
    x0 = (q - y * runs) * kRun
    m = np.minimum(kRun, wb - x0)
    out = []
    for by in range(gy):
        b0 = by * PB
        nb = min(PB, B - b0)
        for j in range(nb):
            base = b0 * plane + y * wb + x0 + j * plane
            addr = base[:, None] + np.arange(kRun)[None, :]
            if not words:
                addr = np.where(np.arange(kRun)[None, :] < m[:, None], addr, -1)
            slot = j * T + tid  # the slot in its block's tile
            block = (q // T) * gy + by
            out.append((np.full(q.shape, b0 + j), y, x0, block * PB * T + slot, addr,
                        np.full(q.shape, words)))
    return tuple(np.concatenate(c) for c in zip(*out)), plane, words


@pytest.mark.parametrize("shape", [(24, 40), (23, 37), (270, 480), (9, 4), (5, 6)],
                         ids=["vec", "ragged", "270x480", "one-run", "short-run"])
@pytest.mark.parametrize("B", [1, 15, 16, 17, 63])
@pytest.mark.parametrize("given_offset", [0, 1, 2], ids=["aligned", "off1", "off2"])
def test_k6_given_tile_reads_its_own_pose_and_run(shape, B, given_offset):
    """Each (pose, run) reads the plates of its own pose and run: a word on
    4 bytes in the vector kernels, the run's bytes elsewhere; each tile
    slot is filled once; a short last block of poses reads no pose past B."""
    hb, wb = shape
    (pose, y, x0, slot, addr, words), plane, is_words = k6_given_model(hb, wb, B,
                                                                        given_offset)
    kRun = _const("posed.cu", "kRun")
    assert is_words == (wb % kRun == 0 and given_offset % 4 == 0)
    assert np.all(pose < B)
    if is_words:  # one aligned 4-byte load a pose and run
        assert np.all((addr[:, 0] + given_offset) % 4 == 0)
    real = addr >= 0
    # every byte read belongs to its own pose, row and run's pixels
    b_of = np.where(real, addr // plane, -1)
    pix = np.where(real, addr % plane, -1)
    assert np.all(b_of[real] == np.broadcast_to(pose[:, None], addr.shape)[real])
    assert np.all(pix[real] // wb == np.broadcast_to(y[:, None], addr.shape)[real])
    col = pix % wb
    i = np.broadcast_to(np.arange(kRun)[None, :], addr.shape)
    assert np.all(col[real] == (np.broadcast_to(x0[:, None], addr.shape) + i)[real])
    assert np.all(addr[real] < B * plane)
    # every (pose, pixel) plate is read exactly once
    got = np.sort(addr[real])
    assert np.array_equal(got, np.arange(B * plane))
    # the tiles: one slot a (block, pose, thread), each filled once
    PB, T = _const("posed.cu", "K6_POSES_PER_BLOCK"), _const("posed.cu", "K6_THREADS")
    assert np.unique(slot).size == slot.size
    assert np.all(slot % (PB * T) < np.minimum(PB, B) * T)


# ------------------------------------------------------- K7's vector tiles


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays (selectors 0-7)."""
    both = x.astype(np.uint64) | (y.astype(np.uint64) << np.uint64(32))
    out = np.zeros_like(x, dtype=np.uint64)
    for n in range(4):
        nib = np.uint64((sel >> (4 * n)) & 7)
        out |= ((both >> (np.uint64(8) * nib)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def _banks_free(words, phase_lanes, width):
    """Whether each phase of *phase_lanes* lanes of a warp touches distinct
    shared-memory banks: *words* [threads] the first 4-byte word each lane
    reads or writes (-1: inactive), *width* words a lane; lanes on the same
    words share them."""
    for p in range(0, words.size, phase_lanes):
        w = words[p:p + phase_lanes]
        w = np.unique(w[w >= 0])
        banks = ((w[:, None] + np.arange(width)[None, :]) % 32).ravel()
        if np.unique(banks).size != banks.size:
            return False
    return True


def k7_vec_model(frames, B, E, n_out, nc, order):
    """The output of one K7 launch of ``layout.cu``'s vector tiles, and the
    times each output byte was written: ``posed_layout_vec`` (nc 1, order 1:
    the texel tile fastest) or ``posed_layout_rows`` (nc 64-byte chunks a
    block, order 0: the chunk fastest).  *frames*: uint8 [T, ld bytes], the
    texel rows (ld >= B * E).  Asserts every load lies in its row's B * E
    bytes and that the shared-memory accesses are free of bank conflicts."""
    threads = _const("common.cuh", "kThreads")
    tile_texels, chunk = _const("layout.cu", "kTileTexels"), _const("layout.cu", "kChunkBytes")
    T, ld = frames.shape
    row_bytes = B * E
    k_row, k_units = chunk * nc + 16, 4 * nc
    loads = tile_texels * k_units // threads
    chunks, tiles = _ceil(row_bytes, chunk * nc), _ceil(n_out, tile_texels)
    out = np.zeros(B * n_out * E, np.uint8)
    writes = np.zeros(B * n_out * E, np.int64)
    tid = np.arange(threads)
    flat = frames.ravel()
    for blk in range(tiles * chunks):
        ti, ch = (blk % tiles, blk // tiles) if order else (blk // chunks, blk % chunks)
        t0, col0 = ti * tile_texels, ch * chunk * nc
        units = min(chunk * nc, row_bytes - col0) // 16
        tile = np.zeros(tile_texels * k_row, np.uint8)
        for j in range(loads):
            i = j * threads + tid
            if nc == 1:
                w, lane = i >> 5, i & 31
                rows, us = w * 8 + ((lane & 7) >> 2) * 4 + (lane >> 3), lane & 3
            else:
                rows, us = i // k_units, i % k_units
            t = t0 + rows
            ok = (t < T) & (us < units)
            src = t * ld + col0 + us * 16
            assert np.all(col0 + us[ok] * 16 + 16 <= row_bytes)
            slot = rows * k_row + us * 16
            assert _banks_free(slot // 4, 8, 4)
            for e in range(16):
                tile[slot + e] = np.where(ok, flat[np.where(ok, src + e, 0)], 0)
        g = tid >> 4
        if E == 1:
            h = g & 1
            tt = t0 + g * 16
            for k in range(nc):
                c = (tid & 15) + 16 * k
                on = (tt < n_out) & (c < units * 4)
                a = []
                for i in range(16):
                    at = (g * 16 + (i ^ (h << 2))) * k_row + c * 4
                    assert _banks_free(np.where(on, at // 4, -1), 32, 1)
                    a.append(tile[at[:, None] + np.arange(4)].copy().view("<u4").ravel())
                o = [[None] * 4 for _ in range(4)]
                for q in range(4):
                    x0 = _byte_perm(a[4 * q], a[4 * q + 1], 0x5140)
                    x1 = _byte_perm(a[4 * q], a[4 * q + 1], 0x7362)
                    y0 = _byte_perm(a[4 * q + 2], a[4 * q + 3], 0x5140)
                    y1 = _byte_perm(a[4 * q + 2], a[4 * q + 3], 0x7362)
                    o[q] = [_byte_perm(x0, y0, 0x5410), _byte_perm(x0, y0, 0x7632),
                            _byte_perm(x1, y1, 0x5410), _byte_perm(x1, y1, 0x7632)]
                for j in range(4):
                    s = np.stack([np.where(h, o[1][j], o[0][j]), np.where(h, o[0][j], o[1][j]),
                                  np.where(h, o[3][j], o[2][j]), np.where(h, o[2][j], o[3][j])],
                                 1).astype("<u4").view(np.uint8)
                    dst = (col0 + c * 4 + j) * n_out + tt
                    for e in range(16):
                        out[dst[on] + e] = s[on, e]
                        writes[dst[on] + e] += 1
        else:
            for k in range(nc):
                p = (tid & 15) + 16 * k
                for j in range(4):
                    gg = j * 16 + g
                    tt = t0 + gg * 4
                    on = (p < units * 4) & (tt < n_out)
                    dst = ((col0 // 4 + p) * n_out + tt) * 4
                    for q in range(4):
                        at = (gg * 4 + q) * k_row + p * 4
                        assert _banks_free(np.where(on, at // 4, -1), 32, 1)
                        for e in range(4):
                            out[dst[on] + 4 * q + e] = tile[at[on] + e]
                            writes[dst[on] + 4 * q + e] += 1
    return out, writes


@pytest.mark.parametrize("nc,order", [(1, 1), (1, 0), (2, 0), (4, 0), (4, 1), ("rows", "rows")],
                         ids=["vector path", "nc1", "nc2", "nc4", "nc4 tile-first",
                              "long-row path"])
@pytest.mark.parametrize("E,B,ld,P,S", [
    (1, 128, 128, 6, 24), (1, 256, 256, 3, 24), (1, 1024, 1024, 6, 16), (1, 2048, 2048, 6, 8),
    (1, 144, 144, 6, 16),                 # a last chunk of 16 bytes a row
    (1, 1024, 2048, 6, 16),               # a batch slice: rows 2048 bytes apart
    (1, 64, 64, 12, 16),                  # the vector path's own shape
    (4, 64, 64, 6, 16), (4, 256, 256, 6, 8), (4, 36, 48, 3, 24),
    (4, 64, 64, 12, 5),                   # 300 texels: a short last tile
])
def test_k7_vector_tiles_write_each_output_once(nc, order, E, B, ld, P, S):
    """K7's vector tiles, the short rows' path and the long-row path of the
    committed ``K7_ROW_CHUNKS_U8`` / ``_RGBA`` and ``K7_ROW_ORDER`` beside the
    sweep's other shapes: the output equals the pose-major layout, zero planes included,
    every byte written once, loads inside their rows, shared accesses free
    of bank conflicts."""
    if nc == "rows":
        nc = _const("layout.cu", "K7_ROW_CHUNKS_U8" if E == 1 else "K7_ROW_CHUNKS_RGBA")
        order = _const("layout.cu", "K7_ROW_ORDER")
    rng = np.random.default_rng(B * 7 + ld + P + S)
    T, n_out = P * S * S, 6 * S * S if P <= 6 else P * S * S
    frames = rng.integers(0, 256, (T, ld * E), dtype=np.uint8)
    out, writes = k7_vec_model(frames, B, E, n_out, nc, order)
    want = np.zeros((B, n_out, E), np.uint8)
    want[:, :T] = frames[:, :B * E].reshape(T, B, E).transpose(1, 0, 2)
    assert np.array_equal(out, want.ravel())
    assert np.all(writes == 1)


def test_k7_long_row_threshold_is_a_blocks_run():
    """``posed.long_row_path`` sends rows to the long-row path from one
    block's run of a row on, as ``layout.cu`` sizes it for u8 and RGBA."""
    from blinky_tpu_torch.kernels import posed

    chunk = _const("layout.cu", "kChunkBytes")
    assert posed.LONG_ROW_MIN_BYTES == {1: chunk * _const("layout.cu", "K7_ROW_CHUNKS_U8"),
                                        4: chunk * _const("layout.cu", "K7_ROW_CHUNKS_RGBA")}


# ------------------------------------------------------------- K10's ring


def _k10(name):
    return _const("ingest.cu", name)


def k10_ring_model(src, rows_kn, copied, K, row_bytes):
    """Every bulk copy, consumer read and bulk store of one
    ``equirect_gather_kernel_ring<K>`` launch, as ``ingest.cu`` computes
    them, on byte arrays.

    *src*: the pano's bytes, ``row_bytes`` a row; *rows_kn* [K, n]: each
    output's resolved tap rows; *copied* [n]: the outputs that read taps (a
    valid pixel on a used plate).  Returns (out, writes): the output bytes
    with each copied output's first tap in place (the consumer's vector of
    tap 0 stands for its blend) and the count of stores of each output byte;
    asserts on the way that every copy lands in its own slot of the stage,
    inside it, that each warp's copies bring the bytes it expects, and that
    every consumer read of tap k finds that tap's bytes."""
    SB, maxrun = _k10(f"K10_RING_STAGE_BYTES_K{K}"), _k10("K10_RING_MAX_RUN")
    P, C = _k10("K10_RING_PRODUCERS"), 32 * _k10("K10_RING_CONSUMERS")
    slots = _ceil(_ceil(maxrun, P), 32)
    n = rows_kn.shape[1]
    per_out = K * row_bytes
    whole = per_out <= SB
    run = min(SB // per_out if whole else 1, maxrun)
    piece = row_bytes if whole else SB // K // 16 * 16
    pieces = _ceil(row_bytes, piece)
    pairs = K == 4 and pieces == 1
    out = np.zeros(n * row_bytes, np.uint8)
    writes = np.zeros(n * row_bytes, np.int64)
    chunk = _ceil(run, P)
    assert chunk <= 32 * slots
    lanes16 = np.arange(16)
    for r in range(_ceil(n, run)):
        p0 = r * run
        nn = min(run, n - p0)
        for pc in range(pieces):
            c0 = pc * piece
            cb = min(piece, row_bytes - c0)
            stage = np.full(SB, -1, np.int16)
            owners = np.zeros(nn, np.int64)
            for pw in range(P):
                e = min((pw + 1) * chunk, min(run, n - r * run))
                expect = got = 0
                for lane in range(32):
                    for j in range(slots):
                        i = pw * chunk + lane + 32 * j
                        if i >= e:
                            continue
                        owners[i] += 1
                        if not copied[p0 + i]:
                            continue
                        expect += K * cb
                        d = i * K * cb
                        rr = rows_kn[:, p0 + i]
                        if K == 1:
                            copies = [(d, rr[0] * row_bytes + c0, cb)]
                        else:
                            copies = []
                            for k in (0, 2):
                                if pairs and rr[k + 1] == rr[k] + 1:
                                    copies.append((d + k * cb, rr[k] * row_bytes, 2 * cb))
                                else:
                                    copies += [(d + k * cb, rr[k] * row_bytes + c0, cb),
                                               (d + (k + 1) * cb, rr[k + 1] * row_bytes + c0, cb)]
                        for dst, so, size in copies:
                            assert dst % 16 == 0 and so % 16 == 0 and size % 16 == 0
                            assert 0 <= dst and dst + size <= SB
                            assert (stage[dst:dst + size] == -1).all(), "two copies overlap"
                            stage[dst:dst + size] = src[so:so + size]
                            got += size
                assert got == expect
            assert (owners == 1).all(), "an output of the run has no producer lane, or two"
            # the consumers: thread tid walks vectors tid, tid + C, ... with
            # (i, c) stepped as the kernel steps them
            vecs = cb // 16
            di, dc = C // vecs, C % vecs
            i = np.arange(C) // vecs
            c = np.arange(C) % vecs
            v = np.arange(C)
            dst = np.zeros(nn * cb, np.uint8)
            while (v < nn * vecs).any():
                live = v < nn * vecs
                assert (i[live] == v[live] // vecs).all() and (c[live] == v[live] % vecs).all()
                iv, cv = i[live], c[live]
                keep = copied[p0 + iv]
                iv, cv = iv[keep, None], cv[keep, None]
                for k in range(K):
                    want = src[rows_kn[k, p0 + iv] * row_bytes + c0 + cv * 16 + lanes16]
                    assert (stage[iv * K * cb + k * cb + cv * 16 + lanes16] == want).all(), k
                dst[iv * cb + cv * 16 + lanes16] = stage[iv * K * cb + cv * 16 + lanes16]
                v = v + C
                i = i + di
                c = c + dc
                wrap = c >= vecs
                c[wrap] -= vecs
                i[wrap] += 1
            # the bulk store: nn whole rows, or one output's piece
            at = p0 * row_bytes + c0
            assert pieces == 1 or nn == 1
            out[at:at + nn * cb] = dst
            writes[at:at + nn * cb] += 1
    return out, writes


@pytest.mark.parametrize("K", [1, 4])
def test_k10_ring_fits_shared_memory(K):
    """A K-tap ring's stages, their outputs' operands, two mbarriers each
    and, with four taps, two output buffers fit an SM's 227 KB."""
    SB, stages = _k10(f"K10_RING_STAGE_BYTES_K{K}"), _k10(f"K10_RING_STAGES_K{K}")
    out = 0 if K == 1 else SB // K
    assert stages * (SB + 32 * _k10("K10_RING_MAX_RUN") + 16) + 2 * out <= 232448
    assert 32 * (_k10("K10_RING_CONSUMERS") + _k10("K10_RING_PRODUCERS")) <= 1024


@pytest.mark.parametrize("K", [1, 4])
@pytest.mark.parametrize("row_bytes", [192, 512, 1024, 12288, 16384, 16400, 49152, 49168])
@pytest.mark.parametrize("n", [1, 37, 333])
def test_k10_ring_copies_reads_and_stores(K, row_bytes, n):
    """Runs of whole outputs, one output a run at a stage's edge, and
    pieces past it: each output byte is stored once, and from its own taps;
    horizontal neighbours (one row apart) travel in one copy."""
    rng = np.random.default_rng(K * 7 + row_bytes + n)
    rows = 24
    src = rng.integers(0, 256, rows * row_bytes, dtype=np.uint8).astype(np.int16)
    r0 = rng.integers(0, rows - 1, (2, n))
    nb = np.where(rng.random((2, n)) < 0.7, r0 + 1, rng.integers(0, rows, (2, n)))
    rows_kn = np.stack([r0[0], nb[0], r0[1], nb[1]])[:K]
    copied = rng.random(n) < 0.8
    copied[0] = True
    out, writes = k10_ring_model(src, rows_kn, copied, K, row_bytes)
    assert (writes == 1).all()
    want = src.reshape(rows, row_bytes)[rows_kn[0]].reshape(-1).astype(np.uint8)
    keep = np.repeat(copied, row_bytes)
    assert np.array_equal(out[keep], want[keep])
