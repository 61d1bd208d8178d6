"""Demo containers and the prefetching frame-batch pipeline.

The reference records demos (server-message stream + view angles,
``CL_Record_f``, ``engine/NQ/cl_demo.c:204``) and replays them
deterministically; ``timedemo`` (``cl_demo.c:393``) replays as fast as
possible and reports fps.  Here a *demo* is a recorded cubemap sequence
(+ optional camera poses): the framework's batch-reprojection input.

Container format (``.npz``):
    frames   [N, P, S, S] uint8   — palette-indexed plate images
    palette  [256, 3] uint8
    poses    [N, 3] float32       — optional (pitch, yaw, roll) per frame

:class:`FrameBatchIterator` packs frames into the device layout
[P, S, S, B] (C++ packer) on a background thread so host packing overlaps
device compute — the framework's data-loader, standing in for the
reference's demo playback feeding the renderer.  The batches are NumPy
arrays; ``Session.render`` copies each to the session's device.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path

import numpy as np

from blinky_tpu_torch.io.cubemap import to_batch_layout
from blinky_tpu_torch.utils.timing import FrameClock


def write_demo(path, frames, palette, poses=None) -> None:
    """Write a demo container.  frames: [N, P, S, S] — uint8 palette
    indices, or packed-RGBA uint32 for true-color sources
    (``kernels.remap.pack_rgba``)."""
    frames = np.asarray(frames)
    if frames.dtype not in (np.uint8, np.uint32):
        raise ValueError(f"demo frames must be uint8 or uint32 (RGBA), "
                         f"got {frames.dtype}")
    arrs = dict(frames=frames, palette=np.asarray(palette, dtype=np.uint8))
    if poses is not None:
        arrs["poses"] = np.asarray(poses, dtype=np.float32)
    np.savez_compressed(path, **arrs)


def parse_pose_track(text: str) -> np.ndarray:
    """Parse a pose text file: one ``pitch yaw roll`` (degrees) per line,
    whitespace- or comma-separated; blank lines and ``//`` comments skipped.
    Returns [N, 3] float32."""
    rows = []
    for line in text.splitlines():
        line = line.split("//")[0].strip().replace(",", " ")
        if not line:
            continue
        vals = [float(v) for v in line.split()]
        if len(vals) != 3:
            raise ValueError(f"pose line needs 3 values, got {len(vals)}: {line!r}")
        rows.append(vals)
    return np.asarray(rows, dtype=np.float32)


def import_saveglobe_dir(directory, numplates=None):
    """Import a directory of per-frame ``f_saveglobe`` PCX plate dumps.

    The reference's concrete pipeline output is ``<name><i>.pcx`` per
    plate (``save_globe``, ``engine/NQ/fisheye.c:1467-1486``); a recorded
    sequence is one such dump per frame (e.g. ``frame0001_0.pcx`` ..
    ``frame0001_5.pcx``).  Files are grouped by the stem before the
    trailing plate index; stems sort lexicographically into frame order.

    Returns (frames [N, P, S, S] uint8, palette [256, 3] uint8,
    stems [N]).  0xFE-masked texels (the non-"full" saveglobe mode,
    ``fisheye.c:1441-1443``) import as-is.
    """
    from blinky_tpu_torch.io.pcx import decode_pcx

    groups, stems = _group_plate_files(directory, ("pcx",))
    if numplates is None:
        numplates = 1 + max(max(g) for g in groups.values())
    frames = None
    palette = None
    for n, stem in enumerate(stems):
        g = groups[stem]
        missing = [i for i in range(numplates) if i not in g]
        if missing:
            raise ValueError(f"frame {stem!r}: missing plate(s) {missing}")
        for i in range(numplates):
            img, pal = decode_pcx(g[i].read_bytes())
            if frames is None:
                S = img.shape[0]
                frames = np.zeros((len(stems), numplates, S, S), np.uint8)
                palette = pal
            if img.shape != frames.shape[2:]:
                raise ValueError(f"frame {stem!r} plate {i}: size {img.shape} "
                                 f"!= {frames.shape[2:]}")
            frames[n, i] = img
    return frames, palette, stems


def _group_plate_files(directory, exts):
    """Group ``<stem><i>.<ext>`` plate files by frame stem.  Returns
    (groups: {stem: {plate_index: path}}, stems sorted)."""
    import re

    directory = Path(directory)
    pat = re.compile(r"^(.*?)(\d+)\.(%s)$" % "|".join(exts), re.IGNORECASE)
    groups: dict = {}
    for p in sorted(directory.iterdir()):
        m_ = pat.match(p.name)
        if not m_:
            continue
        stem, idx = m_.group(1), int(m_.group(2))
        groups.setdefault(stem, {})[idx] = p
    if not groups:
        raise ValueError(
            f"no '<name><i>.{'/'.join(exts)}' plate files found in {directory}")
    return groups, sorted(groups)


def _decode_image(path) -> np.ndarray:
    """Read a .png/.ppm file -> [H, W, 3] u8 RGB (gray promoted)."""
    from blinky_tpu_torch.io.png import decode_png
    from blinky_tpu_torch.io.ppm import decode_ppm

    data = Path(path).read_bytes()
    img = (decode_png(data) if Path(path).suffix.lower() == ".png"
           else decode_ppm(data))
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    return img


def import_rgb_faces_dir(directory, numplates=None):
    """Import a directory of TRUE-COLOR per-frame cubemap faces.

    The palette-free counterpart of :func:`import_saveglobe_dir` for
    360°-video-style sources: ``<stem><i>.png`` / ``<stem><i>.ppm`` RGB
    faces (one set per frame, plate order matching the globe) become
    packed-RGBA uint32 frames the remap kernel gathers as 4-byte texels
    (``kernels/remap.py`` module docstring; the reference's own world is
    palette-only, so this surface is an extension).

    Returns (frames [N, P, S, S] uint32, stems [N]).
    """
    from blinky_tpu_torch.kernels.remap import pack_rgba

    groups, stems = _group_plate_files(directory, ("png", "ppm"))
    if numplates is None:
        numplates = 1 + max(max(g) for g in groups.values())
    frames = None
    for n, stem in enumerate(stems):
        g = groups[stem]
        missing = [i for i in range(numplates) if i not in g]
        if missing:
            raise ValueError(f"frame {stem!r}: missing plate(s) {missing}")
        for i in range(numplates):
            rgb = _decode_image(g[i])
            if frames is None:
                S = rgb.shape[0]
                frames = np.zeros((len(stems), numplates, S, S), np.uint32)
            if rgb.shape[:2] != frames.shape[2:]:
                raise ValueError(f"frame {stem!r} plate {i}: size "
                                 f"{rgb.shape[:2]} != {frames.shape[2:]}")
            frames[n, i] = pack_rgba(rgb)
    return frames, stems


def read_demo(path):
    """Read a demo container -> dict(frames, palette, poses|None)."""
    with np.load(path) as z:
        return dict(
            frames=z["frames"],
            palette=z["palette"],
            poses=z["poses"] if "poses" in z.files else None,
        )


class FrameBatchIterator:
    """Iterate [P, S, S, B] device-layout batches with background prefetch.

    The last batch is zero-padded to *batch* frames (static shapes keep the
    remap kernel warm); ``n_valid`` on each yielded item gives the real
    frame count.
    """

    def __init__(self, frames: np.ndarray, batch: int, prefetch: int = 2):
        frames = np.asarray(frames)
        self.frames = frames if frames.dtype == np.uint32 else frames.astype(
            np.uint8, copy=False)
        self.batch = int(batch)
        self.n = self.frames.shape[0]
        self.prefetch = max(1, prefetch)

    def __len__(self):
        return (self.n + self.batch - 1) // self.batch

    def _pack(self, i0: int):
        chunk = self.frames[i0 : i0 + self.batch]
        n_valid = chunk.shape[0]
        if n_valid < self.batch:
            pad = np.zeros((self.batch - n_valid,) + chunk.shape[1:],
                           chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        return to_batch_layout(chunk), n_valid

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abort = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up if the consumer went away
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for i0 in range(0, self.n, self.batch):
                    if not _put((self._pack(i0), None)):
                        return
                _put((stop, None))
            except BaseException as e:  # propagate into the consumer
                _put((stop, e))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item, err = q.get()
                if item is stop:
                    if err is not None:
                        raise err
                    break
                yield item
            t.join()
        finally:
            abort.set()


def timedemo(session, frames, batch: int = 64, rubix=None, decode_rgb=False):
    """Replay a frame sequence through the session as fast as possible and
    report throughput — the ``timedemo`` analog (``cl_demo.c:364-393``).

    Renders on the session's device and, for a CUDA result, synchronises
    that device before the clock stops.  Returns (outputs_last_batch,
    FrameClock) and logs the reference's "frames seconds fps" line to the
    session console.
    """
    import torch

    clock = FrameClock()
    out = None
    for batch_frames, n_valid in FrameBatchIterator(frames, batch):
        out = session.render(batch_frames, rubix=rubix, decode_rgb=decode_rgb)
        clock.tick(n_valid)
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)  # the final batch, before stopping
    session._print(clock.report())
    return out, clock


def import_equirect_dir(directory, platesize: int = 512, globe=None):
    """Import a directory of equirectangular panoramas (one ``.png`` /
    ``.ppm`` per frame, sorted by name) as packed-RGBA uint32 cubemap
    frames via :func:`blinky_tpu_torch.io.cubemap.equirect_to_cubemap` — the
    bridge from real 360° video to the batch pipeline.

    Returns (frames [N, P, S, S] uint32, stems [N]).
    """
    from blinky_tpu_torch.kernels.ingest import EquirectIngest
    from blinky_tpu_torch.kernels.remap import pack_rgba
    from blinky_tpu_torch.palette import MAX_PLATES

    directory = Path(directory)
    paths = [p for p in sorted(directory.iterdir())
             if p.suffix.lower() in (".png", ".ppm")]
    if not paths:
        raise ValueError(f"no .png/.ppm panoramas found in {directory}")
    # streaming host executor, one pano resident at a time (a long 4K
    # video would not fit decoded all at once): EquirectIngest.host, the
    # NumPy executor.  Pipelines that stay on the device should use
    # Session.render_equirect / EquirectIngest directly.
    kern = None
    frames = np.zeros((len(paths), MAX_PLATES, platesize, platesize),
                      np.uint32)
    for n, p in enumerate(paths):
        pano = _decode_image(p)
        if kern is None:
            kern = EquirectIngest(pano.shape[0], pano.shape[1], platesize,
                                  globe=globe, device="cpu")
        if pano.shape[:2] != kern.pano_hw:
            raise ValueError(f"{p.name}: pano size {pano.shape[:2]} != "
                             f"{kern.pano_hw}")
        frames[n] = kern.host(pack_rgba(pano))
    return frames, [p.stem for p in paths]
