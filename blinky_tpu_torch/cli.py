"""Command-line interface: the ``f_*`` vocabulary outside the console.

The port of :mod:`blinky_tpu.cli`, with the same subcommands, flags,
messages, exit codes and output bytes.  The reference's user surface is the
Quake console (13 commands + ``fisheye``, ``engine/NQ/fisheye.c:651-665``);
this CLI drives the same vocabulary for batch use::

    python -m blinky_tpu_torch.cli remap --frames glb --numplates 6 \\
        --cmd "f_lens stereographic" --cmd "f_fov 200" --out warped.pcx
    python -m blinky_tpu_torch.cli lenses          # f_lens <tab> analog
    python -m blinky_tpu_torch.cli bench --quick
    python -m blinky_tpu_torch.cli parity --lens panini --globe cube
    blinky-tpu-torch reproject --demo demo.npz --device cpu

One flag is the port's own: ``--device`` (every subcommand; default
``cuda``), the device the session's tables and kernels live on.  The JAX
CLI took its device from the environment.  With ``--device cuda`` and no
card, a subcommand that touches the device raises; ``--device cpu`` runs
the kernels' plain versions.  ``reproject --shard`` splits the batch over
the cards there are (:mod:`blinky_tpu_torch.parallel`), and over
``[cpu]`` with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from blinky_tpu_torch.kernels.remap import host_array as _host


def _device(args) -> torch.device:
    """The ``--device`` of a subcommand that touches it: a card that is not
    there raises here, before any work."""
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA device here "
                           "(pass --device cpu to run on the CPU)")
    return dev


def _add_session_args(p):
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--cmd", action="append", default=[], help="console command, repeatable")
    p.add_argument("--palette", default=None,
                   help="palette source: a .pak (gfx/palette.lmp inside), "
                        "a raw 768-byte .lmp, or an f_dumppal text file")
    p.add_argument("--lens-dir", action="append", default=[],
                   help="directory of user lens scripts (.py / .lua), repeatable")
    p.add_argument("--globe-dir", action="append", default=[],
                   help="directory of user globe scripts (.py / .lua), repeatable")


def _script_dirs(args) -> dict:
    """Session kwargs for the user script dirs (docs/SCRIPTING.md)."""
    return dict(lens_dirs=args.lens_dir, globe_dirs=args.globe_dir)


def _load_palette(spec):
    """Resolve a --palette argument (pak / lmp / dumppal text)."""
    from pathlib import Path

    from blinky_tpu_torch.palette import load_dumppal, load_lmp

    if spec is None:
        return None
    p = Path(spec)
    if p.suffix.lower() == ".pak":
        from blinky_tpu_torch.io.pak import load_palette_from_pak

        return load_palette_from_pak(p)
    data = p.read_bytes()
    # Dispatch on file type: a raw .lmp is exactly 768 palette bytes (or
    # carries the .lmp suffix); anything else is f_dumppal text ("r, g, b,"
    # per line), which is itself >= 768 bytes and would silently misparse
    # as garbage raw bytes if probed with load_lmp first.
    if p.suffix.lower() == ".lmp" or len(data) == 768:
        return load_lmp(data)
    return load_dumppal(data.decode())


def cmd_remap(args) -> int:
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.io.cubemap import load_globe_pcx, synthetic_cubemap
    from blinky_tpu_torch.io.pcx import encode_pcx

    sess = Session(args.width, args.height, echo=True, device=_device(args),
                   cmdline_cmds=args.cmd, **_script_dirs(args))
    user_pal = _load_palette(args.palette)
    if user_pal is not None:
        sess.palette = user_pal
    for c in args.cmd:
        sess.cmd(c)
    if args.frames:
        frames, pal = load_globe_pcx(args.frames, args.numplates)
        if pal is not None and pal.any() and user_pal is None:
            sess.palette = pal
    else:
        frames = synthetic_cubemap(sess.platesize)
    out = _host(sess.render(frames, rubix=args.rubix or None))
    path = args.out
    if path.endswith(".pcx"):
        with open(path, "wb") as f:
            f.write(encode_pcx(out, sess.palette))
    elif path.endswith(".png"):
        from blinky_tpu_torch.io.png import encode_png

        with open(path, "wb") as f:
            f.write(encode_png(sess.palette[out]))
    elif path.endswith(".ppm"):
        from blinky_tpu_torch.io.ppm import encode_ppm

        with open(path, "wb") as f:
            f.write(encode_ppm(sess.palette[out]))
    else:
        if not path.endswith(".npz"):
            path += ".npz"  # np.savez appends it; report the real file
        np.savez(path, screen=out, palette=sess.palette)
    print(f"wrote {path} ({out.shape[1]}x{out.shape[0]})")
    return 0


def cmd_demo_synth(args) -> int:
    """Write a synthetic demo container (recorded cubemap sequence with a
    camera-pose track) for pipeline testing without game assets."""
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap
    from blinky_tpu_torch.io.dataset import write_demo
    from blinky_tpu_torch.palette import default_palette

    S, N = args.platesize, args.frames
    base = synthetic_cubemap(S)
    frames = np.empty((N,) + base.shape, np.uint8)
    for i in range(N):
        frames[i] = np.roll(base, 2 * i, axis=2)  # cheap distinct frames
    t = np.arange(N, dtype=np.float32)
    poses = np.stack([10 * np.sin(t / 20), 3 * t, 0 * t], axis=1)  # pitch/yaw/roll
    write_demo(args.out, frames, default_palette(), poses)
    print(f"wrote {args.out}: {N} frames, platesize {S}")
    return 0


def cmd_demo_import(args) -> int:
    """Bridge from the reference engine's own output: a directory of
    per-frame ``f_saveglobe`` PCX plate dumps (``save_globe``,
    ``fisheye.c:1467-1486``) + an optional pose track becomes a demo
    container for the batch pipeline."""
    from pathlib import Path

    from blinky_tpu_torch.io.dataset import import_saveglobe_dir, parse_pose_track, write_demo

    if args.poses and args.dem:  # before the (possibly long) dump decode
        print("error: --poses and --dem are mutually exclusive")
        return 2
    if args.rgb and args.equirect:
        print("error: --rgb and --equirect are mutually exclusive")
        return 2
    if args.equirect:
        # equirectangular panoramas (one per frame) -> cubemap plates
        from blinky_tpu_torch.io.dataset import import_equirect_dir

        frames, stems = import_equirect_dir(args.dir,
                                            platesize=args.equirect)
        palette = None
    elif args.rgb:
        # true-color faces (png/ppm) -> packed-RGBA uint32 frames; the
        # palette only matters for the background underlay
        from blinky_tpu_torch.io.dataset import import_rgb_faces_dir

        frames, stems = import_rgb_faces_dir(args.dir, numplates=args.numplates)
        palette = None
    else:
        frames, palette, stems = import_saveglobe_dir(args.dir,
                                                      numplates=args.numplates)
    user_pal = _load_palette(args.palette)
    if user_pal is not None:
        palette = user_pal
    elif palette is None or not palette.any():
        from blinky_tpu_torch.palette import default_palette

        palette = default_palette()
    poses = None
    if args.poses:
        poses = parse_pose_track(Path(args.poses).read_text())
        if len(poses) == 0:
            print("note: pose file contains no poses; importing without a track")
            poses = None
        elif len(poses) != len(frames):
            print(f"note: {len(poses)} poses for {len(frames)} frames "
                  "(playback holds the last pose)")
    elif args.dem:
        # camera track straight from the engine's own recording
        # (CL_WriteDemoMessage, cl_demo.c:77-92)
        from blinky_tpu_torch.io.demfile import lerp_pose_track, read_dem

        dem = read_dem(args.dem)
        poses = dem.poses
        if len(poses) == 0:
            print("note: .dem contains no messages; importing without a track")
            poses = None
        elif len(poses) != len(frames):
            # frames interpolate between demo messages, exactly like
            # playback does (CL_RelinkEntities, cl_main.c:567-576)
            poses = lerp_pose_track(poses, len(frames))
            print(f"note: resampled {len(dem)} demo messages to "
                  f"{len(frames)} frame poses (engine lerp)")
    write_demo(args.out, frames, palette, poses)
    N, P, S, _ = frames.shape
    print(f"wrote {args.out}: {N} frames ({stems[0]} .. {stems[-1]}), "
          f"{P} plates, platesize {S}")
    return 0


def cmd_serve(args) -> int:
    """Interactive browser viewer: drag to look, console box, shortcut
    keys — the optional vid-layer analog (SURVEY.md §2.5)."""
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.viewer import Viewer

    poses = None
    if args.demo:
        from blinky_tpu_torch.io.dataset import read_demo

        demo = read_demo(args.demo)
        frames, pal = demo["frames"], demo["palette"]
        poses = demo.get("poses")
    else:
        from blinky_tpu_torch.io.cubemap import synthetic_cubemap
        from blinky_tpu_torch.palette import default_palette

        frames = synthetic_cubemap(args.platesize)[None]
        pal = default_palette()
    user_pal = _load_palette(args.palette)
    if user_pal is not None:
        pal = user_pal
    sess = Session(args.width, args.height, platesize=frames.shape[2],
                   palette=pal, echo=True, cmdline_cmds=args.cmd,
                   device=_device(args), **_script_dirs(args))
    # the shipped game config (game/id1/config.cfg:6-8): shortcut keys on,
    # "0" re-toggles them, "r" toggles the rubix grid
    sess.cmd("f_shortcutkeys")
    sess.cmd("bind 0 f_shortcutkeys")
    sess.cmd("bind r f_rubix")
    for c in args.cmd:
        sess.cmd(c)
    # bind-first cold serve (VERDICT r3 task 4; fisheye.c:306-322 — the
    # loop never blocks): the port binds immediately, requests serve
    # host-gathered frames (bit-equal to the device kernel), and the
    # device's cold start (the kernels' nvcc build, the CUDA context)
    # happen on a background thread that flips the viewer to the device
    # path when warm.  --no-warm skips the background warm and starts in
    # warm mode instead: nothing else ever sets device_ready, so
    # device_warm=False there would pin the viewer to host renders
    # forever — with --no-warm the first request pays the compile, as
    # its --help text says.
    pose_scale = args.pose_scale
    if pose_scale != "auto":
        from blinky_tpu_torch.kernels.posed import check_render_scale

        try:
            pose_scale = int(pose_scale)
            check_render_scale(args.width, args.height, pose_scale)
        except ValueError as e:
            print(f"error: --pose-scale: {e}")
            return 2
    viewer = Viewer(sess, frames, poses=poses, host=args.host,
                    port=args.port, device_warm=args.no_warm,
                    pose_scale=pose_scale)
    if not args.no_warm:
        print("warming the device in the background (first-ever compile "
              "can take a minute; host renders serve meanwhile) ...")
        viewer.start_background_warm()
    print(f"serving {len(frames)} frame(s) at {viewer.address} — Ctrl-C to stop")
    try:
        viewer.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


def cmd_reproject(args) -> int:
    """Batch-reproject a demo container through a lens — the framework's
    ``timedemo``-style offline pipeline (BASELINE config 4)."""
    from pathlib import Path

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.io.dataset import FrameBatchIterator, read_demo
    from blinky_tpu_torch.io.pcx import encode_pcx
    from blinky_tpu_torch.io.ppm import encode_ppm
    from blinky_tpu_torch.utils.timing import FrameClock

    demo = read_demo(args.demo)
    frames, pal = demo["frames"], demo["palette"]
    user_pal = _load_palette(args.palette)
    if user_pal is not None:
        pal = user_pal
    N, P, S, _ = frames.shape
    sess = Session(args.width, args.height, platesize=S, palette=pal,
                   echo=True, cmdline_cmds=args.cmd, device=_device(args),
                   **_script_dirs(args))
    for c in args.cmd:
        sess.cmd(c)
    if args.pose:
        p, y, r = (float(v) for v in args.pose.split(","))
        # fixed-point text: the console's Q_atof has no exponent syntax
        # ('1e-05' would parse as 1.0)
        sess.cmd(f"setviewangles {p:.9f} {y:.9f} {r:.9f}")
    poses = demo.get("poses") if args.follow_poses else None
    if poses is not None and len(poses) == 0:
        poses = None
    if args.follow_poses and poses is None:
        print("demo has no pose track; --follow-poses ignored")

    is_rgba = frames.dtype == np.uint32  # true-color (demo-import --rgb)
    out_rgba = is_rgba or args.aa > 1    # AA resolves in RGB space
    if args.aa > 1 and poses is not None:
        print("error: --aa applies to static views (render_aa); "
              "drop --follow-poses")
        return 2
    if out_rgba and args.format == "pcx":
        print("error: pcx is palette-indexed; use --format png/ppm/npz "
              "for true-color output (gif quantizes via median cut)")
        return 2
    from blinky_tpu_torch.kernels.posed import check_render_scale

    k = args.pose_scale
    if k != "auto":
        try:
            k = int(k)
            check_render_scale(args.width, args.height, k)
        except ValueError as e:
            print(f"error: --pose-scale: {e}")
            return 2
    if (k == "auto" or k > 1) and poses is None:
        print("--pose-scale applies to --follow-poses only; ignored")
    if args.format == "gif" and not 0 <= args.gif_delay <= 0xFFFF:
        print("error: --gif-delay must be 0..65535 centiseconds")
        return 2
    mesh = None
    if args.shard:
        if poses is not None or args.aa > 1:
            print("error: --shard applies to the plain batched remap "
                  "(drop --follow-poses / --aa)")
            return 2
        from blinky_tpu_torch import parallel

        # the cards there are (one CPU device under --device cpu)
        devices = parallel.visible_devices(sess.device.type)
        n_dev = len(devices)
        if n_dev < 2:
            print(f"--shard: 1 device visible; running unsharded")
        else:
            mesh = parallel.make_mesh(n_data=n_dev, n_space=1, devices=devices)
            print(f"shard: data-parallel over {n_dev} devices")
    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    clock = FrameClock()
    wrote = 0
    stack = [] if args.format in ("npz", "gif") else None
    # rubix comes from --rubix or from session state (a user --cmd f_rubix);
    # the per-frame-pose path needs the expanded source either way
    want_rubix = bool(args.rubix or sess.rubix_enabled)
    if args.batch <= 0:
        # --batch 0: derive the chunk from the source layout + the HBM
        # budget (budget.py — the reference sizes its buffers
        # from the live dimensions, fisheye.c:703-727) instead of a hand
        # constant; posed playback keeps per-pose index tables live, so
        # its chunks come out smaller
        from blinky_tpu_torch.budget import (
            aa_bytes_per_lane, feasible_batch, planes_bytes_per_lane,
            posed_bytes_per_lane, screen_bytes_per_lane,
        )

        if poses is not None:
            per_lane = posed_bytes_per_lane(
                S, P, args.width, args.height,
                render_scale=1 if k == "auto" else k,
                rgba=is_rgba, expanded=want_rubix)
            args.batch = feasible_batch(per_lane, 0, cap=N, device=sess.device)
        elif args.aa > 1:
            # the decoded planes and the supersampled screen, both packed
            # RGBA, dwarf the u8 model's planes and screen; the planes as
            # planes_bytes_per_lane counts them (padded, doubled for rubix)
            from blinky_tpu_torch.palette import MAX_PLATES

            per_lane = aa_bytes_per_lane(
                S, 2 * MAX_PLATES if want_rubix else max(P, MAX_PLATES),
                args.width, args.height, args.aa, rgba=is_rgba)
            args.batch = feasible_batch(per_lane, 0, cap=N, device=sess.device)
        else:
            # under --shard each device holds only its B-shard: the
            # per-device budget affords n_devices x the batch
            args.batch = feasible_batch(
                planes_bytes_per_lane(S, P, rgba=is_rgba,
                                      expanded=want_rubix),
                screen_bytes_per_lane(args.width, args.height,
                                      rgba=is_rgba),
                cap=N, device=sess.device,
                n_devices=1 if mesh is None else mesh.devices.size)
        print(f"auto batch: {args.batch}")
    if mesh is not None and args.batch % mesh.devices.size:
        # a sharded chunk must split evenly over the mesh
        args.batch = ((args.batch // mesh.devices.size + 1)
                      * mesh.devices.size)
        print(f"--shard: batch rounded up to {args.batch} "
              f"(multiple of {mesh.devices.size} devices)")
    palmap = None
    if want_rubix and not is_rgba:
        from blinky_tpu_torch.palette import create_palmap

        palmap = create_palmap(sess.palette)  # hoisted out of the loop
    for batch_frames, n_valid in FrameBatchIterator(frames, args.batch):
        if want_rubix:
            from blinky_tpu_torch.kernels.remap import expand_rubix_source

            batch_frames = expand_rubix_source(batch_frames, sess.palette,
                                               palmap=palmap)
        if poses is not None:
            # per-frame poses: one fused device call builds a lensmap for
            # every frame's own view basis and remaps it (kernels/posed.py)
            # — a short pose track holds its last pose for the rest.
            B = batch_frames.shape[-1]
            pidx = np.minimum(np.arange(wrote, wrote + B), len(poses) - 1)
            out = np.moveaxis(
                _host(sess.render_posed(batch_frames,
                                             np.asarray(poses)[pidx],
                                             render_scale=k)),
                0, -1,
            )
        elif args.aa > 1:
            out = _host(sess.render_aa(batch_frames, factor=args.aa,
                                            rubix=want_rubix))
        elif mesh is not None:
            out = _host(sess.render_sharded(batch_frames, mesh,
                                                 rubix=want_rubix))
        else:
            out = _host(sess.render(batch_frames, rubix=want_rubix))
        clock.tick(n_valid)
        for b in range(n_valid):
            img = out[..., b]
            if out_rgba and args.format in ("ppm", "png"):
                from blinky_tpu_torch.kernels.remap import unpack_rgb

                rgb = unpack_rgb(img)
            elif args.format in ("ppm", "png"):
                rgb = sess.palette[img]
            if args.format == "pcx":
                (outdir / f"frame{wrote:06d}.pcx").write_bytes(encode_pcx(img, sess.palette))
            elif args.format == "ppm":
                (outdir / f"frame{wrote:06d}.ppm").write_bytes(encode_ppm(rgb))
            elif args.format == "png":
                from blinky_tpu_torch.io.png import encode_png

                (outdir / f"frame{wrote:06d}.png").write_bytes(encode_png(rgb))
            else:
                stack.append(img)
            wrote += 1
    if stack is not None and args.format == "gif":
        from blinky_tpu_torch.io.gif import encode_gif, encode_gif_u32

        if out_rgba:
            # true-color run: one global median-cut palette over the
            # whole sequence, then the lossless palettized encoder
            data = encode_gif_u32(stack, delay_cs=args.gif_delay)
        else:
            data = encode_gif(np.stack(stack, axis=-1), sess.palette,
                              delay_cs=args.gif_delay)
        (outdir / "warped.gif").write_bytes(data)
    elif stack is not None:
        np.savez_compressed(outdir / "warped.npz",
                            screen=np.stack(stack), palette=sess.palette)
    print(clock.report())
    print(f"wrote {wrote} frames to {outdir}")
    return 0


def cmd_sweep(args) -> int:
    """Animated zoom sweep: rebuild the lensmap across an f_fov/f_vfov
    range and write one animated GIF — the moving version of the bench's
    rebuild-path config (BASELINE config 1), and a direct showcase of the
    builder's no-recompile dynamic-zoom design (fov is a traced argument,
    so every step is a warm ms-scale device call)."""
    from pathlib import Path

    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap
    from blinky_tpu_torch.io.dataset import read_demo
    from blinky_tpu_torch.io.gif import encode_gif
    from blinky_tpu_torch.utils.timing import FrameClock

    pal = _load_palette(args.palette)
    if args.demo:
        demo = read_demo(args.demo)
        frames = demo["frames"][0]  # [P, S, S] u8
        if frames.dtype != np.uint8:
            print("error: sweep needs a palettized demo (GIF output)")
            return 2
        if pal is None:
            pal = demo["palette"]
        src = frames
    else:
        src = None  # synthesized after the session fixes platesize
    # the f32 device builder makes per-step rebuilds ms-scale (the exact
    # host build would pay seconds per frame; drift is characterized in
    # docs/PERF.md section 5 and invisible in motion)
    device = _device(args)
    sess = Session(args.width, args.height,
                   platesize=(src.shape[1] if src is not None else None),
                   palette=pal, echo=True, backend="torch", device=device,
                   cmdline_cmds=args.cmd, **_script_dirs(args))
    for c in args.cmd:
        sess.cmd(c)
    sess.cmd(f"f_lens {args.lens}; f_globe {args.globe}")
    if not sess.lens_valid or not sess.globe_valid:
        print("error: invalid lens/globe")
        return 2
    if src is None:
        src = synthetic_cubemap(sess.platesize)
    # honor rubix turned on via --cmd too, like cmd_reproject
    want_rubix = bool(args.rubix or sess.rubix_enabled)
    if want_rubix:
        # expand once to the raw||tinted layout: rubix then rides the
        # static gather indices with zero per-frame cost (the plain-source
        # per-element tint LUT is catastrophic on v5e — kernels/remap.py)
        from blinky_tpu_torch.kernels.remap import expand_rubix_source

        src = expand_rubix_source(src, sess.palette)
    zoom_cmd = "f_vfov" if args.vfov else "f_fov"
    values = np.linspace(args.start, args.stop, args.steps)
    if args.bounce:
        values = np.concatenate([values, values[-2:0:-1]])
    # Fused ramp (VERDICT r2 task 8): solve every step's scale on the
    # host, then run the builder over the zoom axis at once: one
    # sweep (K9 on a card) for the whole ramp instead of one render per
    # step.  Bit-identical to the per-step path (same traced builder,
    # same f32 scales; pinned in tests/test_cli_pipeline.py).  Any step
    # the zoom solver rejects falls back to the per-step loop, whose
    # per-command behavior (error print + background frame) is the
    # reference's.
    from blinky_tpu_torch.api import _atof
    from blinky_tpu_torch.lensmap import Zoom, ZoomError, calc_scale

    fused_scales = None
    if (sess.fisheye_enabled  # `--cmd "fisheye 0"` renders the plain
            # rectilinear view per step — only the per-step path does that
            and sess.lens.map_type == "inverse"
            and getattr(sess.lens, "jittable", True)
            and sess.view_angles is None):
        try:
            fused_scales = [
                calc_scale(
                    Zoom("vfov" if args.vfov else "fov",
                         int(_atof(f"{v:.6g}"))),  # the console's int parse
                    sess.lens, args.width, args.height)
                for v in values
            ]
        except ZoomError:
            fused_scales = None
    clock = FrameClock()
    if fused_scales is not None:
        from blinky_tpu_torch.kernels.posed import zoom_sweep_remap

        out_ramp = _host(zoom_sweep_remap(
            sess.lens, sess.globe, fused_scales, src,
            args.width, args.height, numcells=sess.rubix_numcells,
            cell_size=sess.rubix_cell_size, pad_size=sess.rubix_pad_size,
            device=device))
        for v in values:
            sess.cmd(f"{zoom_cmd} {v:.6g}")  # echo + end state, no render
        shots = list(out_ramp)
        clock.tick(len(values))
    else:
        shots = []
        for v in values:
            sess.cmd(f"{zoom_cmd} {v:.6g}")
            shots.append(_host(sess.render(src, rubix=want_rubix)))
            clock.tick(1)
    out = Path(args.out)
    out.write_bytes(encode_gif(np.stack(shots, axis=-1), sess.palette,
                               delay_cs=args.gif_delay))
    print(clock.report())
    print(f"wrote {len(shots)} steps ({zoom_cmd} {args.start:g}..{args.stop:g}"
          f"{', bounce' if args.bounce else ''}) to {out}")
    return 0


def cmd_gallery(args) -> int:
    """Render every shipped lens once (its onload default zoom) into an
    output directory — the visual-QA sweep the reference did by tabbing
    through ``f_lens`` in game."""
    from pathlib import Path

    import html

    from blinky_tpu_torch import lenses
    from blinky_tpu_torch.api import Session
    from blinky_tpu_torch.io.cubemap import synthetic_cubemap
    from blinky_tpu_torch.io.png import encode_png
    from blinky_tpu_torch.io.ppm import encode_ppm

    outdir = Path(args.outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    sess = Session(args.width, args.height, device=_device(args))
    if args.rubix:
        sess.cmd("f_rubix")
    frames = synthetic_cubemap(sess.platesize)
    ext = "png" if args.format == "png" else "ppm"
    cells = []
    for name in lenses.names():
        sess.cmd(f"f_lens {name}")
        if not sess.lens_valid:
            print(f"{name}: SKIPPED (invalid)")
            continue
        img = _host(sess.render(frames))
        rgb = sess.palette[img]
        data = encode_png(rgb) if ext == "png" else encode_ppm(rgb)
        (outdir / f"{name}.{ext}").write_bytes(data)
        zoom = sess.zoom.command() or "no zoom"
        cells.append((name, zoom, sess.lens.map_type))
        print(f"{name}: {zoom}")
    if args.html:
        # contact sheet (browsers render PNG; use --format png with it)
        body = "".join(
            f'<figure><img src="{n}.{ext}" width="{args.width}">'
            f"<figcaption>{html.escape(n)} &middot; {html.escape(z)} "
            f"&middot; {m}-mapped</figcaption></figure>"
            for n, z, m in cells)
        (outdir / "index.html").write_text(
            "<!DOCTYPE html><html><head><meta charset='utf-8'>"
            "<title>blinky-tpu lens gallery</title><style>"
            "body{background:#111;color:#ddd;font:13px monospace}"
            "figure{display:inline-block;margin:6px}"
            "img{border:1px solid #333;image-rendering:pixelated}"
            "figcaption{text-align:center;padding:2px}</style></head>"
            f"<body><h2>blinky-tpu — all {len(cells)} lenses "
            f"({args.width}x{args.height}"
            f"{', rubix' if args.rubix else ''})</h2>{body}</body></html>")
        print(f"wrote {outdir / 'index.html'}")
    return 0


def cmd_lenses(args) -> int:
    from blinky_tpu_torch import lenses

    for n in lenses.names():
        print(n)
    return 0


def cmd_globes(args) -> int:
    from blinky_tpu_torch import globes

    for n in globes.names():
        print(n)
    return 0


def cmd_help(args) -> int:
    from blinky_tpu_torch.api import HELP_TEXT

    print(HELP_TEXT)
    return 0


def cmd_bench(args) -> int:
    from blinky_tpu_torch.bench.throughput import run_build_bench, run_throughput

    device = _device(args)
    batch, iters = (16, 3) if args.quick else (128, 10)
    r = run_throughput(batch=batch, iters=iters, rubix=args.rubix, decode_rgb=args.rgb,
                       device=device)
    print(json.dumps(r))
    if args.sweep:
        print(json.dumps(run_build_bench(device=device)))
    return 0


def cmd_parity(args) -> int:
    from blinky_tpu_torch import globes, lenses
    from blinky_tpu_torch.lensmap import Zoom, build_lensmap, calc_scale
    from blinky_tpu_torch.parity.oracle import oracle_inverse_lensmap

    def _is_script(s):
        return s.endswith((".py", ".lua")) or "/" in s

    g = (globes.load_globe_module(args.globe) if _is_script(args.globe)
         else globes.get(args.globe))
    lens = (lenses.load_lens_module(args.lens, g) if _is_script(args.lens)
            else lenses.get(args.lens, g))
    zoom = Zoom(args.zoom, args.fov)
    scale = calc_scale(zoom, lens, args.width, args.height)
    S = min(args.width, args.height)
    if lens.map_type == "forward":
        # forward lenses: the oracle is the pure-Python scan-order
        # rasterizer; compare the native C++ rasterizer against it
        from blinky_tpu_torch.lensmap.forward_raster import build_forward

        o_lm = build_forward(lens, g, scale, args.width, args.height, S,
                             use_native=False)
        o = {f: np.asarray(getattr(o_lm, f))
             for f in ("plate", "px", "py", "valid", "tint", "flat_idx")}
        b = build_forward(lens, g, scale, args.width, args.height, S,
                          use_native=True)
    else:
        o = oracle_inverse_lensmap(lens, g, scale, args.width, args.height, S)
        b = build_lensmap(lens, g, scale, args.width, args.height, S,
                          backend=args.backend, device=_device(args)).to_numpy()
    mism = {
        f: int((np.asarray(getattr(b, f)) != o[f]).sum())
        for f in ("plate", "px", "py", "valid", "tint", "flat_idx")
    }
    total = sum(mism.values())
    print(json.dumps(dict(lens=args.lens, globe=args.globe,
                          map_type=lens.map_type, backend=args.backend,
                          mismatches=mism, total=total)))
    return 0 if total == 0 else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="blinky-tpu-torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("remap", help="warp a cubemap through a lens")
    _add_session_args(p)
    p.add_argument("--frames", default=None, help="PCX prefix from f_saveglobe")
    p.add_argument("--numplates", type=int, default=6)
    p.add_argument("--rubix", action="store_true")
    p.add_argument("--out", default="warped.pcx")
    p.set_defaults(fn=cmd_remap)

    p = sub.add_parser("demo-synth", help="write a synthetic demo container")
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--platesize", type=int, default=128)
    p.add_argument("--out", default="demo.npz")
    p.set_defaults(fn=cmd_demo_synth)

    p = sub.add_parser(
        "demo-import",
        help="import a directory of per-frame f_saveglobe PCX plate dumps",
    )
    p.add_argument("dir", help="directory of <name><i>.pcx dumps (one set per frame)")
    p.add_argument("--out", default="demo.npz")
    p.add_argument("--poses", default=None,
                   help="pose track text file: 'pitch yaw roll' per line (deg)")
    p.add_argument("--dem", default=None,
                   help="read the pose track from an engine .dem recording "
                        "(resampled to frame count with the engine's lerp)")
    p.add_argument("--numplates", type=int, default=None,
                   help="plates per frame (default: inferred from indices)")
    p.add_argument("--palette", default=None,
                   help="override the PCX palette (pak / .lmp / dumppal text)")
    p.add_argument("--rgb", action="store_true",
                   help="true-color import: <stem><i>.png/.ppm RGB faces "
                        "-> packed-RGBA uint32 frames (no palette)")
    p.add_argument("--equirect", type=int, default=None, metavar="PLATESIZE",
                   help="360-video import: one equirect .png/.ppm panorama "
                        "per frame, resampled to cubemap plates of this size")
    p.set_defaults(fn=cmd_demo_import)

    p = sub.add_parser("reproject", help="batch-reproject a demo (timedemo pipeline)")
    _add_session_args(p)
    p.add_argument("--demo", required=True, help="demo .npz from demo-synth / write_demo")
    p.add_argument("--batch", type=int, default=64,
                   help="frames per device chunk; 0 = derive from the "
                        "source layout and HBM budget (budget.py)")
    p.add_argument("--rubix", action="store_true")
    p.add_argument("--shard", action="store_true",
                   help="data-parallel remap over all visible devices "
                        "(Session.render_sharded); --batch 0 then derives "
                        "n_devices x the per-device feasible chunk")
    p.add_argument("--pose", default=None, metavar="PITCH,YAW,ROLL",
                   help="rotate the view within the recorded plates (deg)")
    p.add_argument("--follow-poses", action="store_true",
                   help="track the demo's pose stream (per batch)")
    p.add_argument("--pose-scale", default="1", metavar="K",
                   help="per-frame-pose quality<->speed knob: build each "
                        "pose's lensmap at 1/K size and upsample on device "
                        "(~K^2 x the sustained fps; docs/PERF.md section 6). "
                        "'auto' probes the device and picks the smallest K "
                        "sustaining 60 fps (dynamic resolution)")
    p.add_argument("--aa", type=int, default=1, metavar="K",
                   help="supersample factor: render at Kx and box-average "
                        "down (true-color output)")
    p.add_argument("--format", default="pcx",
                   choices=["pcx", "ppm", "png", "npz", "gif"])
    p.add_argument("--gif-delay", type=int, default=5, metavar="CS",
                   help="animated-GIF frame delay in centiseconds "
                        "(--format gif; 5 = 20 fps)")
    p.add_argument("--outdir", default="warped")
    p.set_defaults(fn=cmd_reproject)

    p = sub.add_parser(
        "serve",
        help="interactive browser viewer (drag to look, console, shortcut keys)",
    )
    _add_session_args(p)
    p.add_argument("--demo", default=None,
                   help="demo .npz to play (default: one synthetic cubemap)")
    p.add_argument("--platesize", type=int, default=256,
                   help="synthetic cubemap platesize when no --demo")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8666)
    p.add_argument("--no-warm", action="store_true",
                   help="skip the startup device-builder compile for the "
                        "active lens (first drag-look will pay it instead)")
    p.add_argument("--pose-scale", default="1",
                   help="render_scale for drag-look on forward-only / "
                        "scalar-only lenses (static-ray posed preview): "
                        "an integer or 'auto' (default 1)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("gallery", help="render every lens to an image dir")
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--rubix", action="store_true")
    p.add_argument("--format", default="ppm", choices=["ppm", "png"])
    p.add_argument("--html", action="store_true",
                   help="also write an index.html contact sheet")
    p.add_argument("--outdir", default="gallery")
    p.set_defaults(fn=cmd_gallery)

    p = sub.add_parser("sweep",
                       help="animated f_fov/f_vfov zoom sweep -> GIF")
    _add_session_args(p)
    p.add_argument("--lens", default="stereographic")
    p.add_argument("--globe", default="cube")
    p.add_argument("--demo", default=None,
                   help="render frame 0 of this demo .npz (else synthetic)")
    p.add_argument("--start", type=float, default=100.0)
    p.add_argument("--stop", type=float, default=330.0)
    p.add_argument("--steps", type=int, default=24)
    p.add_argument("--vfov", action="store_true", help="sweep f_vfov")
    p.add_argument("--bounce", action="store_true",
                   help="append the reverse sweep for a seamless loop")
    p.add_argument("--rubix", action="store_true")
    p.add_argument("--gif-delay", type=int, default=5, metavar="CS")
    p.add_argument("--out", default="sweep.gif")
    p.set_defaults(fn=cmd_sweep)

    sub.add_parser("lenses", help="list lenses (f_lens <tab>)").set_defaults(fn=cmd_lenses)
    sub.add_parser("globes", help="list globes (f_globe <tab>)").set_defaults(fn=cmd_globes)
    sub.add_parser("help", help="f_help").set_defaults(fn=cmd_help)

    p = sub.add_parser("bench", help="timedemo-style throughput")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--rubix", action="store_true")
    p.add_argument("--rgb", action="store_true")
    p.add_argument("--sweep", action="store_true", help="also run the f_fov rebuild sweep")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("parity", help="oracle vs builder check")
    p.add_argument("--lens", default="panini")
    p.add_argument("--globe", default="cube")
    p.add_argument("--zoom", default="fov", choices=["fov", "vfov", "cover", "contain"])
    p.add_argument("--fov", type=int, default=180)
    p.add_argument("--width", type=int, default=96)
    p.add_argument("--height", type=int, default=72)
    p.add_argument("--backend", default="numpy", choices=["numpy", "torch"])
    p.set_defaults(fn=cmd_parity)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="the device the kernels run on: cuda (the default; "
                            "raises without a card) or cpu")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
