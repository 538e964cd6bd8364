"""Command-line renderer: ``python -m mitsuba_tpu_torch scene.xml [...]``.

The reference CLI (mitsuba.cpp), as the JAX package's ``__main__`` has it:
-o output, -D key=value scene defines, -L log level, -z quiet, -x skip
scenes whose output exists, -r SEC periodic partial-image flush, --spp and
--size overrides. It renders on the card; ``--cpu`` asks for the CPU. A
file whose integrator has an ``li`` (path, volpath, direct, ao, field) goes
through ``render_pass`` in passes, a 1x1 meter's too (its film of
pixel-jittered samples, times ``ray_weight``), as in the JAX CLI;
``api.render`` sends a meter to ``render_meter`` instead. The integrators
without one (ptracer, bdpt, pssmlt, mlt, erpt: ``api.WHOLE_IMAGE``) render
through ``api.render``, where the JAX CLI stops with ``ValueError:
unknown integrator type``; they have no partial film, so -r writes nothing
before the final image and says so once. The JAX CLI's checkpoints (-c),
device count above 1 (-p) and concurrent scenes (-j above 1) land in a
later slice of the port and raise.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mitsuba_tpu_torch",
        description="PyTorch/CUDA port of the mitsuba_tpu renderer "
                    "(Mitsuba 0.6 scene files)",
    )
    ap.add_argument("scenes", nargs="+", help="scene XML file(s)")
    ap.add_argument("-o", "--output", default=None,
                    help="output file (default: scene name + .exr)")
    ap.add_argument("-D", "--define", action="append", default=[],
                    metavar="key=value", help="scene parameter substitution")
    ap.add_argument("-p", "--devices", type=int, default=0,
                    help="number of devices (0 = one card)")
    ap.add_argument("-x", "--skip-existing", action="store_true",
                    help="skip scenes whose output already exists")
    ap.add_argument("-j", "--jobs", type=int, default=1,
                    help="scenes rendered concurrently")
    ap.add_argument("-r", "--flush", type=float, default=0.0,
                    help="write the partial image every SEC seconds")
    ap.add_argument("-c", "--checkpoint", default="",
                    help="checkpoint file for mid-render resume")
    ap.add_argument("-z", "--quiet", action="store_true")
    ap.add_argument("-L", "--log-level", default="info",
                    choices=["trace", "debug", "info", "warn", "error"])
    ap.add_argument("--spp", type=int, default=0, help="override sample count")
    ap.add_argument("--size", default="", help="override resolution WxH")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU")
    args = ap.parse_args(argv)
    # flag: (asked for, ROADMAP.md Queue 1 item where it lands)
    later = {"-c": (bool(args.checkpoint), "3.12"),
             "-j": (args.jobs > 1, "3.13"), "-p": (args.devices > 1, "3.14")}
    for flag, (asked, item) in later.items():
        if asked:
            raise NotImplementedError(
                f"{flag} lands in a later slice of the port (ROADMAP.md, "
                f"Queue 1 item {item})")

    import torch

    from .io.image import write_image
    from .io.mitsuba_xml import load_scene
    from .render import api, film as film_mod
    from .utils.logging import (TRACE, ProgressReporter, Statistics,
                                get_logger, set_log_level)

    set_log_level(TRACE if args.log_level == "trace"
                  else getattr(logging, args.log_level.upper()))
    log = get_logger()
    device = "cpu" if args.cpu else None
    defines = {}
    for d in args.define:
        k, _, v = d.partition("=")
        defines[k] = v

    for scene_path in args.scenes:
        out = args.output or os.path.splitext(scene_path)[0] + ".exr"
        if args.skip_existing and os.path.exists(out):
            log.info("skipping %s (output exists)", scene_path)
            continue
        t0 = time.time()
        log.info("loading %s ...", scene_path)
        ls = load_scene(scene_path, defines, device=device)
        settings = ls.settings
        if args.spp:
            settings = dataclasses.replace(settings, spp=args.spp)
        if args.size:
            w, h = (int(x) for x in args.size.lower().split("x"))
            settings = dataclasses.replace(settings, width=w, height=h)
        dev = ls.scene.tri_p0.device
        log.info("rendering %dx%d @ %d spp on %s", settings.width,
                 settings.height, settings.spp, dev)
        stats = Statistics.counter("render", "samples")
        progress = ProgressReporter(os.path.basename(scene_path),
                                    settings.spp, quiet=args.quiet)

        H, W = settings.height, settings.width
        if ls.integrator.type in api.WHOLE_IMAGE:
            # no partial film: one call, the final image alone
            if args.flush > 0:
                log.info("-r: integrator type %d has no partial film; only "
                         "the final image is written", ls.integrator.type)
            img = api.render(ls.scene, ls.static, ls.sensor, ls.integrator,
                             settings, device=dev).cpu().numpy()
            stats.incr(settings.spp * H * W)
            progress.update(settings.spp)
        else:
            # spp-chunked loop with a periodic flush (mitsuba.cpp -r), the
            # passes api.render makes
            film = film_mod.Film.empty(H, W, dev)
            chunk = min(settings.spp_per_pass, settings.spp)
            last_flush = time.time()
            s = 0
            with torch.no_grad():
                while s < settings.spp:
                    n = min(chunk, settings.spp - s)
                    film = api.render_pass(ls.scene, ls.static, ls.sensor,
                                           ls.integrator, settings, film, s,
                                           n)
                    s += n
                    stats.incr(n * H * W)
                    progress.update(s)
                    if (args.flush > 0
                            and time.time() - last_flush > args.flush):
                        write_image(out,
                                    film_mod.develop(film).cpu().numpy())
                        last_flush = time.time()
                img = film_mod.develop(film).cpu().numpy()
        write_image(out, img)
        log.info("wrote %s (%.1fs)", out, time.time() - t0)
        if not args.quiet:
            Statistics.print_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
