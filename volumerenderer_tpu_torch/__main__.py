"""Command-line entry point: ``python -m volumerenderer_tpu_torch`` (twin of
``python -m volumerenderer_tpu``).

The reference is launched as a desktop executable that opens a window on
``bunny_cloud.vdb`` (src/main.cpp:1157-1167, 1217-1227).  Its equivalent:

  python -m volumerenderer_tpu_torch render [--volume a.vdb] [--algorithm RAY]
      [--size 512] [--frames 16] [--out out.png] [--fast paired]
  python -m volumerenderer_tpu_torch view [--volume a.vdb] [--size 512]
      [--fast decimated] [--motion coarse]      # interactive window
  python -m volumerenderer_tpu_torch bench     # POINT, 128x128, 8 frames
  python -m volumerenderer_tpu_torch warmup [--volume a.vdb] [--size 512]

``--volume`` accepts .vdb / .nvdb / .npy / .npz (grid.load); without it a
procedural cloud stands in for the reference's asset.  ``--fast`` picks
the performance tier: "off" (default) keeps the reference's term order;
"paired" takes the paired divides, the analytic segment integrals and the
closed-form Beam rule; "decimated" adds gather_stride=3 and path_stride=3.
Everything runs on ``--device`` (default "cuda"; "cpu" runs the kernels'
plain versions).  ``warmup`` builds the CUDA kernels and the native
library and runs a session's first frames (uncached, view build, batch).
``view`` opens the matplotlib viewer (viewer.InteractiveViewer);
``--motion`` picks its drag-frame mode (default "coarse").
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time


def _make_renderer(args, algorithm=None):
    from . import Algorithm, Renderer, RenderParams, StaticConfig, grid

    device = args.device
    g = (grid.load(args.volume, device=device) if args.volume
         else grid.procedural.cloud(n=96, device=device))
    params = RenderParams.default().replace(
        light_source_world_pos=(0.0, 20.0, 20.0))
    cfg = {}
    fast = getattr(args, "fast", "off")
    if fast in ("paired", "decimated"):
        cfg.update(gather_eval="paired", segment_eval="paired",
                   segment_mode="analytic", beam_quadrature_rule="closed")
    if fast == "decimated":
        cfg.update(gather_stride=3, path_stride=3)
    config = StaticConfig(width=args.size, height=args.size, **cfg)
    algo = Algorithm[args.algorithm] if algorithm is None else algorithm
    return Renderer(g, config, params, algorithm=algo, device=device)


def _cmd_render(args) -> int:
    from .io import ppm

    r = _make_renderer(args)
    t0 = time.time()
    r.step(args.frames)
    img = r.image_u8()
    if args.out.endswith(".ppm"):
        ppm.write_ppm(args.out, img)
    else:
        ppm.write_png(args.out, img)
    n = int(r.lights.count.reshape(-1)[0]) if r.lights is not None else 0
    print(f"{args.algorithm} {args.frames} frames in {time.time()-t0:.1f}s "
          f"(lights={n}) -> {args.out}")
    return 0


def _cmd_view(args) -> int:
    from .viewer import InteractiveViewer

    InteractiveViewer(_make_renderer(args), motion_mode=args.motion).run()
    return 0


def _cmd_bench(args) -> int:
    args.algorithm = "POINT"
    args.volume, args.size, args.frames = "", 128, 8
    args.out = os.path.join(tempfile.gettempdir(),
                            "volumerenderer_tpu_torch_bench.png")
    return _cmd_render(args)


def _cmd_warmup(args) -> int:
    """Build the CUDA kernels (on a CUDA device) and the native library,
    then run the frames a ``render`` session starts with: the uncached
    first frame, the view build with a cached frame, and a batch."""
    from .grid import vdbio_native

    t0 = time.time()
    if args.device != "cpu":
        from .ops.kernels import _build

        _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    vdbio_native.lib()
    print(f"[warmup] kernels and native library built at "
          f"{time.time()-t0:.1f}s", flush=True)
    r = _make_renderer(args)
    r.first_frame_uncached = True
    print(f"[warmup] renderer ready at {time.time()-t0:.1f}s", flush=True)
    r.step(1)
    float(r.image().max())
    print(f"[warmup] first (uncached) frame at {time.time()-t0:.1f}s",
          flush=True)
    r.step(1)
    float(r.image().max())
    print(f"[warmup] view built + cached step at {time.time()-t0:.1f}s",
          flush=True)
    r.step(max(2, r.frame_batch))
    float(r.image().max())
    print(f"[warmup] batched step at {time.time()-t0:.1f}s", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m volumerenderer_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn in (("render", _cmd_render), ("view", _cmd_view),
                     ("bench", _cmd_bench), ("warmup", _cmd_warmup)):
        p = sub.add_parser(name)
        p.set_defaults(fn=fn)
        p.add_argument("--device", default="cuda",
                       help='torch device (default "cuda"; "cpu" for tests)')
        if name != "bench":
            p.add_argument("--volume", default="",
                           help=".vdb/.nvdb/.npy/.npz (default: procedural "
                                "cloud)")
            p.add_argument("--size", type=int, default=512)
            p.add_argument("--algorithm", default="RAY",
                           choices=["BEAM", "RAY", "POINT", "SPHERE", "PATH"])
            p.add_argument("--fast", default="off",
                           choices=["off", "paired", "decimated"],
                           help="performance tier")
        if name == "render":
            p.add_argument("--frames", type=int, default=16)
            p.add_argument("--out", default="render.png")
        if name == "view":
            p.add_argument("--motion", default="coarse",
                           choices=["off", "coarse", "truncated"],
                           help="mid-drag preview mode")
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
