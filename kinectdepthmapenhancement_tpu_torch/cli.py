"""Command-line interface: the reference's file-replay entry point
(main.cpp:139-201) and its evaluation main() (main.cpp:158-309), the
PyTorch counterpart of the JAX package's cli.py.

  python -m kinectdepthmapenhancement_tpu_torch enhance \\
      --depth experiment/depth.xml --color experiment/color.jpg \\
      --pipeline kde --out refined.xml [--ply cloud.ply] [--png depth.png] \\
      [--debug-dir dbg/] [--device cuda]

  python -m kinectdepthmapenhancement_tpu_torch evaluate out.txt [--full] \\
      [--tum DIR --frames N] [--grid RxC] [--methods input,jbf,kde] \\
      [--timing-iters N] [--figure cmp.png] [--device cuda]

`enhance` reads a cv::FileStorage XML depth ("depth" node, mm) and a colour
image, runs one pipeline (a compiled call, core/jit.py), writes the
refined depth back as FileStorage XML and optional PLY / PNG renders.
The work after the file reads is `enhance`, a function of arrays.
`evaluate` times every method on one frame and writes its mean 3-D error
against ground truth (utils/evaluate.py, the evaluation.txt layout): on
the 640x480 test scene, or with --tum on a TUM RGB-D sequence against the
pseudo-ground truth its depth frames fold to.  Both run on the card
unless --device says otherwise; without a card "cuda" raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch

from kinectdepthmapenhancement_tpu_torch.core import io, jit
from kinectdepthmapenhancement_tpu_torch.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu_torch.core.config import (
    GridParams,
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu_torch.core.device import resolve_device
from kinectdepthmapenhancement_tpu_torch.models import pipelines
from kinectdepthmapenhancement_tpu_torch.utils import visualize

PIPELINES = ("jbf", "mrf", "rgbf", "kde", "spdsp", "tof")


# the pipelines enhance runs, each a compiled call (core/jit.py) as the JAX
# package's cli.py:57-95 jits them
_COMPILED = {name: jit.jit(getattr(pipelines, f"{name}_pipeline")) for name in PIPELINES}


class Enhanced(NamedTuple):
    refined: np.ndarray   # f32 [H, W] mm
    points: torch.Tensor  # [H, W, 3] mm, on the device
    color: torch.Tensor   # u8 [H, W, 3], on the device


def enhance(depth: np.ndarray, color: np.ndarray, pipeline: str = "kde", *, device="cuda",
            debug_dir: Optional[str] = None) -> Enhanced:
    """Run `pipeline` on one frame: depth f32 [H, W] mm and color u8
    [H, W, 3] NumPy arrays.  Returns the refined depth (NumPy), the point
    map and colour on the device; debug_dir (kde only) receives the
    segmentation, label, normal and depth renders."""
    dev = resolve_device(device)
    h, w = depth.shape
    if color.shape[:2] != (h, w):
        raise ValueError(f"color {color.shape[:2]} != depth {(h, w)}")
    intr = default_kinect_intrinsics(w, h)
    d = torch.from_numpy(np.array(depth, dtype=np.float32)).to(dev)
    c = torch.from_numpy(np.array(color, dtype=np.uint8)).to(dev)
    if pipeline in ("jbf", "mrf"):
        refined = _COMPILED[pipeline](d, c)
        points = projective_to_real(refined, intr)
    elif pipeline == "rgbf":
        # the raw points are computed outside the call and passed in, as
        # the JAX CLI does
        refined = _COMPILED["rgbf"](d, projective_to_real(d, intr), c,
                                    RGBFConfig()).refined_depth
        points = projective_to_real(refined, intr)
    elif pipeline == "kde":
        cfg = KDEConfig()
        res = _COMPILED["kde"](d, c, intr, cfg)
        points = res.optimized_points
        refined = points[..., 2]
        if debug_dir:
            written = visualize.dump_kde_debug(debug_dir, res, c, cfg.grid.num_clusters)
            print(f"wrote {len(written)} debug renders to {debug_dir}")
    elif pipeline == "spdsp":
        points = _COMPILED["spdsp"](d, projective_to_real(d, intr), c, intr,
                                    SPDSPConfig()).optimized_points
        refined = points[..., 2]
    elif pipeline == "tof":
        points = _COMPILED["tof"](d, projective_to_real(d, intr), c, intr,
                                  TOFConfig()).plane_fitted
        refined = points[..., 2]
    else:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    return Enhanced(refined=refined.cpu().numpy(), points=points, color=c)


def _cmd_enhance(args: argparse.Namespace) -> int:
    color = io.imread_rgb(args.color)
    mats = io.read_filestorage_xml(args.depth)
    if args.depth_node not in mats:
        raise SystemExit(f"node {args.depth_node!r} not in {args.depth} (has {list(mats)})")
    depth = mats[args.depth_node].astype(np.float32)
    if color.shape[:2] != depth.shape:
        raise SystemExit(f"color {color.shape[:2]} != depth {depth.shape}")
    out = enhance(depth, color, args.pipeline, device=args.device, debug_dir=args.debug_dir)
    io.write_filestorage_xml(args.out, {"depth": out.refined})
    print(f"wrote {args.out}")
    if args.ply:
        cloud = visualize.point_cloud(out.points, out.color)
        visualize.save_ply(args.ply, cloud)
        print(f"wrote {args.ply} ({cloud.shape[0]} points)")
    if args.png:
        visualize.save_png(args.png, visualize.depth_rgb(torch.from_numpy(out.refined)))
        print(f"wrote {args.png}")
    return 0


def _cmd_evaluate(args: argparse.Namespace) -> int:
    from kinectdepthmapenhancement_tpu_torch.utils import evaluate

    grid = None
    if args.grid:
        rows, cols = (int(t) for t in args.grid.lower().split("x"))
        grid = GridParams(rows=rows, cols=cols)
    methods = args.methods.split(",") if args.methods else None
    kw = dict(include_sp_methods=args.full, grid=grid, timing_iters=args.timing_iters,
              methods=methods, figure_path=args.figure, device=args.device)
    if args.tum:
        results = evaluate.evaluate_tum(args.tum, frames=args.frames, **kw)
        print(evaluate.write_report(args.out, results))
    else:
        if args.frames != 30:
            print("warning: --frames only applies with --tum; ignored", file=sys.stderr)
        evaluate.main(args.out, **kw)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    print(f"runtimes measured on {where}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kinectdepthmapenhancement_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    en = sub.add_parser("enhance", help="run one pipeline on a depth+color frame")
    en.add_argument("--depth", required=True, help="cv::FileStorage XML depth file")
    en.add_argument("--depth-node", default="depth", help="matrix node name")
    en.add_argument("--color", required=True, help="color image (jpg/png)")
    en.add_argument("--pipeline", default="kde", choices=PIPELINES)
    en.add_argument("--out", required=True, help="output FileStorage XML path")
    en.add_argument("--ply", help="optional point-cloud PLY output")
    en.add_argument("--png", help="optional depth render PNG output")
    en.add_argument(
        "--debug-dir",
        help="write the segmentation/labelImage/normals/depth renders (KDE only; "
        "the reference's always-on imwrite hooks, KinectDepthEnhancement.cpp:69,77)",
    )
    en.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    en.set_defaults(fn=_cmd_enhance)

    ev = sub.add_parser("evaluate", help="timing + accuracy harness (evaluation.txt)")
    ev.add_argument("out", help="output text file")
    ev.add_argument("--full", action="store_true", help="include SPDSP/TOF")
    ev.add_argument(
        "--tum",
        help="TUM RGB-D sequence dir: evaluate a real frame against the "
        "temporally-accumulated pseudo-GT (capture protocol, main.cpp:86-116)",
    )
    ev.add_argument("--frames", type=int, default=30,
                    help="frames folded into the pseudo-GT accumulator (with --tum)")
    ev.add_argument("--grid", help="superpixel grid ROWSxCOLS override, e.g. 3x4")
    ev.add_argument("--methods", help="comma-separated subset to run, e.g. input,jbf,kde")
    ev.add_argument("--timing-iters", type=int, default=5, help="timed repetitions per method")
    ev.add_argument(
        "--figure",
        help="write a side-by-side comparison PNG (input / GT / each method's depth "
        "render, the reference's PCL 6-viewport view, main.cpp:362-413)",
    )
    ev.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    ev.set_defaults(fn=_cmd_evaluate)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
