"""Command-line interface: encode / decode / eval / sweep / compare.

    python -m roibasedimagecompression_torch encode IN.png OUT.rhccq [--roi-quality 20]
    python -m roibasedimagecompression_torch decode IN.rhccq OUT.png
    python -m roibasedimagecompression_torch eval ORIG.png FILE.rhccq [--adaptive]
    python -m roibasedimagecompression_torch sweep IMAGES_ROOT [--csv out.csv]
    python -m roibasedimagecompression_torch compare ORIG.png FILE.rhccq [--html out.html]

The JAX package's CLI, flag for flag, plus `--device` (default `cuda`; `cpu`
runs on the CPU) on every subcommand that computes on a device.  Without a
card `--device cuda` raises: nothing slides to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _prewarm_async(device):
    """Start building `_build/` (both kernels and the native runtime) on a
    thread while the encode reads its input: the port's one first-use cost
    (`utils/warmup.py`).  CUDA only; RHCCQ_NO_PREWARM skips it.  Returns the
    future, or None; a failed build raises from it, and the encode that
    loads the kernel raises as well."""
    import os

    if os.environ.get("RHCCQ_NO_PREWARM") or device is None or not str(device).startswith("cuda"):
        return None
    from roibasedimagecompression_torch.utils import warmup

    return warmup.prewarm(device=device)


def _cmd_encode(args):
    import numpy as np

    from roibasedimagecompression_torch import CodecConfig, encode
    from roibasedimagecompression_torch.io import image_io
    from roibasedimagecompression_torch.models.enhance import enhance_shadows

    warm = _prewarm_async(args.device)
    img = image_io.imread_rgb(args.input)
    if args.enhance_shadows:
        img = enhance_shadows(img, device=args.device)
    extra = {}
    if args.palette_refine is not None:
        extra["palette_refine_iters"] = args.palette_refine
    cfg = CodecConfig(
        roi_quality=args.roi_quality,
        nonroi_quality=args.nonroi_quality,
        single_region=args.single_region,
        split_method=args.split_method,
        split_margin=args.split_margin,
        container_level=args.container_level,
        **extra,
    )
    t0 = time.perf_counter()
    data = encode(np.asarray(img), cfg, device=args.device)
    dt = time.perf_counter() - t0
    if warm is not None:
        warm.result()
    with open(args.output, "wb") as f:
        f.write(data)
    pixels = img.shape[0] * img.shape[1]
    raw = pixels * 3
    print(
        f"{args.output}: {len(data):,} bytes "
        f"({raw / len(data):.2f}:1, {len(data) * 8 / pixels:.2f} bpp) "
        f"in {dt:.1f}s ({pixels / 1e6 / dt:.3f} MP/s)"
    )


def _cmd_decode(args):
    from roibasedimagecompression_torch import decode
    from roibasedimagecompression_torch.io import image_io

    rgb = decode(args.input)
    image_io.imwrite(args.output, rgb)
    print(f"{args.output}: {rgb.shape[1]}x{rgb.shape[0]}")


def _cmd_eval(args):
    from roibasedimagecompression_torch.eval import harness

    res = harness.evaluate_pair(args.original, args.compressed, device=args.device)
    out = res.as_dict()
    if args.adaptive:
        from roibasedimagecompression_torch.eval import adaptive as A
        from roibasedimagecompression_torch.io import container, image_io

        orig = image_io.imread_rgb(args.original)
        metrics = A.adaptive_quality_metrics(
            orig, container.decode_file(args.compressed), device=args.device
        )
        out["adaptive"] = metrics
        print(A.format_adaptive_report(metrics, orig.shape), file=sys.stderr)
    print(json.dumps(out, indent=2, default=float))


def _cmd_sweep(args):
    from roibasedimagecompression_torch.eval import report

    result = report.run_batch_evaluation(
        args.images_root, csv_path=args.csv, plot_path=args.plot, device=args.device
    )
    print(report.format_summary_report(result["summary"]))


def _cmd_compare(args):
    import os
    import tempfile

    from roibasedimagecompression_torch.eval import report

    jpg = args.jpeg
    if jpg is None:
        jpg = os.path.join(tempfile.mkdtemp(), "baseline.jpg")
        report.compress_with_jpeg(args.original, jpg, quality=args.jpeg_quality)
    row = report.three_way_comparison(args.original, jpg, args.compressed, device=args.device)
    print(json.dumps(row, indent=2, default=float))
    if args.html:
        report.html_report([row], args.html)
        print(f"wrote {args.html}")
    if args.panels:
        from roibasedimagecompression_torch.io import container, image_io

        report.comparison_figure(
            image_io.imread_rgb(args.original),
            container.decode_file(args.compressed),
            args.panels,
            device=args.device,
        )
        print(f"wrote {args.panels}")


def _add_device(p) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="torch device to compute on (default cuda; cpu runs on the CPU)",
    )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="roibasedimagecompression_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("encode", help="PNG/JPEG -> .rhccq")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--roi-quality", type=float, default=20.0)
    p.add_argument("--nonroi-quality", type=float, default=10.0)
    p.add_argument("--single-region", action="store_true")
    p.add_argument("--enhance-shadows", action="store_true")
    p.add_argument(
        "--split-method", default="hybrid",
        choices=["kmeans", "kmeans-mc", "hybrid", "mediancut"],
        help="oversized-cluster split: hybrid (default — k-means above 64 "
        "colors, host median cut below; R-D equal to kmeans on the full "
        "Kodak-24 at 2.2x the encode speed), kmeans (the reference's "
        "recursive-split law, all clusters on device), kmeans-mc "
        "(stratified init), mediancut (fastest, lower-rate R-D point; "
        "see RD_SPLIT_METHODS.json)",
    )
    p.add_argument(
        "--split-margin", type=float, default=2.0,
        help="over-provision the split cluster count by this factor (MAX-law "
        "compliant; >1 improves R-D and cuts split recursion depth — see "
        "RD_SPLIT_METHODS.json)",
    )
    p.add_argument(
        "--container-level", type=int, default=10,
        help="entropy stage: 0 = byte-compat zlib-9, 1-12 = libdeflate "
        "(7 is ~5x faster than 10 at +5%% size)",
    )
    p.add_argument(
        "--palette-refine", type=int, default=None, metavar="ITERS",
        help="global palette refinement iterations (Lloyd on the final "
        "palette against the tier-1 color table; omit to use the config "
        "default — see RD_REFINE.json)",
    )
    _add_device(p)
    p.set_defaults(fn=_cmd_encode)

    p = sub.add_parser("decode", help=".rhccq -> image file")
    p.add_argument("input")
    p.add_argument("output")
    p.set_defaults(fn=_cmd_decode)

    p = sub.add_parser("eval", help="quality metrics for one pair")
    p.add_argument("original")
    p.add_argument("compressed")
    p.add_argument("--adaptive", action="store_true")
    _add_device(p)
    p.set_defaults(fn=_cmd_eval)

    p = sub.add_parser("sweep", help="batch Kodak evaluation")
    p.add_argument("images_root")
    p.add_argument("--csv")
    p.add_argument("--plot")
    _add_device(p)
    p.set_defaults(fn=_cmd_sweep)

    p = sub.add_parser("compare", help="3-way PNG vs JPEG vs RHCCQ")
    p.add_argument("original")
    p.add_argument("compressed")
    p.add_argument("--jpeg")
    p.add_argument("--jpeg-quality", type=int, default=85)
    p.add_argument("--html")
    p.add_argument("--panels", help="write the 12-panel comparison figure PNG")
    _add_device(p)
    p.set_defaults(fn=_cmd_compare)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
