"""Export a serving bundle (pose fast/precise path, or a crop net) with
``torch.export`` (port of ``tpupose/apps/export_serving.py``).

Usage::

    # pose net: one program per original image size
    python -m tpupose_torch.apps.export_serving coco_posenet.npz bundle/ \\
        --sizes 480x640,584x584 [--precise] [--platforms cpu,cuda]

    # face/hand crop nets: batched forward + per-crop-geometry tails
    python -m tpupose_torch.apps.export_serving facenet.npz face_bundle/ \\
        --arch facenet --sizes 368x368,184x184 --batches 1,4,8

Bundles (programs + weights + config) are served by
``tpupose_torch.serving.ServingPoseDetector`` / ``ServingCropDetector``
and by ``python -m tpupose_torch.apps.serve <bundle> --device cuda``.
CUDA programs are traced on CUDA: export them where the card is.
"""

from __future__ import annotations

import argparse


def parse_sizes(text: str):
    out = []
    for part in text.split(","):
        h, w = part.lower().split("x")
        out.append((int(h), int(w)))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("weights", help="npz weights (Chainer-npz interchange)")
    p.add_argument("out", help="bundle directory to create")
    p.add_argument("--arch", default="posenet",
                   choices=["posenet", "facenet", "handnet"])
    p.add_argument("--sizes", required=True,
                   help="comma-separated HxW sizes to export programs "
                        "for: original image sizes (posenet), crop sizes "
                        "(facenet/handnet)")
    p.add_argument("--platforms", default="cpu,cuda",
                   help="platforms whose programs the bundle holds")
    p.add_argument("--device", default="cuda",
                   help="torch device of the detector that is exported "
                        "(and calibrated, with --quant)")
    p.add_argument("--img-size", type=int, default=None,
                   help="network input target (config img_size)")
    p.add_argument("--heatmap-size", type=int, default=None,
                   help="postprocess map target "
                        "(InferenceConfig.heatmap_size; posenet only)")
    p.add_argument("--precise", action="store_true",
                   help="posenet: export the multi-scale precise pipeline "
                        "instead of the fast path")
    p.add_argument("--batches", default="1,4,8",
                   help="crop nets: batched-forward sizes to export")
    p.add_argument("--pose-batches", default="",
                   help="posenet: comma list of batch sizes to ALSO "
                        "export batched programs for, enabling "
                        "ServingPoseDetector.detect_batch (empty = "
                        "single-frame programs only)")
    p.add_argument("--tail-stride", type=int, default=8,
                   help="crop nets: tail-geometry rounding (see "
                        "CropKeypointDetector)")
    p.add_argument("--quant", action="store_true",
                   help="export a w8a8 int8 bundle (tpupose_torch/quant.py)"
                        ": the detector is quantized before export, "
                        "calibrated on the --calib images (pose net: "
                        "serving frames; crop nets: face/hand crops)")
    p.add_argument("--quant-min-side", type=int, default=None,
                   help="--quant posenet: mixed precision, programs with "
                        "network inputs below this stay float32 (the "
                        "bundle then carries both trees); default 0, every "
                        "program int8")
    p.add_argument("--conv7-impl", choices=("kernel", "im2col"),
                   default=None,
                   help="--quant: route of the int8 layers that are not "
                        "heads, bit-equal either way: 'kernel' (the CUDA "
                        "kernels; the default on CUDA) or 'im2col' (im2col "
                        "+ _int_mm + the requant kernel; the default on "
                        "the CPU)")
    p.add_argument("--calib",
                   help="--quant: comma-separated image paths for "
                        "activation-range calibration (required with "
                        "--quant)")
    args = p.parse_args(argv)

    import dataclasses

    platforms = tuple(args.platforms.split(","))
    sizes = parse_sizes(args.sizes)

    calib_imgs = None
    if args.quant:
        import cv2

        if not args.calib:
            raise SystemExit("--quant requires --calib img1,img2,... "
                             "(serving-representative calibration images)")
        calib_imgs = []
        for path in args.calib.split(","):
            img = cv2.imread(path)
            if img is None:
                raise SystemExit(f"--calib: cannot read {path!r}")
            calib_imgs += [img, img[:, ::-1]]

    if args.arch == "posenet":
        from tpupose_torch.config import INFERENCE
        from tpupose_torch.detectors.pose import PoseDetector
        from tpupose_torch.serving import save_bundle

        cfg = INFERENCE
        overrides = {k: v for k, v in (("img_size", args.img_size),
                                       ("heatmap_size", args.heatmap_size))
                     if v is not None}
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        det = PoseDetector(args.arch, weights_file=args.weights, cfg=cfg,
                           precise=args.precise, device=args.device)
        if calib_imgs is not None:
            det.quantize(calib_imgs, min_side=args.quant_min_side,
                         conv7_impl=args.conv7_impl)
        pose_batches = tuple(int(b) for b in args.pose_batches.split(",")
                             if b.strip())
        save_bundle(det, args.out, sizes, platforms=platforms,
                    batch_sizes=pose_batches)
        mode = "precise" if args.precise else "fast"
    else:
        from tpupose_torch.config import FACE, HAND
        from tpupose_torch.detectors.crop_keypoints import \
            CropKeypointDetector
        from tpupose_torch.serving import save_crop_bundle

        cfg = FACE if args.arch == "facenet" else HAND
        if args.img_size is not None:
            cfg = dataclasses.replace(cfg, img_size=args.img_size)
        det = CropKeypointDetector(args.arch, cfg, weights_file=args.weights,
                                   device=args.device,
                                   tail_stride=args.tail_stride)
        if calib_imgs is not None:
            det.quantize(calib_imgs, conv7_impl=args.conv7_impl)
        batches = tuple(int(b) for b in args.batches.split(","))
        flips = (False, True) if args.arch == "handnet" else (False,)
        save_crop_bundle(det, args.out, sizes, batch_sizes=batches,
                         flips=flips, platforms=platforms)
        mode = "crop"
    if calib_imgs is not None:
        mode += "+w8a8"
    print(f"wrote bundle: {args.out} ({len(sizes)} geometries, "
          f"{mode} mode, platforms {args.platforms})")


if __name__ == "__main__":
    main()
