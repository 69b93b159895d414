"""COCO val keypoint-AP evaluation harness (port of
``tpupose/apps/evaluate.py``).

Runs a pose detector over the eval-mode dataset and scores it with the OKS
evaluator of ``tpupose_torch/evaluation.py``, the measure of ``BASELINE.md``'s
accuracy target (COCO val2017 AP within 0.5 of the reference).

Usage:
  python -m tpupose_torch.apps.evaluate --coco_dir /data/coco \\
      --weights coco_posenet.npz [--precise] [--bucketed] [--quant] \\
      [--n_samples 100] [--out eval.json] [--device cuda]

``--bucketed`` runs every image on a fixed canvas palette
(``detectors/bucketed.py``).  ``--quant`` switches the detector to w8a8
int8 (``quant.py``), calibrated on the first eval image and its mirror.
"""

from __future__ import annotations

import argparse
import json
import time


def evaluate_detector(detector, dataset, limit=None, verbose=True,
                      pipeline_depth: int = 2):
    """Run ``detector`` over ``dataset`` (anything with ``len`` and
    ``eval_sample(i) -> (img, gts, img_id)``); returns (metrics, results
    list).

    Keeps ``pipeline_depth`` frames in flight through the detector's
    ``submit`` / ``collect``, so one frame's host work (the next frame's
    load and resize, this one's OKS scoring) overlaps the device work of
    those queued; ``pipeline_depth=0`` runs ``detector(img)`` frame by
    frame.  The metrics do not depend on the depth."""
    from tpupose_torch.evaluation import KeypointEvaluator, poses_to_results

    evaluator = KeypointEvaluator()
    results = []
    n = len(dataset) if limit is None else min(limit, len(dataset))
    t0 = time.perf_counter()

    can_pipeline = pipeline_depth > 0 and hasattr(detector, "submit")
    pending = []        # [(handle, gts, img_id)]

    def score(poses, scores, gts, img_id):
        dts = poses_to_results(poses, scores, img_id)
        results.extend(dts)
        evaluator.add_image(dts, gts)

    def drain_one():
        handle, gts, img_id = pending.pop(0)
        score(*detector.collect(handle), gts, img_id)

    done = 0
    for i in range(n):
        img, gts, img_id = dataset.eval_sample(i)
        if can_pipeline:
            pending.append((detector.submit(img), gts, img_id))
            if len(pending) > pipeline_depth:
                drain_one()
                done += 1
        else:
            score(*detector(img), gts, img_id)
            done += 1
        if verbose and done and done % 20 == 0:
            dt = time.perf_counter() - t0
            print(f"  [{done}/{n}] {dt / done:.2f}s/img")
    while pending:
        drain_one()
    metrics = evaluator.summarize()
    metrics["images"] = n
    metrics["seconds_per_image"] = (time.perf_counter() - t0) / max(n, 1)
    return metrics, results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="COCO keypoint AP evaluation")
    p.add_argument("--coco_dir", required=True)
    p.add_argument("--split", default="val2017")
    p.add_argument("--weights", help="coco_posenet.npz")
    p.add_argument("--precise", action="store_true")
    p.add_argument("--n_samples", type=int, default=None)
    p.add_argument("--bucketed", action="store_true",
                   help="run every image on a fixed canvas palette "
                        "(detectors/bucketed.py)")
    p.add_argument("--canvas_long", type=int, default=640,
                   help="bucketed canvas long side (COCO max side)")
    p.add_argument("--quant", action="store_true",
                   help="w8a8 int8 inference (tpupose_torch/quant.py), "
                        "calibrated on the first eval image and its mirror")
    p.add_argument("--out", help="write metrics + results JSON here")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None):
    import os

    from tpupose_torch.data import CocoPoseDataset
    from tpupose_torch.detectors import PoseDetector

    args = parse_args(argv)
    ann = os.path.join(
        args.coco_dir, "annotations",
        f"person_keypoints_{args.split}.json")
    dataset = CocoPoseDataset(
        ann, os.path.join(args.coco_dir, args.split), mode="eval",
        n_samples=args.n_samples)
    detector = PoseDetector("posenet", weights_file=args.weights,
                            precise=args.precise, device=args.device)
    if args.quant:
        first = dataset.eval_sample(0)[0]
        detector.quantize([first, first[:, ::-1]])
    if args.bucketed:
        from tpupose_torch.detectors.bucketed import (BucketedPoseDetector,
                                                      canvas_palette)

        detector = BucketedPoseDetector(
            detector, canvases=canvas_palette(args.canvas_long))

    metrics, results = evaluate_detector(detector, dataset)
    for k, v in metrics.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"metrics": metrics, "results": results}, f)
    return metrics


if __name__ == "__main__":
    main()
