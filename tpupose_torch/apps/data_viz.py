"""Data-pipeline visual check: GT PAF, heatmap and mask overlays (port of
``tpupose/apps/data_viz.py``, the reference data loader's eyeball loop).

Writes ``<out>/sample_<i>.png`` side-by-side panels (raw | PAF hue wheel +
heatmap colormap + ignore mask), or shows them with ``--show``, with the GT
maps from the renderers the trainer uses (``tpupose_torch.data.gt``, on the
CPU here).  cv2 is imported when it runs.

Usage:
  python -m tpupose_torch.apps.data_viz --coco_dir coco --out viz [--n 8]
      [--insize 368] [--split train] [--show]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def overlay_pafs(img: np.ndarray, pafs: np.ndarray) -> np.ndarray:
    """PAF field as hue (direction) / saturation+value (magnitude), mixed
    per-pixel across limbs."""
    import cv2

    paf_xy = pafs.reshape(-1, 2, *pafs.shape[1:])   # (L, 2, H, W)
    nonzero = (paf_xy != 0).any(axis=1)             # (L, H, W)
    counts = np.maximum(nonzero.sum(axis=0), 1)
    mix = paf_xy.sum(axis=0) / counts               # (2, H, W)
    hue = (np.arctan2(mix[1], mix[0]) / np.pi) / -2 + 0.5
    sat = np.minimum(np.hypot(mix[0], mix[1]), 1.0)
    hsv = np.stack([hue * 180, sat * 255, sat * 255],
                   axis=-1).astype(np.uint8)
    rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR)
    return cv2.addWeighted(img, 0.6, rgb, 0.4, 0)


def overlay_heatmap(img: np.ndarray, heatmap: np.ndarray) -> np.ndarray:
    """Max-combined joint heatmap under a JET colormap."""
    import cv2

    colored = cv2.applyColorMap(
        np.clip(heatmap * 255, 0, 255).astype(np.uint8), cv2.COLORMAP_JET)
    return cv2.addWeighted(img, 0.6, colored, 0.4, 0)


def overlay_ignore_mask(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Black out ignored regions."""
    return img * (~mask).astype(np.uint8)[:, :, None]


def render_panel(img, poses, ignore_mask, cfg):
    """One sample -> side-by-side (raw | paf+heatmap+mask overlay)."""
    import torch

    from tpupose_torch.data.gt import render_labels

    h, w = img.shape[:2]
    pafs, heatmaps = render_labels(
        torch.from_numpy(np.asarray(poses, np.float32)), h, w,
        cfg.heatmap_sigma, cfg.paf_sigma)
    pafs = pafs.numpy()
    heatmaps = heatmaps.numpy()

    shown = img.copy()
    shown = overlay_pafs(shown, pafs)
    shown = overlay_heatmap(shown, heatmaps[:-1].max(axis=0))
    shown = overlay_ignore_mask(shown, ignore_mask)
    return np.hstack([img, shown])


def main(argv=None):
    import cv2

    from tpupose_torch.config import TrainConfig
    from tpupose_torch.data import CocoPoseDataset

    p = argparse.ArgumentParser(description="GT label visual check")
    p.add_argument("--coco_dir", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", default="viz")
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--insize", type=int, default=368)
    p.add_argument("--show", action="store_true",
                   help="interactive window instead of files")
    args = p.parse_args(argv)

    cfg = TrainConfig(insize=args.insize)
    ds = CocoPoseDataset(
        os.path.join(args.coco_dir, "annotations",
                     f"person_keypoints_{args.split}2017.json"),
        os.path.join(args.coco_dir, f"{args.split}2017"),
        mask_dir=os.path.join(args.coco_dir,
                              f"ignore_mask_{args.split}2017"),
        mode="train", cfg=cfg)

    os.makedirs(args.out, exist_ok=True)
    for i in range(min(args.n, len(ds))):
        img, poses, mask = ds.sample(i)
        panel = render_panel(img, poses, mask, cfg)
        if args.show:
            cv2.imshow("w", panel)
            if cv2.waitKey(0) == ord("q"):
                break
        else:
            path = os.path.join(args.out, f"sample_{i}.png")
            cv2.imwrite(path, panel)
            print("wrote", path)


if __name__ == "__main__":
    main()
