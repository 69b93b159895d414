"""HandDetector: 21-keypoint hand inference (port of
``tpupose/detectors/hand.py``).

``detector(hand_img, hand_type="right") -> list of 21 [x, y, conf] or
None``.  Left hands are detected by mirroring the input (a numpy flip) and
un-mirroring the heatmaps on the device; the pipeline lives in
``CropKeypointDetector``.  The port runs float32 or, after ``quantize()``,
int8; bfloat16 is ROADMAP item 1.25.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpupose_torch.config import HAND, HandConfig
from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector


class HandDetector(CropKeypointDetector):
    def __init__(self, arch: str = "handnet",
                 weights_file: Optional[str] = None,
                 params=None,
                 cfg: HandConfig = HAND,
                 device="cuda",
                 seed: int = 0,
                 tail_stride: int = 1):
        super().__init__(arch, cfg, weights_file=weights_file,
                         params=params, device=device, seed=seed,
                         tail_stride=tail_stride)

    def __call__(self, hand_img: np.ndarray, hand_type: str = "right"):
        return self.detect_crop(hand_img, flip=(hand_type == "left"))

    def detect_batch(self, hand_imgs, hand_types):
        """All hand crops through one batched forward (left hands mirrored
        on input, their heatmaps un-mirrored in the per-crop tail)."""
        return self.detect_crops(
            hand_imgs, [t == "left" for t in hand_types])


def _main(argv=None):
    """``python -m tpupose_torch.detectors.hand handnet <npz> --img
    hand.png [--hand-type left] [--device cpu]``"""
    import argparse

    import cv2

    from tpupose_torch.detectors.draw import draw_hand_keypoints

    p = argparse.ArgumentParser(description="Hand detector")
    p.add_argument("arch", choices=("handnet",))
    p.add_argument("weights", help="weights file path (.npz)")
    p.add_argument("--img", required=True)
    p.add_argument("--hand-type", default="right", choices=("left", "right"))
    p.add_argument("--out", default="result.png")
    p.add_argument("--device", default="cuda", help="torch device")
    args = p.parse_args(argv)

    detector = HandDetector(args.arch, weights_file=args.weights,
                            device=args.device)
    img = cv2.imread(args.img)
    if img is None:
        raise FileNotFoundError(args.img)
    keypoints = detector(img, hand_type=args.hand_type)
    print(f"Saving result into {args.out}...")
    cv2.imwrite(args.out, draw_hand_keypoints(img, keypoints, (0, 0)))


if __name__ == "__main__":
    _main()
