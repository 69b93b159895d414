"""FaceDetector: 70-keypoint face inference (port of
``tpupose/detectors/face.py``).

``detector(face_img) -> list of 70 [x, y, conf] or None`` in crop pixels;
the pipeline lives in ``CropKeypointDetector``.  The port runs float32 or,
after ``quantize()``, int8; bfloat16 is ROADMAP item 1.25.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tpupose_torch.config import FACE, FaceConfig
from tpupose_torch.detectors.crop_keypoints import CropKeypointDetector


class FaceDetector(CropKeypointDetector):
    def __init__(self, arch: str = "facenet",
                 weights_file: Optional[str] = None,
                 params=None,
                 cfg: FaceConfig = FACE,
                 device="cuda",
                 seed: int = 0,
                 tail_stride: int = 1):
        super().__init__(arch, cfg, weights_file=weights_file,
                         params=params, device=device, seed=seed,
                         tail_stride=tail_stride)

    def __call__(self, face_img: np.ndarray):
        return self.detect_crop(face_img)

    def detect_batch(self, face_imgs):
        """All persons' face crops through one batched forward."""
        return self.detect_crops(face_imgs)


def _main(argv=None):
    """``python -m tpupose_torch.detectors.face facenet <npz> --img
    face.png [--device cpu]``"""
    import argparse

    import cv2

    from tpupose_torch.detectors.draw import draw_face_keypoints

    p = argparse.ArgumentParser(description="Face detector")
    p.add_argument("arch", choices=("facenet",))
    p.add_argument("weights", help="weights file path (.npz)")
    p.add_argument("--img", required=True)
    p.add_argument("--out", default="result.png")
    p.add_argument("--device", default="cuda", help="torch device")
    args = p.parse_args(argv)

    detector = FaceDetector(args.arch, weights_file=args.weights,
                            device=args.device)
    img = cv2.imread(args.img)
    if img is None:
        raise FileNotFoundError(args.img)
    keypoints = detector(img)
    print(f"Saving result into {args.out}...")
    cv2.imwrite(args.out, draw_face_keypoints(img, keypoints, (0, 0)))


if __name__ == "__main__":
    _main()
