"""Demo cascade: pose -> per-person face and hand keypoints -> overlay
(port of ``tpupose/apps/demo.py``).

For each detected person the anthropometric face and hand crops are cut
(``detectors/crops.py``), and every face crop goes through one batched
FaceNet forward, every hand crop through one batched HandNet forward.
``cascade_results`` is the detection alone and needs no cv2;
``run_cascade`` draws its results.

Usage:
  python -m tpupose_torch.apps.demo --img photo.png \\
      [--pose-weights coco_posenet.npz --face-weights facenet.npz \\
       --hand-weights handnet.npz] [--precise] [--quant] [--out result.png]
"""

from __future__ import annotations

import argparse


def cascade_results(img, pose_detector, face_detector, hand_detector,
                    on_crops=None):
    """The cascade's detections on one BGR image: ``{"poses", "scores",
    "faces": [(keypoints, bbox)], "hands": [(side, keypoints, bbox)]}``.

    ``on_crops(face_crops, hand_crops)``: an optional hook called after the
    crops are cut and before the crop nets run (``--quant`` calibrates the
    crop nets on these crops there)."""
    from tpupose_torch.detectors.crops import (crop_face, crop_hands,
                                               get_unit_length)

    poses, scores = pose_detector(img)
    results = {"poses": poses, "scores": scores, "faces": [], "hands": []}

    # Every person's crops first, then one batched forward per net.
    face_crops, face_bboxes = [], []
    hand_crops, hand_sides, hand_bboxes = [], [], []
    for person_pose in poses:
        unit_length = get_unit_length(person_pose)
        cropped_face, bbox = crop_face(img, person_pose, unit_length)
        if cropped_face is not None:
            face_crops.append(cropped_face)
            face_bboxes.append(bbox)
        hands = crop_hands(img, person_pose, unit_length)
        for side in ("left", "right"):
            if hands[side] is not None:
                hand_crops.append(hands[side]["img"])
                hand_sides.append(side)
                hand_bboxes.append(hands[side]["bbox"])

    if on_crops is not None:
        on_crops(face_crops, hand_crops)

    for face_keypoints, bbox in zip(face_detector.detect_batch(face_crops),
                                    face_bboxes):
        results["faces"].append((face_keypoints, bbox))
    for hand_keypoints, side, bbox in zip(
            hand_detector.detect_batch(hand_crops, hand_sides),
            hand_sides, hand_bboxes):
        results["hands"].append((side, hand_keypoints, bbox))
    return results


def run_cascade(img, pose_detector, face_detector, hand_detector,
                on_crops=None):
    """The full cascade on one BGR image: ``(result_img, results)``, the
    results of ``cascade_results`` drawn over the image."""
    import cv2

    from tpupose_torch.detectors.draw import (draw_face_keypoints,
                                              draw_hand_keypoints,
                                              draw_person_pose)

    results = cascade_results(img, pose_detector, face_detector,
                              hand_detector, on_crops=on_crops)
    res_img = cv2.addWeighted(img, 0.6,
                              draw_person_pose(img, results["poses"]), 0.4, 0)
    for face_keypoints, bbox in results["faces"]:
        res_img = draw_face_keypoints(res_img, face_keypoints,
                                      (bbox[0], bbox[1]))
        cv2.rectangle(res_img, (bbox[0], bbox[1]), (bbox[2], bbox[3]),
                      (255, 255, 255), 1)
    for _side, hand_keypoints, bbox in results["hands"]:
        res_img = draw_hand_keypoints(res_img, hand_keypoints,
                                      (bbox[0], bbox[1]))
        cv2.rectangle(res_img, (bbox[0], bbox[1]), (bbox[2], bbox[3]),
                      (255, 255, 255), 1)
    return res_img, results


def main(argv=None):
    p = argparse.ArgumentParser(description="Pose+face+hand demo cascade")
    p.add_argument("--img", required=True, help="input image path")
    p.add_argument("--out", default="result.png")
    p.add_argument("--pose-weights", help="coco_posenet.npz")
    p.add_argument("--face-weights", help="facenet.npz")
    p.add_argument("--hand-weights", help="handnet.npz")
    p.add_argument("--precise", action="store_true",
                   help="multi-scale pose inference")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 network compute (not ported: ROADMAP.md "
                        "Queue 1 item 1.25)")
    p.add_argument("--nms-mode", choices=("scipy", "conv"), default="scipy",
                   help="peak NMS semantics: 'scipy' (reflect-boundary "
                        "Gaussian, strict > rule); 'conv' is not ported "
                        "(ROADMAP.md Queue 1 item 1.18)")
    p.add_argument("--tail-stride", type=int, default=16,
                   help="round face/hand tail-resize targets up to this "
                        "multiple (<= ~1 px keypoint shift); 1 = exact "
                        "per-crop semantics")
    p.add_argument("--quant", action="store_true",
                   help="w8a8 int8 inference for all three nets "
                        "(tpupose_torch/quant.py); the pose net calibrates "
                        "on the input image, the crop nets on the face and "
                        "hand crops the cascade cuts")
    p.add_argument("--device", default="cuda", help="torch device")
    args = p.parse_args(argv)
    if args.bf16:
        raise NotImplementedError(
            "--bf16: bfloat16 compute is not ported yet (ROADMAP.md, Queue 1 "
            "item 1.25)")
    if args.nms_mode == "conv":
        raise NotImplementedError(
            "--nms-mode conv is not ported yet (ROADMAP.md, Queue 1 item "
            "1.18)")

    import cv2

    from tpupose_torch.detectors import (FaceDetector, HandDetector,
                                         PoseDetector)

    pose_detector = PoseDetector("posenet", weights_file=args.pose_weights,
                                 precise=args.precise, device=args.device)
    face_detector = FaceDetector("facenet", weights_file=args.face_weights,
                                 device=args.device,
                                 tail_stride=args.tail_stride)
    hand_detector = HandDetector("handnet", weights_file=args.hand_weights,
                                 device=args.device,
                                 tail_stride=args.tail_stride)

    img = cv2.imread(args.img)
    if img is None:
        raise FileNotFoundError(args.img)

    on_crops = None
    if args.quant:
        # pose net: calibrate on the frame being served and its mirror;
        # crop nets: on the face and hand crops the cascade cuts (up to 4
        # and their mirrors), or the frame when a net gets no crops
        pose_detector.quantize([img, img[:, ::-1]])

        def on_crops(face_crops, hand_crops):
            def calib(crops):
                out = []
                for c in crops[:4]:
                    out += [c, c[:, ::-1]]
                return out or [img, img[:, ::-1]]

            face_detector.quantize(calib(face_crops))
            hand_detector.quantize(calib(hand_crops))

    print("Estimating pose...")
    res_img, results = run_cascade(
        img, pose_detector, face_detector, hand_detector,
        on_crops=on_crops)
    n = len(results["poses"])
    print(f"{n} people, {len(results['faces'])} faces, "
          f"{len(results['hands'])} hands")
    print(f"Saving result into {args.out}...")
    cv2.imwrite(args.out, res_img)


if __name__ == "__main__":
    main()
