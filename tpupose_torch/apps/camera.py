"""Streaming camera / video apps: pose overlay and face-keypoint overlay
(port of ``tpupose/apps/camera.py``).

The pose loop is software-pipelined: the device computes frame N while the
host reads and draws frame N-1 (``PoseDetector.submit`` / ``collect``);
``--batch`` groups frames into one ``detect_batch`` (a partial tail batch
is padded with repeats of its last frame), on a ``--mesh`` of ranks too;
the face loop dispatches frame N's crops (``submit_crops``) before it
collects frame N-1's.  ``--video`` reads a file, ``--save`` writes the
result video.

The loops (``stream_pose``, ``stream_pose_batched``, ``stream_face``)
take the frame source, the drawing and the sink as arguments; cv2's
capture, writer, ``imshow``, ``addWeighted`` and Haar cascade are only the
defaults ``main()`` passes, imported inside functions, so the loops run
without cv2.

Usage:
  python -m tpupose_torch.apps.camera pose [--camera 0 | --video in.mp4]
      [--weights coco_posenet.npz] [--save out.mp4] [--headless]
      [--max-frames N] [--batch B] [--precise] [--bf16] [--quant]
      [--nms-mode scipy|conv] [--device cuda]
  python -m tpupose_torch.apps.camera face [--face-source haar|pose] ...
  torchrun --nproc_per_node 4 -m tpupose_torch.apps.camera pose \\
      --video in.mp4 --batch 8 --mesh 4x1 --headless --save out.mp4

On a mesh rank 0 reads each batch and broadcasts it, every rank runs
``detect_batch``, and only rank 0 draws and writes.
"""

from __future__ import annotations

import argparse
import itertools
import os
import time

import numpy as np


def _warn_if_random(weights, what: str) -> None:
    if not weights:
        print(f"WARNING: no weights given for {what} — running a "
              "randomly-initialized network (smoke-test mode, outputs "
              "are meaningless)", flush=True)


# ---------------------------------------------------------------------------
# cv2 defaults: the source, the drawing, the sink
# ---------------------------------------------------------------------------


def open_capture(args):
    import cv2

    if args.video:
        cap = cv2.VideoCapture(args.video)
    else:
        cap = cv2.VideoCapture(args.camera)
        cap.set(cv2.CAP_PROP_FRAME_WIDTH, 640)
        cap.set(cv2.CAP_PROP_FRAME_HEIGHT, 480)
    if not cap.isOpened():
        raise RuntimeError("failed to open video source")
    return cap


def source_fps(cap) -> float:
    """Source frame rate for the --save writer (30 when unreported)."""
    import cv2

    fps = cap.get(cv2.CAP_PROP_FPS)
    return float(fps) if fps and fps > 0 else 30.0


def capture_frames(cap, live: bool):
    """The capture's frames until it has none."""
    while True:
        ret, img = cap.read()
        if not ret:
            print("Failed to capture image" if live else "End of video")
            return
        yield img


class VideoSink:
    """``--save``'s video writer, opened at the first frame, and the
    ``imshow`` window unless ``--headless``."""

    def __init__(self, args, fps: float = 30.0):
        self.args = args
        self.fps = fps
        self.writer = None

    def __call__(self, img) -> None:
        import cv2

        if self.args.save and self.writer is None:
            self.writer = cv2.VideoWriter(
                self.args.save, cv2.VideoWriter_fourcc(*"mp4v"), self.fps,
                (img.shape[1], img.shape[0]))
        if self.writer is not None:
            self.writer.write(img)
        if not self.args.headless:
            cv2.imshow("result", img)
            cv2.waitKey(1)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.release()
            self.writer = None


def blend_pose(img, poses):
    """The poses drawn over ``img`` at 40% (the reference's overlay)."""
    import cv2

    from tpupose_torch.detectors import draw_person_pose

    return cv2.addWeighted(img, 0.6, draw_person_pose(img, poses), 0.4, 0)


def draw_faces(img, located, keypoints):
    """Each located crop's face keypoints drawn at its place in ``img``."""
    from tpupose_torch.detectors import draw_face_keypoints

    res = img.copy()
    for (_, left_top), kps in zip(located, keypoints):
        res = draw_face_keypoints(res, kps, left_top)
    return res


def haar_cascade_path() -> str:
    """Locate ``haarcascade_frontalface_alt.xml``: the port's copy in
    ``tpupose_torch/assets/`` first (headless OpenCV builds lack
    ``cv2.data.haarcascades``), then the cv2-installed one."""
    vendored = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "assets",
        "haarcascade_frontalface_alt.xml")
    if os.path.exists(vendored):
        return vendored
    import cv2

    data_dir = getattr(getattr(cv2, "data", None), "haarcascades", None)
    if data_dir:
        return os.path.join(data_dir, "haarcascade_frontalface_alt.xml")
    raise FileNotFoundError("haarcascade_frontalface_alt.xml not found "
                            "(the port's asset is missing and cv2.data "
                            "is absent)")


def haar_face_crops(cascade, img):
    """Haar rects -> [(crop, left_top)] (the reference's face demo)."""
    import cv2

    from tpupose_torch.detectors import crop_face_haar

    rects = cascade.detectMultiScale(
        cv2.cvtColor(img, cv2.COLOR_BGR2GRAY), scaleFactor=1.1,
        minNeighbors=5, minSize=(30, 30))
    return [crop_face_haar(img, rect) for rect in rects]


def pose_face_crops(pose_detector, img):
    """Pose-driven face regions: the demo cascade's nose-anchored crops
    (no Haar objdetect needed)."""
    from tpupose_torch.detectors import crop_face, get_unit_length

    poses, _ = pose_detector(img)
    crops = []
    for person_pose in poses:
        crop, bbox = crop_face(img, person_pose, get_unit_length(person_pose))
        if crop is not None:
            crops.append((crop, (bbox[0], bbox[1])))
    return crops


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


def _first(frames, max_frames: int):
    return itertools.islice(frames, max_frames) if max_frames else frames


def _maybe_quantize(detector, quant: bool, frame) -> None:
    """--quant: w8a8 int8 inference, calibrated on the first frame and its
    mirror."""
    if quant and not detector.quantized:
        detector.quantize([frame, frame[:, ::-1]])


def stream_pose(detector, frames, draw, emit, max_frames: int = 0,
                quant: bool = False) -> int:
    """Pipelined pose loop: frame N is submitted before frame N-1's
    result is collected, drawn (``draw(img, poses) -> img``) and emitted
    (``emit(img)``).  Returns the frames emitted."""
    pending = None
    n = 0
    for img in _first(frames, max_frames):
        _maybe_quantize(detector, quant, img)
        handle = detector.submit(img)
        if pending is not None:
            prev_handle, prev_img = pending
            poses, _ = detector.collect(prev_handle)
            emit(draw(prev_img, poses))
            n += 1
        pending = (handle, img)
    if pending is not None:
        handle, img = pending
        poses, _ = detector.collect(handle)
        emit(draw(img, poses))
        n += 1
    return n


def _broadcast_frames(group, mesh):
    """Rank 0's list of frames (None at the end) on every rank."""
    if mesh is None or not mesh.distributed:
        return group
    import torch.distributed as dist

    box = [group]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def stream_pose_batched(detector, frames, draw, emit, batch: int,
                        max_frames: int = 0, quant: bool = False,
                        mesh=None) -> int:
    """Batched pose loop: groups of ``batch`` frames through one
    ``detect_batch``; a partial tail batch is padded with repeats of its
    last frame, so every call has the full batch (and splits over a
    mesh's data axis).  On a ``mesh`` only rank 0 passes ``frames``,
    ``draw`` and ``emit`` (the others None): it reads each group and
    broadcasts it.  Returns the real frames processed."""
    source = iter(_first(frames, max_frames)) if frames is not None else None
    n = 0
    while True:
        group = (list(itertools.islice(source, batch))
                 if source is not None else None)
        group = _broadcast_frames(group, mesh)
        if not group:
            return n
        _maybe_quantize(detector, quant, group[0])
        padded = group + [group[-1]] * (batch - len(group))
        results = detector.detect_batch(np.stack(padded))[:len(group)]
        if emit is not None:
            for img, (poses, _) in zip(group, results):
                emit(draw(img, poses))
        n += len(group)
        if len(group) < batch:
            return n


def stream_face(detector, frames, find_crops, draw, emit,
                max_frames: int = 0, quant: bool = False) -> int:
    """Pipelined face loop: frame N's crops (``find_crops(img) ->
    [(crop, left_top)]``) go through one ``submit_crops`` before frame
    N-1's keypoints are collected, drawn (``draw(img, located, keypoints)
    -> img``) and emitted.  ``quant``: calibrate int8 on the first
    located crops and their mirrors.  Returns the frames emitted."""
    pending = None
    n = 0

    def finish(handle, img, located):
        emit(draw(img, located, detector.collect_crops(handle)))

    for img in _first(frames, max_frames):
        located = find_crops(img)
        crops = [c for c, _ in located]
        if quant and not detector.quantized and crops:
            calib = []
            for c in crops[:4]:
                calib += [c, c[:, ::-1]]
            detector.quantize(calib)
        handle = detector.submit_crops(crops)
        if pending is not None:
            finish(*pending)
            n += 1
        pending = (handle, img, located)
    if pending is not None:
        finish(*pending)
        n += 1
    return n


# ---------------------------------------------------------------------------
# the apps
# ---------------------------------------------------------------------------


def _compute_dtype(args):
    import torch

    return torch.bfloat16 if getattr(args, "bf16", False) else torch.float32


def _inference_cfg(args):
    import dataclasses

    from tpupose_torch.config import INFERENCE

    return dataclasses.replace(
        INFERENCE, nms_mode=getattr(args, "nms_mode", "scipy"))


def parse_mesh(spec: str, device):
    """'DATAxSPATIAL' (e.g. '4x2') -> the mesh of this process group
    (initialised from ``torchrun``'s variables when they are set);
    ``SystemExit`` for a bad spec or a grid the world does not fill."""
    import torch.distributed as dist

    from tpupose_torch.parallel import initialize_distributed, make_mesh

    try:
        n_data, n_spatial = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise SystemExit(f"--mesh expects DATAxSPATIAL (e.g. 4x2), "
                         f"got {spec!r}")
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        initialize_distributed(device=device)
    try:
        return make_mesh(n_data, n_spatial, device=device)
    except ValueError as e:
        raise SystemExit(f"--mesh {spec}: {e} (launch one process per rank "
                         "with torchrun)")


def _report(n_frames: int, seconds: float, extra: str = "") -> None:
    if n_frames:
        print(f"{n_frames} frames in {seconds:.2f}s = "
              f"{n_frames / seconds:.2f} FPS{extra}")


def run_pose(args, frames=None, draw=None, emit=None) -> int:
    """The pose app; ``frames``, ``draw``, ``emit`` default to the
    capture, ``blend_pose`` and a ``VideoSink``."""
    from tpupose_torch.detectors import PoseDetector

    mesh = parse_mesh(args.mesh, args.device) if args.mesh else None
    lead = mesh is None or mesh.rank == 0
    _warn_if_random(args.weights, "posenet")
    detector = PoseDetector("posenet", weights_file=args.weights,
                            precise=args.precise, cfg=_inference_cfg(args),
                            compute_dtype=_compute_dtype(args),
                            device=args.device, mesh=mesh)
    cap = sink = None
    if lead:
        if frames is None:
            cap = open_capture(args)
            frames = capture_frames(cap, live=not args.video)
        if emit is None:
            emit = sink = VideoSink(args, source_fps(cap) if cap else 30.0)
        draw = draw or blend_pose
    else:
        frames = draw = emit = None
    t0 = time.perf_counter()
    try:
        if args.batch > 1:
            n = stream_pose_batched(detector, frames, draw, emit, args.batch,
                                    args.max_frames, args.quant, mesh)
        else:
            n = stream_pose(detector, frames, draw, emit, args.max_frames,
                            args.quant)
    finally:
        if cap is not None:
            cap.release()
        if sink is not None:
            sink.close()
    if lead:
        _report(n, time.perf_counter() - t0,
                f" (batch {args.batch})" if args.batch > 1 else "")
    return n


def run_face(args, frames=None, draw=None, emit=None,
             find_crops=None) -> int:
    """The face app: faces located by a Haar cascade or, with
    ``--face-source pose``, by the pose net's face crops, then FaceNet per
    crop; the defaults as ``run_pose``'s."""
    from tpupose_torch.detectors import FaceDetector

    _warn_if_random(args.weights, "facenet")
    detector = FaceDetector("facenet", weights_file=args.weights,
                            compute_dtype=_compute_dtype(args),
                            device=args.device)
    if find_crops is None:
        if args.face_source == "haar":
            import cv2

            if not hasattr(cv2, "CascadeClassifier"):
                raise RuntimeError(
                    "this OpenCV build has no objdetect module "
                    "(cv2.CascadeClassifier); install full opencv-python "
                    "or use --face-source pose")
            cascade = cv2.CascadeClassifier(haar_cascade_path())

            def find_crops(img):
                return haar_face_crops(cascade, img)
        else:
            from tpupose_torch.detectors import PoseDetector

            pose_detector = PoseDetector("posenet",
                                         weights_file=args.pose_weights,
                                         device=args.device)

            def find_crops(img):
                return pose_face_crops(pose_detector, img)
    cap = sink = None
    if frames is None:
        cap = open_capture(args)
        frames = capture_frames(cap, live=not args.video)
    if emit is None:
        emit = sink = VideoSink(args, source_fps(cap) if cap else 30.0)
    t0 = time.perf_counter()
    try:
        n = stream_face(detector, frames, find_crops, draw or draw_faces,
                        emit, args.max_frames, args.quant)
    finally:
        if cap is not None:
            cap.release()
        if sink is not None:
            sink.close()
    _report(n, time.perf_counter() - t0)
    return n


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Streaming pose/face demo")
    p.add_argument("mode", choices=("pose", "face"))
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--video", help="video file instead of camera")
    p.add_argument("--weights", help=".npz weight file")
    p.add_argument("--save", help="write result video to this path")
    p.add_argument("--headless", action="store_true",
                   help="no imshow window")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--batch", type=int, default=1,
                   help="pose mode: frames per detect_batch")
    p.add_argument("--mesh",
                   help="pose batch mode: split each batch over a "
                        "DATAxSPATIAL mesh of ranks (e.g. 4x2 = frames "
                        "over 4 data ranks, frame rows over 2); one "
                        "process per rank under torchrun")
    p.add_argument("--precise", action="store_true",
                   help="pose mode: multi-scale precise inference, "
                        "pipelined across frames")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 network compute")
    p.add_argument("--quant", action="store_true",
                   help="w8a8 int8 network compute (tpupose_torch/"
                        "quant.py); pose mode calibrates on the first "
                        "frame, face mode on the first located face crops")
    p.add_argument("--nms-mode", choices=("scipy", "conv"), default="scipy",
                   help="pose mode: peak NMS semantics ('scipy' = the "
                        "reference CPU path, 'conv' = its GPU path)")
    p.add_argument("--face-source", default="haar",
                   choices=("haar", "pose"),
                   help="face mode: locate faces via Haar cascade or via "
                        "the pose network's nose-anchored crops")
    p.add_argument("--pose-weights",
                   help="face mode with --face-source pose: posenet .npz")
    p.add_argument("--device", default="cuda", help="torch device")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mesh and (args.mode != "pose" or args.batch <= 1):
        raise SystemExit("--mesh requires pose mode with --batch > 1 "
                         "(the mesh splits frame batches)")
    return (run_pose if args.mode == "pose" else run_face)(args)


if __name__ == "__main__":
    main()
