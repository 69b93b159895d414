"""The port's streaming camera app (``tpupose_torch/apps/camera.py``) on the
CPU, mirroring the JAX app's tests (``test_eval_apps.py::TestCameraApp``,
``TestCameraFaceMode``, ``test_detectors.py::test_camera_*``): cv2-written
videos in ``tmp_path``, the pipelined loops against the serial calls, the
padded batch tail, the ``--mesh`` refusals, the Haar path and face mode
with the pose source; and the import leaves cv2 and JAX out.

The pose detector is the port's with CocoPoseNet cut to 2 stages (the
detector's ``ARCHS`` patched while it is built) and seeded weights
calibrated so 64x80 frames carry people; FaceNet runs at 64 px.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cv2():
    import cv2

    return cv2


def _write_video(path, n_frames, wh=(80, 64), fps=10.0, seed=0):
    """``n_frames`` seeded random frames (wh = (width, height))."""
    cv2 = _cv2()
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         wh)
    rng = np.random.RandomState(seed)
    for _ in range(n_frames):
        wr.write(rng.randint(0, 255, (wh[1], wh[0], 3), dtype=np.uint8))
    wr.release()


def _frame_count(path) -> int:
    cv2 = _cv2()
    cap = cv2.VideoCapture(str(path))
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return n


def _frames(n, seed=0):
    return list(np.random.RandomState(seed).randint(
        0, 256, (n, 64, 80, 3)).astype(np.uint8))


def _pose_detector(precise=False):
    from tpupose_torch.config import InferenceConfig
    from tpupose_torch.detectors import net, pose
    from tpupose_torch.models import CocoPoseNet
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    cfg = InferenceConfig(img_size=64, heatmap_size=56, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    if precise:
        cfg = dataclasses.replace(cfg, scales=(0.5, 1.0))
    archs = net.ARCHS
    net.ARCHS = dict(archs, posenet=lambda seed=0, dtype=torch.float32:
                     CocoPoseNet(num_stages=2, seed=seed, dtype=dtype))
    try:
        det = pose.PoseDetector(cfg=cfg, device="cpu", precise=precise)
    finally:
        net.ARCHS = archs
    assert calibrate_output_convs(det, _frames(1)[0])
    return det


@pytest.fixture(scope="module")
def pose_det():
    return _pose_detector()


@pytest.fixture(scope="module")
def precise_det():
    return _pose_detector(precise=True)


@pytest.fixture(scope="module")
def face_det():
    from tpupose_torch.config import FaceConfig
    from tpupose_torch.detectors import FaceDetector

    return FaceDetector("facenet", cfg=FaceConfig(img_size=64), device="cpu")


def _patch(monkeypatch, **detectors):
    import tpupose_torch.detectors as det_mod

    seen = {}
    for name, det in detectors.items():
        def make(*a, _det=det, _name=name, **kw):
            seen[_name] = kw
            return _det

        monkeypatch.setattr(det_mod, name, make)
    return seen


# ---------------------------------------------------------------------------
# the loops, with in-memory frames
# ---------------------------------------------------------------------------


def _recorder():
    tables = []

    def draw(img, poses):
        tables.append(poses)
        return img

    return tables, draw


def test_pipelined_pose_loop_equals_serial_calls(pose_det):
    from tpupose_torch.apps.camera import stream_pose

    frames = _frames(5)
    tables, draw = _recorder()
    emitted = []
    assert stream_pose(pose_det, iter(frames), draw, emitted.append) == 5
    want = [pose_det(f)[0] for f in frames]
    assert sum(len(t) for t in want) >= 4
    for got, ref in zip(tables, want):
        np.testing.assert_array_equal(got, ref)
    assert all(a is b for a, b in zip(emitted, frames))


def test_pipelined_loop_submits_frame_n_before_collecting_n_minus_1(
        pose_det, monkeypatch):
    from tpupose_torch.apps.camera import stream_pose

    events = []
    submit, collect = pose_det.submit, pose_det.collect
    monkeypatch.setattr(pose_det, "submit",
                        lambda img: events.append("S") or submit(img))
    monkeypatch.setattr(pose_det, "collect",
                        lambda h: events.append("C") or collect(h))
    stream_pose(pose_det, iter(_frames(3)), lambda img, p: img,
                lambda img: None)
    assert events == ["S", "S", "C", "S", "C", "C"]


def test_max_frames_caps_the_pipelined_loop(pose_det):
    from tpupose_torch.apps.camera import stream_pose

    read = []

    def source():
        for f in _frames(6):
            read.append(1)
            yield f

    assert stream_pose(pose_det, source(), lambda img, p: img,
                       lambda img: None, max_frames=4) == 4
    assert len(read) == 4   # no frame read past the cap


def test_batched_loop_pads_the_tail_with_the_last_frame(pose_det,
                                                        monkeypatch):
    """7 frames at --batch 4: two ``detect_batch`` calls of 4, the second
    padded with repeats of the 7th frame; tables equal the serial
    ``__call__``'s."""
    from tpupose_torch.apps.camera import stream_pose_batched

    frames = _frames(8)
    calls = []
    detect = pose_det.detect_batch

    def recording(imgs):
        calls.append(np.array(imgs))
        return detect(imgs)

    monkeypatch.setattr(pose_det, "detect_batch", recording)
    tables, draw = _recorder()
    n = stream_pose_batched(pose_det, iter(frames), draw, lambda img: None,
                            batch=4, max_frames=7)
    assert n == 7 and [len(c) for c in calls] == [4, 4]
    for k in range(4):
        np.testing.assert_array_equal(calls[1][k], frames[min(4 + k, 6)])
    for got, frame in zip(tables, frames[:7]):
        np.testing.assert_array_equal(got, pose_det(frame)[0])


def test_face_loop_with_pose_source_equals_serial(pose_det, face_det):
    """The face loop with pose-located crops: frame N's crops submitted
    before frame N-1's are collected; keypoints equal ``detect_batch`` on
    the same crops."""
    from tpupose_torch.apps.camera import pose_face_crops, stream_face

    frames = _frames(3, seed=4)
    got, located_all = [], []

    def draw(img, located, keypoints):
        got.append(keypoints)
        located_all.append(located)
        return img

    n = stream_face(face_det, iter(frames),
                    lambda img: pose_face_crops(pose_det, img), draw,
                    lambda img: None)
    assert n == 3
    assert sum(len(loc) for loc in located_all) >= 1
    for keypoints, located in zip(got, located_all):
        assert keypoints == face_det.detect_batch([c for c, _ in located])


# ---------------------------------------------------------------------------
# main(): cv2 videos, flags
# ---------------------------------------------------------------------------


def test_video_pipeline(tmp_path, monkeypatch, pose_det):
    video, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    _write_video(video, 5)
    seen = _patch(monkeypatch, PoseDetector=pose_det)
    from tpupose_torch.apps import camera

    camera.main(["pose", "--video", str(video), "--headless", "--save",
                 str(out), "--max-frames", "4", "--device", "cpu",
                 "--nms-mode", "conv"])
    assert _frame_count(out) == 4
    kw = seen["PoseDetector"]
    assert kw["cfg"].nms_mode == "conv" and kw["device"] == "cpu"
    assert kw["mesh"] is None and kw["compute_dtype"] == torch.float32


def test_video_pipeline_precise_streaming(tmp_path, monkeypatch,
                                          precise_det):
    video, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    _write_video(video, 4)
    _patch(monkeypatch, PoseDetector=precise_det)
    from tpupose_torch.apps import camera

    camera.main(["pose", "--video", str(video), "--headless", "--precise",
                 "--save", str(out), "--max-frames", "3", "--device",
                 "cpu"])
    assert _frame_count(out) == 3


def test_precise_batched_video(tmp_path, monkeypatch, precise_det):
    video, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    _write_video(video, 4)
    _patch(monkeypatch, PoseDetector=precise_det)
    from tpupose_torch.apps import camera

    camera.main(["pose", "--video", str(video), "--headless", "--precise",
                 "--batch", "2", "--save", str(out), "--max-frames", "4",
                 "--device", "cpu"])
    assert _frame_count(out) == 4


def test_camera_batch_mode(tmp_path, monkeypatch, pose_det):
    """--batch 3 over 6 frames writes 6; --batch 4 --max-frames 5 writes 5
    through two full batches (the tail of 1 padded)."""
    video = tmp_path / "in.mp4"
    _write_video(video, 6)
    _patch(monkeypatch, PoseDetector=pose_det)
    from tpupose_torch.apps import camera

    out = tmp_path / "out.mp4"
    camera.main(["pose", "--video", str(video), "--headless", "--save",
                 str(out), "--batch", "3", "--max-frames", "6", "--device",
                 "cpu"])
    assert _frame_count(out) == 6
    sizes = []
    detect = pose_det.detect_batch
    monkeypatch.setattr(pose_det, "detect_batch",
                        lambda imgs: sizes.append(len(imgs)) or detect(imgs))
    out2 = tmp_path / "out2.mp4"
    camera.main(["pose", "--video", str(video), "--headless", "--save",
                 str(out2), "--batch", "4", "--max-frames", "5",
                 "--device", "cpu"])
    assert _frame_count(out2) == 5
    assert sizes == [4, 4]


@pytest.mark.parametrize("argv, match", [
    (["--mesh", "2x1"], "requires pose mode with --batch > 1"),
    (["--batch", "4", "--mesh", "banana"], "expects DATAxSPATIAL"),
    (["--batch", "4", "--mesh", "2x1"], "needs more than the 1"),
    (["--batch", "4", "--mesh", "1x2"], "needs more than the 1"),
], ids=["without_batch", "malformed", "oversubscribed_data",
        "oversubscribed_spatial"])
def test_camera_mesh_flag_errors(tmp_path, argv, match):
    from tpupose_torch.apps import camera

    video = tmp_path / "in.mp4"
    _write_video(video, 2)
    with pytest.raises(SystemExit, match=match):
        camera.main(["pose", "--video", str(video), "--headless",
                     "--device", "cpu", *argv])


def test_camera_mesh_1x1_reaches_the_detector(tmp_path, monkeypatch,
                                              pose_det):
    """--mesh 1x1 in one process is the process's 1x1 mesh."""
    video = tmp_path / "in.mp4"
    _write_video(video, 2)
    seen = _patch(monkeypatch, PoseDetector=pose_det)
    from tpupose_torch.apps import camera

    camera.main(["pose", "--video", str(video), "--headless", "--batch",
                 "2", "--mesh", "1x1", "--device", "cpu"])
    assert seen["PoseDetector"]["mesh"].shape == {"data": 1, "spatial": 1}


def test_haar_cascade_path_is_the_ports_copy():
    from tpupose_torch.apps.camera import haar_cascade_path

    path = haar_cascade_path()
    assert path == os.path.join(REPO, "tpupose_torch", "assets",
                                "haarcascade_frontalface_alt.xml")
    with open(path, "rb") as f, open(os.path.join(
            REPO, "tpupose", "assets", "haarcascade_frontalface_alt.xml"),
            "rb") as g:
        assert f.read() == g.read()


def test_face_video_pipeline_haar(tmp_path, monkeypatch, face_det):
    """Haar face mode: runs end to end where cv2 has ``CascadeClassifier``
    and raises naming ``--face-source pose`` where it has not (this
    sandbox's cv2 5.0.0), as the JAX app does."""
    video, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    _write_video(video, 3, wh=(124, 92))
    _patch(monkeypatch, FaceDetector=face_det)
    from tpupose_torch.apps import camera

    argv = ["face", "--video", str(video), "--headless", "--save", str(out),
            "--max-frames", "3", "--device", "cpu"]
    if hasattr(_cv2(), "CascadeClassifier"):
        camera.main(argv)
        assert _frame_count(out) == 3
    else:
        with pytest.raises(RuntimeError, match="--face-source pose"):
            camera.main(argv)


def test_face_video_pipeline_pose_source(tmp_path, monkeypatch, pose_det,
                                         face_det):
    video, out = tmp_path / "in.mp4", tmp_path / "out.mp4"
    _write_video(video, 3)
    seen = _patch(monkeypatch, FaceDetector=face_det, PoseDetector=pose_det)
    from tpupose_torch.apps import camera

    camera.main(["face", "--video", str(video), "--headless", "--save",
                 str(out), "--max-frames", "3", "--face-source", "pose",
                 "--device", "cpu"])
    assert _frame_count(out) == 3
    assert seen["PoseDetector"]["device"] == "cpu"


def test_import_leaves_out_cv2_and_jax():
    code = ("import sys; import tpupose_torch.apps.camera, "
            "tpupose_torch.parallel; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('cv2', 'jax', 'flax', 'tpupose')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr
