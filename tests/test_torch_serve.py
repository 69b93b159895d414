"""The port's HTTP front-end (``tpupose_torch/apps/serve.py``) in-process
on the CPU, against the JAX package's ``tpupose.apps.serve`` and the live
port detector.

Real ``ThreadingHTTPServer``s on ephemeral ports are driven with the
modules' own client helpers, so the whole request path runs: decode,
submit on the service's device thread, collect, JSON reply.  Both
packages' servers run the full 6-stage CocoPoseNet at ``img_size=96`` on
the same calibrated params.  Tolerances: the port's payloads equal its
in-process results exactly (JSON carries float64 copies of float32
values); against the JAX server's payloads within
``_assert_pose_tables_match``'s 5e-3.
"""

import json
import shutil
import threading
from urllib.error import HTTPError
from urllib.request import Request, urlopen

import numpy as np
import pytest
import torch

from tpupose.apps import serve as jax_serve
from tpupose_torch.apps import serve
from tpupose_torch.apps.serve import (detect_batch_over_http,
                                      detect_crops_over_http,
                                      detect_over_http, make_server)
from tpupose_torch.config import FaceConfig
from tpupose_torch.detectors import FaceDetector
from tpupose_torch.detectors.bucketed import BucketedPoseDetector
from tpupose_torch.serving import ServingPoseDetector, save_bundle
from tpupose_torch.utils.calibrate import calibrate_crop_output_conv

from test_torch_detector import _assert_pose_tables_match
from test_torch_serving import HW, _frame, _same, pose_detectors


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_path(tmp_path):
    """A test's directory, removed when it ends: a full-width model's
    weights file is ~200 MB, and pytest keeps every test's directory."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def detectors():
    jdet, _, tdet = pose_detectors()
    return jdet, tdet


@pytest.fixture
def served():
    """Start a server (this package's ``make_server`` or the JAX one's) for
    a detector; yields the starter, which returns the base URL."""
    servers = []

    def start(detector, make=make_server, **kw):
        server = make(detector, port=0, **kw)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        servers.append((server, t))
        host, port = server.server_address[:2]
        return f"http://{host}:{port}"

    yield start
    for server, t in servers:
        server.shutdown()
        server.server_close()
        t.join(timeout=5)


def _status(url, path, body=b"", headers=None):
    req = Request(url + path, data=body, headers=headers or {},
                  method="POST")
    with pytest.raises(HTTPError) as e:
        urlopen(req, timeout=60)
    return e.value.code, json.loads(e.value.read())


def test_healthz(served, detectors):
    _, tdet = detectors
    url = served(tdet)
    with urlopen(url + "/healthz", timeout=30) as resp:
        info = json.loads(resp.read())
    assert info == {"kind": "pose", "arch": "posenet", "mode": "fast",
                    "geometry": "any", "image_sizes": None, "status": "ok"}


def test_detect_matches_in_process_and_jax_server(served, detectors):
    jdet, tdet = detectors
    url, jurl = served(tdet), served(jdet, make=jax_serve.make_server)
    for seed in (0, 1):
        got = detect_over_http(url, _frame(seed))
        assert _same(got, tdet(_frame(seed)))
        ref = jax_serve.detect_over_http(jurl, _frame(seed))
        _assert_pose_tables_match(*got, *ref)
    assert len(got[0]) >= 1


def test_detect_batch_matches_in_process_and_jax_server(served, detectors):
    jdet, tdet = detectors
    url, jurl = served(tdet), served(jdet, make=jax_serve.make_server)
    frames = [_frame(0), _frame(1)]
    got = detect_batch_over_http(url, frames)
    for g, r in zip(got, tdet.detect_batch(np.stack(frames))):
        assert _same(g, r)
    for g, r in zip(got, jax_serve.detect_batch_over_http(jurl, frames)):
        _assert_pose_tables_match(*g, *r)


def test_png_body_matches_raw(served, detectors):
    pytest.importorskip("cv2")
    _, tdet = detectors
    url = served(tdet)
    assert _same(detect_over_http(url, _frame(1), raw=False),
                 detect_over_http(url, _frame(1), raw=True))
    code, out = _status(url, "/v1/detect", b"not an image",
                        {"Content-Type": "image/png"})
    assert code == 400 and "decode" in out["error"]


def test_concurrent_clients_equal_sequential(served, detectors):
    """Ten client threads (more than the cores) over two frame sizes, with
    a short thread switch interval: every reply equals the sequential one
    for its frame, so no forward ran into another."""
    import sys

    _, tdet = detectors
    url = served(tdet)
    frames = [_frame(0), _frame(1)[:80, :112].copy(), _frame(2),
              _frame(3)[:80, :112].copy()]
    want = [detect_over_http(url, f) for f in frames]
    got = [None] * 10
    errors = []

    def client(i):
        try:
            got[i] = detect_over_http(url, frames[i % len(frames)])
        except Exception as e:        # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(got))]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, g in enumerate(got):
        assert _same(g, want[i % len(frames)])


def test_client_errors(served, detectors):
    """413 before the body is read, 400 for a bad shape and for a size the
    ``reject`` policy was not warmed for, 404 for an unknown path."""
    _, tdet = detectors
    url = served(tdet, max_body_bytes=1024)
    code, out = _status(url, "/v1/detect", b"x" * 4096,
                        {"Content-Type": "application/octet-stream",
                         "X-Image-Shape": "32x32x3"})
    assert code == 413 and "limit" in out["error"]
    url = served(tdet, geometry="reject", warm_sizes=[HW])
    raw = {"Content-Type": "application/octet-stream"}
    code, out = _status(url, "/v1/detect", b"\0" * 10,
                        dict(raw, **{"X-Image-Shape": "2x2x3"}))
    assert code == 400 and "needs 12" in out["error"]
    code, out = _status(url, "/v1/detect", b"\0" * 12,
                        dict(raw, **{"X-Image-Shape": "2x2"}))
    assert code == 400 and "X-Image-Shape" in out["error"]
    code, out = _status(url, "/v1/detect", b"\0" * (64 * 64 * 3),
                        dict(raw, **{"X-Image-Shape": "64x64x3"}))
    assert code == 400 and "not pre-warmed" in out["error"]
    assert _same(detect_over_http(url, _frame(0)), tdet(_frame(0)))
    code, out = _status(url, "/v1/nowhere")
    assert code == 400 and "no endpoint" in out["error"]
    with pytest.raises(HTTPError) as e:
        urlopen(url + "/nowhere", timeout=30)
    assert e.value.code == 404
    with pytest.raises(ValueError, match="geometry policy"):
        serve.PoseService(tdet, geometry="bucket")


def test_detect_crops_with_flips(served):
    det = FaceDetector(device="cpu", cfg=FaceConfig(img_size=64))
    rng = np.random.RandomState(3)
    crops = [rng.randint(0, 256, (40, 36, 3)).astype(np.uint8)
             for _ in range(3)]
    calibrate_crop_output_conv(det, crops)
    url = served(det)
    flips = [False, True, True]
    got = detect_crops_over_http(url, crops, flips=flips)
    assert got == det.detect_crops(crops, flips)
    assert sum(k is not None for row in got for k in row) >= 1
    code, out = _status(url, "/v1/detect_crops", np.stack(crops).tobytes(),
                        {"Content-Type": "application/octet-stream",
                         "X-Image-Shape": "3x40x36x3", "X-Flips": "0,1"})
    assert code == 400 and "X-Flips" in out["error"]
    code, _ = _status(url, "/v1/detect", b"")
    assert code == 400


def test_bucket_geometry_over_a_bundle_warms_only_its_sizes(
        detectors, tmp_path, monkeypatch):
    """Fault 3.3 of the JAX CLI, not copied: ``--geometry bucket`` over a
    bundle takes the bundle's sizes as its palette, so startup runs those
    sizes only, and a frame of another size is placed on them."""
    _, tdet = detectors
    save_bundle(tdet, str(tmp_path), [HW], platforms=("cpu",))
    seen, started = [], []
    submit = ServingPoseDetector.submit

    def counted(self, img):
        seen.append(np.asarray(img).shape[:2])
        return submit(self, img)

    class Server:
        server_address = ("127.0.0.1", 0)

        def serve_forever(self):
            started.append(True)

        def server_close(self):
            pass

    def fake_make_server(detector, *args, **kwargs):
        started.append(detector)
        return Server()

    monkeypatch.setattr(ServingPoseDetector, "submit", counted)
    monkeypatch.setattr(serve, "make_server", fake_make_server)
    serve.main([str(tmp_path), "--geometry", "bucket", "--device", "cpu"])
    detector = started[0]
    assert isinstance(detector, BucketedPoseDetector)
    assert detector.canvases == [HW] and seen == [HW]
    assert started[1] is True
    poses, _ = detector(_frame(0)[:80, :100].copy())
    assert seen[-1] == HW and poses.shape[1:] == (18, 3)
    # the bundle served as it is: another size is a 400 from the device
    # thread, which goes on serving
    server = make_server(detector.detector, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = "http://%s:%d" % server.server_address[:2]
        code, out = _status(url, "/v1/detect", b"\0" * (64 * 64 * 3),
                            {"Content-Type": "application/octet-stream",
                             "X-Image-Shape": "64x64x3"})
        assert code == 400 and "no program exported" in out["error"]
        assert _same(detect_over_http(url, _frame(0)),
                     detector.detector(_frame(0)))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)
