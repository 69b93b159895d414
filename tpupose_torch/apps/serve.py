"""HTTP serving front-end for pose / face / hand detection (port of
``tpupose/apps/serve.py``).

A serving process loads a ``torch.export`` bundle (``tpupose_torch/
serving.py``) or a live detector from npz weights and exposes detection
over plain HTTP with the standard library's ``http.server``.

Endpoints
---------
- ``GET /healthz``: readiness and the detector's metadata (arch, mode,
  servable image sizes).
- ``POST /v1/detect``: one image; the body is an encoded image (PNG/JPEG,
  any ``Content-Type`` but ``application/octet-stream``; decoding imports
  cv2) or raw uint8 HWC bytes with an ``X-Image-Shape: HxWx3`` header.
  Returns ``{"poses": [[[x, y, score] x 18] x N], "scores": [N]}``.
- ``POST /v1/detect_batch``: same-size frames, raw uint8 NxHxWx3 bytes
  with ``X-Image-Shape``, through the detector's ``detect_batch``.
  Returns ``{"results": [{"poses": ..., "scores": ...} x N]}``.
- ``POST /v1/detect_crops``: crop-net detectors (facenet/handnet), raw
  uint8 NxHxWx3 bytes with ``X-Image-Shape`` and an optional ``X-Flips:
  0,1,...`` header (the left-hand path).  Returns ``{"results": [[[x, y,
  conf] | null x C] x N]}``.

The handler runs inside ``ThreadingHTTPServer``, one thread per
connection.  Every forward of a service runs on one long-lived device
thread, one at a time in the order requests hand them over:

- a forward enters ``float32_numerics()``, whose cuDNN and matmul flags
  are process-wide, and two forwards in two threads could interleave its
  enter and exit and leave one of them running with TF32, which changes
  pose tables;
- cuDNN and cuBLAS keep per-thread state: the f32 forward in a new thread
  per call took 119 ms against 65 ms in one thread, while the int8 one,
  on the port's own kernels, took 46-47 ms either way
  (``scripts/serve_probe.py`` on an H100).

The device-to-host copy and the JSON encode of a request (``collect``)
run in its handler thread, beside the next request's forward.

Client hardening: bodies above ``max_body_bytes`` (default 64 MiB) are
refused with 413 before any read.  A size a live detector has not served
yet costs a first sight (cuDNN's heuristics, kernel builds) on the same
device thread (``geometry="any"``); ``geometry="reject"`` answers 400 to
sizes not warmed at startup (``warm_sizes`` / ``--warm``), and the CLI's
``--geometry bucket`` wraps the detector in ``BucketedPoseDetector`` (its
canvases run at startup).  A bundle serves the sizes it was exported for (any other is
a 400), and its bucket palette is those sizes.
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np


class ServingError(ValueError):
    """Client error (HTTP 400): bad payload, shape, or geometry."""


# refuse request bodies above this before buffering them (HTTP 413);
# a raw 640x640x3 frame is ~1.2 MB, a 64-frame batch ~75 MB
MAX_BODY_BYTES = 64 * 1024 * 1024


def _parse_shape(header: Optional[str], ndim: int):
    if not header:
        raise ServingError(
            "raw payloads need an X-Image-Shape header like 480x640x3")
    try:
        shape = tuple(int(t) for t in header.lower().split("x"))
    except ValueError:
        raise ServingError(f"bad X-Image-Shape {header!r}")
    if len(shape) != ndim or any(t <= 0 for t in shape) or shape[-1] != 3:
        raise ServingError(
            f"X-Image-Shape {header!r}: expected {ndim} positive "
            "x-separated dims ending in 3")
    return shape


def _raw_array(body: bytes, shape):
    if len(body) != int(np.prod(shape)):
        raise ServingError(f"raw body is {len(body)} bytes, X-Image-Shape "
                           f"{shape} needs {int(np.prod(shape))}")
    return np.frombuffer(body, np.uint8).reshape(shape)


def _decode_image(body: bytes, content_type: str, shape_header):
    """Encoded (cv2.imdecode) or raw-uint8 request body -> HWC image."""
    if content_type == "application/octet-stream":
        return _raw_array(body, _parse_shape(shape_header, 3))
    import cv2

    img = cv2.imdecode(np.frombuffer(body, np.uint8), cv2.IMREAD_COLOR)
    if img is None:
        raise ServingError("could not decode image body")
    return img


def _pose_payload(poses, scores) -> dict:
    return {"poses": np.asarray(poses, np.float64).tolist(),
            "scores": np.asarray(scores, np.float64).tolist()}


class _DeviceThread:
    """One long-lived thread that runs the calls handed to ``run`` one at a
    time, in the order they arrive, and hands back each result or
    exception."""

    def __init__(self):
        self._jobs = queue.Queue()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="tpupose-device")
        self._thread.start()

    def _loop(self):
        while True:
            job = self._jobs.get()
            if job is None:
                return
            fn, done = job
            try:
                done.put((True, fn()))
            except BaseException as e:     # noqa: BLE001 — re-raised in run
                done.put((False, e))

    def run(self, fn):
        done = queue.Queue(maxsize=1)
        self._jobs.put((fn, done))
        ok, value = done.get()
        if not ok:
            raise value
        return value

    def close(self):
        if self._thread.is_alive():
            self._jobs.put(None)
            self._thread.join()


class PoseService:
    """Wraps a pose detector (live, bundle or bucketed) for the HTTP
    handler.

    ``submit`` and ``detect_batch`` run on the service's device thread, one
    forward at a time in request order; ``collect`` runs in the handler's
    thread.  Sizes not served yet are served there too (``geometry="any"``)
    or refused (``geometry="reject"``)."""

    kind = "pose"

    def __init__(self, detector, geometry: str = "any"):
        if geometry not in ("any", "reject"):
            raise ValueError(f"geometry policy {geometry!r}: any|reject")
        self.detector = detector
        self.geometry = geometry
        self._device = _DeviceThread()
        # sizes already served (single keys (h, w); batched keys
        # (b, h, w)); bundles start with their exported sizes and batches
        self._known = {tuple(s) for s in
                       getattr(detector, "image_sizes", None) or []}
        batch_sizes = getattr(detector, "batch_sizes", None)
        if callable(batch_sizes):
            for h, w in list(self._known):
                for b in batch_sizes((h, w)):
                    self._known.add((int(b), h, w))
        # a BucketedPoseDetector absorbs every size into its palette
        self._absorbs = bool(getattr(detector, "absorbs_geometry", False))

    def warm(self, sizes) -> None:
        """Serve each size once at startup and mark it known: with
        ``geometry="reject"`` this IS the servable set.  ``(h, w)`` warms a
        single frame, ``(b, h, w)`` a batch."""
        for size in sizes:
            key = tuple(int(t) for t in size)
            frames = np.zeros((*key, 3), np.uint8)
            if len(key) == 3:
                self._device.run(lambda: self.detector.detect_batch(frames))
            else:
                self.detector.collect(self._device.run(
                    lambda: self.detector.submit(frames)))
            self._known.add(key)

    def close(self) -> None:
        """Stop the device thread."""
        self._device.close()

    def info(self) -> dict:
        d = self.detector
        return {
            "kind": self.kind,
            "arch": getattr(d, "arch", "posenet"),
            "mode": getattr(d, "mode",
                            "precise" if getattr(d, "precise", False)
                            else "fast"),
            "geometry": self.geometry,
            "image_sizes": [list(s) for s in
                            getattr(d, "image_sizes", [])] or None,
        }

    def _detect(self, key, img_or_batch):
        """One request's forward on the device thread, then its copy in
        this one."""
        batched = len(key) == 3
        if (key not in self._known and not self._absorbs
                and self.geometry == "reject"):
            raise ServingError(
                f"geometry {key} not pre-warmed and this server rejects "
                "novel sizes; resize to a warmed geometry")
        forward = self.detector.detect_batch if batched \
            else self.detector.submit
        try:
            out = self._device.run(lambda: forward(img_or_batch))
        except ValueError as e:               # unknown bundle geometry
            raise ServingError(str(e))
        self._known.add(key)
        if batched:
            return {"results": [_pose_payload(p, s) for p, s in out]}
        return _pose_payload(*self.detector.collect(out))

    def handle(self, path: str, body: bytes, headers) -> dict:
        if path == "/v1/detect":
            img = _decode_image(body, headers.get("Content-Type", ""),
                                headers.get("X-Image-Shape"))
            return self._detect(img.shape[:2], img)
        if path == "/v1/detect_batch":
            shape = _parse_shape(headers.get("X-Image-Shape"), 4)
            imgs = _raw_array(body, shape)
            if not hasattr(self.detector, "detect_batch"):
                raise ServingError("detector has no batched path")
            return self._detect(shape[:3], imgs)
        raise ServingError(f"pose service has no endpoint {path}")


class CropService(PoseService):
    """Face/hand crop-net serving (``/v1/detect_crops``)."""

    kind = "crop"

    def info(self) -> dict:
        d = self.detector
        return {
            "kind": self.kind,
            "arch": d.arch,
            "crop_sizes": [list(s) for s in
                           getattr(d, "crop_sizes", [])] or None,
        }

    def handle(self, path: str, body: bytes, headers) -> dict:
        if path != "/v1/detect_crops":
            raise ServingError(f"crop service has no endpoint {path}")
        shape = _parse_shape(headers.get("X-Image-Shape"), 4)
        crops = _raw_array(body, shape)
        flips_hdr = headers.get("X-Flips")
        flips = None
        if flips_hdr:
            flips = [t.strip() not in ("0", "", "false")
                     for t in flips_hdr.split(",")]
            if len(flips) != shape[0]:
                raise ServingError(
                    f"X-Flips has {len(flips)} entries for "
                    f"{shape[0]} crops")
        try:
            pending = self._device.run(
                lambda: self.detector.submit_crops(list(crops), flips))
        except ValueError as e:
            raise ServingError(str(e))
        return {"results": self.detector.collect_crops(pending)}


class _Server(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` whose ``server_close`` also stops its
    service's device thread."""

    def server_close(self):
        super().server_close()
        service = getattr(self, "service", None)
        if service is not None:
            service.close()


class _Handler(BaseHTTPRequestHandler):
    # the service is attached to the server object by make_server()
    protocol_version = "HTTP/1.1"

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):      # quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def do_GET(self):
        if self.path == "/healthz":
            info = self.server.service.info()
            info["status"] = "ok"
            self._reply(200, info)
        else:
            self._reply(404, {"error": f"no endpoint {self.path}"})

    def do_POST(self):
        service = self.server.service
        try:
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                length = -1
            if length < 0:
                self._reply(400, {"error": "bad Content-Length"})
                return
            cap = getattr(self.server, "max_body_bytes", MAX_BODY_BYTES)
            if length > cap:
                # refuse WITHOUT buffering: drain a bounded amount in fixed
                # chunks (discarded) so a well-behaved client can finish
                # sending and read the 413, then close
                self.close_connection = True
                remaining = min(length, 4 * cap)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self._reply(413, {"error":
                                  f"body of {length} bytes exceeds the "
                                  f"{cap}-byte limit"})
                return
            body = self.rfile.read(length)
            payload = service.handle(self.path, body, self.headers)
            self._reply(200, payload)
        except ServingError as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:              # noqa: BLE001 — serving loop
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(detector, host: str = "127.0.0.1", port: int = 0,
                verbose: bool = False,
                max_body_bytes: int = MAX_BODY_BYTES,
                geometry: str = "any",
                warm_sizes=None) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server for a detector.

    ``detector`` may be a live ``PoseDetector``, a ``ServingPoseDetector``
    bundle, a ``BucketedPoseDetector``, or a crop detector /
    ``ServingCropDetector`` (chosen by the presence of ``submit_crops``).
    ``port=0`` binds an ephemeral port (``server.server_address[1]``).
    ``geometry`` / ``warm_sizes``: the novel-size policy and the sizes
    served once at startup (pose services; see ``PoseService``).
    ``server_close()`` also stops the service's device thread."""
    if hasattr(detector, "submit_crops"):
        service = CropService(detector)
    else:
        service = PoseService(detector, geometry=geometry)
        if warm_sizes:
            service.warm(warm_sizes)
    server = _Server((host, port), _Handler)
    server.service = service
    server.verbose = verbose
    server.max_body_bytes = int(max_body_bytes)
    return server


# ---------------------------------------------------------------------------
# client helpers


def _post(url: str, body: bytes, headers: dict, timeout: float):
    from urllib.request import Request, urlopen

    req = Request(url, data=body, headers=headers, method="POST")
    with urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _pose_arrays(payload):
    """A pose payload -> (poses (N, 18, 3), scores (N,)) float32, the
    shapes of the in-process tables, an empty table included."""
    return (np.asarray(payload["poses"], np.float32).reshape(-1, 18, 3),
            np.asarray(payload["scores"], np.float32))


def _raw_headers(arr: np.ndarray) -> dict:
    return {"Content-Type": "application/octet-stream",
            "X-Image-Shape": "x".join(str(t) for t in arr.shape)}


def detect_over_http(url: str, img: np.ndarray, raw: bool = True,
                     timeout: float = 60.0):
    """POST one image to a serve.py endpoint; returns (poses, scores).

    ``raw=True`` sends uint8 bytes with X-Image-Shape (no encode);
    ``raw=False`` PNG-encodes with cv2 (what a non-numpy client sends)."""
    img = np.ascontiguousarray(img, np.uint8)
    if raw:
        body, headers = img.tobytes(), _raw_headers(img)
    else:
        import cv2

        ok, buf = cv2.imencode(".png", img)
        if not ok:
            raise ValueError("PNG encode failed")
        body, headers = buf.tobytes(), {"Content-Type": "image/png"}
    return _pose_arrays(_post(url.rstrip("/") + "/v1/detect", body,
                              headers, timeout))


def detect_batch_over_http(url: str, imgs, timeout: float = 120.0):
    """POST a same-size frame batch; returns [(poses, scores) per frame]."""
    arr = np.ascontiguousarray(np.stack(imgs), np.uint8)
    out = _post(url.rstrip("/") + "/v1/detect_batch", arr.tobytes(),
                _raw_headers(arr), timeout)
    return [_pose_arrays(r) for r in out["results"]]


def detect_crops_over_http(url: str, crops, flips=None,
                           timeout: float = 60.0):
    """POST a crop batch (same HxW) to a crop-net server; keypoint lists."""
    arr = np.ascontiguousarray(np.stack(crops), np.uint8)
    headers = _raw_headers(arr)
    if flips is not None:
        headers["X-Flips"] = ",".join("1" if f else "0" for f in flips)
    return _post(url.rstrip("/") + "/v1/detect_crops", arr.tobytes(),
                 headers, timeout)["results"]


# ---------------------------------------------------------------------------
# CLI


def _load_detector(args):
    import os

    if os.path.isdir(args.model):        # bundle directory
        with open(os.path.join(args.model, "meta.json")) as f:
            meta = json.load(f)
        if meta.get("mode") == "crop":
            from tpupose_torch.serving import ServingCropDetector

            return ServingCropDetector(args.model, device=args.device)
        from tpupose_torch.serving import ServingPoseDetector

        return ServingPoseDetector(args.model, device=args.device)
    # npz weights -> live detector
    if args.arch in ("facenet", "handnet"):
        from tpupose_torch.config import FACE, HAND
        from tpupose_torch.detectors.crop_keypoints import \
            CropKeypointDetector

        cfg = FACE if args.arch == "facenet" else HAND
        return CropKeypointDetector(args.arch, cfg, weights_file=args.model,
                                    device=args.device)
    from tpupose_torch.detectors.pose import PoseDetector

    return PoseDetector("posenet", weights_file=args.model,
                        precise=args.precise, device=args.device)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Serve pose/face/hand detection over HTTP from a "
                    "bundle directory or an npz weights file.")
    p.add_argument("model",
                   help="bundle directory (apps.export_serving output) "
                        "or .npz weights")
    p.add_argument("--arch", default="posenet",
                   choices=("posenet", "facenet", "handnet"),
                   help="architecture when serving from npz weights "
                        "(bundles are self-describing)")
    p.add_argument("--precise", action="store_true",
                   help="multi-scale pyramid when serving from npz weights")
    p.add_argument("--device", default="cuda",
                   help="torch device: the card, or cpu")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8731)
    p.add_argument("--verbose", action="store_true",
                   help="log each request")
    p.add_argument("--max-body-mb", type=int, default=64,
                   help="refuse request bodies above this (HTTP 413)")
    p.add_argument("--geometry", default="any",
                   choices=("any", "reject", "bucket"),
                   help="novel-image-size policy for pose detectors: "
                        "'any' serves a new size on first sight, 'reject' "
                        "400s sizes not in --warm, 'bucket' absorbs every "
                        "size into a fixed canvas palette (a bundle's "
                        "palette is its exported sizes), run at startup")
    p.add_argument("--warm", default="",
                   help="comma list of sizes to serve once at startup: "
                        "HxW frames and/or BxHxW batches, "
                        "e.g. 480x640,720x1280,8x480x640")
    p.add_argument("--canvas-long", type=int, default=640,
                   help="--geometry bucket over a live detector: canvas "
                        "palette long side")
    args = p.parse_args(argv)

    detector = _load_detector(args)
    warm_sizes = [tuple(int(t) for t in s.split("x"))
                  for s in args.warm.split(",") if s]
    if args.geometry == "bucket":
        if hasattr(detector, "submit_crops"):
            p.error("--geometry bucket applies to pose detectors only")
        from tpupose_torch.detectors.bucketed import (BucketedPoseDetector,
                                                      canvas_palette)

        # a bundle serves only its exported sizes: they are its palette
        canvases = (getattr(detector, "image_sizes", None)
                    or canvas_palette(args.canvas_long))
        detector = BucketedPoseDetector(detector, canvases=canvases)
        print("warming canvas palette "
              f"({len(detector.canvases)} canvases)...", flush=True)
        detector.warm(verbose=args.verbose)
        geometry, warm_sizes = "any", []
    else:
        geometry = args.geometry
    server = make_server(detector, args.host, args.port,
                         verbose=args.verbose,
                         max_body_bytes=args.max_body_mb * 1024 * 1024,
                         geometry=geometry, warm_sizes=warm_sizes)
    host, port = server.server_address[:2]
    print(f"serving {args.model} on http://{host}:{port} "
          f"(GET /healthz, POST /v1/detect[_batch|_crops])", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
