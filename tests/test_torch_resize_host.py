"""The compiled host uint8 bilinear resize (``ops/resize.py::resize_u8_linear``,
``tpupose_torch/native/resize_u8_host.cpp``) against its numpy plain version
``resize_u8_linear_plain``, byte for byte, on the CPU.

Shapes: ``test_torch_resize_batch.py``'s sides and non-square crops, up and
down to the pose inputs (368x496, 368x656), the crop size (368x368), a small
target (37x45) and the identity; HW, HWC with 3 and with 4 channels, and
mirrored views.  Also: the plain version's ``ValueError`` for what it
refuses, ``out=`` written in place, ``resize_u8_linear.calls`` advancing
once per image the compiled routine resizes, threads resizing at once, and
a failed build raising with the compiler's message (there is no fallback).
The plain version is held to cv2's bytes in ``tests/test_torch_ops.py``.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from tpupose_torch import native
from tpupose_torch.ops import resize as rs

from test_torch_resize_batch import NON_SQUARE, SIDES

SIZES = [(496, 368), (656, 368), (368, 368), (45, 37), "identity"]
LAYOUTS = {"hw": (), "hwc3": (3,), "hwc4": (4,)}


def _id(v):
    return v if isinstance(v, str) else "x".join(map(str, v))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_library():
    """The compiled routine, built (or found built) once for the module."""
    return rs._host_library()


def _image(hw, channels, seed=0):
    return np.random.RandomState(seed + hw[0] * 1000 + hw[1]).randint(
        0, 256, tuple(hw) + channels).astype(np.uint8)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("size", SIZES, ids=_id)
@pytest.mark.parametrize("hw", [(s, s) for s in SIDES] + NON_SQUARE, ids=_id)
def test_compiled_resize_is_plains_bytes(host_library, hw, size, layout):
    img = _image(hw, LAYOUTS[layout])
    size = hw[::-1] if size == "identity" else size
    for view in (img, img[:, ::-1]):
        got = rs.resize_u8_linear(view, size)
        want = rs.resize_u8_linear_plain(view, size)
        assert got.shape == want.shape == (size[1], size[0]) + img.shape[2:]
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_compiled_resize_on_random_shapes_and_channels(host_library, seed):
    rng = np.random.RandomState(100 + seed)
    for _ in range(8):
        in_h, in_w, out_h, out_w = (int(v) for v in rng.randint(1, 300, 4))
        cn = int(rng.randint(1, 6))
        img = rng.randint(0, 256, (in_h, in_w, cn)).astype(np.uint8)
        np.testing.assert_array_equal(
            rs.resize_u8_linear(img, (out_w, out_h)),
            rs.resize_u8_linear_plain(img, (out_w, out_h)))


def test_identity_size_is_a_copy():
    img = _image((9, 11), (3,))
    calls = rs.resize_u8_linear.calls
    got = rs.resize_u8_linear(img, (11, 9))
    assert got is not img and not np.shares_memory(got, img)
    np.testing.assert_array_equal(got, img)
    assert rs.resize_u8_linear.calls == calls


@pytest.mark.parametrize("bad", [
    np.zeros((8, 8, 3), np.float32), np.zeros((8, 8), np.int16),
    np.zeros((8, 8, 3), bool), np.zeros(8, np.uint8),
    np.zeros((2, 8, 8, 3), np.uint8)], ids=lambda a: f"{a.dtype}{a.shape}")
def test_refuses_what_the_plain_version_refuses(bad):
    with pytest.raises(ValueError) as plain:
        rs.resize_u8_linear_plain(bad, (4, 4))
    with pytest.raises(ValueError) as compiled:
        rs.resize_u8_linear(bad, (4, 4))
    assert str(compiled.value) == str(plain.value)


def test_out_is_written_in_place(host_library):
    frames = [_image((480, 640), (3,), seed) for seed in range(3)]
    batch = np.full((3, 368, 496, 3), 7, np.uint8)
    got = rs.resize_u8_linear(frames[1], (496, 368), out=batch[1])
    assert np.shares_memory(got, batch[1]) and got.shape == batch[1].shape
    np.testing.assert_array_equal(
        batch[1], rs.resize_u8_linear_plain(frames[1], (496, 368)))
    assert (batch[0] == 7).all() and (batch[2] == 7).all()
    same = np.empty((480, 640, 3), np.uint8)
    assert rs.resize_u8_linear(frames[0], (640, 480), out=same) is same
    np.testing.assert_array_equal(same, frames[0])


@pytest.mark.parametrize("out", [
    np.empty((368, 496, 3), np.float32), np.empty((368, 496), np.uint8),
    np.empty((496, 368, 3), np.uint8),
    np.empty((368, 992, 3), np.uint8)[:, ::2]], ids=["dtype", "ndim",
                                                    "shape", "strided"])
def test_out_of_the_wrong_kind_is_refused(out):
    with pytest.raises(ValueError, match="out must be"):
        rs.resize_u8_linear(_image((48, 64), (3,)), (496, 368), out=out)


def test_calls_counts_each_compiled_image(host_library):
    calls = rs.resize_u8_linear.calls
    imgs = [_image((40 + i, 50), (3,), i) for i in range(4)]
    for i, img in enumerate(imgs):
        rs.resize_u8_linear(img, (64, 48))
        assert rs.resize_u8_linear.calls == calls + i + 1
    rs.resize_u8_linear(imgs[0][:, ::-1], (64, 48))
    assert rs.resize_u8_linear.calls == calls + 5


def test_threads_resize_at_once(host_library):
    """The routine keeps no state between calls and ctypes releases the
    interpreter lock around it: 8 threads resizing different frames at once
    each get their own plain bytes, and no count is lost."""
    frames = [_image((120 + 7 * i, 160), (3,), i) for i in range(8)]
    want = [rs.resize_u8_linear_plain(f, (124, 92)) for f in frames]
    calls = rs.resize_u8_linear.calls
    failures = []

    def worker(i):
        for _ in range(25):
            if not np.array_equal(rs.resize_u8_linear(frames[i], (124, 92)),
                                  want[i]):
                failures.append(i)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert failures == []
    assert rs.resize_u8_linear.calls == calls + 8 * 25


def test_failed_build_raises_with_no_fallback(tmp_path, monkeypatch):
    bad = tmp_path / "resize_u8_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "RESIZE_SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    rs._host_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            rs.resize_u8_linear(_image((20, 30), (3,)), (15, 10))
    finally:
        rs._host_library.cache_clear()
