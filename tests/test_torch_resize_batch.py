"""The batched uint8 bilinear resize of packed crops
(``ops/resize.py::resize_u8_linear_batch``) on the CPU.

Its plain PyTorch version must give ``resize_u8_linear``'s bytes (cv2's,
``tests/test_torch_ops.py``) at every size, mirrored or not, and over a
batch of mixed sizes; the wrapper must refuse what the kernel does not take.
``tpupose_torch/csrc/resize_u8.cu`` has no interpret mode, but its C++ runs
here under g++ with the CUDA shim of ``test_torch_blur_nms_host.py`` (each
block's threads as ``std::thread``s): its taps, mirroring, bands, 16-byte
stores and the wrapper's launches of ``MAX_ITEMS`` images are held against
the plain version.  The card's compiler and the hardware are checked by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops import resize as rs

from test_torch_blur_nms_host import _SHIM

SIDES = [1, 2, 64, 100, 157, 192, 368, 500]
NON_SQUARE = [(37, 120), (120, 37), (1, 200), (200, 1), (368, 500),
              (480, 640)]


def _image(hw, seed=0):
    return np.random.RandomState(seed + hw[0] * 1000 + hw[1]).randint(
        0, 256, hw + (3,)).astype(np.uint8)


def _numpy_batch(images, mirrors, size):
    return np.stack([rs.resize_u8_linear(img[:, ::-1] if m else img, size)
                     for img, m in zip(images, mirrors)])


def _plain(images, mirrors, size):
    packed, descriptors = rs.pack_u8_images(images, mirrors)
    return rs.resize_u8_linear_batch(packed, descriptors, size).numpy()


@pytest.mark.parametrize("mirror", [False, True])
@pytest.mark.parametrize("hw", [(s, s) for s in SIDES] + NON_SQUARE)
def test_plain_batch_resize_is_numpys_bytes(hw, mirror):
    img = _image(hw)
    np.testing.assert_array_equal(_plain([img], [mirror], (368, 368)),
                                  _numpy_batch([img], [mirror], (368, 368)))


@pytest.mark.parametrize("size", [(368, 368), (496, 368), (45, 37)])
def test_mixed_batch_equals_crops_resized_one_at_a_time(size):
    rng = np.random.RandomState(3)
    images = [_image((int(h), int(w)), i) for i, (h, w) in enumerate(
        rng.randint(1, 200, (9, 2)))]
    images.append(_image(size[::-1]))          # already the output size
    mirrors = [bool(m) for m in rng.randint(0, 2, len(images))]
    np.testing.assert_array_equal(_plain(images, mirrors, size),
                                  _numpy_batch(images, mirrors, size))


def test_pack_puts_views_back_to_back():
    frame = _image((50, 60))
    crops = [frame[5:25, 10:40], frame[::2, ::3], frame[:1, :1]]
    packed, descriptors = rs.pack_u8_images(crops, [True, False, True])
    assert packed.dtype == torch.uint8 and packed.device.type == "cpu"
    assert packed.numel() == sum(c.size for c in crops)
    for c, (o, h, w, m) in zip(crops, descriptors):
        np.testing.assert_array_equal(
            packed[o:o + c.size].reshape(h, w, 3).numpy(), c)
    assert [m for *_, m in descriptors] == [True, False, True]


@pytest.mark.parametrize("packed, descriptors, size, match", [
    (torch.zeros(12, dtype=torch.int32), [(0, 2, 2, False)], (8, 8),
     "uint8"),
    (torch.zeros(2, 6, dtype=torch.uint8), [(0, 2, 2, False)], (8, 8),
     "1-D"),
    (torch.zeros(24, dtype=torch.uint8)[::2], [(0, 2, 2, False)], (8, 8),
     "contiguous"),
    (torch.zeros(12, dtype=torch.uint8), [(1, 2, 2, False)], (8, 8),
     "outside"),
    (torch.zeros(12, dtype=torch.uint8), [(-1, 2, 2, False)], (8, 8),
     "outside"),
    (torch.zeros(12, dtype=torch.uint8), [(0, 0, 2, False)], (8, 8),
     "outside"),
    (torch.zeros(12, dtype=torch.uint8), [(0, 2, 2, False)], (0, 8),
     "size"),
    (torch.zeros(12, dtype=torch.uint8), [(0, 2, 2, False)],
     (rs.MAX_OUT_W + 1, 8), "size"),
])
def test_batch_resize_refuses_what_the_kernel_does_not_take(
        packed, descriptors, size, match):
    with pytest.raises(ValueError, match=match):
        rs.resize_u8_linear_batch(packed, descriptors, size)


@pytest.mark.parametrize("img", [np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32),
                                 np.zeros((0, 4, 3), np.uint8)])
def test_pack_refuses_what_the_kernel_does_not_take(img):
    with pytest.raises(ValueError, match="HWC"):
        rs.pack_u8_images([img], [False])


def _host_source(cuda_source: str) -> str:
    src = cuda_source.replace("#include <cuda_runtime.h>",
                              '#include "host_shim.h"')
    src, n_smem = re.subn(
        r"extern __shared__ __align__\(16\) int (\w+)\[\];",
        r"int* \1 = host_smem;", src)
    src, n_launch = re.subn(r"(\w+)<<<(.*?)>>>\(", r"host_launch(\1, \2, ",
                            src, flags=re.S)
    assert (n_smem, n_launch) == (1, 1), "resize_u8.cu changed: update shim"
    return src


_EXTRA_SHIM = r"""
#include <algorithm>
#include <math.h>
using std::max;
using std::min;
inline double __ddiv_rn(double a, double b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __double2float_rn(double a) { return (float)a; }
inline float __fsub_rn(float a, float b) { return a - b; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("resize_u8_host")
    (out / "host_shim.h").write_text(_SHIM + _EXTRA_SHIM)
    with open(_cuda_build.source("resize_u8")) as f:
        (out / "resize_u8_host.cpp").write_text(_host_source(f.read()))
    lib_path = str(out / "resize_u8_host.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-shared", "-fPIC", "-o", lib_path,
                    str(out / "resize_u8_host.cpp")], check=True, timeout=300)
    return rs.bind(ctypes.CDLL(lib_path))


def _host_batch(lib, images, mirrors, size):
    packed, descriptors = rs.pack_u8_images(images, mirrors)
    out = torch.full((len(images), size[1], size[0], 3), 7, dtype=torch.uint8)
    launches = rs._launch(lib, packed, descriptors, out, None)
    return out.numpy(), launches


@pytest.mark.parametrize("case", ["request", "ragged_rows", "identity",
                                  "down", "thin"])
def test_kernel_source_matches_plain_on_host(host_kernel, case):
    rng = np.random.RandomState(len(case))
    if case == "request":       # the hand cell's: 8 crops, 4 mirrored
        sides = rng.randint(64, 193, 8)
        images = [_image((int(s), int(s)), i) for i, s in enumerate(sides)]
        mirrors, size = [i % 2 == 0 for i in range(8)], (368, 368)
    elif case == "ragged_rows":  # 135-byte rows: no 16-byte store; 37 rows
        images = [_image((20, 31)), _image((50, 9), 1)]
        mirrors, size = [True, False], (45, 37)
    elif case == "identity":
        images = [_image((40, 24))]
        mirrors, size = [True], (24, 40)
    elif case == "down":
        images = [_image((500, 480)), _image((1, 1), 2)]
        mirrors, size = [False, True], (368, 368)
    else:
        images = [_image((1, 300)), _image((300, 1), 3)]
        mirrors, size = [True, True], (64, 48)
    got, launches = _host_batch(host_kernel, images, mirrors, size)
    assert launches == 1
    np.testing.assert_array_equal(got, _plain(images, mirrors, size))
    np.testing.assert_array_equal(got, _numpy_batch(images, mirrors, size))


def test_kernel_source_takes_more_items_than_a_launch_holds(host_kernel):
    n = rs.MAX_ITEMS + 6
    rng = np.random.RandomState(9)
    images = [_image((int(h), int(w)), i) for i, (h, w) in enumerate(
        rng.randint(1, 12, (n, 2)))]
    mirrors = [bool(m) for m in rng.randint(0, 2, n)]
    got, launches = _host_batch(host_kernel, images, mirrors, (10, 6))
    assert launches == 2
    np.testing.assert_array_equal(got, _plain(images, mirrors, (10, 6)))
