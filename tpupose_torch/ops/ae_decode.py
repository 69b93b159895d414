"""The associative-embedding decode of a bottom-up net (HigherHRNet's
test-time path: ``lib/core/inference.py``, ``lib/core/group.py``'s
``HeatmapParser`` and ``lib/utils/transforms.py``), on the detector's
device around one host step.

Per frame:

- geometry (``ae_geometry``): the short side to ``input_size``, the long
  side to the next multiple of ``size_multiple`` above its scaled length;
  the frame is resized on the host (``resize_u8_linear``) onto the
  uniformly scaled region, centred on a zero canvas;
- on the device: ``normalise`` (BGR to RGB, ``/255``, ImageNet's mean and
  std), the frame and its mirror as one batch of 2, the net, then
  ``aggregate``: per pass output 0 resized bilinearly to output 1's size,
  the heatmaps the mean of its first J channels and output 1, the tags its
  last J, the mirrored pass mirrored back and permuted by the flip index;
  heatmaps and tags resized bilinearly to the canvas, the heatmaps the mean
  of the passes;
- ``top_k``: NMS (a pixel kept where the 5x5 max pool equals it), the
  ``max_num_people`` largest of each joint (equal values in row-major
  order), their tags and their quarter-pixel adjust, as one (J, K, 7)
  table, copied to the host asynchronously;
- on the host (``match_by_tag``): the candidates over the threshold,
  joint by joint in the match order, joined to the first
  ``max_num_people`` groups by ``assign`` (the first optimal assignment in
  row order of ``round(|tag - group mean|) * 100 - val``) where the tag
  distance is below ``tag_threshold``, else opening a group keyed by the
  tag's first value; a person's score is the mean of its J values;
- ``refine`` on the device for every (person, joint) the person lacks:
  the argmax over the canvas of ``det - round(|tag - mean tag|)`` (the
  first in row-major order; on a card one launch of ``csrc/ae_refine.cu``
  for every pair), its quarter-pixel adjust and value, in one copy back;
  filled where the value is positive;
- ``final_poses``: the exact inverse of the resize, to frame pixels.

``ae_decode`` runs the host step and the refine of a pending frame under
the spans ``ae.match`` (its wait for the table copy included) and
``ae.refine`` (enqueue and the copy back), and counts
``ae_decode.candidates`` (over the threshold), ``ae_decode.persons``,
``ae_decode.refined`` (the (person, joint) pairs refine scores) and
``ae_decode.refilled`` (joints refine filled).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpupose_torch.ops import _cuda_build
from tpupose_torch.ops.resize import resize_u8_linear
from tpupose_torch.ops.upload import to_device
from tpupose_torch.utils.profiling import annotate

TABLE_FIELDS = 7      # x, y, val, tag (pass 0), tag (pass 1), x adj, y adj
_REFINE_CHUNK = 64    # pairs a plain refine step holds, per joint
GROUP = 16            # pairs of a joint a refine block scores; must equal
                      # AE_REFINE_GROUP in csrc/ae_refine.cu


# The test-time settings of ``w32_512_adam_lr1e-3.yaml`` (``TEST:``): flip
# test on, scale 1, adjust and refine on.
SIZE_MULTIPLE = 64
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
NMS_KERNEL = 5
NMS_PADDING = 2
MAX_NUM_PEOPLE = 30
DETECTION_THRESHOLD = 0.1
TAG_THRESHOLD = 1.0


@dataclasses.dataclass(frozen=True)
class AEConfig:
    """The decoder's setting that varies: the network input's short side
    (512 published; smaller for tests on the CPU)."""

    input_size: int = 512


AE_DEFAULTS = AEConfig()


@dataclasses.dataclass(frozen=True)
class AEGeometry:
    """A frame's network input ``in_hw``, the region ``res_hw`` its resize
    fills and that region's top-left ``offset`` (y, x) in the input."""

    frame_hw: Tuple[int, int]
    in_hw: Tuple[int, int]
    res_hw: Tuple[int, int]
    offset: Tuple[int, int]

    @property
    def scale(self) -> Tuple[float, float]:
        """Frame pixels per input pixel, (x, y)."""
        return (self.frame_hw[1] / self.res_hw[1],
                self.frame_hw[0] / self.res_hw[0])


def ae_geometry(frame_h: int, frame_w: int, input_size: int = 512
                ) -> AEGeometry:
    """``get_multi_scale_size`` at scale 1 (a 720x1280 frame: a 512x960
    input, the frame resized to 512x910 at x offset 25)."""
    m = SIZE_MULTIPLE
    base = int((input_size + m - 1) // m * m)
    h, w = frame_h, frame_w
    if w < h:
        in_hw = (int((base / w * h + m - 1) // m * m), base)
        res_hw = (int(math.floor(h * base / w + 0.5)), base)
    else:
        in_hw = (base, int((base / h * w + m - 1) // m * m))
        res_hw = (base, int(math.floor(w * base / h + 0.5)))
    offset = ((in_hw[0] - res_hw[0]) // 2, (in_hw[1] - res_hw[1]) // 2)
    return AEGeometry((h, w), in_hw, res_hw, offset)


def place_frame(img: np.ndarray, geom: AEGeometry,
                pin: bool = False) -> torch.Tensor:
    """The (H, W, 3) uint8 network input of a BGR frame: resized onto its
    region, zeros around; in pinned memory if ``pin`` (a card's upload then
    copies it as it is, with no staging copy)."""
    out = torch.empty(geom.in_hw + img.shape[2:], dtype=torch.uint8,
                      pin_memory=pin)
    view = out.numpy()
    view[...] = 0
    (oy, ox), (rh, rw) = geom.offset, geom.res_hw
    view[oy:oy + rh, ox:ox + rw] = resize_u8_linear(img, (rw, rh))
    return out


def normalise(imgs_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) BGR uint8 -> (B, 3, H, W) float32 RGB: ``/255``, then
    minus the mean, over the std (torchvision's ``ToTensor`` and
    ``Normalize``)."""
    x = imgs_u8.flip(-1).permute(0, 3, 1, 2).float().div(255)
    mean, std = to_device(np.asarray([MEAN, STD], np.float32), x.device)
    return x.sub(mean[:, None, None]).div(std[:, None, None])


def with_mirror(x: torch.Tensor) -> torch.Tensor:
    """(1, C, H, W) -> (2, C, H, W): the frame, then its mirror in x."""
    return torch.cat([x, torch.flip(x, [3])])


def _bilinear(t: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(t, size=tuple(hw), mode="bilinear",
                         align_corners=False)


def aggregate(out0: torch.Tensor, out1: torch.Tensor,
              flip_index: Sequence[int], in_hw: Tuple[int, int]):
    """The net's outputs of a frame and its mirror, (2, 2J, H/4, W/4) and
    (2, J, H/2, W/2) -> heatmaps (J, H, W) and tags (2, J, H, W) at the
    input size."""
    j = out1.shape[1]
    up = _bilinear(out0, out1.shape[-2:])
    flip = to_device(np.asarray(flip_index, np.int64), up.device)
    mirrored = torch.flip(up[1:], [3])
    hm = torch.cat([0 + up[:1, :j], 0 + mirrored[:, :j][:, flip]])
    hm = hm + torch.cat([out1[:1], torch.flip(out1[1:], [3])[:, flip]])
    tags = torch.cat([up[:1, j:], mirrored[:, j:][:, flip]])
    heat = _bilinear((hm / 2).contiguous(), in_hw)
    det = (heat[0] + heat[1]) / 2.0
    return det, _bilinear(tags.contiguous(), in_hw)


def top_k(det: torch.Tensor, tags: torch.Tensor) -> torch.Tensor:
    """The (J, K, 7) candidate table of (J, H, W) heatmaps and (L, J, H, W)
    tags, K = ``MAX_NUM_PEOPLE``: per joint the K largest NMS peaks (equal
    values in row-major order), each as x, y, value, its L = 2 tags and its
    adjusted x and y (``+0.5``, and ``+-0.25`` toward the larger neighbour
    in x and in y).  Rows past a joint's positive peaks hold pixels of
    value 0 or below, which the threshold drops."""
    nj, h, w = det.shape
    k = MAX_NUM_PEOPLE
    maxm = F.max_pool2d(det[None], NMS_KERNEL, 1, NMS_PADDING)[0]
    peaks = (det * torch.eq(maxm, det).float()).reshape(nj, h * w)
    # a unique key a pixel: the value's bits (positive floats order as
    # their bits) above the row-major index, reversed, so equal values
    # take the first pixel
    shift = max(1, (h * w - 1).bit_length())
    bits = peaks.clamp_min(0).view(torch.int32).to(torch.int64)
    last = (1 << shift) - 1
    key = (bits << shift) | (last - torch.arange(h * w, device=det.device))
    idx = last - (key.topk(min(k, h * w), dim=1).values & last)
    val = peaks.gather(1, idx)
    x, y = idx % w, idx // w
    flat = det.reshape(nj, h * w)

    def at(yy, xx):
        return flat.gather(1, yy * w + xx)

    dx = torch.where(at(y, (x + 1).clamp_max(w - 1))
                     > at(y, (x - 1).clamp_min(0)), 0.25, -0.25)
    dy = torch.where(at((y + 1).clamp_max(h - 1), x)
                     > at((y - 1).clamp_min(0), x), 0.25, -0.25)
    tg = tags.reshape(tags.shape[0], nj, h * w)
    xf, yf = x.float(), y.float()
    return torch.stack([xf, yf, val, tg[0].gather(1, idx),
                        tg[1].gather(1, idx), xf + 0.5 + dx, yf + 0.5 + dy],
                       dim=2)


# ----------------------------------------------------------------------
# the host match
# ----------------------------------------------------------------------

def _least(c: np.ndarray):
    """A least assignment of every row of the (n, m) integer cost ``c``,
    n <= m, with its dual potentials: rows added one at a time, a
    shortest augmenting path each, in plain Python over lists (at these
    sizes, 30 columns at most, faster than a numpy step a column scan).
    Returns (column of each row, u (n,), v (m,)), lists of ints;
    ``c - u - v >= 0`` everywhere, 0 on the assignment, and v is 0 on
    every column left free."""
    n, m = c.shape
    rows = c.tolist()
    inf = 1 << 62
    u, v = [0] * (n + 1), [0] * (m + 1)
    p = [0] * (m + 1)                   # p[col] = row, 1-based; 0 free
    way = [0] * (m + 1)
    for i in range(1, n + 1):
        p[0], j0 = i, 0
        minv, used = [inf] * (m + 1), [False] * (m + 1)
        while True:
            used[j0] = True
            i0 = p[j0]
            row, ui = rows[i0 - 1], u[i0]
            delta, j1 = inf, 0
            for j in range(1, m + 1):
                if used[j]:
                    continue
                cur = row[j - 1] - ui - v[j]
                if cur < minv[j]:
                    minv[j], way[j] = cur, j0
                if minv[j] < delta:
                    delta, j1 = minv[j], j
            for j in range(m + 1):
                if used[j]:
                    u[p[j]] += delta
                    v[j] -= delta
                else:
                    minv[j] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = [0] * n
    for j in range(1, m + 1):
        if p[j]:
            col_of_row[p[j] - 1] = j - 1
    return col_of_row, u[1:], v[1:]


def assign(cost: np.ndarray, cols: int) -> np.ndarray:
    """The column of each row of a ``rows x grouped`` cost block, padded
    with ``cols - grouped`` equal columns (the source's 1e10 columns,
    ``cols >= rows``): of the assignments of least total cost, the first in
    row order (the smallest column for row 0, then row 1, ...).

    The costs are integers (``match_costs``), so every sum, and every
    potential, is exact.  The padded columns' cost does not change which
    assignments are least (each takes the same number of them), so they
    cost 0 there; rows past ``rows`` cost 0 everywhere (munkres's square
    padding).

    1. A least assignment of the real rows with its potentials
       (``_least``); the padding rows, potential 0, take the free columns,
       whose potential is 0, so the square matrix's assignment is least
       too.
    2. Its tight edges, ``c - u - v == 0``: every least assignment lies on
       them.  Row by row, the row takes its smallest tight column that an
       alternating path of tight edges through the later rows frees (a
       breadth-first search), and keeps it."""
    cost = np.asarray(cost, np.int64)
    rows, grouped = cost.shape
    if cols < rows or cols < grouped:
        raise ValueError(f"assign: a {cost.shape} block and {cols} columns")
    if rows == 0:
        return np.zeros(0, np.int64)
    c = np.zeros((cols, cols), np.int64)
    c[:rows, :grouped] = cost
    real, u, v = _least(c[:rows])
    col_of_row = real + sorted(set(range(cols)) - set(real))
    row_of_col = [0] * cols
    for r, col in enumerate(col_of_row):
        row_of_col[col] = r
    pot = np.zeros(cols, np.int64)
    pot[:rows] = u
    tight = ((c - pot[:, None] - np.asarray(v, np.int64)[None]) == 0
             ).tolist()
    taken = [False] * cols
    for i in range(rows):
        cur = col_of_row[i]
        for j in range(cur):
            if not tight[i][j] or taken[j]:
                continue
            start = row_of_col[j]           # must move off column j
            seen = taken.copy()
            seen[j] = True
            mover = {}
            queue, hit = [start], False
            while queue and not hit:
                nxt = []
                for r in queue:
                    t = tight[r]
                    for col in range(cols):
                        if not t[col] or seen[col]:
                            continue
                        seen[col] = True
                        mover[col] = r
                        if col == cur:
                            hit = True
                            break
                        nxt.append(row_of_col[col])
                    if hit:
                        break
                queue = nxt
            if not hit:
                continue
            col = cur                       # shift the path, then i -> j
            while True:
                row = mover[col]
                prev = col_of_row[row]
                col_of_row[row] = col
                row_of_col[col] = row
                if row == start:
                    break
                col = prev
            col_of_row[i] = j
            row_of_col[j] = i
            break
        taken[col_of_row[i]] = True
    return np.asarray(col_of_row[:rows], np.int64)


def match_costs(dist: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """``round(dist) * 100 - val`` (the source's cost, ``dist`` float64
    tag distances, ``vals`` the rows' float32 values) exactly, as int64:
    scaled by the power of two that makes every value whole.  Raises
    ``ValueError`` where the scaled costs would not fit (distances of
    millions)."""
    vals = np.asarray(vals, np.float64)
    _, exp = np.frexp(vals[vals != 0]) if vals.any() else (None, [0])
    shift = max(0, 24 - int(np.min(exp)))       # float32: 24 bits
    rounded = np.round(dist)
    if (rounded.max(initial=0) * 100 * 2.0 ** shift > 2.0 ** 55
            or np.abs(vals).max(initial=0) * 2.0 ** shift > 2.0 ** 55):
        raise ValueError("match_costs: tag distances or values too large "
                         "for exact int64 costs")
    q = vals * 2.0 ** shift
    return (rounded.astype(np.int64) * (100 << shift)
            - q.astype(np.int64)[:, None])


def match_by_tag(table: np.ndarray, order: Sequence[int]) -> np.ndarray:
    """``match_by_tag`` over a (J, K, 7) host table: groups (P, J, 7)
    float32 in insertion order, zero rows where a person lacks a joint.

    Joints in ``order``; a joint's candidates are its rows over
    ``DETECTION_THRESHOLD``.  The first joint that has any opens a group
    for each, keyed by its pass-0 tag (an equal key lands in that group and
    restarts its tags).  Later joints are assigned to the first
    ``MAX_NUM_PEOPLE`` groups by ``assign`` on ``round(|tag - group
    mean|) * 100 - val`` (float64; a group mean the float32 sum of its
    tags in order over their count), a
    pair joining where the distance is below ``TAG_THRESHOLD``; a row left
    over opens a group."""
    nj = table.shape[0]
    groups: dict = {}
    sums: dict = {}          # key -> [float32 sum of its tags, count]

    def open_group(key, idx, joint, tag):
        groups.setdefault(key, np.zeros((nj, TABLE_FIELDS)))[idx] = joint
        sums[key] = [np.zeros(2, np.float32) + tag, 1]

    for i, idx in enumerate(order):
        rows = table[idx].astype(np.float64)
        keep = rows[:, 2] > DETECTION_THRESHOLD
        joints = rows[keep]
        tags = table[idx][keep][:, 3:5]
        if joints.shape[0] == 0:
            continue
        if i == 0 or not groups:
            for tag, joint in zip(tags, joints):
                open_group(tag[0], idx, joint, tag)
            continue
        keys = list(groups)[:MAX_NUM_PEOPLE]
        means = np.array([(sums[k][0] / np.float32(sums[k][1])).astype(
            np.float32) for k in keys])
        dist = np.linalg.norm(joints[:, None, 3:5] - means[None], ord=2,
                              axis=2)
        added, grouped = dist.shape
        for row, col in enumerate(assign(match_costs(dist, joints[:, 2]),
                                         max(added, grouped))):
            if col < grouped and dist[row, col] < TAG_THRESHOLD:
                groups[keys[col]][idx] = joints[row]
                acc = sums[keys[col]]
                acc[0] = (acc[0] + tags[row]).astype(np.float32)
                acc[1] += 1
            else:
                open_group(tags[row][0], idx, joints[row], tags[row])
    if not groups:
        return np.zeros((0, nj, TABLE_FIELDS), np.float32)
    return np.array(list(groups.values())).astype(np.float32)


# ----------------------------------------------------------------------
# refine on the device
# ----------------------------------------------------------------------

def _scores(t0, t1, m, det):
    """``det - round(sqrt(d0 * d0 + d1 * d1))``, d the tags ``t0``, ``t1``
    minus the mean tag ``m`` (rows of 2): each step its own rounding, as
    numpy's."""
    d0 = t0 - m[:, :1]
    d0.mul_(d0)
    d1 = t1 - m[:, 1:]
    d1.mul_(d1)
    return torch.sub(det, d0.add_(d1).sqrt_().round_())


def refine_argmax_plain(flat: torch.Tensor, tg: torch.Tensor,
                        m: torch.Tensor, joints: np.ndarray) -> torch.Tensor:
    """The pixel of (J, HW) ``flat`` maximising ``_scores`` for each pair
    (joint ``joints[k]``, mean tag ``m[k]``), the first in row-major
    order: the whole map, joint by joint, ``_REFINE_CHUNK`` pairs at a
    time.  ``refine_argmax`` computes the same in one CUDA launch."""
    idx = torch.empty(len(joints), dtype=torch.int64, device=flat.device)
    for j in np.unique(joints):
        rows = np.flatnonzero(joints == j)
        for start in range(0, len(rows), _REFINE_CHUNK):
            sel = to_device(rows[start:start + _REFINE_CHUNK], flat.device)
            idx[sel] = _scores(tg[0, j][None], tg[1, j][None],
                               m.index_select(0, sel),
                               flat[j][None]).argmax(dim=1)
    return idx


def _groups(joints: np.ndarray):
    """The pairs' indices grouped by joint (stable) and the groups, (joint,
    first, count) rows of at most ``GROUP`` pairs into them."""
    order = np.argsort(joints, kind="stable")
    rows, start = [], 0
    for j, n in zip(*np.unique(joints[order], return_counts=True)):
        for first in range(start, start + n, GROUP):
            rows.append((j, first, min(GROUP, start + n - first)))
        start += n
    return order.astype(np.int32), np.asarray(rows, np.int32).reshape(-1, 3)


def refine_argmax(flat: torch.Tensor, tg: torch.Tensor, m: torch.Tensor,
                  joints: np.ndarray) -> torch.Tensor:
    """``refine_argmax_plain``'s pixels; on a card one launch of
    ``csrc/ae_refine.cu`` (``GROUP`` pairs of a joint a block, each pixel
    read once for them), counted in ``refine_argmax.launches``, its
    groups in ``refine_argmax.groups`` and its shape, (J, HW, the pairs
    of each joint), in ``refine_argmax.shapes``; on the CPU the plain
    version."""
    if flat.device.type != "cuda":
        return refine_argmax_plain(flat, tg, m, joints)
    nj, hw = flat.shape
    order, groups = _groups(joints)
    dev = flat.device
    o, g = to_device(order, dev), to_device(groups, dev)
    best = torch.zeros(len(joints), dtype=torch.int64, device=dev)
    flat, tg, m = flat.contiguous(), tg.contiguous(), m.contiguous()
    with torch.cuda.device(dev):
        lib = _refine_library()
        err = lib.ae_refine_launch(
            flat.data_ptr(), tg.data_ptr(), m.data_ptr(), g.data_ptr(),
            o.data_ptr(), best.data_ptr(), len(groups), nj, hw,
            torch.cuda.current_stream().cuda_stream)
    _cuda_build.check(lib, "ae_refine", err)
    with _counts_lock:
        refine_argmax.launches += 1
        refine_argmax.groups += len(groups)
        refine_argmax.shapes[(nj, hw, tuple(np.bincount(
            joints, minlength=nj).tolist()))] += 1
    return 0xFFFFFFFF - (best & 0xFFFFFFFF)


refine_argmax.launches = 0
refine_argmax.groups = 0
refine_argmax.shapes = collections.Counter()


@functools.lru_cache(maxsize=1)
def _refine_library():
    lib = _cuda_build.load("ae_refine")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ae_refine_launch.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.ae_refine_launch.restype = i
    return lib


def refine(det: torch.Tensor, tags: torch.Tensor, joints: np.ndarray,
           means: np.ndarray) -> torch.Tensor:
    """For each (joint ``joints[k]``, mean tag ``means[k]``): the pixel of
    (J, H, W) ``det`` that maximises ``det - round(|tag - mean|)`` over the
    (L = 2, J, H, W) ``tags`` (the first maximum in row-major order,
    ``refine_argmax``), as (K, 3) x + 0.5 +- 0.25, y + 0.5 +- 0.25, value,
    on the device."""
    nj, h, w = det.shape
    flat = det.reshape(nj, h * w)
    tg = tags.reshape(tags.shape[0], nj, h * w)
    m = to_device(np.ascontiguousarray(means, np.float32), det.device)
    jk = to_device(np.ascontiguousarray(joints, np.int64), det.device)
    idx = refine_argmax(flat, tg, m, np.asarray(joints))
    x, y = idx % w, idx // w
    everything = flat.reshape(-1)

    def at(yy, xx):
        return everything[jk * (h * w) + yy * w + xx]

    return torch.stack([
        x.float() + 0.5 + torch.where(at(y, (x + 1).clamp_max(w - 1))
                                      > at(y, (x - 1).clamp_min(0)),
                                      0.25, -0.25),
        y.float() + 0.5 + torch.where(at((y + 1).clamp_max(h - 1), x)
                                      > at((y - 1).clamp_min(0), x),
                                      0.25, -0.25),
        at(y, x)], dim=1)


# ----------------------------------------------------------------------
# one frame's host step
# ----------------------------------------------------------------------

@dataclasses.dataclass
class AEPending:
    """A frame queued up to its table: the maps (on the device), the table
    being copied to ``host`` (``ready`` recorded after the copy on a card,
    None on the CPU) and the geometry."""

    det: torch.Tensor
    tags: torch.Tensor
    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    geom: AEGeometry


def start_fetch(det: torch.Tensor, tags: torch.Tensor, table: torch.Tensor,
                geom: AEGeometry) -> AEPending:
    """Queue the table's device-to-host copy (pinned, asynchronous on a
    card) and return the pending frame."""
    if table.device.type != "cuda":
        return AEPending(det, tags, table, None, geom)
    host = torch.empty(table.shape, dtype=table.dtype, pin_memory=True)
    host.copy_(table, non_blocking=True)
    ready = torch.cuda.Event()
    ready.record()
    return AEPending(det, tags, host, ready, geom)


def person_means(groups: np.ndarray) -> np.ndarray:
    """(P, 2) float32: each person's mean tag, the float32 sum of its
    joints' tags in joint order over their count (joint by joint over
    every person at once: an absent joint adds 0)."""
    present = groups[:, :, 2] > 0
    acc = np.zeros((len(groups), 2), np.float32)
    for j in range(groups.shape[1]):
        acc = (acc + np.where(present[:, j, None], groups[:, j, 3:5],
                              np.float32(0))).astype(np.float32)
    return (acc / present.sum(axis=1, keepdims=True).astype(np.float32)
            ).astype(np.float32)


def ae_decode(pending: AEPending, order: Sequence[int]):
    """The host step of a pending frame: (persons (P, J, 3) as x, y, value
    in input pixels, adjusted and refined, zero rows where absent; scores
    (P,), the mean of each person's J values before refine)."""
    with annotate("ae.match"):
        if pending.ready is not None:
            pending.ready.synchronize()
        table = pending.host.numpy()
        groups = match_by_tag(table, order)
        present = groups[:, :, 2] > 0
        groups[:, :, 0:2] = np.where(present[..., None], groups[:, :, 5:7],
                                     groups[:, :, 0:2])
        scores = np.array([g[:, 2].mean() for g in groups], np.float32)
    refilled = 0
    with annotate("ae.refine"):
        persons, joints = np.nonzero(~present)
        if len(persons):
            means = person_means(groups)[persons]
            found = refine(pending.det, pending.tags, joints, means).cpu() \
                .numpy()
            fill = found[:, 2] > 0
            groups[persons[fill], joints[fill], 0:3] = found[fill]
            refilled = int(fill.sum())
    with _counts_lock:
        ae_decode.candidates += int((table[:, :, 2].astype(np.float64)
                                     > DETECTION_THRESHOLD).sum())
        ae_decode.persons += len(groups)
        ae_decode.refined += len(persons)
        ae_decode.refilled += refilled
    return groups[:, :, 0:3].copy(), scores


ae_decode.candidates = 0
ae_decode.persons = 0
ae_decode.refined = 0
ae_decode.refilled = 0
_counts_lock = threading.Lock()


def final_poses(persons: np.ndarray, geom: AEGeometry) -> np.ndarray:
    """(P, J, 3) input-pixel poses -> frame pixels (``get_final_preds``
    for this resize: its exact inverse); absent joints stay zero."""
    out = np.zeros(persons.shape, np.float32)
    if not len(persons):
        return out
    sx, sy = geom.scale
    present = persons[:, :, 2] > 0
    x = (persons[:, :, 0].astype(np.float64) - geom.offset[1] + 0.5) * sx \
        - 0.5
    y = (persons[:, :, 1].astype(np.float64) - geom.offset[0] + 0.5) * sy \
        - 0.5
    out[:, :, 0] = np.where(present, x, 0.0)
    out[:, :, 1] = np.where(present, y, 0.0)
    out[:, :, 2] = persons[:, :, 2]
    return out
