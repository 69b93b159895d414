"""A plain reference of OpenPose's BODY_25 for the CPU tests: its layer
table, float32 forward, w8a8 int8 emulation and 25-part pose postprocess,
in plain PyTorch and numpy.  It imports nothing of ``jax``, ``tpupose`` or
``tpupose_torch``: the tests hand it the port's ``state_dict`` (the
prototxt's layer names, ``stem.conv4_3_CPM.conv.weight``,
``stem.conv4_3_CPM.prelu.weight``) and compare.

The net (``pose_deploy.prototxt`` of ``models/pose/body_25``; Cao et al.,
TPAMI 2019, Fig. 3): the VGG-19 stem with ReLU, ``conv4_3_CPM`` and
``conv4_4_CPM`` with PReLU; then 4 PAF stages (52 channels, 26 pairs) and
2 heatmap stages (26 channels, 25 parts and the background), each 5 dense
blocks of three 3x3 PReLU convs (the block's output ``[_0, _1, _2]``), a
1x1 PReLU ``Mconv6`` and a 1x1 head ``Mconv7``.

The int8 scheme: symmetric per-output-channel int8 weights; activations
``v = a * X`` with ``a = max|v| / 127`` over a calibration forward; the
image as ``X = u8 - 128``; every concat member a group at its own scale;
the heads float32, quantized at their own scale (into [-128, 127]) where a
later stage reads them.  A layer's epilogue: ``y = sum_g acc_g * mult_g +
bias`` in float32, in group order; ReLU stores ``clip(round(max(y, 0)),
0, 127)``, PReLU ``clip(round(y < 0 ? y * slope : y), -127, 127)``.
Integer sums are float64 convolutions of integer values, exact.

The postprocess is the original algorithm: a SciPy-reflect Gaussian blur
in float32, peaks above the threshold and their 4 neighbours, the first K
of each part in row-major order; each pair's candidates scored by the PAF
at ``n_integ_points`` samples with a length prior; greedy one-to-one
matching by score; the subset fold with its merge quirk; the final filter.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

STEM = [("conv1_1", 3, 64, "relu"), ("conv1_2", 64, 64, "relu"),
        ("conv2_1", 64, 128, "relu"), ("conv2_2", 128, 128, "relu"),
        ("conv3_1", 128, 256, "relu"), ("conv3_2", 256, 256, "relu"),
        ("conv3_3", 256, 256, "relu"), ("conv3_4", 256, 256, "relu"),
        ("conv4_1", 256, 512, "relu"), ("conv4_2", 512, 512, "relu"),
        ("conv4_3_CPM", 512, 256, "prelu"),
        ("conv4_4_CPM", 256, 128, "prelu")]
POOL_AFTER = ("conv1_2", "conv2_2", "conv3_4")
# (module, width, Mconv6 width, out channels, inputs after the feature)
STAGES = [("stage0_L2", 96, 256, 52, ()),
          ("stage1_L2", 128, 512, 52, ("stage0_L2",)),
          ("stage2_L2", 128, 512, 52, ("stage1_L2",)),
          ("stage3_L2", 128, 512, 52, ("stage2_L2",)),
          ("stage0_L1", 96, 256, 26, ("stage3_L2",)),
          ("stage1_L1", 128, 512, 26, ("stage0_L1", "stage3_L2"))]
NUM_PARTS = 25
PAIRS = ((1, 8), (1, 2), (1, 5), (2, 3), (3, 4), (5, 6), (6, 7), (8, 9),
         (9, 10), (10, 11), (8, 12), (12, 13), (13, 14), (1, 0), (0, 15),
         (15, 17), (0, 16), (16, 18), (2, 17), (5, 18), (14, 19), (19, 20),
         (14, 21), (11, 22), (22, 23), (11, 24))
NON_SPAWNING = (18, 19)     # 2-17 and 5-18, the shoulder-ear pairs
_EPS = 1e-12


def layer_table() -> List[Tuple[str, str, Tuple[str, ...], Tuple[int, ...],
                                int, int, str]]:
    """Every conv in forward order: (module, name, input tensors, their
    channels, out channels, k, activation "relu" / "prelu" / "none")."""
    layers, prev, prev_c = [], "image", 3
    for name, cin, cout, act in STEM:
        layers.append(("stem", name, (prev,), (cin,), cout, 3, act))
        prev, prev_c = f"stem/{name}", cout
    outs = {m: o for m, _, _, o, _ in STAGES}
    for module, width, mid, out, inputs in STAGES:
        t = module[len("stage"):]
        groups, cin = (prev,) + inputs, (prev_c,) + tuple(outs[p]
                                                          for p in inputs)
        for i in range(1, 6):
            block = []
            for j in range(3):
                name = f"Mconv{i}_stage{t}_{j}"
                g, c = (groups, cin) if j == 0 else ((block[-1],), (width,))
                layers.append((module, name, g, c, width, 3, "prelu"))
                block.append(f"{module}/{name}")
            groups, cin = tuple(block), (width,) * 3
        layers.append((module, f"Mconv6_stage{t}", groups, cin, mid, 1,
                       "prelu"))
        layers.append((module, f"Mconv7_stage{t}",
                       (f"{module}/Mconv6_stage{t}",), (mid,), out, 1,
                       "none"))
    return layers


def forward(params: Dict[str, torch.Tensor], x: torch.Tensor, hook=None):
    """x: (B, H, W, 3) normalized -> (PAF stages, heatmap stages), lists of
    NCHW float32 tensors.  ``hook(path, y)`` sees each layer's output after
    its activation (before a pool) and each stage's head under its
    module."""
    t = {"image": x.permute(0, 3, 1, 2).contiguous()}
    pafs, hms = [], []
    for module, name, groups, _, _, k, act in layer_table():
        key = f"{module}.{name}"
        y = F.conv2d(torch.cat([t[g] for g in groups], 1),
                     params[f"{key}.conv.weight"], params[f"{key}.conv.bias"],
                     padding=k // 2)
        if act == "relu":
            y = F.relu(y)
        elif act == "prelu":
            slope = params[f"{key}.prelu.weight"]
            y = torch.where(y < 0, y * slope[:, None, None], y)
        path = f"{module}/{name}"
        if hook is not None:
            hook(path, y)
        t[path] = F.max_pool2d(y, 2, 2) if name in POOL_AFTER else y
        if act == "none":
            t[module] = y
            if hook is not None:
                hook(module, y)
            (pafs if module.endswith("_L2") else hms).append(y)
    return pafs, hms


def calibration_ranges(params, frames_norm: torch.Tensor) -> Dict[str, float]:
    """``path -> max|value|`` over the float32 forward of each (H, W, 3)
    normalized frame."""
    ranges: Dict[str, float] = {}
    with torch.no_grad():
        for frame in frames_norm:
            forward(params, frame[None], hook=lambda p, y: ranges.__setitem__(
                p, max(ranges.get(p, 0.0), float(y.abs().amax()))))
    return ranges


def quantize(params, ranges: Dict[str, float]):
    """``{path: (int8 HWIO kernels per group, float32 mults, bias,
    slopes)}`` in numpy."""
    host = {k: v.detach().float().numpy() for k, v in params.items()}

    def a_of(path):
        return max(ranges[path], _EPS) / 127.0

    scales = {"image": (1.0 / 255.0, 0.5)}
    layers = {}
    for module, name, groups, cin, _, _, act in layer_table():
        key, path = f"{module}.{name}", f"{module}/{name}"
        kernel = host[f"{key}.conv.weight"].transpose(2, 3, 1, 0)
        bias = host[f"{key}.conv.bias"]
        a_out = None if act == "none" else a_of(path)
        bias_eff = (bias if a_out is None else bias / a_out).astype(
            np.float64)
        kqs, mults, start = [], [], 0
        for g, n in zip(groups, cin):
            a_in, z_in = scales[g] if g in scales else (a_of(g), 0.0)
            part = kernel[:, :, start:start + n, :]
            start += n
            ws = np.maximum(np.abs(part).reshape(-1, part.shape[-1])
                            .max(axis=0), _EPS) / 127.0
            kq = np.clip(np.round(part / ws), -127, 127).astype(np.int8)
            ws = ws.astype(np.float32)
            s_o = kq.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.float64)
            mult = a_in * ws if a_out is None else a_in * ws / a_out
            bias_eff = bias_eff + z_in * s_o * mult
            kqs.append(kq)
            mults.append(mult.astype(np.float32))
        layers[path] = (kqs, mults, bias_eff.astype(np.float32),
                        host.get(f"{key}.prelu.weight"))
        if a_out is not None:
            scales[path] = (a_out, 0.0)
    return layers


def int8_forward(layers, ranges: Dict[str, float], x: torch.Tensor):
    """x: (B, H, W, 3) normalized (``u8 / 255 - 0.5``) -> (PAF heads,
    heatmap heads), lists of NCHW float32, as the w8a8 forward gives them."""
    xq = torch.clamp(torch.round(x / (1.0 / 255.0) - 0.5), -128.0, 127.0)
    t = {"image": xq.permute(0, 3, 1, 2).contiguous().double()}
    heads, pafs, hms = {}, [], []
    for module, name, groups, _, _, k, act in layer_table():
        path = f"{module}/{name}"
        kqs, mults, bias, slope = layers[path]
        parts = []
        for g in groups:
            if g in t:
                parts.append(t[g])
            else:
                a = torch.tensor([max(ranges[g], _EPS) / 127.0],
                                 dtype=torch.float32)
                parts.append(torch.clamp(torch.round(heads[g] / a), -128.0,
                                         127.0).double())
        y = None
        for p, kq, m in zip(parts, kqs, mults):
            kernel = torch.from_numpy(np.ascontiguousarray(
                kq.transpose(3, 2, 0, 1))).double()
            acc = F.conv2d(p, kernel, padding=k // 2).float()
            part = acc * torch.from_numpy(m)[:, None, None]
            y = part if y is None else y + part
        y = y + torch.from_numpy(bias)[:, None, None]
        if act == "none":
            heads[module] = y
            (pafs if module.endswith("_L2") else hms).append(y)
            continue
        if act == "relu":
            y = torch.clamp(torch.round(torch.clamp_min(y, 0.0)), 0.0, 127.0)
        else:
            y = torch.where(y < 0, y * torch.from_numpy(slope)[:, None, None],
                            y)
            y = torch.clamp(torch.round(y), -127.0, 127.0)
        y = y.double()
        t[path] = F.max_pool2d(y, 2, 2) if name in POOL_AFTER else y
    return pafs, hms


# ---------------------------------------------------------------------------
# The postprocess over the 25 parts and 26 pairs
# ---------------------------------------------------------------------------


def smooth(maps: np.ndarray, sigma: float) -> np.ndarray:
    """(..., H, W) float32 -> SciPy-reflect Gaussian blur (truncate 4):
    rows, then columns, each ``x0 * w0`` then ``acc + xk * wk`` in tap
    order, in float32."""
    radius = int(4.0 * sigma + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * (xs / sigma) ** 2)
    taps = (phi / phi.sum()).astype(np.float32)
    x = maps.astype(np.float32)
    h, w = x.shape[-2:]
    xp = x[..., np.pad(np.arange(h), radius, mode="symmetric"), :]
    acc = xp[..., 0:h, :] * taps[0]
    for k in range(1, len(taps)):
        acc = acc + xp[..., k:k + h, :] * taps[k]
    yp = acc[..., np.pad(np.arange(w), radius, mode="symmetric")]
    out = yp[..., 0:w] * taps[0]
    for k in range(1, len(taps)):
        out = out + yp[..., k:k + w] * taps[k]
    return out


def find_peaks(heatmaps: np.ndarray, p):
    """(25, H, W) float32 -> per part a list of (x, y, score), row-major,
    at most ``max_peaks_per_joint``."""
    s = smooth(heatmaps, p.gaussian_sigma)
    zero = np.zeros_like(s[:, :1, :])
    up = np.concatenate([zero, s[:, :-1, :]], 1)
    down = np.concatenate([s[:, 1:, :], zero], 1)
    zero = np.zeros_like(s[:, :, :1])
    left = np.concatenate([zero, s[:, :, :-1]], 2)
    right = np.concatenate([s[:, :, 1:], zero], 2)
    mask = ((s > p.heatmap_peak_thresh) & (s > up) & (s > down)
            & (s > left) & (s > right))
    out = []
    for j in range(s.shape[0]):
        ys, xs = np.nonzero(mask[j])
        out.append([(int(x), int(y), s[j, y, x]) for y, x
                    in list(zip(ys, xs))[:p.max_peaks_per_joint]])
    return out


def candidate_scores(pafs: torch.Tensor, peaks, img_len: float, p):
    """Every pair's (score, valid) (26, K, K), rows its part-a peaks, in
    float32 torch ops.  pafs: (52, H, W)."""
    k = p.max_peaks_per_joint
    h, w = pafs.shape[-2:]
    table = np.zeros((3, NUM_PARTS, k), np.float32)
    for j, plist in enumerate(peaks):
        for i, (x, y, _) in enumerate(plist):
            table[:, j, i] = (x, y, 1.0)
    table = torch.from_numpy(table)
    ia = torch.tensor([a for a, _ in PAIRS])
    ib = torch.tensor([b for _, b in PAIRS])
    ax, ay, av = (t.index_select(0, ia) for t in table)
    bx, by, bv = (t.index_select(0, ib) for t in table)
    rows = pafs.reshape(len(PAIRS), 2, -1).transpose(-1, -2)
    n_pts = p.n_integ_points
    vx = bx[:, None, :] - ax[:, :, None]
    vy = by[:, None, :] - ay[:, :, None]
    norm = torch.sqrt(vx * vx + vy * vy)
    nonzero = norm > 0
    safe = torch.where(nonzero, norm, torch.ones_like(norm))
    ux, uy = vx / safe, vy / safe
    t = torch.linspace(0.0, 1.0, n_pts)
    xi = torch.round(ax[:, :, None, None] + vx[..., None] * t).long().clamp(
        0, w - 1)
    yi = torch.round(ay[:, :, None, None] + vy[..., None] * t).long().clamp(
        0, h - 1)
    got = torch.gather(rows, 1, (yi * w + xi).reshape(len(PAIRS), -1)[
        ..., None].expand(-1, -1, 2)).reshape(len(PAIRS), k, k, n_pts, 2)
    inner = got[..., 0] * ux[..., None] + got[..., 1] * uy[..., None]
    score = inner.mean(dim=-1) + torch.clamp(
        p.limb_length_ratio * img_len / safe - p.length_penalty_value,
        max=0.0)
    valid = (nonzero
             & ((inner > p.inner_product_thresh).sum(-1)
                > p.n_integ_points_thresh)
             & (score > 0.0) & (av[:, :, None] > 0) & (bv[:, None, :] > 0))
    return score.numpy(), valid.numpy()


def connections(score, valid, peaks):
    """Per pair, the accepted (a, b, score) in greedy order: candidates by
    descending score, ties in a-major order, used endpoints skipped, until
    ``min(n_a, n_b)`` are taken."""
    out = []
    for pair, (ja, jb) in enumerate(PAIRS):
        ia, ib = np.nonzero(valid[pair])
        cands = sorted(zip(ia.tolist(), ib.tolist(),
                           score[pair][ia, ib].tolist()),
                       key=lambda c: c[2], reverse=True)
        conns, used_a, used_b = [], set(), set()
        for a, b, s in cands:
            if len(conns) >= min(len(peaks[ja]), len(peaks[jb])):
                break
            if a not in used_a and b not in used_b:
                conns.append((a, b, np.float32(s)))
                used_a.add(a)
                used_b.add(b)
        out.append(conns)
    return out


def group(conns, peak_scores: np.ndarray, p):
    """The subset fold in float32 (the original's merge adds the
    connection score to the count); the subsets past the final filter."""
    subsets = []
    for pair, pair_conns in enumerate(conns):
        ja, jb = PAIRS[pair]
        for ia, ib, conn in pair_conns:
            found = [i for i, s in enumerate(subsets)
                     if s["j"][ja] == ia or s["j"][jb] == ib]
            if len(found) == 1:
                s = subsets[found[0]]
                if s["j"][jb] != ib:
                    s["j"][jb] = ib
                    s["count"] += np.float32(1)
                    s["score"] += peak_scores[jb, ib] + conn
            elif len(found) == 2:
                s1, s2 = subsets[found[0]], subsets[found[1]]
                if not np.any((s1["j"] >= 0) & (s2["j"] >= 0)):
                    s1["j"] = s1["j"] + s2["j"] + 1
                    s1["score"] += s2["score"] + conn
                    s1["count"] += s2["count"] + conn
                    del subsets[found[1]]
                else:
                    for s in (s1, s2):
                        if s["j"][ja] == -1:
                            s["j"][ja] = ia
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[ja, ia] + conn
                        elif s["j"][jb] == -1:
                            s["j"][jb] = ib
                            s["count"] += np.float32(1)
                            s["score"] += peak_scores[jb, ib] + conn
            elif not found and pair not in NON_SPAWNING:
                j = -np.ones(NUM_PARTS, np.int64)
                j[ja], j[jb] = ia, ib
                subsets.append({"j": j, "count": np.float32(2),
                                "score": (peak_scores[ja, ia]
                                          + peak_scores[jb, ib] + conn)})
    thresh = np.float32(p.subset_score_thresh)
    return [s for s in subsets if s["count"] >= p.n_subset_limbs_thresh
            and s["score"] / s["count"] >= thresh]


def poses(pafs: torch.Tensor, heatmaps: np.ndarray, p,
          scale: Tuple[float, float] = (1.0, 1.0)):
    """Maps at postprocess resolution, PAFs (52, H, W) and heatmaps
    (26, H, W) float32 -> (poses (N, 25, 3) of (x, y, 2), scores (N,)),
    ``scale`` being original pixels per map pixel."""
    peaks = find_peaks(heatmaps[:-1], p)
    peak_scores = np.zeros((NUM_PARTS, p.max_peaks_per_joint), np.float32)
    for j, plist in enumerate(peaks):
        for i, (_, _, s) in enumerate(plist):
            peak_scores[j, i] = s
    score, valid = candidate_scores(pafs, peaks, float(pafs.shape[-1]), p)
    subsets = group(connections(score, valid, peaks), peak_scores, p)
    out = np.zeros((len(subsets), NUM_PARTS, 3))
    for n, s in enumerate(subsets):
        for j in range(NUM_PARTS):
            if s["j"][j] >= 0:
                x, y, _ = peaks[j][s["j"][j]]
                out[n, j] = (x * scale[0], y * scale[1], 2)
    return out, np.asarray([s["score"] for s in subsets], np.float32)
