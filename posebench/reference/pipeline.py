"""The reference's whole paths, from the uint8 inputs to the answers.

``pose_answers``: a 480x640 frame -> the cv2-parity resize to the network
input, the float32 (or w8a8) forward, the align-corners resize of the last
stage's maps to the postprocess resolution, the numpy postprocess -> poses
in original pixels and scores, as ``PoseDetector.__call__`` returns them.

``hand_answers``: square crops and hand types -> each crop mirrored if
left and resized to the net's input, the w8a8 forward, per crop the maps
resized to the crop, un-mirrored, blurred (SciPy reflect, in float32) and
reduced to one keypoint per channel (the first maximum of the blur), as
``HandDetector.detect_batch`` returns them.

``control`` computes the same in the next precision below the
configuration's: TF32 convolutions and matmuls for float32, int4 weights
for int8.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from posebench.reference import nets, postprocess, quant
from posebench.reference.resize import (optimal_size, resize_align_corners,
                                        resize_u8_linear)


@contextlib.contextmanager
def numerics(tf32: bool = False):
    """float32 convolutions and matmuls with TF32 on or off, restored on
    exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=tf32):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.set_float32_matmul_precision(old[1])


def pose_geometry(cfg: dict, frame_hw):
    """(network input (h, w), map (h, w)) of a frame."""
    h, w = frame_hw
    in_w, in_h = optimal_size(h, w, cfg["img_size"], cfg["stride"])
    map_w, map_h = optimal_size(h, w, cfg["heatmap_size"], cfg["stride"])
    return (in_h, in_w), (map_h, map_w)


def int8_tree(cfg: dict, params, calib_u8: Sequence[np.ndarray], device,
              control: bool = False):
    """The w8a8 layers from calibration inputs of any size, each resized
    to ``img_size`` square (int4 weights for the control)."""
    s = cfg["img_size"]
    calib = np.stack([resize_u8_linear(np.asarray(c), (s, s))
                      for c in calib_u8])
    with numerics():
        return quant.build(cfg, params, calib, device, 4 if control else 8)


def _last_maps(cfg, params, x_u8: torch.Tensor, qtree, control: bool):
    """The last stage's NHWC float32 maps of uint8 (B, H, W, 3) inputs,
    one tensor per branch."""
    with torch.no_grad(), numerics(tf32=control and qtree is None):
        if qtree is None:
            x = x_u8.float() / cfg["input_scale"] - 0.5
            outs = nets.forward(cfg, params, x)[-1]
        else:
            outs = quant.forward(cfg, qtree, x_u8)
    return [o.permute(0, 2, 3, 1) for o in outs]


def pose_answers(cfg: dict, params, frames: np.ndarray, device,
                 qtree=None, control: bool = False):
    """Per frame: (poses (N, 18, 3), scores (N,), most peaks of a joint,
    original pixels per map pixel).
    ``qtree``: ``int8_tree``'s layers for the int8 path, else float32."""
    (in_h, in_w), map_hw = pose_geometry(cfg, frames.shape[1:3])
    scale = (frames.shape[2] / map_hw[1], frames.shape[1] / map_hw[0])
    out = []
    for frame in frames:
        x = torch.from_numpy(resize_u8_linear(frame, (in_w, in_h))
                             ).to(device)[None]
        paf, hm = _last_maps(cfg, params, x, qtree, control)
        with numerics():
            paf = resize_align_corners(paf, map_hw)
            hm = resize_align_corners(hm, map_hw)
        out.append(postprocess.poses(
            paf[0].permute(2, 0, 1), hm[0].permute(2, 0, 1).cpu().numpy(),
            cfg["inference"], scale))
    return out


def pose_maps(cfg: dict, params, frame: np.ndarray, device):
    """The float32 maps the postprocess of ``frame`` reads, channel-first
    numpy (PAFs, heatmaps): what the calibration scales."""
    (in_h, in_w), map_hw = pose_geometry(cfg, frame.shape[:2])
    x = torch.from_numpy(resize_u8_linear(frame, (in_w, in_h))
                         ).to(device)[None]
    paf, hm = _last_maps(cfg, params, x, None, False)
    with numerics():
        paf = resize_align_corners(paf, map_hw)
        hm = resize_align_corners(hm, map_hw)
    return (paf[0].permute(2, 0, 1).cpu().numpy(),
            hm[0].permute(2, 0, 1).cpu().numpy())


def prepare_crops(cfg: dict, crops, types) -> np.ndarray:
    s = cfg["img_size"]
    return np.stack([resize_u8_linear(
        np.ascontiguousarray(c[:, ::-1]) if t == "left" else c, (s, s))
        for c, t in zip(crops, types)])


def crop_peaks(cfg: dict, params, crops, device) -> np.ndarray:
    """Each channel's largest |value| of the float32 last-stage maps over
    unmirrored crops: what the crop calibration scales."""
    x = torch.from_numpy(prepare_crops(cfg, crops, ["right"] * len(crops))
                         ).to(device)
    (hm,) = _last_maps(cfg, params, x, None, False)
    return hm.abs().amax(dim=(0, 1, 2)).cpu().numpy()


def hand_answers(cfg: dict, params, requests, device, qtree=None,
                 control: bool = False) -> List[list]:
    """Per request (crops, types): per crop, per keypoint channel
    ``[x, y, score]`` in crop pixels, or None below the threshold."""
    p = cfg["keypoints"]
    out = []
    for crops, types in requests:
        x = torch.from_numpy(prepare_crops(cfg, crops, types)).to(device)
        (hm,) = _last_maps(cfg, params, x, qtree, control)
        answers = []
        for maps, crop, t in zip(hm, crops, types):
            with numerics():
                m = resize_align_corners(maps, crop.shape[:2])
            if t == "left":
                m = torch.flip(m, dims=(1,))
            sm = postprocess.smooth(m.permute(2, 0, 1)[:-1].cpu().numpy(),
                                    p["gaussian_sigma"])
            flat = sm.reshape(len(sm), -1)
            idx = np.argmax(flat, axis=1)      # the first maximum
            kps = []
            for c, i in enumerate(idx):
                y, xx = divmod(int(i), sm.shape[2])
                score = flat[c, i]
                kps.append([xx, y, float(score)]
                           if score > p["heatmap_peak_thresh"] else None)
            answers.append(kps)
        out.append(answers)
    return out
