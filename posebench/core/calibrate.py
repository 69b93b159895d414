"""Output-conv calibration of seeded random weights, frozen from
``tpupose_torch/utils/calibrate.py`` so that the yardstick does not move
with the program (its SciPy blur and 3x3 maximum filter restated in numpy,
which spares the run SciPy's import).  It runs on the reference's maps and
scales the weights that both sides are then given.

A random CPM net's maps peak near 1e-3, far below the detectors'
thresholds, so the postprocess would run on nothing.  The output convs have
no activation, so scaling a channel's weights and bias scales its map.
"""

from __future__ import annotations

import numpy as np
import torch

from posebench.reference.postprocess import smooth


def _local_max(x: np.ndarray) -> np.ndarray:
    """``x == scipy.ndimage.maximum_filter(x, size=3)``: each pixel against
    its 3x3 neighbourhood, the border mirrored."""
    h, w = x.shape
    xp = np.pad(x, 1, mode="symmetric")
    top = np.max([xp[dy:dy + h, dx:dx + w] for dy in range(3)
                  for dx in range(3)], axis=0)
    return x == top


def pose_gains(paf: np.ndarray, hm: np.ndarray, p: dict, n_target: int,
               capacity_frac: float):
    """Per-channel gains of the heatmap and PAF output convs from one
    frame's maps (channel-first, at postprocess resolution): each blurred
    heatmap gets about ``n_target`` peaks above the threshold, capped so the
    ``capacity_frac * max_peaks_per_joint``-th local maximum stays below
    it; each PAF channel unit amplitude.  The background keeps gain 1."""
    thresh = p["heatmap_peak_thresh"]
    limit = max(n_target, int(p["max_peaks_per_joint"] * capacity_frac))
    hg = np.ones(hm.shape[0], np.float32)
    for j in range(hm.shape[0] - 1):
        sm = smooth(hm[j], p["gaussian_sigma"])
        mx = _local_max(sm) & (sm > 0)
        vals = np.sort(sm[mx])[::-1]
        n = min(n_target, len(vals))
        g = thresh * 1.05 / (vals[n - 1] if n else 1.0)
        if len(vals) > limit:
            g = min(g, thresh * 0.90 / vals[limit])
        hg[j] = g
    pg = (1.0 / np.maximum(np.abs(paf).max(axis=(1, 2)), 1e-9)
          ).astype(np.float32)
    return hg, pg


def crop_gains(peak: np.ndarray, thresh: float) -> np.ndarray:
    """Gains of a crop net's output conv from each channel's largest value
    over the calibration crops: keypoint channel j peaks at ``thresh *
    u_j``, the u_j spread over [0.5, 4] in a fixed order; the background
    keeps gain 1."""
    c = peak.shape[0] - 1
    u = np.linspace(0.5, 4.0, c)[np.random.RandomState(0).permutation(c)]
    gain = np.ones(peak.shape[0], np.float32)
    gain[:c] = thresh * u / np.maximum(peak[:c], 1e-12)
    return gain


def scale_conv(params: dict, key: str, gain: np.ndarray) -> None:
    """Scale conv ``key``'s output channels in place."""
    g = torch.from_numpy(gain).to(params[f"{key}.weight"].device)
    params[f"{key}.weight"].mul_(g[:, None, None, None])
    params[f"{key}.bias"].mul_(g)
