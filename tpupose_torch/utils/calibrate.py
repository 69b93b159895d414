"""Deterministic output-conv calibration for weightless runs (port of
``tpupose/utils/calibrate.py``).

A randomly initialised CocoPoseNet emits ~1e-3-amplitude maps: no peaks,
so the data-dependent postprocess (peak tables, matching, grouping) would
run near empty.  This rescales the last stage's output convs per channel so
each blurred heatmap has ~``n_target`` above-threshold peaks and the PAF
channels have unit amplitude.  Exact and linear: the output convs have no
activation, so scaling weight and bias scales the emitted maps.
``calibrate_crop_output_conv`` does the same for the face and hand nets,
which the JAX package's module does not cover.
"""

from __future__ import annotations

import numpy as np
import torch


def calibrate_output_convs(det, img, n_target: int = 4,
                           capacity_frac: float = 0.5) -> bool:
    """Rescale ``det``'s last-stage output convs in place (posenet only).

    ``det``: a ``tpupose_torch`` PoseDetector; ``img``: the BGR uint8 frame
    whose maps (``det.compute_maps``) drive the per-channel gains.  The
    gain is capped so the ``capacity_frac * max_peaks_per_joint``-th local
    maximum stays below threshold, keeping the peak table unsaturated.
    Returns False (no-op) when the model lacks the posenet output convs."""
    from scipy.ndimage import gaussian_filter, maximum_filter

    stage = f"stage{getattr(det.model, 'num_stages', 0)}"
    try:
        l2 = getattr(getattr(det.model, f"{stage}_L2"),
                     f"Mconv7_{stage}_L2").conv
        l1 = getattr(getattr(det.model, f"{stage}_L1"),
                     f"Mconv7_{stage}_L1").conv
    except AttributeError:
        return False

    maps, _ = det.compute_maps(img)
    paf0 = maps[0].cpu().numpy()
    hm0 = maps[1].cpu().numpy()

    cfg = det.cfg
    limit = max(n_target, int(cfg.max_peaks_per_joint * capacity_frac))
    hg = np.ones(hm0.shape[0], np.float32)
    for j in range(hm0.shape[0] - 1):  # background channel stays as-is
        sm = gaussian_filter(hm0[j], sigma=cfg.gaussian_sigma)
        mx = (sm == maximum_filter(sm, size=3)) & (sm > 0)
        vals = np.sort(sm[mx])[::-1]
        n = min(n_target, len(vals))
        v = vals[n - 1] if n else 1.0
        g = cfg.heatmap_peak_thresh * 1.05 / v
        if len(vals) > limit:
            g = min(g, cfg.heatmap_peak_thresh * 0.90 / vals[limit])
        hg[j] = g
    pg = (1.0 / np.maximum(np.abs(paf0).max(axis=(1, 2)), 1e-9)
          ).astype(np.float32)

    with torch.no_grad():
        for conv, g in ((l2, hg), (l1, pg)):
            g = torch.from_numpy(g).to(conv.weight.device)
            conv.weight.mul_(g[:, None, None, None])
            conv.bias.mul_(g)
    return True


def calibrate_crop_output_conv(det, crops) -> None:
    """Rescale a face or hand detector's last-stage output conv in place,
    so a weightless crop net gives keypoints on both sides of the
    threshold (a random net's maps peak near 1e-3, far below it).

    ``det``: a ``tpupose_torch`` FaceDetector or HandDetector (float32);
    ``crops``: HWC uint8 crops.  Keypoint channel j is scaled so its
    largest value over the crops' last-stage maps becomes
    ``heatmap_peak_thresh * u_j``, the u_j spread evenly over [0.5, 4] in
    a seeded order; the background channel stays.  Exact and linear, as
    ``calibrate_output_convs``."""
    stage = f"stage{det.model.num_stages}"
    conv = getattr(getattr(det.model, stage), f"Mconv7_{stage}").conv
    maps = det.forward_maps(det.prepare_crops(crops, [False] * len(crops)))
    peak = maps[-1].abs().amax(dim=(0, 1, 2)).cpu().numpy()
    c = peak.shape[0] - 1
    u = np.linspace(0.5, 4.0, c)[np.random.RandomState(0).permutation(c)]
    gain = np.ones(peak.shape[0], np.float32)
    gain[:c] = det.cfg.heatmap_peak_thresh * u / np.maximum(peak[:c], 1e-12)
    with torch.no_grad():
        g = torch.from_numpy(gain).to(conv.weight.device)
        conv.weight.mul_(g[:, None, None, None])
        conv.bias.mul_(g)
