"""HandNet: the 21-keypoint hand network (port of
``tpupose/models/handnet.py``).

FaceNet's topology with 22 output channels (21 keypoints + background);
stages 2-6 take concat(previous heatmap, feature), 150 channels.
"""

from __future__ import annotations

from tpupose_torch.models.cpm import SingleBranchCPM

NUM_HAND_CHANNELS = 22  # 21 keypoints + background


class HandNet(SingleBranchCPM):
    """Hand keypoint network; ``forward`` returns the stacked per-stage
    heatmaps (S, B, H/8, W/8, 22)."""

    num_channels = NUM_HAND_CHANNELS
