"""FaceNet: the 70-keypoint face network (port of
``tpupose/models/facenet.py``).

``VGGFaceStem`` to conv5_3_CPM (128 channels at stride 8), then 6
single-branch CPM stages of 71 channels (70 keypoints + background); stages
2-6 take concat(previous heatmap, feature), 199 channels.
"""

from __future__ import annotations

from tpupose_torch.models.cpm import SingleBranchCPM

NUM_FACE_CHANNELS = 71  # 70 keypoints + background


class FaceNet(SingleBranchCPM):
    """Face keypoint network; ``forward`` returns the stacked per-stage
    heatmaps (S, B, H/8, W/8, 71)."""

    num_channels = NUM_FACE_CHANNELS
