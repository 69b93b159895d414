"""Data pipeline: COCO annotations, augmentation, GT rendering on the
device, the batch loader and the synthetic dataset (port of
``tpupose/data``)."""

from tpupose_torch.data.augment import augment, resize_triple
from tpupose_torch.data.coco_json import CocoAnnotations, ann_to_mask
from tpupose_torch.data.dataset import (
    CocoPoseDataset,
    generate_ignore_masks,
    parse_annotations,
)
from tpupose_torch.data.gt import (render_heatmaps, render_heatmaps_at,
                                   render_labels, render_labels_at,
                                   render_pafs, render_pafs_at)
from tpupose_torch.data.loader import BatchLoader
from tpupose_torch.data.synthetic import SyntheticCropDataset
