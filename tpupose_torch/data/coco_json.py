"""Self-contained COCO keypoint annotation access, no pycocotools (a copy
of ``tpupose/data/coco_json.py``).

JSON index building, person-category filtering, polygon and RLE
(compressed and uncompressed) segmentation decoding.  RLE decodes through
the C++ decoder of ``tpupose_torch/native/`` (built with g++ at first use);
the numpy decoders here are its plain versions.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np


def decode_compressed_rle(rle_str: str, h: int, w: int) -> np.ndarray:
    """Decode COCO's compressed RLE string to a (h, w) uint8 mask, natively
    (``native.rle_decode_native``)."""
    from tpupose_torch.native import rle_decode_native

    return rle_decode_native(rle_str, h, w)


def rle_counts_to_mask(counts, h: int, w: int) -> np.ndarray:
    """Uncompressed RLE counts -> (h, w) uint8 mask, natively."""
    from tpupose_torch.native import rle_counts_to_mask_native

    return rle_counts_to_mask_native(counts, h, w)


def decode_compressed_rle_numpy(rle_str: str, h: int, w: int
                                ) -> np.ndarray:
    """Plain version of ``decode_compressed_rle``.

    Implements the LEB128-style char encoding used by the COCO API: each
    count is stored as a sequence of 6-bit chunks (+48 ascii offset), with
    bit 5 as the continuation flag; counts beyond the first two are deltas
    from the count two positions back.  Column-major (Fortran) pixel order.
    """
    counts: List[int] = []
    i = 0
    m = len(rle_str)
    while i < m:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(rle_str[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return rle_counts_to_mask_numpy(counts, h, w)


def rle_counts_to_mask_numpy(counts, h: int, w: int) -> np.ndarray:
    """Plain version of ``rle_counts_to_mask``."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        if val:
            flat[pos:pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((w, h)).T  # column-major


def ann_to_mask(ann: dict, h: int, w: int) -> np.ndarray:
    """Rasterize a COCO segmentation (polygons or RLE) to a (h, w) uint8
    mask — the native equivalent of ``pycocotools``' ``annToMask``."""
    seg = ann["segmentation"]
    if isinstance(seg, list):  # polygons
        import cv2

        mask = np.zeros((h, w), np.uint8)
        for poly in seg:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask
    counts = seg["counts"]
    sh, sw = seg["size"]
    if isinstance(counts, str):
        return decode_compressed_rle(counts, sh, sw)
    return rle_counts_to_mask(list(counts), sh, sw)


class CocoAnnotations:
    """Minimal person-keypoints annotation index.

    Mirrors the pycocotools calls the reference uses:
    ``getCatIds(catNms=['person'])`` / ``getImgIds`` / ``getAnnIds`` /
    ``loadAnns`` / ``loadImgs``.
    """

    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.imgs = {im["id"]: im for im in data["images"]}
        self.anns_by_img: Dict[int, List[dict]] = {}
        for ann in data.get("annotations", []):
            self.anns_by_img.setdefault(ann["image_id"], []).append(ann)

    def person_cat_id(self) -> Optional[int]:
        for cid, c in self.cats.items():
            if c.get("name") == "person":
                return cid
        return None

    def img_ids_with_person(self) -> List[int]:
        pid = self.person_cat_id()
        ids = {
            ann["image_id"]
            for anns in self.anns_by_img.values()
            for ann in anns
            if pid is None or ann.get("category_id") == pid
        }
        return sorted(ids)

    def annotations(self, img_id: int) -> List[dict]:
        return self.anns_by_img.get(img_id, [])

    def image_info(self, img_id: int) -> dict:
        return self.imgs[img_id]
