"""Offline ignore-mask generation CLI (port of
``tpupose/apps/gen_masks.py``, the reference's ``gen_ignore_mask.py``).

For each COCO split, write ``ignore_mask_{split}2017/<id>.png`` masks
covering crowd regions and under-annotated persons (numpy RLE decoding).

Usage:
  python -m tpupose_torch.apps.gen_masks --coco_dir /data/coco \
      [--splits train val] [--limit N] [--vis]
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    from tpupose_torch.data import generate_ignore_masks

    p = argparse.ArgumentParser(description="Generate COCO ignore masks")
    p.add_argument("--coco_dir", required=True)
    p.add_argument("--splits", nargs="+", default=["train", "val"])
    p.add_argument("--limit", type=int, default=None,
                   help="only the first N images (debugging)")
    p.add_argument("--vis", action="store_true",
                   help="also write mask+keypoint overlay panels "
                        "(ref gen_ignore_mask.py --vis)")
    args = p.parse_args(argv)

    for split in args.splits:
        ann = os.path.join(
            args.coco_dir, "annotations",
            f"person_keypoints_{split}2017.json")
        out_dir = os.path.join(args.coco_dir, f"ignore_mask_{split}2017")
        print(f"{split}: generating masks into {out_dir} ...")
        n = generate_ignore_masks(
            ann, os.path.join(args.coco_dir, f"{split}2017"), out_dir,
            limit=args.limit,
            vis_dir=(out_dir + "_vis" if args.vis else None))
        print(f"{split}: wrote {n} masks")


if __name__ == "__main__":
    main()
