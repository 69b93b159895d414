"""Weight-conversion CLI: Caffe ``.caffemodel`` -> Chainer ``.npz`` (port of
``tpupose/apps/convert_model.py``, the reference converter's interface):

  python -m tpupose_torch.apps.convert_model {posenet,facenet,handnet} \
      pose_iter_440000.caffemodel coco_posenet.npz

with a native protobuf reader (no caffe or Chainer) and the reference's
omitted ``conv5_5_CPM_L1`` layer included (``--reference-quirk`` skips it
as the reference does).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from tpupose_torch.weights.caffe import convert_caffemodel

    p = argparse.ArgumentParser(
        description="Convert caffemodel into npz weights")
    p.add_argument("arch", choices=("posenet", "facenet", "handnet"))
    p.add_argument("caffe_file", help="caffe weights file path")
    p.add_argument("npz_file", help="output npz path")
    p.add_argument("--reference-quirk", action="store_true",
                   help="skip conv5_5_CPM_L1 exactly like the reference")
    args = p.parse_args(argv)

    print("Loading caffemodel file...")
    convert_caffemodel(args.caffe_file, args.npz_file, args.arch,
                       replicate_reference_quirk=args.reference_quirk)
    print("Done.")


if __name__ == "__main__":
    main()
