#!/usr/bin/env python3
"""Time one tree's ``conv_s8`` on the single-group ReLU layers that
CocoPoseNet and the crop nets run, at the tile ``pick_tile`` gives each,
from CUDA-graph replays: to compare two trees' kernels on one card, run it
from each tree's root in turns within one call.

    python3 scripts/conv_s8_ab.py <label> [rounds]

Uses only the wrapper's single-group calls (a tensor input, ``packed``
and ``tile``), which every version of ``ops/conv_s8.py`` takes.  Prints
one JSON line: ms per layer, the median over ``rounds``.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

sys.path.insert(0, os.getcwd())

# (B, H, W, C, O, k): the pose net's timed layers at 368x496 and the crop
# nets' 46x46 layers
LAYERS = {"conv1_2": (1, 368, 496, 64, 64, 3),
          "conv3_2": (1, 92, 124, 256, 256, 3),
          "conv4_2": (1, 46, 62, 512, 512, 3),
          "conv4_4_CPM": (1, 46, 62, 256, 128, 3),
          "conv5_4": (1, 46, 62, 128, 512, 1),
          "Mconv6": (1, 46, 62, 128, 128, 1),
          "crop conv4_3": (1, 46, 46, 512, 512, 3),
          "crop conv5_3_CPM": (1, 46, 46, 512, 128, 3)}


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from tpupose_torch.ops import conv_s8 as cs

    label = sys.argv[1]
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    rng = np.random.RandomState(3)
    fns = {}
    for name, (b, h, w, c, o, k) in LAYERS.items():
        x, kq, mult, bias = chip_smoke._conv_s8_case(rng, b, h, w, c, o, k)
        packed = cs.pack_conv_s8_weights(kq)
        tile = cs.pick_tile(b, h, w, c, o, k)
        fns[name] = (lambda x=x, kq=kq, mult=mult, bias=bias, packed=packed,
                     tile=tile: cs.conv_s8(x, kq, mult, bias, packed=packed,
                                           tile=tile))
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(chip_smoke._graph_ms(fn, 20))
    print(json.dumps({"label": label, "ms": {
        n: statistics.median(v) for n, v in times.items()},
        "all": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
