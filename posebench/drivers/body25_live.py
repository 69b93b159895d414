"""Live BODY_25 pose: ``PoseDetector(arch="body25").__call__`` on seeded
frames, a closed loop with one stream, as a camera loop that waits for
each result: ``pose_live``'s protocol on the BODY_25 net, its reference
``reference/body25.py``.

Traffic keys: ``frames`` (distinct seeded frames, cycled), ``frame_hw``,
``precision`` (``"f32"``, or ``"int8"`` after ``quantize()`` on the frames
listed in ``calib_frames``, on the route ``conv7_impl``), ``warmup`` (calls
before the window).

The program is built first, so a checkout whose port has no ``body25``
fails at once.  The seeded weights are calibrated on frame 0 in two
passes: the last PAF head to unit amplitude, then, the maps recomputed
(the heatmap stages read that PAF), the last heatmap head to about
``n_target`` peaks.
"""

from __future__ import annotations

import torch

from posebench.core import calibrate, inputs
from posebench.core.cell import Cell, Program
from posebench.reference import body25, compare, pipeline


def _detector_config(cfg: dict):
    import dataclasses

    from tpupose_torch.config import InferenceConfig

    return dataclasses.replace(
        InferenceConfig(), img_size=cfg["img_size"],
        heatmap_size=cfg["heatmap_size"], downscale=cfg["stride"],
        **cfg["inference"])


def setup(cell: Cell) -> Program:
    from tpupose_torch.detectors.pose import PoseDetector

    cfg, traffic, dev = cell.config, cell.traffic, cell.device
    clock = inputs.PhaseClock(dev)
    det = PoseDetector(cfg["arch"], cfg=_detector_config(cfg), device=dev)
    clock.mark("detector_init")
    frames = inputs.seeded_frames(cell.seed, traffic["frames"],
                                  tuple(traffic["frame_hw"]), dev)
    params = body25.seeded_params(cfg, cell.seed, dev)
    p = cfg["inference"]
    paf, hm = body25.pose_maps(cfg, params, frames[0], dev)
    _, pg = calibrate.pose_gains(paf, hm, p, **cfg["calibration"])
    calibrate.scale_conv(params, body25.head_key(cfg, cfg["paf_output"]), pg)
    paf, hm = body25.pose_maps(cfg, params, frames[0], dev)
    hg, _ = calibrate.pose_gains(paf, hm, p, **cfg["calibration"])
    calibrate.scale_conv(params, body25.head_key(cfg, cfg["heatmap_output"]),
                         hg)
    det.model.load_state_dict(params)
    clock.mark("inputs_weights_calibration")
    calib = [frames[i] for i in traffic.get("calib_frames", [])]
    if traffic["precision"] == "int8":
        det.quantize(calib, conv7_impl=traffic["conv7_impl"]
                     if torch.device(dev).type == "cuda" else None)
        clock.mark("quantize")
    for i in range(traffic["warmup"]):
        det(frames[i % len(frames)])
    clock.mark("warmup")
    in_hw, _ = pipeline.pose_geometry(cfg, frames.shape[1:3])
    holder = {"det": det}

    def free():
        holder.clear()

    return Program(call=lambda i: holder["det"](frames[i]),
                   n_inputs=len(frames), forward_hw=in_hw, forward_batch=1,
                   precision=traffic["precision"],
                   program_span="pose_fast_" if traffic["precision"] == "f32"
                   else "poseq_fast_",
                   state={"frames": frames, "params": params,
                          "calib": calib, "setup_parts": clock.parts},
                   free=free)


def expected(cell: Cell, program: Program, control: bool = False):
    """The reference's answer to each input."""
    s = program.state
    qtree = None
    if program.precision == "int8":
        qtree = body25.int8_tree(cell.config, s["params"], s["calib"],
                                 cell.device, control)
    return body25.pose_answers(cell.config, s["params"], s["frames"],
                               cell.device, qtree, control)


def numbers(answered, want) -> dict:
    """``answered``: (input index, the program's answer) per request."""
    return compare.pose_numbers(answered, want)


def diagnostics(program: Program, want) -> dict:
    """What the reference saw: the most peaks of any part in any frame,
    and persons per frame."""
    return {"most_peaks_per_joint": max(w[2] for w in want),
            "setup_parts_s": program.state["setup_parts"],
            "persons_per_frame": [len(w[0]) for w in want]}
