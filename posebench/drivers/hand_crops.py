"""Hand crops: ``HandDetector.detect_batch`` on seeded square crops, one
request (one frame's hands) at a time, a closed loop with one stream.

Traffic keys: ``frames`` (seeded frames the crops are cut from),
``requests`` (distinct requests, cycled), ``crops_per_request``,
``side_range`` (crop sides, px), ``left_share``, ``calib_crops`` (crops
``quantize()`` and the output calibration see), ``precision``,
``conv7_impl``, ``warmup_rounds`` (passes over every request before the
window, so every tail shape is warm).
"""

from __future__ import annotations

import torch

from posebench.core import calibrate, inputs
from posebench.core.cell import Cell, Program
from posebench.reference import compare, nets, pipeline


def setup(cell: Cell) -> Program:
    from tpupose_torch.config import HandConfig
    from tpupose_torch.detectors import HandDetector

    cfg, traffic, dev = cell.config, cell.traffic, cell.device
    clock = inputs.PhaseClock(dev)
    frames = inputs.seeded_frames(cell.seed, traffic["frames"],
                                  tuple(traffic["frame_hw"]), dev)
    requests, calib = inputs.crop_requests(
        cell.seed, frames, traffic["requests"], traffic["crops_per_request"],
        tuple(traffic["side_range"]), traffic["left_share"],
        traffic["calib_crops"])
    params = nets.seeded_params(cfg, cell.seed, dev)
    (out_key,) = [k for k in nets.output_convs(cfg)]
    peak = pipeline.crop_peaks(cfg, params, calib, dev)
    calibrate.scale_conv(params, out_key, calibrate.crop_gains(
        peak, cfg["keypoints"]["heatmap_peak_thresh"]))
    clock.mark("inputs_weights_calibration")

    det = HandDetector(cfg=HandConfig(img_size=cfg["img_size"],
                                      **cfg["keypoints"]), device=dev)
    det.model.load_state_dict(params)
    clock.mark("detector_init")
    if traffic["precision"] == "int8":
        det.quantize(calib, conv7_impl=traffic["conv7_impl"]
                     if torch.device(dev).type == "cuda" else None)
        clock.mark("quantize")
    for _ in range(traffic["warmup_rounds"]):
        for crops, types in requests:
            det.detect_batch(crops, types)
    clock.mark("warmup")
    holder = {"det": det}

    def call(i):
        crops, types = requests[i]
        return holder["det"].detect_batch(crops, types)

    return Program(call=call, n_inputs=len(requests),
                   forward_hw=(cfg["img_size"], cfg["img_size"]),
                   forward_batch=traffic["crops_per_request"],
                   precision=traffic["precision"], program_span=None,
                   state={"requests": requests, "params": params,
                          "calib": calib, "setup_parts": clock.parts},
                   free=holder.clear)


def expected(cell: Cell, program: Program, control: bool = False):
    s = program.state
    qtree = None
    if program.precision == "int8":
        qtree = pipeline.int8_tree(cell.config, s["params"], s["calib"],
                                   cell.device, control)
    return pipeline.hand_answers(cell.config, s["params"], s["requests"],
                                 cell.device, qtree, control)


def numbers(answered, want) -> dict:
    return compare.keypoint_numbers(answered, want)


def diagnostics(program: Program, want) -> dict:
    return {"setup_parts_s": program.state["setup_parts"],
            "keypoints_per_request": [sum(k is not None for crop in w
                                          for k in crop) for w in want]}
