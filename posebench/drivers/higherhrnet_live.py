"""Live HigherHRNet-W32 pose: ``PoseDetector(arch="higherhrnet_w32")
.__call__`` on seeded frames, a closed loop with one stream, as a camera
loop that waits for each result: ``pose_live``'s protocol on the
associative-embedding net, its reference ``reference/higherhrnet.py``.

Traffic keys: ``frames`` (distinct seeded frames, cycled), ``frame_hw``,
``precision`` (``"f32"``: the port's float32 route, TF32 off),
``warmup`` (calls before the window).

The program is built first, so a checkout whose port has no
``higherhrnet_w32`` fails at once.  The seeded weights and BN statistics
are calibrated on the run's frames (``higherhrnet.calibrate``: the heads
shifted and scaled in three steps) and loaded into the program, which
folds each BN into its conv.  A request runs both passes of the flip
test: one forward of batch 2.
"""

from __future__ import annotations

from posebench.core import inputs
from posebench.core.cell import Cell, Program
from posebench.reference import compare, higherhrnet


def _detector_config(cfg: dict):
    """The program's decoder setting: the input size (the ``test``
    values of the configuration are the program's constants)."""
    from tpupose_torch.ops.ae_decode import AEConfig

    return AEConfig(input_size=cfg["input_size"])


def _counts() -> dict:
    from tpupose_torch.ops.ae_decode import ae_decode, refine_argmax

    return {"candidates": ae_decode.candidates, "persons": ae_decode.persons,
            "refined": ae_decode.refined, "refilled": ae_decode.refilled,
            "refine_groups": refine_argmax.groups}


def setup(cell: Cell) -> Program:
    from tpupose_torch.detectors.pose import PoseDetector

    cfg, traffic, dev = cell.config, cell.traffic, cell.device
    if traffic["precision"] != "f32":
        raise ValueError("higherhrnet_live runs the float32 route only")
    clock = inputs.PhaseClock(dev)
    det = PoseDetector(cfg["arch"], cfg=_detector_config(cfg), device=dev)
    clock.mark("detector_init")
    frames = inputs.seeded_frames(cell.seed, traffic["frames"],
                                  tuple(traffic["frame_hw"]), dev)
    params = higherhrnet.seeded_params(cfg, cell.seed, dev)
    higherhrnet.calibrate(cfg, params, frames, dev)
    det.model.load_state_dict(params)
    clock.mark("inputs_weights_calibration")
    for i in range(traffic["warmup"]):
        det(frames[i % len(frames)])
    clock.mark("warmup")
    geom = higherhrnet.geometry(cfg, frames.shape[1:3])
    holder = {"det": det}
    calls = [0]
    before = _counts()

    def call(i):
        calls[0] += 1
        return holder["det"](frames[i])

    def per_request():
        """The decode's counters a request since set-up."""
        now = _counts()
        return {k: (now[k] - before[k]) / max(1, calls[0]) for k in now}

    def free():
        holder.clear()

    return Program(call=call, n_inputs=len(frames), forward_hw=geom.in_hw,
                   forward_batch=2, precision="f32",
                   program_span="pose_fast_",
                   state={"frames": frames, "params": params,
                          "setup_parts": clock.parts,
                          "per_request": per_request},
                   free=free)


def expected(cell: Cell, program: Program, control: bool = False):
    """The reference's answer to each input; ``control``: its forward
    with TF32 convolutions and matmuls."""
    s = program.state
    return higherhrnet.pose_answers(cell.config, s["params"], s["frames"],
                                    cell.device, control)


def numbers(answered, want) -> dict:
    """``answered``: (input index, the program's answer) per request."""
    return compare.pose_numbers(answered, want)


def diagnostics(program: Program, want) -> dict:
    """What the reference saw (the most candidates of a joint in any
    frame, persons a frame) and the program's decode counters a request
    since set-up (candidates over the threshold, persons, pairs refine
    scored and filled, refine kernel groups)."""
    s = program.state
    return {"most_candidates_per_joint": max(w[2] for w in want),
            "setup_parts_s": s["setup_parts"],
            "persons_per_frame": [len(w[0]) for w in want],
            "ae_decode_per_request": s["per_request"]()}
