"""The port's meshed ``PoseDetector.detect_batch`` on the CPU, over gloo
ranks: f32 and int8 on 2x1, 1x2 and 2x2 meshes against the mesh-less port
in the same process, the precise pyramid with a scale too small to split,
the refusals, and the camera app's batched loop on a mesh; then the f32
tables against the JAX package's meshed ``detect_batch`` on the same
weights.

Two rank groups (two and four ranks) run every check once; the
ranks run this file as a script, one torch thread each, without JAX.
CocoPoseNet is cut to 2 stages (``ARCHS`` patched in each process: a
6-stage net takes ~5 s to draw on one thread) with seeded weights
calibrated by ``calibrate_output_convs`` so the maps carry peaks; frames
are 64x80 at ``img_size=64``, so the network input is the frame.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import rank_main, run_ranks

STAGES = 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test processes on the machine's cores; torch's
    default pool of one thread per core in each would oversubscribe
    them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _cfg(precise=False):
    from tpupose_torch.config import InferenceConfig

    cfg = InferenceConfig(img_size=64, heatmap_size=56, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    if precise:
        # 0.125 of 64 is 8 rows: one block of 8, too few to split
        cfg = dataclasses.replace(cfg, scales=(0.125, 1.0))
    return cfg


def _frames(b=2, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (b, 64, 80, 3)).astype(np.uint8)


def _two_stage_archs():
    """Every ``PoseDetector`` of this process draws a 2-stage net, and the
    quantizer's graph of it has 2 stages."""
    from tpupose_torch import quant
    from tpupose_torch.detectors import net
    from tpupose_torch.models import CocoPoseNet

    net.ARCHS = dict(net.ARCHS, posenet=lambda seed=0, dtype=torch.float32:
                     CocoPoseNet(num_stages=STAGES, seed=seed, dtype=dtype))
    quant.ARCH_GRAPHS = dict(quant.ARCH_GRAPHS, posenet=dataclasses.replace(
        quant.ARCH_GRAPHS["posenet"], num_stages=STAGES))


def _calibrated():
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.utils.calibrate import calibrate_output_convs

    det = PoseDetector(cfg=_cfg(), device="cpu")
    assert calibrate_output_convs(det, _frames()[0])
    return det


def _twin(ref, precise=False):
    """A mesh-less detector with ``ref``'s weights."""
    from tpupose_torch.detectors.pose import PoseDetector

    det = PoseDetector(cfg=_cfg(precise), device="cpu", precise=precise)
    det.model.load_state_dict(ref.model.state_dict())
    return det


def _same_tables(a, b, score_atol=0.0) -> bool:
    """The same persons and joint coordinates, scores within
    ``score_atol``."""
    return len(a) == len(b) and all(
        np.array_equal(pa, pb) and np.allclose(sa, sb, rtol=0,
                                                atol=score_atol)
        for (pa, sa), (pb, sb) in zip(a, b))


def _run_mesh(mesh, ref, qref, precise_ref, frames):
    """The meshed detector's f32 and int8 maps and tables on ``frames``
    against the mesh-less ``ref`` (int8: ``qref``, quantized on the same
    frames in this process), and the precise pyramid's."""
    from tpupose_torch.detectors.pose import PoseDetector
    from tpupose_torch.parallel import replicate

    out = {}
    det = PoseDetector(cfg=_cfg(), device="cpu", mesh=mesh)
    det.model.load_state_dict(ref.model.state_dict())
    replicate(det.model, mesh)
    (paf, hm), _ = det.compute_maps_batch(frames)
    (rpaf, rhm), _ = ref.compute_maps_batch(frames)
    out["f32_map_err"] = max(np.abs(paf - rpaf).max(), np.abs(hm - rhm).max())
    out["maps"] = (paf, hm)
    tables = det.detect_batch(frames)
    out["f32_tables"] = tables
    # f32 convs at another batch or row extent sum in other orders: the
    # maps move by ~1e-7, which reaches the scores, not the coordinates
    out["f32_equal"] = _same_tables(tables, ref.detect_batch(frames), 1e-5)
    det.quantize(frames[:2])
    (qpaf, qhm), _ = det.compute_maps_batch(frames)
    (rqpaf, rqhm), _ = qref.compute_maps_batch(frames)
    out["int8_maps_equal"] = (np.array_equal(qpaf, rqpaf)
                              and np.array_equal(qhm, rqhm))
    out["int8_tables_equal"] = _same_tables(det.detect_batch(frames),
                                            qref.detect_batch(frames))
    pdet = PoseDetector(cfg=_cfg(True), device="cpu", mesh=mesh,
                        precise=True)
    pdet.model.load_state_dict(precise_ref.model.state_dict())
    (ppaf, phm), _ = pdet.compute_maps_batch(frames)
    (rppaf, rphm), _ = precise_ref.compute_maps_batch(frames)
    out["precise_map_err"] = max(np.abs(ppaf - rppaf).max(),
                                 np.abs(phm - rphm).max())
    out["precise_equal"] = _same_tables(pdet.detect_batch(frames),
                                        precise_ref.detect_batch(frames),
                                        1e-5)
    out["n_poses"] = [len(p) for p, _ in tables]
    return out, det


def _refusals(det):
    """The ValueErrors of a meshed f32 detector with n_data = 2."""
    msgs = []
    try:
        det.detect_batch(_frames(b=3))
    except ValueError as e:
        msgs.append(str(e))
    return msgs


def _camera(mesh, ref, frames):
    """``stream_pose_batched`` on a mesh: rank 0 reads and draws, the
    tables recorded there; batch 4 over 7 frames (a tail of 3)."""
    from tpupose_torch.apps.camera import stream_pose_batched
    from tpupose_torch.detectors.pose import PoseDetector

    det = PoseDetector(cfg=_cfg(), device="cpu", mesh=mesh)
    det.model.load_state_dict(ref.model.state_dict())
    seen = []
    lead = mesh.rank == 0
    n = stream_pose_batched(
        det, list(frames) if lead else None,
        (lambda img, poses: seen.append(poses) or img) if lead else None,
        (lambda img: None) if lead else None, batch=4, max_frames=7,
        mesh=mesh)
    want = [ref(f)[0] for f in frames[:7]] if lead else []
    return {"n": n, "equal": len(seen) == len(want) and all(
        np.array_equal(a, b) for a, b in zip(seen, want))}


def _checks(rank, world):
    from tpupose_torch.parallel import make_mesh
    from tpupose_torch.weights import flax_params_from_model

    _two_stage_archs()
    frames = _frames()
    ref = _calibrated()
    qref = _twin(ref)
    qref.quantize(frames[:2])
    precise_ref = _twin(ref, precise=True)
    out = {}
    if world == 2:
        for nd, ns in ((2, 1), (1, 2)):
            mesh = make_mesh(nd, ns, device="cpu")
            out[f"{nd}x{ns}"], det = _run_mesh(mesh, ref, qref, precise_ref,
                                               frames)
            out[f"{nd}x{ns}"].pop("maps")
            if nd == 2:
                out["refused"] = _refusals(det)
                out["camera"] = _camera(mesh, ref, _frames(b=7, seed=1))
    else:
        out["2x2"], _ = _run_mesh(make_mesh(2, 2, device="cpu"), ref, qref,
                                  precise_ref, frames)
        maps = out["2x2"].pop("maps")
        if rank == 0:
            out["params"] = flax_params_from_model(ref.model)
            out["maps"] = maps
    return out


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """The two rank groups, one after the other (fewer processes at once
    beside the other test workers)."""
    return [run_ranks(os.path.abspath(__file__), world,
                      str(tmp_path_factory.mktemp(f"detect_{world}")))
            for world in (2, 4)]


def _runs(groups, mesh):
    return [r[mesh] for r in (groups[1] if mesh == "2x2" else groups[0])]


MESHES = ["2x1", "1x2", "2x2"]


@pytest.mark.parametrize("mesh", MESHES)
def test_meshed_f32_maps_and_tables_equal_meshless(groups, mesh):
    """f32 maps within 1e-5 of the mesh-less port's (the convs on slabs
    and on a data rank's smaller batch sum in other orders), pose tables
    equal (coordinates exactly, scores within 1e-5), on every rank; the
    frames carry people."""
    for run in _runs(groups, mesh):
        assert run["f32_map_err"] <= 1e-5
        assert run["f32_equal"]
        assert sum(run["n_poses"]) >= 4


@pytest.mark.parametrize("mesh", MESHES)
def test_meshed_int8_maps_are_bit_equal(groups, mesh):
    """The int8 forward on slabs with halos (each kernel's plain version
    on the CPU) gives the mesh-less int8 maps bit for bit, and the same
    tables."""
    for run in _runs(groups, mesh):
        assert run["int8_maps_equal"]
        assert run["int8_tables_equal"]


@pytest.mark.parametrize("mesh", MESHES)
def test_meshed_precise_with_a_scale_too_small_to_split(groups, mesh):
    """The pyramid's 0.125 scale (8 rows) runs whole on every spatial
    rank, the 1.0 scale (64 rows) on slabs; maps within 1e-5 of the
    mesh-less pyramid's and the same tables (scores within 1e-5)."""
    for run in _runs(groups, mesh):
        assert run["precise_map_err"] <= 1e-5
        assert run["precise_equal"]


def test_meshed_detect_batch_refuses_a_batch_the_data_axis_splits_unevenly(
        groups):
    for res in groups[0]:
        assert len(res["refused"]) == 1
        assert "does not split over 2 data ranks" in res["refused"][0]


def test_camera_batched_loop_on_a_mesh(groups):
    """``stream_pose_batched`` on a 2x1 mesh: rank 0 reads 7 frames in
    batches of 4 (the tail of 3 padded) and broadcasts them; its drawn
    tables equal the serial ``__call__``'s; every rank counts 7 frames."""
    for r, res in enumerate(groups[0]):
        assert res["camera"]["n"] == 7
        if r == 0:
            assert res["camera"]["equal"]


def test_meshed_tables_match_jax_meshed_detect_batch(groups):
    """JAX's ``detect_batch`` on ``make_mesh(2, 2)`` (the 8 virtual CPU
    devices) with the ranks' weights: the same people, coordinates and
    scores within 5e-3 as the port's 2x2 tables; the port's 2x2 maps
    within 1e-5 x max |ref| of JAX's ``compute_maps`` (float32 convs in
    other summation orders: 9.5e-6 at a max of 5.3 when written)."""
    import jax

    from tpupose.detectors import PoseDetector as JaxPoseDetector
    from tpupose.models import CocoPoseNet as JaxCocoPoseNet
    from tpupose.parallel import make_mesh as jax_make_mesh

    from test_torch_detector import _assert_pose_tables_match

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 virtual devices")
    jdet = JaxPoseDetector("posenet", params={"params": {}}, cfg=_cfg(),
                           mesh=jax_make_mesh(2, 2))
    jdet.model = JaxCocoPoseNet(num_stages=STAGES)
    jdet.variables = {"params": groups[1][0]["params"]}
    want = jdet.detect_batch(_frames())
    paf, hm = groups[1][0]["maps"]
    for i, frame in enumerate(_frames()):
        (jpaf, jhm), _ = jdet.compute_maps(frame)
        for got, ref in ((paf[i], jpaf), (hm[i], jhm)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    got = groups[1][0]["2x2"]["f32_tables"]
    assert len(got) == len(want) == 2
    for (gp, gs), (wp, ws) in zip(got, want):
        _assert_pose_tables_match(gp, gs, np.asarray(wp), np.asarray(ws))


if __name__ == "__main__":
    rank_main(_checks)
