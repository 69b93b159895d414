"""Tests of the port that need an NVIDIA GPU; they skip without one.

This file imports neither JAX nor the JAX test helpers, so it also runs on
a machine without JAX:

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

The kernel must equal its plain PyTorch version bit for bit (it rounds every
product and sum as PyTorch's eager ops do), and the detector on the card
must find the pose table the CPU finds from the same weights.
"""

import numpy as np
import pytest
import torch

from tpupose.config import InferenceConfig
from tpupose_torch.detectors.pose import PoseDetector
from tpupose_torch.ops import blur_nms as bn
from tpupose_torch.utils.calibrate import calibrate_output_convs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planted(rng, j, h, w):
    hm = rng.rand(j, h, w).astype(np.float32) * 0.3
    for c in range(j):
        for _ in range(3):
            y, x = rng.randint(2, h - 2), rng.randint(2, w - 2)
            hm[c, y, x] += rng.uniform(0.5, 1.0)
    return hm


@pytest.mark.parametrize("shape", [(18, 320, 432), (18, 46, 62), (3, 7, 9),
                                   (18, 584, 584)])
def test_blur_nms_kernel_matches_reference(cuda_device, shape):
    x = torch.from_numpy(_planted(np.random.RandomState(5), *shape)).to(
        cuda_device)
    before = bn.blur_nms.launches
    s, m = bn.blur_nms(x, 2.5, 0.05)
    rs, rm = bn.blur_nms_reference(x, 2.5, 0.05)
    torch.cuda.synchronize()
    assert bn.blur_nms.launches == before + 1
    assert torch.equal(s, rs)
    assert torch.equal(m, rm)


def test_blur_nms_rejects_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(2, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        bn.blur_nms(x.double(), 2.5, 0.05)
    with pytest.raises(ValueError, match="contiguous"):
        bn.blur_nms(x.transpose(1, 2), 2.5, 0.05)


def test_cuda_detector_matches_cpu(cuda_device):
    """Same weights on the card and the CPU: the maps agree to float32
    noise, and the card's postprocess on those maps gives the CPU's pose
    table.  (Whole pose tables from the two forwards are not compared: a
    1e-5 map difference may flip a near-threshold peak or limb.)"""
    from tpupose_torch.detectors.pose import results_to_host
    from tpupose_torch.ops.postprocess import postprocess_pose

    cfg = InferenceConfig(img_size=96, heatmap_size=88, max_subsets=128,
                          n_subset_limbs_thresh=2, subset_score_thresh=0.05)
    frame = np.random.RandomState(0).randint(0, 256, (96, 128, 3)).astype(
        np.uint8)
    cpu = PoseDetector(cfg=cfg, device="cpu", seed=0)
    assert calibrate_output_convs(cpu, frame)
    card = PoseDetector(cfg=cfg, device=cuda_device, seed=1)
    card.model.load_state_dict(cpu.model.state_dict())
    (paf, hm), _ = card.compute_maps(frame)
    (cpaf, chm), _ = cpu.compute_maps(frame)
    for got, ref in ((paf, cpaf), (hm, chm)):
        # float32 in other summation orders; TF32 would miss by ~1e-3.
        scale = ref.abs().max().item()
        assert (got.cpu() - ref).abs().max().item() <= 1e-4 * scale

    before = bn.blur_nms.launches
    with torch.no_grad():
        on_card, on_cpu = (results_to_host([postprocess_pose(
            p, h, paf.shape[-1], cfg)])[0] for p, h in ((paf, hm),
                                                         (paf.cpu(), hm.cpu())))
    assert bn.blur_nms.launches == before + 1
    for name in ("poses", "valid", "num_peaks", "peaks_dropped",
                 "spawns_suppressed"):
        np.testing.assert_array_equal(getattr(on_card, name),
                                      getattr(on_cpu, name), err_msg=name)
    np.testing.assert_allclose(on_card.scores, on_cpu.scores, atol=1e-5)
    assert on_card.valid.sum() >= 1
    poses, _ = card(frame)
    assert poses.shape[0] >= 1
