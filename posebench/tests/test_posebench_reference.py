"""The reference against the port at a small size, and its controls.

The reference imports nothing of the port; here the port's model and int8
forward are run beside it on one set of seeded weights."""

import numpy as np
import pytest
import torch

from posebench.control import readings
from posebench.core import registry
from posebench.reference import nets, quant
from posebench.tests import tiny


@pytest.mark.parametrize("arch,scale", [("posenet", 255.0),
                                        ("handnet", 256.0)])
def test_forwards_equal_the_port(arch, scale):
    from tpupose_torch import quant as pq
    from tpupose_torch.models import ARCHS

    torch.set_num_threads(2)
    cfg = registry.config(arch)
    params = nets.seeded_params(cfg, tiny.SEED, "cpu")
    model = ARCHS[arch]().eval()
    model.load_state_dict(params)
    rng = np.random.RandomState(0)
    calib = rng.randint(0, 256, (2, 48, 48, 3)).astype(np.uint8)
    frame = rng.randint(0, 256, (1, 48, 64, 3)).astype(np.uint8)
    x = torch.from_numpy(frame).float() / scale - 0.5
    with torch.no_grad():
        ours = nets.forward(cfg, params, x)[-1]
        theirs = model(x)
        ranges = pq.calibrate_ranges(model, torch.from_numpy(calib).float()
                                     / scale - 0.5)
    qtree, static = pq.quantize(arch, model, ranges)
    q_theirs = pq.quant_apply(static, pq.qtree_to_device(qtree, static,
                                                         "cpu"), x, "im2col")
    q_ours = quant.forward(cfg, quant.build(cfg, params, calib, "cpu"),
                           torch.from_numpy(frame))
    last = [theirs[0][-1], theirs[1][-1]] if arch == "posenet" \
        else [theirs[-1]]
    q_last = [q_theirs[0][-1], q_theirs[1][-1]] if arch == "posenet" \
        else [q_theirs[-1]]
    for a, b, qa, qb in zip(ours, last, q_ours, q_last):
        torch.testing.assert_close(a, b.permute(0, 3, 1, 2), rtol=1e-5,
                                   atol=1e-6)
        assert torch.equal(qa, qb.permute(0, 3, 1, 2))


@pytest.mark.parametrize("name", ["posenet.live_int8",
                                  "handnet.crops8_int8"])
def test_int4_control_fails(name):
    """The int8 cells' control, int4 weights, fails a limit on the CPU at
    64 px, where the program reads within them."""
    torch.set_num_threads(2)
    cell = tiny.tiny_cell(name)
    ours, control = readings(cell, 0.5)
    limits = cell.traffic["limits"]
    assert all(ours[k] <= v for k, v in limits.items())
    assert any(control[k] > v for k, v in limits.items())


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    """The float32 cell's control, TF32 convolutions and matmuls, fails a
    limit on the card at 64 px, where the program reads within them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists only on the card")
    cell = tiny.tiny_cell("posenet.live_f32", device="cuda")
    ours, control = readings(cell, 0.5)
    limits = cell.traffic["limits"]
    assert all(ours[k] <= v for k, v in limits.items())
    assert any(control[k] > v for k, v in limits.items())
