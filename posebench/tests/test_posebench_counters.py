"""The operation and byte counters against hand counts, and the models'
totals."""

import pytest

from posebench.core import flops
from posebench.core import registry
from posebench.reference import nets


def test_conv7_bound_hand_count():
    # Mconv1 of a pose refine stage at 46x62: 185 channels in three groups
    b, h, w, o, groups = 1, 46, 62, 128, (38, 19, 128)
    c = 185
    ops = 2 * h * w * o * 49 * c
    n_bytes = h * w * c + 49 * c * o + 4 * o * 4 + h * w * o
    assert ops == 6_618_465_280
    want = max(n_bytes / 3.35e12, ops / 1979e12)
    assert flops.conv7_bound_s(b, h, w, groups, o) == pytest.approx(want,
                                                                    rel=1e-12)
    assert ops / 1979e12 > n_bytes / 3.35e12     # operations bound it


def test_conv_s8_bound_hand_count():
    # conv1_2 at 368x496: 64 -> 64, 3x3; bytes bound it
    b, h, w, c, o, k = 1, 368, 496, 64, 64, 3
    ops = 2 * h * w * o * 9 * c
    n_bytes = h * w * c + 9 * c * o + 8 * o + h * w * o
    assert n_bytes == 23_400_960
    want = max(n_bytes / 3.35e12, ops / 1979e12)
    assert flops.conv_s8_bound_s(b, h, w, c, o, k) == pytest.approx(
        want, rel=1e-12)
    assert n_bytes / 3.35e12 > ops / 1979e12


def test_model_totals():
    pose = registry.config("posenet")
    hand = registry.config("handnet")
    assert nets.forward_macs(pose, (368, 496)) == 183_215_400_448
    assert nets.forward_macs(hand, (368, 368)) == 103_187_671_040
    assert flops.forward_ops(hand, (368, 368), 8) == 16 * 103_187_671_040


def test_int8_layer_split():
    """The layers each kernel's roofline counts: non-head 7x7 and the
    other non-head layers; the heads stay float32."""
    pose = registry.config("posenet")
    layers = flops.int8_layers(pose, (368, 496))
    assert sum(layer.k == 7 for layer, _ in layers) == 50
    assert sum(layer.k != 7 for layer, _ in layers) == 30
    hand = registry.config("handnet")
    layers = flops.int8_layers(hand, (368, 368))
    assert sum(layer.k == 7 for layer, _ in layers) == 25
    assert sum(layer.k != 7 for layer, _ in layers) == 21


def test_param_counts():
    pose = registry.config("posenet")
    n = sum(s[0] * s[1] * s[2] * s[3] if len(s) == 4 else s[0]
            for s in nets.param_shapes(pose).values())
    assert n == 52_311_446
