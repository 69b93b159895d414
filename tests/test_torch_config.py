"""The port's own copies of the JAX package's schema, configuration and
weight-file layer names (``tpupose_torch/config.py``,
``tpupose_torch/weights/``, the optimizer's stem layer lists) against the
originals, on the CPU."""

import dataclasses
import warnings

import numpy as np
import pytest
from torch import nn

import tpupose.config as jcfg
from tpupose.weights import chainer_npz as jnpz
from tpupose_torch import config as tcfg
from tpupose_torch import weights as tw
from tpupose_torch.models.posenet import CocoPoseNet


def test_inference_config_equals_jax_field_by_field():
    jfields = [f.name for f in dataclasses.fields(jcfg.InferenceConfig)]
    tfields = [f.name for f in dataclasses.fields(tcfg.InferenceConfig)]
    assert tfields == jfields
    for name in jfields:
        assert getattr(tcfg.INFERENCE, name) == getattr(jcfg.INFERENCE,
                                                        name), name


def test_skeleton_and_limbs_equal_jax():
    assert tcfg.NUM_JOINTS == jcfg.NUM_JOINTS == 18
    assert ({j.name: int(j) for j in tcfg.JointType}
            == {j.name: int(j) for j in jcfg.JointType})
    assert tcfg.LIMBS == jcfg.LIMBS
    for name in ("LIMBS_FROM", "LIMBS_TO"):
        got, ref = getattr(tcfg, name), getattr(jcfg, name)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
    assert tcfg.NON_SPAWNING_LIMBS == jcfg.NON_SPAWNING_LIMBS


def _cocoposenet_layers():
    model = CocoPoseNet(num_stages=6)
    return [(name.split(".")[-2], name)
            for name, m in model.named_modules() if isinstance(m, nn.Conv2d)]


def test_layer_to_path_equals_jax_on_every_cocoposenet_layer():
    layers = _cocoposenet_layers()
    assert len(layers) == 92
    for layer, module_name in layers:
        got = tw.layer_to_path(layer)
        assert got == jnpz.layer_to_path(layer), layer
        assert f"{got[0]}.{got[1]}.conv" == module_name


@pytest.mark.parametrize("report, warns", [
    ({"missing": ["conv5_5_CPM_L1/W", "conv5_5_CPM_L1/b"], "unused": []},
     False),
    ({"missing": ["conv1_1/W"], "unused": []}, True),
    ({"missing": [], "unused": ["extra/W"]}, True),
], ids=["documented_omission", "missing", "unused"])
def test_warn_on_load_report_warns_as_jax(report, warns):
    assert tw.EXPECTED_MISSING == jnpz.EXPECTED_MISSING
    for fn in (tw.warn_on_load_report, jnpz.warn_on_load_report):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            fn(report, "weights.npz")
        assert len(seen) == int(warns)
        if warns:
            assert issubclass(seen[0].category, RuntimeWarning)
            assert "does not fully match the posenet model" in str(
                seen[0].message)


@pytest.mark.parametrize("name", ["FaceConfig", "HandConfig"])
def test_crop_configs_equal_jax_field_by_field(name):
    jcls, tcls = getattr(jcfg, name), getattr(tcfg, name)
    jfields = [f.name for f in dataclasses.fields(jcls)]
    assert [f.name for f in dataclasses.fields(tcls)] == jfields
    single = {"FaceConfig": "FACE", "HandConfig": "HAND"}[name]
    for field in jfields:
        assert (getattr(getattr(tcfg, single), field)
                == getattr(getattr(jcfg, single), field)), field


def test_drawing_topologies_and_limb_count_equal_jax():
    assert tcfg.FACE_LINES == jcfg.FACE_LINES
    assert tcfg.FINGER_LINES == jcfg.FINGER_LINES
    assert tcfg.NUM_LIMBS == jcfg.NUM_LIMBS == 19


@pytest.mark.parametrize("arch", ["facenet", "handnet"])
def test_layer_to_path_equals_jax_on_every_crop_net_layer(arch):
    from tpupose_torch.models import ARCHS

    layers = [(name.split(".")[-2], name)
              for name, m in ARCHS[arch]().named_modules()
              if isinstance(m, nn.Conv2d)]
    assert len(layers) == 15 + 2 + 5 * 7
    for layer, module_name in layers:
        got = tw.layer_to_path(layer)
        assert got == jnpz.layer_to_path(layer), layer
        assert f"{got[0]}.{got[1]}.conv" == module_name


def test_train_config_equals_jax_field_by_field():
    jfields = [f.name for f in dataclasses.fields(jcfg.TrainConfig)]
    assert [f.name for f in dataclasses.fields(tcfg.TrainConfig)] == jfields
    for name in jfields:
        assert getattr(tcfg.TRAIN, name) == getattr(jcfg.TRAIN, name), name


def test_coco_joint_order_and_flip_pairs_equal_jax():
    assert tcfg.COCO_JOINT_ORDER == jcfg.COCO_JOINT_ORDER
    assert len(tcfg.COCO_JOINT_ORDER) == 17
    assert tcfg.FLIP_PAIRS == jcfg.FLIP_PAIRS


def test_stem_layer_lists_equal_jax():
    from tpupose.train import optimizer as jopt
    from tpupose_torch.train import optimizer as topt

    assert topt.GRAD_SCALE_LAYERS == jopt.GRAD_SCALE_LAYERS
    assert topt.FREEZE_LAYERS == jopt.FREEZE_LAYERS
