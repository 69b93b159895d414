from tpupose_torch.models.body25 import Body25Net
from tpupose_torch.models.facenet import FaceNet
from tpupose_torch.models.handnet import HandNet
from tpupose_torch.models.higherhrnet import HigherHRNetW32
from tpupose_torch.models.posenet import CocoPoseNet

# Architecture registry (mirrors ``tpupose.models.ARCHS``, plus ``body25``
# and ``higherhrnet_w32``, which the JAX package has not).  The pose nets
# carry their skeleton as ``topology`` and their decoder as ``decoder``:
# ``"paf"`` (part affinity fields) or ``"associative_embedding"``.
ARCHS = {
    "posenet": CocoPoseNet,
    "facenet": FaceNet,
    "handnet": HandNet,
    "body25": Body25Net,
    "higherhrnet_w32": HigherHRNetW32,
}
