from tpupose_torch.models.facenet import FaceNet
from tpupose_torch.models.handnet import HandNet
from tpupose_torch.models.posenet import CocoPoseNet

# Architecture registry (mirrors ``tpupose.models.ARCHS``).
ARCHS = {
    "posenet": CocoPoseNet,
    "facenet": FaceNet,
    "handnet": HandNet,
}
