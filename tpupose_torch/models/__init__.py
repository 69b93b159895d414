from tpupose_torch.models.posenet import CocoPoseNet

# Architecture registry (mirrors ``tpupose.models.ARCHS``; the crop nets are
# not ported yet).
ARCHS = {
    "posenet": CocoPoseNet,
}
