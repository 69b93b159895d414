from tpupose_torch.detectors.pose import PoseDetector
