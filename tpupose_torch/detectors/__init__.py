from tpupose_torch.detectors.crops import (
    compute_limbs_length,
    compute_unit_length,
    crop_around_keypoint,
    crop_face,
    crop_face_haar,
    crop_hands,
    crop_image,
    crop_person,
    get_unit_length,
)
from tpupose_torch.detectors.draw import (
    draw_face_keypoints,
    draw_hand_keypoints,
    draw_person_pose,
)
from tpupose_torch.detectors.face import FaceDetector
from tpupose_torch.detectors.hand import HandDetector
from tpupose_torch.detectors.pose import PoseDetector
