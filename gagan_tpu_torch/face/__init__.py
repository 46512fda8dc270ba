"""Face detection and alignment in front of the encoders and inversion
(port of gagan_tpu/face): the MTCNN cascade and the cp2tform / FFHQ
alignments, on uint8 [H, W, 3] arrays, with no Pillow and no cv2."""

from .align import (align_face, get_reference_facial_points,
                    get_similarity_transform_cv2, warp_and_crop_face)
from .mtcnn import MTCNN, detect_faces

__all__ = [
    "MTCNN", "detect_faces", "align_face", "warp_and_crop_face",
    "get_reference_facial_points", "get_similarity_transform_cv2",
]
