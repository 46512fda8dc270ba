"""Single / few style-image dataset of the image-driven adaptation trainers
(port of gagan_tpu/data/style_dataset.py).

Each record is the image aligned (``face.align_face`` from a
``landmark_fn``) or resized to ``size``, and a 256^2 copy, as uint8 HWC and
as normalized [-1, 1] CHW float.  Images are read by ``data/dataset.py::
read_rgb`` (PNG without Pillow) and resized as Pillow resizes
(``ops/resize.py``): Pillow's default ``resize`` filter for RGB, BICUBIC, to
``size``, then LANCZOS to 256^2.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, List, Optional, Union

import numpy as np

from ..ops.resize import resize_uint8
from .dataset import read_rgb

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tiff")


def is_image_file(filename: str) -> bool:
    return filename.lower().endswith(IMG_EXTENSIONS)


def make_dataset(directory: str) -> List[str]:
    assert os.path.isdir(directory), f"{directory} is not a valid directory"
    images = []
    for root, _, fnames in sorted(os.walk(directory)):
        images.extend(os.path.join(root, f) for f in fnames
                      if is_image_file(f))
    return images


def _to_float_chw(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return ((arr - 0.5) / 0.5).transpose(2, 0, 1)


class ImagesDataset:
    """Indexable style-image records.  ``device`` is where ``align_face``
    runs its quad map and Lanczos when ``align_input`` is set."""

    def __init__(self, size: int,
                 image_path: Union[str, List[str]],
                 align_input: bool = False,
                 landmark_fn: Optional[Callable] = None,
                 device="cuda"):
        if isinstance(image_path, (list, tuple)):
            self.image_paths = list(image_path)
        elif os.path.isdir(image_path):
            self.image_paths = sorted(make_dataset(image_path))
        elif os.path.isfile(image_path):
            self.image_paths = [image_path]
        else:
            raise ValueError(
                f"Incorrect 'image_path' argument in ImagesDataset, "
                f"{image_path}")
        self.size = size
        self.align_input = align_input
        if align_input and landmark_fn is None:
            raise ValueError(
                "align_input=True needs a landmark_fn(image) -> [68, 2] "
                "(dlib is not available; see gagan_tpu_torch.face.align_face)")
        self.landmark_fn = landmark_fn
        self.device = device

    def __len__(self) -> int:
        return len(self.image_paths)

    def __getitem__(self, index: int) -> dict:
        from ..face.align import align_face

        path = Path(self.image_paths[index])
        img = read_rgb(str(path))
        if self.align_input:
            im_h = align_face(img, self.landmark_fn(img),
                              output_size=self.size, device=self.device)
        else:
            im_h = resize_uint8(img, (self.size, self.size), "bicubic")
        im_l = resize_uint8(im_h, (256, 256), "lanczos3")
        return {
            "image_high_res": im_h,
            "image_low_res": im_l,
            "image_high_res_t": _to_float_chw(im_h),
            "image_low_res_t": _to_float_chw(im_l),
            "image_name": path.stem,
        }
