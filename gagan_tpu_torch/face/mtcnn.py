"""MTCNN face detector, the P-Net / R-Net / O-Net cascade (port of
gagan_tpu/face/mtcnn.py).

The three nets are plain functions over parameter dicts (``F.conv2d``,
PReLU, ``F.max_pool2d(ceil_mode=True)``), run on an explicit device, the
card by default.  The cascade's box bookkeeping (NMS, calibration, squaring,
correction) stays host numpy, as in the JAX module.  The JAX module pins its
nets to the host CPU only for the TPU's compile and layout limits; on the
card a new pyramid shape costs nothing to compile.

Two reference quirks are kept bit for bit, because pretrained weights depend
on them: P-Net's softmax runs over the last axis (the WIDTH of its [N, 2, H,
W] score map), and R-Net / O-Net flatten after a (3, 2) transpose.

Pillow's BILINEAR resizes of the image pyramid and of the box crops are
``ops/resize.py``'s, which give Pillow's pixels (its fixed-point
coefficients and rounding).  On the card the nets run with TF32 off: the cascade
thresholds its scores, so it runs at the float32 of the CPU route.

Weights: ``weights_dir`` or ``GAGAN_MTCNN_DIR`` with {pnet,rnet,onet}.npy,
the reference's name -> array dicts (``params_from_npy`` converts).  A set
directory without them raises.  Without a directory the nets are random
(from a ``torch.Generator``), for shape and pipeline runs only.
"""

from __future__ import annotations

import math
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..ops.resize import resize_uint8, resize_uint8_tensor

Params = Dict[str, object]


# ----------------------------------------------------------------------------
# Layers


def _conv(p, x):
    return F.conv2d(x, p["w"], p["b"])


def _prelu(a, x):
    return torch.where(x >= 0, x, a[None, :, None, None] * x)


def _linear(p, x):
    return x @ p["w"].t() + p["b"]


def _flatten_wh(x):
    """The reference's Flatten: transpose(3, 2) then reshape."""
    return x.transpose(2, 3).reshape(x.shape[0], -1)


def _pool(x, k, s):
    return F.max_pool2d(x, k, s, ceil_mode=True)


# ----------------------------------------------------------------------------
# Networks


def pnet_apply(params: Params, x: torch.Tensor):
    """Proposal net: (offsets [N, 4, h, w], probs [N, 2, h, w]), softmax
    over the LAST axis (the reference quirk)."""
    x = _prelu(params["prelu1"], _conv(params["conv1"], x))
    x = _pool(x, 2, 2)
    x = _prelu(params["prelu2"], _conv(params["conv2"], x))
    x = _prelu(params["prelu3"], _conv(params["conv3"], x))
    a = _conv(params["conv4_1"], x)
    b = _conv(params["conv4_2"], x)
    return b, torch.softmax(a, dim=-1)


def rnet_apply(params: Params, x: torch.Tensor):
    """Refinement net on 24x24 crops: (offsets [N, 4], probs [N, 2])."""
    x = _prelu(params["prelu1"], _conv(params["conv1"], x))
    x = _pool(x, 3, 2)
    x = _prelu(params["prelu2"], _conv(params["conv2"], x))
    x = _pool(x, 3, 2)
    x = _prelu(params["prelu3"], _conv(params["conv3"], x))
    x = _linear(params["conv4"], _flatten_wh(x))
    x = torch.where(x >= 0, x, params["prelu4"] * x)
    a = _linear(params["conv5_1"], x)
    b = _linear(params["conv5_2"], x)
    return b, torch.softmax(a, dim=-1)


def onet_apply(params: Params, x: torch.Tensor):
    """Output net on 48x48 crops: (landmarks [N, 10], offsets [N, 4],
    probs [N, 2])."""
    x = _prelu(params["prelu1"], _conv(params["conv1"], x))
    x = _pool(x, 3, 2)
    x = _prelu(params["prelu2"], _conv(params["conv2"], x))
    x = _pool(x, 3, 2)
    x = _prelu(params["prelu3"], _conv(params["conv3"], x))
    x = _pool(x, 2, 2)
    x = _prelu(params["prelu4"], _conv(params["conv4"], x))
    x = _linear(params["conv5"], _flatten_wh(x))
    x = torch.where(x >= 0, x, params["prelu5"] * x)
    a = _linear(params["conv6_1"], x)
    b = _linear(params["conv6_2"], x)
    c = _linear(params["conv6_3"], x)
    return c, b, torch.softmax(a, dim=-1)


_PNET_SHAPES = {
    "conv1": (10, 3, 3), "conv2": (16, 10, 3), "conv3": (32, 16, 3),
    "conv4_1": (2, 32, 1), "conv4_2": (4, 32, 1),
}
_RNET_SHAPES = {
    "conv1": (28, 3, 3), "conv2": (48, 28, 3), "conv3": (64, 48, 2),
    "conv4": (128, 576), "conv5_1": (2, 128), "conv5_2": (4, 128),
}
_ONET_SHAPES = {
    "conv1": (32, 3, 3), "conv2": (64, 32, 3), "conv3": (64, 64, 3),
    "conv4": (128, 64, 2), "conv5": (256, 1152),
    "conv6_1": (2, 256), "conv6_2": (4, 256), "conv6_3": (10, 256),
}
_PRELU_DIMS = {
    "pnet": {"prelu1": 10, "prelu2": 16, "prelu3": 32},
    "rnet": {"prelu1": 28, "prelu2": 48, "prelu3": 64, "prelu4": 128},
    "onet": {"prelu1": 32, "prelu2": 64, "prelu3": 64, "prelu4": 128,
             "prelu5": 256},
}
_SHAPES = {"pnet": _PNET_SHAPES, "rnet": _RNET_SHAPES, "onet": _ONET_SHAPES}


def init_net(name: str, gen: torch.Generator, device="cpu") -> Params:
    """Random weights of the JAX init's shapes and scales: N(0, 0.1^2)
    weights, zero biases, PReLU slopes 0.25; drawn on the CPU."""
    params: Params = {}
    for layer, shp in _SHAPES[name].items():
        full = (shp[0], shp[1], shp[2], shp[2]) if len(shp) == 3 else shp
        params[layer] = {
            "w": (torch.randn(full, generator=gen) * 0.1).to(device),
            "b": torch.zeros(shp[0], device=device)}
    for layer, dim in _PRELU_DIMS[name].items():
        params[layer] = torch.full((dim,), 0.25, device=device)
    return params


def params_from_npy(weights: Dict[str, np.ndarray], device="cpu") -> Params:
    """The reference .npy name -> array dict (keys like
    'features.conv1.weight', 'conv4_1.bias', 'prelu1.weight') as a net's
    parameter dict."""
    params: Params = {}
    for name, arr in weights.items():
        parts = name.replace("features.", "").split(".")
        layer, kind = parts[0], parts[-1]
        t = torch.from_numpy(np.asarray(arr, np.float32).copy()).to(device)
        if layer.startswith("prelu"):
            params[layer] = t.reshape(-1)
        else:
            params.setdefault(layer, {})
            params[layer]["w" if kind == "weight" else "b"] = t
    return params


def load_weights(weights_dir: str, device="cpu") -> Dict[str, Params]:
    """{pnet, rnet, onet} from ``weights_dir``'s .npy files; a missing file
    raises, naming it."""
    out = {}
    for name in ("pnet", "rnet", "onet"):
        path = os.path.join(weights_dir, f"{name}.npy")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path}: MTCNN weights not found (the directory given by "
                f"weights_dir or GAGAN_MTCNN_DIR must hold pnet.npy, "
                f"rnet.npy and onet.npy)")
        out[name] = params_from_npy(np.load(path, allow_pickle=True)[()],
                                    device)
    return out


# ----------------------------------------------------------------------------
# Box utilities: host numpy.


def nms(boxes: np.ndarray, overlap_threshold: float = 0.5,
        mode: str = "union") -> List[int]:
    if len(boxes) == 0:
        return []
    pick = []
    x1, y1, x2, y2, score = [boxes[:, i] for i in range(5)]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    ids = np.argsort(score)
    while len(ids) > 0:
        last = len(ids) - 1
        i = ids[last]
        pick.append(i)
        ix1 = np.maximum(x1[i], x1[ids[:last]])
        iy1 = np.maximum(y1[i], y1[ids[:last]])
        ix2 = np.minimum(x2[i], x2[ids[:last]])
        iy2 = np.minimum(y2[i], y2[ids[:last]])
        w = np.maximum(0.0, ix2 - ix1 + 1.0)
        h = np.maximum(0.0, iy2 - iy1 + 1.0)
        inter = w * h
        if mode == "min":
            overlap = inter / np.minimum(area[i], area[ids[:last]])
        else:
            overlap = inter / (area[i] + area[ids[:last]] - inter)
        ids = np.delete(ids, np.concatenate(
            [[last], np.where(overlap > overlap_threshold)[0]]))
    return pick


def convert_to_square(bboxes: np.ndarray) -> np.ndarray:
    square = np.zeros_like(bboxes)
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    h = y2 - y1 + 1.0
    w = x2 - x1 + 1.0
    side = np.maximum(h, w)
    square[:, 0] = x1 + w * 0.5 - side * 0.5
    square[:, 1] = y1 + h * 0.5 - side * 0.5
    square[:, 2] = square[:, 0] + side - 1.0
    square[:, 3] = square[:, 1] + side - 1.0
    square[:, 4:] = bboxes[:, 4:]
    return square


def calibrate_box(bboxes: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    w = (x2 - x1 + 1.0)[:, None]
    h = (y2 - y1 + 1.0)[:, None]
    bboxes[:, 0:4] = bboxes[:, 0:4] + np.hstack([w, h, w, h]) * offsets
    return bboxes


def correct_bboxes(bboxes: np.ndarray, width: int, height: int):
    x1, y1, x2, y2 = [bboxes[:, i] for i in range(4)]
    w, h = x2 - x1 + 1.0, y2 - y1 + 1.0
    num = bboxes.shape[0]
    x, y, ex, ey = x1, y1, x2, y2
    dx, dy = np.zeros((num,)), np.zeros((num,))
    edx, edy = w.copy() - 1.0, h.copy() - 1.0

    ind = np.where(ex > width - 1.0)[0]
    edx[ind] = w[ind] + width - 2.0 - ex[ind]
    ex = np.minimum(ex, width - 1.0)
    ind = np.where(ey > height - 1.0)[0]
    edy[ind] = h[ind] + height - 2.0 - ey[ind]
    ey = np.minimum(ey, height - 1.0)
    ind = np.where(x < 0.0)[0]
    dx[ind] = 0.0 - x[ind]
    x = np.maximum(x, 0.0)
    ind = np.where(y < 0.0)[0]
    dy[ind] = 0.0 - y[ind]
    y = np.maximum(y, 0.0)
    return [arr.astype("int32")
            for arr in (dy, edy, dx, edx, y, ey, x, ex, w, h)]


def _preprocess(img: np.ndarray) -> np.ndarray:
    """[h, w, c] uint8 / float -> normalized [1, c, h, w] float32."""
    img = img.transpose((2, 0, 1))[None]
    return (img.astype(np.float32) - 127.5) * 0.0078125


def get_image_boxes(bounding_boxes: np.ndarray, image: np.ndarray,
                    size: int = 24) -> np.ndarray:
    """Cut out, zero-pad and resize (Pillow BILINEAR) each box of a uint8
    [H, W, 3] image: [n, 3, size, size] float32."""
    num = len(bounding_boxes)
    height, width = image.shape[:2]
    dy, edy, dx, edx, y, ey, x, ex, w, h = correct_bboxes(
        bounding_boxes, width, height)
    out = np.zeros((num, 3, size, size), "float32")
    for i in range(num):
        if h[i] <= 0 or w[i] <= 0:
            continue
        box = np.zeros((h[i], w[i], 3), "uint8")
        box[dy[i]:edy[i] + 1, dx[i]:edx[i] + 1] = \
            image[y[i]:ey[i] + 1, x[i]:ex[i] + 1]
        box = resize_uint8(box, (size, size), "bilinear")
        out[i] = _preprocess(box)[0]
    return out


def _generate_bboxes(probs: np.ndarray, offsets: np.ndarray, scale: float,
                     threshold: float) -> np.ndarray:
    """P-Net score map -> candidate boxes."""
    stride, cell_size = 2, 12
    inds = np.where(probs > threshold)
    if inds[0].size == 0:
        return np.array([])
    tx1, ty1, tx2, ty2 = [offsets[0, i, inds[0], inds[1]] for i in range(4)]
    score = probs[inds[0], inds[1]]
    return np.vstack([
        np.round((stride * inds[1] + 1.0) / scale),
        np.round((stride * inds[0] + 1.0) / scale),
        np.round((stride * inds[1] + 1.0 + cell_size) / scale),
        np.round((stride * inds[0] + 1.0 + cell_size) / scale),
        score, tx1, ty1, tx2, ty2,
    ]).T


def _run_first_stage(image: torch.Tensor, pnet_params, scale: float,
                     threshold: float) -> Optional[np.ndarray]:
    """One pyramid level: the image (a uint8 [H, W, 3] tensor on the nets'
    device) resized by Pillow's BILINEAR, P-Net, boxes above threshold,
    NMS."""
    height, width = image.shape[:2]
    sw, sh = math.ceil(width * scale), math.ceil(height * scale)
    img = resize_uint8_tensor(image, (sh, sw), "bilinear")
    x = (img.permute(2, 0, 1)[None].float() - 127.5) * 0.0078125
    offsets, probs = pnet_apply(pnet_params, x)
    boxes = _generate_bboxes(probs[0, 1].cpu().numpy(),
                             offsets.cpu().numpy(), scale, threshold)
    if len(boxes) == 0:
        return None
    return boxes[nms(boxes[:, 0:5], overlap_threshold=0.5)]


# The last detect_faces call's box counts (P-Net's candidates over the
# pyramid, after its NMS, after R-Net, after O-Net) and host seconds per
# stage (each stage ends in a copy to the host, so its device work is in).
STAGE_COUNTS: Dict[str, int] = {}
STAGE_SECONDS: Dict[str, float] = {}


def detect_faces(params: Dict[str, Params], image,
                 min_face_size: float = 20.0,
                 thresholds=(0.15, 0.25, 0.35),
                 nms_thresholds=(0.7, 0.7, 0.7)):
    """The 3-stage cascade.  ``params``: {'pnet', 'rnet', 'onet'} on one
    device, where the nets run; ``image``: uint8 [H, W, 3] (a PIL image
    converts through ``np.asarray``).  Returns (bounding_boxes [n, 5],
    landmarks [n, 10]) as numpy."""
    image = np.ascontiguousarray(np.asarray(image, np.uint8))
    device = params["pnet"]["conv1"]["w"].device
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                         allow_tf32=False):
            return _detect_faces_impl(params, image, device, min_face_size,
                                      thresholds, nms_thresholds)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32


def _detect_faces_impl(params, image, device, min_face_size, thresholds,
                       nms_thresholds):
    empty = np.zeros((0, 5)), np.zeros((0, 10))
    STAGE_COUNTS.clear()
    STAGE_SECONDS.clear()
    t0 = time.perf_counter()
    height, width = image.shape[:2]
    min_length = min(height, width)
    min_detection_size = 12
    factor = 0.707
    scales = []
    m = min_detection_size / min_face_size
    min_length *= m
    fc = 0
    while min_length > min_detection_size:
        scales.append(m * factor ** fc)
        min_length *= factor
        fc += 1

    # Stage 1
    on_device = torch.from_numpy(image).to(device)
    boxes_per_scale = [
        _run_first_stage(on_device, params["pnet"], s, thresholds[0])
        for s in scales]
    boxes_per_scale = [b for b in boxes_per_scale if b is not None]
    STAGE_COUNTS["pnet"] = sum(len(b) for b in boxes_per_scale)
    STAGE_SECONDS["pnet"] = time.perf_counter() - t0
    if not boxes_per_scale:
        return empty
    bounding_boxes = np.vstack(boxes_per_scale)
    keep = nms(bounding_boxes[:, 0:5], nms_thresholds[0])
    bounding_boxes = bounding_boxes[keep]
    STAGE_COUNTS["pnet_nms"] = len(bounding_boxes)
    bounding_boxes = calibrate_box(bounding_boxes[:, 0:5],
                                   bounding_boxes[:, 5:])
    bounding_boxes = convert_to_square(bounding_boxes)
    bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])

    # Stage 2
    img_boxes = get_image_boxes(bounding_boxes, image, size=24)
    if len(img_boxes) == 0:
        return empty
    offsets, probs = (t.cpu().numpy() for t in rnet_apply(
        params["rnet"], torch.from_numpy(img_boxes).to(device)))
    keep = np.where(probs[:, 1] > thresholds[1])[0]
    bounding_boxes = bounding_boxes[keep]
    bounding_boxes[:, 4] = probs[keep, 1]
    offsets = offsets[keep]
    keep = nms(bounding_boxes, nms_thresholds[1])
    bounding_boxes = calibrate_box(bounding_boxes[keep], offsets[keep])
    bounding_boxes = convert_to_square(bounding_boxes)
    bounding_boxes[:, 0:4] = np.round(bounding_boxes[:, 0:4])
    STAGE_COUNTS["rnet"] = len(bounding_boxes)
    STAGE_SECONDS["rnet"] = time.perf_counter() - t0 - STAGE_SECONDS["pnet"]

    # Stage 3
    img_boxes = get_image_boxes(bounding_boxes, image, size=48)
    if len(img_boxes) == 0:
        return empty
    landmarks, offsets, probs = (t.cpu().numpy() for t in onet_apply(
        params["onet"], torch.from_numpy(img_boxes).to(device)))
    keep = np.where(probs[:, 1] > thresholds[2])[0]
    bounding_boxes = bounding_boxes[keep]
    bounding_boxes[:, 4] = probs[keep, 1]
    offsets, landmarks = offsets[keep], landmarks[keep]

    w = bounding_boxes[:, 2] - bounding_boxes[:, 0] + 1.0
    h = bounding_boxes[:, 3] - bounding_boxes[:, 1] + 1.0
    xmin, ymin = bounding_boxes[:, 0], bounding_boxes[:, 1]
    landmarks[:, 0:5] = xmin[:, None] + w[:, None] * landmarks[:, 0:5]
    landmarks[:, 5:10] = ymin[:, None] + h[:, None] * landmarks[:, 5:10]

    bounding_boxes = calibrate_box(bounding_boxes, offsets)
    keep = nms(bounding_boxes, nms_thresholds[2], mode="min")
    STAGE_COUNTS["onet"] = len(keep)
    STAGE_SECONDS["onet"] = (time.perf_counter() - t0 - STAGE_SECONDS["pnet"]
                             - STAGE_SECONDS["rnet"])
    return bounding_boxes[keep], landmarks[keep]


# ----------------------------------------------------------------------------


class MTCNN:
    """Detect, and align five points to 112x112.

    Weights load from ``weights_dir`` or ``GAGAN_MTCNN_DIR`` ({pnet, rnet,
    onet}.npy; a set directory without them raises); otherwise they are
    random, drawn from ``generator`` (default ``torch.Generator`` seed 0),
    for pipeline runs only.  The nets run on ``device`` (the card unless
    the caller asks for the CPU)."""

    def __init__(self, weights_dir: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda"):
        from . import align as align_lib

        self.device = resolve_device(device)
        weights_dir = weights_dir or os.environ.get("GAGAN_MTCNN_DIR")
        if weights_dir:
            self.params = load_weights(weights_dir, self.device)
        else:
            gen = (generator if generator is not None
                   else torch.Generator().manual_seed(0))
            self.params = {name: init_net(name, gen, self.device)
                           for name in ("pnet", "rnet", "onet")}
        self.reference = align_lib.get_reference_facial_points(
            default_square=True)

    def detect_faces(self, image, min_face_size: float = 20.0,
                     thresholds=(0.15, 0.25, 0.35),
                     nms_thresholds=(0.7, 0.7, 0.7)):
        return detect_faces(self.params, image, min_face_size, thresholds,
                            nms_thresholds)

    def align(self, img):
        """One face -> (112x112 uint8 [112, 112, 3] array, 2x3 transform)
        or (None, None); the JAX method returns a PIL image of the same
        pixels."""
        from . import align as align_lib

        img = np.ascontiguousarray(np.asarray(img, np.uint8))
        _, landmarks = self.detect_faces(img)
        if len(landmarks) == 0:
            return None, None
        pts = [[landmarks[0][j], landmarks[0][j + 5]] for j in range(5)]
        return align_lib.warp_and_crop_face(
            img, pts, self.reference, crop_size=(112, 112),
            device=self.device)

    def align_multi(self, img, limit: Optional[int] = None,
                    min_face_size: float = 30.0):
        """(boxes, [112x112 uint8 arrays], [2x3 transforms])."""
        from . import align as align_lib

        img = np.ascontiguousarray(np.asarray(img, np.uint8))
        boxes, landmarks = self.detect_faces(img, min_face_size)
        if limit:
            boxes, landmarks = boxes[:limit], landmarks[:limit]
        faces, tfms = [], []
        for lm in landmarks:
            pts = [[lm[j], lm[j + 5]] for j in range(5)]
            face, tfm = align_lib.warp_and_crop_face(
                img, pts, self.reference, crop_size=(112, 112),
                device=self.device)
            faces.append(face)
            tfms.append(tfm)
        return boxes, faces, tfms
