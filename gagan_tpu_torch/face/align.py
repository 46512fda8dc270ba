"""Face alignment (port of gagan_tpu/face/align.py): the Matlab cp2tform
similarity solve, the 5-point warp-crop (ArcFace layout) and the FFHQ quad
crop.

The numpy parts are the JAX module's.  Its image calls are replaced, since
the card's machine has neither Pillow nor cv2:
  - ``cv2.getAffineTransform`` by a 3-point linear solve;
  - ``cv2.warpAffine`` (INTER_LINEAR, zero border) by :func:`warp_affine`,
    which follows cv2's arithmetic: the inverse map in double, each
    destination pixel's source position in float32, the four neighbours
    blended (zeros outside) and rounded to the nearest level;
  - Pillow's LANCZOS ``resize`` by ``ops/resize.py``, which computes
    Pillow's fixed-point coefficients and rounding (Pillow's pixels);
  - Pillow's ``QUAD`` transform with BILINEAR by :func:`quad_transform`:
    each output pixel centre mapped bilinearly onto the quad, sampled
    bilinearly with the edge rows and columns clamped and truncated to
    uint8, zero where the centre falls outside the image, as Pillow does.
``scipy.ndimage.gaussian_filter`` stays (SciPy is on the card's machine).

Images are uint8 [H, W, 3] arrays.  The two large steps of
:func:`align_face`, the quad map at ``transform_size`` and the Lanczos down
to ``output_size``, run in torch on ``device`` (the card when asked for);
the crop, the reflect pad and its blur run on the host.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.resize import resize_uint8_tensor

# ArcFace 5-point reference landmarks on a (96, 112) crop.
REFERENCE_FACIAL_POINTS = np.array([
    [30.29459953, 51.69630051],
    [65.53179932, 51.50139999],
    [48.02519989, 71.73660278],
    [33.54930115, 92.3655014],
    [62.72990036, 92.20410156],
], dtype=np.float32)

DEFAULT_CROP_SIZE = (96, 112)


class FaceWarpException(Exception):
    pass


def get_reference_facial_points(output_size: Optional[Tuple[int, int]] = None,
                                inner_padding_factor: float = 0.0,
                                outer_padding: Tuple[int, int] = (0, 0),
                                default_square: bool = False) -> np.ndarray:
    """5 reference keypoints for a crop layout."""
    pts = REFERENCE_FACIAL_POINTS.copy()
    crop = np.array(DEFAULT_CROP_SIZE, dtype=np.float64)

    if default_square:
        diff = crop.max() - crop
        pts += diff / 2
        crop += diff

    if output_size and tuple(output_size) == tuple(crop.astype(int)):
        return pts
    if inner_padding_factor == 0 and outer_padding == (0, 0):
        if output_size is None:
            return pts
        raise FaceWarpException(
            f"No paddings to do, output_size must be None or {crop}")

    if not 0 <= inner_padding_factor <= 1.0:
        raise FaceWarpException("Not (0 <= inner_padding_factor <= 1.0)")
    if (inner_padding_factor > 0 or max(outer_padding) > 0) \
            and output_size is None:
        output_size = tuple(
            (crop * (1 + inner_padding_factor * 2)).astype(np.int32)
            + np.array(outer_padding) * 2)
    if not (outer_padding[0] < output_size[0]
            and outer_padding[1] < output_size[1]):
        raise FaceWarpException("outer_padding must be smaller than "
                                "output_size")

    if inner_padding_factor > 0:
        diff = crop * inner_padding_factor * 2
        pts += diff / 2
        crop += np.round(diff).astype(np.int32)

    size_bf_outer = np.array(output_size) - np.array(outer_padding) * 2
    if size_bf_outer[0] * crop[1] != size_bf_outer[1] * crop[0]:
        raise FaceWarpException("must have (output_size - outer_padding) "
                                "= some_scale * (crop_size * (1 + "
                                "inner_padding_factor))")
    scale = size_bf_outer[0] / crop[0]
    pts *= scale

    return (pts + np.array(outer_padding)).astype(np.float32)


def _tformfwd(trans: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """Row-vector convention: [x, y, 1] = [u, v, 1] @ trans."""
    uv1 = np.hstack([uv, np.ones((uv.shape[0], 1))])
    return (uv1 @ trans)[:, :2]


def find_nonreflective_similarity(uv: np.ndarray, xy: np.ndarray):
    """Least-squares similarity [sc, ss, tx, ty]."""
    m = xy.shape[0]
    x, y = xy[:, 0:1], xy[:, 1:2]
    X = np.vstack([
        np.hstack([x, y, np.ones((m, 1)), np.zeros((m, 1))]),
        np.hstack([y, -x, np.zeros((m, 1)), np.ones((m, 1))]),
    ])
    U = np.vstack([uv[:, 0:1], uv[:, 1:2]])
    if np.linalg.matrix_rank(X) < 4:
        raise FaceWarpException("cp2tform: two unique points required")
    r = np.linalg.lstsq(X, U, rcond=None)[0].ravel()
    sc, ss, tx, ty = r
    tinv = np.array([[sc, -ss, 0], [ss, sc, 0], [tx, ty, 1]])
    t = np.linalg.inv(tinv)
    t[:, 2] = [0, 0, 1]
    return t, tinv


def find_similarity(uv: np.ndarray, xy: np.ndarray):
    """Best of the non-reflective fit and the reflected fit, both scored
    against the original ``xy`` (the JAX module's fix of the reference's
    in-place reflection)."""
    trans1, trans1_inv = find_nonreflective_similarity(uv, xy)

    xy_r = xy.copy()
    xy_r[:, 0] *= -1
    trans2r, _ = find_nonreflective_similarity(uv, xy_r)
    reflect_y = np.diag([-1.0, 1.0, 1.0])
    trans2 = trans2r @ reflect_y

    norm1 = np.linalg.norm(_tformfwd(trans1, uv) - xy)
    norm2 = np.linalg.norm(_tformfwd(trans2, uv) - xy)
    if norm1 <= norm2:
        return trans1, trans1_inv
    return trans2, np.linalg.inv(trans2)


def get_similarity_transform(src_pts: np.ndarray, dst_pts: np.ndarray,
                             reflective: bool = True):
    if reflective:
        return find_similarity(src_pts, dst_pts)
    return find_nonreflective_similarity(src_pts, dst_pts)


def get_similarity_transform_cv2(src_pts: np.ndarray, dst_pts: np.ndarray,
                                 reflective: bool = True) -> np.ndarray:
    """2x3 forward matrix (the layout cv2.warpAffine takes)."""
    trans, _ = get_similarity_transform(src_pts, dst_pts, reflective)
    return trans[:, 0:2].T


def get_affine_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affine map of three source points onto three destination
    points (``cv2.getAffineTransform``): a 6x6 solve in double."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    a = np.zeros((6, 6))
    a[0::2, 0:2], a[0::2, 2] = src, 1.0
    a[1::2, 3:5], a[1::2, 5] = src, 1.0
    return np.linalg.solve(a, dst.reshape(6)).reshape(2, 3)


def _as_tensor(img, device=None) -> torch.Tensor:
    if isinstance(img, torch.Tensor):
        return img if device is None else img.to(device)
    return torch.from_numpy(np.ascontiguousarray(img, np.uint8)).to(
        device or "cpu")


def _like_input(out: torch.Tensor, img):
    return out if isinstance(img, torch.Tensor) else out.cpu().numpy()


def warp_affine(img, matrix: np.ndarray, dsize: Tuple[int, int],
                device=None):
    """``cv2.warpAffine(img, matrix, dsize)`` with INTER_LINEAR and a zero
    border: ``img`` uint8 [H, W, C] (numpy, or a tensor on its device),
    ``matrix`` the 2x3 forward map, ``dsize`` (width, height).  Returns the
    input's type."""
    x = _as_tensor(img, device)
    h_in, w_in = x.shape[:2]
    m = [float(v) for v in np.asarray(matrix, np.float64).reshape(6)]
    det = m[0] * m[4] - m[1] * m[3]
    det = 1.0 / det if det != 0 else 0.0
    a11, a22, a12, a21 = m[4] * det, m[0] * det, -m[1] * det, -m[3] * det
    inv = [a11, a12, -a11 * m[2] - a12 * m[5],
           a21, a22, -a21 * m[2] - a22 * m[5]]
    w_out, h_out = dsize
    dev = x.device
    xs = torch.arange(w_out, device=dev, dtype=torch.float32)[None, :]
    ys = torch.arange(h_out, device=dev, dtype=torch.float32)[:, None]
    c = torch.tensor(inv, dtype=torch.float32, device=dev)
    sx = (c[0] * xs + c[1] * ys + c[2]).double()
    sy = (c[3] * xs + c[4] * ys + c[5]).double()
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    src = x.double()

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < w_in) & (yy >= 0) & (yy < h_in)
        v = src[yy.clamp(0, h_in - 1), xx.clamp(0, w_in - 1)]
        return v * ok[..., None]

    out = (tap(y0, x0) * (1 - fx) * (1 - fy) + tap(y0, x0 + 1) * fx * (1 - fy)
           + tap(y0 + 1, x0) * (1 - fx) * fy + tap(y0 + 1, x0 + 1) * fx * fy)
    out = torch.floor(out + 0.5).clamp(0, 255).to(torch.uint8)
    return _like_input(out, img)


def warp_and_crop_face(src_img, facial_pts, reference_pts=None,
                       crop_size: Tuple[int, int] = (96, 112),
                       align_type: str = "smilarity", device=None):
    """Warp a face to the reference layout.  ``align_type``: 'smilarity'
    (sic, the reference's default), 'cv2_affine' (3-point solve) or
    'affine' (full 3x3 lstsq).  ``src_img`` uint8 [H, W, 3] (numpy, or a
    tensor on its device).  Returns (the cropped uint8 image, of the
    input's type, and the 2x3 transform)."""
    if reference_pts is None:
        if crop_size == (96, 112):
            reference_pts = REFERENCE_FACIAL_POINTS
        else:
            default_square = crop_size[0] == crop_size[1]
            reference_pts = get_reference_facial_points(
                output_size=crop_size, default_square=default_square)

    ref_pts = np.float32(reference_pts)
    src_pts = np.float32(facial_pts)
    if src_pts.shape != ref_pts.shape and src_pts.T.shape == ref_pts.shape:
        src_pts = src_pts.T

    if align_type == "cv2_affine":
        tfm = get_affine_transform(src_pts[0:3], ref_pts[0:3])
    elif align_type == "affine":
        ones = np.ones((src_pts.shape[0], 1), np.float32)
        a = np.hstack([src_pts, ones])
        b = np.hstack([ref_pts, ones])
        tfm = np.linalg.lstsq(a, b, rcond=None)[0].T[:2]
    else:
        tfm = get_similarity_transform_cv2(src_pts, ref_pts)

    face = warp_affine(src_img, tfm, (crop_size[0], crop_size[1]), device)
    return face, tfm


def ffhq_quad(eye_left, eye_right, mouth_left, mouth_right):
    """FFHQ crop quad from eye centers + mouth corners.  Returns (quad
    [4, 2], qsize)."""
    eye_left = np.asarray(eye_left, np.float64)
    eye_right = np.asarray(eye_right, np.float64)
    eye_avg = (eye_left + eye_right) * 0.5
    eye_to_eye = eye_right - eye_left
    mouth_avg = (np.asarray(mouth_left, np.float64)
                 + np.asarray(mouth_right, np.float64)) * 0.5
    eye_to_mouth = mouth_avg - eye_avg

    x = eye_to_eye - np.flipud(eye_to_mouth) * [-1, 1]
    x /= np.hypot(*x)
    x *= max(np.hypot(*eye_to_eye) * 2.0, np.hypot(*eye_to_mouth) * 1.8)
    y = np.flipud(x) * [-1, 1]
    c = eye_avg + eye_to_mouth * 0.1
    quad = np.stack([c - x - y, c - x + y, c + x + y, c + x - y])
    qsize = np.hypot(*x) * 2
    return quad, qsize


def quad_transform(img: torch.Tensor, quad: np.ndarray,
                   size: int) -> torch.Tensor:
    """Pillow's ``transform((size, size), QUAD, quad.flatten(), BILINEAR)``
    of a uint8 [H, W, C] tensor, on its device.  ``quad`` [4, 2]: the
    source corners mapped to the output's NW, SW, SE and NE corners."""
    h_in, w_in = img.shape[:2]
    dev = img.device
    (x0, y0), sw, se, ne = [tuple(float(v) for v in p) for p in quad]
    a_s = a_t = 1.0 / size
    a = (x0, (ne[0] - x0) * a_s, (sw[0] - x0) * a_t,
         (se[0] - sw[0] - ne[0] + x0) * a_s * a_t,
         y0, (ne[1] - y0) * a_s, (sw[1] - y0) * a_t,
         (se[1] - sw[1] - ne[1] + y0) * a_s * a_t)
    xin = torch.arange(size, device=dev, dtype=torch.float64)[None, :] + 0.5
    yin = torch.arange(size, device=dev, dtype=torch.float64)[:, None] + 0.5
    sx = a[0] + a[1] * xin + a[2] * yin + a[3] * xin * yin
    sy = a[4] + a[5] * xin + a[6] * yin + a[7] * xin * yin
    inside = (sx >= 0) & (sx < w_in) & (sy >= 0) & (sy < h_in)
    sx, sy = sx - 0.5, sy - 0.5
    xi, yi = torch.floor(sx), torch.floor(sy)
    dx, dy = (sx - xi)[..., None], (sy - yi)[..., None]
    xi, yi = xi.long(), yi.long()
    xa, xb = xi.clamp(0, w_in - 1), (xi + 1).clamp(0, w_in - 1)
    src = img.double()

    def row(r):
        v0 = src[r, xa]
        return v0 + (src[r, xb] - v0) * dx

    v1 = row(yi.clamp(0, h_in - 1))
    has2 = ((yi + 1 >= 0) & (yi + 1 < h_in))[..., None]
    v2 = torch.where(has2, row((yi + 1).clamp(0, h_in - 1)), v1)
    v = torch.trunc(v1 + (v2 - v1) * dy)
    return torch.where(inside[..., None], v, 0.0).to(torch.uint8)


def _lanczos(img: np.ndarray, size, device) -> np.ndarray:
    """Pillow's LANCZOS resize of a uint8 [H, W, 3] array to (w, h)."""
    x = _as_tensor(img, device)
    return resize_uint8_tensor(x, (size[1], size[0]), "lanczos3").cpu().numpy()


# Seconds of the last align_face call's steps: "shrink" (Lanczos),
# "pad_blur" (reflect pad and SciPy blur, host), "quad" (the quad map) and
# "lanczos" (down to output_size); the card is synchronised at each stamp.
STEP_SECONDS: Dict[str, float] = {}


def _stamp(name: str, t0: float, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = time.perf_counter()
    STEP_SECONDS[name] = t - t0
    return t


def align_face(img, landmarks: np.ndarray, output_size: int = 1024,
               transform_size: int = 4096, enable_padding: bool = True,
               device="cuda") -> np.ndarray:
    """FFHQ alignment from 68 landmarks ([68, 2] (x, y), the dlib layout) or
    5 ([5, 2], MTCNN's order: left eye, right eye, nose, left mouth, right
    mouth).  ``img``: uint8 [H, W, 3] (a PIL image converts through
    ``np.asarray``).  Returns the aligned face as a uint8 [output_size,
    output_size, 3] array where the JAX function returns a PIL image of the
    same pixels.  The quad map and the Lanczos resizes run on ``device``
    (the card unless the caller asks for the CPU)."""
    import scipy.ndimage

    device = resolve_device(device)
    STEP_SECONDS.clear()
    t = time.perf_counter()
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    lm = np.asarray(landmarks, np.float64)
    if lm.shape[0] == 5:
        quad, qsize = ffhq_quad(lm[0], lm[1], lm[3], lm[4])
    else:
        eye_left = lm[36:42].mean(axis=0)
        eye_right = lm[42:48].mean(axis=0)
        quad, qsize = ffhq_quad(eye_left, eye_right, lm[48], lm[54])

    shrink = int(np.floor(qsize / output_size * 0.5))
    if shrink > 1:
        rsize = (int(np.rint(img.shape[1] / shrink)),
                 int(np.rint(img.shape[0] / shrink)))
        img = _lanczos(img, rsize, device)
        quad /= shrink
        qsize /= shrink
        t = _stamp("shrink", t, device)

    width, height = img.shape[1], img.shape[0]
    border = max(int(np.rint(qsize * 0.1)), 3)
    crop = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
            int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    crop = (max(crop[0] - border, 0), max(crop[1] - border, 0),
            min(crop[2] + border, width), min(crop[3] + border, height))
    if crop[2] - crop[0] < width or crop[3] - crop[1] < height:
        img = img[crop[1]:crop[3], crop[0]:crop[2]]
        quad -= crop[0:2]
        width, height = img.shape[1], img.shape[0]

    pad = (int(np.floor(quad[:, 0].min())), int(np.floor(quad[:, 1].min())),
           int(np.ceil(quad[:, 0].max())), int(np.ceil(quad[:, 1].max())))
    pad = (max(-pad[0] + border, 0), max(-pad[1] + border, 0),
           max(pad[2] - width + border, 0), max(pad[3] - height + border, 0))
    if enable_padding and max(pad) > border - 4:
        pad = np.maximum(pad, int(np.rint(qsize * 0.3)))
        arr = np.pad(np.float32(img),
                     ((pad[1], pad[3]), (pad[0], pad[2]), (0, 0)), "reflect")
        h, w, _ = arr.shape
        yy, xx, _ = np.ogrid[:h, :w, :1]
        mask = np.maximum(
            1.0 - np.minimum(np.float32(xx) / pad[0],
                             np.float32(w - 1 - xx) / pad[2]),
            1.0 - np.minimum(np.float32(yy) / pad[1],
                             np.float32(h - 1 - yy) / pad[3]))
        blur = qsize * 0.02
        arr += (scipy.ndimage.gaussian_filter(arr, [blur, blur, 0]) - arr) \
            * np.clip(mask * 3.0 + 1.0, 0.0, 1.0)
        arr += (np.median(arr, axis=(0, 1)) - arr) * np.clip(mask, 0.0, 1.0)
        img = np.uint8(np.clip(np.rint(arr), 0, 255))
        quad += pad[:2]
        t = _stamp("pad_blur", t, device)

    out = quad_transform(_as_tensor(img, device), quad + 0.5, transform_size)
    t = _stamp("quad", t, device)
    if output_size < transform_size:
        out = resize_uint8_tensor(out, (output_size, output_size), "lanczos3")
        t = _stamp("lanczos", t, device)
    return out.cpu().numpy()


def align_face_5p(img, landmarks5: np.ndarray, output_size: int = 1024,
                  transform_size: int = 4096, enable_padding: bool = True,
                  device="cuda") -> np.ndarray:
    """FFHQ alignment from 5-point landmarks (MTCNN order: left eye, right
    eye, nose, left mouth corner, right mouth corner).  uint8 [H, W, 3] in,
    uint8 [output_size, output_size, 3] out (the JAX function returns a PIL
    image)."""
    return align_face(img, np.asarray(landmarks5, np.float64),
                      output_size=output_size, transform_size=transform_size,
                      enable_padding=enable_padding, device=device)


def align_face_auto(img, output_size: int = 1024, transform_size: int = 4096,
                    enable_padding: bool = True, mtcnn=None, device="cuda"):
    """Image -> FFHQ-aligned face with no landmark file: the most confident
    MTCNN detection's 5 landmarks drive the FFHQ quad.  Real behaviour
    needs converted MTCNN weights (``GAGAN_MTCNN_DIR``); with random
    weights the cascade runs but its detections mean nothing.

    ``img`` uint8 [H, W, 3]; returns the aligned uint8 [output_size,
    output_size, 3] array (the JAX function returns a PIL image of it), or
    None when no face is detected.  ``mtcnn`` defaults to ``MTCNN(device=
    device)``; the nets, the quad map and the Lanczos run on ``device``."""
    from .mtcnn import MTCNN

    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    if mtcnn is None:
        mtcnn = MTCNN(device=device)
    boxes, landmarks = mtcnn.detect_faces(img)
    if len(boxes) == 0:
        return None
    best = int(np.argmax(boxes[:, 4]))
    pts = np.stack([landmarks[best][:5], landmarks[best][5:]], axis=1)
    return align_face_5p(img, pts, output_size=output_size,
                         transform_size=transform_size,
                         enable_padding=enable_padding, device=device)
