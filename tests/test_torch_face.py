"""The port's face detection and alignment (gagan_tpu_torch.face) against the
JAX package's, which calls Pillow and cv2, on the CPU.

The MTCNN nets cross from JAX's random init as the reference's .npy name ->
array dicts (``params_from_npy``).  Tolerances:
  - nets: 1e-5 of the output's max|.| (float32 convolutions and matmuls
    summed in another order: ~1e-7 relative a layer, a few layers deep);
  - ``detect_faces``: the same number of boxes, boxes and landmarks within
    1e-2 px.  The port's pyramid and crop resizes give Pillow's pixels
    exactly (``ops/resize.py``), so the two cascades see the same inputs and
    differ by float32 rounding in the nets (~1e-6 in the offsets, times box
    sizes of ~100 px); a box that the thresholds or an np.round flip moved
    would miss by a whole pixel or more;
  - the similarity fits, ``ffhq_quad`` and the reference points: equal to
    1e-12 (the same float64 numpy);
  - ``warp_and_crop_face`` against cv2.warpAffine and ``quad_transform``
    against Pillow's QUAD: at most 1 level, and equal on at least 99.9% of
    pixels.  Both follow the library's own arithmetic (cv2: float32 source
    positions, a bilinear blend rounded to nearest; Pillow: float64
    positions, a blend truncated), so they can differ only where a blend
    lands within rounding of a level boundary;
  - ``align_face`` / ``align_face_5p`` against Pillow: at most 1 level (the
    Lanczos resizes are Pillow's exactly; the quad map is as above; the
    blur is the same SciPy call).
"""

import jax
import numpy as np
import PIL.Image
import pytest
import torch

from gagan_tpu.face import align as jalign
from gagan_tpu.face import mtcnn as jmtcnn
from gagan_tpu_torch.face import align as talign
from gagan_tpu_torch.face import mtcnn as tmtcnn

torch.set_num_threads(2)


def npy_dict(tree):
    """A JAX net's parameter tree as the reference's .npy name -> array."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[f"{k}.weight"] = np.asarray(v["w"])
            out[f"{k}.bias"] = np.asarray(v["b"])
        else:
            out[f"{k}.weight"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def nets():
    jnet = jmtcnn.MTCNN(key=jax.random.PRNGKey(0))
    tparams = {n: tmtcnn.params_from_npy(npy_dict(jnet.params[n]))
               for n in ("pnet", "rnet", "onet")}
    return jnet, tparams


def smooth_image(size, seed=1):
    """A uint8 [size, size, 3] image: seeded noise at 1/8 the size,
    Pillow-bicubic upsampled."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 256, (size // 8, size // 8, 3)).astype(np.uint8)
    return np.asarray(PIL.Image.fromarray(base).resize((size, size),
                                                       PIL.Image.BICUBIC))


@pytest.mark.parametrize("net,shape", [("pnet", (2, 3, 37, 45)),
                                       ("rnet", (5, 3, 24, 24)),
                                       ("onet", (5, 3, 48, 48))])
def test_nets_match_jax(nets, net, shape):
    jnet, tparams = nets
    x = np.random.RandomState(2).uniform(-1, 1, shape).astype(np.float32)
    jfn = getattr(jmtcnn, f"{net}_apply")
    tfn = getattr(tmtcnn, f"{net}_apply")
    want = jfn(jnet.params[net], x)
    got = tfn(tparams[net], torch.from_numpy(x))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_random_init_and_weights_dir(tmp_path, monkeypatch):
    """The port's random nets have the JAX init's shapes and scales; a
    GAGAN_MTCNN_DIR without the files raises; with them, they load."""
    jp = jmtcnn.init_onet(jax.random.PRNGKey(1))
    tp = tmtcnn.init_net("onet", torch.Generator().manual_seed(1))
    assert set(tp) == set(jp)
    for k, v in jp.items():
        if isinstance(v, dict):
            assert tuple(tp[k]["w"].shape) == v["w"].shape
            assert abs(float(tp[k]["w"].std()) - 0.1) < 0.02
            assert float(tp[k]["b"].abs().max()) == 0.0
        else:
            assert torch.equal(tp[k], torch.full(v.shape, 0.25))
    monkeypatch.setenv("GAGAN_MTCNN_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="pnet.npy"):
        tmtcnn.MTCNN(device="cpu")
    for n in ("pnet", "rnet", "onet"):
        init = getattr(jmtcnn, f"init_{n}")(jax.random.PRNGKey(3))
        np.save(tmp_path / f"{n}.npy", npy_dict(init), allow_pickle=True)
    m = tmtcnn.MTCNN(device="cpu")
    np.testing.assert_array_equal(
        m.params["rnet"]["conv4"]["w"].numpy(),
        np.asarray(jmtcnn.init_rnet(jax.random.PRNGKey(3))["conv4"]["w"]))


@pytest.mark.parametrize("size,thresholds", [(96, (0.1, 0.3, 0.4)),
                                             (128, (0.15, 0.25, 0.35))])
def test_detect_faces_matches_jax(nets, size, thresholds):
    jnet, tparams = nets
    img = smooth_image(size)
    jb, jl = jnet.detect_faces(PIL.Image.fromarray(img),
                               thresholds=thresholds)
    tb, tl = tmtcnn.detect_faces(tparams, img, thresholds=thresholds)
    assert len(jb) > 0 and len(tb) == len(jb)
    np.testing.assert_allclose(tb, jb, rtol=0, atol=1e-2)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-2)
    counts = tmtcnn.STAGE_COUNTS
    assert counts["pnet"] >= counts["pnet_nms"] >= len(tb)
    assert counts["onet"] == len(tb)


def test_fits_quad_and_reference_points_match_jax():
    rng = np.random.RandomState(4)
    src = rng.uniform(0, 100, (5, 2))
    dst = rng.uniform(0, 100, (5, 2))
    for fn in ("find_nonreflective_similarity", "find_similarity"):
        for a, b in zip(getattr(talign, fn)(src, dst),
                        getattr(jalign, fn)(src, dst)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    for refl in (True, False):
        np.testing.assert_allclose(
            talign.get_similarity_transform_cv2(src, dst, refl),
            jalign.get_similarity_transform_cv2(src, dst, refl), atol=1e-12)
    q1, s1 = talign.ffhq_quad(*src[:4])
    q2, s2 = jalign.ffhq_quad(*src[:4])
    np.testing.assert_allclose(q1, q2, atol=1e-12)
    assert s1 == pytest.approx(s2, abs=1e-12)
    for kw in ({}, {"default_square": True},
               {"output_size": (112, 112), "default_square": True},
               {"inner_padding_factor": 0.25, "outer_padding": (4, 4)}):
        np.testing.assert_allclose(talign.get_reference_facial_points(**kw),
                                   jalign.get_reference_facial_points(**kw),
                                   atol=1e-12)


def _close_levels(got, want):
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert got.shape == np.asarray(want).shape
    assert diff.max() <= 1, diff.max()
    return diff


@pytest.mark.parametrize("align_type", ["smilarity", "cv2_affine", "affine"])
def test_warp_and_crop_face_matches_jax(align_type):
    img = smooth_image(160, seed=5)
    pts = np.array([[60.3, 70.1], [101.2, 68.4], [80.5, 92.7], [64.8, 118.3],
                    [98.1, 117.2]])
    ref = talign.get_reference_facial_points(default_square=True)
    got, tfm = talign.warp_and_crop_face(img, pts, ref, (112, 112),
                                         align_type)
    want, jtfm = jalign.warp_and_crop_face(img, pts, ref, (112, 112),
                                           align_type)
    np.testing.assert_allclose(tfm, jtfm, rtol=0, atol=1e-6)
    diff = _close_levels(got, want)
    assert (diff == 0).mean() >= 0.999
    t_got, _ = talign.warp_and_crop_face(torch.from_numpy(img), pts, ref,
                                         (112, 112), align_type)
    assert torch.equal(t_got, torch.from_numpy(got))


def test_quad_transform_matches_pillow():
    img = smooth_image(120, seed=6)
    quad = np.array([[5.3, 4.1], [8.2, 101.7], [110.9, 105.2], [113.1, 2.4]])
    for size in (64, 200):
        want = np.asarray(PIL.Image.fromarray(img).transform(
            (size, size), PIL.Image.QUAD, (quad + 0.5).flatten(),
            PIL.Image.BILINEAR))
        got = talign.quad_transform(torch.from_numpy(img), quad + 0.5,
                                    size).numpy()
        diff = _close_levels(got, want)
        assert (diff == 0).mean() >= 0.999


LANDMARKS5 = np.array([[40.2, 50.3], [80.7, 48.9], [61.0, 72.4],
                       [45.5, 95.1], [78.3, 94.0]])


@pytest.mark.parametrize("padding", [True, False])
@pytest.mark.parametrize("five", [True, False])
def test_align_face_matches_jax(padding, five):
    """Small sizes (output 64, transform 128); the quad reaches past the
    image, so the padding branch runs when enabled.  JAX's function is given
    a PIL image: with an array it fails (``hasattr(img, "size")`` holds for
    an ndarray, so it is never converted)."""
    img = smooth_image(128, seed=7)
    pil = PIL.Image.fromarray(img)
    if five:
        got = talign.align_face_5p(img, LANDMARKS5, output_size=64,
                                   transform_size=128,
                                   enable_padding=padding, device="cpu")
        want = jalign.align_face_5p(pil, LANDMARKS5, output_size=64,
                                    transform_size=128,
                                    enable_padding=padding)
    else:
        lm = np.random.RandomState(8).uniform(30, 100, (68, 2))
        lm[36:42] = LANDMARKS5[0] + np.random.RandomState(9).randn(6, 2)
        lm[42:48] = LANDMARKS5[1] + np.random.RandomState(10).randn(6, 2)
        lm[48], lm[54] = LANDMARKS5[3], LANDMARKS5[4]
        got = talign.align_face(img, lm, output_size=64, transform_size=128,
                                enable_padding=padding, device="cpu")
        want = jalign.align_face(pil, lm, output_size=64, transform_size=128,
                                 enable_padding=padding)
    assert got.dtype == np.uint8 and got.shape == (64, 64, 3)
    _close_levels(got, want)


def test_align_face_shrinks_large_images_like_jax():
    """A small quad in a large image takes the shrink branch (Lanczos)."""
    img = smooth_image(256, seed=11)
    got = talign.align_face_5p(img, LANDMARKS5 / 2 + 20, output_size=16,
                               transform_size=32, device="cpu")
    want = jalign.align_face_5p(PIL.Image.fromarray(img), LANDMARKS5 / 2 + 20,
                                output_size=16,
                                transform_size=32)
    _close_levels(got, want)


def test_align_face_auto_and_mtcnn_align_match_jax(nets):
    """On an image where the random cascade's best detection has distinct
    landmarks: JAX's random nets often return boxes of negative width, and
    then its get_image_boxes fails on them (the port keeps that code)."""
    jnet, tparams = nets
    tnet = tmtcnn.MTCNN(device="cpu")
    tnet.params = tparams
    img = smooth_image(160, seed=3)
    want = jalign.align_face_auto(PIL.Image.fromarray(img), output_size=64,
                                  transform_size=128, mtcnn=jnet)
    got = talign.align_face_auto(img, output_size=64, transform_size=128,
                                 mtcnn=tnet, device="cpu")
    _close_levels(got, want)
    face, tfm = tnet.align(img)
    jface, jtfm = jnet.align(PIL.Image.fromarray(img))
    np.testing.assert_allclose(tfm, jtfm, rtol=0, atol=1e-3)
    assert face.shape == (112, 112, 3)
    diff = _close_levels(face, jface)
    assert (diff == 0).mean() >= 0.99
    boxes, faces, tfms = tnet.align_multi(img, limit=2, min_face_size=20.0)
    jboxes, jfaces, _ = jnet.align_multi(PIL.Image.fromarray(img), limit=2,
                                         min_face_size=20.0)
    assert len(faces) == len(jfaces) == len(tfms)
    np.testing.assert_allclose(boxes, jboxes, rtol=0, atol=1e-2)
