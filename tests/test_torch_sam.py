"""The port's SAM (mimo_tpu_torch/decomp/sam.py) against
mimo_tpu/decomp/sam.py: encoder, prompt encoder and two-way decoder,
SamPredictor.predict(box=), automatic_masks and the SAM matting, on the
same numpy-seeded inputs with JAX-initialised tiny params carried over by
the weights bridge (fp32 on the CPU); and the device-matmul NMS on the cases of
tests/test_decomp_models.py::test_automask_device_nms_matches_host_oracle.

Images are at the model's own square size (64x64), so both sides' resize
is an identity. Tolerance: logits and IoU predictions atol/rtol 1e-4 (fp32
on both sides, summation order differs); boolean masks equal except where
|logit| < 1e-3; the NMS counts exact.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import sam as JS
from mimo_tpu_torch.decomp import sam as S
from mimo_tpu_torch.decomp import vit as V
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def _port_cfg(cfg):
    return S.SAMConfig(encoder=V.ViTConfig(**cfg.encoder.__dict__),
                       prompt_dim=cfg.prompt_dim,
                       image_embed_size=cfg.image_embed_size,
                       decoder_depth=cfg.decoder_depth,
                       decoder_heads=cfg.decoder_heads,
                       num_mask_tokens=cfg.num_mask_tokens)


@pytest.fixture(scope="module")
def sam():
    cfg = JS.tiny_sam_config()
    p = JS.sam_init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(0)
    for blk in p["encoder"]["blocks"]:      # live rel-pos tables
        for k in ("rel_pos_h", "rel_pos_w"):
            blk[k] = jnp.asarray(rng.standard_normal(blk[k].shape).astype(
                np.float32) * 0.3)
    return cfg, p, bridge_params(p, kind="sam")


def _masks_agree(got, want_logits):
    """Boolean masks equal but where the reference logit is within 1e-3 of
    the threshold."""
    bad = (got != (want_logits > 0)) & (np.abs(want_logits) >= 1e-3)
    assert not bad.any(), int(bad.sum())


def test_encode_and_decode_match_jax(sam):
    cfg, p, pt = sam
    px = np.random.default_rng(1).standard_normal((1, 64, 64, 3)).astype(
        np.float32)
    emb_j = JS.encode_image(p, cfg, jnp.asarray(px))
    emb_t = S.encode_image(pt, _port_cfg(cfg), tt(px))
    np.testing.assert_allclose(nn(emb_t), nn(emb_j), **TOL)
    pts = np.array([[[0.5, 0.5], [0.1, 0.9]], [[0.2, 0.8], [0.3, 0.3]]],
                   np.float32)
    lbl = np.array([[1, -1], [2, 3]], np.int32)
    sp_j = JS.encode_points(p, jnp.asarray(pts), jnp.asarray(lbl))
    sp_t = S.encode_points(pt, tt(pts), torch.from_numpy(lbl))
    np.testing.assert_allclose(nn(sp_t), nn(sp_j), atol=1e-5)
    m_j, iou_j = JS.decode_masks(p, cfg, emb_j[0], sp_j)
    m_t, iou_t = S.decode_masks(pt, _port_cfg(cfg), emb_t[0], sp_t)
    assert m_t.shape == (2, cfg.num_mask_tokens, 16, 16)
    np.testing.assert_allclose(nn(m_t), nn(m_j), **TOL)
    np.testing.assert_allclose(nn(iou_t), nn(iou_j), **TOL)


def test_predictor_box_and_points_match_jax(sam):
    cfg, p, pt = sam
    img = np.random.default_rng(2).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    pj = JS.SamPredictor(p, cfg)
    pj.set_image(img)
    ptp = S.SamPredictor(pt, _port_cfg(cfg))
    ptp.set_image(img)
    np.testing.assert_allclose(nn(ptp._embed), nn(pj._embed), **TOL)
    for kw in (dict(box=np.array([10, 12, 50, 58])),
               dict(points=np.array([[32.0, 24.0], [5.0, 40.0]]),
                    labels=np.array([1, 0]))):
        m_j, iou_j = pj.predict(**kw)
        m_t, iou_t = ptp.predict(**kw)
        assert m_t.shape == (cfg.num_mask_tokens, 64, 64)
        assert m_t.dtype == bool
        np.testing.assert_allclose(iou_t, np.asarray(iou_j), **TOL)
        # the reference's logits at full resolution (bilinear 16 -> 64)
        pts, lbl = [], []
        if "points" in kw:
            pts.append(kw["points"] / 64.0)
            lbl.append(kw["labels"])
        if "box" in kw:
            pts.append(np.asarray(kw["box"], np.float32).reshape(2, 2) / 64)
            lbl.append([2, 3])
        logits, _ = JS.decode_masks(p, cfg, pj._embed, JS.encode_points(
            p, jnp.asarray(np.concatenate(pts)[None], jnp.float32),
            jnp.asarray(np.concatenate(lbl)[None], jnp.int32)))
        full = nn(S.resize_logits(tt(logits[0]), 64, 64))
        _masks_agree(m_t, full)
        _masks_agree(np.asarray(m_j), full)


def test_automatic_masks_match_jax(sam):
    cfg, p, pt = sam
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    kw = dict(points_per_side=4, pred_iou_thresh=-1e9, nms_iou=0.5)
    res_j = JS.automatic_masks(JS.SamPredictor(p, cfg), img, **kw)
    res_t = S.automatic_masks(S.SamPredictor(pt, _port_cfg(cfg)), img, **kw)
    assert len(res_t) == len(res_j) > 1
    for a, b in zip(res_t, res_j):
        assert abs(a["predicted_iou"] - b["predicted_iou"]) < 1e-4
        assert a["segmentation"].shape == (64, 64)
        assert (a["segmentation"] != b["segmentation"]).mean() < 0.01
    # min_area applies after NMS at full resolution (fault R2, kept)
    big = min(r["area"] for r in res_j)
    kept_t = S.automatic_masks(S.SamPredictor(pt, _port_cfg(cfg)), img,
                               min_area=big, **kw)
    kept_j = JS.automatic_masks(JS.SamPredictor(p, cfg), img, min_area=big,
                                **kw)
    assert [r["area"] for r in kept_t] == [r["area"] for r in kept_j]


def test_device_nms_matches_host_oracle():
    """The cases of test_automask_device_nms_matches_host_oracle through
    the port's nms_stats and the greedy walk of automatic_masks."""
    g4 = 16
    cand = np.full((6, g4, g4), -1.0, np.float32)
    cand[0, :8, :8] = 1.0          # base block
    cand[1, :8, :8] = 1.0          # exact duplicate -> dropped
    cand[2, :8, :10] = 1.0         # IoU 0.8 with 0 -> dropped at 0.7
    cand[3, 8:, 8:] = 1.0          # disjoint -> kept
    cand[4, :4, :4] = 1.0          # IoU 0.25 with 0 -> kept
    cand[5] = -1.0                 # empty -> dropped (area 0)
    iou_scores = np.array([0.95, 0.93, 0.92, 0.91, 0.90, 0.89])
    areas, inter = S.nms_stats(tt(cand), torch.ones((g4, g4), dtype=bool))
    areas, inter = areas.numpy(), inter.numpy()
    kept = []
    for i in np.argsort(-iou_scores, kind="stable"):
        if areas[i] <= 0:
            continue
        if not any(inter[i, j] / (areas[i] + areas[j] - inter[i, j]) > 0.7
                   for j in kept if areas[i] + areas[j] - inter[i, j] > 0):
            kept.append(int(i))
    oracle = S.mask_nms(
        [{"segmentation": cand[i] > 0, "area": int((cand[i] > 0).sum()),
          "predicted_iou": float(iou_scores[i]), "idx": i}
         for i in range(6) if (cand[i] > 0).any()], iou_thresh=0.7)
    assert kept == [r["idx"] for r in oracle] == [0, 3, 4]
    bin_ = (cand > 0).reshape(6, -1).astype(np.float32)
    np.testing.assert_array_equal(inter, bin_ @ bin_.T)
    # the valid region masks the padded part of the grid
    valid = torch.zeros((g4, g4), dtype=bool)
    valid[:, :6] = True
    a2, _ = S.nms_stats(tt(cand), valid)
    assert a2[0].item() == 48


def test_mask_nms_matches_jax():
    rng = np.random.default_rng(4)
    res = [{"segmentation": rng.random((12, 12)) > t,
            "predicted_iou": float(s), "area": 0}
           for t, s in zip((0.5, 0.5, 0.9, 0.2, 0.52), rng.random(5))]
    res[1]["segmentation"] = res[0]["segmentation"].copy()
    got = S.mask_nms([dict(r, i=i) for i, r in enumerate(res)], 0.7)
    want = JS.mask_nms([dict(r, i=i) for i, r in enumerate(res)], 0.7)
    assert [r["i"] for r in got] == [r["i"] for r in want]
    assert len(got) < len(res)


def test_sam_matting_matches_jax(sam):
    """decomp/matting.sam_matting: the best multimask output of a box
    prompt, feathered (the torch Gaussian against OpenCV's)."""
    from mimo_tpu.decomp import matting as JM
    from mimo_tpu_torch.decomp import matting as M
    cfg, p, pt = sam
    img = np.random.default_rng(5).integers(0, 256, (64, 64, 3)).astype(
        np.uint8)
    for box in (None, np.array([8, 4, 56, 60])):
        rgba, found = M.sam_matting(img, S.SamPredictor(pt, _port_cfg(cfg)),
                                    box)
        rgba_j, found_j = JM.sam_matting(img, JS.SamPredictor(p, cfg), box)
        assert found == found_j
        np.testing.assert_array_equal(rgba, rgba_j)


@pytest.mark.parametrize("opencv", [True, False])
def test_set_image_shrinks_bilinearly_as_jax(sam, opencv, monkeypatch):
    """A frame wider than the encoder input (80x96 into 64): the pixels the
    port encodes equal the reference's (cv2's INTER_LINEAR) with OpenCV,
    and are within one uint8 level without it (the resize on the tensor's
    device), and the embeddings follow."""
    from mimo_tpu_torch.utils import frames as FU
    cfg, p, pt = sam
    img = np.random.default_rng(5).integers(0, 256, (80, 96, 3)).astype(
        np.uint8)
    pj = JS.SamPredictor(p, cfg)
    want = []
    encode = pj._encode
    pj._encode = lambda params, x: (want.append(np.asarray(x)),
                                    encode(params, x))[1]
    pj.set_image(img)
    if not opencv:
        monkeypatch.setattr(FU, "cv2", None)
    got = []
    encode_t = S.encode_image
    monkeypatch.setattr(S, "encode_image", lambda params, c, x: (
        got.append(nn(x)), encode_t(params, c, x))[1])
    ptp = S.SamPredictor(pt, _port_cfg(cfg))
    ptp.set_image(img)
    assert ptp._scaled == pj._scaled == (53, 64)
    if opencv:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(nn(ptp._embed), nn(pj._embed), **TOL)
    else:
        levels = [x[0] * S.SAM_STD + S.SAM_MEAN for x in (got[0], want[0])]
        assert np.abs(levels[0] - levels[1]).max() <= 1 + 1e-3
