"""The port's ProPainter (mimo_tpu_torch/decomp/propainter.py) against
mimo_tpu/decomp/propainter.py on the tiny config, fp32 on the CPU, with
JAX-initialised params carried over by the weights bridge (the offset
stacks' zero-initialised last convs given small random values, so the
deformable alignment samples off the grid): the fold / unfold machinery,
the fusion feed-forward, the deformable alignment with and without the
flow prior, the flow completion and its combine, image and feature
propagation, sparse window attention with masked, unmasked and padded
windows, the generator over one window, the window blend, the reference
index, and inpaint_video end to end on a clip long enough to take every
chunk rule (T = 14 at 16x24: two RAFT clips, flow completion and image
propagation in padded chunks, capped reference frames).

Tolerance: atol 1e-4 for single modules (fp32 sums in another order);
2e-4 for the propagations and the generator; the end-to-end clip within
2e-3 (RAFT's flows, then four networks and two recurrences).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import propainter as JP
from mimo_tpu.decomp import raft as JR
from mimo_tpu_torch.decomp import propainter as P
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()


def _live_offsets(tree, rng):
    """Every offset stack's last conv (zero at init) given small random
    weights."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "c4":
                v = {n: jnp.asarray(rng.normal(0, 0.05, a.shape),
                                    jnp.float32) for n, a in v.items()}
            out[k] = _live_offsets(v, rng)
        return out
    if isinstance(tree, list):
        return [_live_offsets(v, rng) for v in tree]
    return tree


@pytest.fixture(scope="module")
def pp():
    cfg = JP.tiny_propainter_config()
    p = _live_offsets(JP.propainter_init(jax.random.PRNGKey(0), cfg),
                      np.random.default_rng(9))
    return cfg, p, bridge_params(p)


def test_unfold_and_fold_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    got = P._unfold(tt(x), (3, 3), (2, 2), (1, 1))
    want = JP._unfold(jnp.asarray(x), (3, 3), (2, 2), (1, 1))
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-6)
    cols = rng.standard_normal((2, 5, 6, 4 * 9)).astype(np.float32)
    got = P._fold(tt(cols), (9, 11), (3, 3), (2, 2), (1, 1))
    want = JP._fold(jnp.asarray(cols), (9, 11), (3, 3), (2, 2), (1, 1))
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-5)


def test_fusion_ff_and_align_corners_match_jax(pp):
    cfg, p, pt = pp
    blk, tblk = p["gen"]["blocks"][0], pt["gen"]["blocks"][0]
    x = np.random.default_rng(1).standard_normal(
        (2, 4, 5, cfg.hidden)).astype(np.float32)
    want = JP.fusion_ff(blk, cfg, jnp.asarray(x), (8, 10))
    got = P.fusion_ff(tblk, cfg, tt(x), (8, 10))
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-4)
    y = np.random.default_rng(2).standard_normal((2, 5, 7, 3)).astype(
        np.float32)
    np.testing.assert_allclose(nn(P._align_corners_2x(tt(y))),
                               nn(JP._align_corners_2x(jnp.asarray(y))),
                               atol=1e-5)


@pytest.mark.parametrize("with_flow", [False, True])
def test_deform_align_matches_jax(pp, with_flow):
    cfg, p, pt = pp
    rng = np.random.default_rng(3)
    c = cfg.channel
    key = "align_fwd"
    g = cfg.deform_groups
    if with_flow:     # the generator's flow-guided alignment
        ja, ta = p["gen"][key], pt["gen"][key]
        x = rng.standard_normal((1, 6, 7, c)).astype(np.float32)
        cond = rng.standard_normal((1, 6, 7, 2 * c + 5)).astype(np.float32)
        flow = (rng.standard_normal((1, 6, 7, 2)) * 2).astype(np.float32)
        want = JP._deform_align(ja, jnp.asarray(x), jnp.asarray(cond), g,
                                3.0, flow=jnp.asarray(flow))
        got = P._deform_align(ta, tt(x), tt(cond), g, 3.0, flow=tt(flow))
    else:             # the flow net's second-order alignment
        ja, ta = p["flow"]["prop"][key], pt["flow"]["prop"][key]
        c4 = 4 * cfg.fc_dim
        x = rng.standard_normal((1, 6, 7, 2 * c4)).astype(np.float32)
        cond = rng.standard_normal((1, 6, 7, 3 * c4)).astype(np.float32)
        want = JP._deform_align(ja, jnp.asarray(x), jnp.asarray(cond), g,
                                5.0)
        got = P._deform_align(ta, tt(x), tt(cond), g, 5.0)
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-4)


def test_forward_bidirect_flow_matches_jax(pp):
    cfg, p, pt = pp
    rng = np.random.default_rng(4)
    t, h, w = 5, 16, 24
    ff = rng.standard_normal((t - 1, h, w, 2)).astype(np.float32)
    fb = rng.standard_normal((t - 1, h, w, 2)).astype(np.float32)
    m = np.zeros((t, h, w, 1), np.float32)
    m[:, 4:10, 6:14] = 1
    wf, wb = JP.forward_bidirect_flow(p["flow"], cfg, jnp.asarray(ff),
                                      jnp.asarray(fb), jnp.asarray(m))
    gf, gb = P.forward_bidirect_flow(pt["flow"], cfg, tt(ff), tt(fb), tt(m))
    np.testing.assert_allclose(nn(gf), nn(wf), atol=2e-4)
    np.testing.assert_allclose(nn(gb), nn(wb), atol=2e-4)
    np.testing.assert_array_equal(nn(gf) * (1 - m[:-1]), ff * (1 - m[:-1]))


def test_img_and_feat_propagation_match_jax(pp):
    cfg, p, pt = pp
    rng = np.random.default_rng(5)
    t, h, w = 5, 12, 16
    frames = rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32)
    masks = np.zeros((t, h, w, 1), np.float32)
    masks[:, 3:8, 4:11] = 1
    masks[2, :2] = 1
    ff = (rng.standard_normal((t - 1, h, w, 2)) * 1.5).astype(np.float32)
    fb = -ff + rng.normal(0, 0.3, ff.shape).astype(np.float32)
    wi, wm = JP.img_propagation(jnp.asarray(frames * (1 - masks)),
                                jnp.asarray(ff), jnp.asarray(fb),
                                jnp.asarray(masks))
    gi, gm = P.img_propagation(tt(frames * (1 - masks)), tt(ff), tt(fb),
                               tt(masks))
    np.testing.assert_allclose(nn(gi), nn(wi), atol=2e-4)
    np.testing.assert_array_equal(nn(gm), nn(wm))

    c = cfg.channel
    feats = rng.standard_normal((t, 6, 8, c)).astype(np.float32)
    m2 = (rng.uniform(size=(t, 6, 8, 2)) > 0.6).astype(np.float32)
    sf = (rng.standard_normal((t - 1, 6, 8, 2))).astype(np.float32)
    sb = -sf + rng.normal(0, 0.3, sf.shape).astype(np.float32)
    want = JP.feat_propagation(p["gen"], cfg, jnp.asarray(feats),
                               jnp.asarray(sf), jnp.asarray(sb),
                               jnp.asarray(m2))
    got = P.feat_propagation(pt["gen"], cfg, tt(feats), tt(sf), tt(sb),
                             tt(m2))
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-4)


@pytest.mark.parametrize("case", ["masked", "unmasked", "mixed"])
def test_sparse_window_attention_matches_jax(pp, case):
    """fh x fw = 5 x 7 tokens in 2 x 3 windows: padded bottom and right;
    local masks on no window, every window, or some."""
    cfg, p, pt = pp
    rng = np.random.default_rng(6)
    t, lt, fh, fw = 4, 3, 5, 7
    x = rng.standard_normal((t, fh, fw, cfg.hidden)).astype(np.float32)
    mask = np.zeros((lt, fh, fw, 1), np.float32)
    if case == "masked":
        mask[:] = 1
    elif case == "mixed":
        mask[1, 0, 0] = 1
        mask[2, 4, 6] = 1
    t_ind = (1, 3)
    blk, tblk = p["gen"]["blocks"][1], pt["gen"]["blocks"][1]
    want = JP.sparse_window_attention(blk, cfg, jnp.asarray(x),
                                      jnp.asarray(mask), np.asarray(t_ind))
    got = P.sparse_window_attention(tblk, cfg, tt(x), tt(mask), t_ind)
    np.testing.assert_allclose(nn(got), nn(want), atol=1e-4)


def test_inpaint_forward_matches_jax(pp):
    cfg, p, pt = pp
    rng = np.random.default_rng(7)
    t, h, w, lt = 6, 24, 32, 4
    frames = rng.uniform(-1, 1, (t, h, w, 3)).astype(np.float32)
    masks = np.zeros((t, h, w, 1), np.float32)
    masks[:, 8:16, 10:22] = 1
    upd = masks.copy()
    upd[1, 8:12] = 0
    flows = (rng.standard_normal((2, lt - 1, h, w, 2)) * 2).astype(
        np.float32)
    want = JP.inpaint_forward(p["gen"], cfg, jnp.asarray(frames),
                              jnp.asarray(flows[0]), jnp.asarray(flows[1]),
                              jnp.asarray(masks), jnp.asarray(upd), lt)
    got = P.inpaint_forward(pt["gen"], cfg, tt(frames), tt(flows[0]),
                            tt(flows[1]), tt(masks), tt(upd), lt)
    assert got.shape == (lt, h, w, 3)
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-4)


def test_blend_window_and_ref_index_match_jax():
    rng = np.random.default_rng(8)
    t, h, w = 9, 6, 5
    frames = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    masks = (rng.uniform(size=(t, h, w, 1)) > 0.5).astype(np.float32)
    jc, js = jnp.zeros((t, h, w, 3)), jnp.zeros((t, 1, 1, 1))
    tc, ts = torch.zeros((t, h, w, 3)), torch.zeros((t, 1, 1, 1))
    for f in range(0, t, 3):
        win = list(range(max(0, f - 3), min(t, f + 4)))
        pred = rng.uniform(-1, 1, (len(win), h, w, 3)).astype(np.float32)
        jc, js = JP._blend_window(jc, js, jnp.asarray(pred),
                                  jnp.asarray(frames), jnp.asarray(masks),
                                  win[0])
        P._blend_window(tc, ts, tt(pred), tt(frames), tt(masks), win[0])
    np.testing.assert_allclose(nn(tc), nn(jc), atol=1e-6)
    for args in ((0, [0, 1, 2], 10, 4, -1), (5, [4, 5, 6], 12, 2, 2),
                 (13, [11, 12, 13], 14, 4, 2), (40, list(range(35, 46)), 48,
                                                10, 8)):
        assert P._get_ref_index(*args) == JP._get_ref_index(*args)


def test_inpaint_video_end_to_end_matches_jax(pp):
    cfg, p, pt = pp
    rcfg = JR.tiny_raft_config()
    rp = JR.raft_init(jax.random.PRNGKey(1), rcfg)
    rng = np.random.default_rng(10)
    t, h, w = 14, 16, 24
    assert t > P.raft_clip(w) and t - 1 > P.fc_chunk(cfg, h, w) \
        and t > min(100, cfg.subvideo_length) and t > cfg.subvideo_length
    frames = rng.uniform(0, 1, (t, h, w, 3)).astype(np.float32)
    masks = np.zeros((t, h, w, 1), np.float32)
    for i in range(t):
        masks[i, 4:10, 3 + i % 5:12 + i % 5] = 1
    want = JP.inpaint_video(p, cfg, rp, rcfg, jnp.asarray(frames),
                            jnp.asarray(masks))
    got = P.inpaint_video(pt, cfg, bridge_params(rp), rcfg, tt(frames),
                          tt(masks))
    assert got.shape == (t, h, w, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(nn(got), nn(want), atol=2e-3)
    outside = np.broadcast_to(masks == 0, frames.shape)
    np.testing.assert_allclose(nn(got)[outside], frames[outside], atol=1e-6)


def test_init_tree_matches_jax():
    cfg = P.tiny_propainter_config()
    got = P.propainter_init(torch.Generator().manual_seed(0), cfg)
    want = bridge_params(JP.propainter_init(jax.random.PRNGKey(0), cfg))

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for x, y in zip(a, b):
                walk(x, y, path)
        else:
            assert tuple(a.shape) == tuple(b.shape), path
    walk(got, want)
