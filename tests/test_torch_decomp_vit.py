"""The port's ViT encoder (mimo_tpu_torch/decomp/vit.py) in its three
forms and ViTPose (decomp/vitpose.py) against mimo_tpu/decomp/{vit,
vitpose}.py on the same numpy-seeded inputs, JAX parameters carried over
by the weights bridge, fp32 on the CPU.

Tolerance: atol/rtol 1e-4 for model outputs (fp32 on both sides, summation
order differs through the blocks); window round trips and the keypoint
decode exact; the person crop 1e-4 (OpenCV's float bilinear against
torch's).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mimo_tpu.decomp import hmr as JHMR
from mimo_tpu.decomp import vit as JV
from mimo_tpu.decomp import vitpose as JVP
from mimo_tpu_torch.decomp import vit as V
from mimo_tpu_torch.decomp import vitpose as VP
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def _port(cfg):
    return V.ViTConfig(**cfg.__dict__)


def _randomise(p, seed):
    """Non-trivial rel-pos tables, LayerScale and norms (zero / 1e-5 / one
    at init would hide them)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        if isinstance(t, dict):
            return {k: (jnp.asarray(rng.standard_normal(v.shape).astype(
                np.float32) * 0.3) if k in ("rel_pos_h", "rel_pos_w", "ls1",
                                              "ls2", "cls_token")
                        else walk(v)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        return t
    return walk(p)


VIT_CASES = {
    "plain": dict(img_size=(32, 32), patch_size=16, dim=32, depth=2,
                  num_heads=4),
    "cls_layerscale": dict(img_size=(32, 32), patch_size=16, dim=32,
                           depth=2, num_heads=4, use_cls_token=True,
                           layer_scale=True),
    "windowed_relpos": dict(img_size=(80, 80), patch_size=16, dim=32,
                            depth=2, num_heads=4, window_size=2,
                            global_blocks=(1,), use_rel_pos=True),
    "vitpose": dict(img_size=(64, 48), patch_size=16, dim=32, depth=2,
                    num_heads=4, patch_padding=4, cls_pos_to_all=True),
}


@pytest.mark.parametrize("name", sorted(VIT_CASES))
def test_vit_forms_match_jax(name):
    cfg = JV.ViTConfig(**VIT_CASES[name])
    p = _randomise(JV.vit_init(jax.random.PRNGKey(0), cfg), 1)
    h, w = cfg.img_size
    x = np.random.default_rng(2).standard_normal((2, h, w, 3)).astype(
        np.float32)
    tj, inter_j = JV.vit_apply(p, cfg, jnp.asarray(x),
                               return_intermediates=[0])
    tt_, inter_t = V.vit_apply(bridge_params(p), _port(cfg), tt(x),
                               return_intermediates=[0])
    np.testing.assert_allclose(nn(tt_), nn(tj), **TOL)
    np.testing.assert_allclose(nn(inter_t[0]), nn(inter_j[0]), **TOL)


def test_vit_pos_embed_interpolation_matches_jax():
    """A cls-token ViT run at a larger grid than its pos embed's."""
    cfg = JV.ViTConfig(img_size=(32, 32), patch_size=16, dim=32, depth=1,
                       num_heads=4, use_cls_token=True)
    p = JV.vit_init(jax.random.PRNGKey(3), cfg)
    x = np.random.default_rng(4).standard_normal((1, 80, 48, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        nn(V.vit_apply(bridge_params(p), _port(cfg), tt(x))),
        nn(JV.vit_apply(p, cfg, jnp.asarray(x))), **TOL)


def test_attn_plain_long_sequence_matches_jax():
    """S >= 1024 takes the flash dispatch (q/k/v column views); on the CPU
    that is the plain version, and it agrees with the JAX branch."""
    from mimo_tpu.models import layers as JL
    d, heads, s = 32, 4, 1030
    p = {"qkv": JL.linear_init(jax.random.PRNGKey(0), d, 3 * d),
         "proj": JL.linear_init(jax.random.PRNGKey(1), d, d)}
    x = np.random.default_rng(5).standard_normal((2, s, d)).astype(
        np.float32)
    np.testing.assert_allclose(
        nn(V._attn_plain(bridge_params(p), tt(x), heads)),
        nn(JV._attn_plain(p, jnp.asarray(x), heads)), **TOL)


@pytest.mark.parametrize("hgt,wid,ws", [(5, 7, 3), (4, 4, 2), (14, 9, 14)])
def test_window_partition_round_trip_matches_jax(hgt, wid, ws):
    x = np.random.default_rng(6).standard_normal((2, hgt * wid, 8)).astype(
        np.float32)
    w_t, pad_t = V._window_partition(tt(x), hgt, wid, ws)
    w_j, pad_j = JV._window_partition(jnp.asarray(x), hgt, wid, ws)
    assert pad_t == pad_j
    np.testing.assert_array_equal(nn(w_t), nn(w_j))
    back = V._window_unpartition(w_t, 2, hgt, wid, ws, pad_t)
    np.testing.assert_array_equal(nn(back), x)


def _port_vp(cfg):
    return VP.ViTPoseConfig(backbone=_port(cfg.backbone),
                            num_keypoints=cfg.num_keypoints,
                            deconv_channels=cfg.deconv_channels,
                            num_deconv=cfg.num_deconv,
                            flip_test=cfg.flip_test)


def _vitpose_params(seed):
    cfg = JVP.tiny_vitpose_config()
    p = JVP.vitpose_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for blk in p["deconvs"]:            # live BatchNorm statistics
        c = blk["bn_mean"].shape[0]
        blk["bn_mean"] = jnp.asarray(rng.standard_normal(c) * 0.1,
                                     jnp.float32)
        blk["bn_var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
        blk["bn_scale"] = jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)
    return cfg, p


def test_vitpose_heatmaps_flip_test_and_decode_match_jax():
    cfg, p = _vitpose_params(7)
    pt = bridge_params(p, kind="vitpose")
    crops = np.random.default_rng(8).standard_normal(
        (2, *cfg.backbone.img_size, 3)).astype(np.float32)
    hm_t = VP.heatmaps(pt, _port_vp(cfg), tt(crops))
    hm_j = JVP.heatmaps(p, cfg, jnp.asarray(crops))
    np.testing.assert_allclose(nn(hm_t), nn(hm_j), **TOL)
    pairs = [(1, 2), (3, 4)]
    ft = VP.heatmaps_flip_test(pt, _port_vp(cfg), tt(crops), pairs)
    fj = JVP.heatmaps_flip_test(p, cfg, jnp.asarray(crops), pairs)
    np.testing.assert_allclose(nn(ft), nn(fj), **TOL)
    # the decode on the same heatmaps is exact
    boxes = np.array([[0, 0, 48, 64], [10, 20, 96, 128]], np.float32)
    hm = np.asarray(fj)
    np.testing.assert_array_equal(VP.decode_keypoints(hm, boxes),
                                  JVP.decode_keypoints(hm, boxes))


def test_square_crop_and_estimate_pose_match_jax():
    cfg, p = _vitpose_params(9)
    rng = np.random.default_rng(10)
    frame = rng.integers(0, 256, (90, 70, 3)).astype(np.uint8)
    for bbox in (np.array([10.0, 5.0, 50.0, 80.0]),
                 np.array([-8.0, 30.0, 40.0, 100.0])):
        got, cs = VP.square_crop(frame, bbox, out_size=(64, 48))
        want, cs_j = JHMR.square_crop(frame, bbox, out_size=(64, 48))
        np.testing.assert_allclose(got, want, atol=1e-4)
        np.testing.assert_array_equal(cs, cs_j)
    # the factory's estimate_pose on the same crop
    bbox = np.array([10.0, 5.0, 50.0, 80.0])
    crop, cs = JHMR.square_crop(frame, bbox, out_size=(64, 48))
    hm = JVP.heatmaps_flip_test(p, cfg, jnp.asarray(crop[None]))
    half = cs[2] / 2
    want = JVP.decode_keypoints(np.asarray(hm), np.array(
        [[cs[0] - half, cs[1] - half, cs[2], cs[2]]]))[0]
    got = VP.estimate_pose(bridge_params(p, kind="vitpose"), _port_vp(cfg),
                           frame, bbox)
    np.testing.assert_allclose(got, want, **TOL)


def test_hand_boxes_match_jax():
    k = np.zeros((133, 3))
    k[-42:-21, 0] = np.linspace(10, 20, 21)
    k[-42:-21, 1] = np.linspace(30, 40, 21)
    k[-42:-21, 2] = 0.9
    k[-21:, 2] = 0.4
    got, want = VP.hand_boxes_from_keypoints(k), \
        JVP.hand_boxes_from_keypoints(k)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] is None and want[1] is None


@pytest.mark.parametrize("biased", [False, True], ids=["plain", "bias"])
def test_attention_heads_stays_off_cudnn(biased, monkeypatch):
    """``attention_heads`` runs its one SDPA call with cuDNN's attention
    disabled (it did not repeat its bits on the card), and gives the math
    backend's result."""
    import torch
    seen = []
    sdpa = V.F.scaled_dot_product_attention

    def spy(*args, **kwargs):
        seen.append(torch.backends.cuda.cudnn_sdp_enabled())
        return sdpa(*args, **kwargs)

    monkeypatch.setattr(V.F, "scaled_dot_product_attention", spy)
    assert torch.nn.attention.SDPBackend.CUDNN_ATTENTION not in \
        V.SDPA_BACKENDS
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((2, 7, 3, 8), generator=gen) for _ in range(3))
    bias = torch.randn((2, 3, 7, 7), generator=gen) if biased else None
    got = V.attention_heads(q, k, v, bias)
    assert seen == [False] and torch.backends.cuda.cudnn_sdp_enabled()
    with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.MATH):
        want = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=bias).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
