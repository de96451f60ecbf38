"""The port's SAM2 (mimo_tpu_torch/decomp/sam2.py) against
mimo_tpu/decomp/sam2.py on the cases of tests/test_sam2_parity.py and
tests/test_sam2_hmr.py: RoPE self- and cross-attention, the memory
attention stack (all slots valid, and the port's valid-slots-only against
the JAX package's -inf masked ring), the memory encoder, the decoder heads,
propagation forwards and backwards, a mid-frame prompt and track_object.
Same numpy-seeded inputs, JAX-initialised tiny params through the weights
bridge, fp32 on the CPU.

Frames are at the model's square size (64x64), so both resizes are
identities. Tolerance: activations and logits atol/rtol 1e-4 (fp32 on both
sides; the propagation loop runs a few frames deep), boolean masks equal
except where |logit| < 1e-3.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from mimo_tpu.decomp import sam2 as JS2
from mimo_tpu_torch.decomp import hiera as H
from mimo_tpu_torch.decomp import sam as S
from mimo_tpu_torch.decomp import sam2 as S2
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt

set_fp32_matmuls()

TOL = dict(atol=1e-4, rtol=1e-4)


def port_cfg(cfg):
    h = cfg.hiera
    hc = H.HieraConfig(**{f: getattr(h, f) for f in (
        "embed_dim", "num_heads", "stages", "window_spec", "global_blocks",
        "input_size", "pos_bkg_size", "mlp_ratio", "neck_dim", "ln_eps")})
    return S2.SAM2Config(hiera=hc, **{f: getattr(cfg, f) for f in (
        "dim", "mem_dim", "num_maskmem", "mem_layers", "mem_heads", "mem_ff",
        "max_obj_ptrs", "num_mask_tokens", "decoder_heads", "rope_theta",
        "sigmoid_scale_mem", "sigmoid_bias_mem", "stability_delta",
        "stability_thresh")})


@pytest.fixture(scope="module")
def model():
    cfg = JS2.tiny_sam2_config()
    p = JS2.sam2_init(jax.random.PRNGKey(0), cfg)
    # the LayerScale gammas (1e-6 at init) would hide the memory fuser
    for blk in p["mem_enc"]["fuser"]:
        blk["gamma"] = jnp.full_like(blk["gamma"], 0.5)
    return cfg, p, bridge_params(p, kind="sam2")


def _frames(seed, n, h=64, w=64):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for _ in range(n)]


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _masks_agree(got, want_logits):
    bad = (got != (want_logits > 0)) & (np.abs(want_logits) >= 1e-3)
    assert not bad.any(), int(bad.sum())


@pytest.mark.parametrize("kv_in,m,n_ptr", [(None, 1, 0), (8, 3, 4)])
def test_rope_attention_matches_jax(kv_in, m, n_ptr):
    d, heads, g = 16, 2, 4
    p = JS2._rope_attn_init(jax.random.PRNGKey(0), d, kv_in=kv_in)
    s = g * g
    q = _rand(1, 1, s, d)
    kv = q if kv_in is None else _rand(2, 1, m * s + n_ptr, kv_in)
    ang = JS2.axial_rope_angles(d // heads, g, g)
    cos, sin = np.cos(ang), np.sin(ang)
    kw = {} if kv_in is None else dict(repeat_k=m, k_rope_len=m * s)
    want = JS2._rope_attention(p, jnp.asarray(q), jnp.asarray(kv),
                               jnp.asarray(kv), heads, jnp.asarray(cos),
                               jnp.asarray(sin), **kw)
    got = S2._rope_attention(bridge_params(p), tt(q), tt(kv), tt(kv), heads,
                             tt(cos), tt(sin), **kw)
    np.testing.assert_allclose(nn(got), nn(want), **TOL)
    np.testing.assert_array_equal(
        S2.axial_rope_angles(d // heads, g, g), ang)


@pytest.mark.parametrize("valid_mems,valid_ptrs", [(3, 2), (2, 1)])
def test_memory_attention_matches_jax(model, valid_mems, valid_ptrs):
    """All slots valid, and a ring with empty slots: the JAX package masks
    them with -inf, the port is handed the valid ones only."""
    cfg, p, pt = model
    g, d, md, m = 4, cfg.dim, cfg.mem_dim, cfg.num_maskmem
    split = d // md
    feat, feat_pos = _rand(1, g, g, d), _rand(2, g, g, d)
    mem, mem_pos = _rand(3, m, g, g, md), _rand(4, m, g, g, md)
    ptr = _rand(5, 2 * split, md)
    mem_valid = (np.arange(m) < valid_mems).astype(np.float32)
    ptr_valid = np.repeat(np.arange(2) < valid_ptrs, split).astype(np.float32)
    want = JS2.memory_attention(p, cfg, jnp.asarray(feat),
                                jnp.asarray(feat_pos), jnp.asarray(mem),
                                jnp.asarray(mem_pos), jnp.asarray(mem_valid),
                                jnp.asarray(ptr), jnp.asarray(ptr_valid))
    got = S2.memory_attention(pt, port_cfg(cfg), tt(feat), tt(feat_pos),
                              tt(mem[:valid_mems]), tt(mem_pos[:valid_mems]),
                              tt(ptr[:valid_ptrs * split]))
    np.testing.assert_allclose(nn(got), nn(want), **TOL)


def test_memory_encoder_matches_jax(model):
    cfg, p, pt = model
    g = cfg.image_size // 16
    feat = _rand(6, g, g, cfg.dim)
    mask = _rand(7, cfg.image_size, cfg.image_size, scale=5.0)
    np.testing.assert_allclose(
        nn(S2.encode_memory(pt, port_cfg(cfg), tt(feat), tt(mask))),
        nn(JS2.encode_memory(p, cfg, jnp.asarray(feat), jnp.asarray(mask))),
        **TOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_encode_and_sam_heads_match_jax(model, multimask):
    cfg, p, pt = model
    px = _rand(8, 2, 64, 64, 3)
    fj = JS2.encode_frames(p, cfg, jnp.asarray(px))
    ft = S2.encode_frames(pt, port_cfg(cfg), tt(px))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(nn(a), nn(b), **TOL)
    pts = np.array([[[20.0, 30.0], [40.0, 10.0]]], np.float32)
    lbl = np.array([[1, 0]], np.int32)
    sp_j = JS2.encode_points(p, cfg, jnp.asarray(pts), jnp.asarray(lbl))
    sp_t = S2.encode_points(pt, port_cfg(cfg), tt(pts), torch.from_numpy(lbl))
    np.testing.assert_allclose(nn(sp_t), nn(sp_j), atol=1e-5)
    for sparse_j, sparse_t in ((sp_j, sp_t), (None, None)):
        want = JS2.forward_sam_heads(p, cfg, fj[0][1], fj[2][1], fj[1][1],
                                     sparse_j, multimask)
        got = S2.forward_sam_heads(pt, port_cfg(cfg), ft[0][1], ft[2][1],
                                   ft[1][1], sparse_t, multimask)
        for a, b in zip(got, want):
            np.testing.assert_allclose(nn(a), nn(b), **TOL)


def _pair(model, frames):
    cfg, p, pt = model
    pj = JS2.SAM2VideoPredictor(p, cfg)
    pj.init_state(frames)
    ptp = S2.SAM2VideoPredictor(pt, port_cfg(cfg))
    ptp.init_state(frames, enc_chunk=3)         # a short last chunk
    for a, b in zip(ptp._feats, pj._feats):
        np.testing.assert_allclose(nn(a), nn(b), **TOL)
    return pj, ptp


@pytest.mark.parametrize("prompt_frame,n_frames", [(0, 5), (2, 6)])
def test_propagate_matches_jax(model, prompt_frame, n_frames):
    """Forward and backward propagation from a first-frame and a mid-frame
    prompt: the low-res logits of every tracked frame, the masks, and the
    untracked side left empty. 6 frames fill the tiny config's ring (2
    recent memories, 3 pointers) and wrap it."""
    cfg, _, _ = model
    frames = _frames(9, n_frames)
    pj, ptp = _pair(model, frames)
    pts, lbl = np.array([[32.0, 24.0]]), np.array([1])
    m0_j = pj.add_new_points(prompt_frame, pts, lbl)
    m0_t = ptp.add_new_points(prompt_frame, pts, lbl)
    np.testing.assert_allclose(nn(ptp._cond["low_res"]),
                               nn(pj._cond["low_res"]), **TOL)
    np.testing.assert_allclose(nn(ptp._cond["mem"]), nn(pj._cond["mem"]),
                               **TOL)
    _masks_agree(m0_t, nn(S.resize_logits(tt(pj._cond["low_res"]), 64, 64)))
    for reverse in (False, True):
        order = (list(range(prompt_frame - 1, -1, -1)) if reverse
                 else list(range(prompt_frame + 1, n_frames)))
        if not order:
            continue
        f16, s1, s0, pos16 = pj._feats
        want = JS2._propagate_scan(cfg, pj.p, f16, s1, s0, pos16,
                                   pj._cond["mem"], pj._cond["ptr"],
                                   jnp.asarray(order))
        got = ptp.propagate_logits(order)
        np.testing.assert_allclose(nn(got), nn(want), **TOL)
        masks = ptp.propagate_in_video(reverse=reverse)
        assert masks.shape == (n_frames, 64, 64) and masks.dtype == bool
        untracked = [t for t in range(n_frames)
                     if t != prompt_frame and t not in order]
        assert not masks[untracked].any()
        np.testing.assert_array_equal(masks[prompt_frame], m0_t)
        full = nn(S.resize_logits(tt(want), 64, 64))
        _masks_agree(masks[order], full)


def test_track_object_matches_jax(model):
    cfg, p, pt = model
    frames = _frames(10, 4, 48, 64)
    pts, lbl = np.array([[20.0, 16.0], [40.0, 30.0]]), np.array([1, 1])
    want = JS2.track_object(p, cfg, frames, pts, lbl)
    got = S2.track_object(pt, port_cfg(cfg), frames, pts, lbl)
    assert got.shape == (4, 48, 64) and got.dtype == bool
    assert 0 < want.mean() < 1
    # 48x64 frames resized to 64x64 both ways (the port's resize_frame is
    # OpenCV's INTER_LINEAR where OpenCV is installed); no logit of this
    # seed lies within 1e-3 of 0, so the masks are equal
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("opencv", [True, False])
def test_init_state_shrinks_bilinearly_as_jax(model, opencv, monkeypatch):
    """Frames wider and taller than the model input (80x96 into 64x64): the
    pixels the port encodes equal the reference's (cv2's INTER_LINEAR) with
    OpenCV, and are within one uint8 level without it (the resize on the
    tensor's device); the features follow with OpenCV."""
    from mimo_tpu_torch.utils import frames as FU
    cfg, p, pt = model
    frames = _frames(6, 3, h=80, w=96)
    want, got = [], []
    encode_j, encode_t = JS2.encode_frames, S2.encode_frames
    with monkeypatch.context() as m:
        # eager, so the reference's pixels can be read on their way in
        m.setattr(JS2.jax, "jit", lambda fn, **kw: fn)
        m.setattr(JS2, "encode_frames", lambda params, c, x: (
            want.append(np.asarray(x, np.float64)), encode_j(params, c, x))[1])
        pj = JS2.SAM2VideoPredictor(p, cfg)
        pj.init_state(frames)
    if not opencv:
        monkeypatch.setattr(FU, "cv2", None)
    monkeypatch.setattr(S2, "encode_frames", lambda params, c, x: (
        got.append(nn(x)), encode_t(params, c, x))[1])
    ptp = S2.SAM2VideoPredictor(pt, port_cfg(cfg))
    ptp.init_state(frames)
    if opencv:
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(ptp._feats, pj._feats):
            np.testing.assert_allclose(nn(a), nn(b), **TOL)
    else:
        levels = [(x * S2.IMG_STD + S2.IMG_MEAN) * 255 for x in (got[0],
                                                                 want[0])]
        assert np.abs(levels[0] - levels[1]).max() <= 1 + 1e-3
