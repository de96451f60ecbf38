"""The port's window accumulation (pipelines/pose2vid.py) against
mimo_tpu's ``.at[].add`` scatter, and the order of its adds.

The port adds one window at a time (``accumulate_windows``: one
``index_add_`` per window, whose frame indices are distinct), so no scatter
call adds twice to one frame and the sum does not depend on the order of
atomics on CUDA. mimo_tpu scatters a whole chunk of windows in one
``.at[].add``.

Tolerance: rtol 1e-6, atol 1e-6 on fp32 sums. Both sides take the same
products (prediction × window weight); a frame that several windows share
gets its adds in window order on the port's side and in the scatter's order
on mimo_tpu's, so the sums may differ in their last bits.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from mimo_tpu import config as JC
from mimo_tpu.pipelines import pose2vid as JP
from mimo_tpu_torch import config as C
from mimo_tpu_torch.pipelines import pose2vid as P
from mimo_tpu_torch.pipelines.context import compute_windows
from tests.test_torch_helpers import nn, tt

TOL = dict(rtol=1e-6, atol=1e-6)
LATENT = (3, 5, 4)     # (h, w, 4) of a tiny latent frame


# (frames, context, stride, overlap, pad_to_multiple): the full-width
# defaults on a 32-frame clip (two windows that wrap around) and on a
# 41-frame clip (three, some frames in all three), a longer clip with
# dilated windows, and weight-0 padding windows
WINDOWS = [
    pytest.param(32, 24, 1, 4, 1, id="32f-ctx24"),
    pytest.param(41, 24, 1, 4, 1, id="41f-ctx24-three-deep"),
    pytest.param(30, 8, 2, 2, 1, id="30f-ctx8-dilated"),
    pytest.param(14, 6, 1, 2, 4, id="14f-ctx6-padded"),
]


def _preds(rng, n_windows, cs):
    return rng.standard_normal((n_windows, cs) + LATENT).astype(np.float32)


@pytest.mark.parametrize("frames,context,stride,overlap,pad", WINDOWS)
def test_accumulate_windows_matches_jax_scatter(frames, context, stride,
                                                overlap, pad):
    win, wts = compute_windows(frames, context, stride, overlap,
                               pad_to_multiple=pad)
    # overlapping windows: some frame is in two of them
    assert np.bincount(win.reshape(-1), minlength=frames).max() > 1
    rng = np.random.default_rng(frames)
    preds = _preds(rng, *win.shape)
    wt = jnp.asarray(wts)[:, None, None, None, None]
    ref = jnp.zeros((frames,) + LATENT, jnp.float32).at[
        jnp.asarray(win).reshape(-1)].add(
            (jnp.asarray(preds) * wt).reshape((-1,) + LATENT))
    got = torch.zeros((frames,) + LATENT)
    P.accumulate_windows(got, tt(preds),
                         torch.as_tensor(win, dtype=torch.long), tt(wts))
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)


def _stand_in_unet(cfg_split: bool):
    """A UNet stand-in for both packages: a fixed function of each window's
    latents, another one for the uncond half under CFG."""
    def pred(lat_w, xp):
        cond = xp.tanh(lat_w * 1.5 + 0.25)
        if not cfg_split:
            return cond
        return xp.concatenate([xp.sin(lat_w) * 0.5, cond], axis=0)
    return pred


@pytest.mark.parametrize("guidance", [3.5, 1.0])
@pytest.mark.parametrize("window_chunk", [None, 2])
def test_accumulate_step_matches_jax(monkeypatch, guidance, window_chunk):
    """One step's combined v-prediction (scatter, overlap counter, CFG) of
    both packages, on a stand-in UNet over overlapping windows."""
    frames, h, w = 10, 3, 5
    st_j = JP.Pose2VideoStatic(cfg=JC.tiny_mimo_config(), num_frames=frames,
                               height=8 * h, width=8 * w,
                               num_inference_steps=2, guidance_scale=guidance)
    st_t = P.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=frames,
                              height=8 * h, width=8 * w,
                              num_inference_steps=2, guidance_scale=guidance,
                              window_chunk=window_chunk)
    win, wts = P.make_windows(st_t)
    assert win.shape[0] >= 3
    pred = _stand_in_unet(guidance > 1.0)
    monkeypatch.setattr(
        JP, "_run_unet_window_chunk",
        lambda params, st, cond, lat, t, w_idx, size, frame_axis_override=None:
        pred(lat[w_idx], jnp))
    monkeypatch.setattr(
        P, "_run_unet_window_chunk",
        lambda params, st, cond, lat, t, w_idx: pred(lat[w_idx], torch))
    lat = np.random.default_rng(5).standard_normal(
        (frames, h, w, 4)).astype(np.float32)
    ref = JP._accumulate_step(
        None, st_j, {}, jnp.asarray(lat), 500.0, jnp.asarray(win),
        jnp.asarray(wts), JP._window_counter(frames, jnp.asarray(win),
                                             jnp.asarray(wts)),
        window_chunk or win.shape[0], True)
    got = P._accumulate_step(
        None, st_t, {}, tt(lat), 500.0, win, wts,
        torch.as_tensor(P._window_counter(frames, win, wts)))
    np.testing.assert_allclose(nn(got), nn(ref), **TOL)


def test_no_scatter_call_repeats_an_index(monkeypatch):
    """Every index_add_ of a step gets distinct frames, though the step's
    one chunk holds overlapping windows (so a scatter of the whole chunk
    would repeat frames)."""
    frames = 41
    st = P.Pose2VideoStatic(cfg=C.MIMOConfig(), num_frames=frames, height=24,
                            width=40, num_inference_steps=2,
                            guidance_scale=3.5)
    win, wts = P.make_windows(st)
    assert len(np.unique(win.reshape(-1))) < win.size   # overlapping chunk
    pred = _stand_in_unet(True)
    monkeypatch.setattr(
        P, "_run_unet_window_chunk",
        lambda params, st, cond, lat, t, w_idx: pred(lat[w_idx], torch))
    calls = []
    index_add = torch.Tensor.index_add_

    def recording_index_add(self, dim, index, source, *args, **kwargs):
        calls.append(index.clone())
        return index_add(self, dim, index, source, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "index_add_", recording_index_add)
    lat = torch.randn((frames, 3, 5, 4), generator=torch.Generator()
                      .manual_seed(0))
    P._accumulate_step(None, st, {}, lat, 500.0, win, wts,
                       torch.as_tensor(P._window_counter(frames, win, wts)))
    assert len(calls) == 2 * win.shape[0]      # uncond and cond, per window
    for index in calls:
        assert index.numel() == len(torch.unique(index))
