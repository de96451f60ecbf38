"""The port's tiny generation against mimo_tpu's pose2vid.generate_fn on
the same parameters (bridged), inputs and numpy noise, fp32 on the CPU; and
the port's animate entry point driven from frames in memory.

Tolerance: atol 2e-4 on [0, 1] pixels. Both sides run fp32; summation
order differs through prepare (VAE, CLIP, reference UNet), two denoising
UNet passes and the decoder.
"""

import numpy as np
import pytest
import torch

from mimo_tpu import config as JC
from mimo_tpu.pipelines import pose2vid as JP
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry.animate import animate
from mimo_tpu_torch.entry.runner import Runner, init_random_params
from mimo_tpu_torch.pipelines import pose2vid as P
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt
from tests.test_pipeline import tiny_inputs, tiny_params

set_fp32_matmuls()

ATOL = 2e-4


@pytest.mark.parametrize("frames,guidance,window_chunk,interp,interp_mode", [
    # one window, CFG
    pytest.param(6, 3.5, None, 0, "slerp", id="6-3.5-None"),
    # several overlapping windows, run in chunks
    pytest.param(10, 3.5, 2, 0, "slerp", id="10-3.5-2"),
    # no CFG
    pytest.param(6, 1.0, None, 0, "slerp", id="6-1.0-None"),
    # latent interpolation before the decode, both modes
    pytest.param(6, 3.5, None, 2, "slerp", id="6-3.5-None-interp2-slerp"),
    pytest.param(6, 3.5, None, 2, "linear", id="6-3.5-None-interp2-linear"),
])
def test_generation_matches_jax(frames, guidance, window_chunk, interp,
                                interp_mode):
    cfg = JC.tiny_mimo_config()
    h = w = 32
    params = tiny_params(cfg)
    inputs = [np.asarray(a, np.float32) for a in tiny_inputs(cfg, frames, h,
                                                             w)]
    st_j = JP.Pose2VideoStatic(cfg=cfg, num_frames=frames, height=h, width=w,
                               num_inference_steps=2,
                               guidance_scale=guidance,
                               interpolation_factor=interp,
                               interpolation_mode=interp_mode)
    ref = np.asarray(JP.generate_fn(params, st_j, *inputs))
    st_t = P.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=frames,
                              height=h, width=w, num_inference_steps=2,
                              guidance_scale=guidance,
                              window_chunk=window_chunk,
                              interpolation_factor=interp,
                              interpolation_mode=interp_mode)
    got = P.generate_host_loop(bridge_params(params), st_t,
                               *[tt(a) for a in inputs])
    out_frames = (frames - 1) * interp + 1 if interp >= 2 else frames
    assert got.shape == (out_frames, h, w, 3)
    np.testing.assert_allclose(nn(got), ref, atol=ATOL)


def test_prepare_conditioning_matches_jax():
    cfg = JC.tiny_mimo_config()
    frames, h, w = 4, 32, 32
    params = tiny_params(cfg)
    ref_img, pose, bk, clip_px, _ = [np.asarray(a, np.float32)
                                     for a in tiny_inputs(cfg, frames, h, w)]
    st_j = JP.Pose2VideoStatic(cfg=cfg, num_frames=frames, height=h, width=w,
                               num_inference_steps=2, guidance_scale=3.5)
    st_t = P.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=frames,
                              height=h, width=w, num_inference_steps=2,
                              guidance_scale=3.5, vae_chunk=3)
    ref = JP.prepare_conditioning(params, st_j, ref_img, pose, bk, clip_px)
    got = P.prepare_conditioning(bridge_params(params), st_t, tt(ref_img),
                                 tt(pose), tt(bk), tt(clip_px))
    for key in ("ctx_cond", "ctx_uncond", "ref_latents", "bk_latents",
                "pose_fea"):
        np.testing.assert_allclose(nn(got[key]), nn(ref[key]), atol=1e-4,
                                   err_msg=key)
    assert len(got["cond_banks"]) == len(ref["cond_banks"])
    for gb, rb in zip(got["cond_banks"], ref["cond_banks"]):
        np.testing.assert_allclose(nn(gb), nn(rb), atol=1e-4)


def test_window_counter_matches_jax():
    import jax.numpy as jnp
    st = P.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=10,
                            height=32, width=32, num_inference_steps=2,
                            guidance_scale=3.5)
    win, wts = P.make_windows(st)
    np.testing.assert_array_equal(
        P._window_counter(10, win, wts),
        np.asarray(JP._window_counter(10, jnp.asarray(win),
                                      jnp.asarray(wts))))


def _template():
    frames = []
    for t in range(5):
        f = np.zeros((80, 60, 3), np.uint8)
        f[15:70, 20 + t:40 + t] = (120, 180, 90)
        frames.append(f)
    ref = np.full((70, 50, 3), 255, np.uint8)
    ref[10:60, 15:35] = (30, 60, 160)
    return ref, frames


def test_animate_from_frames_in_memory():
    """The entry point a user calls, with no template directory and no
    video codec: shape, range, determinism under one seed, and the phase
    times it reports."""
    cfg = C.tiny_mimo_config()
    params = init_random_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    runner = Runner(cfg=cfg, params=params, device=torch.device("cpu"),
                    dtype=torch.float32)
    ref, frames = _template()
    kw = dict(width=32, height=24, steps=2, cfg_scale=3.5, seed=3)
    a = animate(runner, ref, frames, **kw)
    b = animate(runner, ref, frames, **kw)
    assert a.shape == (5, 24, 32, 3) and a.dtype == np.float32
    assert np.isfinite(a).all() and a.min() >= 0.0 and a.max() <= 1.0
    assert a.std() > 1e-3
    np.testing.assert_array_equal(a, b)
    tm = runner.last_timings
    assert set(tm) == {"prepare", "step_mean", "decode", "steps", "step_ms",
                       "clip", "spans", "h2d_bytes", "d2h_bytes"}
    assert tm["steps"] == 2 and len(tm["step_ms"]) == 2
    assert tm["step_mean"] == pytest.approx(sum(tm["step_ms"]) / 2)
    assert tm["clip"] == runner.clip_id == 2
    assert [s["name"] for s in tm["spans"]] == [
        "entry.animate", "entry.template", "entry.reference", "entry.inputs",
        "entry.output"]


def test_cli_validates_template_before_model_init(tmp_path):
    """The CLI fails on a missing template before it builds any weights."""
    from mimo_tpu_torch.entry.animate import main
    with pytest.raises(FileNotFoundError, match="sdc.mp4"):
        main(["--ref", str(tmp_path / "ref.png"), "--template",
              str(tmp_path / "missing"), "--output",
              str(tmp_path / "out.mp4")])


def test_cli_needs_cuda_after_input_checks(tmp_path, monkeypatch):
    """With valid inputs and no CUDA device, the CLI raises a RuntimeError
    that names CUDA, and builds no weights: no CPU fallback."""
    import types
    from mimo_tpu_torch.entry import animate as AN
    monkeypatch.setattr(AN, "load_template",
                        lambda path, max_frames: types.SimpleNamespace(
                            fps=30, sdc=[np.zeros((8, 8, 3), np.uint8)]))
    monkeypatch.setattr(AN.VIO, "load_image",
                        lambda path: np.zeros((8, 8, 3), np.uint8))
    built = []
    monkeypatch.setattr(AN, "init_random_params",
                        lambda *a, **k: built.append("random"))
    monkeypatch.setattr(AN, "load_params", lambda *a, **k: built.append("npz"))
    monkeypatch.setattr(AN.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        AN.main(["--ref", str(tmp_path / "ref.png"), "--template",
                 str(tmp_path / "tpl"), "--output", str(tmp_path / "o.mp4"),
                 "--interp", "2"])
    assert built == []


def test_load_params_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """load_params loads onto the card by default: without CUDA it raises a
    RuntimeError naming CUDA; device='cpu' loads the bundle."""
    from mimo_tpu_torch.entry.runner import load_params
    path = tmp_path / "w.npz"
    np.savez(path, **{"unet/conv_in/kernel": np.ones((3, 3, 4, 8), np.float32),
                      "unet/conv_in/bias": np.zeros(8, np.float32)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_params(str(path))
    tree = load_params(str(path), device="cpu", dtype=torch.float32)
    conv = tree["unet"]["conv_in"]
    assert conv["kernel"].device.type == "cpu"
    assert conv["kernel"].shape == (8, 4, 3, 3)          # HWIO -> OIHW
    assert float(conv["kernel"].sum()) == 3 * 3 * 4 * 8
