"""The port's sharded generation (mimo_tpu_torch/pipelines/pose2vid.py over
a parallel.ProcessMesh, models/unet.py's frame-sharded motion modules) on
gloo CPU worlds of 2 and 4 ranks, on tests/test_pipeline.py's tiny
configurations, parameters and inputs (fp32):

- frame-sharded: 8 frames 32x32, one window, worlds 2 and 4 (the latent
  levels' 16 / 4 / 1 positions take the all-to-all and, at 1 position,
  the all-gather branch), and at world 2 with the latent interpolation
  (x3: the latents gathered first, 22 frames decoded frame-sharded);
- window DP: 10 frames, the window count padded to the world;
- the hybrid tail: 52 frames, context 8 / overlap 4, 13 windows on 4
  ranks: 12 window-parallel, 1 frame-sharded, no padded window run (the
  window-frames each rank's UNet ran are counted);
- 2-D: a (2, 2) ("data", "frame") world, 12 frames, context 8 / overlap 4,
  the window count padded to 2.

Each is held against the port's single-process result at atol 2e-5 (the
JAX package's own bound for its sharded paths) and against the JAX
package's output at atol 2e-4 on [0, 1] pixels (tests/test_torch_pipeline.py):
for the frame-sharded mode JAX's sharded output on tests/test_pipeline.py's
8-device mesh (its all-to-all), for the rest (and the frame-sharded run
with the latent interpolation, whose 22 frames do not split over 8
devices) JAX's single-device output, which tests/test_pipeline.py holds to
its sharded one. Every rank must return the whole video.
"""

import dataclasses

import numpy as np
import pytest
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mimo_tpu import config as JC
from mimo_tpu.pipelines import pose2vid as JP
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry import graft
from mimo_tpu_torch.pipelines import pose2vid as TP
from tests.test_pipeline import tiny_inputs, tiny_params
from tests.test_torch_helpers import bridge_params, set_fp32_matmuls, tt

set_fp32_matmuls()

H = W = 32
SELF_ATOL, JAX_ATOL = 2e-5, 2e-4


def _cfg(pkg, **pipeline):
    cfg = pkg.tiny_mimo_config()
    return dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, **pipeline)) if pipeline else cfg


def _case(world, mesh, sharding, frames, steps=2, pad=1, interp=0,
          **pipeline):
    return dict(world=world, mesh=mesh, sharding=sharding, frames=frames,
                steps=steps, pad=pad, interp=interp, pipeline=pipeline)


ONE_D = {n: ((n,), ("data",)) for n in (2, 4)}
CASES = {
    "frame-sharded n=2": _case(2, ONE_D[2], dict(frame_axis="data"), 8,
                               context_frames=8),
    "frame-sharded n=4": _case(4, ONE_D[4], dict(frame_axis="data"), 8,
                               context_frames=8),
    # the latents gathered before the interpolation: 22 frames decoded
    "frame-sharded n=2 interp 3": _case(2, ONE_D[2],
                                        dict(frame_axis="data"), 8,
                                        interp=3, context_frames=8),
    "window DP n=2": _case(2, ONE_D[2], dict(mesh_axis="data"), 10, pad=2),
    "window DP n=4": _case(4, ONE_D[4], dict(mesh_axis="data"), 10, pad=4),
    "hybrid tail n=4": _case(4, ONE_D[4], dict(mesh_axis="data"), 52,
                             steps=1, context_frames=8, context_overlap=4),
    "2-D 2x2": _case(4, ((2, 2), ("data", "frame")),
                     dict(mesh_axis="data", frame_axis="frame"), 12, pad=2,
                     context_frames=8, context_overlap=4),
}


def _static(pkg, name, **extra):
    c = CASES[name]
    return pkg.Pose2VideoStatic(cfg=_cfg(C if pkg is TP else JC,
                                         **c["pipeline"]),
                                num_frames=c["frames"], height=H, width=W,
                                num_inference_steps=c["steps"],
                                guidance_scale=3.5, pad_windows_to=c["pad"],
                                interpolation_factor=c["interp"], **extra)


def _fields(st):
    return {f.name: getattr(st, f.name) for f in dataclasses.fields(st)
            if f.name != "mesh"}


def _inputs(name):
    cfg = JC.tiny_mimo_config()
    return [np.asarray(a, np.float32)
            for a in tiny_inputs(cfg, CASES[name]["frames"], H, W)]


@pytest.fixture(scope="module")
def params():
    return tiny_params(JC.tiny_mimo_config())


@pytest.fixture(scope="module")
def sharded(params):
    """Each case's per-rank results, every world spawned once."""
    port_params = bridge_params(params)
    out = {}
    for world in (2, 4):
        names = [n for n, c in CASES.items() if c["world"] == world]
        cases = [dict(mesh=CASES[n]["mesh"], static=_fields(_static(TP, n))
                      | CASES[n]["sharding"], inputs=_inputs(n))
                 for n in names]
        ranks = graft.spawn(graft.generation_body, world, backend="gloo",
                            device="cpu", args=(port_params, cases))
        for i, n in enumerate(names):
            out[n] = [r[i] for r in ranks]
    return out


def _single(params, name):
    st = _static(TP, name)
    return TP.generate_host_loop(bridge_params(params), st,
                                 *[tt(a) for a in _inputs(name)]).numpy()


@pytest.fixture(scope="module")
def jax_outputs(params):
    """The JAX package's output of a case, computed once: the frame-sharded
    cases take tests/test_pipeline.py's frame-sharded program (the 8-device
    mesh, one frame a device, its all-to-all)."""
    cache = {}

    def get(name):
        key = "frame-sharded" if name.startswith("frame-sharded n=") \
            and not CASES[name]["interp"] else name
        if key not in cache:
            if key != "frame-sharded":
                cache[key] = np.asarray(JP.generate_fn(
                    params, _static(JP, name), *_inputs(name)))
            else:
                mesh = Mesh(np.array(jax.devices()), ("data",))
                st = _static(JP, name, frame_axis="data", mesh=mesh)
                repl = NamedSharding(mesh, P())
                cache[key] = np.asarray(jax.jit(
                    lambda p, a, b, c, d, e: JP.generate_fn(
                        p, st, a, b, c, d, e))(
                    jax.device_put(params, repl),
                    *jax.device_put(_inputs(name), repl)))
        return cache[key]

    return get


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_generation_matches(sharded, params, jax_outputs, name):
    single = _single(params, name)
    want = jax_outputs(name)
    c = CASES[name]
    frames = (c["frames"] - 1) * c["interp"] + 1 if c["interp"] else \
        c["frames"]
    assert single.shape == want.shape == (frames, H, W, 3)
    for rank, res in enumerate(sharded[name]):
        got = res["video"]
        assert got.shape == single.shape, rank
        np.testing.assert_allclose(got, single, atol=SELF_ATOL,
                                   err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, want, atol=JAX_ATOL,
                                   err_msg=f"rank {rank}")


def test_hybrid_tail_runs_no_padded_window(sharded):
    """13 windows of 8 frames on 4 ranks, 1 step: each rank runs 3 of the
    12 window-parallel windows (24 window-frames) and its 2 of the tail
    window's 8 frames: 26, where padding to 16 windows would run 32."""
    st = _static(TP, "hybrid tail n=4")
    win, wts = TP.make_windows(st)
    assert win.shape == (13, 8) and (wts == 1).all()
    padded, _ = TP.make_windows(dataclasses.replace(st, pad_windows_to=4))
    assert padded.shape[0] == 16
    for res in sharded["hybrid tail n=4"]:
        assert res["unet_frames"] == 3 * 8 + 8 // 4
        assert res["unet_frames"] < padded.shape[0] // 4 * 8


@pytest.mark.parametrize("name,per_rank", [
    # one window of 8 frames, F/n of them on each rank, 2 steps
    ("frame-sharded n=2", 2 * 4), ("frame-sharded n=4", 2 * 2),
    ("frame-sharded n=2 interp 3", 2 * 4),
    # 4 windows of 4 frames split over the ranks, 2 steps
    ("window DP n=2", 2 * 2 * 4), ("window DP n=4", 2 * 1 * 4),
    # 4 windows (one padded) of 8: 2 a data line, 4 of 8 frames each
    ("2-D 2x2", 2 * 2 * 4),
])
def test_each_rank_runs_its_share(sharded, name, per_rank):
    for res in sharded[name]:
        assert res["unet_frames"] == per_rank


def test_frame_mode_refuses_several_windows():
    """Frame mode keeps each rank's frames local: a window set whose frame
    blocks cross ranks must go to the 2-D mode."""
    class Mesh1D:
        shape = {"data": 2}

        def size(self, axis):
            return 2

        def index(self, axis):
            return 0

        def group(self, axis):
            return None

    st = TP.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=10,
                             height=H, width=W, num_inference_steps=1,
                             guidance_scale=3.5, frame_axis="data",
                             mesh=Mesh1D())
    win, _ = TP.make_windows(st)
    assert win.shape[0] > 1
    with pytest.raises(ValueError, match="2-D mode"):
        TP._unet_call(None, st, {}, tt(np.zeros((5, 4, 4, 4))), 500.0, win)


def test_window_dp_refuses_uneven_chunks():
    class Mesh1D:
        shape = {"data": 4}

        def size(self, axis):
            return 4

    # 4 windows of 4 frames, explicit chunks of 2: not a multiple of 4
    st = TP.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=10,
                             height=H, width=W, num_inference_steps=1,
                             guidance_scale=3.5, mesh_axis="data",
                             window_chunk=2, mesh=Mesh1D())
    win, wts = TP.make_windows(st)
    with pytest.raises(ValueError, match="multiples of 4"):
        TP._accumulate_step(None, st, {}, tt(np.zeros((10, 4, 4, 4))),
                            500.0, win, wts, None)


def test_frame_mode_decode_refuses_uneven_frames():
    """A frame-sharded decode of F' frames that do not split over the axis
    raises, as the JAX package's shard_map does (x2 interpolation of 8
    frames gives 15)."""
    class Mesh1D:
        def size(self, axis):
            return 2

        def index(self, axis):
            return 0

    st = TP.Pose2VideoStatic(cfg=C.tiny_mimo_config(), num_frames=8,
                             height=H, width=W, num_inference_steps=1,
                             guidance_scale=3.5, frame_axis="data",
                             interpolation_factor=2, mesh=Mesh1D())
    with pytest.raises(ValueError, match="15 frames do not split over 2"):
        TP._decode_frames(None, st, tt(np.zeros((15, 4, 4, 4))))
