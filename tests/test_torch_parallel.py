"""The port's multi-process layer (mimo_tpu_torch/parallel/{mesh,comm,
decomp}.py) on gloo CPU worlds of 2 and 4 ranks, against the JAX package's
collectives and frame-parallel forwards on the conftest's 8-device virtual
mesh.

Each world is spawned once (``entry/graft.py``'s spawner, the rank bodies
in the package) and the parametrised cases read its results. The
collectives move data only: they must equal ``jax.lax.all_to_all(...,
tiled=True)`` / ``all_gather`` under ``shard_map`` on the same arrays in
every bit. ``frame_parallel`` and ``render_frames_sharded`` run the
single-process program on a block of the batch: within 1e-5 of the port's
single process (the renderer equal in every bit), within 1e-4 of
``tests/test_decomp_sharding.py``'s JAX results (the port's model
tolerance, fp32 on both sides) and the renderer within its own tolerance
(``tests/test_torch_renderer.py``).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mimo_tpu.decomp import hmr as JHM
from mimo_tpu.decomp import vitpose as JVP
from mimo_tpu.models import unet as JU
from mimo_tpu.parallel.decomp import frame_parallel as jax_frame_parallel
from mimo_tpu.parallel.decomp import render_frames_sharded as jax_render
from mimo_tpu.parallel.mesh import get_mesh as jax_get_mesh
from mimo_tpu_torch.decomp import hmr as HM
from mimo_tpu_torch.decomp import renderer as R
from mimo_tpu_torch.decomp import vitpose as VP
from mimo_tpu_torch.entry import graft
from mimo_tpu_torch.models import unet as U
from mimo_tpu_torch.parallel import comm
from tests.test_decomp_sharding import _toy_scene
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt
from tests.test_torch_motion import _port_vp_cfg
from tests.test_torch_motion_core import _port_hmr_cfg
from tests.test_torch_renderer import assert_render_close, edges_and_areas

set_fp32_matmuls()

WORLDS = (2, 4)
B, F, S, C = 2, 8, 12, 3          # the motion module's (b, F, S, c) tokens
# (split_axis, concat_axis): frame- to spatial-sharding and back
DIRECTIONS = {"frames->positions": (2, 1), "positions->frames": (1, 2)}


def _tokens():
    return np.random.default_rng(0).standard_normal(
        (B, F, S, C)).astype(np.float32)


def _blocks(x, axis, n):
    return list(np.split(x, n, axis=axis))


def _comm_cases(n):
    g = _tokens()
    cases = {}
    for name, (split, concat) in DIRECTIONS.items():
        cases[name] = dict(mesh=((n,), ("data",)), axis="data",
                           op="all_to_all", inputs=_blocks(g, 3 - split, n),
                           kwargs=dict(split_axis=split, concat_axis=concat))
    cases["all_gather"] = dict(mesh=((n,), ("data",)), axis="data",
                               op="all_gather", inputs=_blocks(g, 1, n),
                               kwargs=dict(axis=1))
    cases["all_gather bool"] = dict(mesh=((n,), ("data",)), axis="data",
                                    op="all_gather",
                                    inputs=[np.ascontiguousarray(
                                        (g > 0)[:, :, r::n])
                                        for r in range(n)],
                                    kwargs=dict(axis=2))
    cases["broadcast"] = dict(mesh=((n,), ("data",)), axis="data",
                              op="broadcast",
                              inputs=[g + r for r in range(n)])
    cases["get_mesh all_gather"] = dict(mesh=None, axis="data",
                                        op="all_gather",
                                        inputs=[g[0] + r for r in range(n)],
                                        kwargs=dict(axis=0))
    if n == 4:
        for axis in ("data", "frame"):
            cases[f"2-D all_gather over {axis}"] = dict(
                mesh=((2, 2), ("data", "frame")), axis=axis,
                op="all_gather", inputs=[g * (r + 1) for r in range(n)],
                kwargs=dict(axis=0))
    return cases


def _decomp_setup():
    """tests/test_decomp_sharding.py's JAX params and inputs, and the port's
    counterparts through the bridge."""
    vcfg, hcfg = JVP.tiny_vitpose_config(), JHM.tiny_hmr_config()
    vp = JVP.vitpose_init(jax.random.PRNGKey(0), vcfg)
    hp = JHM.hmr_init(jax.random.PRNGKey(0), hcfg)
    crops = {b: np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (b, *vcfg.backbone.img_size, 3)))
        for b in (8, 5)}
    hcrops = np.asarray(jax.random.normal(
        jax.random.PRNGKey(1), (6, *hcfg.backbone.img_size, 3)))
    return (vcfg, hcfg, vp, hp, crops, hcrops)


def _decomp_cases(n, setup):
    vcfg, hcfg, vp, hp, crops, hcrops = setup
    verts, faces, colors, focal, center, h, w = _toy_scene()
    cases = {
        "vitpose": dict(op="vitpose", crops=crops[8 if n == 2 else 5]),
        "hmr": dict(op="hmr", crops=hcrops),
        "render": dict(op="render", scene=(
            np.asarray(verts), np.asarray(faces), np.asarray(colors),
            float(focal), np.asarray(center), h, w)),
    }
    models = {"vitpose": (bridge_params(vp, kind="vitpose"),
                          _port_vp_cfg(vcfg)),
              "hmr": (bridge_params(hp), _port_hmr_cfg(hcfg)),
              "smpl": None, "focal": 50.0}
    return models, cases


@pytest.fixture(scope="module")
def decomp_setup():
    return _decomp_setup()


@pytest.fixture(scope="module")
def worlds(decomp_setup):
    """Each world's results by case name: (comm results, decomp results),
    each a list by rank."""
    out = {}
    for n in WORLDS:
        ccases = _comm_cases(n)
        models, dcases = _decomp_cases(n, decomp_setup)
        ranks = graft.spawn(graft.bodies, n, backend="gloo", device="cpu",
                            args=([(graft.comm_body, (list(ccases.values()),)),
                                   (graft.motion_body,
                                    (models, list(dcases.values())))],))
        out[n] = ({k: [r[0][i] for r in ranks]
                   for i, k in enumerate(ccases)},
                  {k: [r[1][i] for r in ranks]
                   for i, k in enumerate(dcases)})
    return out


def _jax_collective(x, n, body, spec_in, spec_out):
    mesh = Mesh(np.array(jax.devices()[:n]), ("x",))
    return np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=spec_in, out_specs=spec_out,
        check_vma=False))(jnp.asarray(x)))


@pytest.mark.parametrize("direction", list(DIRECTIONS))
@pytest.mark.parametrize("n", WORLDS)
def test_all_to_all_matches_jax(worlds, n, direction):
    split, concat = DIRECTIONS[direction]
    spec_in, spec_out = ((P(None, "x"), P(None, None, "x")) if split == 2
                         else (P(None, None, "x"), P(None, "x")))
    want = _jax_collective(
        _tokens(), n, lambda x: jax.lax.all_to_all(
            x, "x", split, concat, tiled=True), spec_in, spec_out)
    got = worlds[n][0][direction]
    for r in range(n):
        assert got[r].shape == _blocks(want, split, n)[r].shape
        np.testing.assert_array_equal(got[r], _blocks(want, split, n)[r])


@pytest.mark.parametrize("n", WORLDS)
def test_all_gather_matches_jax(worlds, n):
    want = _jax_collective(
        _tokens(), n, lambda x: jax.lax.all_gather(x, "x", axis=1,
                                                   tiled=True),
        P(None, "x"), P())
    for got in worlds[n][0]["all_gather"]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WORLDS)
def test_bool_masks_travel_as_uint8(worlds, n):
    """gloo takes no bool: the mask is sent as uint8 and comes back bool."""
    mask = _tokens() > 0
    want = np.concatenate([mask[:, :, r::n] for r in range(n)], axis=2)
    for got in worlds[n][0]["all_gather bool"]:
        assert got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", WORLDS)
def test_broadcast_replicates_rank_0(worlds, n):
    for got in worlds[n][0]["broadcast"]:
        np.testing.assert_array_equal(got, _tokens())


@pytest.mark.parametrize("n", WORLDS)
def test_get_mesh_spans_the_world(worlds, n):
    """``get_mesh``: one "data" axis over every rank, in rank order."""
    g = _tokens()[0]
    want = np.concatenate([g + r for r in range(n)])
    for got in worlds[n][0]["get_mesh all_gather"]:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axis", ["data", "frame"])
def test_2d_mesh_axis_groups(worlds, axis):
    """Rank r = d * 2 + f of the (2, 2) ("data", "frame") mesh: the
    "frame" group of r holds (d, 0) and (d, 1), the "data" group (0, f) and
    (1, f), in that order."""
    got = worlds[4][0][f"2-D all_gather over {axis}"]
    g = _tokens()
    for r in range(4):
        d, f = divmod(r, 2)
        line = [d * 2 + k for k in range(2)] if axis == "frame" \
            else [k * 2 + f for k in range(2)]
        np.testing.assert_array_equal(
            got[r], np.concatenate([g * (k + 1) for k in line]))


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("spatial", [6272, 1568, 400, 104, 16, 4, 1])
def test_reshard_mode_matches_jax(spatial, ndev):
    """The production 512x784 levels and the tiny config's 32x32 levels
    (16 / 4 / 1 positions: ragged at 8, and at 1 position)."""
    assert U.reshard_mode(spatial, ndev) == JU.reshard_mode(spatial, ndev)
    if spatial >= 104:
        assert U.reshard_mode(spatial, ndev) == "a2a"


def test_local_slice_refuses_ragged():
    assert comm.local_slice(12, 4, 3) == slice(9, 12)
    with pytest.raises(ValueError, match="equal blocks"):
        comm.local_slice(10, 4, 0)


@pytest.mark.parametrize("n", WORLDS)
def test_frame_parallel_vitpose(worlds, decomp_setup, n):
    """8 crops on 2 ranks; 5 crops on 4 ranks (padded with the last one,
    sliced back)."""
    vcfg, _, vp, _, crops, _ = decomp_setup
    b = 8 if n == 2 else 5
    x = crops[b]
    want_jax = np.asarray(jax.jit(jax_frame_parallel(
        lambda p, c: JVP.heatmaps_flip_test(p, vcfg, c), jax_get_mesh(8)))(
            vp, jnp.asarray(x)))
    single = VP.heatmaps_flip_test(bridge_params(vp, kind="vitpose"),
                                   _port_vp_cfg(vcfg), tt(x))
    for got in worlds[n][1]["vitpose"]:
        assert got.shape == single.shape and got.shape[0] == b
        np.testing.assert_allclose(nn(got), nn(single), atol=1e-5)
        np.testing.assert_allclose(nn(got), want_jax, atol=1e-4)


@pytest.mark.parametrize("n", WORLDS)
def test_frame_parallel_hmr_dict_output(worlds, decomp_setup, n):
    _, hcfg, _, hp, _, hcrops = decomp_setup
    want_jax = jax.jit(jax_frame_parallel(
        lambda p, c: JHM.hmr_forward(p, hcfg, c), jax_get_mesh(8)))(
            hp, jnp.asarray(hcrops))
    single = HM.hmr_forward(bridge_params(hp), _port_hmr_cfg(hcfg),
                            tt(hcrops))
    for got in worlds[n][1]["hmr"]:
        assert set(got) == set(single) == set(want_jax)
        for k in single:
            np.testing.assert_allclose(nn(got[k]), nn(single[k]), atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose(nn(got[k]), nn(want_jax[k]),
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_render_frames_sharded(worlds, n):
    verts, faces, colors, focal, center, h, w = _toy_scene()
    want_jax = jax_render(verts, faces, colors, focal, center, height=h,
                          width=w, mesh=jax_get_mesh(8), face_chunk=8,
                          band=8, band_chunk=8)
    single = R.render_frames(tt(verts), torch.from_numpy(np.array(faces)),
                             tt(colors), float(focal), tt(center), height=h,
                             width=w)
    edges = [edges_and_areas(v, np.asarray(faces), float(focal),
                             np.asarray(center), h, w)
             for v in np.asarray(verts)]
    for got in worlds[n][1]["render"]:
        for g, s in zip(got, single):
            assert torch.equal(g, s)
        assert_render_close(got, want_jax,
                            tuple(np.stack(x) for x in zip(*edges)))


def test_dryrun_multichip_on_cpu():
    """entry/graft.py's four checks on a gloo CPU world of 4 (window DP,
    the frame-sharded 24-frame clip, the 2-D 2x2 mesh, the decomposition's
    motion stage on 5 frames), each against the single process."""
    report = graft.dryrun_multichip(4, backend="gloo", device="cpu")
    assert len(report) == 4
    assert [line.split(": ")[1].split(" ")[0] for line in report] == \
        ["window", "frame-sharded", "2-D", "decomp"]
