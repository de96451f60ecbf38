"""The port's decomposition converter (mimo_tpu_torch/weights/convert_decomp.py)
against mimo_tpu/weights/convert_decomp.py, bit for bit, on the state dicts
that tests/test_convert_decomp.py synthesizes with the published key names
(SAM, ViTPose, SAM2, HMR2, HaMeR, RAFT, ProPainter; each captured from its
test's own call of the JAX converter) and on a DINOv2 state dict made here
from the tiny depth model's encoder (no JAX test converts one), and its CLI
writing the bundles that decomp.factory.build_decomp_models reads.
"""

import numpy as np
import pytest
import torch

import tests.test_convert_decomp as TCD
from mimo_tpu.weights.convert import flatten_tree
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import hmr as HM
from mimo_tpu_torch.decomp import propainter as PP
from mimo_tpu_torch.decomp import raft as R
from mimo_tpu_torch.decomp import sam as S
from mimo_tpu_torch.decomp import sam2 as S2
from mimo_tpu_torch.decomp import vitpose as VP
from mimo_tpu_torch.weights import bridge
from mimo_tpu_torch.weights import convert_decomp as PC

# (the JAX test that synthesizes the state dict, the JAX converter it
# calls, the port's converter, the port's config of that test)
CASES = {
    "sam": ("test_sam_converter_roundtrip", "convert_sam", PC.convert_sam,
            S.tiny_sam_config),
    "vitpose": ("test_vitpose_converter_roundtrip", "convert_vitpose",
                PC.convert_vitpose, VP.tiny_vitpose_config),
    "sam2": ("test_sam2_converter_roundtrip", "convert_sam2",
             PC.convert_sam2, S2.tiny_sam2_config),
    "hmr": ("test_hmr2_converter_roundtrip", "convert_hmr2",
            PC.convert_hmr2, HM.tiny_hmr_config),
    "hamer": ("test_hamer_converter_roundtrip", "convert_hamer",
              PC.convert_hamer, lambda: HM.tiny_hmr_config(num_joints=4)),
    "raft": ("test_raft_converter_roundtrip", "convert_raft",
             PC.convert_raft, R.tiny_raft_config),
}


def _captured(monkeypatch, name):
    """Run the JAX converter test of ``name``; returns the state dict it
    converted and the JAX converter's tree."""
    test, conv, _, _ = CASES[name]
    seen = {}
    inner = getattr(TCD.WD, conv)

    def spy(sd, cfg, *args, **kwargs):
        seen["sd"] = dict(sd)
        seen["tree"] = inner(sd, cfg, *args, **kwargs)
        return seen["tree"]

    monkeypatch.setattr(TCD.WD, conv, spy)
    getattr(TCD, test)()
    return seen["sd"], seen["tree"]


def _captured_propainter(monkeypatch):
    """The two state dicts (generator, flow net) the JAX ProPainter
    converter test converts, and the JAX converter's tree."""
    seen = {}
    inner = TCD.WD.convert_propainter

    def spy(gen_sd, flow_sd, cfg):
        seen.update(gen=dict(gen_sd), flow=dict(flow_sd))
        seen["tree"] = inner(gen_sd, flow_sd, cfg)
        return seen["tree"]

    monkeypatch.setattr(TCD.WD, "convert_propainter", spy)
    TCD.test_propainter_converter_roundtrip()
    return seen["gen"], seen["flow"], seen["tree"]


def _tensors(sd):
    """A state dict (SAM2's nested under "model") of torch tensors."""
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _assert_bit_equal(got, want):
    fg, fw = flatten_tree(got), flatten_tree(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        a, b = np.asarray(fg[k]), np.asarray(fw[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert np.array_equal(a, b), k


@pytest.mark.parametrize("name", list(CASES))
def test_converter_bit_equal_to_jax(name, monkeypatch):
    sd, want = _captured(monkeypatch, name)
    _, _, convert, cfg = CASES[name]
    _assert_bit_equal(convert(sd, cfg()), want)


def test_propainter_converter_bit_equal_to_jax(monkeypatch):
    gen_sd, flow_sd, want = _captured_propainter(monkeypatch)
    _assert_bit_equal(PC.convert_propainter(
        gen_sd, flow_sd, PP.tiny_propainter_config()), want)


def test_dinov2_converter_bit_equal_to_jax():
    """A DINOv2 state dict (DepthAnythingV2's pretrained.* keys) emitted
    from the tiny depth model's JAX encoder: the port's converter equals
    the JAX one bit for bit and gives that encoder back."""
    import jax
    from mimo_tpu.decomp import depth_anything as JD
    cfg = JD.tiny_depth_config()
    enc = jax.tree.map(np.asarray, JD.depth_anything_init(
        jax.random.PRNGKey(0), cfg)["encoder"])
    sd = {}
    TCD._emit_conv(sd, "pretrained.patch_embed.proj", enc["patch_embed"])
    sd["pretrained.cls_token"] = enc["cls_token"][None, None]
    sd["pretrained.pos_embed"] = enc["pos_embed"][None]
    for i, blk in enumerate(enc["blocks"]):
        bp = f"pretrained.blocks.{i}"
        TCD._emit_vit_block(sd, bp, blk, mlp=("mlp.fc1", "mlp.fc2"))
        sd[f"{bp}.ls1.gamma"] = blk["ls1"]
        sd[f"{bp}.ls2.gamma"] = blk["ls2"]
    TCD._emit_norm(sd, "pretrained.norm", enc["ln_out"])
    got = PC.convert_dinov2(sd, cfg.encoder.depth)
    _assert_bit_equal(got, TCD.WD.convert_dinov2(sd, cfg.encoder.depth))
    _assert_bit_equal(got, enc)


def test_deconv_transform_equals_jax():
    w = np.random.default_rng(0).standard_normal((3, 2, 4, 4)).astype(
        np.float32)
    assert np.array_equal(PC._t_deconv(w), TCD.WD._t_deconv(w))


def test_cli_writes_the_bundles_the_factory_reads(monkeypatch, tmp_path):
    """Each synthesized checkpoint saved as a torch file, converted by the
    CLI (the factory's configs made the tiny ones), read back by the
    factory: every stage wired, and each bundle's tree equal to the bridge
    of the JAX converter's."""
    flags = {"sam": "--sam", "vitpose": "--vitpose", "sam2": "--sam2",
             "hmr": "--hmr2", "hamer": "--hamer", "raft": "--raft"}
    tiny_cfgs = FA.configs(tiny=True)
    monkeypatch.setattr(FA, "configs", lambda tiny: tiny_cfgs)
    argv, want = ["--out-dir", str(tmp_path / "out")], {}
    for name in CASES:
        sd, want[name] = _captured(monkeypatch, name)
        path = tmp_path / f"{name}.pth"
        torch.save(_tensors(sd), path)
        argv += [flags[name], str(path)]
    gen_sd, flow_sd, want["propainter"] = _captured_propainter(monkeypatch)
    for flag, sd in (("--propainter", gen_sd), ("--flow-complete", flow_sd)):
        path = tmp_path / f"{flag[2:]}.pth"
        torch.save(_tensors(sd), path)
        argv += [flag, str(path)]
    PC.main(argv)
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{n}.npz" for n in [*CASES, "propainter"])
    for name in [*CASES, "propainter"]:
        kind = name if name in bridge.TRANSPOSED_CONVS else None
        got = bridge.load_npz(str(out / f"{name}.npz"), kind=kind)
        ref = bridge.from_flat(flatten_tree(want[name]), kind=kind)
        _assert_bit_equal(got, ref)

    from mimo_tpu_torch.decomp import smpl as SM
    np.savez(out / "smpl.npz", **SM.surface_arrays(0, rings=6, segments=8))
    models = FA.build_decomp_models(str(out), dtype=torch.float32,
                                    tiny=True, device="cpu")
    for stage in ("segment_box", "automask", "track_video", "estimate_pose",
                  "estimate_pose_batch", "detect_person", "estimate_motion",
                  "inpaint"):
        assert getattr(models, stage) is not None, stage
    est = models.estimate_motion.__self__
    assert est.hamer_params is not None and est.smpl_model.num_verts == 50


def test_load_smpl_mean_params_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "smpl_mean_params.npz"
    np.savez(path, pose=rng.standard_normal((1, 144)),
             shape=rng.standard_normal((1, 10)),
             cam=rng.standard_normal(3))
    _assert_bit_equal(PC.load_smpl_mean_params(str(path)),
                      TCD.WD.load_smpl_mean_params(str(path)))


def test_cli_propainter_needs_the_flow_net(tmp_path):
    """--propainter and --flow-complete go together (the bundle holds both
    nets)."""
    for flag in ("--propainter", "--flow-complete"):
        with pytest.raises(SystemExit):
            PC.main(["--out-dir", str(tmp_path), flag, "x.pth"])
    with pytest.raises(ValueError, match="together"):
        PC.convert_bundles(str(tmp_path), propainter="x.pth")
    assert not any(tmp_path.iterdir())
