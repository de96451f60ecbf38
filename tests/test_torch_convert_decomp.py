"""The port's decomposition converter (mimo_tpu_torch/weights/convert_decomp.py)
against mimo_tpu/weights/convert_decomp.py, bit for bit, on the state dicts
that tests/test_convert_decomp.py synthesizes with the published key names
(SAM, ViTPose, SAM2, HMR2, HaMeR; each captured from its test's own call of
the JAX converter), and its CLI writing the bundles that
decomp.factory.build_decomp_models reads.
"""

import numpy as np
import pytest
import torch

import tests.test_convert_decomp as TCD
from mimo_tpu.weights.convert import flatten_tree
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import hmr as HM
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
             "hmr": "--hmr2", "hamer": "--hamer"}
    tiny_cfgs = FA.configs(tiny=True)
    monkeypatch.setattr(FA, "configs", lambda tiny: tiny_cfgs)
    argv, want = ["--out-dir", str(tmp_path / "out")], {}
    for name in CASES:
        sd, want[name] = _captured(monkeypatch, name)
        path = tmp_path / f"{name}.pth"
        torch.save(_tensors(sd), path)
        argv += [flags[name], str(path)]
    PC.main(argv)
    out = tmp_path / "out"
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{n}.npz" for n in CASES)
    for name in CASES:
        kind = name if name in bridge.TRANSPOSED_CONVS else None
        got = bridge.load_npz(str(out / f"{name}.npz"), kind=kind)
        ref = bridge.from_flat(flatten_tree(want[name]), kind=kind)
        _assert_bit_equal(got, ref)

    from mimo_tpu_torch.decomp import smpl as SM
    np.savez(out / "smpl.npz", **SM.surface_arrays(0, rings=6, segments=8))
    models = FA.build_decomp_models(str(out), dtype=torch.float32,
                                    tiny=True, device="cpu")
    for stage in ("segment_box", "automask", "track_video", "estimate_pose",
                  "estimate_pose_batch", "detect_person", "estimate_motion"):
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
