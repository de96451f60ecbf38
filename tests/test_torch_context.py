"""The port's copies of JAX-free code held to their originals: the config
dataclasses (field for field, defaults and tiny configs) and the context
window scheduler (exact equality: same integer algorithm)."""

import dataclasses

import numpy as np
import pytest

from mimo_tpu import config as JC
from mimo_tpu.pipelines import context as JCTX
from mimo_tpu_torch import config as C
from mimo_tpu_torch.pipelines import context as CTX


def _fields(obj):
    """Dataclass -> nested dict of plain values (dtype fields skipped)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        out[f.name] = _fields(v) if dataclasses.is_dataclass(v) else v
    return out


@pytest.mark.parametrize("name", [
    "MIMOConfig", "tiny_mimo_config", "sd15_reference_unet_config",
    "sd15_denoising_unet_config", "tiny_unet_config", "tiny_vae_config",
    "tiny_clip_config"])
def test_configs_equal_field_for_field(name):
    got, ref = getattr(C, name)(), getattr(JC, name)()
    assert _fields(got) == _fields(ref)


def test_config_properties_equal():
    got, ref = C.MIMOConfig(), JC.MIMOConfig()
    assert got.denoising_unet.time_embed_dim == ref.denoising_unet.time_embed_dim
    assert got.denoising_unet.num_blocks == ref.denoising_unet.num_blocks
    assert got.vae.downscale == ref.vae.downscale
    assert got.reference_unet.head_dim(320) == ref.reference_unet.head_dim(320)


def test_dtype_policy_is_torch():
    import torch
    assert C.DTypePolicy.for_device("cuda") == C.DTypePolicy.bf16()
    assert C.DTypePolicy.for_device("cpu").compute_dtype == torch.float32


def test_json_roundtrip_loads_in_both(tmp_path):
    path = str(tmp_path / "cfg.json")
    C.save_json(C.tiny_mimo_config(), path)
    assert _fields(C.load_json(path)) == _fields(C.tiny_mimo_config())
    assert _fields(JC.load_json(path)) == _fields(JC.tiny_mimo_config())


@pytest.mark.parametrize("nf,cs,stride,ov,step,pad", [
    (64, 24, 1, 4, 0, 1), (64, 24, 3, 4, 0, 1), (150, 24, 1, 4, 0, 1),
    (30, 24, 1, 4, 0, 1), (24, 24, 1, 4, 0, 1), (8, 4, 1, 1, 0, 1),
    (64, 24, 1, 4, 5, 1), (100, 16, 2, 4, 7, 1), (64, 24, 1, 4, 0, 8),
    (10, 4, 1, 1, 0, 2),
])
def test_compute_windows_equal_jax(nf, cs, stride, ov, step, pad):
    got = CTX.compute_windows(nf, cs, stride, ov, step, pad)
    ref = JCTX.compute_windows(nf, cs, stride, ov, step, pad)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].dtype == ref[0].dtype and got[1].dtype == ref[1].dtype


def test_ordered_halving_equal_jax():
    for v in range(64):
        assert CTX.ordered_halving(v) == JCTX.ordered_halving(v)
