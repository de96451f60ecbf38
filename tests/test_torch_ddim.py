"""The port's DDIM (v-prediction, zero-SNR, trailing spacing) against
mimo_tpu/schedulers/ddim.py: identical tables, and step_v within fp32
rounding (atol/rtol 1e-6: the same fp32 formula on both sides)."""

import numpy as np
import pytest
import jax.numpy as jnp

from mimo_tpu.config import SchedulerConfig as JSchedulerConfig
from mimo_tpu.schedulers.ddim import DDIM as JDDIM
from mimo_tpu.schedulers.ddim import _make_alphas_cumprod as j_acp
from mimo_tpu_torch.config import SchedulerConfig
from mimo_tpu_torch.schedulers.ddim import DDIM, _make_alphas_cumprod
from tests.test_torch_helpers import nn, tt


@pytest.mark.parametrize("steps", [1, 2, 4, 25, 30])
def test_tables_equal_jax(steps):
    np.testing.assert_array_equal(_make_alphas_cumprod(SchedulerConfig()),
                                  j_acp(JSchedulerConfig()))
    got = DDIM.create(SchedulerConfig(), steps)
    ref = JDDIM.create(JSchedulerConfig(), steps)
    np.testing.assert_array_equal(got.timesteps, ref.timesteps)
    np.testing.assert_array_equal(got.alpha_t, ref.alpha_t)
    np.testing.assert_array_equal(got.alpha_prev, ref.alpha_prev)
    assert got.init_noise_sigma == ref.init_noise_sigma


def test_leading_spacing_equal_jax():
    got = DDIM.create(SchedulerConfig(timestep_spacing="leading"), 25)
    ref = JDDIM.create(JSchedulerConfig(timestep_spacing="leading"), 25)
    np.testing.assert_array_equal(got.timesteps, ref.timesteps)


@pytest.mark.parametrize("i", [0, 7, 24])
def test_step_v_matches_jax(i):
    rng = np.random.default_rng(i)
    x = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    v = rng.standard_normal((2, 3, 4, 4)).astype(np.float32)
    got = DDIM.create(SchedulerConfig(), 25).step_v(tt(v), i, tt(x))
    ref = JDDIM.create(JSchedulerConfig(), 25).step_v(jnp.asarray(v), i,
                                                      jnp.asarray(x))
    np.testing.assert_allclose(nn(got), nn(ref), atol=1e-6, rtol=1e-6)
