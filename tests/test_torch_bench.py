"""The port's bench command (``mimo_tpu_torch/bench.py``) and serving bench
(``mimo_tpu_torch/tools/bench_serving.py``) on the CPU at the tiny config:
the bit-sum checksum against ``bench.py``'s JAX one on the same arrays
(exact), the tiny bench's video against ``mimo_tpu``'s ``generate_fn`` on
the same bridged parameters and inputs (``tests/test_torch_pipeline.py``'s
ATOL, fp32 on both sides), its lines and checksums, the commands' refusal
without CUDA, and the serving loop's clips equal in every bit to lone
generations."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mimo_tpu import config as JC
from mimo_tpu.pipelines import pose2vid as JP
from mimo_tpu_torch import bench
from mimo_tpu_torch import config as C
from mimo_tpu_torch.entry.runner import init_random_params
from mimo_tpu_torch.pipelines import pose2vid as P
from mimo_tpu_torch.tools import bench_serving as BS
from tests.test_pipeline import tiny_inputs, tiny_params
from tests.test_torch_helpers import bridge_params, nn, set_fp32_matmuls, tt
from tests.test_torch_pipeline import ATOL

set_fp32_matmuls()

ROOT = Path(__file__).resolve().parents[1]
TPU_METRIC = "frames_per_sec_per_chip_24f_512x784_30step"   # bench.py:64
KEYS = {"metric", "value", "unit", "vs_baseline"}
FRAMES, SIZE, STEPS = 6, 32, 2


def jax_checksum(x):
    """bench.py's checksum (its e2e run's ``once``), on a JAX array."""
    flat = x.reshape(-1)
    bits = jax.lax.bitcast_convert_type(
        flat, jnp.uint16 if flat.dtype.itemsize == 2 else jnp.uint32)
    return int(jnp.sum(bits.astype(jnp.int32)))


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("dtype,shape,positive", [
    ("float32", (257, 129), False),
    ("bfloat16", (6, 32, 32, 3), False),
    # all-positive values: the unsigned bit sum passes 2^31, so the int32
    # sum wraps (fp32 after 3 elements near 1.0, bf16 after ~132k)
    ("float32", (4096,), True),
    ("bfloat16", (200_000,), True),
])
def test_checksum_equals_jax(dtype, shape, positive):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    if positive:
        a = np.abs(a) + 0.5
    xj, xt = _pair(a, dtype)
    want = jax_checksum(xj)
    assert bench.checksum(xt) == want
    unsigned = int(xt.reshape(-1).view(
        torch.int16 if dtype == "bfloat16" else torch.int32).to(
        torch.int64).remainder(1 << (16 if dtype == "bfloat16" else 32))
        .sum())
    if positive:
        assert unsigned >= 1 << 31


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checksum_order_independent_and_bit_sensitive(dtype):
    a = np.random.default_rng(1).standard_normal((257, 129)).astype(
        np.float32)
    _, x = _pair(a, dtype)
    base = bench.checksum(x)
    perm = torch.randperm(x.numel(), generator=torch.Generator().manual_seed(2))
    assert bench.checksum(x.reshape(-1)[perm]) == base
    flat = x.reshape(-1).clone()
    bits = flat.view(torch.int16 if dtype == "bfloat16" else torch.int32)
    bits[1234] ^= 1
    assert bench.checksum(flat) != base


def _tiny_static(cfg):
    return P.Pose2VideoStatic(cfg=cfg, num_frames=FRAMES, height=SIZE,
                              width=SIZE, num_inference_steps=STEPS,
                              guidance_scale=bench.GUIDANCE)


def test_bench_run_matches_jax_and_emits_its_lines():
    cfg = JC.tiny_mimo_config()
    params = tiny_params(cfg)
    inputs = [np.asarray(a, np.float32)
              for a in tiny_inputs(cfg, FRAMES, SIZE, SIZE)]
    st_j = JP.Pose2VideoStatic(cfg=cfg, num_frames=FRAMES, height=SIZE,
                               width=SIZE, num_inference_steps=STEPS,
                               guidance_scale=bench.GUIDANCE)
    ref = np.asarray(JP.generate_fn(params, st_j, *inputs))
    emitted, logs = [], []
    res = bench.run(bridge_params(params), _tiny_static(C.tiny_mimo_config()),
                    [tt(a) for a in inputs], emit=emitted.append,
                    log=logs.append)
    np.testing.assert_allclose(nn(res["video"]), ref, atol=ATOL)
    notes = [note for note, _ in res["lines"]]
    assert notes == ["provisional phase-sum", "e2e run 0", "e2e run 1",
                     "final"]
    assert emitted == [line for _, line in res["lines"]]
    for line in emitted:
        assert set(line) == KEYS and line["value"] > 0
        assert line["metric"] != TPU_METRIC and "torch" in line["metric"]
        assert line["unit"] == "frames/s"
        assert line["vs_baseline"] == pytest.approx(
            line["value"] / bench.BASELINE_FPS, abs=2e-4)
        json.dumps(line)
    a, b = res["checksums"]
    assert a == b == bench.checksum(res["video"])
    assert all(res["phases"][k] > 0 for k in ("prepare", "step", "decode"))
    assert any("equal in every bit" in msg for msg in logs)


def test_bench_budget_spent_keeps_the_provisional_line():
    cfg = C.tiny_mimo_config()
    params = init_random_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    inputs = bench.make_inputs(cfg, FRAMES, SIZE, SIZE, "cpu", torch.float32)
    res = bench.run(params, _tiny_static(cfg), inputs, emit=lambda x: None,
                    log=lambda m: None, deadline=0.0)
    assert [n for n, _ in res["lines"]] == ["provisional phase-sum", "final"]
    assert res["lines"][0][1] == res["lines"][1][1]
    assert res["checksums"] == [] and res["video"] is None


def test_bench_times_the_generation_loop(monkeypatch):
    """Every phase the bench times is a ``generate_host_loop`` call: the
    one-step warm-up, the 4-step run under a PhaseClock that gives
    prepare, step and decode, then the two end-to-end runs."""
    cfg = C.tiny_mimo_config()
    params = init_random_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    inputs = bench.make_inputs(cfg, FRAMES, SIZE, SIZE, "cpu", torch.float32)
    calls, loop = [], P.generate_host_loop

    def spy(params, st, *args, clock=None):
        calls.append((st.num_inference_steps, clock is not None))
        return loop(params, st, *args, clock=clock)

    monkeypatch.setattr(P, "generate_host_loop", spy)
    res = bench.run(params, _tiny_static(cfg), inputs, emit=lambda x: None,
                    log=lambda m: None)
    assert calls == [(1, False), (bench.TIMED_STEPS, True), (STEPS, False),
                     (STEPS, False)]
    assert len(res["checksums"]) == 2


def test_kernel_wrappers_count_their_launches():
    """``ops.kernel_wrappers`` lists the main path's thirteen wrappers, each
    with its launch count; ``launch_counts`` reads them by name, and the
    three flash wrappers' (flash_attention_wide among them) by width."""
    from mimo_tpu_torch import ops
    from mimo_tpu_torch.ops import flash_attention as FA
    wrappers = ops.kernel_wrappers()
    names = [fn.__name__ for fn in wrappers]
    assert len(set(names)) == len(wrappers) == 13
    assert all(isinstance(fn.launches, int) for fn in wrappers)
    assert FA.FLASH_WRAPPERS == (FA.flash_attention_nt,
                                 FA.flash_attention_nt_bank,
                                 FA.flash_attention_wide)
    assert set(FA.FLASH_WRAPPERS) <= set(wrappers)
    got = ops.launch_counts()
    assert got["counts"] == {fn.__name__: fn.launches for fn in wrappers}
    assert got["widths"] == [
        [fn.__name__, d, n] for fn in FA.FLASH_WRAPPERS
        for d, n in sorted(fn.widths.items())]
    json.dumps(got)


def test_make_inputs_shapes_and_ranges():
    cfg = C.MIMOConfig()
    ref, pose, bk, clip, noise = bench.make_inputs(cfg, 2, 64, 96, "cpu",
                                                   torch.bfloat16)
    assert ref.shape == (64, 96, 3) and pose.shape == bk.shape == (2, 64, 96,
                                                                    3)
    assert clip.shape == (224, 224, 3) and noise.shape == (2, 8, 12, 4)
    assert all(t.dtype == torch.bfloat16 for t in (ref, pose, bk, clip,
                                                   noise))
    assert pose.min() >= 0 and bk.min() >= -1 and ref.max() <= 1


@pytest.mark.parametrize("argv", [
    ["-m", "mimo_tpu_torch", "bench"],
    ["-m", "mimo_tpu_torch.tools.bench_serving", "--clips", "2"]],
    ids=["bench", "bench_serving"])
def test_commands_need_cuda(argv):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and res.stdout == ""


def test_serving_clips_equal_lone_generations():
    cfg = C.tiny_mimo_config()
    params = init_random_params(cfg, torch.Generator().manual_seed(0),
                                dtype=torch.float32)
    st = _tiny_static(cfg)

    def draw(seed):
        return bench.make_inputs(cfg, FRAMES, SIZE, SIZE, "cpu",
                                 torch.float32, seed)

    logs = []
    res = BS.serve(params, st, 2, draw, logs.append)
    assert len(res["videos"]) == 2
    for k, video in enumerate(res["videos"]):
        assert torch.equal(video, P.generate_host_loop(params, st, *draw(k)))
    line = res["line"]
    assert set(line) == KEYS | {"per_clip_s"} and len(line["per_clip_s"]) == 2
    assert line["value"] > 0 and "torch" in line["metric"]
    assert len(logs) == 3      # the warm-up clip and the two clips
