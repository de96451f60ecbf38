"""What surrounds the GEMM tile core (csrc/gemm.cu), on the CPU: how the
tiles cut every product the main path launches, the prepared (K-major,
tiled) weight read the way the kernel's tiles read it, and the cache that
prepares each weight once. (That the kernel's shared-memory ring fits
227 KB is a static_assert in csrc/gemm.cu, checked by every build.)

The emulation below computes what the kernel computes, tile by tile, from
the prepared weight, and is held to the plain versions (the unfused
composition) in fp32 at ragged shapes, with test_torch_ffn.py's tolerance
(atol 2e-4: the sums run in another order).
"""

import gc
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mimo_tpu_torch import config as C
from mimo_tpu_torch.models import layers as L
from mimo_tpu_torch.ops import ffn as FF
from tests.test_torch_helpers import set_fp32_matmuls

set_fp32_matmuls()

ATOL = 2e-4


def main_path_products(cfg: C.MIMOConfig):
    """(K, N, epilogue) of every tile-core launch of cfg's generation:
    the denoiser's spatial transformers (LN + q|k|v, out + residual, the
    FFN), the reference UNet's FFNs (its attention writes the bank and
    runs unfused), and every motion module (proj_in, the temporal q|k|v
    and out, the FFN, proj_out + residual). N counts value columns for
    GEGLU."""
    mult = inspect.signature(L.geglu_ff_init).parameters["mult"].default

    def ffn(c):
        return {(c, mult * c, "geglu"), (mult * c, c, "bias_res")}

    out = set()
    for ucfg, reads_bank in ((cfg.reference_unet, False),
                             (cfg.denoising_unet, True)):
        chans = ucfg.block_out_channels
        attn_levels = {c for c, x in zip(chans, ucfg.cross_attn_blocks) if x}
        for c in attn_levels | {chans[-1]}:          # + the mid block
            out |= ffn(c)
            if reads_bank:
                out |= {(c, 3 * c, "bias"), (c, c, "bias_res")}
        if ucfg.use_motion_module:
            motion = set(chans) | ({chans[-1]} if ucfg.motion_module_mid_block
                                   else set())
            for c in motion:
                out |= ffn(c) | {(c, c, "bias"), (c, 3 * c, "bias"),
                                 (c, c, "bias_res")}
    return sorted(out)


MAIN_PATH = main_path_products(C.MIMOConfig())


def test_main_path_products_enumerated():
    """Every width of the SD1.5 UNets appears, with each epilogue."""
    assert {k for k, _, _ in MAIN_PATH} >= {320, 640, 1280, 5120}
    assert {e for _, _, e in MAIN_PATH} == {"bias", "bias_res", "geglu"}
    assert (320, 1280, "geglu") in MAIN_PATH and (1280, 3840, "bias") \
        in MAIN_PATH


def test_tile_width_matches_kernel_source():
    """The weight is prepared in tiles of the width the kernel reads."""
    src = (Path(FF.__file__).parents[1] / "csrc" / "gemm.cu").read_text()
    assert int(re.search(r"constexpr int kBN = (\d+);", src)[1]) == FF.TILE_N


# rows R = 48 frames x S tokens of the UNet levels 0-3: 64x98 latents
# (512x784 frames, whole 128-row tiles), then the edit path's 98x98
# (784x784: R mod 128 = 64 / 48 / 48 / 48), then ragged small calls
ROWS = [48 * s for s in (6272, 1568, 400, 104, 9604, 2401, 625, 169)] + [
    40, 1000]


@pytest.mark.parametrize("m", ROWS)
@pytest.mark.parametrize("n,geglu", [(320, False), (1280, True),
                                     (3840, False)])
def test_row_tiles_cover_ragged_rows(m, n, geglu):
    """The tile core's persistent walk (csrc/gemm.cu: gemm_kernel, launch):
    a grid of min(tiles, SMs) blocks; block b's producer loads its tiles b,
    b + grid, ... in order, and consumer warpgroup cw takes every other one
    of them (cw, cw + 2, ...), each as two 64-row epilogue halves. Every
    (row tile, column tile) is stored once, and the rows past M of the last
    row tile (a whole half where R mod 128 <= 64) are masked, never
    stored."""
    src = (Path(FF.__file__).parents[1] / "csrc" / "gemm.cu").read_text()
    bm = int(re.search(r"constexpr int kBM = (\d+);", src)[1])
    sms = 132
    row_tiles = -(-m // bm)
    tiles = row_tiles * FF.col_tiles(n, geglu)
    grid = min(tiles, sms)
    stored = np.zeros((row_tiles * bm, FF.col_tiles(n, geglu)), int)
    for b in range(grid):
        produced = list(range(b, tiles, grid))
        consumed = {cw: list(range(b + cw * grid, tiles, 2 * grid))
                    for cw in (0, 1)}
        assert produced[0::2] == consumed[0] and produced[1::2] == consumed[1]
        for t in produced:
            row0, col = t // FF.col_tiles(n, geglu) * bm, \
                t % FF.col_tiles(n, geglu)
            for half in (row0, row0 + 64):
                rows = np.arange(half, half + 64)
                stored[rows[rows < m], col] += 1     # copy_out's r < e.m
    assert (stored[:m] == 1).all() and not stored[m:].any()
    tail = m - (row_tiles - 1) * bm
    assert 0 < tail <= bm
    if m in ROWS[:4]:
        assert tail == bm                    # 64x98 latents: no ragged tile
    elif m in ROWS[4:8]:
        assert tail == {460992: 64}.get(m, 48)


def _columns(n: int, geglu: bool):
    """Output columns of each weight row the tiles read: value column and,
    for GEGLU, its gate column (-1 where a row is padding)."""
    cols = FF.TILE_N // 2 if geglu else FF.TILE_N
    value, gate = [], []
    for j in range(FF.col_tiles(n, geglu)):
        for half in ((0, 1) if geglu else (0,)):
            for c in range(cols):
                col = j * cols + c
                (gate if half else value).append(col if col < n else -1)
    return value, gate


@pytest.mark.parametrize("k,n,epi", MAIN_PATH)
def test_tile_plan_of_main_path(k, n, epi):
    geglu = epi == "geglu"
    # a width wgmma takes (a multiple of 8 up to 256; GEGLU halves too)
    assert FF.TILE_N % 8 == 0 and FF.TILE_N <= 256
    assert not geglu or (FF.TILE_N // 2) % 8 == 0
    # the tiles cover every output column exactly once, and on the main
    # path no column is padding
    value, gate = _columns(n, geglu)
    assert sorted(c for c in value if c >= 0) == list(range(n))
    assert -1 not in value
    if geglu:
        assert gate == value                 # gate column j sits beside j


@pytest.mark.parametrize("n,geglu", [(8, False), (200, False), (232, False),
                                     (696, False), (928, True), (8, True),
                                     (5000, True)])
def test_tile_plan_ragged(n, geglu):
    """Ragged N: whole tiles cover n with less than one tile of padding,
    and every padding row of the prepared weight is zero."""
    tiles = FF.col_tiles(n, geglu)
    cols = FF.TILE_N // 2 if geglu else FF.TILE_N
    assert (tiles - 1) * cols < n <= tiles * cols
    value, _ = _columns(n, geglu)
    assert sorted(c for c in value if c >= 0) == list(range(n))
    # weight row j·TILE_N + half·cols + c of the prepared copy is column
    # j·cols + c: padding past n
    pad = torch.tensor([j * cols + c >= n for j in range(tiles)
                        for _half in ((0, 1) if geglu else (0,))
                        for c in range(cols)])
    wp = FF.prepare_weight((torch.ones(8, 2 * n if geglu else n),), geglu)
    assert not wp[pad].any() and wp[~pad].all()


def tile_core_emulated(a, wp, n, geglu=False, bias=None, res=None):
    """What gemm_kernel computes, from the prepared weight wp: each
    (128-row, TILE_N) tile is a's rows against the TILE_N weight rows one
    load brings, then the epilogue, column by column as the kernel maps
    them (GEGLU: the tile's first half value columns, second half gate)."""
    r = a.shape[0]
    cols = FF.TILE_N // 2 if geglu else FF.TILE_N
    out = torch.empty((r, n), dtype=a.dtype)
    for j in range(FF.col_tiles(n, geglu)):
        tile = wp[j * FF.TILE_N:(j + 1) * FF.TILE_N]
        valid = min(cols, n - j * cols)
        cs = slice(j * cols, j * cols + valid)
        for r0 in range(0, r, 128):                 # kBM rows a tile
            rs = slice(r0, min(r, r0 + 128))
            acc = (a[rs] @ tile.t()).to(a.dtype)
            if geglu:
                h = acc[:, :valid] + bias[cs]
                g = acc[:, cols:cols + valid] + bias[n:][cs]
                y = h * torch.nn.functional.gelu(g)
            else:
                y = acc[:, :valid]
                if bias is not None:
                    y = y + bias[cs]
                if res is not None:
                    y = y + res[rs, cs]
            out[rs, cs] = y
    return out


def _params(rng, c, mult=4):
    def lin(k, n, bias=True):
        p = {"kernel": torch.from_numpy(
            (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32))}
        if bias:
            p["bias"] = torch.from_numpy(
                rng.standard_normal(n).astype(np.float32) * 0.1)
        return p
    ln = {"scale": torch.from_numpy(rng.standard_normal(c).astype(np.float32)),
          "bias": torch.from_numpy(rng.standard_normal(c).astype(np.float32))}
    ff = {"proj_in": lin(c, 2 * mult * c), "proj_out": lin(mult * c, c)}
    attn = {k: lin(c, c, bias=False) for k in ("to_q", "to_k", "to_v")}
    return ln, ff, attn, lin(c, c)


def _emulate(a, ws, geglu=False, bias=None, res=None):
    ws = tuple(ws)
    n = sum(w.shape[1] for w in ws) // (2 if geglu else 1)
    wp = FF.prepare_weight(ws, geglu)
    assert wp.shape == (FF.col_tiles(n, geglu) * FF.TILE_N, a.shape[1])
    return tile_core_emulated(a, wp, n, geglu, bias, res)


# rows: one ragged 128-row tile; C=232: K past whole 64-deep stages and N
# past whole tiles for every product (GEGLU value/gate tiles included);
# C=64: a single narrow tile
@pytest.mark.parametrize("rows,c", [(150, 232), (40, 64)])
def test_prepared_weight_reproduces_plain_versions(rows, c):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    ln_p, ff_p, attn_p, lin_p = _params(rng, c)
    normed = L.layer_norm(ln_p, x)

    h = _emulate(normed, (ff_p["proj_in"]["kernel"],), True,
                 ff_p["proj_in"]["bias"])
    y = _emulate(h, (ff_p["proj_out"]["kernel"],),
                 bias=ff_p["proj_out"]["bias"], res=x)
    np.testing.assert_allclose(y.numpy(), FF.ffn_ln_geglu_plain(
        x, ln_p, ff_p).numpy(), atol=ATOL)

    qkv = _emulate(normed, FF.qkv_weights(attn_p))
    for got, want in zip(qkv.split(c, dim=1),
                         FF.qkv_ln_plain(x, ln_p, attn_p)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)

    np.testing.assert_allclose(
        _emulate(x, (lin_p["kernel"],), bias=lin_p["bias"]).numpy(),
        FF.matmul_bias_plain(x, lin_p).numpy(), atol=ATOL)
    res = torch.from_numpy(rng.standard_normal((rows, c)).astype(np.float32))
    np.testing.assert_allclose(
        _emulate(x, (lin_p["kernel"],), bias=lin_p["bias"], res=res).numpy(),
        FF.matmul_bias_residual_plain(x, lin_p, res).numpy(), atol=ATOL)


def test_prepared_weight_layout():
    """Tile j of a GEGLU weight: value columns j·w/2 … then their gate
    columns; past n, zeros."""
    k, n = 16, 24
    w = torch.arange(k * 2 * n, dtype=torch.float32).reshape(k, 2 * n)
    wp = FF.prepare_weight((w,), geglu=True)             # 80 values a tile
    assert wp.shape == (160, k)
    assert torch.equal(wp[:n], w[:, :n].t())
    assert torch.equal(wp[80:80 + n], w[:, n:].t())
    assert not wp[n:80].any() and not wp[80 + n:].any()
    q, kk, v = (torch.randn(k, 8) for _ in range(3))
    wp = FF.prepare_weight((q, kk, v))
    assert torch.equal(wp[:24], torch.cat([q, kk, v], dim=1).t())
    assert not wp[24:].any()


def test_weight_prepared_once_per_parameter():
    """The derived copy is built once per parameter and version, rebuilt
    after an in-place change, and dropped with the parameter."""
    w = torch.randn(16, 24)
    builds = []

    def build():
        builds.append(1)
        return FF.prepare_weight((w,))

    first = FF._once((w,), "t", build)
    assert FF._once((w,), "t", build) is first and len(builds) == 1
    with torch.no_grad():
        w.add_(1.0)
    again = FF._once((w,), "t", build)
    assert len(builds) == 2 and torch.equal(again[:24], w.t())
    key = ("t", id(w))
    assert key in FF._DERIVED
    del w, first, again
    gc.collect()
    assert key not in FF._DERIVED


def test_inference_tensor_refused():
    """An inference tensor keeps no version, so an in-place change could not
    reach its prepared copy: the cache refuses it with a clear error."""
    with torch.inference_mode():
        w = torch.randn(16, 24)
    with pytest.raises(ValueError, match="inference"):
        FF._once((w,), "t", lambda: FF.prepare_weight((w,)))
