"""The plain reference against the port's CPU path at the tiny sizes: the
parameter tree, each model, the host-side prep and paste-back; and the FLOP
counter on hand-counted work."""

import numpy as np
import pytest
import torch

from benchmark.reference import encoders as E
from benchmark.reference import frames as RF
from benchmark.reference import nn
from benchmark.reference import params as P
from benchmark.reference import unet as RU
from benchmark.traffic import generator as G
from benchmark.work import count, peaks

import bench_tiny

from mimo_tpu_torch.config import load_json
from mimo_tpu_torch.entry import edit as ED
from mimo_tpu_torch.entry import runner as RN
from mimo_tpu_torch.models import clip_vision as CV
from mimo_tpu_torch.models import pose_guider as PG
from mimo_tpu_torch.models import unet as U
from mimo_tpu_torch.models import vae as V
from mimo_tpu_torch.utils import frames as FU


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    cfg = bench_tiny.config("animate")
    path = bench_tiny.config_file("animate", tmp_path_factory.mktemp("c"))
    params = P.draw(P.layout(cfg), torch.Generator().manual_seed(7),
                    torch.float32)
    return cfg, load_json(str(path)), params


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tree


def test_layout_is_the_ports_tree(tiny):
    cfg, mcfg, params = tiny
    port = RN.init_random_params(mcfg, torch.Generator().manual_seed(0),
                                 torch.float32)
    assert _shapes(params) == _shapes(port)


def test_draw_is_seeded_aligned_and_channels_last(tiny):
    cfg, _, params = tiny
    again = P.draw(P.layout(cfg), torch.Generator().manual_seed(7),
                   torch.float32)
    k = params["vae"]["decoder"]["conv_in"]["kernel"]
    assert torch.equal(k, again["vae"]["decoder"]["conv_in"]["kernel"])
    assert k.is_contiguous(memory_format=torch.channels_last)
    for t in (params["clip"]["class_embed"],
              params["pose_guider"]["conv_out"]["bias"]):
        offset = t.data_ptr() - t.untyped_storage().data_ptr()
        assert offset % (P.ALIGN * t.element_size()) == 0
    proj = params["denoising_unet"]["down"][0]["motions"][0]["proj_out"]
    assert proj["kernel"].abs().min() > 0   # nothing zero-initialised
    s = params["vae"]["encoder"]["norm_out"]["scale"]
    assert ((s >= 1 - P.NORM_SPREAD) & (s <= 1 + P.NORM_SPREAD)).all()


def _close(a, b, tol=2e-4):
    a, b = a.float(), b.float()
    assert a.shape == b.shape
    assert torch.allclose(a, b, atol=tol, rtol=tol), (a - b).abs().max()


def test_unets_match_the_port(tiny):
    cfg, mcfg, params = tiny
    g = torch.Generator().manual_seed(3)
    ref_lat = torch.randn((2, 8, 8, 4), generator=g)
    ctx = torch.randn((2, 1, cfg["clip_vision"]["projection_dim"]),
                      generator=g)
    banks = RU.unet2d_banks(params["reference_unet"], cfg["reference_unet"],
                            ref_lat, ctx)
    pbanks = U.unet2d_apply(params["reference_unet"], mcfg.reference_unet,
                            ref_lat, 0.0, ctx)
    for a, b in zip(banks, pbanks):
        _close(a, b)
    cond = [b[-1] for b in banks]
    x = torch.randn((4, 4, 8, 8, 8), generator=g)
    pose = torch.randn((4, 4, 8, 8, 32), generator=g)
    ctx4 = torch.randn((4, 1, ctx.shape[-1]), generator=g)
    ours = RU.unet3d(params["denoising_unet"], cfg["denoising_unet"], x,
                     500.0, ctx4, pose, cond, cfg_split=True)
    port = U.unet3d_apply(params["denoising_unet"], mcfg.denoising_unet, x,
                          500.0, ctx4, pose, cond, cfg_split=True)
    _close(ours, port)


def test_encoders_match_the_port(tiny):
    cfg, mcfg, params = tiny
    g = torch.Generator().manual_seed(4)
    img = torch.rand((3, 64, 64, 3), generator=g) * 2 - 1
    _close(E.vae_encode_mean(params["vae"], cfg["vae"], img),
           V.encode_mean(params["vae"], mcfg.vae, img))
    z = torch.randn((3, 8, 8, 4), generator=g)
    _close(E.vae_decode(params["vae"], cfg["vae"], z),
           V.decode(params["vae"], mcfg.vae, z))
    px = torch.rand((1, 32, 32, 3), generator=g)
    _close(E.clip_image_embed(params["clip"], cfg["clip_vision"], px),
           CV.clip_image_embed(params["clip"], mcfg.clip_vision, px))
    pose = torch.rand((2, 64, 64, 3), generator=g)
    _close(E.pose_guider(params["pose_guider"], pose),
           PG.pose_guider_apply(params["pose_guider"], pose[None])[0])


@pytest.mark.parametrize("seed", [5, 2 ** 33 + 1])
def test_host_prep_matches_the_port(seed):
    tr = bench_tiny.traffic("edit", frames=8)
    tr.update(height=180, width=320, ref_size=[192, 128], speed=[6, 9])
    inp = G.clip_inputs(tr, seed, 0)
    assert np.array_equal(RF.prep_reference_image(inp["ref"]),
                          RN.prep_reference_image(inp["ref"]))
    white = [np.full(inp["sdc"][0].shape, 255, np.uint8)] * len(inp["sdc"])
    ours = RF.crop_human(inp["sdc"], white)
    theirs = FU.crop_human(inp["sdc"], white)
    for a, b in zip(ours[0] + ours[1], theirs[0] + theirs[1]):
        assert np.array_equal(a, b)
    shots, boxes = RF.roi_shots(inp["sdc"])
    pc, vc, bc, _, ctx, bbox = FU.crop_human_clip_auto_context(
        inp["sdc"], inp["vid"], inp["bk"], ED.OVERLAY)
    assert shots == ctx and boxes == bbox
    for a, b in zip(RF.shot_crops(inp["sdc"], shots, boxes), pc):
        assert np.array_equal(a, b)
    pad_info, n = [], sum(len(s) for s in shots)
    for b in RF.shot_crops(inp["bk"], shots, boxes):
        bb, pad = RF.pad_img(b, (255, 255, 255))
        pad_info.append((bb.shape[0], bb.shape[1], pad))
    video = np.random.default_rng(seed % 97).random((n, 64, 64, 3),
                                                    np.float32)
    ours = RF.composite_back(video, shots, boxes, pad_info, inp["bk"],
                             inp["vid"], inp["occ"])
    theirs = ED.composite_back(video, ctx, bbox, pad_info, inp["bk"],
                               inp["vid"], inp["occ"])
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a, b)


def test_flop_counter_by_hand():
    x = torch.empty((1, 8, 8, 3), device="meta")
    conv = {"kernel": torch.empty((4, 3, 3, 3), device="meta"),
            "bias": torch.empty((4,), device="meta")}
    a = torch.empty((5, 6), device="meta")
    w = torch.empty((6, 7), device="meta")

    def work():
        nn.conv2d(conv, x, padding=1)
        nn.matmul(a, w, "tile", res=True)

    flops, log = count._count(work)
    assert flops == 2 * 8 * 8 * 4 * 3 * 3 * 3 + 2 * 5 * 6 * 7
    assert log == [{"op": "gemm", "kind": "tile", "m": 5, "k": 6, "n": 7,
                    "res": True, "geglu": False}]
    f, b = peaks.gemm_work(5, 6, 7, res=True, geglu=False)
    assert f == 420 and b == 2 * (30 + 42 + 7 + 2 * 35)


def test_flash_work_by_hand():
    f, b = peaks.flash_work(2, 8, 40, 100, 100, bank=50)
    assert f == 4 * 2 * 8 * 100 * 150 * 40
    assert b == 2 * 8 * 40 * (200 + 400 + 100 + 200)   # q, k|v, bank, out
    assert peaks.bound_s(989e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12) == pytest.approx(1.0)


def test_clip_work_counts_each_piece(tiny):
    cfg = bench_tiny.config("animate")
    w = count.clip_work(cfg, 6)
    steps = cfg["pipeline"]["num_inference_steps"]
    assert w["clip_flops"] == sum(w["flops"].values()) + \
        (steps - 1) * w["flops"]["step"]
    assert w["gemm_bound_s"] > 0 and w["flash40_bound_s"] == 0


def test_fp8_operands_round():
    x = torch.linspace(-3, 3, 1001)
    r = nn.round_fp8(x)
    assert (r - x).abs().max() > 1e-3
    assert ((r - x).abs() <= x.abs().max() / 448 * 16).all()
