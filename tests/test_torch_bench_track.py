"""The port's SAM 2 tracker (``decomp/sam2.py``, ``decomp/hiera.py``,
through ``build_decomp_models(...).track_video``) against the benchmark's
plain float32 reference (``benchmark/reference/{hiera,sam2}.py``) at the
tiny configuration on seeded weights: the weights' layout, each module, a
10-frame clip (the 3-slot memory ring and the 4 pointers fill and wrap),
the record of decisions and the near-tie rule, the planted faults of the
cell's calibration (each must read not correct), the work count against a
hand count, and a whole run of the cell at tiny size.

Tolerance: both sides compute in float32 on the CPU from the same weights
and inputs, so modules agree to float32 rounding (1e-4 absolute on values
of order 1, through the tiny Hiera's 4 blocks and the decoder's 2), and
the clip's compared sigmoids to 1e-7. ``LIMITS`` stand in for a cell's
limits at this size: above the sound program's gaps (mean ~4e-9, 99.9th
percentile 6e-8) and below the float8 control's (mean ~5e-4) and every
planted fault's (the rotated pointers', the smallest: mean 6e-7, 99.9th
percentile 4e-6).
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import check
from benchmark import run as BR
from benchmark.entries import track as T
from benchmark.reference import hiera as RH
from benchmark.reference import nn
from benchmark.reference import params as P
from benchmark.reference import sam2 as RS
from benchmark.traffic import generator as G
from benchmark.work import track_count as TC
from mimo_tpu_torch.decomp import hiera as PH
from mimo_tpu_torch.decomp import sam2 as S2
from tests.test_torch_helpers import set_fp32_matmuls

set_fp32_matmuls()

CPU = torch.device("cpu")
TOL = dict(atol=1e-4, rtol=1e-4)
LIMITS = {"mean_abs": 1e-7, "p999_abs": 1e-6}
TRAFFIC = {"frames": 10, "height": 40, "width": 72,
           "streams": ["sdc", "vid", "bk", "occ"], "speed": [1, 3],
           "ref_size": [48, 32], "occ_size": [6, 8], "max_clips": 2}
CELL = "track-150f-404x720"


def tiny_config() -> dict:
    """The cell's configuration file with the port's tiny SAM 2 fields."""
    c = dataclasses.asdict(S2.tiny_sam2_config())
    h = {k: list(v) if isinstance(v, tuple) else v
         for k, v in c.pop("hiera").items()}
    with open("benchmark/configs/sam2-hiera-l-track.json") as f:
        cfg = json.load(f)
    cfg.update(hiera=h, sam2=c, dtype="float32")
    return cfg


@pytest.fixture(scope="module")
def cfg():
    return tiny_config()


@pytest.fixture(scope="module")
def params(cfg):
    gen = torch.Generator().manual_seed(G.weights_seed(5))
    return P.draw(T.layout(cfg), gen, torch.float32)


def _port_cfg():
    return S2.tiny_sam2_config()


def _pixels(seed, n=2, s=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, s, s, 3), generator=g)


def _run(cfg, params, seed=3, traffic=TRAFFIC):
    """The program's clip and the reference's of the same inputs (the
    reference following the program's record)."""
    prog = T.Program(cfg, None, params, CPU, torch.float32)
    inp = G.clip_inputs(traffic, seed, 0)
    out = prog.clip(inp)
    ref = T.reference(cfg, params, inp, CPU)
    return out, ref, prog, inp


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape)
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return [_shapes(v) for v in tree]


def test_layout_is_the_ports_tree(cfg, params):
    port = S2.sam2_init(torch.Generator().manual_seed(0), _port_cfg())
    assert _shapes(params) == _shapes(port)
    assert params["decoder"]["obj_mlp"]["fc3"]["bias"].min() >= 4.0
    T._port_config(cfg)                          # the factory's tiny config
    with pytest.raises(ValueError, match="prompt"):
        T._port_config(dict(cfg, track=dict(cfg["track"], points=3)))


def test_encoder_matches_reference(cfg, params):
    px = _pixels(0)
    feat, s1, s0, pos = S2.encode_frames(params, _port_cfg(), px)
    for i in range(px.shape[0]):
        rf, r1, r0 = RS.encode(params, cfg, px[i:i + 1])
        torch.testing.assert_close(feat[i], rf, **TOL)
        torch.testing.assert_close(s1[i], r1, **TOL)
        torch.testing.assert_close(s0[i], r0, **TOL)
    torch.testing.assert_close(pos, RH.sine_embed(4, 4, 32, CPU), **TOL)
    # the plan and the position embedding, written apart on both sides
    hcfg = _port_cfg().hiera
    assert [tuple(b) for b in RH.block_plan(cfg["hiera"])] == \
        hcfg.block_plan()
    torch.testing.assert_close(
        PH.hiera_pos_embed(params["trunk"], hcfg, 16, 16),
        RH.pos_embed(params["trunk"], 16, 16, CPU), **TOL)


@pytest.mark.parametrize("m,n_ptr", [(1, 1), (3, 4)])
def test_memory_attention_matches_reference(cfg, params, m, n_ptr):
    """RoPE self- and cross-attention with the memories' keys rotated and
    the pointer tokens not."""
    g = torch.Generator().manual_seed(m)
    c = _port_cfg()
    feat, pos = (torch.randn((4, 4, c.dim), generator=g) for _ in range(2))
    mem, mpos = (torch.randn((m, 4, 4, c.mem_dim), generator=g)
                 for _ in range(2))
    ptr = torch.randn((n_ptr * c.dim // c.mem_dim, c.mem_dim), generator=g)
    got = S2.memory_attention(params, c, feat, pos, mem, mpos, ptr)
    want = RS.memory_attention(params, cfg, feat, pos, mem, mpos, ptr)
    torch.testing.assert_close(got, want, **TOL)


def test_memory_encoder_matches_reference(cfg, params):
    g = torch.Generator().manual_seed(2)
    feat = torch.randn((4, 4, 32), generator=g)
    mask = torch.randn((64, 64), generator=g) * 10
    torch.testing.assert_close(S2.encode_memory(params, _port_cfg(), feat,
                                                mask),
                               RS.encode_memory(params, feat, mask), **TOL)


@pytest.mark.parametrize("multimask", [True, False])
def test_decoder_matches_reference(cfg, params, multimask):
    """The two-way decoder's masks, IoUs and object logit, and the port's
    recorded decisions against the reference's at this seed."""
    c = _port_cfg()
    feat, s1, s0, _ = S2.encode_frames(params, c, _pixels(1, n=1))
    pts = np.array([[20.0, 30.0], [40.0, 12.0]], np.float32)[:1 if multimask
                                                             else 2]
    sparse = S2.encode_points(params, c, torch.from_numpy(pts)[None],
                              torch.ones((1, len(pts)), dtype=torch.int32))
    masks, iou, _, obj = S2.decode_masks(params, c, feat[0], sparse,
                                         s0[0], s1[0])
    r_masks, r_iou, _, r_obj = RS.decode(
        params, cfg, feat[0], RS.point_tokens(params, pts, 64, CPU), s0[0],
        s1[0])
    torch.testing.assert_close(masks[0], r_masks, **TOL)
    torch.testing.assert_close(iou[0], r_iou, **TOL)
    torch.testing.assert_close(obj[0, 0], r_obj, **TOL)
    decided = {}
    S2.forward_sam_heads(params, c, feat[0], s0[0], s1[0], sparse,
                         multimask, decided=decided)
    assert int(decided["best"]) == int(torch.argmax(r_iou[1:]))
    assert float(decided["obj"]) == pytest.approx(float(r_obj), abs=1e-4)
    assert ("stable" in decided) == (not multimask)


def test_clip_matches_reference_and_its_record(cfg, params):
    """A 10-frame clip through the entry: the compared sigmoids equal the
    reference's, which takes its own decisions where it agrees; the record
    holds every frame; the ring (3 memories) and the pointers (4) fill."""
    out, ref, prog, inp = _run(cfg, params)
    assert out.shape == ref.shape == (10, 16, 16)
    gaps = check.gaps(out, ref)
    assert gaps["p999_abs"] < 1e-6 and check.judge(gaps, LIMITS)
    dec = T._DECISIONS[inp["seed"]]
    assert list(dec["frames"]) == list(range(1, 10))
    assert dec["best"].shape == dec["obj"].shape == (9,)
    assert (dec["obj"] > 0).all()                 # the gate's biased head
    assert dec["prompt_stable"] is not None       # 5 points: single output
    assert dec["prompt_mask"].shape == (64, 64)
    tm = prog.timings()
    assert tm["frames"] == 9 and len(tm["frame_ms"]) == 9
    rec = prog.models.track_video.last_record
    assert max(rec.slots) == 3 and max(rec.ptr_tokens) == 4 * 2
    assert rec.keys[-1] == 3 * 16 + 8
    # without a record the reference decides alone, and agrees here
    T._DECISIONS.clear()
    alone = T.reference(cfg, params, inp, CPU)
    assert check.gaps(alone, ref)["p999_abs"] < 1e-6


def test_frame_graphs_replay_the_eager_loop(cfg, params, monkeypatch):
    """The CUDA-graph path of the frame loop (``_FrameGraph``: one graph a
    shape of the bank, made at its first frame, which runs for real, and
    replayed for every later frame of that shape, on later clips too) with
    the capture stood in by the step itself: every frame's logits and
    decisions equal the eager loop's in every bit, on two clips through
    one tracker; the tiny bank's shapes are (1, 1), (2, 2), (3, 3) and
    (3, 4)."""
    clips = [G.clip_inputs(TRAFFIC, seed, 0) for seed in (3, 4)]

    def track(models):
        out = []
        for inp in clips:
            models.track_video(list(inp["vid"]), T.first_mask(inp), 0)
            rec = models.track_video.last_record
            out.append((rec.picked(), rec.decisions()))
        return out

    eager = track(T.Program(cfg, None, params, CPU, torch.float32).models)
    made = []
    monkeypatch.setattr(S2, "_use_graph", lambda device: True)
    monkeypatch.setattr(S2, "_graphed", lambda fn, device, pool: (
        made.append(pool), (fn(), fn, "pool"))[1])
    models = T.Program(cfg, None, params, CPU, torch.float32).models
    graphed = track(models)
    assert sorted(models.track_video.tracker._graphs) == [
        (1, 1), (2, 2), (3, 3), (3, 4)]
    assert made == [None, "pool", "pool", "pool"]   # one shared pool
    for (a, da), (b, db) in zip(eager, graphed):
        assert torch.equal(a, b)
        for k in ("best", "obj"):
            np.testing.assert_array_equal(da[k], db[k])


def test_near_tie_rule():
    d = RS.Decider({"x": 1}, RS.TIES)
    ious = torch.tensor([0.50, 0.51, 0.90])
    assert d.best(ious, None) == 2
    assert d.best(ious, 2) == 2
    assert d.best(ious, 0) == 2                   # 0.40 behind: its own
    close = torch.tensor([0.700, 0.705, 0.10])
    assert d.best(close, 0) == 0                  # within 0.02: followed
    assert d.stable(0.985, 0.98, False) is False  # within 0.01
    assert d.stable(0.999, 0.98, False) is True
    assert d.present(0.1, -0.2) is False          # |0.1| <= 0.25
    assert d.present(3.0, -0.2) is True
    logits = torch.tensor([[-1.0, -0.1], [0.2, 2.0]])
    prog = np.array([[True, True], [False, False]])
    np.testing.assert_array_equal(d.binary(logits, prog).numpy(),
                                  [[False, True], [False, True]])
    assert d.stats["iou"] == {"decisions": 4, "followed": 1, "differ": 1}
    assert d.stats["pixel"] == {"decisions": 4, "followed": 2, "differ": 2}
    assert RS.Decider(None, RS.TIES).best(close, None) == 1


# ---------------------------------------------------------------------------
# planted faults: the program broken underneath, the reference unchanged
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def patched(module, name, make):
    orig = getattr(module, name)
    setattr(module, name, make(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


def _first_candidate(orig):
    """Every pick is candidate 0 of the decoder's masks (the single-output
    one), never the best of the three multimask outputs: candidate 0 is
    copied over the first multimask output, whose IoU is set above any."""
    def decode(*a, **kw):
        masks, iou, toks, obj = orig(*a, **kw)
        masks, iou, toks = masks.clone(), iou.clone(), toks.clone()
        masks[:, 1], toks[:, 1], iou[:, 1] = masks[:, 0], toks[:, 0], 2.0
        return masks, iou, toks, obj
    return decode


def _gate_inverted(orig):
    def decode(*a, **kw):
        masks, iou, toks, obj = orig(*a, **kw)
        return masks, iou, toks, -obj
    return decode


def _recent_dropped(orig):
    """Memory attention sees the conditioning memory alone."""
    def attend(p, cfg, feat, feat_pos, mem, mem_pos, ptr):
        return orig(p, cfg, feat, feat_pos, mem[:1], mem_pos[:1], ptr)
    return attend


def _pointers_rotated(orig):
    """The cross-attention's pointer tokens rotated like the memories'
    keys, with the angles of the grid's first positions."""
    def attend(p, q_in, k_in, v_in, heads, cos, sin, repeat_k=1,
               k_rope_len=None):
        if k_rope_len is None:
            return orig(p, q_in, k_in, v_in, heads, cos, sin)
        dt = p["q"]["kernel"].dtype
        q = torch.matmul(q_in.to(dt), p["q"]["kernel"]) + p["q"]["bias"]
        k = torch.matmul(k_in.to(dt), p["k"]["kernel"]) + p["k"]["bias"]
        v = torch.matmul(v_in.to(dt), p["v"]["kernel"]) + p["v"]["bias"]
        extra = k.shape[1] - k_rope_len
        ck = torch.cat([cos.repeat(repeat_k, 1), cos[:extra]])
        sk = torch.cat([sin.repeat(repeat_k, 1), sin[:extra]])
        b, sq, inner = q.shape
        dh = inner // heads
        qh = S2._apply_rope(q.reshape(b, sq, heads, dh).transpose(1, 2),
                            cos, sin)
        kh = S2._apply_rope(k.reshape(b, -1, heads, dh).transpose(1, 2),
                            ck, sk)
        o = S2.attention_heads(qh.transpose(1, 2), kh.transpose(1, 2),
                               v.reshape(b, -1, heads, dh))
        return torch.matmul(o.reshape(b, sq, inner), p["out"]["kernel"]) \
            + p["out"]["bias"]
    return attend


def box_dropped(blocks, keep=64):
    """Hiera's global blocks' attention with each head's q, k and v columns
    from ``keep`` on zero: at d = 72 the flash kernel's second 64-column
    box dropped (at the tiny d = 8, the last column). ``blocks``: the
    global blocks' parameters."""
    def make(orig):
        def attn(blk, x, heads, dout, q_pool, hgt, wid):
            if not any(blk is b for b in blocks):
                return orig(blk, x, heads, dout, q_pool, hgt, wid)
            d = dout // heads
            w = blk["qkv"]["kernel"]
            keep_col = torch.arange(3 * dout, device=w.device) % d \
                < min(keep, d - 1)
            qkv = {"kernel": w * keep_col,
                   "bias": blk["qkv"]["bias"] * keep_col}
            return orig(dict(blk, qkv=qkv), x, heads, dout, q_pool, hgt,
                        wid)
        return attn
    return make


def fault(name, params, cfg):
    """The planted fault ``name`` as a context manager."""
    if name == "box_dropped":
        blocks = [params["trunk"]["blocks"][i]
                  for i in cfg["hiera"]["global_blocks"]]
        return patched(PH, "_attn", box_dropped(blocks))
    module, attr, make = {
        "first_candidate": (S2, "decode_masks", _first_candidate),
        "gate_inverted": (S2, "decode_masks", _gate_inverted),
        "recent_dropped": (S2, "memory_attention", _recent_dropped),
        "pointers_rotated": (S2, "_rope_attention", _pointers_rotated),
    }[name]
    return patched(module, attr, make)


FAULTS = ["box_dropped", "first_candidate", "gate_inverted",
          "pointers_rotated", "recent_dropped"]


@pytest.mark.parametrize("name", FAULTS)
def test_planted_fault_reads_not_correct(cfg, params, name):
    with fault(name, params, cfg):
        out, ref, _, _ = _run(cfg, params)
    assert not check.judge(check.gaps(out, ref), LIMITS), name


def test_control_reads_not_correct(cfg, params):
    inp = G.clip_inputs(TRAFFIC, 3, 0)
    ref = T.reference(cfg, params, inp, CPU)
    with nn.operands("fp8"):
        ctl = T.reference(cfg, params, inp, CPU)
    assert not check.judge(check.gaps(ctl, ref), LIMITS)


# ---------------------------------------------------------------------------
# the work count, and a whole run of the cell
# ---------------------------------------------------------------------------


def test_work_count_against_a_hand_count(cfg):
    """One memory-attention layer at the tiny widths, counted by hand: the
    projections, the self-attention over the grid's S tokens and the
    cross-attention over the M memories' tokens and the pointers'."""
    c = dataclasses.replace(_port_cfg())
    d, md, ff = c.dim, c.mem_dim, c.mem_ff
    s, m, n_ptr = 16, 3, 4
    keys = m * s + n_ptr * d // md
    hand = (2 * s * d * d * 4                         # self q, k, v, out
            + 2 * 2 * s * s * d                       # its two products
            + 2 * s * d * d * 2 + 2 * keys * md * d * 2   # cross q, out; k, v
            + 2 * 2 * s * keys * d                    # its two products
            + 2 * s * d * ff * 2)                     # the feed-forward
    p = TC._meta_tree(T.layout(cfg))
    with FlopCounterMode(display=False) as fc:
        RS.memory_attention(p, cfg, TC._empty(4, 4, d), TC._empty(4, 4, d),
                            TC._empty(m, 4, 4, md), TC._empty(m, 4, 4, md),
                            TC._empty(n_ptr * d // md, md))
    assert fc.get_total_flops() == hand
    assert TC.frame_memory(1, cfg) == (1, 1)
    assert TC.frame_memory(9, cfg) == (3, 4)
    w = TC.clip_work(cfg, 10)
    assert w["clip_flops"] > 10 * w["flops"]["encode"] > 0
    assert w["flash72_bound_s"] == 0       # no global block at d = 72 here
    assert w["memattn_bound_s"] == 0       # nor memory attention at 256


def test_whole_run_of_the_cell_at_tiny_size(cfg, tmp_path):
    path = tmp_path / "tiny-track.json"
    path.write_text(json.dumps(cfg))
    res = BR.run_cell(CELL, 2 ** 31 + 17, 0.0, True, device=CPU,
                      cfg_path=path, traffic=TRAFFIC, limits=LIMITS)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] == 1
    m = res["metrics"]
    assert {"track.encode_ms", "track.frame_ms", "models.track_mfu"} <= set(m)
    # no card: the kernels' rooflines find nothing to read
    assert "kernels.flash72_roofline" not in m
    assert "kernels.memattn_roofline" not in m
