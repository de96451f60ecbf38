"""The tracker's recorder (``decomp/sam2.py::TrackRecord`` under
``decomp/factory.py::TrackVideo``, the ``track_video`` of
``build_decomp_models``) on the tiny CPU configuration: the five spans in
order with one ``track.frame`` range and mark a propagated frame, the
counters (memory slots reaching the ring's size, keys, pointer tokens,
bytes), no host read of a device value added by the recorder and none in
the encode or the frame loop, the masks equal in every bit with and
without the recorder, and the benchmark's five readers of its record
(``benchmark/metrics/``)."""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import spec as S
from mimo_tpu_torch.decomp import factory as FA
from mimo_tpu_torch.decomp import sam2 as S2

FRAMES = 6
SPANS = ["track.key", "track.encode", "track.prompt", "track.frame",
         "track.masks"]
READERS = ["track.encode_ms", "track.frame_ms", "models.track_mfu",
           "kernels.flash72_roofline", "kernels.memattn_roofline"]


@pytest.fixture(scope="module")
def params():
    return S2.sam2_init(torch.Generator().manual_seed(3),
                        S2.tiny_sam2_config())


@pytest.fixture(scope="module")
def clip():
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (40, 56, 3)).astype(np.uint8)
              for _ in range(FRAMES)]
    mask = np.zeros((40, 56), bool)
    mask[10:30, 20:40] = True
    return frames, mask


def _models(params):
    return FA.build_decomp_models(params={"sam2": params}, only={"sam2"},
                                  device="cpu", tiny=True)


def _host_ranges(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e.name() for e in sorted(prof.profiler.kineto_results.events(),
                                     key=lambda e: e.start_ns())
            if e.device_type() != cuda and e.name().startswith("track.")]


def test_spans_in_order_with_a_mark_a_frame(params, clip):
    frames, mask = clip
    models = _models(params)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        models.track_video(frames, mask, 0)
    names = _host_ranges(prof)
    assert list(dict.fromkeys(names)) == SPANS
    assert names.count("track.frame") == FRAMES - 1
    assert names.count("track.masks") == 2        # one a direction
    rec = models.track_video.last_record
    assert [m for m, _ in rec.clock.marks] == (
        ["start", "encode", "prompt"]
        + [f"frame{i}" for i in range(FRAMES - 1)])
    tm = rec.timings()
    assert [s["name"] for s in tm["spans"]] == ["track.key", "track.masks",
                                                "track.masks"]
    assert tm["frames"] == len(tm["frame_ms"]) == FRAMES - 1
    assert tm["encode"] > 0 and tm["prompt"] > 0
    assert tm["frame_mean"] == pytest.approx(np.mean(tm["frame_ms"]))
    # a second call on the same clip is a clip of its own, encode cached
    models.track_video(frames, mask, 0)
    again = models.track_video.last_record.timings()
    assert again["clip"] == tm["clip"] + 1 and again["encode"] is None


def test_counters(params, clip):
    frames, mask = clip
    models = _models(params)
    masks = models.track_video(frames, mask, 0)
    rec = models.track_video.last_record
    cfg = S2.tiny_sam2_config()
    per_ptr = cfg.dim // cfg.mem_dim
    assert rec.slots == [1, 2, 3, 3, 3]           # the ring: 1 + 2 recent
    assert rec.ptr_tokens == [per_ptr * n for n in (1, 2, 3, 4, 4)]
    assert rec.keys == [m * 16 + p for m, p in zip(rec.slots,
                                                   rec.ptr_tokens)]
    tm = rec.timings()
    assert tm["slots"] == pytest.approx(np.mean(rec.slots))
    # up: the clip's frames as they are, the 5 points and their labels;
    # back: the prompt frame's mask and both directions' masks
    assert tm["h2d_bytes"] == FRAMES * 40 * 56 * 3 + 5 * 2 * 4 + 5 * 4
    assert tm["d2h_bytes"] == 40 * 56 + 2 * masks.nbytes


def test_hiera_pass_counters(params, clip):
    """The encode's Hiera passes, logged with the clip's counters: on the
    CPU the row passes' plain versions, 3 a block an encode chunk (the 6
    frames are one chunk of 8), no kernel launch; 0 where the encode was
    cached."""
    frames, mask = clip
    models = _models(params)
    models.track_video(frames, mask, 0)
    tm = models.track_video.last_record.timings()
    depth = S2.tiny_sam2_config().hiera.depth
    assert {k: tm[k] for k in S2.HIERA_PASSES} == {
        "hiera_fused_passes": 0, "hiera_eager_passes": 3 * depth,
        "hiera_ln_passes": 0}
    models.track_video(frames, mask, 0)
    tm = models.track_video.last_record.timings()
    assert all(tm[k] == 0 for k in S2.HIERA_PASSES)


HOST_READS = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
              "__float__")


def _count_host_reads(monkeypatch, fn):
    counts = {}
    for name in HOST_READS:
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    try:
        out = fn()
    finally:
        monkeypatch.undo()
    return counts, out


def test_recorder_adds_no_host_read(params, clip, monkeypatch):
    """The same reads of device values with the recorder (``track_video``)
    as without it (the bare predictor's calls), and none inside the frame
    loop; equal masks in every bit."""
    frames, mask = clip
    models = _models(params)
    pts = FA.sample_mask_points(mask, n=5)
    lbl = np.ones(len(pts), np.int32)

    def bare():
        pred = S2.SAM2VideoPredictor(params, S2.tiny_sam2_config())
        pred.init_state(list(frames))
        pred.add_new_points(0, pts, lbl)
        return pred.propagate_in_video(False) | pred.propagate_in_video(True)

    with_rec, masks = _count_host_reads(monkeypatch, lambda: models.track_video(
        frames, mask, 0))
    without, want = _count_host_reads(monkeypatch, bare)
    assert with_rec == without
    np.testing.assert_array_equal(masks, want)
    np.testing.assert_array_equal(
        masks, S2.track_object(params, S2.tiny_sam2_config(), frames, pts,
                               lbl))
    pred = models.track_video.tracker
    pred.record = S2.TrackRecord(models.track_video.last_record.clock)
    loop, _ = _count_host_reads(monkeypatch, lambda: pred.propagate_logits(
        list(range(1, FRAMES))))
    assert loop == {}


class _Reads(TorchDispatchMode):
    """Counts the operators that read a tensor's value on the host
    (``aten._local_scalar_dense``: ``item``, ``bool``, indexing with a
    tensor), which on CUDA wait for the device."""

    def __init__(self):
        super().__init__()
        self.reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.reads += 1
        return func(*args, **(kwargs or {}))


def test_encode_and_frame_loop_never_wait_for_the_device(params, clip):
    """No value is read on the host in the encode or the frame loop (a
    read waits for the device, and breaks the loop's CUDA graph)."""
    frames, mask = clip
    models = _models(params)
    models.track_video(frames, mask, 0)
    pred = models.track_video.tracker
    with _Reads() as enc:
        pred.init_state(list(frames))
    pred.add_new_points(0, FA.sample_mask_points(mask), np.ones(5, np.int32))
    with _Reads() as loop:
        pred.propagate_logits(list(range(1, FRAMES)))
    assert enc.reads == 0 and loop.reads == 0


def _rec(frame_ms=(2.0, 4.0), encode=30.0, trace=None, work=None):
    tm = {"encode": encode, "prompt": 1.0, "frame_ms": list(frame_ms)}
    return {"clips": [{"ok": True, "timings": tm, "wall_s": 0.5,
                       "frames": 3},
                      {"ok": False, "timings": {}, "wall_s": 0.1,
                       "frames": 0}],
            "window_s": 1.0, "trace": trace, "work": work}


def test_readers_of_the_record():
    read = {n: S.reader(n) for n in READERS}
    trace = {"kernels": {"void flash_fwd_kernel<72>(x)": 0.004,
                         "pytorch_flash::flash_fwd_kernel<pytorch_flash::"
                         "Flash_fwd_kernel_traits<256, 64>>": 0.010,
                         "gemm": 1.0}}
    work = {"clip_flops": 9.89e12, "flash72_bound_s": 0.002,
            "memattn_bound_s": 0.004}
    rec = _rec(trace=trace, work=work)
    assert read["track.encode_ms"](rec) == 30.0
    assert read["track.frame_ms"](rec) == 3.0
    assert read["models.track_mfu"](rec) == pytest.approx(1.0)
    assert read["kernels.flash72_roofline"](rec) == pytest.approx(50.0)
    assert read["kernels.memattn_roofline"](rec) == pytest.approx(40.0)
    # untraced, cached or not this program's record: nothing to read
    bare = _rec(encode=None, frame_ms=())
    for name in READERS:
        assert read[name](bare) is None, name
    assert read["models.track_mfu"](_rec(work={"clip_flops": 1.0})) \
        == pytest.approx(100 / 989e12)
    synthesis = {"flops": {}, "clip_flops": 1.0, "flash40_bound_s": 1.0}
    assert read["kernels.flash72_roofline"](_rec(trace=trace,
                                                 work=synthesis)) is None
