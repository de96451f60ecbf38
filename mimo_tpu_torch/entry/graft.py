"""Entry hooks of the port and its multi-process runs.

Counterpart of the root ``__graft_entry__.py``:

- ``entry(device=None)`` -> (fn, example_args): the denoising UNet3D forward
  of the tiny config (banks, pose features, CFG) on the card unless the
  caller asks for the CPU.
- ``dryrun_multichip(n, backend=..., device=...)``: on ``n`` ranks, the
  four checks of ``__graft_entry__.py``, each against the single-process
  result: window DP (10 frames, the window count padded to n), the
  frame-sharded single-window clip (24 frames or the next multiple of n),
  the 2-D (windows x frames) mesh at even n >= 4 (12 frames, context 8,
  overlap 4), and the decomposition's motion stage on a ragged n + 1
  frames (the sdc within one uint8 level).
- ``spawn(body, world, ...)``: starts ``world`` ranks with
  ``torch.multiprocessing`` in spawn mode (a child imports only what the
  body needs, never a parent's JAX), joins them through
  ``init_method="file://..."`` in a temporary directory (no port to
  clash between concurrent runs), runs ``body(device, *args)`` on each
  and returns every rank's result; any rank's failure raises. The rank
  bodies of the tests live here, so a child imports only
  ``mimo_tpu_torch``.

    python -m mimo_tpu_torch.entry.graft --world N --backend {nccl,gloo}
        [--device cpu | cuda | cuda:0] [--probe]

runs ``dryrun_multichip`` (``--probe``: which collectives the backend runs
on the device's tensors, each called directly).
On the CPU the checks hold the sharded runs to 2e-5 (fp32); on the card
(bf16 and the kernels) to ``MULTI_TOL``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# sharded vs single-process limits (max, mean abs error on [0, 1] pixels)
# of a bf16 run on the card: between the sound seeds (max 0.106-0.152,
# mean 0.0064-0.0076) and the planted faults (the PE over a rank's frames
# 0.465 / 0.034, the all-to-all's blocks reversed 1.0 / 0.117) of
# ``chip_smoke.py --calibrate multi`` (PERF.md)
MULTI_TOL = (0.3, 0.015)
FP32_TOL = 2e-5          # fp32 on the CPU (the JAX package's bound)


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' to run on the "
                           "CPU")
    return dev


# ---------------------------------------------------------------------------
# entry()
# ---------------------------------------------------------------------------


def entry(device=None):
    """The denoising-UNet forward (the flagship compute path) of the tiny
    config and its example arguments: bf16 on the card, fp32 on the CPU."""
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.models import unet as U
    dev = _device(device)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    cfg = C.tiny_mimo_config()
    ucfg, rcfg = cfg.denoising_unet, cfg.reference_unet
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    p3 = U.unet_init(gen, ucfg, dtype)
    p2 = U.unet_init(gen, rcfg, dtype)
    W, F, H = 2, 4, 32
    with torch.inference_mode():
        banks = U.unet2d_apply(p2, rcfg, randn(2, H, H, 4), 0.0,
                               randn(2, 1, rcfg.cross_attention_dim))
    cond_banks = tuple(b[1] for b in banks)
    x = randn(2 * W, F, H, H, 8)
    ctx = torch.cat([torch.zeros((W, 1, ucfg.cross_attention_dim), dtype=dtype,
                                 device=dev),
                     randn(1, 1, ucfg.cross_attention_dim).expand(W, -1, -1)])
    pose = randn(2 * W, F, H, H, ucfg.block_out_channels[0])

    def fn(params, x, t, ctx, pose, banks):
        return U.unet3d_apply(params, ucfg, x, t, ctx, pose, list(banks),
                              cfg_split=True)

    return fn, (p3, x, 500.0, ctx, pose, cond_banks)


# ---------------------------------------------------------------------------
# the spawner
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, backend: Optional[str], device,
               init_file: str, out_dir: str, body: Callable,
               args: Sequence[Any]) -> None:
    from mimo_tpu_torch import parallel
    if torch.device(device or "cuda").type == "cpu":
        torch.set_num_threads(1)
    dev = parallel.init(backend, device, init_method="file://" + init_file,
                        world_size=world, rank=rank)
    try:
        result = body(dev, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(body: Callable, world: int, *, backend: Optional[str] = None,
          device=None, args: Sequence[Any] = ()) -> List[Any]:
    """``body(device, *args)`` on ``world`` ranks (``parallel.init``'s
    ``backend`` and ``device``); returns each rank's result, in rank order.
    ``body`` and ``args`` must pickle (a module-level function)."""
    with tempfile.TemporaryDirectory(prefix="mimo_ranks_") as tmp:
        mp.start_processes(
            _rank_main, args=(world, backend, device,
                              os.path.join(tmp, "init"), tmp, body,
                              tuple(args)),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------


def bodies(dev, jobs: Sequence[Tuple[Callable, Sequence[Any]]]
           ) -> List[Any]:
    """Several rank bodies in one world: [body(dev, *args) for body,
    args in jobs]."""
    return [body(dev, *args) for body, args in jobs]


def comm_body(dev, cases: Sequence[Dict[str, Any]]) -> List[np.ndarray]:
    """Each case: {"mesh": (shape, axis names), or None for ``get_mesh``'s
    world-wide "data" mesh, "axis": name, "op": "all_to_all" |
    "all_gather" | "broadcast" (``comm``'s, over the axis's group),
    "inputs": one numpy array a rank, "kwargs": the op's other arguments}.
    Returns this rank's outputs."""
    from mimo_tpu_torch.parallel import comm
    from mimo_tpu_torch.parallel import mesh as M
    out = []
    for case in cases:
        mesh = (M.get_mesh(device=dev) if case["mesh"] is None
                else M.ProcessMesh(*case["mesh"], dev))
        x = torch.from_numpy(case["inputs"][mesh.rank]).to(dev)
        y = getattr(comm, case["op"])(x, mesh.group(case["axis"]),
                                      **case.get("kwargs", {}))
        out.append(y.cpu().numpy())
    return out


def probe_body(dev) -> Dict[str, str]:
    """Which collectives the world's backend runs on ``dev``'s tensors:
    each called directly (no host staging), its result checked."""
    world, rank = dist.get_world_size(), dist.get_rank()
    x = torch.arange(2 * world, dtype=torch.float32, device=dev) + 10 * rank
    calls = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(world * x.numel(), device=dev), x),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_gather uint8": lambda: dist.all_gather(
            [torch.empty_like(x, dtype=torch.uint8) for _ in range(world)],
            x.to(torch.uint8)),
    }
    result = {}
    for name, call in calls.items():
        try:
            call()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            result[name] = "ok"
        except (RuntimeError, ValueError) as e:   # what the probe reports
            result[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    from mimo_tpu_torch.parallel import comm
    from mimo_tpu_torch.parallel.mesh import get_mesh
    g = get_mesh(device=dev).group("data")
    got = comm.all_to_all(x.reshape(world, 2), g, 0, 1)
    want = torch.cat([x[2 * rank:2 * rank + 2] - 10 * (rank - r)
                      for r in range(world)])[None]
    result["comm.all_to_all"] = "ok" if torch.equal(got, want) else "WRONG"

    return result


@contextlib.contextmanager
def count_window_frames():
    """Counts, in the yielded list's one item, the window-frames the UNet
    runs inside (the frame indices of each ``_run_unet_window_chunk``
    call)."""
    from mimo_tpu_torch.pipelines import pose2vid as P
    inner, count = P._run_unet_window_chunk, [0]

    def counted(params_du, st, cond, latents, t, w_idx, *args, **kwargs):
        count[0] += w_idx.numel()
        return inner(params_du, st, cond, latents, t, w_idx, *args, **kwargs)

    P._run_unet_window_chunk = counted
    try:
        yield count
    finally:
        P._run_unet_window_chunk = inner


def generation_body(dev, params, cases: Sequence[Dict[str, Any]],
                    dtype=torch.float32) -> List[Dict[str, Any]]:
    """Each case: {"mesh": (shape, axis names), "static": the
    Pose2VideoStatic fields but ``mesh``, "inputs": (ref, pose, bk,
    clip_pixels, noise) numpy}. Returns this rank's video and the
    window-frames its UNet ran (``count_window_frames``)."""
    from mimo_tpu_torch.parallel.mesh import ProcessMesh
    from mimo_tpu_torch.pipelines import pose2vid as P
    params = _to(params, dev)
    out = []
    for case in cases:
        mesh = ProcessMesh(*case["mesh"], dev)
        st = P.Pose2VideoStatic(**case["static"], mesh=mesh)
        args = [torch.from_numpy(np.asarray(a)).to(dev, dtype)
                for a in case["inputs"]]
        with count_window_frames() as frames:
            video = P.generate_host_loop(params, st, *args)
        out.append({"video": video.float().cpu().numpy(),
                    "unet_frames": frames[0]})
    return out


def motion_body(dev, models: Dict[str, Any],
                cases: Sequence[Dict[str, Any]]) -> List[Any]:
    """The decomposition's frame-parallel forwards on a 1-D "data" mesh
    over the world. ``models``: {"vitpose": (params, cfg), "hmr": (params,
    cfg), "smpl": SMPLModel, "focal": f}. Each case is
    {"op": "vitpose" | "hmr", "crops": numpy} (``frame_parallel`` over
    the flip-test heatmaps / the HMR2 forward), {"op": "render", "scene":
    (verts, faces, colors, focal, center, H, W)}, {"op": "motion", "clip":
    (frames, masks, boxes)} (``MotionEstimator(mesh=...)``), or {"op":
    "pose_batch", "clip": (frames, boxes)} (the factory's
    ``estimate_pose_batch`` in batches of 2, built with the mesh)."""
    from mimo_tpu_torch.decomp import hmr as HM
    from mimo_tpu_torch.decomp import vitpose as VP
    from mimo_tpu_torch.decomp.motion import MotionEstimator
    from mimo_tpu_torch.parallel.decomp import (frame_parallel,
                                                render_frames_sharded)
    from mimo_tpu_torch.parallel.mesh import get_mesh
    mesh = get_mesh(device=dev)
    vp, vcfg = _to(models["vitpose"][0], dev), models["vitpose"][1]
    hp, hcfg = _to(models["hmr"][0], dev), models["hmr"][1]
    out = []
    for case in cases:
        if case["op"] == "vitpose":
            fn = frame_parallel(
                lambda p, c: VP.heatmaps_flip_test(p, vcfg, c), mesh)
            res = fn(vp, torch.from_numpy(case["crops"]).to(dev))
        elif case["op"] == "hmr":
            fn = frame_parallel(lambda p, c: HM.hmr_forward(p, hcfg, c),
                                mesh)
            res = fn(hp, torch.from_numpy(case["crops"]).to(dev))
        elif case["op"] == "render":
            verts, faces, colors, focal, center, h, w = case["scene"]
            res = render_frames_sharded(
                torch.from_numpy(verts).to(dev), torch.from_numpy(faces),
                torch.from_numpy(colors), focal, torch.tensor(center),
                height=h, width=w, mesh=mesh)
        elif case["op"] == "pose_batch":
            from mimo_tpu_torch.decomp.factory import build_decomp_models
            res = build_decomp_models(
                params={"vitpose": vp}, tiny=True, device=dev,
                mesh=mesh).estimate_pose_batch(*case["clip"], batch=2)
        else:
            res = MotionEstimator(
                vitpose_params=vp, vitpose_cfg=vcfg, hmr_params=hp,
                hmr_cfg=hcfg, smpl_model=models["smpl"],
                focal=models["focal"], mesh=mesh).estimate_motion(
                    *case["clip"])
        out.append(_to(res, "cpu"))
    return out


# ---------------------------------------------------------------------------
# dryrun_multichip
# ---------------------------------------------------------------------------


def _tiny_inputs(cfg, frames: int, h: int, w: int, seed: int):
    rng = np.random.default_rng(seed)
    ds = cfg.vae.downscale
    cs = cfg.clip_vision.image_size
    return (rng.uniform(-1, 1, (h, w, 3)),
            rng.uniform(0, 1, (frames, h, w, 3)),
            rng.uniform(-1, 1, (frames, h, w, 3)),
            rng.standard_normal((cs, cs, 3)),
            rng.standard_normal((frames, h // ds, w // ds, 4)))


def _compare(name: str, got: np.ndarray, want: np.ndarray, fp32: bool,
             n: int, note: str) -> str:
    err = np.abs(got.astype(np.float64) - want)
    mx, mean = float(err.max()), float(err.mean())
    limit = f"max <= {FP32_TOL}" if fp32 else \
        f"max <= {MULTI_TOL[0]}, mean <= {MULTI_TOL[1]}"
    ok = mx <= FP32_TOL if fp32 else (mx <= MULTI_TOL[0]
                                      and mean <= MULTI_TOL[1])
    line = (f"dryrun_multichip({n}): {name} {note}: sharded vs "
            f"single-process max abs err {mx:.3g}, mean {mean:.3g} "
            f"({limit})")
    if not ok:
        raise AssertionError(line)
    return line


def dryrun_body(dev) -> List[str]:
    """The four checks of ``dryrun_multichip`` on this rank; rank 0 also
    runs the single-process references and returns the report."""
    from mimo_tpu_torch import config as C
    from mimo_tpu_torch.decomp import hmr as HM
    from mimo_tpu_torch.decomp import smpl as SM
    from mimo_tpu_torch.decomp import vitpose as VP
    from mimo_tpu_torch.decomp.motion import MotionEstimator
    from mimo_tpu_torch.entry.runner import init_random_params
    from mimo_tpu_torch.parallel.mesh import get_mesh, get_mesh_2d
    from mimo_tpu_torch.pipelines import pose2vid as P
    n, rank = dist.get_world_size(), dist.get_rank()
    fp32 = dev.type == "cpu"
    dtype = torch.float32 if fp32 else torch.bfloat16
    cfg = C.tiny_mimo_config()
    params = init_random_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dtype)
    mesh = get_mesh(device=dev)
    H = W = 32
    report = []

    def run(st, inputs):
        args = [torch.from_numpy(np.asarray(a, np.float32)).to(dev, dtype)
                for a in inputs]
        return P.generate_host_loop(params, st, *args).float().cpu().numpy()

    def check(name, st, inputs, note):
        got = run(st, inputs)
        if got.shape != (st.num_frames, H, W, 3) or \
                not np.isfinite(got).all():
            raise AssertionError(f"{name}: output {got.shape}")
        if rank == 0:
            plain = dataclasses.replace(st, mesh=None, mesh_axis=None,
                                        frame_axis=None)
            report.append(_compare(name, got, run(plain, inputs), fp32, n,
                                   note))

    def static(cfg_, frames, **kw):
        return P.Pose2VideoStatic(cfg=cfg_, num_frames=frames, height=H,
                                  width=W, num_inference_steps=2,
                                  guidance_scale=3.5, **kw)

    # window DP: 10 frames, windows padded to a multiple of n
    st = static(cfg, 10, pad_windows_to=n, mesh_axis="data", mesh=mesh)
    check("window DP", st, _tiny_inputs(cfg, 10, H, W, 1),
          f"({P.make_windows(st)[0].shape[0]} windows)")

    # frame-sharded flagship shape: 24 frames (or the next multiple of n),
    # one window
    f2 = 24 if 24 % n == 0 else -(-24 // n) * n
    if f2 > 32:   # the temporal PE's horizon
        raise ValueError(f"frame-sharded dryrun needs <= 32 frames; n={n} "
                         f"forces {f2}")
    cfg24 = dataclasses.replace(cfg, pipeline=dataclasses.replace(
        cfg.pipeline, context_frames=f2))
    st = static(cfg24, f2, frame_axis="data", mesh=mesh)
    if P.make_windows(st)[0].shape[0] != 1:
        raise AssertionError("the frame-sharded dryrun needs one window")
    check("frame-sharded", st, _tiny_inputs(cfg24, f2, H, W, 7),
          f"({f2} frames, one window)")

    # 2-D (windows x frames): 12 frames, context 8, overlap 4
    if n % 2 == 0 and n >= 4:
        nd, nf = 2, n // 2
        mesh2 = get_mesh_2d((nd, nf), device=dev)
        cfg2d = dataclasses.replace(cfg, pipeline=dataclasses.replace(
            cfg.pipeline, context_frames=8, context_overlap=4))
        st = static(cfg2d, 12, pad_windows_to=nd, mesh_axis="data",
                    frame_axis="frame", mesh=mesh2)
        check("2-D", st, _tiny_inputs(cfg2d, 12, H, W, 9),
              f"({nd}x{nf}, {P.make_windows(st)[0].shape[0]} windows)")

    # the decomposition's motion stage, frame-parallel, on n + 1 frames
    gen = torch.Generator(device=dev).manual_seed(11)
    vcfg, hcfg = VP.tiny_vitpose_config(), HM.tiny_hmr_config()
    kw = dict(vitpose_params=VP.vitpose_init(gen, vcfg, dtype),
              vitpose_cfg=vcfg, hmr_params=HM.hmr_init(gen, hcfg, dtype),
              hmr_cfg=hcfg, smpl_model=SM.random_test_model(gen), focal=50.0)
    rng = np.random.default_rng(0)
    T, h, w = n + 1, 32, 24
    frames = [rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
              for _ in range(T)]
    masks = np.zeros((T, h, w), bool)
    masks[:, 4:28, 4:20] = True
    boxes = np.asarray([[4, 4, 20, 28]] * T, np.int64)
    sdc = MotionEstimator(mesh=mesh, **kw).estimate_motion(frames, masks,
                                                           boxes)
    if rank == 0:
        sdc1 = MotionEstimator(**kw).estimate_motion(frames, masks, boxes)
        if sdc.shape != sdc1.shape or sdc.shape != (T, h, w, 3):
            raise AssertionError(f"sdc {sdc.shape} vs {sdc1.shape}")
        derr = int(np.abs(sdc.astype(int) - sdc1.astype(int)).max())
        if derr > 1:
            raise AssertionError(f"decomp frame-parallel mismatch: {derr}")
        report.append(f"dryrun_multichip({n}): decomp motion stage "
                      f"frame-parallel ({T} frames over {n} ranks): max "
                      f"uint8 delta {derr} (<= 1)")
    return report


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     device=None) -> List[str]:
    """The four checks on ``n_devices`` ranks (``parallel.init``'s
    ``backend`` and ``device``; on one card name ``backend="gloo"`` and
    ``device="cuda:0"``); prints and returns rank 0's report."""
    report = spawn(dryrun_body, n_devices, backend=backend,
                   device=device)[0]
    for line in report:
        print(line, flush=True)
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-process dry run of the "
                                             "port")
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda (rank r on cuda:r) or cuda:N (every "
                         "rank on card N; gloo only)")
    ap.add_argument("--probe", action="store_true",
                    help="report which collectives the backend runs on the "
                         "device's tensors")
    args = ap.parse_args(argv)
    if args.probe:
        for rank, res in enumerate(spawn(probe_body, args.world,
                                         backend=args.backend,
                                         device=args.device)):
            print(f"rank {rank}: {res}", flush=True)
        return
    dryrun_multichip(args.world, backend=args.backend, device=args.device)


if __name__ == "__main__":
    main()
