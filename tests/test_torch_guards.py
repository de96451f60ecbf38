"""Guards of the port: it imports neither JAX nor mimo_tpu, its kernel
build raises a clear error where there is no nvcc instead of handing back
a fallback, and its kernel wrappers count their launches."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

SLICE_MODULES = [
    "mimo_tpu_torch", "mimo_tpu_torch.config",
    "mimo_tpu_torch.weights.bridge", "mimo_tpu_torch.ops._build",
    "mimo_tpu_torch.ops.flash_attention", "mimo_tpu_torch.ops.attention",
    "mimo_tpu_torch.ops.groupnorm", "mimo_tpu_torch.ops.ffn",
    "mimo_tpu_torch.ops.temporal_attention", "mimo_tpu_torch.models.layers",
    "mimo_tpu_torch.models.unet", "mimo_tpu_torch.models.vae",
    "mimo_tpu_torch.models.clip_vision", "mimo_tpu_torch.models.pose_guider",
    "mimo_tpu_torch.schedulers.ddim", "mimo_tpu_torch.pipelines.context",
    "mimo_tpu_torch.pipelines.pose2vid", "mimo_tpu_torch.utils.frames",
    "mimo_tpu_torch.utils.video_io", "mimo_tpu_torch.entry.template",
    "mimo_tpu_torch.entry.runner", "mimo_tpu_torch.entry.animate",
    "mimo_tpu_torch.pipelines.interp",
    "mimo_tpu_torch.tools.ablate_flash", "mimo_tpu_torch.tools.time_tattn_core",
    "mimo_tpu_torch.tools.time_norms", "mimo_tpu_torch.tools.timing",
    "mimo_tpu_torch.tools.time_flash_wide",
    "mimo_tpu_torch.weights.convert", "mimo_tpu_torch.tools.compare_sass",
    "mimo_tpu_torch.entry.edit", "mimo_tpu_torch.weights.checkpoint",
    "mimo_tpu_torch.utils.profiling", "mimo_tpu_torch.serving.app",
    "mimo_tpu_torch.__main__", "mimo_tpu_torch.decomp.vit",
    "mimo_tpu_torch.decomp.hiera", "mimo_tpu_torch.decomp.sam",
    "mimo_tpu_torch.decomp.sam2", "mimo_tpu_torch.decomp.vitpose",
    "mimo_tpu_torch.decomp.detector", "mimo_tpu_torch.decomp.matting",
    "mimo_tpu_torch.decomp.pipeline", "mimo_tpu_torch.decomp.factory",
    "mimo_tpu_torch.ops.connected_components",
    "mimo_tpu_torch.tools.profile_decomp",
    "mimo_tpu_torch.weights.convert_decomp", "mimo_tpu_torch.decomp.transforms",
    "mimo_tpu_torch.decomp.smpl", "mimo_tpu_torch.decomp.hmr",
    "mimo_tpu_torch.decomp.renderer", "mimo_tpu_torch.decomp.motion",
    "mimo_tpu_torch.ops.morphology", "mimo_tpu_torch.ops.sampling",
    "mimo_tpu_torch.decomp.raft", "mimo_tpu_torch.decomp.propainter",
    "mimo_tpu_torch.decomp.depth_anything", "mimo_tpu_torch.decomp.occlusion",
    "mimo_tpu_torch.parallel", "mimo_tpu_torch.parallel.mesh",
    "mimo_tpu_torch.parallel.comm", "mimo_tpu_torch.parallel.decomp",
    "mimo_tpu_torch.entry.graft", "mimo_tpu_torch.ops.rows",
]


def test_port_imports_no_jax_and_no_mimo_tpu():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') "
        "or m == 'mimo_tpu' or m.startswith('mimo_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_every_slice_module_is_listed():
    """A new port module joins the import guard above."""
    pkg = ROOT / "mimo_tpu_torch"
    found = {"mimo_tpu_torch." + ".".join(p.relative_to(pkg)
                                          .with_suffix("").parts)
             for p in pkg.rglob("*.py") if p.name != "__init__.py"}
    assert found <= set(SLICE_MODULES), found - set(SLICE_MODULES)


def test_build_without_nvcc_raises(monkeypatch):
    from mimo_tpu_torch.ops import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    monkeypatch.setattr(_build, "library_path",
                        lambda: Path("/nonexistent/libmimo_kernels.so"))
    monkeypatch.setitem(_build._STATE, "lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_library()


def test_failed_nvcc_raises(monkeypatch, tmp_path):
    """A compiler error surfaces with its output; nothing is loaded."""
    from mimo_tpu_torch.ops import _build
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: synthetic failure' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "build" / "libmimo_kernels_x.so")
    monkeypatch.setitem(_build._STATE, "lib", None)
    with pytest.raises(RuntimeError, match="synthetic failure"):
        _build.load_library()
    assert not (tmp_path / "build" / "libmimo_kernels_x.so").exists()


def test_sources_and_signatures_present():
    """Every C entry point the wrappers call is declared for ctypes, and
    defined in the CUDA sources."""
    from mimo_tpu_torch.ops import _build
    text = "".join(p.read_text() for p in _build._sources())
    for name in _build._SIGNATURES:
        assert f"{name}(" in text, name


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """NCCL refuses two ranks on one card: init raises, naming both counts,
    and does not switch to gloo (the default backend on CUDA is NCCL)."""
    import torch
    from mimo_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for backend in ("nccl", None):
        with pytest.raises(RuntimeError, match="2 ranks needs 2 cards, 1 "
                                               "visible"):
            mesh.init(backend, "cuda:0", init_method="file:///nonexistent",
                      world_size=2, rank=0)


def test_init_on_cuda_without_cuda_raises(monkeypatch):
    import torch
    from mimo_tpu_torch.parallel import mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("nccl", "gloo", None):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.init(backend, "cuda", init_method="file:///nonexistent",
                      world_size=1, rank=0)


def test_graft_entry_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    import torch
    from mimo_tpu_torch.entry import graft
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            graft.entry()
    fn, args = graft.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (4, 4, 32, 32, 4) and torch.isfinite(out).all()


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
