"""Guards of the port: it imports neither JAX nor mimo_tpu, and its kernel
build raises a clear error where there is no nvcc instead of handing back
a fallback."""

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
    "mimo_tpu_torch.entry.profile", "mimo_tpu_torch.pipelines.interp",
    "mimo_tpu_torch.tools.ablate_flash", "mimo_tpu_torch.tools.time_tattn_core",
    "mimo_tpu_torch.tools.time_norms", "mimo_tpu_torch.tools.timing",
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
