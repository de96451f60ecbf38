"""Build and bind the CUDA kernels under ``mimo_tpu_torch/csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links the objects into one
shared library with a plain C interface, which ``ctypes`` loads. The library
is named by a hash of the sources and flags and lives in
``mimo_tpu_torch/_build/`` (ignored by git), so a changed source rebuilds and
an unchanged one loads in milliseconds. Every pointer and the stream cross
the boundary as ``c_void_p``; each C entry point returns the
``cudaGetLastError()`` code of its launches, and :func:`check` raises on any
code but 0.

There is no fallback: without ``nvcc`` or when the build fails, this raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every exported entry point: (argtypes, restype)
_SIGNATURES = {
    "mimo_cuda_error_string": ([_I], ctypes.c_char_p),
    "mimo_flash_attention_fwd": (
        [_P] * 6 + [_I] * 6 + [_L] * 12 + [_F, _P], _I),
    "mimo_flash_wide_fwd": ([_P] * 4 + [_I] * 5 + [_L] * 8 + [_F, _P], _I),
    "mimo_group_norm_fwd": ([_P] * 9 + [_I] * 5 + [_F] + [_I] * 7 + [_P],
                            _I),
    "mimo_group_norm_resident_fwd": (
        [_P] * 5 + [_I] * 5 + [_F] + [_I] * 5 + [_P], _I),
    "mimo_ln_rows_fwd": (
        [_P, _L, _I, _I, _P, _P, _F, _P, _I, _I, _P] + [_I] * 4 + [_P], _I),
    "mimo_gemm_fwd": (
        [_P, _L, _P, _P, _P, _L, _P, _L] + [_I] * 4 + [_P], _I),
    "mimo_temporal_attention_fwd": ([_P, _P] + [_I] * 9 + [_F, _P], _I),
    "mimo_flash_ablate_fwd": (
        [_I, _I] + [_P] * 4 + [_I] * 5 + [_L] * 8 + [_F, _P], _I),
    "mimo_hiera_bias_gelu": ([_P] * 3 + [_L, _I, _P], _I),
    "mimo_hiera_bias_res": ([_P] * 4 + [_L] + [_I] * 6 + [_P], _I),
}

_STATE: Dict[str, object] = {}


def find_nvcc() -> str:
    """Path of nvcc: $PATH first, then the toolkit's default location."""
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "mimo_tpu_torch CUDA kernels need nvcc (CUDA toolkit) to build; none "
        "was found on PATH or at /usr/local/cuda/bin/nvcc")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmimo_kernels_{h.hexdigest()[:16]}.so"


def _compile_and_link(nvcc: str, so: Path) -> str:
    """One nvcc per source, all at once, then one link into ``so``.
    Returns the compilers' output; raises with it if any step fails."""
    objs = Path(tempfile.mkdtemp(prefix=f"{so.stem}.", dir=BUILD_DIR))
    try:
        procs = []
        for src in (s for s in _sources() if s.suffix == ".cu"):
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs / f"{src.stem}.o"),
                   str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = ""
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-shared", "-o", str(tmp),
               *[str(o) for o in sorted(objs.glob("*.o"))]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout + res.stderr}")
        os.replace(tmp, so)
        return log
    finally:
        shutil.rmtree(objs, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    lib = _STATE.get("lib")
    if lib is not None:
        return lib
    so = library_path()
    if not so.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        log = _compile_and_link(nvcc, so)
        so.with_suffix(".log").write_text(log)
        _STATE["build_seconds"] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _STATE["lib"] = lib
    return lib


def build_alone(src: str, entry: str, signature=None):
    """``src`` built alone with nvcc into a temporary directory (it may
    include ``csrc/``'s headers), for timing an earlier design beside the
    package's kernel. Returns (``entry`` bound with ``signature`` =
    (argtypes, restype), by default its ``_SIGNATURES`` line; nvcc's
    output)."""
    so = Path(tempfile.mkdtemp(prefix="alone.")) / "libalone.so"
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-I",
                          str(CSRC), "-o", str(so), src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes, fn.restype = signature or _SIGNATURES[entry]
    return fn, res.stdout + res.stderr


def ptxas_report(log: str):
    """From nvcc's ``-Xptxas -v`` output: ([(mangled kernel name, "N
    registers", its spill line), ...], [each warning and each "Performance
    Loss" note, e.g. C7520: wgmma products serialized])."""
    kernels, notes, name, spills = [], [], None, ""
    for line in log.splitlines():
        if "warning" in line or "Performance Loss" in line:
            notes.append(line.strip())
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            spills = line.strip()
        elif "Used" in line and "registers" in line and name:
            kernels.append(
                (name, line.split("Used")[1].split(",")[0].strip(), spills))
            name = None
    return kernels, notes


def build_seconds() -> Optional[float]:
    """Wall time of the nvcc build in this process (None if it loaded a
    library built earlier)."""
    return _STATE.get("build_seconds")


def build_log() -> str:
    """nvcc's output for the current library (ptxas register/smem use)."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the CUDA device ``dev`` (the launch
    plans size their grids by it)."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = load_library().mimo_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
