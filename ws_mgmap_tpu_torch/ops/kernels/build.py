"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into an
object file (one ``nvcc`` per source, all started together), and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lives under
``<repo>/build/ws_mgmap_tpu_torch/<hash>/``, keyed by a hash of the
sources and flags, so a fresh checkout builds it on first use and an
edited source rebuilds it. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "ws_mgmap_tpu_torch"
LIB_NAME = "libws_mgmap_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# the C interface of csrc/*.cu: pointers and the stream as void*, sizes int
SIGNATURES = {
    "ws_cuda_error_string": ([_INT], ctypes.c_char_p),
    "ws_splat_max_f32": ([_VP] * 3 + [_INT] * 4 + [_VP], _INT),
    "ws_splat_max_bf16": ([_VP] * 3 + [_INT] * 4 + [_VP], _INT),
    "ws_conv3x3_bn_act_f32": ([_VP] * 7 + [_INT] * 7 + [_VP], _INT),
    "ws_conv3x3_bn_act_bf16": ([_VP] * 7 + [_INT] * 7 + [_VP], _INT),
}

_LIB: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last build, if any


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    if shutil.which("nvcc"):
        cands.append(Path(shutil.which("nvcc")))
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cands.append(Path(CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _build(out_dir: Path) -> None:
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    out_dir.parent.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=out_dir.parent))
    try:
        procs = []
        for src in cu:
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = tmp / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(logs))
        try:
            tmp.rename(out_dir)
        except OSError:
            # another process built the same hash first
            if not (out_dir / LIB_NAME).is_file():
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources on first use."""
    global _LIB, build_seconds
    if _LIB is None:
        out_dir = BUILD_ROOT / _source_hash()
        if not (out_dir / LIB_NAME).is_file():
            t0 = time.perf_counter()
            _build(out_dir)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out_dir / LIB_NAME))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned after a launch."""
    if status != 0:
        lib = load_library()
        msg = lib.ws_cuda_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
