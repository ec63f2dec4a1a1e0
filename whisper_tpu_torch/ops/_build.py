"""Build and load the port's CUDA kernels.

On first use, nvcc compiles every `whisper_tpu_torch/csrc/*.cu` into one
shared library with a plain C interface, under `build/whisper_tpu_torch/`
at the repository root, and ctypes loads it.  The library name carries a
hash of the sources, so an edited kernel is rebuilt.  A missing nvcc or a
failed build raises; nothing falls back to another path.

Each C entry point takes device pointers and the CUDA stream as
`ctypes.c_void_p` (from `Tensor.data_ptr()` and
`torch.cuda.current_stream().cuda_stream`), launches on that stream, and
returns `cudaGetLastError()` as an int.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "whisper_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signature of every kernel entry point: name -> argtypes
SIGNATURES = {
    # q, k, v, out, B, T, H, Dh, stream
    "wtt_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, stream
    "wtt_cross_attention_q8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin): cannot build the "
                           "whisper_tpu_torch CUDA kernels")
    return nvcc


class KernelLibrary:
    """The loaded shared library plus how it was built."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float,
                 compiler_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds   # 0.0 when already built
        self.compiler_log = compiler_log

    def call(self, name: str, *args) -> None:
        """Run one C entry point; raise on a nonzero cudaGetLastError()."""
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc} at launch")


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library."""
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"libwtt_kernels_{digest.hexdigest()[:16]}.so"
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.is_file() else ""
    return KernelLibrary(lib, path, seconds, log)
