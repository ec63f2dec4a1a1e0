"""Build and load the port's CUDA kernels.

On first use, nvcc compiles every `whisper_tpu_torch/csrc/*.cu` to an
object file, one nvcc process per source, all started together, then links
them into one shared library with a plain C interface under
`build/whisper_tpu_torch/` at the repository root, and ctypes loads it.
The library name carries a hash of the sources, so an edited kernel is
rebuilt.  A missing nvcc or a
failed build raises; nothing falls back to another path.

Each C entry point takes device pointers and the CUDA stream as
`ctypes.c_void_p` (from `Tensor.data_ptr()` and
`torch.cuda.current_stream().cuda_stream`, or the same handle from
`torch._C._cuda_getCurrentRawStream`), launches on that stream, and
returns `cudaGetLastError()` as an int.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "whisper_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every kernel entry point: name -> argtypes
SIGNATURES = {
    # q, k, v, out, B, T, H, Dh, stream
    "wtt_encoder_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # q, k, v, out, B, H, Dh, Tp, t_valid, stream
    "wtt_encoder_attention_bhdt": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, B, Tp, H, Dh, t_valid, stream
    "wtt_encoder_attention_btd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # rows0, ld0, rows1, ld1, rows2, ld2, hann, cos, sin, filters_t, out,
    # n_frames, n_mel, stream
    "wtt_log_mel": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P],
    # q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster, words, stream
    "wtt_cross_attention_q8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
    # x, x_bf16, codes, scales, mins (or 0), out, M, N, K, cluster, stream
    "wtt_quantized_matmul": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, x_bf16, codes, scales, mins (or 0), out, M, N, K, cluster, stream
    "wtt_quantized_matmul_decode": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _P],
    # q, k, v, out, B, H, Dh, Ta, cluster, tile_keys, n_stages, stream
    "wtt_cross_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k_q, k_s, v_q, v_s, out, B, H, Dh, Ta, cluster, tile_keys,
    # n_stages, stream
    "wtt_cross_attention_bhtd_q8": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _I, _I, _P],
    # x, w, b, out, rows, D, eps, stream
    "wtt_ln_cast": [_P, _P, _P, _P, _I, _I, _F, _P],
    # y0, b0, y1, b1, n_pairs, rows, D, stream
    "wtt_bias_cast": [_P, _P, _P, _P, _I, _I, _I, _P],
    # x, y, bias, w, b, x_out, ln_out, rows, D, eps, stream
    "wtt_bias_residual_ln": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # y, bias, rows, D, stream
    "wtt_bias_gelu_cast": [_P, _P, _I, _I, _P],
    # x, y, bias, x_out, rows, D, stream
    "wtt_bias_residual": [_P, _P, _P, _P, _I, _I, _P],
    # k, v, v_bias, k_codes, k_scales, v_codes, v_scales, B, H, Ta, stream
    "wtt_cross_kv_quant": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # qkv, q_b, v_b, k_cache, v_cache, pad_len (or 0), out, B, H, Dh, C,
    # cache_index, kv_len, scale, stream
    "wtt_self_attn_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _F, _P],
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


# serializes a first build: the serving engine's scheduler thread and the
# caller's thread may both reach their first kernel at once
_BUILD_LOCK = threading.Lock()


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library; one
    thread builds while the others wait."""
    with _BUILD_LOCK:
        return _build_and_load()


def _build_and_load() -> KernelLibrary:
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
        nvcc = _find_nvcc()
        tag = f"{digest.hexdigest()[:16]}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        jobs = []
        for src in srcs:
            obj = BUILD_DIR / f"{src.stem}_{tag}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = ""
        failed = []
        for cmd, _, proc in jobs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        objs = [obj for _, obj, _ in jobs]
        if not failed:
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        log_path.write_text(log)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    log = log_path.read_text() if log_path.is_file() else ""
    return KernelLibrary(lib, path, seconds, log)
