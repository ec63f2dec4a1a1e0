"""Host C++ libraries of the port, built from the repository's `native/`
sources with the host's C++ compiler on first use.

A library lands in the port's build directory (build/whisper_tpu_torch/,
next to the CUDA kernels) as lib<stem>_<hash>.so.  The hash covers its
sources, the headers they include and every flag, so an edited source or
flag builds a new library and a stale one is never loaded.  No
-march=native: the build directory travels with copies of the tree to
other hosts, and the name does not key on the host CPU.

One build at a time: a thread lock within the process and a file lock
across processes; the library lands through an atomic rename.  A missing
compiler or a failed step raises OSError or subprocess.SubprocessError,
which `load` turns into a warning and None: the caller's Python path runs.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from .logging import log_warn

_LOCK = threading.Lock()


def library_path(stem: str, build_dir: Path, units, link_flags,
                 headers=(), libs=()) -> Path:
    """Where the library of these (source, compile flags) units, link
    flags, headers and libraries lives once built."""
    h = hashlib.sha256()
    for src, flags in units:
        h.update(Path(src).name.encode() + b"\0" + Path(src).read_bytes())
        h.update(" ".join(flags).encode() + b"\0")
    for hdr in headers:
        h.update(Path(hdr).name.encode() + b"\0" + Path(hdr).read_bytes())
    h.update(" ".join(link_flags).encode())
    if libs:
        h.update(b"\0" + " ".join(libs).encode())
    return Path(build_dir) / f"lib{stem}_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise OSError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def build(stem: str, build_dir: Path, units, link_flags,
          headers=(), libs=()) -> Path:
    """Build (unless built) and return the library: each (source, flags)
    unit compiled with -c, all in parallel, then the objects linked with
    `link_flags`, and `libs` (-L/-l flags) after the objects."""
    path = library_path(stem, build_dir, units, link_flags, headers, libs)
    if path.is_file():
        return path
    cxx = shutil.which("c++")
    if cxx is None:
        raise OSError("no C++ compiler (c++) on PATH")
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path.parent / f".{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)      # another process may build it
        if path.is_file():
            return path
        tmp_dir = Path(tempfile.mkdtemp(prefix=f".{stem}.", dir=path.parent))
        try:
            jobs = []
            for src, flags in units:
                obj = tmp_dir / f"{Path(src).stem}.o"
                cmd = [cxx, *flags, "-c", str(src), "-o", str(obj)]
                jobs.append((cmd, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for cmd, _, proc in jobs:
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)} failed:\n{out}")
            if failed:
                raise OSError("\n".join(failed))
            tmp = tmp_dir / path.name
            _run([cxx, *link_flags, *(str(obj) for _, obj, _ in jobs),
                  *libs, "-o", str(tmp)])
            os.replace(tmp, path)
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
    return path


def load(what: str, stem: str, build_dir: Path, units, link_flags,
         headers=()):
    """ctypes.CDLL of the library, built first if need be; None, with a
    warning naming `what`, when it cannot be built or loaded."""
    with _LOCK:
        try:
            return ctypes.CDLL(str(build(stem, build_dir, units, link_flags,
                                         headers)))
        except (OSError, subprocess.SubprocessError) as e:
            log_warn(f"{what} unavailable: {e}")
            return None
