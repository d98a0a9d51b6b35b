"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use, from ``detjax_torch/csrc/`` only,
into ``detjax_torch/_build/<name>-<hash>/`` where the hash covers the
sources, every header in ``csrc/`` and the flags; a changed source gets a
new directory. The sources expose a plain C interface (pointers, ints,
floats and a stream handle), so no PyTorch header is compiled and a build
takes seconds. Libraries of different names build concurrently when
loaded from different threads. Nothing here runs when a module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()  # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time (0.0 when found built), "log": nvcc output,
#          "path": the shared library}
build_info: Dict[str, dict] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then $PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and $PATH): the CUDA kernels are built from source at first use")
    return found


def load_library(name: str, sources: Sequence[str],
                 src_dir: Path = CSRC) -> ctypes.CDLL:
    """Compile ``sources`` (file names in ``src_dir``, by default
    ``csrc/``) into ``lib<name>.so`` unless that exact build exists, then
    load it once per process."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        paths = [Path(src_dir) / s for s in sources]
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in sorted(set(paths) | set(CSRC.glob("*.cuh"))):
            digest.update(p.name.encode())
            digest.update(p.read_bytes())
        out_dir = BUILD_ROOT / f"{name}-{digest.hexdigest()[:16]}"
        lib_path = out_dir / f"lib{name}.so"
        info = {"seconds": 0.0, "log": "", "path": str(lib_path)}
        if not lib_path.is_file():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".lib{name}.{os.getpid()}.so"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {name}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib_path)
            info.update(seconds=time.perf_counter() - t0,
                        log=proc.stdout + proc.stderr)
        lib = ctypes.CDLL(str(lib_path))
        _libs[name] = lib
        build_info[name] = info
        return lib
