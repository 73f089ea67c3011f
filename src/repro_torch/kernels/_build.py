"""Build and load the CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one ``nvcc``
process per source, all started together) and linked into one shared
library with a plain C interface, which is loaded with :mod:`ctypes`.  The
library lands in ``build/repro_torch/`` at the repository root under a
name keyed by a hash of the sources and flags, so it is built at first use
and rebuilt only when a source changes.  ``nvcc`` comes from ``CUDA_HOME``
or, failing that, from ``torch.utils.cpp_extension.CUDA_HOME``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
#: C entry -> argument types (every pointer and the stream are void*,
#: strides int64).
SIGNATURES = {
    "rt_gather_decode": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P),
    "rt_fused_gather_decode_bitmap": (_P, _P, _P, _P, _I, _I, _I, _P, _I, _I,
                                      _P, _P, _P, _I, _P),
    "rt_fused_gather_decode_filter_bitmap": (_P, _P, _P, _P, _I, _I, _I, _P,
                                             _I, _I, _P, _P, _P, _I, _P, _P),
    "rt_cond_bitmap": (_P, _P, _I, _I, _P, _I, _I, _P, _I, _P),
    "rt_launch_floor": (_P,),
    "rt_seed_words": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P),
    "rt_khop_hop": (_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                    _P, _P, _P),
    "rt_expand_words": (_P, _P, _I, _I, _P, _P, _I, _I, _I, _P, _I, _P, _P,
                        _P, _P),
    "rt_merge_hop": (_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                     _P),
    "rt_interval_words": (_P, _I, _P, _I, _I, _P, _P, _I, _P, _I, _P, _I,
                          _P, _P),
    "rt_count_tiles": (_P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P, _P),
    "rt_delta_decode": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "rt_fused_decode_bitmap_batch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                     _P, _I, _P, _I, _P, _P, _P, _I, _P),
    "rt_fused_decode_filter_bitmap_batch": (_P, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _P, _I, _P, _I, _P, _P,
                                            _P, _I, _P, _P, _I, _P, _I, _P),
    "rt_ids_bitmap": (_P, _I, _I, _P, _I, _P),
    "rt_fused_decode_bitmap": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _P, _I, _P),
    "rt_rle_to_bitmap": (_P, _I, _P, _P, _I, _P),
    "rt_bitmap_select": (_P, _P, _I, _I, _P, _P, _P),
    "rt_flash_attention": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           *(_L,) * 12, _I, _I, _P),
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if not home:
        from torch.utils import cpp_extension
        home = cpp_extension.CUDA_HOME
    path = os.path.join(home, "bin", "nvcc") if home else ""
    if not path or not os.path.exists(path):
        raise RuntimeError("no CUDA toolkit: nvcc not found under CUDA_HOME "
                           f"({home!r})")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in sum(_sources(), []):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the sources unless the keyed library exists.

    The compiler's register and shared-memory report (``-Xptxas=-v``) is
    kept beside the library as ``<name>.log``."""
    out = library_path()
    if out.exists():
        return out
    cc = nvcc()
    srcs, _ = _sources()
    work = BUILD_DIR / f"{out.stem}.tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        objs = [work / f"{s.stem}.o" for s in srcs]
        procs = [subprocess.Popen([cc, *FLAGS, "-c", str(s), "-o", str(o)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        log = []
        failed = []
        for s, p in zip(srcs, procs):
            text, _ = p.communicate()
            log.append(f"== {s.name} ==\n{text}")
            if p.returncode != 0:
                failed.append(s.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp = work / out.name
        link = subprocess.run([cc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"link failed:\n{link.stdout}{link.stderr}")
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


def launch(name: str, *args) -> None:
    """Call one C entry; raise if it reports a CUDA error."""
    lib = library()
    rc = getattr(lib, name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} "
                           f"({lib.rt_error_string(rc).decode()})")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(t: torch.Tensor, name: str, device: torch.device,
          ndim: int) -> None:
    """Raise unless ``t`` is a contiguous int32 tensor of ``ndim``
    dimensions on ``device`` (the kernels take int32 and reinterpret
    uint32 bit patterns themselves)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} has dtype {t.dtype}, expected int32")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (use the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")
