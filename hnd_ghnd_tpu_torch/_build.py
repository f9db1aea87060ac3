"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The kernels have a plain C interface (pointers, sizes and the stream), so
they build in seconds, without PyTorch's headers: one ``nvcc -c`` per
source, all started together, then one ``nvcc -shared`` link.  The library
goes to ``build/torch_kernels/`` at the repo root, named by a hash of the
sources and flags: a changed source builds a new library, an unchanged one
is loaded as it is.

Nothing here runs at import time; the first kernel launch calls ``load()``.
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
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
# no --use_fast_math: the quantizer must divide and round like IEEE f32
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C function name -> argtypes; every function returns a cudaError_t as int
_SIGNATURES = {
    "hnd_quantize_work_floats": [],
    "hnd_quantize_u8": [_P, _P, _P, _I64, _I, _P],
    "hnd_dequantize_u8": [_P, _P, _P, _P, _I64, _P],
    "hnd_launch_floor": [_I64, _I, _P],
    "hnd_roi_align_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                          _I, _I, _I, _P],
    "hnd_roi_align_bwd": [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _I,
                          _I, _I, _P],
    "hnd_f32_to_bf16": [_P, _P, _I64, _P],
    "hnd_quantize_levels": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "hnd_quantize_levels_absmax": [_P, _P, _P, _I, _I, _I, _P, _P],
    "hnd_quantize_levels_codes": [_P, _P, _P, _I, _I, _I, _P, _P, _P],
    "hnd_stem_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "hnd_stem_dw_partials_size": [_I, _I, _I],
    "hnd_stem_dw": [_P, _P, _P, _P, _I, _I, _I, _P],
    "hnd_int8_conv_fused": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                            ctypes.c_float, _P, _P, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build did: {"seconds", "cached", "path", "log"}
build_info: dict = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, then /usr/local/cuda/bin, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the CUDA "
            "kernels of hnd_ghnd_tpu_torch cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        path = BUILD_DIR / f"libhnd_torch_kernels_{_digest(sources)}.so"
        t0 = time.perf_counter()
        log = ""
        cached = path.is_file()
        if not cached:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build to private names, then rename: concurrent builders
            # never load a half-written library
            nvcc = find_nvcc()
            tag = f"{path.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
            procs = [subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, o in zip(sources, objs)]
            outs = [p.communicate()[0] for p in procs]
            log = "".join(outs)
            for s, p, out in zip(sources, procs, outs):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {s.name} ({p.returncode}):\n{out}")
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                                   *[str(o) for o in objs]],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{log}")
            for o in objs:
                o.unlink()
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        build_info.update(seconds=time.perf_counter() - t0, cached=cached,
                          path=str(path), log=log)
        _lib = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
