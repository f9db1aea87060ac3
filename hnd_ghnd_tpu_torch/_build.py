"""Build the CUDA kernels of ``csrc/`` with nvcc and load them with ctypes.

The kernels have a plain C interface (pointers, sizes and the stream), so
they build in seconds, without PyTorch's headers: one ``nvcc -c`` per
source, all started together, then one ``nvcc -shared`` link.  The library
goes to ``build/torch_kernels/`` at the repo root, named by a hash of the
sources and flags: a changed source builds a new library, an unchanged one
is loaded as it is.

Nothing here runs at import time; the first kernel launch calls ``load()``.

``load_host(name)`` builds the JAX package's native host libraries with
g++ as tools/build_native.sh does: ``cocomask`` from
native/cocomask/cocomask.cpp, unchanged (RLE codec, IoUs, polygons,
COCOeval's matching), and ``prep`` from ``csrc/prep.cpp``, the port's copy
of native/pipeline/prep.cpp (the fused resize/flip/pad, and the libjpeg
decode where libjpeg is installed: it is built with ``-ljpeg`` first, then
without its decode half).  They go to the same directory, named by a hash
of source and flags, at first use; the port never loads the tracked
``build/lib*.so`` of the JAX package.  A host library is optional: where
it does not build (no g++) ``load_host`` returns None and says why in
``host_info``, and its callers take their pure paths, as the JAX package
does without its libraries.
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
    "hnd_stem_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hnd_stem_dw_partials_size": [_I, _I, _I],
    "hnd_stem_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hnd_int8_conv_fused": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P,
                            ctypes.c_float, _P, _P, _P],
    "hnd_nms_work_bytes": [_I, _I, _P, _P],
    "hnd_nms_keep": [_P, _I, _P, _I, _P, _P, _I, _I, _P, ctypes.c_float, _P,
                     _P, _P],
}

NATIVE = Path(__file__).resolve().parent.parent / "native"
# name -> (source, the flag sets to try in order)
HOST_SOURCES = {"cocomask": (NATIVE / "cocomask" / "cocomask.cpp", [[]]),
                "prep": (CSRC / "prep.cpp", [["-ljpeg"], ["-DHND_NO_JPEG"]])}
# tools/build_native.sh's flags; -std=c++17 (ISO) keeps g++ from
# contracting a * b + c into an FMA, so the bytes follow the source
GXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_host: dict = {}
# name -> {"path", "seconds", "cached"} or {"error"}: what load_host did
host_info: dict = {}
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


def _host_variants(name: str):
    """(g++ flags, the library's path) of each way to build ``name``, in
    the order they are tried."""
    src, variants = HOST_SOURCES[name]
    for flags in variants:
        h = hashlib.sha256(" ".join(GXX_FLAGS + flags).encode())
        h.update(src.read_bytes())
        yield flags, BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _build_host(name: str, flags, path: Path) -> None:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a private name, then a rename: concurrent builders (test workers)
    # never load a half-written library
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    src = HOST_SOURCES[name][0]
    proc = subprocess.run([gxx, *GXX_FLAGS, str(src), "-o", str(tmp),
                           *flags], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ {' '.join(flags)} failed on {src.name} "
                           f"({proc.returncode}): "
                           f"{(proc.stdout + proc.stderr).strip()[-1000:]}")
    os.replace(tmp, path)


def load_host(name: str) -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the host library ``name`` ("cocomask" or
    "prep"); None where it cannot be built, the reason in
    ``host_info[name]["error"]``.  Tried once per process."""
    with _lock:
        if name not in _host:
            t0 = time.perf_counter()
            _host[name], errors = None, []
            # a library built before is loaded as it is; one that does not
            # load here (a library it links is missing) or does not build
            # gives way to the next variant
            for flags, path in _host_variants(name):
                cached = path.is_file()
                try:
                    if not cached:
                        _build_host(name, flags, path)
                    _host[name] = ctypes.CDLL(str(path))
                except (OSError, RuntimeError) as e:
                    errors.append(str(e))
                    continue
                host_info[name] = {"path": str(path), "cached": cached,
                                   "seconds": time.perf_counter() - t0}
                break
            else:
                host_info[name] = {"error": "; ".join(errors)}
        return _host[name]
