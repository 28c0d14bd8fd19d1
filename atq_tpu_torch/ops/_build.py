"""Build and load the port's CUDA kernels.

Every ``atq_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a``
(one ``nvcc`` process per source, all started together), linked into one
shared library with a plain C interface, and loaded with ``ctypes``. The
build happens at first use, from the package's own sources, into
``atq_tpu_torch/_build/`` (listed in .gitignore); the library's name
carries a hash of the sources, the headers they include (``csrc/*.cuh``)
and the flags, so an edited source or header rebuilds. A failed build
raises: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_info: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    """A hash of the flags, the sources and the headers they include
    (``csrc/*.cuh``), so an edited header rebuilds too."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(sources) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    ip = ctypes.POINTER(ctypes.c_int)
    lib.atq_order_stat_plan.argtypes = [i32, i64, i32, ip, ip]
    lib.atq_order_stat_plan.restype = i32
    lib.atq_order_stat.argtypes = [i32, vp, i64, i32, vp, vp, vp]
    lib.atq_order_stat.restype = i32
    lib.atq_ternary_matmul.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32,
                                       i32, i32, i32, vp]
    lib.atq_ternary_matmul.restype = i32
    lib.atq_packed_workspace_floats.argtypes = [i32, i32, i32]
    lib.atq_packed_workspace_floats.restype = i64
    lib.atq_ternary_matmul32.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32,
                                         i32, i32, i32, vp]
    lib.atq_ternary_matmul32.restype = i32
    lib.atq_ternary_matmul_rpb.argtypes = [i32, vp, vp, vp, vp, vp, vp, i32,
                                           i32, i32, i32, vp]
    lib.atq_ternary_matmul_rpb.restype = i32
    lib.atq_fused_dwda_partials.argtypes = [i32, i32]
    lib.atq_fused_dwda_partials.restype = i32
    lib.atq_fused_forward.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, i32,
                                      i32, i32, i32, i32, vp]
    lib.atq_fused_forward.restype = i32
    lib.atq_fused_dx.argtypes = [i32, vp, vp, vp, vp, vp, i32, i32, i32, vp]
    lib.atq_fused_dx.restype = i32
    lib.atq_fused_dwda.argtypes = [i32, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                   i32, i32, i32, i32, vp]
    lib.atq_fused_dwda.restype = i32
    f32 = ctypes.c_float
    lib.atq_attention_forward.argtypes = [i32, i32, vp, vp, vp, vp, vp, i32,
                                          i32, i32, i32, f32, vp]
    lib.atq_attention_forward.restype = i32
    lib.atq_attention_backward.argtypes = [i32, i32, vp, vp, vp, vp, vp, vp,
                                           vp, vp, vp, i32, i32, i32, i32,
                                           f32, vp]
    lib.atq_attention_backward.restype = i32
    return lib


def _build(target: pathlib.Path, sources) -> None:
    nvcc = _nvcc()
    tmp = BUILD_DIR / f"tmp-{os.getpid()}-{threading.get_ident()}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in sources:
        obj = tmp / (src.stem + ".o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    so_tmp = tmp / target.name
    link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(so_tmp),
                           *map(str, objs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(so_tmp, target)  # atomic: readers never see a partial file
    target.with_suffix(".log").write_text("\n".join(log))
    shutil.rmtree(tmp, ignore_errors=True)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built from source on first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        if not sources:
            raise RuntimeError(f"no CUDA sources under {CSRC}")
        target = BUILD_DIR / f"libatq_torch_kernels-{_digest(sources)}.so"
        t0 = time.perf_counter()
        built = not target.exists()
        if built:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build(target, sources)
        _lib = _declare(ctypes.CDLL(str(target)))
        build_info.update(
            library=str(target), built=built,
            seconds=time.perf_counter() - t0,
            sources=[s.name for s in sources])
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
