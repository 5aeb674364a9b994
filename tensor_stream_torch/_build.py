"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain
C interface, ``build/tensor_stream_torch/lib<name>.so`` under the repo
root, at first use (or when the source, or a file of ``csrc/`` that it
includes, is newer than the library). The
build runs only where a kernel is launched: importing the package builds
nothing, so the CPU-only tests import every module without nvcc.
``build_all`` starts one nvcc per source at once and waits for them all.
"""
import ctypes
import fcntl
import os
import re
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tensor_stream_torch")
SOURCES = ("nv12_rgb", "flash_fwd", "flash_bwd", "resize_nv12",
           "clip_augment", "block_fusions")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nv12_rgb and resize_nv12 must round every multiply and add on its own
# (or fuse exactly where their _rn intrinsics say) to stay byte-equal to
# their plain versions; the flash kernels are held to a tolerance, and
# flash_fwd spells out its FMAs where it wants them; clip_augment writes
# every step as an _rn intrinsic, which never contracts; block_fusions is
# held to its plain versions within a bf16 step or a relative rule.
SOURCE_FLAGS = {"nv12_rgb": ("-fmad=false",),
                "resize_nv12": ("-fmad=false",)}

_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_LIBS = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def log_path(name: str) -> str:
    """nvcc's output for the last build of `name` (ptxas register use)."""
    return os.path.join(BUILD_DIR, f"lib{name}.log")


def sources_of(name: str) -> list:
    """csrc/<name>.cu and every file of csrc/ that it includes, directly or
    through another include (quoted includes; system headers are not
    followed)."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(SRC_DIR, rel)) as f:
            todo += [inc for inc in _INCLUDE.findall(f.read())
                     if os.path.exists(os.path.join(SRC_DIR, inc))]
    return [os.path.join(SRC_DIR, rel) for rel in seen]


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not os.path.exists(out):
        return True
    built = os.path.getmtime(out)
    return any(os.path.getmtime(src) > built for src in sources_of(name))


def build_all(names=SOURCES) -> dict:
    """Compiles every stale source, one nvcc per source, all in parallel.
    Returns {name: seconds} for what it built; raises with nvcc's output
    if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [n for n in names if _stale(n)]
        if not todo:
            return {}
        nvcc = nvcc_path()
        t0 = time.monotonic()
        procs = {}
        for name in todo:
            tmp = lib_path(name) + f".tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", tmp,
                   os.path.join(SRC_DIR, f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        took, failed = {}, []
        for name, (tmp, proc) in procs.items():
            output, _ = proc.communicate()
            took[name] = time.monotonic() - t0
            with open(log_path(name), "w") as f:
                f.write(output)
            if proc.returncode != 0:
                failed.append(f"{name}.cu:\n{output}")
            else:
                os.replace(tmp, lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return took


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(lib_path(name))
            _LIBS[name] = lib
        return lib
