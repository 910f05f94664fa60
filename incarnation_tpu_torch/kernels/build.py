"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into a shared library with a
plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). Libraries land in ``build/kernels/`` at the repo root
(gitignored), named by a hash of the source, the csrc headers it includes
and the flags, at first use or all at
once through build_all(). Nothing here runs at import time.

Each C entry point launches on the stream it is given and returns
cudaGetLastError(); Kernel.__call__ raises on a non-zero code and counts
the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"

# --fmad=false: each kernel rounds its multiply-adds as separate operations,
# like its plain PyTorch twin, so kernel and twin agree bit for bit where
# the arithmetic is the same.
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
SOURCES = ("raster", "clustered", "taa", "bvh", "resolve", "skylight",
           "setup", "bin", "cull", "shadow", "shading")

_LIBS: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> list:
    """csrc/<name>.cu and every csrc header it includes by a quoted
    #include, directly or through another header, in the order met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())]
    return found


def _target(name: str) -> pathlib.Path:
    """The library's path, named by a hash of its source, the headers it
    includes and the flags: an edited header rebuilds every library that
    includes it."""
    h = hashlib.sha1()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool):
    """Start one nvcc; returns (target, tmp path, Popen) or None if built."""
    target = _target(name)
    if target.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, job) -> str:
    target, tmp, proc = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)
    return out


def build_all(verbose: bool = False) -> dict:
    """Compile every kernel source in parallel (one nvcc per source).
    Returns {name: compiler output}; raises if any build fails."""
    jobs = {name: _start(name, verbose) for name in SOURCES}
    logs = {}
    errors = []
    for name, job in jobs.items():
        if job is None:
            logs[name] = "(cached)"
            continue
        try:
            logs[name] = _finish(name, job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start(name, verbose=False)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    argtypes: ctypes types of the arguments before the trailing stream.
    `launches` counts successful launches and `by_name` splits them by the
    caller's name for the launch (a raster layer, say); reset() zeroes
    both. `variants` maps further entry points of the same kernel (its
    compile-time roles) to their argtypes; a call picks one with
    variant=<entry name> and counts on the same counters."""

    def __init__(self, lib: str, fn: str, argtypes: list, variants=None):
        self.lib = lib
        self.fn = fn
        self.argtypes = {fn: list(argtypes) + [ctypes.c_void_p]}
        for name, types in (variants or {}).items():
            self.argtypes[name] = list(types) + [ctypes.c_void_p]
        self.launches = 0
        self.by_name: dict = {}
        self._f: dict = {}

    def reset(self):
        self.launches = 0
        self.by_name = {}

    def __call__(self, *args, stream=None, name=None, variant=None):
        import torch
        entry = variant or self.fn
        f = self._f.get(entry)
        if f is None:
            f = getattr(library(self.lib), entry)
            f.argtypes = self.argtypes[entry]
            f.restype = ctypes.c_int
            self._f[entry] = f
        if stream is None:
            stream = torch.cuda.current_stream().cuda_stream
        rc = f(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
        self.launches += 1
        if name is not None:
            self.by_name[name] = self.by_name.get(name, 0) + 1


def timed_build(verbose: bool = False):
    """(seconds, logs) of build_all()."""
    t0 = time.perf_counter()
    logs = build_all(verbose)
    return time.perf_counter() - t0, logs


def ptr(t) -> int:
    """Device pointer of a tensor (None -> NULL)."""
    return 0 if t is None else t.data_ptr()


def zero_scratch(cache: dict, dev, words: int, dtype, stream=None):
    """A kernel's scratch of at least `words` words of `dtype` on dev, one
    buffer per (device, stream) in the kernel's `cache`: counters, tickets
    and look-back words that every launch leaves zero (its last block
    zeroes them), so a call needs no memset. Created zero, replaced by a
    larger zero buffer where a launch needs more; the launches of one
    stream run in order, so they share it. stream: the launch's
    cuda_stream handle, or None for the current stream's."""
    import torch
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev.index, stream)
    buf = cache.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=dtype, device=dev)
        cache[key] = buf
    return buf
