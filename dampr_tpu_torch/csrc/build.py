"""Build and bind the hand-written Hopper kernels.

Each ``csrc/*.cu`` source compiles on first use, with ``nvcc`` for
``sm_90a``, into its own shared library with a plain C interface, and
loads through :mod:`ctypes`.  Pointers cross as ``data_ptr()`` ints and
the stream as the current stream's raw handle (what
``torch.cuda.current_stream().cuda_stream`` gives, read without building a
Stream object); every entry point returns ``cudaGetLastError()`` after its
launches.  No PyTorch header is compiled, so a build takes seconds, not
minutes.

Libraries land in ``csrc/_build/`` (gitignored) under a name keyed by a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags: an
edited source or header rebuilds, an unchanged one loads the cached
library.  :func:`build_all` starts one ``nvcc`` per
source at once, so a cold start costs the slowest file, not the sum.

Importing this module builds nothing and never touches CUDA.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc():
    """The CUDA compiler: ``$NVCC``, then ``nvcc`` on PATH, then the
    toolkit PyTorch itself located (``CUDA_HOME``)."""
    explicit = os.environ.get("NVCC")
    if explicit:
        return explicit
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put the "
                       "CUDA toolkit's bin/ on PATH")


def _headers():
    """The shared ``csrc/*.cuh`` headers, which any source may include."""
    return sorted(os.path.join(_HERE, f) for f in os.listdir(_HERE)
                  if f.endswith(".cuh"))


class Kernel(object):
    """One ``csrc`` source: its build, its loaded entry point, and the
    count of its launches (the main path's proof that it ran)."""

    def __init__(self, source, symbol, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    def _paths(self):
        src = os.path.join(_HERE, self.source)
        digest = hashlib.sha256()
        for path in [src] + _headers():
            with open(path, "rb") as f:
                digest.update(f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(self.source)[0]
        lib = os.path.join(BUILD_DIR, "lib{}-{}.so".format(
            stem, digest.hexdigest()[:16]))
        return src, lib

    def start_build(self):
        """Start ``nvcc`` for this source unless its library is cached.
        Returns ``(process, tmp_path, lib_path)`` or None when cached."""
        src, lib = self._paths()
        if os.path.exists(lib):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "{}.{}.tmp".format(lib, os.getpid())
        proc = subprocess.Popen([_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        return proc, tmp, lib

    @staticmethod
    def finish_build(started):
        if started is None:
            return
        proc, tmp, lib = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}".format(
                proc.returncode, out.decode(errors="replace")))
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half

    def fn(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is None:
            with self._lock:
                if self._fn is None:
                    self.finish_build(self.start_build())
                    lib = ctypes.CDLL(self._paths()[1])
                    f = getattr(lib, self.symbol)
                    f.argtypes = self.argtypes
                    f.restype = ctypes.c_int
                    self._fn = f
        return self._fn

    def launch(self, device, *args):
        """Call the entry point with ``args`` and the current stream of
        ``device`` (a tensor's device, so its index is set; made the
        current device only when it is not already), count the launch,
        and raise on any CUDA error it reports."""
        import torch

        fn = self.fn()
        index = device.index
        stream = torch._C._cuda_getCurrentRawStream(index)
        if index != torch.cuda.current_device():
            with torch.cuda.device(index):
                err = fn(*args, stream)
        else:
            err = fn(*args, stream)
        with self._lock:
            self.launches += 1
        if err != 0:
            raise RuntimeError("{} launch failed: CUDA error {}".format(
                self.symbol, err))


def build_all(kernels):
    """Build every given kernel's library at once (one ``nvcc`` process
    per source, all started together), then load each."""
    started = [k.start_build() for k in kernels]
    for s in started:
        Kernel.finish_build(s)
    for k in kernels:
        k.fn()
