"""Build and load the port's CUDA kernels.

Each source in ``nestfit_tpu_torch/csrc/`` is compiled by its own
``nvcc`` process (all started together) into a shared library with a
plain C interface for ``sm_90a``, then loaded with ``ctypes``.  The
libraries go to ``nestfit_tpu_torch/_build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing
is built at import: the first launch of a kernel builds every kernel,
and a failed build raises.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from nestfit_tpu_torch.utils import profiling

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("hf_chi2.cu", "table_lerp.cu", "tapered_invert.cu",
           "gauss_chi2.cu", "prior_transform.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS = {}
_FUNCS = {}
_COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / source).read_bytes())
    for dep in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every kernel source whose library is missing, one
    ``nvcc`` per source, all in parallel.  Returns the wall seconds; the
    compiler's resource report (``-Xptxas -v``) is kept beside each
    library as ``<name>.log``."""
    t0 = time.perf_counter()
    todo = [s for s in SOURCES if not _lib_path(s).exists()]
    if not todo:
        return time.perf_counter() - t0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(source: str) -> str:
    """The compiler output of ``source``'s last build."""
    return _lib_path(source).with_suffix(".log").read_text()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, building all kernels first if
    it is missing."""
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        _LIBS[source] = lib
    return lib


def function(source: str, name: str, argtypes):
    """The C launcher ``name`` of ``source``'s library, with its ctypes
    signature set (once: a launch then costs no signature setup)."""
    fn = _FUNCS.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCS[source, name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def count_launch(wrapper, n=1) -> None:
    """Add ``n`` (one launch, or what a launch counts) to
    ``wrapper.launches``, under a lock (the dp rows of a mesh launch from
    threads of their own), and to the recorder's counter that the wrapper
    names (:func:`count_call`).  While this thread captures a CUDA graph
    (:func:`recording`), the launch is recorded for the graph instead: it
    happens at each replay."""
    counts = getattr(_RECORDING, "counts", None)
    if counts is not None:
        counts[wrapper] = counts.get(wrapper, 0) + n
        return
    with _COUNT_LOCK:
        wrapper.launches += n
    count_call(wrapper, n)


def count_call(wrapper, n=1) -> None:
    """Add ``n`` to the recorder's counter ``wrapper.counter``, where the
    wrapper names one (a plain version on the CPU counts there too)."""
    name = getattr(wrapper, "counter", None)
    if name is not None:
        profiling.count(name, n)


def add_launches(counts) -> None:
    """Add ``{wrapper: n}`` to the wrappers' counters (a graph replay)."""
    with _COUNT_LOCK:
        for wrapper, n in counts.items():
            wrapper.launches += n
    for wrapper, n in counts.items():
        count_call(wrapper, n)


@contextlib.contextmanager
def recording():
    """Collect this thread's launches in a ``{wrapper: n}`` dict instead
    of the counters, for the length of a graph capture."""
    counts = {}
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = None
