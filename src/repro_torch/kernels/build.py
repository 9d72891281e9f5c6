"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` process (all
started together) into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/repro_torch/lib<name>-<hash>.so <name>.cu

The output goes under ``build/repro_torch/`` at the root of the checkout
(``.gitignore`` lists ``build/``); ``$REPRO_TORCH_BUILD_DIR`` overrides
it, and an installed package, which has no checkout to write into, builds
under the temporary directory. The file name carries a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
reused; a finished library is moved into place atomically, so processes
that build at the same time cannot load a half-written file.

Nothing here runs at import: the CPU tests import every module of the
port, and this machine-independent code must not look for ``nvcc`` until
a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"


def build_dir() -> pathlib.Path:
    """Where built libraries go: ``$REPRO_TORCH_BUILD_DIR`` if set, else
    ``build/repro_torch`` in the checkout that holds this package
    (``src/repro_torch`` beside ``pyproject.toml``), else a directory in
    the temporary directory."""
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    pkg = pathlib.Path(__file__).resolve().parents[1]
    root = pkg.parents[1]
    if pkg.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "repro_torch"
    return pathlib.Path(tempfile.gettempdir()) / "repro_torch-build"


BUILD_DIR = build_dir()
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_vp, _i, _ll, _f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                    ctypes.c_float)

# kernel name -> (source, extra nvcc flags, C entry point, argtypes).
# The CDF kernels keep every multiply and add separately rounded
# (-fmad=false), as the plain PyTorch versions compute them.
KERNELS = {
    "decode_attention": (
        "decode_attention.cu", [], "repro_decode_attention",
        [_vp, _ll, _ll, _vp, _vp, _ll, _ll, _ll, _vp, _vp,
         _i, _i, _i, _i, _i, _i, _f, _vp]),
    "topk_cdf": (
        "topk_cdf.cu", ["-fmad=false"], "repro_topk_cdf",
        [_vp, _ll, _i, _i, _i, _i, _i, _vp, _vp, _vp]),
    "cdf_points": (
        "cdf_points.cu", ["-fmad=false"], "repro_cdf_points",
        [_vp, _ll, _i, _i, _i, _i, _vp, _vp]),
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from src/repro_torch/kernels/csrc at first use")
    return found


def _flags(name: str) -> list[str]:
    return ARCH + BASE_FLAGS + KERNELS[name][1]


def library_path(name: str) -> pathlib.Path:
    src = KERNELS[name][0]
    h = hashlib.sha256()
    for f in (src, "common.cuh"):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, tuple[float, str]]:
    """Compile every missing library, one ``nvcc`` per source, all at
    once. Returns {name: (seconds, compiler report)} for what was built
    this call; raises RuntimeError with the compiler output on failure."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *_flags(n), "-o", str(tmp), str(CSRC / KERNELS[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    built, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        built[n] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return built


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if missing)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _, _, entry, argtypes = KERNELS[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(library(name), KERNELS[name][2])
