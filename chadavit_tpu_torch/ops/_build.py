"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by its own ``nvcc -c``, all started together,
and one more ``nvcc`` links the objects into one shared library with a plain C
interface, loaded with :mod:`ctypes`. No PyTorch header, no CUTLASS and no
``torch.utils.cpp_extension`` take part, so a cold build takes seconds. The
library lands in ``chadavit_tpu_torch/_build/<hash>/``, keyed by a hash of the
sources, the headers and the flags (``.gitignore`` lists ``_build/``), and is
built at first use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argument types of every C entry point: pointers and the stream as c_void_p,
# so that ctypes never cuts a 64-bit pointer to a 32-bit int. The float32
# entry points; each has a bf16 twin (below).
SIGNATURES = {
    "ln_linear_fwd": [_P, _P, _P, _F, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                      _P],
    "linear_relu_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "linear_residual_ln_fwd": [_P, _P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _P],
    "prefix_attention_fwd": [_P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I,
                             _F, _P],
    "prefix_attention_bwd": [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                             _P, _I, _I, _I, _I, _I, _F, _F, _P],
    "layernorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I,
                      _I, _P],
    "linear_dgrad": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "linear_wgrad": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                     _P],
    "ln_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    "ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
}
# the bf16 instance of each kernel: the same arguments, bf16 activations
SIGNATURES.update({f"{name}_bf16": argtypes for name, argtypes in list(SIGNATURES.items())})

_lib = None


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then the default
    toolkit location; raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels of chadavit_tpu_torch need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):  # the sources and their headers
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> None:
    """Run the commands at once; raise with the output of the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the library unless a build of these exact sources exists;
    returns its path. Prints the build seconds when it compiles."""
    out_dir = BUILD_DIR / source_hash()
    lib_path = out_dir / "libchadavit_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    # build under names of this process, then rename: two processes that
    # build at once never load a half-written library
    tag = os.getpid()
    tmp = out_dir / f"libchadavit_kernels.{tag}.so"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
          for src, obj in zip(sources(), objs)])
    _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)
    print(f"[chadavit_tpu_torch] built {lib_path.name} from "
          f"{len(sources())} sources in {time.perf_counter() - t0:.2f} s",
          file=sys.stderr, flush=True)
    return lib_path


def ptxas_report(source: str) -> subprocess.Popen:
    """Start ``nvcc -Xptxas -v -c`` on ``csrc/<source>`` with the build's
    flags; its output (text, on stdout) gives each kernel's registers, shared
    memory and spills. The object file is a throwaway in the build
    directory, removed by :func:`ptxas_lines`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    obj = BUILD_DIR / f"ptxas.{Path(source).stem}.{os.getpid()}.o"  # one per source
    proc = subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                             str(CSRC / source)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.obj = obj
    return proc


def ptxas_lines(proc: subprocess.Popen) -> list[dict]:
    """Wait for a :func:`ptxas_report` and parse it: one dict per kernel
    (``name``, mangled, then ``registers``, ``smem`` bytes, ``spill_stores``,
    ``spill_loads`` bytes). Raises if nvcc failed."""
    out = proc.communicate()[0]
    proc.obj.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed ({proc.returncode}):\n{out}")
    kernels, cur = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": m.group(1)}
            kernels.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return kernels


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(status: int, name: str) -> None:
    """Raise when a C launcher reports a CUDA error (a refused launch never
    runs, and a later synchronize would not say so)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")
