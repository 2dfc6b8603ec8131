"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds a plain C interface and is compiled by hand
with nvcc for Hopper (``sm_90a``) into ``build/kernels/<name>-<hash>.so`` at
the root of the checkout (``~/.cache/deepsense6g_tii_tpu_torch/kernels`` for
an installed package), keyed by a hash of the source and the flags, then
loaded with ``ctypes``.  The hash covers every ``csrc/*.cuh`` header that
the source includes (``#include "name.cuh"``, followed through headers), so
an edited header builds anew; nvcc gets ``-I csrc``.  Nothing here runs at
import: a wrapper calls
:func:`load` when a CUDA tensor first reaches it.  No PyTorch header is
compiled, so a build takes seconds.

:func:`launch` calls a kernel's C entry point on the current stream and
raises on the CUDA error it returns.  ``KERNEL_LAUNCHES`` counts launches
per kernel name: :func:`launch` adds one where it launches a kernel and
nowhere else (one for each kernel an entry point launches), so a caller
can reset the counts, run the model and see which kernels the run went
through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"


def build_dir(sub: str) -> Path:
    """``build/<sub>`` at the root of the checkout when the package runs
    from one; for an installed package, a per-user cache under HOME."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / sub
    return Path.home() / ".cache" / "deepsense6g_tii_tpu_torch" / sub


BUILD_DIR = build_dir("kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

CUDA_NVCC = "/usr/local/cuda/bin/nvcc"

KERNEL_LAUNCHES: Dict[str, int] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, Callable] = {}


def count_launch(name: str) -> None:
    KERNEL_LAUNCHES[name] = KERNEL_LAUNCHES.get(name, 0) + 1


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES.clear()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or CUDA_NVCC
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the port's CUDA kernels are built at first use")
    return nvcc


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """``csrc/<name>.cu`` and, in order of first inclusion, every header
    of ``csrc/`` that it includes directly or through other headers."""
    paths, todo = [], [CSRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in paths:
            continue
        paths.append(path)
        todo += [CSRC_DIR / inc.decode()
                 for inc in _INCLUDE.findall(path.read_bytes())
                 if (CSRC_DIR / inc.decode()).is_file()]
    return paths


_CONSTEXPR = re.compile(rb"^\s*constexpr\s+int\s+(\w+)\s*=\s*(\d+)\s*;",
                        re.M)


def header_constants(header: str) -> Dict[str, int]:
    """The integer literals ``constexpr int NAME = value;`` of
    ``csrc/<header>``: the layout constants that a wrapper sizes its
    buffers by, read from the one place the kernels state them."""
    return {k.decode(): int(v) for k, v in
            _CONSTEXPR.findall((CSRC_DIR / header).read_bytes())}


def header_table(header: str, name: str) -> Tuple[Tuple[int, ...], ...]:
    """The rows of the integer table ``constexpr int NAME[][k] = {{...},
    ...};`` of ``csrc/<header>``."""
    body = re.search(rb"constexpr\s+int\s+" + re.escape(name.encode())
                     + rb"\s*\[\s*\]\s*\[\s*\d+\s*\]\s*=\s*\{(.*?)\};",
                     (CSRC_DIR / header).read_bytes(), re.S)
    if body is None:
        raise KeyError(f"{name}: no integer table in csrc/{header}")
    return tuple(tuple(int(v) for v in row.split(b","))
                 for row in re.findall(rb"\{([\d\s,]+)\}", body.group(1)))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every kernel in ``names`` that is not built yet, one nvcc
    process per source, all started together.  Returns nvcc's output per
    name built (ptxas's registers, shared memory and spills for each kernel
    instance).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s shared library."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def launch(library: str, fname: str, argtypes: Sequence, count_as,
           device, *args) -> None:
    """Calls ``fname`` of ``csrc/<library>.cu`` (built and loaded at first
    use; ``argtypes`` are its ctypes argument types, the stream last) with
    ``args`` and ``device``'s current stream, raises if it returns a CUDA
    error, and counts one launch of ``count_as`` (a kernel name, or a tuple
    of the names of the kernels that ``fname`` launches)."""
    import torch
    fn = _FNS.get(fname)
    if fn is None:
        fn = getattr(load(library), fname)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _FNS[fname] = fn
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{fname} launch failed with CUDA error {err}")
    for name in (count_as,) if isinstance(count_as, str) else count_as:
        count_launch(name)
