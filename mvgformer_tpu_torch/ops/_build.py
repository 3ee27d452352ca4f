"""Build and load the port's CUDA sources: one nvcc call and one ctypes load
per `csrc/*.cu` file.

Each source is compiled for sm_90a into a shared library with a plain C
interface, at first use, into `build/kernels/` at the root of the checkout.
The library's name carries a hash of the source, the shared headers of
`csrc/` and the flags, so an edit rebuilds and an unchanged source loads the
library already built. The compiler's report (ptxas registers, shared memory
and spills) is kept beside the library as `<name>.log`.

Every wrapper launches through a `Launcher`: its host path per call is the
ctypes call, a current-device check and the raw stream handle, with no
`torch.cuda.device` context unless the tensor's device is not current.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# flags of one source on top of NVCC_FLAGS, by the source's stem: the DLT
# rounds each product and sum where the plain torch chain does, so nvcc may
# not contract them into fused multiply-adds
SOURCE_FLAGS = {"dlt_jacobi": ("-fmad=false",)}


def flags(src: Path) -> Tuple[str, ...]:
    """nvcc's flags for `src`."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(src.stem, ()))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from source with the CUDA toolkit")
    return found


def library_path(src: Path) -> Path:
    """Where the shared library for this source, the headers and the flags
    lives."""
    key = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(flags(src)).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def build(src: Path) -> Path:
    """Compile `src` unless its library exists; return the library."""
    lib = library_path(src)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags(src), "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
# the template arguments of a kernel of csrc/, mangled: I<T><ints>E
_ARGS = re.compile(r"I(f|13__nv_bfloat16)((?:Li-?\d+E)*)E")


def instance_label(mangled: str) -> str:
    """'deform_sample_fwd_kernel<bf16, 8, 3, 4>' for a mangled kernel
    template of csrc/ (a length-prefixed name ending in _kernel, then its
    dtype and int arguments); else the name as given."""
    for i in range(len(mangled)):
        m = re.match(r"[1-9]\d*", mangled[i:])
        if m is None:
            continue
        start = i + m.end()
        name = mangled[start:start + int(m.group())]
        args = _ARGS.match(mangled, start + len(name))
        if name.endswith("_kernel") and args:
            ints = re.findall(r"Li(-?\d+)E", args.group(2))
            dtype = "float" if args.group(1) == "f" else "bf16"
            return f"{name}<{', '.join([dtype, *ints])}>"
    return mangled


def ptxas_report(text: str) -> List[dict]:
    """Per entry function in ptxas's -v report: its label
    (`instance_label`), registers per thread, stack frame and spill bytes."""
    out, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": instance_label(m.group(1)), "registers": None,
                   "stack_bytes": 0, "spill_store_bytes": 0,
                   "spill_load_bytes": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = _FRAME.search(line)
        if m:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def kernel_report(src: Path) -> List[dict]:
    """ptxas's report on the library of `src`, from the log kept beside it
    when it was built."""
    return ptxas_report(library_path(src).with_suffix(".log").read_text())


def _timed_build(src: Path) -> Tuple[Path, float]:
    t0 = time.perf_counter()
    lib = build(src)
    return lib, time.perf_counter() - t0


def build_all(sources: Sequence[Path]) -> List[Tuple[Path, float]]:
    """Build every source at once, one nvcc process each; return each
    library with the seconds its build took."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return list(pool.map(_timed_build, sources))


@functools.lru_cache(maxsize=None)
def load(src: Path) -> ctypes.CDLL:
    """The library of `src`, built if needed, loaded once per process."""
    return ctypes.CDLL(str(build(src)))


def vector_width(D: int, esize: int, *tensors: torch.Tensor) -> int:
    """The elements a thread of the sampling kernels (B1, B4, B5) moves per
    load: 16 // esize where a row of D elements is whole 16-byte vectors and
    every tensor's data is 16-byte aligned, else 1 (the kernel's generic
    instance, element loads)."""
    if (D * esize) % 16 == 0 and all(t.data_ptr() % 16 == 0
                                     for t in tensors):
        return 16 // esize
    return 1


def raw_stream(index: int) -> int:
    """The raw handle of the current stream of CUDA device `index`, read
    without making a `torch.cuda.Stream`."""
    return torch._C._cuda_getCurrentRawStream(index)


class Launcher:
    """One C launcher of a `csrc/` source: `launcher(t, *args)` calls
    `name(*args, stream)` on the current stream of t's device and raises if
    it returns a non-zero cudaError_t (or -1, arguments the C side refuses).

    The library is built, loaded and the function's argtypes bound at the
    first call, once; the current device is switched only when t's is not
    current. The last argtype is the stream's."""

    def __init__(self, src: Path, name: str, argtypes: Sequence):
        self.src, self.name, self.argtypes = src, name, list(argtypes)
        self._fn = None

    def _bind(self):
        fn = getattr(load(self.src), self.name)
        fn.restype = ctypes.c_int
        fn.argtypes = self.argtypes
        self._fn = fn
        return fn

    def __call__(self, t, *args) -> None:
        fn = self._fn or self._bind()
        index = t.get_device()
        if index == torch._C._cuda_getDevice():
            err = fn(*args, raw_stream(index))
        else:
            with torch.cuda.device(index):
                err = fn(*args, raw_stream(index))
        if err != 0:
            raise RuntimeError(f"{self.name} failed: error {err}")
