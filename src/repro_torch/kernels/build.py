"""Build the port's CUDA kernels from `repro_torch/csrc` and bind them.

Each kernel is one `csrc/<name>.cu` with a plain C entry point.  It is
compiled by `nvcc` for Hopper (`sm_90a`) into its own shared library and
loaded with `ctypes`; nothing includes PyTorch's headers, so a build takes
seconds.  Libraries go to `build/repro_torch/` at the root of the checkout, named by a digest of the kernel's source,
the shared headers and the flags: an edited source builds anew at first
use, an unchanged one is loaded as it is.  Only sources in the checkout are
built; nothing is fetched.

`build(names)` starts one `nvcc` per missing library, all at once, and
waits for them together; `load(name)` builds on first use and returns the
bound library.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"

#: every kernel library of the port, by source stem
KERNELS: Tuple[str, ...] = ("split_matmul", "hadamard_matmul",
                           "decode_attention", "ssd_chunk",
                           "prefill_attention", "mamba_mixer")

NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")

#: shared memory one Hopper block may use, in bytes (the opt-in maximum)
SMEM_LIMIT = 232448

#: where the CUDA toolkit puts nvcc when it is not on PATH
DEFAULT_NVCC = Path("/usr/local/cuda/bin/nvcc")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> Path:
    # src/repro_torch/kernels/build.py -> the checkout's root
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def find_nvcc() -> str:
    """`nvcc` on PATH, else the CUDA toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    if DEFAULT_NVCC.exists():
        return str(DEFAULT_NVCC)
    raise RuntimeError("nvcc not found on PATH or under /usr/local/cuda/bin: "
                       "the port's CUDA kernels cannot be built")


def source_digest(name: str) -> str:
    """Digest of what a kernel library is built from."""
    src = CSRC / f"{name}.cu"
    if not src.exists():
        raise KeyError(f"no kernel source {src}")
    h = hashlib.blake2b(digest_size=8)
    h.update(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def library_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{source_digest(name)}.so"


def build(names: Iterable[str] = KERNELS, *, ptxas_verbose: bool = False
          ) -> Dict[str, str]:
    """Compile every named library that is missing, one `nvcc` per source,
    all started together.  Returns each compiled library's compiler output
    (with `ptxas_verbose`, the registers and shared memory of each kernel);
    libraries that were already built map to "".  Raises on a failed
    build."""
    names = list(names)
    logs = {name: "" for name in names}
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return logs
    nvcc = find_nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *extra, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The bound library of one kernel, built first if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib


def entry_point(name: str, symbol: str, n_ptr: int, n_int: int):
    """A kernel library's C launcher `int symbol(int device, int dtype,
    n_ptr pointers, n_int ints, void* stream)`, typed for ctypes (pointers
    and the stream as `c_void_p`, so ctypes never cuts them to 32 bits)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = ([ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def resident_blocks(name: str, symbol: str, device_index: int,
                    *args: int) -> int:
    """A kernel library's occupancy query `int symbol(int device, int...
    args)`: the blocks of one instantiation that an SM holds at once, as the
    CUDA runtime's occupancy calculator gives it, read once per arguments.
    Raises where the query fails (it returns minus a CUDA error code)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [ctypes.c_int] * (1 + len(args))
    fn.restype = ctypes.c_int
    got = fn(device_index, *args)
    if got <= 0:
        raise RuntimeError(f"{symbol}{(device_index, *args)}: occupancy "
                           f"query failed ({got})")
    return got


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The streaming multiprocessors of one CUDA device, read once: the
    kernels' launch plans size their grids by it."""
    import torch

    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def require_contiguous(kernel: str, **operands) -> None:
    """Raise ValueError naming the first operand that is not contiguous:
    the kernels index their operands as dense row-major arrays."""
    for name, t in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operand {name} "
                             f"{tuple(t.shape)} with strides {t.stride()} "
                             f"is not contiguous")


def dtype_code(kernel: str, *tensors) -> int:
    """Check a kernel's operands and return the dtype code its C launcher
    takes (0 = float32, 1 = bfloat16): every operand a contiguous tensor of
    one supported dtype on one CUDA device.  Raises otherwise."""
    import torch

    codes = {torch.float32: 0, torch.bfloat16: 1}
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{kernel}: operands must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if t.dtype != first.dtype or t.dtype not in codes:
            raise TypeError(f"{kernel}: operands must all be float32 or all "
                            f"bfloat16, got {[u.dtype for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
    return codes[first.dtype]
