"""Build and load the CUDA kernels under `repro_torch/csrc/`.

Each `*.cu` file exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`); the objects are linked into one shared library
that is loaded with `ctypes`. The library lands in a build directory keyed
by a hash of the sources (the `*.cuh` headers they share included) and
flags, so a changed source rebuilds and an
unchanged one loads at once. The build happens at first use, never at
import: a machine without `nvcc` or a card imports this module fine.

Every C entry point returns `cudaGetLastError()` after its launch, and
`check` raises on a nonzero code. Each wrapper counts its launches in
`LAUNCHES` exactly where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_DIR_ENV = "REPRO_TORCH_BUILD_DIR"

# Launch counts per kernel wrapper (reset with `reset_launch_counts`).
LAUNCHES: Dict[str, int] = {"lif": 0, "lif_counts": 0, "lif_fwd": 0,
                            "lif_counts_fwd": 0, "lif_bwd": 0,
                            "spike_matmul_csr": 0, "spike_matmul_pred": 0,
                            "sdsa_or": 0, "apec_decompose": 0,
                            "apec_matmul_csr": 0, "lif_counts_packed": 0,
                            "spike_matmul_packed_csr": 0,
                            "apec_matmul_packed_csr": 0, "sdsa_causal": 0,
                            "lif_bf16": 0, "spike_matmul_csr_pipe": 0,
                            "spike_matmul_packed_csr_pipe": 0,
                            "apec_matmul_csr_pipe": 0,
                            "apec_matmul_packed_csr_pipe": 0,
                            "apec_decompose_spikes": 0, "lif_fwd_bf16": 0,
                            "lif_bwd_bf16": 0}

_LIB: Optional[ctypes.CDLL] = None
BUILD_INFO: Dict[str, object] = {}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_I = ctypes.c_int
# C entry point -> argument types (every pointer and the stream as void*).
SIGNATURES = {
    "lif_forward": (_P, _P, _I64, _I64, _F, _F, _I, _P),
    "lif_bf16_forward": (_P, _P, _I64, _I64, _F, _F, _I, _P),
    "lif_fwd_forward": (_P, _P, _P, _I64, _I64, _F, _F, _I, _P),
    "lif_fwd_bf16_forward": (_P, _P, _P, _I64, _I64, _F, _F, _I, _P),
    "lif_counts_forward": (_P, _P, _P, _I64, _I64, _I64, _F, _F, _I, _P),
    "lif_counts_fwd_forward": (_P, _P, _P, _P, _I64, _I64, _I64, _F, _F, _I,
                               _P),
    "lif_counts_packed_forward": (_P, _P, _P, _I64, _I64, _I64, _F, _F, _I,
                                  _P),
    "lif_counts_launch": (_I64, _I64, _I, _P),
    "lif_backward": (_P, _P, _P, _I64, _I64, _F, _F, _I, _F, _F, _P),
    "lif_bf16_backward": (_P, _P, _P, _I64, _I64, _F, _F, _I, _F, _F, _P),
    "sdsa_or_strided_forward": (_P, _P, _P, _P, _P, _P),
    "sdsa_causal_strided_forward": (_P, _P, _P, _P, _P, _P, _P),
    "sdsa_capture_id": (_P, _P),
    "spike_matmul_csr_forward": (_P, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                                 _I64, _P),
    "spike_matmul_packed_csr_forward": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                                        _I64, _I64, _I64, _P),
    "spike_matmul_csr_pipe_forward": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                                      _I64, _I64, _P),
    "spike_matmul_packed_csr_pipe_forward": (_P, _P, _P, _P, _P, _P, _I64,
                                             _I64, _I64, _I64, _I64, _P),
    "spike_matmul_pred_forward": (_P, _P, _P, _P, _I64, _I64, _I64, _I64,
                                  _P),
    "spike_matmul_pred_routed_forward": (_P, _P, _P, _P, _I64, _I64, _I64,
                                         _I64, _P, _P),
    "spike_matmul_csr_routed_forward": (_P, _P, _P, _P, _P, _P, _I64, _I64,
                                        _I64, _I64, _P, _P),
    "apec_matmul_csr_routed_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                       _I64, _I64, _I64, _I64, _P, _P),
    "spike_matmul_csr_pipe_launch": (_I64, _I64, _P),
    "spike_matmul_packed_csr_pipe_launch": (_I64, _I64, _P),
    "apec_decompose_forward": (_P, _P, _P, _I64, _I64, _I64, _P),
    "apec_decompose_spikes_forward": (_P, _P, _P, _I64, _I64, _I64, _I64, _I,
                                      _P),
    "apec_matmul_csr_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                                _I64, _I64, _I64, _P),
    "apec_matmul_packed_csr_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                       _I64, _I64, _I64, _I64, _I64, _P),
    "apec_matmul_csr_pipe_forward": (_P, _P, _P, _P, _P, _P, _P, _P, _I64,
                                     _I64, _I64, _I64, _I64, _P),
    "apec_matmul_packed_csr_pipe_forward": (_P, _P, _P, _P, _P, _P, _P, _P,
                                            _I64, _I64, _I64, _I64, _I64,
                                            _I64, _P),
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def build_dir() -> Path:
    """`$REPRO_TORCH_BUILD_DIR`, else `build/repro_torch` at the root of
    the checkout this package lives in."""
    env = os.environ.get(BUILD_DIR_ENV)
    if env:
        return Path(env)
    return CSRC.parents[2] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _sources_key(sources, csrc: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(csrc.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, csrc: Path = CSRC) -> Path:
    """Compile every source of `csrc` (one `nvcc` per file, all started
    together), link one shared library, and return its path. Reuses a
    library built from identical sources."""
    sources = sorted(csrc.glob("*.cu"))
    out_dir = build_dir() / _sources_key(sources, csrc)
    lib_path = out_dir / "librepro_torch_kernels.so"
    if lib_path.exists():
        BUILD_INFO.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)      # atomic: concurrent builds race safely
    BUILD_INFO.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    if verbose:
        print(log)
    return lib_path


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(code: int, what: str) -> None:
    """Raise on a nonzero `cudaGetLastError()` code from a launch."""
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError "
                           f"{code}")


def stream() -> int:
    """The current PyTorch CUDA stream as a raw handle."""
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor, dtype=None) -> None:
    """Check that every tensor lies on one CUDA device, is contiguous and
    (when given) has `dtype`; the kernels take nothing else. A kernel's
    output is invisible to autograd, so an operand that autograd records
    is refused too: differentiable callers go through the registry (whose
    `autograd.Function`s launch the kernels with recording off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel would cut the autograd graph; call it "
            f"through repro_torch.kernels.dispatch, or under no_grad")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on one CUDA "
                             f"device, got {[str(x.device) for x in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
