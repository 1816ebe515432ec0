"""Build the CUDA kernels with nvcc and load them with ctypes.

Each source ``csrc/<name>.cu`` compiles at first use into a shared library
with a plain C interface, ``build/repro_torch/<hash>/lib<name>.so`` under
the repository root, where ``<hash>`` covers every file in ``csrc/`` and
the flags: a changed source builds anew, an unchanged one loads the
library already built. Only sources in the repository are compiled.

Flags: ``sm_90a`` (Hopper), ``-O3``, and for bit-identity with the plain
PyTorch versions ``-fmad=false -prec-div=true -prec-sqrt=true
-ftz=false`` — never ``--use_fast_math``. ``-Xptxas=-v`` reports each
kernel's registers, shared memory and spills; :func:`build` returns that
report and each nvcc's seconds.

Importing this module runs nothing: the compiler is looked for only when
a kernel is first needed, so the CPU tests import it on machines without
nvcc.

:func:`launch` runs one kernel's C entry point on the current stream,
raises on the error code it returns, and adds one to the kernel's count
in :data:`LAUNCHES` — the port's one launch counter, shared by every
wrapper (the flash wrappers also count each launch under its design in
:data:`FLASH_DESIGN_LAUNCHES` and :data:`FLASH_BWD_DESIGN_LAUNCHES`, the
fused and resident stencil wrappers in
:data:`STENCIL_DESIGN_LAUNCHES`, the repack tap sum in
:data:`BLOCKS_DESIGN_LAUNCHES`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["BLOCKS_DESIGN_LAUNCHES", "FLASH_BWD_DESIGN_LAUNCHES",
           "FLASH_DESIGN_LAUNCHES", "LAUNCHES",
           "NVCC_FLAGS", "SOURCES",
           "STENCIL_DESIGN_LAUNCHES", "build", "launch", "library", "nvcc_path",
           "reset_launches"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# flash attention's simple designs are one source per element type
# (csrc/flash_attn.cuh and csrc/flash_attn_bwd.cuh), so that their
# instances build in parallel.
SOURCES = ("stencil3d", "stencil3d_sm90", "stencil3d_blocks_sm90", "sfc_gather",
           "flash_attn_f32", "flash_attn_bf16", "flash_attn_f16",
           "flash_attn_e4m3", "flash_attn_e5m2", "flash_attn_sm90",
           "flash_attn_bwd_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
              "-Xptxas=-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# Kernel launches per wrapper since the last reset_launches(). A wrapper
# adds one where it launches its kernel and nowhere else.
LAUNCHES = {"stencil_step_fused": 0, "stencil_sum_resident": 0,
            "stencil_sum_blocks": 0, "gather_rows": 0,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0}
# flash_attention_fwd's launches by design (kernels/flash_attn.flash_design):
# each also counts once in LAUNCHES["flash_attention_fwd"].
FLASH_DESIGN_LAUNCHES = {"sm90": 0, "simple": 0}
# flash_attention_bwd's launches by design (the same flash_design): each
# also counts once in LAUNCHES["flash_attention_bwd"].
FLASH_BWD_DESIGN_LAUNCHES = {"sm90": 0, "simple": 0}
# stencil_step_fused's and stencil_sum_resident's launches by design
# (kernels/stencil3d.fused_design): each also counts once in LAUNCHES.
STENCIL_DESIGN_LAUNCHES = {"sm90": 0, "sm90_group": 0, "simple": 0}
# stencil_sum_blocks' launches by design (kernels/stencil3d.blocks_design):
# each also counts once in LAUNCHES.
BLOCKS_DESIGN_LAUNCHES = {"sm90": 0, "simple": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, FLASH_DESIGN_LAUNCHES, FLASH_BWD_DESIGN_LAUNCHES,
                   STENCIL_DESIGN_LAUNCHES, BLOCKS_DESIGN_LAUNCHES):
        for name in counts:
            counts[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``. Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                       "the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_ROOT / _source_hash() / f"lib{name}.so"


def build(names=SOURCES) -> dict[str, tuple[float, str]]:
    """Compile every missing library of ``names``, one nvcc per source, all
    started together. Returns ``{name: (seconds, compiler report)}``, the
    seconds from the start to that nvcc's exit ((0.0, "") for a library
    that was already built). Raises with the compiler's output on failure."""
    nvcc = None
    procs = {}
    reports = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            reports[name] = (0.0, "")
            continue
        nvcc = nvcc or nvcc_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    # one reader thread per nvcc, so that each one's exit is timed as it
    # happens and no pipe fills while another is being read
    def finish(name, proc):
        text, _ = proc.communicate()
        reports[name] = (time.perf_counter() - t0, text)

    readers = [threading.Thread(target=finish, args=(name, proc))
               for name, (proc, _, _) in procs.items()]
    for r in readers:
        r.start()
    for r in readers:
        r.join()
    failed = []
    for name, (proc, tmp, out) in procs.items():
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu exited {proc.returncode}:\n"
                          f"{reports[name][1]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(lib: ctypes.CDLL, name: str, fn, device: torch.device, *args) -> None:
    """Call the C entry point ``fn(*args, stream)`` of ``lib`` on the
    current stream of ``device``; raise on the CUDA error it returns (a
    refused launch never runs, and a synchronize would not report it),
    else count the launch under ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
    LAUNCHES[name] += 1
