"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The library lands in
``build/repro_torch/`` at the root of the checkout, under a name keyed by a
hash of the sources, headers and flags, so a stale library is never loaded.
The build happens at first use — never at import — and needs the CUDA
toolkit (``$CUDA_HOME/bin/nvcc``, ``/usr/local/cuda/bin/nvcc`` or ``nvcc``
on ``PATH``).  There is no fallback: a failed build raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from repro_torch.kernels import precision as px

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("assign.cu", "update.cu", "fused_step.cu",
           "fused_step_batched.cu", "assign_int8.cu", "update_int8.cu",
           "fused_step_int8.cu", "fused_step_batched_int8.cu",
           "assign_bf16.cu", "update_bf16.cu", "fused_step_bf16.cu",
           "fused_step_batched_bf16.cu", "fused_step_dma.cu", "kpp_probe.cu",
           "kpp_draw.cu")
HEADERS = ("common.cuh", "update.cuh", "assign_mma.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "sm_90a"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# C entry points: (argtypes) -> int (a cudaError_t).
SIGNATURES = {
    "repro_assign_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                         _I, _P),
    "repro_update_f32": (_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "repro_fused_step_f32": (_P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "repro_fused_step_batched_f32": (_P, _P, _P, _P, _I, _I64, _I, _I, _I,
                                     _P),
    "repro_assign_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                          _I, _I, _I, _P),
    "repro_assign_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                          _I, _P),
    "repro_assign_bf16x3": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _P, _I64, _I, _I, _I, _I, _P),
    "repro_update_int8": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                          _P),
    "repro_fused_step_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                              _I, _I, _I, _P),
    "repro_fused_step_batched_int8": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I64, _I, _I, _I, _P),
    "repro_kpp_probe": (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P),
    "repro_kpp_draw": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I,
                       _I, _I, _P),
}
# The bf16 and bf16x3 entry points of the update and fused kernels share
# one signature.
SIGNATURES.update({
    f"repro_{entry}_{prec}": argtypes for prec in ("bf16", "bf16x3")
    for entry, argtypes in (
        ("update", (_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P)),
        ("fused_step", (_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P)),
        ("fused_step_batched", (_P, _P, _P, _P, _P, _I, _I64, _I, _I, _I,
                                _P)))})
# The dma pipeline of each fused entry point takes its blocks twin's operands.
SIGNATURES.update({f"repro_fused_step_{prec}_dma":
                   SIGNATURES[f"repro_fused_step_{prec}"]
                   for prec in ("f32", "int8", "bf16", "bf16x3")})
# Policies of the dma kernels, in the order of
# repro_fused_step_dma_smem_bytes (csrc/fused_step_dma.cu).
DMA_POLICIES = ("f32", "bf16", "bf16x3", "int8")


@dataclasses.dataclass
class BuildInfo:
    path: Path
    seconds: float          # wall time of this build (0 when cached)
    built: bool             # False when a cached library was reused
    resources: dict         # kernel -> {"registers", "smem_bytes", "spill"}
    # dynamic shared memory of the dma kernels, by policy (after load)
    dma_smem_bytes: dict = dataclasses.field(default_factory=dict)
    # dynamic shared memory of B8's, B16's and B3's tensor-core pass, by
    # kernel and centroids a tile (after load)
    mma_smem_bytes: dict = dataclasses.field(default_factory=dict)


_LIB: ctypes.CDLL | None = None
_INFO: BuildInfo | None = None
_tally = threading.local()


def nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin, PATH): the "
            "CUDA kernels cannot be built")
    return found


def source_digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _parse_ptxas(text: str) -> dict:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    out: dict = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(sm.group(1)) if sm else 0
    return out


def build(force: bool = False) -> BuildInfo:
    """Compile the kernels into ``BUILD_DIR`` (cached by source digest)."""
    digest = source_digest()
    lib = BUILD_DIR / f"librepro_torch_{digest}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists() and log.exists() and not force:
        return BuildInfo(lib, 0.0, False, _parse_ptxas(log.read_text()))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    t0 = time.monotonic()
    procs = []
    for name in SOURCES:
        # per-process names: concurrent first uses never share a file
        obj = BUILD_DIR / f"{Path(name).stem}_{digest}.{os.getpid()}.o"
        cmd = [exe, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, failures = [], []
    for name, _, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{out}{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [exe, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o",
         str(tmp), *(str(obj) for _, obj, _ in procs)],
        capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink()
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    text = "\n".join(logs)
    log.write_text(text)
    os.replace(tmp, lib)
    return BuildInfo(lib, time.monotonic() - t0, True, _parse_ptxas(text))


def load(rebuild: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built at first use).

    Raises ``RuntimeError`` when the card is not compute capability 9.0:
    the kernels are compiled for ``sm_90a`` only.
    """
    global _LIB, _INFO
    if _LIB is not None and not rebuild:
        return _LIB
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the CUDA kernels are built for {ARCH} (compute capability "
            f"9.0); this card is {torch.cuda.get_device_name()} with "
            f"capability {cap}")
    info = build(force=rebuild)
    lib = ctypes.CDLL(str(info.path))
    for fn, argtypes in SIGNATURES.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    lib.repro_kpp_probe_ctas_per_sm.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_kpp_probe_ctas_per_sm.restype = ctypes.c_int
    lib.repro_fused_step_dma_smem_bytes.argtypes = [ctypes.c_int]
    lib.repro_fused_step_dma_smem_bytes.restype = ctypes.c_int
    info.dma_smem_bytes = {prec: lib.repro_fused_step_dma_smem_bytes(i)
                           for i, prec in enumerate(DMA_POLICIES)}
    lib.repro_assign_mma_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.repro_assign_mma_smem_bytes.restype = ctypes.c_int
    info.mma_smem_bytes = {f"{name} bn{bn}":
                           lib.repro_assign_mma_smem_bytes(i, bn)
                           for i, name in enumerate(("B8", "B16", "B3"))
                           for bn in (64, 128)}
    _LIB, _INFO = lib, info
    return lib


def info() -> BuildInfo | None:
    """How the loaded library was obtained (None before :func:`load`)."""
    return _INFO


def count_launch(name: str) -> None:
    """Note one launch of the kernel that ``ops.launch_counts`` names
    ``name`` in this thread's open :func:`tally`, if there is one.  Every
    wrapper calls it beside its own counter's increment."""
    counts = getattr(_tally, "counts", None)
    if counts is not None:
        counts[name] = counts.get(name, 0) + 1


@contextlib.contextmanager
def tally():
    """``{name: launches}`` that the wrappers count on this thread inside
    the ``with``, and none of another thread's: the serving registry reads
    a capture's launches so while a fit launches on another thread."""
    _tally.counts = counts = {}
    try:
        yield counts
    finally:
        _tally.counts = None


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = _LIB.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")


def require(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def xc_shapes(x: torch.Tensor, c: torch.Tensor) -> tuple[int, ...]:
    """(m, k, n), or (B, m, k, n) for batched operands; raises unless the
    shapes and devices of x [..., m, n] and c [..., k, n] agree."""
    *lead, m, n = x.shape
    k = c.shape[-2]
    if (c.shape[-1] != n or list(c.shape[:-2]) != lead or c.device != x.device
            or k < 1 or n < 1 or (lead and lead[0] < 1)):
        raise ValueError(f"bad shapes x {tuple(x.shape)} / c {tuple(c.shape)}"
                         f" on {x.device} / {c.device}")
    return (*lead, m, k, n)


def int8_operands(x, c: torch.Tensor, ndim: int):
    """Validated (q, scale, c, cq, t) of an int8 launch: ``c`` the
    full-width f32 centroids, whose norms the launch computes on the card
    (``common.cuh:sqnorm_rows``), ``(cq, t)`` the centroids quantized in
    the chunk's scaled space (per stream when batched)."""
    q, scale = px.as_quantized(x)
    require("x.q", q, torch.int8, ndim)
    require("x.scale", scale, torch.float32, ndim - 1)
    require("c", c, torch.float32, ndim)
    n = q.shape[-1]
    if (c.shape[-1] != n or c.shape[:-2] != q.shape[:-2]
            or scale.shape != q.shape[:-2] + (n,) or c.device != q.device
            or scale.device != q.device or c.shape[-2] < 1 or n < 1
            or (ndim == 3 and q.shape[0] < 1)):
        raise ValueError(f"bad shapes x {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} / c {tuple(c.shape)}")
    cq, t = px.quantize_centroids(c, scale)
    return q, scale, c, cq, t


TILE_ROWS = 256                # rows per point tile (common.cuh:TM)
SCRATCH_BYTES = 256 << 20      # cap on the per-CTA partials of one launch


def grid(device: torch.device, m: int, partial_floats: int = 0,
         per_sm: int = 2) -> int:
    """CTAs of a launch over ``m`` rows: at most one per point tile,
    ``per_sm`` per SM (two, unless kernel P's shared memory or an
    assignment's tuned launch says otherwise: an assignment's rows are
    independent, so its result does not depend on the grid), and (with
    per-CTA partials of ``partial_floats`` floats) as many as fit
    ``SCRATCH_BYTES``.  The grid depends only on the shape and
    the card, so the summation order (and the result) is fixed for both."""
    tiles = max(1, -(-m // TILE_ROWS))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = min(tiles, per_sm * sms)
    if partial_floats:
        g = min(g, max(1, SCRATCH_BYTES // (4 * partial_floats)))
    return g


def persistent_grid(device: torch.device, tiles: int, per_sm: int = 2
                    ) -> int:
    """CTAs of a launch whose CTAs walk ``tiles`` output tiles: at most one
    per tile, ``per_sm`` per SM.  Each tile is one CTA's, so the result
    does not depend on the grid."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(tiles, per_sm * sms))


def stream_group(grid: int, partial_floats: int) -> int:
    """Streams per launch of a batched kernel whose streams each take
    ``grid`` CTAs of ``partial_floats`` partials: as many as fit
    ``SCRATCH_BYTES``, at least one.  The per-stream grid is never cut."""
    return max(1, SCRATCH_BYTES // (4 * grid * partial_floats))
