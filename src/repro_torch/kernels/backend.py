"""Device resolution, the CUDA kernel library, and the path knobs.

Devices.  Every entry point of the port takes an explicit ``device``,
defaulting to ``"cuda"``; ``resolve_device`` raises when CUDA is asked for
and absent, so nothing silently runs on the CPU.  The CPU runs only where a
caller passes ``device="cpu"`` (the tests do), and there every kernel
wrapper takes its plain PyTorch version.

Kernel library.  The hand-written kernels live in ``csrc/*.cu`` with a
plain C interface.  ``build_library`` compiles each source with its own
``nvcc -c`` for ``sm_90a`` (all started together), links them with one
``nvcc -shared`` into one ``.so`` keyed by a hash of the sources, under
``kernels/_build/`` (listed in ``.gitignore``); ``library`` loads it with
``ctypes`` at first use.  Pointers and the stream travel as ``c_void_p``,
sizes as ``c_int`` and scalars as ``c_double``; each C entry point
returns ``cudaGetLastError()`` and ``launch`` raises if it is not 0.

Payloads and accumulators.  Every kernel has an entry point per payload
dtype — ``repro_<name>_f64``, ``_f32`` and ``_bf16`` — and follows the
reference's accumulator rule (``acc = accum_dtype`` if given, else the
payload dtype; operands cast up on-register, contracted at ``acc``,
rounded once to the payload dtype).  ``entry`` names the entry point of a
payload dtype and accumulator and raises for a pair no kernel
instantiates; ``resolve_precision`` resolves a precision policy (the
``REPRO_TORCH_PRECISION`` variable when none is given).

Path knobs (re-read per call; the port's own variable names, so settings
made for the JAX reference never reach it):

* ``resolve_spgemm_path`` — numeric SpGEMM: ``"fused"`` (default; the
  ``fused_pair_gemm`` kernel plus the ``block_seg_sum`` row-split combine),
  ``"pairs"`` (the unfused ablation path: gathered operands, the
  ``block_pair_gemm`` kernel, then ``block_seg_sum``) or ``"reference"``
  (einsum pair products + the plain segment sum, the reference's CPU
  default order); ``REPRO_TORCH_SPGEMM_PATH`` forces it.
* ``resolve_smooth_path`` — V-cycle smoother: ``"fused"`` (default; the
  ``fused_smoother`` kernel) or ``"reference"`` (the unfused recurrences);
  ``REPRO_TORCH_SMOOTH_PATH`` forces it.
* ``resolve_tune`` — the kernel autotuner's mode (``REPRO_TORCH_TUNE``):
  ``"off"``, ``"cache"`` (default) or ``"sweep"``; see
  ``repro_torch.kernels.autotune``.

``"reference"`` runs plain versions, so it is CPU-only: asked for on a CUDA
device it raises.  On the card the port launches its kernels.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------

def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; CUDA unless the caller asks for
    the CPU.  Raises instead of falling back when CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' "
                         f"or 'cpu'")
    return dev


# ---------------------------------------------------------------------------
# The CUDA library
# ---------------------------------------------------------------------------

def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


@functools.lru_cache(maxsize=None)
def source_digest() -> str:
    """Hash of every kernel source and the compiler flags (memoized: the
    autotuner keys every lookup on it)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{source_digest()}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or "
                           "/usr/local/cuda/bin)")
    return nvcc


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless the build for
    these sources exists.  The compiler's output (``-Xptxas -v``: registers,
    spills) is kept beside it as ``<lib>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for src, obj in zip(cu, objs)]
        logs, failed = [], []
        for src, p in zip(cu, procs):
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(logs))
        staged = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(staged), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        Path(str(so) + ".log").write_text("\n".join(logs))
        os.replace(staged, so)    # atomic: concurrent builds agree
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build_library()))
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


P = ctypes.c_void_p   # pointers and the stream
I = ctypes.c_int      # sizes
D = ctypes.c_double   # scalars passed by value


@functools.lru_cache(maxsize=None)
def kernel(name: str, argtypes: tuple):
    """C entry point ``name`` with its ctypes signature declared."""
    fn = getattr(library(), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, argtypes: tuple, *args) -> None:
    """Call a C entry point on the current stream (passed last) and raise
    on a refused launch."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = kernel(name, argtypes)(*args, stream)
    if rc:
        msg = library().repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_threads(name: str, threads: int) -> None:
    """Threads per block the tuned kernels take: a multiple of 32 in [32,
    1024] (the C entry points refuse anything else as well)."""
    if not (isinstance(threads, int) and 32 <= threads <= 1024
            and threads % 32 == 0):
        raise ValueError(f"{name}: threads={threads!r} must be a multiple "
                         f"of 32 in [32, 1024]")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def on_cuda(name: str, **tensors) -> bool:
    """Where a wrapper runs: True launches the kernel (CUDA tensors), False
    takes the plain version (CPU tensors).  Mixed or other devices raise."""
    devs = {t.device for t in tensors.values() if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices: "
                         + ", ".join(f"{k}={t.device}" for k, t in
                                     tensors.items() if t is not None))
    dev = devs.pop()
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


#: payload dtypes of the kernels, by the suffix of their C entry points
PAYLOADS = {torch.float64: "f64", torch.float32: "f32",
            torch.bfloat16: "bf16"}


def as_dtype(dtype) -> torch.dtype:
    """A payload dtype from a ``torch.dtype`` or its name (``"float64"``,
    ``"float32"``, ``"bfloat16"``: an autotune signature's ``dtype``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    for t in PAYLOADS:
        if str(t).removeprefix("torch.") == str(dtype).removeprefix("torch."):
            return t
    raise ValueError(f"not a kernel dtype: {dtype!r}")


def accumulator(dtype: torch.dtype, accum_dtype=None) -> torch.dtype:
    """The reference's accumulator rule: ``accum_dtype`` if given, else the
    payload dtype."""
    return dtype if accum_dtype is None else as_dtype(accum_dtype)


def contract_dtype(acc: torch.dtype) -> torch.dtype:
    """What a contraction at ``acc`` sums in: bf16 sums at f32 and rounds
    once (one ``einsum(..., preferred_element_type=bf16)``)."""
    return torch.float32 if acc == torch.bfloat16 else acc


def entry(name: str, dtype: torch.dtype, accum_dtype=None, *,
          bf16_f32: bool = False) -> str:
    """The C entry point of kernel ``name`` for payload ``dtype`` at the
    accumulator ``accum_dtype`` (None: the payload's).  f64 and f32
    payloads accumulate at their own dtype.  A bf16 payload accumulates at
    bf16 or f32: ``_bf16``, or ``_bf16_f32`` at f32 for the families whose
    elementwise steps round at the accumulator (``bf16_f32=True``; in the
    others both sum at f32 and round once).  Any other pair has no
    instantiation and raises."""
    if dtype not in PAYLOADS:
        raise ValueError(f"{name}: payload dtype {dtype} has no kernel "
                         f"instantiation (have {list(PAYLOADS)})")
    suffix = PAYLOADS[dtype]
    acc = PAYLOADS.get(accumulator(dtype, accum_dtype))
    if dtype == torch.bfloat16 and acc == "f32":
        if bf16_f32:
            suffix = "bf16_f32"
    elif acc != suffix:
        raise ValueError(f"{name}: no kernel instantiation for {dtype} "
                         f"payloads with accum_dtype={accum_dtype!r}")
    return f"repro_{name}_{suffix}"


def resolve_precision(precision=None):
    """A ``PrecisionPolicy`` from a policy, a stock name, or ``None``: the
    port's own ``REPRO_TORCH_PRECISION`` variable ("f64" | "f32" |
    "bf16"), default "f64".  ``REPRO_PRECISION`` (the reference's) is
    never read."""
    from repro_torch.core.precision import PrecisionPolicy
    if isinstance(precision, PrecisionPolicy):
        return precision
    if precision is None:
        precision = os.environ.get("REPRO_TORCH_PRECISION") or "f64"
    return PrecisionPolicy.from_name(precision)


def check_kernel_args(name: str, floats: dict, ints: dict = None,
                      masks: dict = None) -> None:
    """Validation before any pointer reaches a kernel: one payload dtype
    (f64, f32 or bf16) for the floats of a launch, index arrays int32,
    masks bool, everything contiguous."""
    dtypes = {t.dtype for t in floats.values() if t is not None}
    if len(dtypes) != 1 or not dtypes <= set(PAYLOADS):
        raise ValueError(f"{name}: float operands must share one payload "
                         f"dtype of {list(PAYLOADS)}: " + ", ".join(
                             f"{k}={t.dtype}" for k, t in floats.items()
                             if t is not None))
    payload = dtypes.pop()
    groups = ((floats, payload), (ints or {}, torch.int32),
              (masks or {}, torch.bool))
    for group, dtype in groups:
        for k, t in group.items():
            if t is None:
                continue
            if t.dtype != dtype:
                raise ValueError(f"{name}: {k} is {t.dtype}, the kernel "
                                 f"takes {dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {k} must be contiguous")
            if t.numel() >= 2 ** 31:
                raise ValueError(f"{name}: {k} has {t.numel()} elements, "
                                 f"beyond the kernels' int32 indexing")


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------

def _resolve_path(kind: str, var: str, device, path: str | None,
                  choices: tuple) -> str:
    if path is None:
        path = os.environ.get(var) or "fused"
    if path not in choices:
        raise ValueError(f"invalid {kind} path {path!r}: expected one of "
                         f"{choices} (from {var} or the path= knob)")
    if path == "reference" and torch.device(device).type == "cuda":
        raise ValueError(f"the 'reference' {kind} path runs the plain "
                         f"versions and is CPU-only; on {device} the port "
                         f"launches its kernels (unset {var})")
    return path


def resolve_spgemm_path(device, path: str | None = None) -> str:
    """Numeric SpGEMM path for payloads on ``device``."""
    return _resolve_path("SpGEMM", "REPRO_TORCH_SPGEMM_PATH", device, path,
                         ("fused", "pairs", "reference"))


def resolve_smooth_path(device, path: str | None = None) -> str:
    """V-cycle smoother path for vectors or panels on ``device``."""
    return _resolve_path("smoother", "REPRO_TORCH_SMOOTH_PATH", device, path,
                         ("fused", "reference"))


def resolve_tune(mode: str | None = None) -> str:
    """The autotuner's mode; honours ``REPRO_TORCH_TUNE``.

    "off"    — every ``threads=None`` knob resolves to its static default
               (256, the block size of the untuned kernels); touches no
               file.
    "cache"  (default) a cached winner for the launch's signature on this
               machine and kernel build when one exists, else the default.
               Never measures.
    "sweep"  like "cache", but a miss times the candidates on synthetic
               operands and records the winner
               (``repro_torch.kernels.autotune``).

    Accepts the strings ``repro.kernels.backend.resolve_tune`` accepts,
    with the same meaning; re-read per call (the port runs eagerly, so a
    change takes effect at the next launch).  Invalid values raise
    ``ValueError``.
    """
    if mode is None:
        mode = os.environ.get("REPRO_TORCH_TUNE")
    if mode is None:
        return "cache"
    key = str(mode).strip().lower()
    if key in ("", "0", "off", "false", "none"):
        return "off"
    if key in ("cache", "on", "1", "true"):
        return "cache"
    if key == "sweep":
        return "sweep"
    raise ValueError(
        f"invalid autotune mode {mode!r}: expected 'off', 'cache' or "
        f"'sweep' (from REPRO_TORCH_TUNE or the mode= knob)")
