"""Build and load the port's hand-written CUDA kernels.

The sources under ``repro_torch/csrc/*.cu`` have a plain C interface.  On
first use each source is compiled by its own ``nvcc`` process (all started
together; the flash sources twice, :data:`SPLIT`) for ``sm_90a`` and the
objects are linked into one shared library,
``build/kernels/librepro_torch_<hash>.so`` at the root of the source tree;
``<hash>`` covers the sources, every header beside them (``csrc/*.cuh``) and
the flags, so a changed source or header builds anew and an unchanged tree
loads at once.  The library is loaded with :mod:`ctypes`:
every pointer and the stream are ``c_void_p``, every size ``c_int64``, every
real ``c_double``, and every entry returns the ``cudaError_t`` of its
launches.

Nothing here runs at import: the CPU tests import every module, and only a
call on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("bitonic_sort.cu", "radix_sort.cu", "kway_merge.cu",
           "alltoallv_deliver.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "ssd_scan.cu", "ssd_scan_bwd.cu",
           "lru_scan.cu", "lru_scan_bwd.cu")
# Sources built a second time into an object of their own with a define:
# the flash kernels' float16 instantiations, so that they compile beside the
# float32 and bfloat16 ones (each source's entry hands them an fp16 call).
SPLIT = (("flash_attention.cu", "REPRO_FLASH_F16"),
         ("flash_attention_bwd.cu", "REPRO_FLASH_F16"))
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Argument kinds per entry point: "p" pointer (c_void_p), "i" size (c_int64),
# "f" real (c_double).
_SIGNATURES = {
    # device, in, in_stride, out, rows, n, key kind, stream
    "repro_bitonic_sort_rows": "ipipiiip",
    # device, in, in_stride, out, tmp, scratch, rows, n, kpt, threads,
    # key kind, stream
    "repro_radix_sort_rows": "ipipppiiiiip",
    # device, in, out, tiles, tile, key kind, stream
    "repro_kway_tile_sort": "ippiiip",
    # device, brecv, context stride, bucket stride, cnt, cnt context stride,
    # ranks, R, k, v, cap, starts, key kind, stream
    "repro_kway_splitters": "ipiipi" "pi" "iii" "p" "i" "p",
    # device, brecv, context stride, bucket stride, cnt, cnt context stride,
    # starts, out, k, v, cap, rcap, tile, seg_tiles, key kind, stream
    "repro_kway_merge_segments": "ipiipi" "pp" "iiiiii" "i" "p",
    # device, src, src_stride, src_off, dst, dst_stride, dst_off, v, ww,
    # cnt, cnt_stride, cnt_off, fill, cp, cp_stride, cp_off,
    # ct, ct_stride, ct_off, the payload's and the counts payload's element
    # bytes, stream
    "repro_deliver_words": "ipiipiiii" "piii" "pii" "pii" "ii" "p",
    # device, src, src_stride, src_off, m, pn, nq, s0, s, c0, d, ww,
    # out, out strides (q, p, dl, j), cnt, cnt_stride, cnt_off, fill,
    # cp, cp_stride, cp_off, ct, ct strides (q, p, dl, j), span, the
    # payload's and the counts payload's element bytes, stream
    "repro_assemble_proc_words": "ipii" "iiiiiiii" "piiii" "piii" "pii"
                                 "piiii" "i" "ii" "p",
    # device, q, q strides (b, s, h), k, k strides, v, v strides, o,
    # o strides, part, lse, batch, sq, sk, hq, hkv, d, sk_valid, q_offset,
    # causal, window, prefix, dtype, bq, bk, splits, split_len, scale,
    # stream
    "repro_flash_attention": "i" "piii" "piii" "piii" "piii" "pp"
                             "iiiiiiiiiiiiiiii" "f" "p",
    # device, q, k, v, o, dout (each with strides b, s, h), lse, dsum, dq,
    # dk, dv (with strides), part, slices, batch, sq, sk, hq, hkv, d,
    # sk_valid, q_offset, causal, window, prefix, dtype, scale, stream
    "repro_flash_attention_bwd": "i" "piii" "piii" "piii" "piii" "piii"
                                 "pp" "piii" "piii" "piii" "pi"
                                 "iiiiiiiiiiii" "f" "p",
    # device, x, x strides (b, h, s), dt, dt strides (b, h, s), A, B,
    # B strides (b, s), C, C strides (b, s), y, y strides (b, h, s), s_fin,
    # g, states, batch, heads, seq, n, p, q, the float kinds of x (and y),
    # dt, A, B and C, stream
    "repro_ssd_scan": "i" "piii" "piii" "p" "pii" "pii" "piii" "p" "pp"
                      "iiiiii" "iiiii" "p",
    # device, x, x strides (b, h, s), dt, dt strides (b, h, s), A, B,
    # B strides (b, s), C, C strides (b, s), dy, dy strides (b, h, s),
    # ds_fin, states, dstates, dx, dx strides (b, h, s), ddt, dB, dC,
    # dA_part, dA, batch, heads, seq, n, p, q, stream
    "repro_ssd_scan_bwd": "i" "piii" "piii" "p" "pii" "pii" "piii" "p"
                          "pp" "piii" "pppp" "p" "iiiiii" "p",
    # device, a, a strides (b, s), b, b strides (b, s), h, h_fin, carry,
    # prod, batch, seq, width, the float kinds of a (and h) and b, stream
    "repro_lru_scan": "i" "pii" "pii" "pp" "pp" "iii" "ii" "p",
    # device, a, a strides (b, s), h, h strides (b, s), dh, dh strides
    # (b, s), dh_fin, da, db, carry, prod, batch, seq, width, stream
    "repro_lru_scan_bwd": "i" "pii" "pii" "pii" "p" "pppp" "iii" "p",
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(path).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + repr(SPLIT).encode())
    headers = sorted(p.name for p in CSRC.glob("*.cuh"))
    for name in (*SOURCES, *headers):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile (if needed) and return the shared library's path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # One nvcc per source, all started together, then one link.  Objects
    # and the library carry this process's id until the library is synced to
    # disk and renamed, so a build cut short, or another process building
    # the same sources, never leaves a partial library under the final name.
    tag = f"{so.stem}.{os.getpid()}"
    units = [(s, None) for s in SOURCES] + list(SPLIT)
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}{'.' + d if d else ''}.o"
            for s, d in units]
    tmp = BUILD_DIR / f"{tag}.so"
    procs = [subprocess.Popen([nvcc, *FLAGS, *([f"-D{d}"] if d else []),
                               "-c", str(CSRC / s), "-o", str(o)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for (s, d), o in zip(units, objs)]
    for (s, d), p in zip(units, procs):
        out = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {s}"
                               f"{f' (-D{d})' if d else ''}:\n{out}")
    link = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"linking {so.name} failed:\n{link.stdout}"
                           f"{link.stderr}")
    with open(tmp) as f:
        os.fsync(f.fileno())
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int64,
                     "f": ctypes.c_double}
            for name, sig in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [kinds[c] for c in sig]
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int64]
            lib.repro_error_string.restype = ctypes.c_char_p
            lib.repro_flash_attention_bwd256_tile.argtypes = [ctypes.c_int64]
            lib.repro_flash_attention_bwd256_tile.restype = ctypes.c_int64
            _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call entry ``name`` with ``(device index, *args, current stream)``;
    raise if its launches reported a CUDA error.  An entry makes its card
    the thread's current device (``cudaSetDevice``); the caller's is set
    back, so that a launch on one card of a mesh does not move the
    allocations that follow it (``"cuda"`` without an index) to that card."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    before = torch.cuda.current_device()
    err = getattr(lib, name)(index, *args, stream)
    if index != before:
        torch.cuda.set_device(before)
    if err:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def ptr(t) -> int | None:
    """Device address of tensor ``t`` (``None`` for no tensor)."""
    return None if t is None else t.data_ptr()


def require_cuda(name: str, *tensors) -> None:
    """Raise unless every given tensor is a contiguous-rowed int32 CUDA
    tensor — what the kernels take."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 words, got {t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")


# The key kinds of the sort and merge kernels (csrc/sort_keys.cuh's
# KeyKind): keys of 1, 2 or 4 bytes, each with its order-preserving map.
# bool sorts as its byte (0 or 1), as uint8 does.
KEY_KINDS = {torch.int32: 0, torch.uint32: 1, torch.float32: 2,
             torch.int16: 3, torch.uint16: 4, torch.float16: 5,
             torch.bfloat16: 6, torch.int8: 7, torch.uint8: 8, torch.bool: 8}
# The float kinds of the scans' operands (csrc/ssd_common.cuh's FloatKind):
# each is read as it lies and converted to float32 in the kernel.
FLOAT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def require_kind(name: str, kinds: dict, *tensors,
                 rows: bool = True) -> int:
    """Raise unless every given tensor (None: none) is a CUDA tensor of one
    dtype among ``kinds`` (a dtype → kind code map, such as
    :data:`KEY_KINDS`), with contiguous rows unless ``rows`` is False (an
    operand read through all its strides); returns that dtype's code.  A
    dtype the kernel does not take raises ``TypeError`` naming it and the
    dtypes it takes."""
    ts = [t for t in tensors if t is not None]
    for t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in kinds:
            taken = ", ".join(str(d).replace("torch.", "") for d in kinds)
            raise TypeError(f"{name}: the kernel takes {taken}; got "
                            f"{t.dtype}")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: operands of one dtype, got "
                            f"{ts[0].dtype} and {t.dtype}")
        if rows and t.dim() and t.stride(-1) != 1:
            raise ValueError(f"{name}: rows must be contiguous")
    return kinds[ts[0].dtype]


def define_op(schema: str, cuda_impl, fake_impl):
    """Define the op ``repro_torch::<schema>`` (``torch.ops.repro_torch``)
    with ``cuda_impl`` as its CUDA implementation and ``fake_impl`` as its
    fake one (shapes, strides and dtypes only: what ``FakeTensorMode`` and
    meta tensors run); returns its ``OpOverload``.  The plain
    ``torch.library`` registration: ``torch.library.custom_op``'s Python
    layers (an autograd wrapper and an aliasing check a call) cost tens of
    microseconds a launch, which the host-bound kernel rows read."""
    name = schema.split("(", 1)[0]
    _OPS.define(schema)
    _OPS.impl(name, cuda_impl, "CUDA")
    torch.library.register_fake(f"repro_torch::{name}", fake_impl, lib=_OPS)
    return getattr(torch.ops.repro_torch, name).default


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
