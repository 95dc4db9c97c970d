"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Every ``nbody_tpu_torch/csrc/*.cu`` is compiled by its own ``nvcc``, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu      # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared \\
         -o build/nbody_tpu_torch/<hash>/libnbody_kernels.so *.o

The library lands under ``build/`` beside the package, in a directory named
by a hash of the sources and flags, so an edited source builds anew and an
unchanged one loads at once.  There is no fast-math flag: divides are
IEEE-rounded under nvcc's default ``-prec-div`` where a kernel asks for one
(the pair-symmetric reduce's division by G m), and the pair loops take
``rsqrt.approx`` by name (with a Newton step, ``nbt::rsqrt_newton``, in the
exact sweeps and the force VJP; alone in the mxu kernel, the P3M
short-range sweep and its VJP).  A missing ``nvcc`` raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "nbody_tpu_torch"
LIB_NAME = "libnbody_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C function -> argument types; every function returns an int, a
# cudaError_t but for nbt_tiled_targets, nbt_sr_unit, nbt_sr_vjp_unit,
# nbt_deposit_header and nbt_far_field_scratch.
SIGNATURES = {
    # pos_t, nt, pos_s, mass_s, ns, out, tile_i, tile_j, bf16, stream
    "nbt_tiled_accel": (_P, _I, _P, _P, _I, _P, _I, _I, _I, _P),
    # tile_i, tile_j -> the targets a thread of the tiled sweep owns
    "nbt_tiled_targets": (_I, _I),
    # pos, mass, n, block, band, partials, out, bf16, stream
    "nbt_sym_accel": (_P, _P, _I, _I, _I, _P, _P, _I, _P),
    # pos, vel, mass, n, block, partials, queue, steps, dt, half, leapfrog,
    # stream
    "nbt_fused_rows": (_P, _P, _P, _I, _I, _P, _P, _I, _F, _F, _I, _P),
    # pos2, vel, mass, n, tile_i, tile_j, steps, dt, half, leapfrog, stream
    "nbt_fused_cols": (_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _P),
    # pos, mass, g, n, d_pos, d_mass, tile_i, tile_j, stream
    "nbt_force_vjp": (_P, _P, _P, _I, _P, _P, _I, _I, _P),
    # ptab, mtab, nslots, wl_t, wl_s, e_max, bounds, rc2, fwd, react,
    # scratch, symmetric, paired, stream
    "nbt_sr_sweep": (_P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _P),
    # -> the worklist entries a unit of the sweep (sizes its scratch)
    "nbt_sr_unit": (),
    # ptab, mtab, g, nslots, wl_t, wl_s, e_max, bounds, perm, start, rc2,
    # symmetric, gp, gm, grc2, scratch, stream
    "nbt_sr_vjp": (_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P,
                   _P, _P, _P),
    # -> the positions a unit of the SR VJP's passes (sizes its scratch)
    "nbt_sr_vjp_unit": (),
    # pos_t, mass_t, nt, pos_s, mass_s, ns, block, band, part_t, part_s,
    # out_t, out_s, bf16, stream
    "nbt_two_sided": (_P, _P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    # pos, mass, out, slots (host arrays of k device pointers), k, nl,
    # flags, tile_i, tile_j, stream
    "nbt_ring_accel": (_P, _P, _P, _P, _I, _I, _P, _I, _I, _P),
    # pos_t, nt, pos_s, mass_s, ns, out, tile_i, tile_j, stream
    "nbt_mxu_accel": (_P, _I, _P, _P, _I, _P, _I, _I, _P),
    # pos, mass, n, lo, inv_h, box, ng, scratch, out, stream
    "nbt_deposit": (_P, _P, _I, _P, _P, _F, _I, _P, _P, _P),
    # -> the int64 words of nbt_deposit's scratch past the ng^3 cells
    "nbt_deposit_header": (),
    # pos, mass, m_in, n, lo_box, hi_box, scratch, table, stream
    "nbt_far_field_moments": (_P, _P, _P, _I, _P, _P, _P, _P, _P),
    # -> the doubles of nbt_far_field_moments' scratch
    "nbt_far_field_scratch": (),
    # tgt, in_tgt, acc, table, n, out, stream
    "nbt_far_field_monopoles": (_P, _P, _P, _P, _I, _P, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):  # .cu and .cuh
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from nbody_tpu_torch/csrc at first use"
    )


def build(verbose: bool = False) -> tuple[Path, float]:
    """Compile the kernels unless this source hash is already built.
    Returns the library path and the seconds the build took (0 when it
    was already there).  The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library in ``nvcc.log``."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0
    lib.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        obj = lib.with_name(f"{src.stem}.{os.getpid()}.o")  # nvcc reads .o
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    link = [nvcc, *ARCH, "-shared", "-o", str(tmp),
            *(str(obj) for _, obj, _ in jobs)]
    log, failed = "", False
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log += " ".join(cmd) + "\n" + out
        failed = failed or proc.returncode != 0
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        failed = proc.returncode != 0
    secs = time.perf_counter() - t0
    (lib.parent / "nvcc.log").write_text(log)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{log}")
    if verbose:
        print(log, end="")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, secs


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.nbt_error_string.argtypes = [ctypes.c_int]
    lib.nbt_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = library().nbt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch ({msg})")
