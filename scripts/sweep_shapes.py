#!/usr/bin/env python3
"""The exact sweeps' kernels at their paths' shapes, on one CUDA card.

    python scripts/sweep_shapes.py [--tree DIR] [--targets] [--mxu-tiles]

Times (CUDA events, mean of 20 calls after one warm-up) Kernel A
(``ops/tiled_kernel.py``), the mxu kernel (``ops/mxu_kernel.py``), the ring
(``parallel/ring_kernel.py``) and the fused columns block
(``ops/fused_block.py``, 50 Euler steps, tiles 64 x 256) through their
public wrappers at their default tiles, on the reference initial
conditions:

- Kernel A: N=16384 whole state; one of 4 shards' 4096 targets against all
  16384 sources (``allgather``) and against one shard (``ring``); one of 4
  shards of N=2000, 500 targets against 2000 sources;
- mxu: N=16384 whole state, 500 x 2000 and 500 x 500;
- the ring: N=16384 at K = 2, 3, 4, 8 and N=131072 at K=8;
- the fused columns block at N=2000 (padded to 2048) and N=16384.

Each line is one JSON object ``{"shape": ..., "ms": ...}``; the first is
the card's name and power limit.  ``--tree DIR`` imports
``nbody_tpu_torch`` from another checkout (its kernels build into that
checkout's ``build/``), so two commits compare in one call on one card.

``--targets`` rewrites ``kMaxTargets`` (the most targets a thread of the
tiled sweep owns, ``csrc/common.cuh``) to 1, 2 and 4 in copies of
``csrc/`` under ``build/exp/targets_<R>/``, builds ``tiled.cu`` of each
(one nvcc each, all started together, registers printed) and times
Kernel A's C entry at tiles (32, 256), (64, 256) and (128, 256) at the
Kernel A shapes above.  ``--mxu-tiles`` times the mxu kernel at every
tile_i with tile_j 256, 512 and 1024 at N=16384 and 500 x 2000.  Needs a
CUDA card and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 20


def time_ms(fn, reps: int = REPS) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def emit(shape: str, ms: float, **extra) -> None:
    print(json.dumps({"shape": shape, "ms": ms, **extra}), flush=True)


def kernel_a_shapes(dev) -> dict:
    """name -> (pos_t, pos_s, mass_s) of Kernel A's shapes."""
    from nbody_tpu_torch import make_state

    big = make_state(16384, device=dev)
    small = make_state(2000, device=dev)
    shard = big.pos[:, :4096].contiguous()
    return {
        "A 16384 x 16384": (big.pos, big.pos, big.mass),
        "A 4096 x 16384": (shard, big.pos, big.mass),
        "A 4096 x 4096": (shard, shard, big.mass[:4096].contiguous()),
        "A 500 x 2000": (small.pos[:, :500].contiguous(), small.pos,
                         small.mass),
    }


def wrappers(dev) -> None:
    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import fused_block, mxu_kernel, tiled_kernel
    from nbody_tpu_torch.parallel import make_mesh, ring_kernel
    from nbody_tpu_torch.parallel.decompose import shard_state

    for name, args in kernel_a_shapes(dev).items():
        emit(name, time_ms(lambda: tiled_kernel.accelerations_between(*args)))
    big = make_state(16384, device=dev)
    small = make_state(2000, device=dev)
    for name, args in (
            ("mxu 16384 x 16384", (big.pos, big.pos, big.mass)),
            ("mxu 500 x 2000", (small.pos[:, :500].contiguous(), small.pos,
                                small.mass)),
            ("mxu 500 x 500", (small.pos[:, :500].contiguous(),
                               small.pos[:, :500].contiguous(),
                               small.mass[:500].contiguous()))):
        emit(name, time_ms(lambda: mxu_kernel.accelerations_between(*args)))
    for n, k in ((16384, 2), (16384, 3), (16384, 4), (16384, 8),
                 (131072, 8)):
        st = make_state(n, pad_multiple=64 * k, device=dev)
        sh, _ = shard_state(st, k, make_mesh(k))
        pos, mass = list(sh.pos), list(sh.mass)
        emit(f"ring N={n} K={k}", time_ms(
            lambda: ring_kernel.ring_accelerations(pos, mass),
            reps=REPS if n < 100000 else 3))
    for n in (2000, 16384):
        st = make_state(n, pad_multiple=256, device=dev)
        args = (st.pos, st.vel, st.mass, 0.1, 50, 64, 256)
        emit(f"fused columns N={n} (padded {st.n_padded}), 50 steps",
             time_ms(lambda: fused_block.fused_block(*args), reps=5))


def build_targets(out_root: str) -> dict:
    """R cap -> (ctypes library of tiled.cu built with kMaxTargets = R,
    its register report)."""
    from nbody_tpu_torch.utils import build

    common = (build.CSRC_DIR / "common.cuh").read_text()
    tiled = (build.CSRC_DIR / "tiled.cu").read_text()
    nvcc = build.find_nvcc()
    jobs = {}
    for cap in (1, 2, 4):
        text, n_sub = re.subn(r"constexpr int kMaxTargets = \d+;",
                              f"constexpr int kMaxTargets = {cap};", common)
        if n_sub != 1:
            raise RuntimeError("csrc/common.cuh no longer declares "
                               "kMaxTargets once")
        out = os.path.join(out_root, f"targets_{cap}")
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "common.cuh"), "w") as f:
            f.write(text)
        cu = os.path.join(out, "tiled.cu")
        with open(cu, "w") as f:
            f.write(tiled)
        so = os.path.join(out, "libtiled.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", so, cu]
        jobs[cap] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cap, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for kMaxTargets={cap}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.nbt_tiled_accel.argtypes = list(
            build.SIGNATURES["nbt_tiled_accel"])
        lib.nbt_tiled_targets.argtypes = list(
            build.SIGNATURES["nbt_tiled_targets"])
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line]
        libs[cap] = (lib, regs)
    return libs


def targets(dev) -> None:
    import torch

    libs = build_targets(os.path.join(ROOT, "build", "exp"))
    for cap, (_, regs) in libs.items():
        for line in regs:
            print(f"kMaxTargets={cap}: {line}", flush=True)
    for name, (pt, ps, ms) in kernel_a_shapes(dev).items():
        nt, ns = pt.shape[1], ps.shape[1]
        out = torch.empty((3, nt), dtype=torch.float32, device=dev)
        for ti, tj in ((32, 256), (64, 256), (128, 256)):
            for cap, (lib, _) in libs.items():
                stream = torch.cuda.current_stream().cuda_stream

                def call():
                    err = lib.nbt_tiled_accel(pt.data_ptr(), nt, ps.data_ptr(),
                                              ms.data_ptr(), ns, out.data_ptr(),
                                              ti, tj, 0, stream)
                    if err:
                        raise RuntimeError(f"nbt_tiled_accel: CUDA error {err}")

                emit(f"{name} tiles {ti}x{tj}", time_ms(call), max_targets=cap,
                     r=lib.nbt_tiled_targets(ti, tj))


def mxu_tiles(dev) -> None:
    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import mxu_kernel

    big = make_state(16384, device=dev)
    small = make_state(2000, device=dev)
    for name, args in (("mxu 16384 x 16384", (big.pos, big.pos, big.mass)),
                       ("mxu 500 x 2000", (small.pos[:, :500].contiguous(),
                                           small.pos, small.mass))):
        for ti in mxu_kernel.TILE_I:
            for tj in (256, 512, 1024):
                emit(f"{name} tiles {ti}x{tj}", time_ms(
                    lambda: mxu_kernel.accelerations_between(*args, ti, tj)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose nbody_tpu_torch to time")
    ap.add_argument("--targets", action="store_true",
                    help="Kernel A at kMaxTargets 1, 2, 4")
    ap.add_argument("--mxu-tiles", action="store_true",
                    help="the mxu kernel at every tile")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}; tree {os.path.relpath(args.tree, ROOT)}", flush=True)
    dev = torch.device("cuda", 0)
    if args.targets:
        targets(dev)
    elif args.mxu_tiles:
        mxu_tiles(dev)
    else:
        wrappers(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
