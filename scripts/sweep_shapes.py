#!/usr/bin/env python3
"""The exact sweeps' kernels at their paths' shapes, on one CUDA card.

    python scripts/sweep_shapes.py [--tree DIR] [--targets] [--mxu-tiles]
                                   [--sym-targets] [--vjp-tiles]

Times (CUDA events, mean of 20 calls after one warm-up) Kernel A
(``ops/tiled_kernel.py``), the mxu kernel (``ops/mxu_kernel.py``), the ring
(``parallel/ring_kernel.py``), the fused columns block
(``ops/fused_block.py``, 50 Euler steps, tiles 64 x 256) and the
pair-symmetric kernels (Kernel B and the two-sided sweep,
``ops/sym_kernel.py``, and the fused rows block, 50 Euler steps) through
their public wrappers at their default tiles, on the reference initial
conditions:

- Kernel A: N=16384 whole state; one of 4 shards' 4096 targets against all
  16384 sources (``allgather``) and against one shard (``ring``); one of 4
  shards of N=2000, 500 targets against 2000 sources;
- mxu: N=16384 whole state, 500 x 2000 and 500 x 500;
- the ring: N=16384 at K = 2, 3, 4, 8 and N=131072 at K=8;
- the fused columns block at N=2000 (padded to 2048) and N=16384;
- Kernel B at N=16384 and 2048, and at N=131072 in bf16;
- the two-sided sweep at 4096 x 4096 and 4096 x 2048 (one ``ring_sym``
  block pair of N=16384 over 4, and a half one), and one block pair of
  N=2000 over 4 (512 x 512);
- the fused rows block at N=2000 (padded to 2048) and N=16384.

Each line is one JSON object ``{"shape": ..., "ms": ...}``; the first is
the card's name and power limit.  Kernel B and the two-sided sweep are
host-bound at their small shapes (a wrapper call costs tens of
microseconds of Python), so beside their "ms", the eager wrapper calls'
time as for every kernel, "device_ms" is the device time alone: the calls
captured in a CUDA graph and replayed.  A pair-symmetric line also carries
R, the targets a lane owns there (null for a tree that does not name it).
``--tree DIR`` imports
``nbody_tpu_torch`` from another checkout (its kernels build into that
checkout's ``build/``), so two commits compare in one call on one card.

``--targets`` rewrites ``kMaxTargets`` (the most targets a thread of the
tiled sweep owns, ``csrc/common.cuh``) to 1, 2 and 4 in copies of
``csrc/`` under ``build/exp/targets_<R>/``, builds ``tiled.cu`` of each
(one nvcc each, all started together, registers printed) and times
Kernel A's C entry at tiles (32, 256), (64, 256) and (128, 256) at the
Kernel A shapes above.  ``--mxu-tiles`` times the mxu kernel at every
tile_i with tile_j 256, 512 and 1024 at N=16384 and 500 x 2000.
``--sym-targets`` rewrites ``kMaxSymTargets`` (the most targets a lane of
the pair-symmetric tile body owns; R is the cap wherever the block of 128
allows it) to 1, 2 and 4 in copies of ``csrc/`` under
``build/exp/sym_targets_<R>/``, builds ``sym.cu``, ``two_sided.cu`` and
``fused.cu`` of each (one nvcc each, all started together, registers
printed) and times their C entries: Kernel B at N = 2048, 4096, 8192 and
16384, the two-sided sweep at 512, 1024, 2048 and 4096 squared and 4096 x
2048 (device time, as above), and the fused rows block at N=2048 and
16384 (50 Euler steps), each line with the warps an SM the launch gives at
that R.  ``--vjp-tiles`` times the force VJP kernel
(``ops/vjp_kernel.py``) at tile_i 32, 64, 128 and 256 by tile_j 256, 512
and 1024 at N=16384 and 2048 (the cotangent: the naive accelerations
times 1e20), each line with the CTAs of its grid.  Needs a CUDA card
and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from typing import Callable

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


def device_ms(fn, reps: int = REPS) -> float:
    """Mean device milliseconds per call with the host out of the way:
    ``reps`` calls captured in one CUDA graph after one warm-up call, and
    the graph replayed between CUDA events.  ``fn`` must launch on the
    current stream and must not synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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
    sym_shapes(dev)


def _lane_targets(block: int):
    """R at ``block`` by the tree's ``sym_kernel.lane_targets``, or None
    for a tree from before R was a choice."""
    from nbody_tpu_torch.ops import sym_kernel

    rule = getattr(sym_kernel, "lane_targets", None)
    return rule(block) if rule else None


def sym_shapes(dev) -> None:
    """The pair-symmetric kernels at their paths' shapes."""
    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import fused_block, sym_kernel
    from nbody_tpu_torch.parallel import make_mesh
    from nbody_tpu_torch.parallel.decompose import shard_state

    for n, dist in ((16384, "float32"), (2048, "float32"),
                    (131072, "bfloat16")):
        st = make_state(n, device=dev)
        reps = REPS if n < 100000 else 3

        def call():
            sym_kernel.accelerations(st.pos, st.mass, dist_dtype=dist)

        emit(f"B {n} {dist}", time_ms(call, reps),
             device_ms=device_ms(call, reps),
             r=_lane_targets(sym_kernel.DEFAULT_BLOCK))
    big = make_state(16384, device=dev)
    sh, _ = shard_state(big, 4, make_mesh(4))
    small = make_state(2000, pad_multiple=128 * 4, device=dev)
    sh2, _ = shard_state(small, 4, make_mesh(4))
    for name, args in (
            ("two-sided 4096 x 4096", (sh.pos[0], sh.mass[0], sh.pos[1],
                                       sh.mass[1])),
            ("two-sided 4096 x 2048", (sh.pos[0], sh.mass[0],
                                       sh.pos[1][:, :2048].contiguous(),
                                       sh.mass[1][:2048].contiguous())),
            ("two-sided 512 x 512 (N=2000 over 4)",
             (sh2.pos[0], sh2.mass[0], sh2.pos[1], sh2.mass[1]))):
        def call():
            sym_kernel.accelerations_two_sided(*args)

        emit(name, time_ms(call), device_ms=device_ms(call),
             r=_lane_targets(sym_kernel.DEFAULT_BLOCK))
    for n in (2000, 16384):
        st = make_state(n, pad_multiple=128, device=dev)
        args = (st.pos, st.vel, st.mass, 0.1, 50)
        emit(f"fused rows N={n} (padded {st.n_padded}), 50 steps",
             time_ms(lambda: fused_block.fused_block(*args), reps=5),
             r=_lane_targets(sym_kernel.DEFAULT_BLOCK))


def build_copies(out_dir: str, consts: Callable[[int], dict], files: tuple,
                 fns: tuple) -> dict:
    """R cap -> (ctypes library of the csrc/ ``files`` built with each
    constant of ``consts(R)`` rewritten in a copy of csrc/common.cuh under
    ``out_dir`` + "_<R>", its register report), R = 1, 2, 4: one nvcc a
    copy, all started together; ``fns`` get their argument types."""
    from nbody_tpu_torch.utils import build

    common = (build.CSRC_DIR / "common.cuh").read_text()
    nvcc = build.find_nvcc()
    jobs = {}
    for cap in (1, 2, 4):
        text = common
        for name, value in consts(cap).items():
            text, n_sub = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
            if n_sub != 1:
                raise RuntimeError(f"csrc/common.cuh no longer declares "
                                   f"{name} once")
        out = f"{out_dir}_{cap}"
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "common.cuh"), "w") as f:
            f.write(text)
        cus = [os.path.join(out, name) for name in files]
        for name, cu in zip(files, cus):
            with open(cu, "w") as f:
                f.write((build.CSRC_DIR / name).read_text())
        so = os.path.join(out, "libexp.so")
        cmd = [nvcc, *build.NVCC_FLAGS, "-shared", "-o", so, *cus]
        jobs[cap] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    libs = {}
    for cap, (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {consts(cap)}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn in fns:
            getattr(lib, fn).argtypes = list(build.SIGNATURES[fn])
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line or "Compiling entry" in line]
        libs[cap] = (lib, regs)
    return libs


def targets(dev) -> None:
    import torch

    libs = build_copies(os.path.join(ROOT, "build", "exp", "targets"),
                        lambda cap: {"kMaxTargets": cap}, ("tiled.cu",),
                        ("nbt_tiled_accel", "nbt_tiled_targets"))
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


def sym_targets(dev) -> None:
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import sym_kernel

    libs = build_copies(
        os.path.join(ROOT, "build", "exp", "sym_targets"),
        lambda cap: {"kMaxSymTargets": cap},
        ("sym.cu", "two_sided.cu", "fused.cu"),
        ("nbt_sym_accel", "nbt_two_sided", "nbt_fused_rows"))
    for cap, (_, regs) in libs.items():
        for line in regs:
            print(f"kMaxSymTargets={cap}: {line}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    b = sym_kernel.DEFAULT_BLOCK

    def stream():  # the capturing stream inside device_ms
        return torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    big = make_state(16384, device=dev)
    for n in (2048, 4096, 8192, 16384):
        pos = big.pos[:, :n].contiguous()
        mass = big.mass[:n].contiguous()
        t = n // b
        part = torch.empty(sym_kernel.scratch_bytes(n, b) // 4, device=dev)
        out = torch.empty((3, n), device=dev)
        for cap, (lib, _) in libs.items():
            r = sym_kernel.lane_targets(b, cap)
            emit(f"B {n}", device_ms(lambda: check(lib.nbt_sym_accel(
                pos.data_ptr(), mass.data_ptr(), n, b, t, part.data_ptr(),
                out.data_ptr(), 0, stream()), "nbt_sym_accel")),
                max_targets=cap, r=r,
                warps_per_sm=t * (t + 1) / 2 * (b // (32 * r)) / sms)
    for nt, ns in ((512, 512), (1024, 1024), (2048, 2048), (4096, 2048),
                   (4096, 4096)):
        pt = big.pos[:, :nt].contiguous()
        mt = big.mass[:nt].contiguous()
        ps = big.pos[:, 8192:8192 + ns].contiguous()
        ms = big.mass[8192:8192 + ns].contiguous()
        n_part = 3 * nt * (ns // b)
        part = torch.empty(2 * n_part, device=dev)
        out_t = torch.empty((3, nt), device=dev)
        out_s = torch.empty((3, ns), device=dev)
        for cap, (lib, _) in libs.items():
            r = sym_kernel.lane_targets(b, cap)
            emit(f"two-sided {nt} x {ns}", device_ms(lambda: check(
                lib.nbt_two_sided(
                    pt.data_ptr(), mt.data_ptr(), nt, ps.data_ptr(),
                    ms.data_ptr(), ns, b, nt // b, part.data_ptr(),
                    part[n_part:].data_ptr(), out_t.data_ptr(),
                    out_s.data_ptr(), 0, stream()), "nbt_two_sided")),
                max_targets=cap, r=r,
                warps_per_sm=(nt // b) * (ns // b) * (b // (32 * r)) / sms)
    for n in (2048, 16384):
        st = make_state(n, device=dev)
        part = torch.empty(sym_kernel.scratch_bytes(n, b) // 4, device=dev)
        queue = torch.zeros(1, dtype=torch.int32, device=dev)
        for cap, (lib, _) in libs.items():
            pos, vel = st.pos.clone(), st.vel.clone()
            emit(f"fused rows N={n}, 50 steps", time_ms(lambda: check(
                lib.nbt_fused_rows(pos.data_ptr(), vel.data_ptr(),
                                   st.mass.data_ptr(), n, b, part.data_ptr(),
                                   queue.data_ptr(), 50, 0.1, 0.05, 0,
                                   stream()),
                "nbt_fused_rows"), reps=5),
                max_targets=cap, r=sym_kernel.lane_targets(b, cap))


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


def vjp_tiles(dev) -> None:
    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import naive, vjp_kernel

    for n in (16384, 2048):
        st = make_state(n, device=dev)
        g = naive.accelerations(st.pos, st.mass) * 1e20
        for ti in (32, 64, 128, 256):
            for tj in (256, 512, 1024):
                emit(f"vjp {n} tiles {ti}x{tj}", time_ms(
                    lambda: vjp_kernel.force_vjp(st.pos, st.mass, g, ti, tj)),
                     ctas=-(-n // ti))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout whose nbody_tpu_torch to time")
    ap.add_argument("--targets", action="store_true",
                    help="Kernel A at kMaxTargets 1, 2, 4")
    ap.add_argument("--mxu-tiles", action="store_true",
                    help="the mxu kernel at every tile")
    ap.add_argument("--sym-targets", action="store_true",
                    help="the pair-symmetric kernels at R = 1, 2, 4")
    ap.add_argument("--vjp-tiles", action="store_true",
                    help="the force VJP kernel at every tile")
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
    elif args.sym_targets:
        sym_targets(dev)
    elif args.vjp_tiles:
        vjp_tiles(dev)
    else:
        wrappers(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
