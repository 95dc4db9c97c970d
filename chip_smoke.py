#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nbody_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing what it found; any failure exits non-zero:

1. The card: CUDA must be available; prints ``nvidia-smi``'s name and
   power limit.
2. The build: compiles ``nbody_tpu_torch/csrc/*.cu`` with nvcc (sm_90a)
   and prints the seconds it took and the compiler's register report.
3. Kernels against their plain PyTorch versions on the card, at N=2048,
   N=16384 and N=2000 padded to 2048: relative-norm error <= 1e-5, padded
   particles get exactly 0 from the pair-symmetric kernel, and padded
   sources add exactly nothing in the tiled kernel.  Then the tiled kernel
   at counts that are no multiple of its tiles, N=300, 1000 and 2000
   unpadded and one of 4 shards of N=2000 against all sources (500 x 2000)
   and against one shard (500 x 500): <= 1e-5, two launches bit for bit.
   Then the pair-symmetric kernel at shapes that give a lane each number
   of targets R its launcher picks (R = 1 at block 32, 2 at 64 and 128:
   N=2048, 8192, 16384 in blocks of 128, N=16384 in blocks of 64, N=4096
   in blocks of 32, each zero-mass padded): <= 1e-5, bit for bit over two
   launches, padding exactly 0, and every R seen.
4. The main path: ``run(SimConfig(n=2000, nsteps=500))`` with ``auto``
   (must launch the pair-symmetric kernel and not the tiled one) and with
   ``kernel="pallas"`` (the tiled kernel); both kinetic-energy traces must
   equal tests/golden/ver0_n2000_s500.txt at %.5g in all 10 rows.  The
   launch counters are zeroed just before and read just after each run.
5. The numbers: N=16384 for 500 steps with ``auto`` (GFLOP/s under the
   reference's 29N^2+19N model, mean +- dev over blocks 3..10) and the
   per-sweep time of both kernels, their plain versions and ``naive`` at
   N=16384, timed with CUDA events.
6. The fused blocks against their plain versions, at N=2048 and N=2000
   padded to 2048: both layouts, Euler and leapfrog, one 50-step block;
   relative-norm error of pos and vel <= 1e-5, padded particles keep
   exactly zero velocity in the rows layout (below 1e-9 in the columns
   layout, whose one-sided sweep pulls a zero-mass target as JAX's does),
   and two launches on one input agree bit for bit.
   An Euler block of each layout must equal the unfused block over Kernel
   B (rows) or A (columns) bit for bit: each runs its unfused kernel's
   source loop.
7. The fused main path: ``run(SimConfig(n=2000, nsteps=500, fused=True))``
   (rows) and with ``tile_i=64, tile_j=256`` (columns); both traces must
   equal the golden trace, and each run must launch the fused kernel 11
   times (10 blocks and the warm-up) and the unfused kernels never.  One
   leapfrog run must give finite, positive energies.
8. The fused numbers: N=2000 and N=16384 for 500 steps with ``fused=True``
   beside the unfused ``auto`` figures above; the N=16384 run must launch
   the rows kernel 11 times and the unfused kernels never.  At N=16384,
   where the rows kernel's CTAs each take many of the 8256 tile pairs,
   one 50-step Euler block of each layout is held against its plain
   version (relative-norm error <= 1e-5) and must repeat bit for bit, and
   the rows block must equal the unfused block over Kernel B bit for bit
   (both at block 128, R = 2); then the per-block time of each fused
   kernel and of its plain version (CUDA events).
9. The force VJP kernel against its plain version, at N=2048, N=16384 and
   N=2000 unpadded, with the cotangent g = naive accelerations * 1e20:
   relative-norm error of d_pos and d_mass <= 2e-5 (printed beside both
   against a float64 plain sweep); N=2000 padded to 2048 with a zero
   cotangent on the padding must give the real particles exactly the
   unpadded result; two launches must repeat bit for bit; each forward
   kernel must refuse inputs that require grad.  Then the per-call time of
   the kernel and of its plain version at N=16384 (CUDA events).
10. The differentiable rollout at N=16384: ``make_accel_fn("auto",
    differentiable=True)``, 10 Euler steps, remat on; the gradients of
    sum((p_final - target)^2) with respect to vel and mass must agree with
    the plain backward (``backward="jnp"``) to 1e-4 relative norm and with
    ``remat=False`` bit for bit, and the run must launch the VJP kernel 10
    times, Kernel B 20 times (forward and recompute) and Kernel A never.
    The time of one forward plus backward (CUDA events).  Then
    ``examples.fit_velocities`` at N=2048, 10 steps, 60 iterations must
    recover the velocities (exit 0) and prints its seconds per iteration.
11. ``--energy-check``: N=2000/500 with ``energy_check=True`` keeps the
    golden trace and prints a finite drift; the Plummer run of
    tests/test_distributions.py (N=512, 100 leapfrog steps, dt 0.01, seed
    7) through ``auto`` must drift below 1e-4; N=16384 ``auto`` prints its
    drift beside its GFLOP/s.
12. The P3M short-range kernel against its plain version on the Plummer
    sphere of the JAX package's gate (N=262144, seed 7, ng=128, cutoff 4)
    at the plan suggested for each layout name (``xla`` runs the kernel in
    its plain layout; the card's default is ``pallas_paired``): occupied
    slots agree within 2e-5 of the largest; a 4-way split of the entry
    bounds sums to the full sweep (rtol 1e-6, atol 2e-6 of the largest);
    the layouts without a reaction repeat bit for bit, the symmetric ones
    within 1e-6 relative norm on the occupied slots.  The per-call time of
    kernel and plain version (CUDA events) with the entry count, and the
    share of the kernel's (warp, source) steps that its warp-uniform skip
    takes (``sr_kernel.skip_counts``, counted on the card).
13. The P3M path: the port's ``pm`` and ``p3m`` at Plummer N=16384 against
    the JAX package's accelerations in
    tests/golden/torch_p3m_plummer_n16384.npz (1e-4 relative norm); at
    N=262144 both against the exact forces of Kernel B, at the suggested
    plan (whose capacity cap lets the core overflow to mesh-quality forces)
    and at a capacity with no overflow, where the p3m error must be at
    least 5x below pm's (tests/test_p3m.py's check); then
    ``run(SimConfig(n=262144, nsteps=16, sfreq=8, kernel="p3m",
    distribution="plummer", seed=7))`` must give finite energies, launch the
    short-range kernel 24 times (16 steps and the 8-step warm-up) and no
    other kernel, and prints its ms per step.
14. ``kernel="p3m"`` and ``kernel="pm"`` at N=1048576 on the reference
    initial conditions, 8 steps, sfreq 4: finite energies, ms per step and
    the short-range kernel's launches (12 and 0), the deposit kernel's
    (at least 12: one a force call, and one more a step in which a body
    overflows its cell) and the far field's target kernel's (12: one a
    force call).
15. The particle decomposition's kernels against their plain versions: the
    two-sided sweep at Nt = Ns = 4096 and at 4096 x 2048, and at shapes
    from 512 x 512 to 16384 x 8192 in blocks of 128 (R = 2) and 1024 x 512
    in blocks of 32 (R = 1), both sets zero-mass padded (relative-norm
    error of both sides <= 1e-5, padding exactly 0 on both sides, two
    launches bit for bit, every R seen); the ring kernel at
    N=16384 with K = 2, 3, 4, 8 (padded with zero mass to a multiple of
    64 K) and at N=131072 with K=8, where a CTA owns several target tiles
    (<= 1e-5 against the plain ring and against Kernel B on the whole
    state; bit for bit over two launches).
    Then per-call times at N=16384, K=4 (CUDA events): both kernels at the
    shapes ``ring_sym`` and ``rdma`` give them, their plain versions, and
    Kernels A and B on the whole state; the two-sided sweep's wrapper call
    takes longer on the host than its kernels on the card, so the device
    time of 20 calls captured in a CUDA graph and replayed is printed
    beside it (``device_ms`` of its ``kernels`` row).
16. The sharded main path: ``run(SimConfig(n=2000, nsteps=500, shards=4,
    comm=c))`` for each comm mode, and ``ring_sym`` and ``rdma`` at
    ``shards=3`` (no antipodal hop; N pads to 2304): every trace equals
    the golden trace at %.5g, and the launch counters, zeroed before each
    run, equal the counts the mode implies over 550 steps (500 and the
    warm-up): ``allgather`` K Kernel A launches a step, ``ring`` K^2,
    ``ring_sym`` K Kernel B and K floor((K-1)/2) (+ K/2 for even K)
    two-sided, ``rdma`` one ring launch and nothing else.  One leapfrog run
    per mode gives finite, positive energies.
17. The sharded numbers: N=16384, 500 steps, ``shards=4`` in each mode and
    ``shards=8`` for ``ring_sym`` and ``rdma``, GFLOP/s beside the
    single-device ``auto`` figure of phase 5.  Virtual shards on one card
    move no bytes over a link.
18. The scratch repair: one Kernel B call at N=1048576 (reference initial
    conditions, block 128), whose 103 GB of partials are swept in bands
    within 1/8 of the card's memory: prints the bands and
    ``torch.cuda.max_memory_allocated``, must agree with Kernel A on the
    same state within 1e-5 relative norm and repeat bit for bit.  Then
    banded sweeps under a lowered budget against the one-band sweep, bit
    for bit: Kernel B at N=16384 and the two-sided sweep at 4096 x 4096.
19. ``pallas_mxu``: the mxu kernel against its plain version at N=2048,
    N=16384 and N=2000 unpadded (<= 1e-5 relative norm) and at the ragged
    N=1000 and 300 (<= 5e-5: below N=2000 the expansion's own error is
    that large), against naive and a float64 sweep (L2 < 1e-4, the JAX
    package's bound); two launches repeat bit for bit; the unpadded N=2000
    sweep gives the real targets exactly what the sweep padded to 2048
    gives; it refuses inputs that require grad; the between form at one
    shard's shapes of N=2000 over 4 shards, 500 x 2000 (``allgather``) and
    500 x 500 (``ring``), within 1e-5 of its plain version; each shape
    prints its error against plain, naive and float64.
    ``run(SimConfig(n=2000, nsteps=500, kernel="pallas_mxu"))`` must
    launch it 550 times and no other kernel,
    with every kinetic-energy row within 1e-4 of the golden trace (printing
    how many are equal at %.5g); the same at ``shards=4`` with
    ``allgather`` (4 launches a step) and ``ring`` (16).  N=16384 for 500
    steps prints its GFLOP/s beside ``auto``'s, and the per-call time of
    the kernel, its plain version and Kernel A at N=16384 (CUDA events).
20. bf16: Kernels A and B at N=16384 and N=131072 and the two-sided sweep
    at 4096 x 4096 with bf16-rounded deltas against their bf16 plain
    versions (<= 1e-5), bit for bit over two launches, momentum conserved
    in Kernel B's result, and their per-call times at N=16384 (the
    two-sided sweep's device time beside, as in phase 15);
    ``run(SimConfig(n=131072, nsteps=100, sfreq=10, precision="bf16"))``
    through ``auto`` (Kernel B) and ``kernel="pallas"``: each launches its
    kernel 110 times (100 steps and the 10-step warm-up) and the other
    kernel never, every kinetic-energy row differs from the f32 run of the
    same configuration and lies within 1e-4 of it; GFLOP/s of both
    precisions.  Then N=2000/500 at ``shards=4, comm="ring_sym"`` in bf16
    beside f32: 2200 Kernel B and 3300 two-sided launches in each, no other
    kernel, and the same gate on the kinetic-energy rows.

21. The periodic boundary (``pm_boundary="periodic"``, ``pm_box`` L = 1,
    ng=128, cutoff 4): (a) the P3M short-range kernel against its plain
    version on the ghost-extended tables of the reference initial
    conditions at N=1048576 and of a Gaussian blob wrapped round a box
    corner (sigma 0.06, N=262144, seed 5), at the suggested plan in the
    ``pallas_paired`` and ``pallas`` layouts (and at N=1048576 also at the
    default ghost cap, 2N rounded up to a power of two): occupied slots
    within 2e-5 of the largest, two launches bit for bit; prints the
    ghosts, slots, scratch, entries, the per-call time of kernel and plain
    version and the skipped share.  (b) Periodic ``pm`` and ``p3m`` at
    N=16384 on both states against the JAX package's accelerations in
    tests/golden/torch_periodic_n16384.npz (1e-4 relative norm).  (c)
    Against a numpy copy of the fp64 k-space sum: ``pm`` at 16 bodies
    (ng=32 < 7e-2, ng=64 < 1.5e-2) and ``p3m`` on a corner blob of 96
    (2.5e-2 and 1.5e-2, and under a third of ``pm``'s).  (d) The spectra's
    one-off build time, then ``run(SimConfig(n=1048576, nsteps=8, sfreq=4,
    kernel=k, pm_boundary="periodic", pm_box=1.0))`` for ``p3m`` (12
    short-range launches, no other kernel) and ``pm`` (none), finite
    energies and ms per step, and the periodic energy check of
    tests/test_torch_periodic.py (N=512, 100 steps, ng=32, L=8): drift
    below 5e-2.

22. Differentiable P3M (``differentiable=True``), open and periodic, at
    the P3M gate's state and plan (``suggest_sr_plan(...,
    differentiable=True)``: the unpaired worklist that runs).  (a) The
    short-range sweep's VJP kernel (``csrc/sr_vjp.cu``) against its plain
    version in ``pallas`` and ``pallas_sym`` with a seeded cotangent: gp
    and gm within 1e-5 of each one's largest, grc2 within 1e-4 relative,
    two launches bit for bit; per-call times of both (CUDA events), the
    peak memory of a kernel call, the pairs inside the cutoff, which the
    bound counts, and the share of (warp, other) steps each of the kernel's
    two passes skips (``sr_kernel.vjp_skip_counts``).  (b) The forward of
    ``pm.accelerations(..., differentiable=True)`` equals the
    non-differentiable call in the pinned ``pallas`` layout bit for bit.
    (c) The gradient of mean(|a|^2) through ``make_accel_fn("p3m",
    differentiable=True)`` with the kernel backward against the plain
    backward (``sr_kernel.sweep_vjp`` swapped for ``sweep_vjp_plain``),
    within 1e-4 of the largest; against the JAX package's gradients in
    tests/golden/torch_p3m_grad_n16384.npz (periodic within 1e-4 of the
    largest; open within 1e-4 relative norm, tests/test_torch_p3m_grad.py
    says why).  (d) A 10-step Euler rollout gradient (dt 0.01) through
    ``make_rollout_fn``: which of the mesh's indexing ops repeat bit for
    bit, with and without PyTorch's deterministic mode (the deposit off
    autograd is the fixed-point kernel, under autograd ``_scatter``'s
    ``index_put_``); remat against no
    remat within 1e-4 of the largest (the CIC gather's backward,
    ``index_add_``, adds with atomics in no fixed order), and bit for bit
    under ``torch.use_deterministic_algorithms(True)``; the forward and
    VJP launches of the main path (20 and 10 with remat, 10 and 10
    without), ms per rollout gradient.  (e) ``bench.py:48-49``'s periodic row
    (reference ICs, N=1048576, L = 1, ng=128): the VJP kernel against its
    plain version on the ghost-extended tables as in (a), one finite,
    non-zero gradient of mean(|a|^2), ms of its forward and backward.  (f)
    ``examples.fit_velocities 128 10 40 p3m`` exits 0 and its velocity
    error falls.

23. The CIC deposit kernel (``csrc/deposit.cu``, 64-bit fixed point) at
    ng=128 on the reference initial conditions at N=1048576 and the Plummer
    sphere of the P3M gate (N=262144), open (the solver's box and in-box
    masses) and periodic (L = 1): equal to ``deposit_plain`` bit for bit,
    two launches bit for bit, within 1e-6 relative norm of ``_scatter``'s
    grid; the per-call time of the kernel, its plain version and
    ``_scatter`` (the accumulating ``index_put_`` it replaces off autograd:
    the row's ``library_ms``), against the bound (16 B a body read, the
    grid written).
24. The open far field's kernels (``csrc/far_field.cu``) at the solver's
    box and in-box masses, on the reference initial conditions at
    N=1048576 (every body inside the box) and the Plummer sphere of the
    P3M gate (N=262144, bodies outside it), same-set: the moments table
    within one float32 ulp of ``moments_plain``'s and the target pass
    equal to the nine-call chain given that table bit for bit, the whole
    far field equal to the chain's bit for bit at N=1048576, two calls
    bit for bit; the per-call time of the two kernels (wrapper calls, and
    device time alone from a CUDA graph), of ``far_field_plain`` and of
    the nine-call chain that they replace off autograd (the row's
    ``library_ms``), against the bound (20 B a source read, 28 B a target
    read and 12 B written).

Each phase's seconds are printed after it.

The last lines are the card's name and power limit, a JSON object of the
kernels with their bounds, and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden", "ver0_n2000_s500.txt")
MESH_FIXTURE = os.path.join(ROOT, "tests", "golden",
                            "torch_p3m_plummer_n16384.npz")
REL_TOL = 1e-5  # fp32, different summation order: relative-norm error bound
# The force VJP: JAX's bound between its kernel and its plain sweep
# (tests/test_grad.py), and between the kernel and plain backward of a
# rollout (the analytic VJP against autodiff, the same file).
VJP_TOL = 2e-5
ROLLOUT_TOL = 1e-4
G_SCALE = 1e20  # cotangent scale: brings reference-scale a^2 into fp32 range
TIME_REPS = 20
BLOCK = 50  # steps of a sample block
# The fused layouts: (label, tile_i, tile_j); rows take the default block.
FUSED = (("rows", 0, 0), ("columns", 64, 256))
# The P3M short-range sweep: tests/test_p3m.py's bound between the Pallas
# and the plain sweep, as a share of the largest occupied slot; the mesh
# tiers against the JAX package's accelerations (relative norm).
SR_TOL = 2e-5
MESH_TOL = 1e-4
P3M_GATE = dict(n=262144, seed=7, grid=128, cutoff=4)  # bench.py:102-103
N_UNIFORM = 1048576  # the suite's N=1M rows, bench.py:46-47
# The periodic boundary: bench.py:48-49's periodic row (the reference ICs
# boxed at L = 1) at ng=128, cutoff 4, and tests/test_p3m.py's corner blob.
PERIODIC = dict(grid=128, cutoff=4, box=1.0, blob_n=262144, blob_seed=5)
PERIODIC_FIXTURE = os.path.join(ROOT, "tests", "golden",
                                "torch_periodic_n16384.npz")
COMM_MODES = ("allgather", "ring", "ring_sym", "rdma")
# Shapes that give the pair-symmetric tile body each R its launchers pick
# (nbt::sym_targets: 2 where the block is a multiple of 64, else 1): Kernel
# B at (N, block), the two-sided sweep at (Nt, Ns, block), each zero-mass
# padded from a few bodies fewer.
SYM_SHAPES = ((2048, 128), (8192, 128), (16384, 128), (16384, 64),
              (4096, 32))
TWO_SIDED_SHAPES = ((512, 512, 128), (4096, 2048, 128), (4096, 4096, 128),
                    (16384, 8192, 128), (1024, 512, 32))
RING_TILE = 64  # the ring kernel's default tile_i: shards pad to 64 K

# The least time the card could take: the larger of the operations over the
# H100 SXM's fp32 rate outside the tensor cores (NVIDIA's data sheet) and
# the bytes (each input read once, each output written once) over its
# memory rate.  fp32 operations per pair evaluation, counted from each
# kernel's pair arithmetic (sqrt, divide and rsqrt count one, an FMA two):
FP32_RATE = 67e12
HBM_RATE = 3.35e12
OPS_SYM = 27  # per unordered pair: 3 sub, 6 for |d|^2 + eps^2, sqrt,
# divide, 2 cube, 2 mass, 3 FMA each side
OPS_VJP = 45  # the force VJP's pair arithmetic, sqrt and divide one each
OPS_SR = 31  # 3 sub, 5 |d|^2, eps, rsqrt, 3 clamp, 7 taper, 4 weight, 1 mass, 3 FMA
OPS_SR_REACTION = 7  # the symmetric layouts: target mass, 3 products, 3 adds
# The short-range sweep's VJP: a pair beyond the cutoff costs its distance
# test (3 sub, 5 |d|^2, 1 q, 1 compare); one inside it, both sides once, 58
# more: eps, rsqrt, u^2, u^3, the taper 8, S' 4, w, w' 5, k 2, h 3, h.d 5,
# 2 w' h.d 2, V 9, gp both sides 6, gm_j 7, grc2 2; the reaction (pallas_sym
# off the diagonal) 13 more: h 6, gm_i 7.
OPS_SR_TEST = 10
OPS_SR_VJP = 68
OPS_SR_VJP_REACTION = 13
# The CIC deposit a body: 9 an axis (sub, mul, two clamps, floor, sub, two
# clamps, 1 - frac), 4 products wx wy, 8 by wz, 8 by m.  Its bytes: x, y, z
# and m read, the ng^3 fp32 grid written.
OPS_DEPOSIT = 47
# The far field: a source's moments 8 (the out-of-box mass, 3 compares, 4
# for its group), a target's 9 monopoles at 21 each (3 sub, 5 |d|^2 + eps^2,
# rsqrt, 2 cube, 6 products, 3 adds).  Its bytes: a source's x, y, z, mass
# and in-box mass read, a target's x, y, z, mask and acc read, acc written.
OPS_FAR_FIELD_SOURCE = 8
OPS_FAR_FIELD_TARGET = 189
# The VJP kernel against its plain version: gp and gm as a share of each
# one's largest (fp32 sums in other orders, rsqrt with a Newton step), grc2
# relative (a sum over every pair); the full and rollout gradients, the
# kernel backward against the plain one and against the JAX package's.
SR_VJP_TOL = 1e-5
SR_VJP_RC2_TOL = 1e-4
GRAD_TOL = 1e-4
GRAD_FIXTURE = os.path.join(ROOT, "tests", "golden",
                            "torch_p3m_grad_n16384.npz")
# The mxu kernel's function at its least work: both K=8 products of the
# |r|^2 expansion on the tensor cores with a 3xTF32 split, 3 x (16 + 16)
# flops a pair at the H100 SXM's TF32 rate (NVIDIA's data sheet), and the
# rest on the fp32 pipes: the clamp, sqrt, divide, two for the cube and one
# for G m.
TF32_RATE = 495e12
OPS_MXU_TENSOR = 3 * (16 + 16)
OPS_MXU_FP32 = 6
MXU_TOL = 1e-4  # tests/test_kernels.py:133-143, against naive and float64
# The mxu kernel against its plain version below N=2000, where the
# expansion's own error from float64 is above 1e-5 (tests/test_torch_mxu.py,
# tests/test_torch_cuda.py).
MXU_SMALL_TOL = 5e-5


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) for ``ops`` fp32 operations and ``nbytes``."""
    t_ops, t_bytes = ops / FP32_RATE * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bound_mxu(pairs: float, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of the mxu function over ``pairs`` ordered
    pairs: the largest of its tensor-core time, its fp32 time and its
    bytes' time."""
    t_ops = max(OPS_MXU_TENSOR * pairs / TF32_RATE,
                OPS_MXU_FP32 * pairs / FP32_RATE) * 1e3
    t_bytes = nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


class Laps:
    """Prints the seconds since the last call (or since it was made)."""

    def __init__(self):
        self.t = time.perf_counter()

    def __call__(self, phases: str) -> None:
        now = time.perf_counter()
        print(f"phase {phases}: {now - self.t:.1f} s", flush=True)
        self.t = now


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi failed ({proc.returncode}): {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def rel_err(got, ref) -> float:
    """Relative-norm error, in float64: the VJP's cotangents, scaled by
    G_SCALE, overflow a float32 sum of squares."""
    got, ref = got.double(), ref.double()
    return float((got - ref).norm() / ref.norm())


def time_ms(fn, reps: int = TIME_REPS) -> float:
    """Mean milliseconds per call, from CUDA events around ``reps`` calls
    after one warm-up call: the card's time, or the host's where its
    wrapper calls take longer than their kernels."""
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


def every_targets() -> set:
    """Every R a launcher of the pair-symmetric tile body picks, over the
    blocks its wrappers take."""
    from nbody_tpu_torch.ops import sym_kernel

    return {sym_kernel.lane_targets(b)
            for b in range(32, sym_kernel.MAX_BLOCK + 1, 32)}


def device_ms(fn, reps: int = TIME_REPS) -> float:
    """Mean device milliseconds per call with the host out of the way:
    ``reps`` calls captured in one CUDA graph after one warm-up call, the
    graph replayed between CUDA events (for a kernel whose wrapper call
    takes longer on the host than the kernel on the card)."""
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


def mesh_phases(dev, tag: str, err: dict, ms: dict, launches: dict) -> dict:
    """Phases 12-14; fills ``err``, ``ms`` and ``launches`` and returns the
    short-range kernel's figures per layout name."""
    import numpy as np
    import torch

    from nbody_tpu_torch import SimConfig, run
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.ops import (
        deposit_kernel,
        far_field_kernel,
        fused_block,
        pm,
        sr_kernel,
        sym_kernel,
        tiled_kernel,
        vjp_kernel,
    )
    from nbody_tpu_torch.utils import spans

    # 12. The P3M short-range kernel against its plain version.
    gate = P3M_GATE
    n = gate["n"]
    pos_np, _, mass_np = distributions.plummer(n, seed=gate["seed"])
    p = torch.tensor(pos_np, device=dev)
    m = torch.tensor(mass_np, device=dev)
    ng, cutoff = gate["grid"], gate["cutoff"]
    err["sr"] = 0.0
    sr = {}  # layout -> (entries run, width, symmetric, kernel ms, plain ms)
    for layout, (sym, paired) in pm.SR_LAYOUTS.items():
        plan = pm.suggest_sr_plan(p, m, ng, cutoff, layout=layout)
        pk = pm.sr_pack_inputs(p, m, grid=ng, cutoff_cells=cutoff,
                               symmetric=sym, paired=paired, **plan)
        n_e = int(pk["n_e"])
        if n_e > pk["e_max"]:
            fail(f"sr {layout}: the suggested plan drops entries")
        kw = dict(symmetric=sym, paired=paired)
        tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
        bounds = torch.tensor([0, n_e], dtype=torch.int32, device=dev)
        got = sr_kernel.sweep(*tabs, bounds, pk["rc2"], **kw)
        again = sr_kernel.sweep(*tabs, bounds, pk["rc2"], **kw)
        per = -(-n_e // 4)
        parts = sum(sr_kernel.sweep(
            *tabs, torch.tensor([i * per, min((i + 1) * per, n_e)],
                                dtype=torch.int32, device=dev),
            pk["rc2"], **kw) for i in range(4))
        plain = sr_kernel.sweep_plain(*tabs, bounds, pk["rc2"], **kw)
        torch.cuda.synchronize()
        occ = pk["mtab"] > 0
        scale = float(plain[:, occ].abs().max())
        diff = float((got - plain)[:, occ].abs().max())
        rep = rel_err(again[:, occ], got[:, occ])
        # tests/test_p3m.py's bound for a split: rtol 1e-6, atol 2e-6 * scale.
        split = float(((parts - got).abs() - 1e-6 * got.abs())[:, occ].max())
        err["sr"] = max(err["sr"], diff)
        print(f"sr {layout} N={n}: {n_e} entries of {pk['e_max']}; kernel vs "
              f"plain {diff / scale:.3e} of the largest occupied slot; "
              f"repeat {rep:.3e} (relative norm); 4-way bounds split "
              f"{split / scale:.3e}",
              flush=True)
        if not torch.isfinite(got).all():
            fail(f"sr {layout}: non-finite output")
        if diff > SR_TOL * scale:
            fail(f"sr {layout}: kernel disagrees with its plain version")
        if rep > 1e-6 if sym else not torch.equal(got, again):
            fail(f"sr {layout}: two launches differ")
        if split > 2e-6 * scale:
            fail(f"sr {layout}: the bounds split does not sum to the sweep")
        del got, again, parts, plain
        ms_k = time_ms(lambda: sr_kernel.sweep(*tabs, bounds, pk["rc2"], **kw),
                       reps=10)
        ms_p = time_ms(lambda: sr_kernel.sweep_plain(*tabs, bounds, pk["rc2"],
                                                     **kw), reps=1)
        width = 2 * pm.SLAB if paired else pm.SLAB
        work = sr_kernel.skip_counts(*tabs, bounds, pk["rc2"], chunk=2048,
                                     **kw)
        skip = work["skipped"] / work["steps"]
        sr[layout] = (n_e, width, sym, ms_k, ms_p, pk["ptab"].shape[1], skip)
        print(f"sr {layout} N={n}: kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms "
              f"per call; {n_e * pm.SLAB * width / ms_k / 1e6:.1f} Gpairs/s; "
              f"(warp, source) steps skipped {skip:.4f} of {work['steps']}, "
              f"pairs inside the cutoff {work['inside'] / work['pairs']:.4f} "
              f"{tag}", flush=True)
        del pk, tabs

    # 13. The P3M path.
    fx = np.load(MESH_FIXTURE)
    pos16, _, mass16 = distributions.plummer(int(fx["n"]), seed=int(fx["seed"]))
    digest = hashlib.sha256(pos16.tobytes() + mass16.tobytes()).hexdigest()
    if digest != str(fx["digest"]):
        fail("the Plummer N=16384 state differs from the fixture's")
    p16, m16 = (torch.tensor(a, device=dev) for a in (pos16, mass16))
    r_pm = rel_err(pm.accelerations(p16, m16, grid=int(fx["grid"])).cpu(),
                   torch.tensor(fx["pm"]))
    plan16 = pm.suggest_sr_plan(p16, m16, int(fx["grid"]), int(fx["cutoff"]),
                                capacity=int(fx["capacity"]))
    r_p3m = rel_err(pm.p3m_accelerations(p16, m16, grid=int(fx["grid"]),
                                         **plan16).cpu(),
                    torch.tensor(fx["p3m"]))
    print(f"mesh N=16384 plummer vs the JAX fixture: pm {r_pm:.3e}, p3m "
          f"{r_p3m:.3e} (relative norm)", flush=True)
    if max(r_pm, r_p3m) > MESH_TOL:
        fail("the mesh tiers disagree with the JAX package's accelerations")
    ref = sym_kernel.accelerations(p, m)  # exact, Kernel B
    e_pm = rel_err(pm.accelerations(p, m, grid=ng), ref)
    # The suggested plan caps the cell capacity at 2048, and the Plummer
    # core overflows it; a capacity over the largest cell's occupancy
    # serves every pair exactly, which the accuracy check needs.
    full_cap = pm.suggest_capacity(p, m, ng, cutoff, max_capacity=1 << 20)
    e_p3m = {}
    for label, cap in (("suggested plan", 0), ("no overflow", full_cap)):
        plan = pm.suggest_sr_plan(p, m, ng, cutoff, capacity=cap)
        over = float(pm.cell_overflow_fraction(p, m, ng, cutoff,
                                                plan["capacity"]))
        e_p3m[label] = rel_err(pm.p3m_accelerations(p, m, grid=ng, **plan),
                               ref)
        print(f"mesh N={n} plummer vs exact (Kernel B), {label} {plan}, "
              f"cell overflow {over:.4f}: pm {e_pm:.4e}, p3m "
              f"{e_p3m[label]:.4e} (relative L2), ratio "
              f"{e_pm / e_p3m[label]:.2f}", flush=True)
    if not e_p3m["no overflow"] * 5 <= e_pm:
        fail("the p3m force error is not 5x below pm's")
    del ref
    counters = (sr_kernel, tiled_kernel, sym_kernel, fused_block, vjp_kernel)
    for mod in counters:
        mod.launches = 0
    syncs = spans.counts["host_syncs"]
    res = run(SimConfig(n=n, nsteps=16, sfreq=8, kernel="p3m",
                        distribution="plummer", seed=gate["seed"]), quiet=True)
    counts = tuple(mod.launches for mod in counters)
    syncs = spans.counts["host_syncs"] - syncs
    launches["sr"] = counts[0]
    kes = [ke for _, ke in res.kenergy_trace]
    step_ms = [1e3 * b / 8 for (_, _, _, b, _) in res.samples]
    print(f"p3m run N={n} plummer, 16 steps: sr/tiled/sym/fused/vjp launches "
          f"{counts}, {syncs} host syncs; ms per step "
          f"{', '.join(f'{t:.3f}' for t in step_ms)}; energies "
          f"{', '.join(f'{k:.6g}' for k in kes)} {tag}", flush=True)
    if counts != (24, 0, 0, 0, 0):
        fail(f"p3m run launches {counts} != (24, 0, 0, 0, 0)")
    if len(kes) != 2 or not all(math.isfinite(k) and k > 0 for k in kes):
        fail(f"p3m run energies not finite and positive: {kes}")

    # 14. The uniform and mesh-only rows.
    for kernel, want in (("p3m", 12), ("pm", 0)):
        for mod in (*counters, deposit_kernel, far_field_kernel):
            mod.launches = 0
        res = run(SimConfig(n=N_UNIFORM, nsteps=8, sfreq=4, kernel=kernel),
                  quiet=True)
        counts = tuple(mod.launches for mod in counters)
        launches[f"deposit_{kernel}"] = deposit_kernel.launches
        launches[f"far_field_{kernel}"] = far_field_kernel.launches
        kes = [ke for _, ke in res.kenergy_trace]
        step_ms = [1e3 * b / 4 for (_, _, _, b, _) in res.samples]
        print(f"{kernel} run N={N_UNIFORM} reference, 8 steps: sr/tiled/sym/"
              f"fused/vjp launches {counts}, deposit launches "
              f"{deposit_kernel.launches}, far-field launches "
              f"{far_field_kernel.launches}; ms per step "
              f"{', '.join(f'{t:.3f}' for t in step_ms)} {tag}", flush=True)
        if counts != (want, 0, 0, 0, 0):
            fail(f"{kernel} N={N_UNIFORM} launches {counts}")
        if far_field_kernel.launches != 12:
            fail(f"{kernel} N={N_UNIFORM}: {far_field_kernel.launches} "
                 "far-field launches, not one a force call")
        if deposit_kernel.launches < 12:  # a step that overflows adds one
            fail(f"{kernel} N={N_UNIFORM}: {deposit_kernel.launches} deposit "
                 "launches, fewer than one a force call")
        if len(kes) != 2 or not all(math.isfinite(k) and k > 0 for k in kes):
            fail(f"{kernel} N={N_UNIFORM} energies not finite and positive: "
                 f"{kes}")
    return sr


def sharded_phases(dev, tag: str, err: dict, ms: dict, launches: dict,
                   golden: list, gf: dict) -> None:
    """Phases 15-17; fills ``err``, ``ms`` and ``launches``."""
    import torch

    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.ops import sym_kernel, tiled_kernel
    from nbody_tpu_torch.parallel import make_mesh, ring_kernel
    from nbody_tpu_torch.parallel.decompose import shard_state
    from nbody_tpu_torch.utils.reporting import _g5

    # 15. The kernels against their plain versions, the two-sided sweep at
    # every R its launcher picks.
    err["two_sided"] = err["ring"] = 0.0
    seen = set()
    shapes = ((4096, 4096, 4000, 4096, 128), (3000, 4096, 1000, 2048, 128))
    shapes += tuple((nt - 40, nt, ns - 24, ns, blk)
                    for nt, ns, blk in TWO_SIDED_SHAPES)
    for nt_real, nt, ns_real, ns, blk in shapes:
        r = sym_kernel.lane_targets(blk)
        seen.add(r)
        a = make_state(nt_real, pad_multiple=nt, seed=1, device=dev)
        b = make_state(ns_real, pad_multiple=ns, seed=2, device=dev)
        args = (a.pos, a.mass, b.pos, b.mass)
        got = sym_kernel.accelerations_two_sided(*args, block=blk)
        again = sym_kernel.accelerations_two_sided(*args, block=blk)
        plain = sym_kernel.accelerations_two_sided_plain(*args, block=blk)
        torch.cuda.synchronize()
        rel = [rel_err(x, y) for x, y in zip(got, plain)]
        err["two_sided"] = max([err["two_sided"]] + [
            float((x - y).abs().max()) for x, y in zip(got, plain)])
        print(f"two-sided {nt} x {ns} (real {nt_real} x {ns_real}), block "
              f"{blk}, R = {r}: targets vs plain {rel[0]:.3e}, sources "
              f"{rel[1]:.3e}", flush=True)
        if not all(torch.isfinite(x).all() for x in got):
            fail("two-sided kernel: non-finite output")
        if max(rel) > REL_TOL:
            fail(f"two-sided kernel disagrees with its plain version at "
                 f"{nt} x {ns}")
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"two-sided kernel: two launches at {nt} x {ns} differ")
        if bool((got[0][:, nt_real:] != 0).any()
                or (got[1][:, ns_real:] != 0).any()):
            fail("two-sided kernel: padded particles got non-zero "
                 "acceleration")
    if seen != every_targets():
        fail(f"two-sided kernel: R {sorted(seen)} seen, not every R of "
             f"{sorted(every_targets())}")
    print(f"two-sided: every R of {sorted(seen)}; padding exactly 0 on both "
          "sides; repeats bit for bit", flush=True)
    for n, ks in ((16384, (2, 3, 4, 8)), (131072, (8,))):
        for k in ks:
            st = make_state(n, pad_multiple=RING_TILE * k, device=dev)
            sh, _ = shard_state(st, k, make_mesh(k))
            pos, mass = list(sh.pos), list(sh.mass)
            got = ring_kernel.ring_accelerations(pos, mass)
            again = ring_kernel.ring_accelerations(pos, mass)
            whole = torch.cat(got, dim=1)
            ref = sym_kernel.accelerations(st.pos, st.mass)
            r_b = rel_err(whole, ref)
            plain = torch.cat(
                ring_kernel.ring_accelerations_plain(pos, mass), dim=1)
            r_p = rel_err(whole, plain)
            err["ring"] = max(err["ring"], float((whole - plain).abs().max()))
            print(f"ring N={n} (padded {st.n_padded}) K={k}: vs Kernel B "
                  f"{r_b:.3e}, vs plain {r_p:.3e}", flush=True)
            if not torch.isfinite(whole).all():
                fail(f"ring kernel: non-finite output at N={n} K={k}")
            if max(r_b, r_p) > REL_TOL:
                fail(f"ring kernel disagrees at N={n} K={k}")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                fail(f"ring kernel: two launches at N={n} K={k} differ")
            del got, again, whole, ref, plain
    print("ring: repeats bit for bit at every K", flush=True)
    n, k = 16384, 4
    st = make_state(n, device=dev)
    sh, _ = shard_state(st, k, make_mesh(k))
    pos, mass = list(sh.pos), list(sh.mass)
    ts = (pos[0], mass[0], pos[1], mass[1])  # one block pair of ring_sym
    # A wrapper call, as for every kernel; its Python takes longer than its
    # kernels here, so the device time of its two kernels goes beside it.
    ms["two_sided"] = time_ms(lambda: sym_kernel.accelerations_two_sided(*ts))
    ms["two_sided_device"] = device_ms(
        lambda: sym_kernel.accelerations_two_sided(*ts))
    ms["two_sided_plain"] = time_ms(
        lambda: sym_kernel.accelerations_two_sided_plain(*ts), reps=5)
    ms["ring"] = time_ms(lambda: ring_kernel.ring_accelerations(pos, mass))
    ms["ring_plain"] = time_ms(
        lambda: ring_kernel.ring_accelerations_plain(pos, mass), reps=5)
    nl = n // k
    print(f"two-sided {nl} x {nl}: kernel {ms['two_sided']:.4f} ms a "
          f"wrapper call, {ms['two_sided_device']:.4f} ms on the card (CUDA "
          f"graph), plain {ms['two_sided_plain']:.4f} ms per call; "
          f"{nl * nl / ms['two_sided'] / 1e6:.1f} Gpairs/s {tag}", flush=True)
    print(f"ring N={n} K={k}: kernel {ms['ring']:.4f} ms, plain "
          f"{ms['ring_plain']:.4f} ms per call; {n * n / ms['ring'] / 1e6:.1f}"
          f" Gpairs/s (N^2 model); whole state: Kernel A {ms['A']:.4f} ms, "
          f"Kernel B {ms['B']:.4f} ms {tag}", flush=True)

    # 16. The sharded main path.
    counters = (tiled_kernel, sym_kernel, ring_kernel)
    steps = 550  # 500 and the 50-step warm-up block
    for comm, k in [(c, 4) for c in COMM_MODES] + [("ring_sym", 3),
                                                   ("rdma", 3)]:
        for mod in counters:
            mod.launches = 0
        sym_kernel.two_sided_launches = 0
        res = run(SimConfig(n=2000, nsteps=500, shards=k, comm=comm),
                  quiet=True)
        counts = tuple(m.launches for m in counters) + (
            sym_kernel.two_sided_launches,)
        pairs = k * ((k - 1) // 2) + (k // 2 if k % 2 == 0 else 0)
        want = {"allgather": (k * steps, 0, 0, 0),
                "ring": (k * k * steps, 0, 0, 0),
                "ring_sym": (0, k * steps, 0, pairs * steps),
                "rdma": (0, 0, steps, 0)}[comm]
        print(f"sharded main path shards={k} comm={comm}: tiled/sym/ring/"
              f"two-sided launches {counts}; {res.av:.6g} +- {res.dev:.6g} "
              f"GFLOP/s {tag}", flush=True)
        if counts != want:
            fail(f"shards={k} comm={comm} launches {counts} != {want}")
        if k == 4 and comm == "ring_sym":
            launches["two_sided"] = counts[3]
        if k == 4 and comm == "rdma":
            launches["ring"] = counts[2]
        got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
        if got != golden:
            fail(f"shards={k} comm={comm} trace {got} != golden {golden}")
        print(f"sharded main path shards={k} comm={comm}: all {len(golden)} "
              "kinetic-energy rows equal ver0_n2000_s500.txt at %.5g",
              flush=True)
    for comm in COMM_MODES:
        res = run(SimConfig(n=2000, nsteps=500, shards=4, comm=comm,
                            integrator="leapfrog"), quiet=True)
        kes = [ke for _, ke in res.kenergy_trace]
        if len(kes) != 10 or not all(math.isfinite(x) and x > 0 for x in kes):
            fail(f"sharded leapfrog comm={comm} energies not finite and "
                 f"positive: {kes}")
        print(f"sharded leapfrog shards=4 comm={comm} N=2000/500: energies "
              f"finite and positive, {kes[0]:.5g} .. {kes[-1]:.5g}",
              flush=True)

    # 17. The numbers.
    n = 16384
    for comm, k in [(c, 4) for c in COMM_MODES] + [("ring_sym", 8),
                                                   ("rdma", 8)]:
        res = run(SimConfig(n=n, nsteps=500, shards=k, comm=comm), quiet=True)
        kes = [ke for _, ke in res.kenergy_trace]
        if len(kes) != 10 or not all(math.isfinite(x) and x > 0 for x in kes):
            fail(f"N={n} shards={k} comm={comm} energies not finite and "
                 f"positive: {kes}")
        gf[f"{n} shards={k} {comm}"] = (res.av, res.dev)
        print(f"N={n} 500 steps shards={k} comm={comm}: {res.av:.6g} +- "
              f"{res.dev:.6g} GFLOP/s (29N^2+19N model; single-device auto "
              f"{gf[f'{n} auto'][0]:.6g} +- {gf[f'{n} auto'][1]:.6g}) {tag}",
              flush=True)


def corner_blob(n: int, seed: int, box: float = 1.0):
    """tests/test_p3m.py's Gaussian blob (sigma 0.06 box) wrapped round a box
    corner, from numpy: pairs cross the boundary in one, two and three axes.
    Phase 21 and tests/test_torch_periodic.py share it."""
    import numpy as np

    rng = np.random.default_rng(seed)
    pos = np.asarray((0.06 * box * rng.standard_normal((3, n))) % box,
                     np.float32)
    return pos, np.asarray(1.0 + rng.random(n), np.float32)


def kspace_sum(pos, mass, box: float, kmax: int = 48):
    """The fp64 direct Fourier-series sum of tests/test_p3m.py (scipy's
    Bessel K1 over |k_i| <= kmax 2 pi / box), an independent periodic ground
    truth in numpy, so that it runs where JAX is absent; the plane waves
    factor by axis, so each sum over the k lattice is a product of three
    (2 kmax + 1, N) tables.  tests/test_torch_periodic.py uses it too."""
    import numpy as np
    import scipy.special as sp

    eps, G = np.sqrt(1e-3), 6.67259e-11
    p, m = pos.astype(np.float64), mass.astype(np.float64)
    k1 = 2 * np.pi / box * np.arange(-kmax, kmax + 1)
    wave = np.exp(1j * k1[None, :, None] * p[:, None, :])  # (3, K, N)
    k2 = (k1[:, None, None] ** 2 + k1[None, :, None] ** 2
          + k1[None, None, :] ** 2)
    kk = np.sqrt(np.where(k2 > 0, k2, 1.0))
    phih = np.where(k2 > 0, 4 * np.pi * eps * sp.k1(kk * eps) / kk, 0.0)
    rho = np.einsum("aj,bj,cj->abc", m * wave[0].conj(), wave[1].conj(),
                    wave[2].conj(), optimize=True)
    acc = np.empty((3, p.shape[1]))
    for axis in range(3):
        k_axis = k1.reshape([-1 if a == axis else 1 for a in range(3)])
        acc[axis] = np.einsum("abc,ai,bi,ci->i", 1j * k_axis * phih * rho,
                              *wave, optimize=True).real
    return G / box ** 3 * acc


def periodic_phases(dev, tag: str, ms: dict, launches: dict) -> None:
    """Phase 21; fills the SR kernel's periodic figures in ``ms`` and
    ``launches``."""
    import numpy as np
    import torch

    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.ops import (
        fused_block,
        pm,
        sr_kernel,
        sym_kernel,
        tiled_kernel,
        vjp_kernel,
    )
    from nbody_tpu_torch.utils import build, spans

    ng, cutoff, box = PERIODIC["grid"], PERIODIC["cutoff"], PERIODIC["box"]
    bkw = dict(boundary="periodic", box_size=box)

    # 21(a). The SR kernel against its plain version on the periodic tables.
    ref = make_state(N_UNIFORM, device=dev)
    blob = [torch.tensor(a, device=dev) for a in corner_blob(
        PERIODIC["blob_n"], PERIODIC["blob_seed"], box)]
    for label, (p, m) in ((f"reference N={N_UNIFORM}", (ref.pos, ref.mass)),
                          (f"corner blob N={PERIODIC['blob_n']}", blob)):
        n = p.shape[1]
        for layout in ("pallas_paired", "pallas"):
            sym, paired = pm.SR_LAYOUTS[layout]
            plan = pm.suggest_sr_plan(p, m, ng, cutoff, layout=layout, **bkw)
            # At N=1048576 the default layout also runs at the default
            # ghost cap (0: 2N rounded up to a power of two).
            caps = [plan["sr_ghosts"]] + (
                [0] if n == N_UNIFORM and layout == "pallas_paired" else [])
            for ghosts in caps:
                gplan = dict(plan, sr_ghosts=ghosts)
                cap_label = "plan" if ghosts else "default ghost cap"
                tabs = pm.sr_pack_inputs(p, m, ng, cutoff, symmetric=sym,
                                         paired=paired, **gplan, **bkw)
                n_e, n_ghost = int(tabs["n_e"]), int(tabs["n_ghost"])
                nslots = tabs["ptab"].shape[1]
                if n_e > tabs["e_max"]:
                    fail(f"periodic sr {label} {layout}: the plan drops "
                         "entries")
                if n_ghost > tabs["gcap"]:
                    fail(f"periodic sr {label} {layout}: the plan drops "
                         "ghosts")
                args = (tabs["ptab"], tabs["mtab"], tabs["wl_t"],
                        tabs["wl_s"],
                        torch.tensor([0, n_e], dtype=torch.int32, device=dev),
                        tabs["rc2"])
                kw = dict(symmetric=sym, paired=paired)
                got = sr_kernel.sweep(*args, **kw)
                again = sr_kernel.sweep(*args, **kw)
                plain = sr_kernel.sweep_plain(*args, **kw)
                torch.cuda.synchronize()
                occ = tabs["mtab"] > 0
                scale = float(plain[:, occ].abs().max())
                diff = float((got - plain)[:, occ].abs().max())
                same = torch.equal(got, again)
                scratch = sr_kernel.scratch_floats(
                    nslots, tabs["e_max"], build.library().nbt_sr_unit())
                print(f"periodic sr {label} {layout}, {cap_label} "
                      f"{gplan}: {n_ghost} ghosts ({n_ghost / n:.4f} N) in "
                      f"{tabs['gcap']} slots, {nslots} slots, {scratch} "
                      f"scratch floats, {n_e} entries of {tabs['e_max']}; "
                      f"kernel vs plain {diff / scale:.3e} of the largest "
                      f"occupied slot; repeats bit for bit: {same}",
                      flush=True)
                if not torch.isfinite(got).all():
                    fail(f"periodic sr {label} {layout}: non-finite output")
                if diff > SR_TOL * scale:
                    fail(f"periodic sr {label} {layout}: kernel disagrees "
                         "with its plain version")
                if not same:
                    fail(f"periodic sr {label} {layout}: two launches differ")
                del got, again, plain
                if not ghosts:
                    continue
                ms_k = time_ms(lambda: sr_kernel.sweep(*args, **kw), reps=10)
                ms_p = time_ms(lambda: sr_kernel.sweep_plain(*args, **kw),
                               reps=1)
                work = sr_kernel.skip_counts(*args, chunk=2048, **kw)
                skip = work["skipped"] / work["steps"]
                print(f"periodic sr {label} {layout}: kernel {ms_k:.4f} ms, "
                      f"plain {ms_p:.4f} ms per call; (warp, source) steps "
                      f"skipped {skip:.4f} of {work['steps']}, pairs inside "
                      f"the cutoff {work['inside'] / work['pairs']:.4f} "
                      f"{tag}", flush=True)
                if n == N_UNIFORM and layout == "pallas_paired":
                    ms["sr_periodic"] = ms_k
                del tabs, args
    del ref, blob

    # 21(b). Forces against the JAX package's, at N=16384.
    fx = np.load(PERIODIC_FIXTURE)
    n = int(fx["n"])
    ref16 = make_state(n, device=dev)
    states = {"reference": (ref16.pos, ref16.mass),
              "blob": [torch.tensor(a, device=dev) for a in corner_blob(
                  n, int(fx["blob_seed"]), float(fx["box"]))]}
    for name, (p, m) in states.items():
        host = (p.cpu().numpy(), m.cpu().numpy())
        digest = hashlib.sha256(host[0].tobytes() + host[1].tobytes())
        if digest.hexdigest() != str(fx[f"{name}_digest"]):
            fail(f"the periodic {name} N={n} state differs from the "
                 "fixture's")
        r_pm = rel_err(pm.accelerations(p, m, grid=ng, **bkw).cpu(),
                       torch.tensor(fx[f"{name}_pm"]))
        plan = pm.suggest_sr_plan(p, m, ng, cutoff,
                                  capacity=int(fx[f"{name}_capacity"]), **bkw)
        before = sr_kernel.launches
        r_p3m = rel_err(pm.p3m_accelerations(p, m, grid=ng, **plan,
                                             **bkw).cpu(),
                        torch.tensor(fx[f"{name}_p3m"]))
        print(f"periodic N={n} {name} vs the JAX fixture: pm {r_pm:.3e}, "
              f"p3m {r_p3m:.3e} (relative norm), plan {plan}", flush=True)
        if sr_kernel.launches != before + 1:
            fail("periodic p3m did not launch the SR kernel once")
        if max(r_pm, r_p3m) > MESH_TOL:
            fail(f"periodic {name}: the mesh tiers disagree with the JAX "
                 "package's accelerations")

    # 21(c). Against the fp64 k-space sum, at the CPU tests' bounds.
    rng = np.random.default_rng(11)
    pos16 = np.asarray(rng.random((3, 16)), np.float32)
    mass16 = np.asarray(1.0 + rng.random(16), np.float32)
    exact = kspace_sum(pos16, mass16, 1.0)
    p, m = (torch.tensor(a, device=dev) for a in (pos16, mass16))
    e_pm = {g: rel_err(pm.accelerations(p, m, grid=g, **bkw).cpu(),
                       torch.tensor(exact)) for g in (32, 64)}
    print(f"periodic pm, 16 bodies, vs the k-space sum: ng=32 "
          f"{e_pm[32]:.4e} (< 7e-2), ng=64 {e_pm[64]:.4e} (< 1.5e-2)",
          flush=True)
    if not (e_pm[32] < 7e-2 and e_pm[64] < 1.5e-2 and e_pm[64] < e_pm[32]):
        fail("periodic pm misses the k-space sum")
    pos96, mass96 = corner_blob(96, 5)
    exact = torch.tensor(kspace_sum(pos96, mass96, 1.0))
    p, m = (torch.tensor(a, device=dev) for a in (pos96, mass96))
    for g, lim in ((32, 2.5e-2), (64, 1.5e-2)):
        plan = pm.suggest_sr_plan(p, m, g, 4, **bkw)
        e_p3m = rel_err(pm.accelerations(p, m, grid=g, cutoff_cells=4,
                                         **plan, **bkw).cpu(), exact)
        e_mesh = rel_err(pm.accelerations(p, m, grid=g, **bkw).cpu(), exact)
        print(f"periodic p3m, corner blob of 96, ng={g}, vs the k-space sum: "
              f"{e_p3m:.4e} (< {lim:g}), pm {e_mesh:.4e} (p3m < pm/3)",
              flush=True)
        if not (e_p3m < lim and e_p3m < e_mesh / 3):
            fail(f"periodic p3m at ng={g} misses the k-space sum")

    # 21(d). The main path: bench.py's periodic row, and its mesh half.
    for cutoff_cells in (4, 0):
        def build_env(c=cutoff_cells):
            return pm._make_periodic_env(ng, c, box, dev)

        t0 = time.perf_counter()
        build_env()
        torch.cuda.synchronize()
        first = 1e3 * (time.perf_counter() - t0)
        print(f"periodic env ng={ng} cutoff {cutoff_cells}: built in "
              f"{first:.3f} ms (first call), {time_ms(build_env, reps=3):.3f} "
              f"ms (CUDA events) {tag}", flush=True)
    counters = (sr_kernel, tiled_kernel, sym_kernel, fused_block, vjp_kernel)
    for kernel, want in (("p3m", 12), ("pm", 0)):
        for mod in counters:
            mod.launches = 0
        syncs = spans.counts["host_syncs"]
        res = run(SimConfig(n=N_UNIFORM, nsteps=8, sfreq=4, kernel=kernel,
                            pm_boundary="periodic", pm_box=box), quiet=True)
        counts = tuple(mod.launches for mod in counters)
        syncs = spans.counts["host_syncs"] - syncs
        kes = [ke for _, ke in res.kenergy_trace]
        step_ms = [1e3 * b / 4 for (_, _, _, b, _) in res.samples]
        print(f"periodic {kernel} run N={N_UNIFORM} reference, L={box}, 8 "
              f"steps: sr/tiled/sym/fused/vjp launches {counts}, "
              f"{syncs} host syncs; ms per step "
              f"{', '.join(f'{t:.3f}' for t in step_ms)}; energies "
              f"{', '.join(f'{k:.6g}' for k in kes)} {tag}", flush=True)
        if counts != (want, 0, 0, 0, 0):
            fail(f"periodic {kernel} N={N_UNIFORM} launches {counts}")
        if len(kes) != 2 or not all(math.isfinite(k) and k > 0 for k in kes):
            fail(f"periodic {kernel} N={N_UNIFORM} energies not finite and "
                 f"positive: {kes}")
        if kernel == "p3m":
            launches["sr_periodic"] = counts[0]
    res = run(SimConfig(n=512, nsteps=100, kernel="pm", pm_grid=32,
                        pm_boundary="periodic", pm_box=8.0,
                        energy_check=True), quiet=True)
    print(f"energy check periodic pm N=512, 100 steps, ng=32, L=8: drift "
          f"{res.energy_drift:.6e} (< 5e-2)", flush=True)
    if not (math.isfinite(res.energy_drift) and res.energy_drift < 5e-2):
        fail(f"periodic energy drift {res.energy_drift} not below 5e-2")


def vjp_check(label: str, tabs: dict, n_e: int, sym: bool, dev) -> tuple:
    """The SR VJP kernel against its plain version on one set of tables
    (``ptab, mtab, wl_t, wl_s, rc2``) with a seeded cotangent; fails on a
    miss.  Returns (max abs error of gp and gm, kernel ms, plain ms, MB the
    first call took beyond what was allocated before it)."""
    import torch

    from nbody_tpu_torch.ops import sr_kernel

    gen = torch.Generator(dev).manual_seed(11)
    g = torch.randn(tabs["ptab"].shape, device=dev, generator=gen)
    bounds = torch.tensor([0, n_e], dtype=torch.int32, device=dev)
    args = (tabs["ptab"], tabs["mtab"], tabs["wl_t"], tabs["wl_s"], bounds,
            tabs["rc2"], g)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = sr_kernel.sweep_vjp(*args, symmetric=sym)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - held) / 2**20
    again = sr_kernel.sweep_vjp(*args, symmetric=sym)
    t0 = time.perf_counter()
    plain = sr_kernel.sweep_vjp_plain(*args, symmetric=sym)
    torch.cuda.synchronize()
    ms_p = 1e3 * (time.perf_counter() - t0)
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(got[:2], plain[:2])]
    rel.append(float((got[2] - plain[2]).abs() / plain[2].abs()))
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    max_abs = max(float((a - b).abs().max()) for a, b in zip(got[:2], plain[:2]))
    ms_k = time_ms(lambda: sr_kernel.sweep_vjp(*args, symmetric=sym), reps=5)
    print(f"sr vjp {label}: {n_e} entries; kernel vs plain gp {rel[0]:.3e}, "
          f"gm {rel[1]:.3e} of the largest, grc2 {rel[2]:.3e} relative; "
          f"repeats bit for bit: {same}; kernel {ms_k:.4f} ms, plain "
          f"{ms_p:.1f} ms per call; peak memory of a kernel call "
          f"{peak_mb:.1f} MB above the {held / 2**20:.1f} MB held", flush=True)
    if not all(bool(torch.isfinite(t).all()) for t in got):
        fail(f"sr vjp {label}: non-finite output")
    if max(rel[:2]) > SR_VJP_TOL or rel[2] > SR_VJP_RC2_TOL:
        fail(f"sr vjp {label}: kernel disagrees with its plain version")
    if not same:
        fail(f"sr vjp {label}: two launches differ")
    return max_abs, ms_k, ms_p, peak_mb


def grad_phases(dev, tag: str, err: dict, ms: dict, launches: dict) -> dict:
    """Phase 22; fills the SR VJP kernel's figures in ``err``, ``ms`` and
    ``launches`` and returns its bound's pair counts."""
    import contextlib
    import functools
    import io
    import re
    import warnings

    import numpy as np
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.examples import fit_velocities
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.models.gravity import make_accel_fn
    from nbody_tpu_torch.models.rollout import make_rollout_fn
    from nbody_tpu_torch.ops import pm, sr_kernel

    gate = P3M_GATE
    ng, cutoff = gate["grid"], gate["cutoff"]
    pos_np, vel_np, mass_np = distributions.plummer(gate["n"],
                                                    seed=gate["seed"])
    p, v, m = (torch.tensor(a, device=dev) for a in (pos_np, vel_np, mass_np))

    # 22(a). The VJP kernel against its plain version, and its bound's work.
    work = {}
    for layout in ("pallas", "pallas_sym"):
        sym = pm.SR_LAYOUTS[layout][0]
        plan = pm.suggest_sr_plan(p, m, ng, cutoff, layout=layout,
                                  differentiable=True)
        pk = pm.sr_pack_inputs(p, m, grid=ng, cutoff_cells=cutoff,
                               symmetric=sym, **plan)
        n_e = int(pk["n_e"])
        if n_e > pk["e_max"]:
            fail(f"sr vjp {layout}: the suggested plan drops entries")
        max_abs, ms_k, ms_p, peak_mb = vjp_check(
            f"{layout} N={gate['n']}", pk, n_e, sym, dev)
        # The pairs the function needs at these inputs: each pair's distance
        # test, the full terms inside the cutoff, and (pallas_sym, entries
        # off the diagonal) the reaction's; and the (warp, other) steps each
        # of the kernel's passes skips.
        tabs = (pk["ptab"], pk["mtab"], pk["wl_t"], pk["wl_s"])
        bounds = torch.tensor([0, n_e], dtype=torch.int32, device=dev)
        off = (pk["wl_t"][:n_e] != pk["wl_s"][:n_e]).nonzero()[:, 0]
        counts = functools.partial(sr_kernel.vjp_skip_counts, *tabs, bounds,
                                   pk["rc2"], chunk=2048)
        full = counts()
        react = counts(entries=off) if sym else {"inside": 0}
        work[layout] = (full["pairs"], full["inside"], react["inside"],
                        pk["ptab"].shape[1], n_e)
        skipped = {side: full[side] / full["steps"]
                   for side in ("target", "source")}
        print(f"sr vjp {layout}: pairs {full['pairs']}, inside the cutoff "
              f"{full['inside'] / full['pairs']:.4f}; (warp, other) steps a "
              f"pass {full['steps']}, skipped: target pass "
              f"{skipped['target']:.4f}, source pass {skipped['source']:.4f} "
              f"{tag}", flush=True)
        if layout == "pallas":  # the layout the card's AD runs
            err["sr_vjp"], ms["sr_vjp"], ms["sr_vjp_plain"] = max_abs, ms_k, ms_p
            ms["sr_vjp_peak_mb"], ms["sr_vjp_skipped"] = peak_mb, skipped
        del pk, tabs

    # 22(b). The differentiable forward equals the pinned pallas layout's.
    plan = pm.suggest_sr_plan(p, m, ng, cutoff, differentiable=True)
    kw = dict(grid=ng, cutoff_cells=cutoff, **plan)
    prev = pm.set_sr_layout("pallas")
    try:
        pinned = pm.accelerations(p, m, **kw)
    finally:
        pm.set_sr_layout(prev)
    same = torch.equal(pm.accelerations(p, m, differentiable=True, **kw),
                       pinned)
    print(f"differentiable p3m N={gate['n']}, plan {plan}: forward equals "
          f"the pinned pallas layout bit for bit: {same}", flush=True)
    if not same:
        fail("the differentiable forward differs from the pinned pallas one")

    # 22(c). The full gradient: kernel against plain backward, and the JAX
    # package's gradients.
    def grad(pos, mass, plain=False, **opts):
        kernel = sr_kernel.sweep_vjp
        if plain:  # the yardstick: the plain VJP in the kernel's place
            sr_kernel.sweep_vjp = sr_kernel.sweep_vjp_plain
        try:
            fn = make_accel_fn("p3m", differentiable=True, **opts)
            q = pos.clone().requires_grad_(True)
            torch.mean(fn(q, mass) ** 2).backward()
        finally:
            sr_kernel.sweep_vjp = kernel
        return q.grad

    g_k, g_p = grad(p, m, **kw), grad(p, m, plain=True, **kw)
    rel = float((g_k - g_p).abs().max() / g_p.abs().max())
    print(f"differentiable p3m N={gate['n']}: gradient of mean(|a|^2), kernel "
          f"vs plain backward {rel:.3e} of the largest", flush=True)
    if not (torch.isfinite(g_k).all() and g_k.abs().max() > 0):
        fail("the p3m gradient is not finite and non-zero")
    if rel > GRAD_TOL:
        fail("the p3m gradient disagrees with the plain backward's")
    fx = np.load(GRAD_FIXTURE)
    n16 = int(fx["n"])
    pos16, _, mass16 = distributions.plummer(n16, seed=int(fx["seed"]))
    ref16 = make_state(n16, device=dev)
    states = {"open": (torch.tensor(pos16, device=dev),
                       torch.tensor(mass16, device=dev), {}),
              "periodic": (ref16.pos, ref16.mass,
                           dict(boundary="periodic", box_size=float(fx["box"])))}
    for name, (q, mq, bkw) in states.items():
        host = (q.cpu().numpy(), mq.cpu().numpy())
        digest = hashlib.sha256(host[0].tobytes() + host[1].tobytes())
        if digest.hexdigest() != str(fx[f"{name}_digest"]):
            fail(f"the {name} N={n16} state differs from the fixture's")
        qplan = pm.suggest_sr_plan(q, mq, int(fx["grid"]), int(fx["cutoff"]),
                                   capacity=int(fx[f"{name}_capacity"]),
                                   differentiable=True, **bkw)
        got = grad(q, mq, grid=int(fx["grid"]), cutoff_cells=int(fx["cutoff"]),
                   **qplan, **bkw).cpu().double()
        want = torch.tensor(fx[f"{name}_grad"]).double()
        e_max = float((got - want).abs().max() / want.abs().max())
        e_rel = float((got - want).norm() / want.norm())
        print(f"differentiable p3m N={n16} {name} vs the JAX fixture: "
              f"{e_max:.3e} of the largest, {e_rel:.3e} relative norm",
              flush=True)
        if (e_rel if name == "open" else e_max) > GRAD_TOL:
            fail(f"the {name} p3m gradient disagrees with the JAX package's")

    # 22(d). A 10-step rollout gradient, the main path of differentiable
    # P3M: its launches, remat against no remat, its time.
    steps, dt = 10, 0.01
    accel = make_accel_fn("p3m", differentiable=True, **kw)
    with torch.no_grad():
        target = make_rollout_fn(accel, dt, steps)(p, v, m)[0]

    def rollout_grads(remat=True):
        vel = (0.5 * v).requires_grad_(True)
        mass = m.clone().requires_grad_(True)
        d = make_rollout_fn(accel, dt, steps, remat=remat)(p, vel, mass)[0]
        torch.sum((d - target) ** 2).backward()
        return vel.grad, mass.grad

    # Which of the mesh's indexing ops repeat bit for bit on the card: each
    # run twice on the gate's state, with and without PyTorch's
    # deterministic mode.
    lo_box, hi_box = pm._robust_box(p, m)
    h = ((hi_box - lo_box) / float(ng - 3))[:, 0]
    inv_h, lo = 1.0 / h[:, None], lo_box - h[:, None]
    gen = torch.Generator(dev).manual_seed(5)
    w_acc = torch.randn(p.shape, device=dev, generator=gen)
    w_rho = torch.randn((ng, ng, ng), device=dev, generator=gen)
    grids = torch.randn((3, ng, ng, ng), device=dev, generator=gen)
    idx = torch.randint(0, p.shape[1], (2 * p.shape[1],), device=dev,
                        generator=gen)

    def backward_of(x, f):
        x = x.clone().requires_grad_(True)
        f(x).backward()
        return x.grad

    probes = {
        "CIC gather backward (index_select -> index_add_)": lambda: backward_of(
            grids, lambda g: (pm._gather(g, p, lo, inv_h, ng) * w_acc).sum()),
        "CIC deposit off autograd (csrc/deposit.cu, fixed point)":
            lambda: pm._deposit(p, m, lo, inv_h, ng),
        "CIC deposit under autograd (index_put_, accumulate)": lambda:
            pm._deposit(p, m.clone().requires_grad_(True), lo, inv_h,
                        ng).detach(),
        "CIC deposit backward (a gather)": lambda: backward_of(
            m, lambda q: (pm._deposit(p, q, lo, inv_h, ng) * w_rho).sum()),
        "table gather backward (index_put_, accumulate)": lambda: backward_of(
            p, lambda q: (q[:, idx] * w_acc.repeat(1, 2)).sum()),
    }
    for det in (False, True):
        torch.use_deterministic_algorithms(det, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                same = {k: torch.equal(f(), f()) for k, f in probes.items()}
                if det:
                    g_det = [rollout_grads(remat) for remat in (True, False)]
        finally:
            torch.use_deterministic_algorithms(False)
        print(f"repeats bit for bit{' (deterministic mode)' if det else ''}: "
              + "; ".join(f"{k} {v}" for k, v in same.items()), flush=True)
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    same = all(torch.equal(a, b) for a, b in zip(*g_det))
    print(f"rollout under deterministic mode: remat equals no remat bit for "
          f"bit: {same}; ops that warned of no deterministic CUDA "
          f"implementation: {ops}", flush=True)
    if not same:
        fail("under deterministic mode the rollout gradients with remat "
             "differ from those without")
    del probes, grids, g_det
    runs = {}
    for remat in (True, False):
        sr_kernel.launches = sr_kernel.vjp_launches = 0
        runs[remat] = rollout_grads(remat)
        torch.cuda.synchronize()
        runs[remat] += ((sr_kernel.launches, sr_kernel.vjp_launches),)
    launches["sr_vjp"] = runs[True][2][1]
    launches["sr_ad"] = runs[True][2][0]
    rel = [float((a - b).abs().max() / b.abs().max())
           for a, b in zip(runs[True][:2], runs[False][:2])]
    same = all(torch.equal(a, b) for a, b in zip(runs[True][:2],
                                                 runs[False][:2]))
    print(f"rollout N={gate['n']}, {steps} Euler steps: sr/sr vjp launches "
          f"{runs[True][2]} with remat, {runs[False][2]} without; remat vs "
          f"no remat d_vel {rel[0]:.3e}, d_mass {rel[1]:.3e} of the largest, "
          f"bit for bit: {same}", flush=True)
    if runs[True][2] != (2 * steps, steps) or runs[False][2] != (steps, steps):
        fail("rollout launches are not (20, 10) with remat and (10, 10) "
             "without")
    if not all(torch.isfinite(t).all() and t.abs().max() > 0
               for t in runs[True][:2]):
        fail("rollout gradients missing, non-finite or zero")
    if max(rel) > GRAD_TOL:
        fail("rollout gradients with remat differ from those without")
    del runs
    ms["rollout_p3m"] = time_ms(lambda: rollout_grads(), reps=3)
    print(f"rollout N={gate['n']} p3m, {steps} Euler steps: forward + backward "
          f"{ms['rollout_p3m']:.3f} ms {tag}", flush=True)

    # 22(e). bench.py's periodic row.
    ref = make_state(N_UNIFORM, device=dev)
    box = PERIODIC["box"]
    bkw = dict(boundary="periodic", box_size=box)
    for layout in ("pallas", "pallas_sym"):
        sym = pm.SR_LAYOUTS[layout][0]
        pplan = pm.suggest_sr_plan(ref.pos, ref.mass, ng, cutoff, layout=layout,
                                   differentiable=True, **bkw)
        tabs = pm.sr_pack_inputs(ref.pos, ref.mass, ng, cutoff,
                                 symmetric=sym, **pplan, **bkw)
        n_e = int(tabs["n_e"])
        if n_e > tabs["e_max"] or int(tabs["n_ghost"]) > tabs["gcap"]:
            fail(f"periodic sr vjp {layout}: the plan drops entries or ghosts")
        _, ms_k, _, _ = vjp_check(f"periodic {layout} N={N_UNIFORM}", tabs,
                                  n_e, sym, dev)
        if layout == "pallas":
            ms["sr_vjp_periodic"] = ms_k
        del tabs
    pplan = pm.suggest_sr_plan(ref.pos, ref.mass, ng, cutoff,
                               differentiable=True, **bkw)
    fn = make_accel_fn("p3m", differentiable=True, grid=ng, **pplan, **bkw)

    def periodic_forward():
        q = ref.pos.clone().requires_grad_(True)
        return q, torch.mean(fn(q, ref.mass) ** 2)

    q, loss = periodic_forward()
    loss.backward()
    if not (torch.isfinite(q.grad).all() and q.grad.abs().max() > 0):
        fail("the periodic p3m gradient is not finite and non-zero")
    fwd_ms = time_ms(lambda: periodic_forward(), reps=3)
    both_ms = time_ms(lambda: periodic_forward()[1].backward(), reps=3)
    print(f"periodic differentiable p3m N={N_UNIFORM}, L={box}, plan {pplan}: "
          f"gradient finite, |g| max {float(q.grad.abs().max()):.3e}; forward "
          f"{fwd_ms:.3f} ms, backward {both_ms - fwd_ms:.3f} ms {tag}",
          flush=True)
    del ref, q, loss

    # 22(f). The example.
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fit_velocities.main(["128", "10", "40", "p3m"])
    print(out.getvalue(), end="", flush=True)
    errs = [float(e) for e in re.findall(r"vel rel err=(\S+)", out.getvalue())]
    if rc != 0 or len(errs) < 2 or not errs[-1] < errs[0]:
        fail(f"examples.fit_velocities 128 10 40 p3m exited {rc}, errors "
             f"{errs}")
    return work


def repair_phases(dev, tag: str) -> None:
    """Phase 18: Kernel B's and the two-sided sweep's banded partials."""
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.ops import sym_kernel, tiled_kernel

    n, b = N_UNIFORM, sym_kernel.DEFAULT_BLOCK
    st = make_state(n, device=dev)
    budget = sym_kernel.device_budget(dev)
    band = sym_kernel.sym_band(n, b, budget)
    bands = -(-(n // b) // band)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    got = sym_kernel.accelerations(st.pos, st.mass)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    again = sym_kernel.accelerations(st.pos, st.mass)
    ref = tiled_kernel.accelerations(st.pos, st.mass)
    torch.cuda.synchronize()
    rel = rel_err(got, ref)
    print(f"sym N={n} block {b}: all partials {sym_kernel.scratch_bytes(n, b)} "
          f"bytes; {bands} bands of {band} tiles within {budget} bytes; "
          f"max_memory_allocated {peak} bytes ({peak - base} above the "
          f"state); {secs:.3f} s a call; vs Kernel A {rel:.3e}; auto would "
          f"take {'Kernel B' if sym_kernel.fits(n, b, dev) else 'Kernel A'} "
          f"{tag}", flush=True)
    if not torch.isfinite(got).all():
        fail(f"sym N={n}: non-finite accelerations")
    if rel > REL_TOL:
        fail(f"sym N={n} disagrees with Kernel A")
    if not torch.equal(got, again):
        fail(f"sym N={n}: two calls differ")
    if peak - base > budget + 3 * 4 * n:
        fail(f"sym N={n}: {peak - base} bytes above the state, over the "
             f"budget")
    del st, got, again, ref
    st = make_state(16384, device=dev)
    one = sym_kernel.accelerations(st.pos, st.mass)
    for r in (1, 7, 40):
        banded = sym_kernel.accelerations(
            st.pos, st.mass, scratch_budget=sym_kernel.band_bytes(16384, b, r))
        if not torch.equal(banded, one):
            fail(f"sym N=16384 in bands of {r} differs from one band")
    a = make_state(4096, seed=1, device=dev)
    c = make_state(4096, seed=2, device=dev)
    args = (a.pos, a.mass, c.pos, c.mass)
    one = sym_kernel.accelerations_two_sided(*args)
    for r in (1, 5):
        banded = sym_kernel.accelerations_two_sided(
            *args, scratch_budget=24 * r * 4096)
        if not all(torch.equal(x, y) for x, y in zip(banded, one)):
            fail(f"two-sided 4096 x 4096 in bands of {r} differs from one "
                 "band")
    print("banded sweeps: Kernel B at N=16384 in bands of 1, 7 and 40 tiles "
          "and the two-sided sweep at 4096 x 4096 in bands of 1 and 5 equal "
          "the one-band sweeps bit for bit", flush=True)


def mxu_phases(dev, tag: str, err: dict, ms: dict, launches: dict,
               golden: list, gf: dict) -> None:
    """Phase 19: ``--kernel pallas_mxu``; fills ``err``, ``ms`` and
    ``launches``."""
    import torch

    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.ops import (
        fused_block,
        mxu_kernel,
        naive,
        sym_kernel,
        tiled_kernel,
        vjp_kernel,
    )
    from nbody_tpu_torch.parallel import ring_kernel
    from nbody_tpu_torch.utils.reporting import _g5

    err["mxu"] = 0.0
    got = {}
    for n, n_pad in ((2048, 2048), (16384, 16384), (2000, 2000),
                     (2000, 2048), (1000, 1000), (300, 300)):
        st = make_state(n, pad_multiple=n_pad, device=dev)
        a = mxu_kernel.accelerations(st.pos, st.mass)
        again = mxu_kernel.accelerations(st.pos, st.mass)
        plain = mxu_kernel.accelerations_between_plain(st.pos, st.pos, st.mass)
        ref = naive.accelerations(st.pos, st.mass)
        f64 = naive.accelerations(st.pos.double(), st.mass.double())
        torch.cuda.synchronize()
        got[n_pad] = a
        real = slice(0, n)
        rp = rel_err(a[:, real], plain[:, real])
        rn, rf = rel_err(a[:, real], ref[:, real]), rel_err(a[:, real],
                                                           f64[:, real])
        rpf = rel_err(plain[:, real], f64[:, real])
        err["mxu"] = max(err["mxu"], float((a - plain)[:, real].abs().max()))
        print(f"mxu N={n} (padded {n_pad}): vs plain {rp:.3e}; vs naive "
              f"{rn:.3e}, vs float64 {rf:.3e} (plain vs float64 {rpf:.3e})",
              flush=True)
        if not torch.isfinite(a).all():
            fail(f"mxu kernel: non-finite accelerations at N={n}")
        if rp > (REL_TOL if n >= 2000 else MXU_SMALL_TOL):
            fail(f"mxu kernel disagrees with its plain version at N={n}")
        if max(rn, rf) >= MXU_TOL:
            fail(f"mxu kernel: field error over {MXU_TOL} at N={n}")
        if not torch.equal(a, again):
            fail(f"mxu kernel: two launches at N={n} differ")
    if not torch.equal(got[2000], got[2048][:, :2000]):
        fail("mxu kernel: the padded sweep changed the real targets")
    print("mxu: repeats bit for bit; unpadded N=2000 == padded to 2048 on the "
          "real targets exactly", flush=True)
    st = make_state(256, device=dev)
    p = st.pos.clone().requires_grad_(True)
    try:
        mxu_kernel.accelerations(p, st.mass)
    except RuntimeError as e:
        if "differentiable=True" not in str(e):
            raise
    else:
        fail("mxu kernel accepted inputs that require grad")
    print("mxu kernel refuses inputs that require grad", flush=True)
    # The between form at the shapes the sharded main paths give it: one
    # 500-target shard of N=2000 against all sources (allgather) and against
    # one source shard (ring).
    st = make_state(2000, device=dev)
    for ns in (2000, 500):
        tgt = st.pos[:, 1000:1500].contiguous()
        src, m = st.pos[:, :ns].contiguous(), st.mass[:ns].contiguous()
        a = mxu_kernel.accelerations_between(tgt, src, m)
        again = mxu_kernel.accelerations_between(tgt, src, m)
        plain = mxu_kernel.accelerations_between_plain(tgt, src, m)
        ref = naive.accelerations_between(tgt, src, m)
        f64 = naive.accelerations_between(tgt.double(), src.double(),
                                          m.double())
        torch.cuda.synchronize()
        rp, rn, rf = rel_err(a, plain), rel_err(a, ref), rel_err(a, f64)
        err["mxu"] = max(err["mxu"], float((a - plain).abs().max()))
        print(f"mxu between 500 x {ns}: vs plain {rp:.3e}; vs naive "
              f"{rn:.3e}, vs float64 {rf:.3e}", flush=True)
        if not torch.isfinite(a).all():
            fail(f"mxu between 500 x {ns}: non-finite accelerations")
        if rp > REL_TOL:
            fail(f"mxu between 500 x {ns} disagrees with its plain version")
        if max(rn, rf) >= MXU_TOL:
            fail(f"mxu between 500 x {ns}: field error over {MXU_TOL}")
        if not torch.equal(a, again):
            fail(f"mxu between 500 x {ns}: two launches differ")

    # The main path through the mxu kernel, alone and sharded.
    counters = (mxu_kernel, tiled_kernel, sym_kernel, fused_block, vjp_kernel,
                ring_kernel)
    gold = [float(ke) for _, ke in golden]
    for shards, comm, per_step in ((1, "allgather", 1), (4, "allgather", 4),
                                   (4, "ring", 16)):
        for mod in counters:
            mod.launches = 0
        sym_kernel.two_sided_launches = 0
        res = run(SimConfig(n=2000, nsteps=500, kernel="pallas_mxu",
                            shards=shards, comm=comm), quiet=shards > 1,
                  out=sys.stdout)
        counts = tuple(m.launches for m in counters) + (
            sym_kernel.two_sided_launches,)
        want = (550 * per_step,) + (0,) * 6
        kes = [ke for _, ke in res.kenergy_trace]
        worst = max(abs(k - g) / abs(g) for k, g in zip(kes, gold))
        same = sum(row == want for row, want in zip(
            [(s, _g5(ke)) for s, ke in res.kenergy_trace], golden))
        label = "alone" if shards == 1 else f"shards={shards} comm={comm}"
        print(f"mxu main path {label}: mxu/tiled/sym/fused/vjp/ring/two-sided "
              f"launches {counts}; KE rows vs golden: largest relative "
              f"difference {worst:.3e}, {same} of {len(golden)} equal at "
              f"%.5g; {res.av:.6g} +- {res.dev:.6g} GFLOP/s {tag}", flush=True)
        if counts != want:
            fail(f"mxu run {label} launches {counts} != {want}")
        if len(kes) != len(gold) or worst > MXU_TOL:
            fail(f"mxu run {label}: KE rows over {MXU_TOL} from golden")
        if shards == 1:
            launches["mxu"] = counts[0]
    n = 16384
    res = run(SimConfig(n=n, nsteps=500, kernel="pallas_mxu"), quiet=True)
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(math.isfinite(k) and k > 0 for k in kes):
        fail(f"mxu N={n} energies not finite and positive: {kes}")
    gf[f"{n} pallas_mxu"] = (res.av, res.dev)
    print(f"N={n} 500 steps pallas_mxu: {res.av:.6g} +- {res.dev:.6g} GFLOP/s "
          f"(29N^2+19N model; auto {gf[f'{n} auto'][0]:.6g} +- "
          f"{gf[f'{n} auto'][1]:.6g}) {tag}", flush=True)
    st = make_state(n, device=dev)
    pos, mass = st.pos, st.mass
    ms["mxu"] = time_ms(lambda: mxu_kernel.accelerations(pos, mass))
    ms["mxu_plain"] = time_ms(
        lambda: mxu_kernel.accelerations_between_plain(pos, pos, mass), reps=5)
    ms["A_mxu_phase"] = time_ms(lambda: tiled_kernel.accelerations(pos, mass))
    print(f"mxu N={n}: kernel {ms['mxu']:.4f} ms, plain {ms['mxu_plain']:.4f} "
          f"ms, Kernel A {ms['A_mxu_phase']:.4f} ms per call; "
          f"{n * n / ms['mxu'] / 1e6:.1f} Gpairs/s {tag}", flush=True)


def deposit_phases(dev, tag: str, err: dict, ms: dict) -> dict:
    """Phase 23; fills ``err`` and ``ms`` and returns the deposit's bound
    at the row's state (uniform N=1048576, open)."""
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.ops import deposit_kernel, pm

    ng = P3M_GATE["grid"]
    ref = make_state(N_UNIFORM, device=dev)
    pos_p, _, mass_p = distributions.plummer(P3M_GATE["n"],
                                             seed=P3M_GATE["seed"])
    states = {"uniform": (ref.pos, ref.mass),
              "plummer": (torch.tensor(pos_p, device=dev),
                          torch.tensor(mass_p, device=dev))}
    err["deposit"] = 0.0
    bounds = {}
    for name, (pos, mass) in states.items():
        n = pos.shape[1]
        for boundary in ("open", "periodic"):
            if boundary == "open":  # the solver's box and in-box masses
                mesh = pm._OpenMesh(ng, *pm._robust_box(pos, mass))
                m = mesh.bodies(pos, mass, pos)[1]
                kw = dict(lo=mesh.lo, inv_h=mesh.inv_h)
            else:
                m, kw = mass, dict(box=PERIODIC["box"])
            got = deposit_kernel.deposit(pos, m, ng, **kw)
            again = deposit_kernel.deposit(pos, m, ng, **kw)
            plain = deposit_kernel.deposit_plain(pos, m, ng, **kw)
            lib = pm._scatter(deposit_kernel._corners(pos, ng, **kw), m, ng)
            torch.cuda.synchronize()
            label = f"deposit {name} N={n} {boundary}"
            if not torch.isfinite(got).all():
                fail(f"{label}: non-finite grid")
            if not torch.equal(got, plain):
                fail(f"{label}: the kernel differs from deposit_plain")
            if not torch.equal(got, again):
                fail(f"{label}: two launches differ")
            r_lib = rel_err(got, lib)
            if r_lib > 1e-6:
                fail(f"{label}: {r_lib:.3e} from _scatter's grid")
            del again, plain, lib
            t = (time_ms(lambda: deposit_kernel.deposit(pos, m, ng, **kw)),
                 time_ms(lambda: deposit_kernel.deposit_plain(pos, m, ng,
                                                              **kw), reps=1),
                 time_ms(lambda: pm._scatter(deposit_kernel._corners(
                     pos, ng, **kw), m, ng)))
            b = bound(OPS_DEPOSIT * n, 16 * n + 4 * ng ** 3)
            bounds[(name, boundary)] = b
            ms[label] = t
            print(f"{label}: kernel equals deposit_plain and itself bit for "
                  f"bit, {r_lib:.3e} from _scatter (relative norm); kernel "
                  f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, _scatter {t[2]:.4f} "
                  f"ms per call; bound {b[0]:.4f} ms ({b[1]}) {tag}",
                  flush=True)
        del pos, mass
    row = f"deposit uniform N={N_UNIFORM}"
    ms["deposit"], ms["deposit_plain"], ms["deposit_library"] = \
        ms[f"{row} open"]
    ms["deposit_periodic"] = ms[f"{row} periodic"][0]
    return bounds[("uniform", "open")]


def far_field_phases(dev, tag: str, err: dict, ms: dict) -> dict:
    """Phase 24; fills ``err`` and ``ms`` and returns the far field's bound
    at the row's state (uniform N=1048576)."""
    import numpy as np
    import torch

    from nbody_tpu_torch import make_state
    from nbody_tpu_torch.models import distributions
    from nbody_tpu_torch.ops import far_field_kernel as ffk
    from nbody_tpu_torch.ops import pm

    ref = make_state(N_UNIFORM, device=dev)
    pos_p, _, mass_p = distributions.plummer(P3M_GATE["n"],
                                             seed=P3M_GATE["seed"])
    states = {"uniform": (ref.pos, ref.mass),
              "plummer": (torch.tensor(pos_p, device=dev),
                          torch.tensor(mass_p, device=dev))}
    err["far_field"] = 0.0
    bounds = {}
    for name, (pos, mass) in states.items():
        n = pos.shape[1]
        lo_box, hi_box = pm._robust_box(pos, mass)
        in_tgt = pm._inside(pos, lo_box, hi_box)
        m_in = mass * in_tgt
        acc = torch.randn(pos.shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(5))
        args = (pos, mass, m_in, lo_box, hi_box)

        def kernels():
            return ffk.monopoles(pos, ffk.moments(*args), acc, in_tgt)

        def chain():  # the nine-call chain, on the card too
            hand = pm._hand_far_field
            pm._hand_far_field = lambda *t: False
            try:
                return pm._monopoles(acc, pos, in_tgt,
                                     pm._outlier_moments(*args))
            finally:
                pm._hand_far_field = hand

        table, again = ffk.moments(*args), ffk.moments(*args)
        plain = ffk.moments_plain(*args)
        got = ffk.monopoles(pos, table, acc, in_tgt)
        twice = ffk.monopoles(pos, again, acc, in_tgt)
        given = ffk.monopoles_plain(pos, table, acc, in_tgt)
        whole, lib = ffk.far_field_plain(*args, pos, in_tgt, acc), chain()
        torch.cuda.synchronize()
        label = f"far field {name} N={n}"
        ulp = torch.tensor(np.spacing(plain.abs().cpu().numpy()), device=dev)
        if not torch.isfinite(got).all():
            fail(f"{label}: non-finite far field")
        if not bool(((table - plain).abs() <= ulp).all()):
            fail(f"{label}: the table is more than one ulp from "
                 f"moments_plain's:\n{table}\n{plain}")
        if not (torch.equal(table, again) and torch.equal(got, twice)):
            fail(f"{label}: two calls differ")
        if not torch.equal(got, given):
            fail(f"{label}: the target kernel differs from the chain given "
                 "the table")
        if name == "uniform" and not torch.equal(got, lib):
            fail(f"{label}: the far field differs from the chain's with "
                 "every body inside the box")
        # The far field's own part (every in-box target's acc taken off),
        # relative norm; 0 where the two are equal (no body outside).
        base = torch.where(in_tgt > 0, acc, 0.0)
        r_plain, r_lib = (0.0 if torch.equal(got, other) else
                          rel_err(got - base, other - base)
                          for other in (whole, lib))
        err["far_field"] = max(err["far_field"], r_plain)
        del again, twice, given, whole, lib, base
        t = (time_ms(kernels), device_ms(kernels),
             time_ms(lambda: ffk.far_field_plain(*args, pos, in_tgt, acc),
                     reps=1),
             time_ms(chain))
        b = bound(OPS_FAR_FIELD_SOURCE * n + OPS_FAR_FIELD_TARGET * n,
                  20 * n + 40 * n)
        bounds[name] = b
        ms[label] = t
        print(f"{label}: table within one ulp of moments_plain's, targets "
              f"equal to the chain given it, each twice bit for bit; "
              f"{r_plain:.3e} from far_field_plain, {r_lib:.3e} from the "
              f"chain (relative norm of the far field); rows M "
              f"{', '.join(f'{float(v):.6g}' for v in table[:, 0])}; "
              f"kernels {t[0]:.4f} ms (device {t[1]:.4f}), plain {t[2]:.4f} "
              f"ms, chain {t[3]:.4f} ms per call; bound {b[0]:.4f} ms "
              f"({b[1]}) {tag}", flush=True)
        del pos, mass, acc
    row = f"far field uniform N={N_UNIFORM}"
    (ms["far_field"], ms["far_field_device"], ms["far_field_plain"],
     ms["far_field_library"]) = ms[row]
    ms["far_field_plummer"] = ms[f"far field plummer N={P3M_GATE['n']}"][0]
    return bounds["uniform"]


def bf16_gate(label: str, bf16, f32, tag: str) -> None:
    """BASELINE.md's gate for the bf16 distance mode: every kinetic-energy
    row of the bf16 run within 1e-4 relative of the f32 run of the same
    configuration, and none equal to it (equal rows would mean the mode
    was dropped)."""
    pairs = list(zip(bf16.kenergy_trace, f32.kenergy_trace))
    worst = max(abs(k - k32) / abs(k32) for (_, k), (_, k32) in pairs)
    equal = sum(k == k32 for (_, k), (_, k32) in pairs)
    print(f"bf16 {label}: KE rows {[f'{k:.7g}' for _, k in bf16.kenergy_trace]}"
          f" vs f32 {[f'{k:.7g}' for _, k in f32.kenergy_trace]}, largest "
          f"relative difference {worst:.3e}, {equal} rows equal; GFLOP/s bf16 "
          f"{bf16.av:.6g} +- {bf16.dev:.6g}, f32 {f32.av:.6g} +- "
          f"{f32.dev:.6g} {tag}", flush=True)
    if len(pairs) != 10 or worst > 1e-4:
        fail(f"bf16 {label}: KE over 1e-4 from f32")
    if equal:
        fail(f"bf16 {label}: {equal} KE rows equal the f32 run's")


def bf16_phases(dev, tag: str, ms: dict) -> None:
    """Phase 20: the bf16 distance mode; fills ``ms``."""
    import torch

    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.ops import (
        fused_block,
        mxu_kernel,
        sym_kernel,
        tiled_kernel,
    )
    from nbody_tpu_torch.parallel import ring_kernel

    bf = "bfloat16"
    a = make_state(4096, seed=1, device=dev)
    c = make_state(4096, seed=2, device=dev)
    ts = (a.pos, a.mass, c.pos, c.mass)
    for n in (16384, 131072):
        st = make_state(n, device=dev)
        pos, mass = st.pos, st.mass
        cases = {
            "A": (lambda: tiled_kernel.accelerations(pos, mass, dist_dtype=bf),
                  lambda: tiled_kernel.accelerations_between_plain(
                      pos, pos, mass, dist_dtype=bf)),
            "B": (lambda: sym_kernel.accelerations(pos, mass, dist_dtype=bf),
                  lambda: sym_kernel.accelerations_plain(pos, mass,
                                                         dist_dtype=bf)),
        }
        if n == 16384:
            cases["two_sided"] = (
                lambda: torch.cat(sym_kernel.accelerations_two_sided(
                    *ts, dist_dtype=bf), dim=1),
                lambda: torch.cat(sym_kernel.accelerations_two_sided_plain(
                    *ts, dist_dtype=bf), dim=1))
        for key, (kern, plain) in cases.items():
            got, again, want = kern(), kern(), plain()
            torch.cuda.synchronize()
            rel = rel_err(got, want)
            shape = "4096 x 4096" if key == "two_sided" else f"N={n}"
            if not torch.isfinite(got).all():
                fail(f"bf16 {key} {shape}: non-finite output")
            if rel > REL_TOL:
                fail(f"bf16 {key} {shape} disagrees with its bf16 plain "
                     "version")
            if not torch.equal(got, again):
                fail(f"bf16 {key} {shape}: two launches differ")
            mom = ""
            if key == "B":
                f = got.double() * mass.double()
                drift = float(f.sum(1).abs().max() / f.abs().sum(1).max())
                mom = f"; momentum |sum m a| / sum |m a| {drift:.3e}"
                if drift >= 1e-3:
                    fail(f"bf16 Kernel B at {shape} does not conserve momentum")
            timing = ""
            if n == 16384:
                ms[f"{key}_bf16"] = time_ms(kern)
                ms[f"{key}_bf16_plain"] = time_ms(plain, reps=5)
                timing = (f"; kernel {ms[f'{key}_bf16']:.4f} ms, plain "
                          f"{ms[f'{key}_bf16_plain']:.4f} ms per call {tag}")
                if key == "two_sided":  # its call's Python outlasts its kernels
                    ms["two_sided_bf16_device"] = device_ms(
                        lambda: sym_kernel.accelerations_two_sided(
                            *ts, dist_dtype=bf))
                    timing += (f"; {ms['two_sided_bf16_device']:.4f} ms on "
                               "the card (CUDA graph)")
            print(f"bf16 {key} ({shape}): vs bf16 plain {rel:.3e}, repeats "
                  f"bit for bit{mom}{timing}", flush=True)
            del got, again, want
        del st, pos, mass, cases
    n = 131072
    for kernel, mod, other in (("auto", sym_kernel, tiled_kernel),
                               ("pallas", tiled_kernel, sym_kernel)):
        runs = {}
        for precision in ("f32", "bf16"):
            tiled_kernel.launches = sym_kernel.launches = 0
            # sfreq 10: ten KE rows, and GFLOP/s over blocks 3..10.
            runs[precision] = run(SimConfig(n=n, nsteps=100, sfreq=10,
                                            kernel=kernel, precision=precision),
                                  quiet=True)
            if (mod.launches, other.launches) != (110, 0):
                fail(f"N={n} {kernel} {precision}: {mod.__name__} launches "
                     f"{mod.launches} != 110 or {other.__name__} launches "
                     f"{other.launches} != 0")
        bf16_gate(f"N={n} 100 steps kernel={kernel}", runs["bf16"],
                  runs["f32"], tag)
    # ring_sym passes the mode to both of its kernels.
    others = (tiled_kernel, fused_block, mxu_kernel, ring_kernel)
    runs = {}
    for precision in ("f32", "bf16"):
        for mod in others + (sym_kernel,):
            mod.launches = 0
        sym_kernel.two_sided_launches = 0
        runs[precision] = run(SimConfig(n=2000, nsteps=500, shards=4,
                                        comm="ring_sym", precision=precision),
                              quiet=True)
        counts = (sym_kernel.launches, sym_kernel.two_sided_launches) + tuple(
            mod.launches for mod in others)
        if counts != (2200, 3300, 0, 0, 0, 0):
            fail(f"ring_sym {precision} N=2000/500: sym/two-sided/tiled/fused/"
                 f"mxu/ring launches {counts} != (2200, 3300, 0, 0, 0, 0)")
    print("bf16 ring_sym N=2000/500 shards=4: 2200 Kernel B and 3300 two-sided "
          "launches in each precision, no other kernel", flush=True)
    bf16_gate("N=2000/500 shards=4 comm=ring_sym", runs["bf16"], runs["f32"],
              tag)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nbody_tpu_torch import SimConfig, make_state, run
    from nbody_tpu_torch.examples import fit_velocities
    from nbody_tpu_torch.models.gravity import make_accel_fn, make_block_fn
    from nbody_tpu_torch.models.rollout import make_rollout_fn
    from nbody_tpu_torch.ops import (
        fused_block,
        grad,
        naive,
        pm,
        sym_kernel,
        tiled_kernel,
        vjp_kernel,
    )
    from nbody_tpu_torch.utils import build
    from nbody_tpu_torch.utils.reporting import _g5, parse_trace

    # 1. The card.
    lap = Laps()
    card = card_line()
    tag = f"[{card}]"
    dev = torch.device("cuda", 0)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lap("1")

    # 2. The build.
    path, secs = build.build(verbose=True)
    build.library()
    print(f"build: {secs:.2f} s -> {os.path.relpath(path, ROOT)}", flush=True)
    lap("2")

    # 3. Kernels against their plain versions.
    err = {"A": 0.0, "B": 0.0}
    for n, n_pad in ((2048, 2048), (16384, 16384), (2000, 2048)):
        st = make_state(n, pad_multiple=n_pad, device=dev)
        pos, mass = st.pos, st.mass
        a = tiled_kernel.accelerations(pos, mass)
        a_plain = tiled_kernel.accelerations_between_plain(pos, pos, mass)
        b = sym_kernel.accelerations(pos, mass)
        b_plain = sym_kernel.accelerations_plain(pos, mass)
        ref = naive.accelerations(pos, mass)
        torch.cuda.synchronize()
        ra, rb = rel_err(a, a_plain), rel_err(b, b_plain)
        err["A"] = max(err["A"], float((a - a_plain).abs().max()))
        err["B"] = max(err["B"], float((b - b_plain).abs().max()))
        print(f"kernels N={n} (padded {n_pad}): tiled vs plain {ra:.3e}, "
              f"sym vs plain {rb:.3e}; vs naive: tiled "
              f"{rel_err(a, ref):.3e}, sym {rel_err(b, ref):.3e}", flush=True)
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            fail(f"non-finite accelerations at N={n}")
        if ra > REL_TOL or rb > REL_TOL:
            fail(f"kernel disagrees with its plain version at N={n}")
        if n_pad > n:
            if bool((b[:, n:] != 0).any()):
                fail("sym kernel: padded particles got non-zero acceleration")
            # Kernel A masks ragged sources itself: the unpadded sweep must
            # give the real targets exactly what the padded one gives.
            real = [t.contiguous() for t in (pos[:, :n], mass[:n])]
            a_real = tiled_kernel.accelerations(*real)
            if not torch.equal(a_real, a[:, :n]):
                fail("tiled kernel: padded sources changed the result")
            print(f"padding N={n}->{n_pad}: sym padded columns exactly 0, "
                  "tiled unpadded == padded exactly", flush=True)
    # Kernel A at counts that are no multiple of its tiles, and at one
    # shard's shapes of N=2000 over 4 shards.
    st = make_state(2000, device=dev)
    lib = build.library()
    for nt, ns in ((300, 300), (1000, 1000), (2000, 2000), (500, 2000),
                   (500, 500)):
        lo = 0 if nt == ns else 1000
        tgt = st.pos[:, lo:lo + nt].contiguous()
        src, m = st.pos[:, :ns].contiguous(), st.mass[:ns].contiguous()
        a = tiled_kernel.accelerations_between(tgt, src, m)
        again = tiled_kernel.accelerations_between(tgt, src, m)
        plain = tiled_kernel.accelerations_between_plain(tgt, src, m)
        torch.cuda.synchronize()
        ra = rel_err(a, plain)
        err["A"] = max(err["A"], float((a - plain).abs().max()))
        ti = tiled_kernel.default_tile_i(nt, dev)
        print(f"tiled {nt} x {ns} (tile_i {ti}, "
              f"{lib.nbt_tiled_targets(ti, tiled_kernel.DEFAULT_TILE_J)} "
              f"target(s) a thread): vs plain {ra:.3e}", flush=True)
        if not torch.isfinite(a).all() or ra > REL_TOL:
            fail(f"tiled kernel disagrees with its plain version at "
                 f"{nt} x {ns}")
        if not torch.equal(a, again):
            fail(f"tiled kernel: two launches at {nt} x {ns} differ")
    print("tiled: ragged and shard shapes repeat bit for bit", flush=True)
    # Kernel B at every R its launcher picks (nbt::sym_targets: R from the
    # block), zero-mass padded.
    seen = set()
    for n, block in SYM_SHAPES:
        r = sym_kernel.lane_targets(block)
        seen.add(r)
        st = make_state(n - 24, pad_multiple=block, device=dev)
        b = sym_kernel.accelerations(st.pos, st.mass, block=block)
        again = sym_kernel.accelerations(st.pos, st.mass, block=block)
        plain = sym_kernel.accelerations_plain(st.pos, st.mass, block)
        torch.cuda.synchronize()
        rb = rel_err(b, plain)
        err["B"] = max(err["B"], float((b - plain).abs().max()))
        print(f"sym N={n} (real {n - 24}) block {block}: R = {r} targets a "
              f"lane, vs plain {rb:.3e}", flush=True)
        if not torch.isfinite(b).all() or rb > REL_TOL:
            fail(f"sym kernel disagrees with its plain version at N={n}, "
                 f"block {block}")
        if not torch.equal(b, again):
            fail(f"sym kernel: two launches at N={n}, block {block} differ")
        if bool((b[:, n - 24:] != 0).any()):
            fail(f"sym kernel: padding got non-zero acceleration at N={n}")
    if seen != every_targets():
        fail(f"sym kernel: R {sorted(seen)} seen, not every R of "
             f"{sorted(every_targets())}")
    print(f"sym: every R of {sorted(seen)} within {REL_TOL} of plain, repeats "
          "bit for bit, padding exactly 0", flush=True)
    lap("3")

    # 4. The main path through both kernels.
    with open(GOLDEN) as f:
        golden = parse_trace(f.read())
    launches = {}
    gf = {}  # "N config" -> (GFLOP/s mean, dev)
    for label, kernel, mod, other in (
        ("B", "auto", sym_kernel, tiled_kernel),
        ("A", "pallas", tiled_kernel, sym_kernel),
    ):
        tiled_kernel.launches = 0
        sym_kernel.launches = 0
        res = run(SimConfig(n=2000, nsteps=500, kernel=kernel), out=sys.stdout)
        launches[label] = mod.launches
        print(f"main path kernel={kernel}: {mod.__name__} launches "
              f"{mod.launches}, {other.__name__} launches {other.launches}; "
              f"{res.av:.5g} +- {res.dev:.5g} GFLOP/s {tag}", flush=True)
        if mod.launches < 500 or other.launches != 0:
            fail(f"kernel={kernel} did not run through {mod.__name__} alone")
        got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
        if got != golden:
            fail(f"kernel={kernel} trace {got} != golden {golden}")
        print(f"main path kernel={kernel}: all {len(golden)} kinetic-energy "
              "rows equal ver0_n2000_s500.txt at %.5g", flush=True)
        gf[f"2000 {kernel}"] = (res.av, res.dev)
    lap("4")

    # 5. The numbers.
    res = run(SimConfig(n=16384, nsteps=500), quiet=True)
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"N=16384 kinetic energies not finite and positive: {kes}")
    n = 16384
    print(f"N={n} 500 steps auto: {res.av:.6g} +- {res.dev:.6g} GFLOP/s "
          f"(29N^2+19N model), total {res.total_time:.4f} s {tag}", flush=True)
    gf[f"{n} auto"] = (res.av, res.dev)
    st = make_state(n, device=dev)
    pos, mass = st.pos, st.mass
    ms = {
        "naive": time_ms(lambda: naive.accelerations(pos, mass)),
        "A_plain": time_ms(lambda: tiled_kernel.accelerations_between_plain(
            pos, pos, mass)),
        "A": time_ms(lambda: tiled_kernel.accelerations(pos, mass)),
        "B": time_ms(lambda: sym_kernel.accelerations(pos, mass)),
        "B_plain": time_ms(lambda: sym_kernel.accelerations_plain(pos, mass)),
    }
    ms["A_again"] = time_ms(lambda: tiled_kernel.accelerations(pos, mass))
    for name, t in ms.items():
        print(f"sweep N={n} {name}: {t:.4f} ms, {n * n / t / 1e6:.1f} "
              f"Gpairs/s (N^2 model) {tag}", flush=True)
    lap("5")

    # 6. The fused blocks against their plain versions.
    for label, _, _ in FUSED:
        err[label] = 0.0
    for n, n_pad in ((2048, 2048), (2000, 2048)):
        st = make_state(n, pad_multiple=n_pad, device=dev)
        for label, ti, tj in FUSED:
            for integrator in ("euler", "leapfrog"):
                args = (st.pos, st.vel, st.mass, 0.1, BLOCK, ti, tj, integrator)
                p, v = fused_block.fused_block(*args)
                p2, v2 = fused_block.fused_block(*args)
                p_ref, v_ref = fused_block.fused_block_plain(*args)
                torch.cuda.synchronize()
                rp, rv = rel_err(p, p_ref), rel_err(v, v_ref)
                err[label] = max(err[label], float((p - p_ref).abs().max()),
                                 float((v - v_ref).abs().max()))
                print(f"fused {label} {integrator} N={n} (padded {n_pad}), "
                      f"{BLOCK} steps: pos vs plain {rp:.3e}, vel vs plain "
                      f"{rv:.3e}", flush=True)
                if not (torch.isfinite(p).all() and torch.isfinite(v).all()):
                    fail(f"fused {label} {integrator}: non-finite state")
                if rp > REL_TOL or rv > REL_TOL:
                    fail(f"fused {label} {integrator} disagrees with its "
                         f"plain version at N={n}")
                if not (torch.equal(p, p2) and torch.equal(v, v2)):
                    fail(f"fused {label} {integrator}: two launches on one "
                         "input differ")
                # Padding: the rows layout divides by the mass, so padded
                # particles get exactly 0; the columns layout, as JAX's
                # _kernel and Kernel A, gives a zero-mass target the real
                # particles' pull, about 1e-16 from its place 1e6 away.
                v_pad = float(v[:, n:].abs().max()) if n_pad > n else 0.0
                if v_pad != 0 and (label == "rows" or v_pad > 1e-9):
                    fail(f"fused {label} {integrator}: padded particles "
                         f"moved, |v| up to {v_pad:.3e}")
        for label, ti, tj, kernel in (("rows", 0, 0, "pallas_sym"),
                                      ("columns", 64, 256, "pallas")):
            p, v = fused_block.fused_block(st.pos, st.vel, st.mass, 0.1,
                                           BLOCK, ti, tj)
            blk = make_block_fn(make_accel_fn(kernel, tile_i=ti or 128,
                                              tile_j=tj), 0.1, BLOCK)
            want, _ = blk(st)
            same = torch.equal(p, want.pos) and torch.equal(v, want.vel)
            print(f"fused {label} euler N={n}: bit for bit equal to the "
                  f"unfused {kernel} block: {same}; max abs diff pos "
                  f"{float((p - want.pos).abs().max()):.3e}", flush=True)
            if not same:
                fail(f"fused {label} Euler block differs from the unfused "
                     f"{kernel} block")
        print(f"fused N={n}: both layouts repeat bit for bit; padded "
              "velocities exactly 0 in the rows layout", flush=True)
    lap("6")

    # 7. The fused main path, through each layout.
    for label, ti, tj in FUSED:
        fused_block.launches = tiled_kernel.launches = sym_kernel.launches = 0
        res = run(SimConfig(n=2000, nsteps=500, fused=True, tile_i=ti,
                            tile_j=tj), out=sys.stdout)
        launches[label] = fused_block.launches
        print(f"fused main path {label}: fused_block launches "
              f"{fused_block.launches}, sym {sym_kernel.launches}, tiled "
              f"{tiled_kernel.launches}; {res.av:.6g} +- {res.dev:.6g} "
              f"GFLOP/s {tag}", flush=True)
        if (fused_block.launches, sym_kernel.launches,
                tiled_kernel.launches) != (11, 0, 0):
            fail(f"fused {label} run did not go through the fused kernel "
                 "alone, once a block")
        got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
        if got != golden:
            fail(f"fused {label} trace {got} != golden {golden}")
        print(f"fused main path {label}: all {len(golden)} kinetic-energy "
              "rows equal ver0_n2000_s500.txt at %.5g", flush=True)
        gf[f"2000 fused {label}"] = (res.av, res.dev)
    res = run(SimConfig(n=2000, nsteps=500, fused=True,
                        integrator="leapfrog"), quiet=True)
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"fused leapfrog energies not finite and positive: {kes}")
    print(f"fused leapfrog N=2000/500: energies finite and positive, "
          f"{kes[0]:.5g} .. {kes[-1]:.5g}", flush=True)
    lap("7")

    # 8. The fused numbers.
    n = 16384
    fused_block.launches = tiled_kernel.launches = sym_kernel.launches = 0
    res = run(SimConfig(n=n, nsteps=500, fused=True), quiet=True)
    counts = (fused_block.launches, sym_kernel.launches, tiled_kernel.launches)
    print(f"fused N={n} rows: fused_block launches {counts[0]}, sym "
          f"{counts[1]}, tiled {counts[2]}", flush=True)
    if counts != (11, 0, 0):
        fail(f"fused N={n} run did not go through the fused kernel alone, "
             "once a block")
    kes = [ke for _, ke in res.kenergy_trace]
    if len(kes) != 10 or not all(k == k and 0 < k < float("inf") for k in kes):
        fail(f"N={n} fused kinetic energies not finite and positive: {kes}")
    gf[f"{n} fused rows"] = (res.av, res.dev)
    for key in ("2000 auto", "2000 fused rows", "2000 fused columns",
                f"{n} auto", f"{n} fused rows"):
        av, sd = gf[key]
        print(f"N={key}, 500 steps: {av:.6g} +- {sd:.6g} GFLOP/s "
              f"(29N^2+19N model) {tag}", flush=True)
    st = make_state(n, device=dev)
    for label, ti, tj in FUSED:
        args = (st.pos, st.vel, st.mass, 0.1, BLOCK, ti, tj)
        p, v = fused_block.fused_block(*args)
        p2, v2 = fused_block.fused_block(*args)
        p_ref, v_ref = fused_block.fused_block_plain(*args)
        torch.cuda.synchronize()
        rp, rv = rel_err(p, p_ref), rel_err(v, v_ref)
        err[label] = max(err[label], float((p - p_ref).abs().max()),
                         float((v - v_ref).abs().max()))
        print(f"fused {label} euler N={n}, {BLOCK} steps: pos vs plain "
              f"{rp:.3e}, vel vs plain {rv:.3e}", flush=True)
        if not (torch.isfinite(p).all() and torch.isfinite(v).all()):
            fail(f"fused {label} N={n}: non-finite state")
        if rp > REL_TOL or rv > REL_TOL:
            fail(f"fused {label} disagrees with its plain version at N={n}")
        if not (torch.equal(p, p2) and torch.equal(v, v2)):
            fail(f"fused {label} N={n}: two launches on one input differ")
        if label == "rows":  # Kernel B's R at block 128, the same as the CTA's
            blk = make_block_fn(make_accel_fn("pallas_sym", tile_i=128), 0.1,
                                BLOCK)
            want, _ = blk(st)
            if not (torch.equal(p, want.pos) and torch.equal(v, want.vel)):
                fail(f"fused rows Euler block at N={n} differs from the "
                     "unfused pallas_sym block")
            print(f"fused rows euler N={n} (R = "
                  f"{sym_kernel.lane_targets(128)}): bit for bit equal to the "
                  "unfused pallas_sym block", flush=True)
            del want
        del p, v, p2, v2, p_ref, v_ref
        ms[label] = time_ms(lambda: fused_block.fused_block(*args), reps=5)
        ms[f"{label}_plain"] = time_ms(
            lambda: fused_block.fused_block_plain(*args), reps=2)
        print(f"fused block N={n} {label}, {BLOCK} steps: kernel "
              f"{ms[label]:.4f} ms, plain {ms[f'{label}_plain']:.4f} ms; "
              f"{BLOCK * n * n / ms[label] / 1e6:.1f} Gpairs/s (N^2 model) "
              f"{tag}", flush=True)
    lap("8")

    # 9. The force VJP kernel against its plain version.
    err["vjp"] = 0.0
    got = {}
    for n in (2048, 16384, 2000):
        st = make_state(n, device=dev)
        pos, mass = st.pos, st.mass
        g = naive.accelerations(pos, mass) * G_SCALE
        d = vjp_kernel.force_vjp(pos, mass, g)
        d2 = vjp_kernel.force_vjp(pos, mass, g)
        plain = grad.force_vjp(pos, mass, g)
        f64 = grad.force_vjp(pos.double(), mass.double(), g.double())
        torch.cuda.synchronize()
        got[n] = d
        if not all(torch.isfinite(t).all() for t in d):
            fail(f"vjp kernel: non-finite cotangents at N={n}")
        if not all(torch.equal(a, b) for a, b in zip(d, d2)):
            fail(f"vjp kernel: two launches at N={n} differ")
        rk = [rel_err(a, b) for a, b in zip(d, f64)]
        rp = [rel_err(a, b) for a, b in zip(plain, f64)]
        rel = [rel_err(a, b) for a, b in zip(d, plain)]
        err["vjp"] = max([err["vjp"]] + [float((a - b).abs().max())
                                          for a, b in zip(d, plain)])
        print(f"vjp N={n}: kernel vs plain d_pos {rel[0]:.3e}, d_mass "
              f"{rel[1]:.3e}; vs float64: kernel {rk[0]:.3e}/{rk[1]:.3e}, "
              f"plain {rp[0]:.3e}/{rp[1]:.3e} (d_pos/d_mass); repeats bit "
              "for bit", flush=True)
        if max(rel) > VJP_TOL:
            fail(f"vjp kernel disagrees with its plain version at N={n}")
    st = make_state(2000, pad_multiple=2048, device=dev)
    g = torch.zeros_like(st.pos)
    g[:, :2000] = naive.accelerations(st.pos[:, :2000].contiguous(),
                                      st.mass[:2000].contiguous()) * G_SCALE
    d_pad = vjp_kernel.force_vjp(st.pos, st.mass, g)
    if not (torch.equal(d_pad[0][:, :2000], got[2000][0])
            and torch.equal(d_pad[1][:2000], got[2000][1])):
        fail("vjp kernel: zero-mass padding changed the real cotangents")
    print("vjp padding N=2000->2048, zero cotangent on the padding: "
          "equal to the unpadded run bit for bit", flush=True)
    st = make_state(256, device=dev)
    p, m = st.pos.clone().requires_grad_(True), st.mass.clone().requires_grad_(True)
    for name, call in (
            ("tiled", lambda: tiled_kernel.accelerations(p, m)),
            ("sym", lambda: sym_kernel.accelerations(p, m)),
            ("fused", lambda: fused_block.fused_block(p, st.vel, m, 0.1, 2))):
        try:
            call()
        except RuntimeError as e:
            if "differentiable=True" not in str(e):
                raise
        else:
            fail(f"{name} kernel accepted inputs that require grad")
    print("tiled, sym and fused kernels refuse inputs that require grad",
          flush=True)
    n = 16384
    st = make_state(n, device=dev)
    pos, mass = st.pos, st.mass
    g = naive.accelerations(pos, mass) * G_SCALE
    ms["vjp"] = time_ms(lambda: vjp_kernel.force_vjp(pos, mass, g))
    ms["vjp_plain"] = time_ms(lambda: grad.force_vjp(pos, mass, g), reps=5)
    print(f"vjp N={n}: kernel {ms['vjp']:.4f} ms, plain {ms['vjp_plain']:.4f} "
          f"ms per call; {n * n / ms['vjp'] / 1e6:.1f} Gpairs/s (N^2 model) "
          f"{tag}", flush=True)
    lap("9")

    # 10. The differentiable rollout at full width.
    steps = 10
    with torch.no_grad():
        target = make_rollout_fn(make_accel_fn("auto"), 0.1, steps)(
            st.pos, st.vel, st.mass)[0]

    def rollout_grads(backward_opts=None, remat=True):
        accel = make_accel_fn("auto", differentiable=True,
                              backward_opts=backward_opts)
        rollout = make_rollout_fn(accel, 0.1, steps, remat=remat)
        vel = (0.5 * st.vel).requires_grad_(True)
        m = st.mass.clone().requires_grad_(True)
        d = rollout(st.pos, vel, m)[0] - target
        torch.sum(d * d).backward()
        return vel.grad, m.grad

    vjp_kernel.launches = sym_kernel.launches = tiled_kernel.launches = 0
    grads = rollout_grads()
    torch.cuda.synchronize()
    counts = (vjp_kernel.launches, sym_kernel.launches, tiled_kernel.launches)
    launches["vjp"] = counts[0]
    print(f"rollout N={n}, {steps} Euler steps, remat: vjp launches "
          f"{counts[0]}, sym {counts[1]}, tiled {counts[2]}", flush=True)
    if counts != (steps, 2 * steps, 0):
        fail(f"rollout launches {counts} != ({steps}, {2 * steps}, 0)")
    if not all(t is not None and torch.isfinite(t).all() and t.abs().max() > 0
               for t in grads):
        fail("rollout gradients missing, non-finite or zero")
    plain = rollout_grads({"backward": "jnp"})
    rel = [rel_err(a, b) for a, b in zip(grads, plain)]
    same = all(torch.equal(a, b) for a, b in zip(grads, rollout_grads(remat=False)))
    print(f"rollout N={n}: kernel vs plain backward d_vel {rel[0]:.3e}, "
          f"d_mass {rel[1]:.3e}; remat equals no remat bit for bit: {same}",
          flush=True)
    if max(rel) > ROLLOUT_TOL:
        fail("rollout gradients disagree with the plain backward")
    if not same:
        fail("rollout gradients with remat differ from those without")
    ms["rollout"] = time_ms(lambda: rollout_grads(), reps=5)
    print(f"rollout N={n}, {steps} Euler steps: forward + backward "
          f"{ms['rollout']:.4f} ms {tag}", flush=True)
    rc = fit_velocities.main(["2048", "10", "60"])
    if rc != 0:
        fail(f"examples.fit_velocities 2048 10 60 exited {rc}")
    print(f"fit_velocities N=2048, 10 steps, 60 iterations: recovered {tag}",
          flush=True)
    lap("10")

    # 11. --energy-check.
    res = run(SimConfig(n=2000, nsteps=500, energy_check=True), out=sys.stdout)
    got = [(s, _g5(ke)) for s, ke in res.kenergy_trace]
    if got != golden:
        fail(f"energy-check trace {got} != golden {golden}")
    if not (res.energy_drift is not None and math.isfinite(res.energy_drift)):
        fail(f"energy drift {res.energy_drift} is not finite")
    print(f"energy check N=2000/500: all {len(golden)} kinetic-energy rows "
          f"equal the golden trace; drift {res.energy_drift:.6e}", flush=True)
    res = run(SimConfig(n=512, nsteps=100, dt=0.01, distribution="plummer",
                        seed=7, integrator="leapfrog", energy_check=True),
              quiet=True)
    print(f"energy check plummer N=512, 100 leapfrog steps: drift "
          f"{res.energy_drift:.6e}", flush=True)
    if not res.energy_drift < 1e-4:
        fail(f"plummer energy drift {res.energy_drift} >= 1e-4")
    res = run(SimConfig(n=16384, nsteps=500, energy_check=True), quiet=True)
    print(f"energy check N=16384/500 auto: drift {res.energy_drift:.6e}, "
          f"{res.av:.6g} +- {res.dev:.6g} GFLOP/s {tag}", flush=True)
    if not math.isfinite(res.energy_drift):
        fail("N=16384 energy drift is not finite")

    lap("11")
    sr = mesh_phases(dev, tag, err, ms, launches)
    lap("12-14")
    sharded_phases(dev, tag, err, ms, launches, golden, gf)
    lap("15-17")
    repair_phases(dev, tag)
    lap("18")
    mxu_phases(dev, tag, err, ms, launches, golden, gf)
    lap("19")
    bf16_phases(dev, tag, ms)
    lap("20")
    periodic_phases(dev, tag, ms, launches)
    lap("21")
    vjp_work = grad_phases(dev, tag, err, ms, launches)
    lap("22")
    deposit_bound = deposit_phases(dev, tag, err, ms)
    lap("23")
    far_field_bound = far_field_phases(dev, tag, err, ms)
    lap("24")

    # The bounds, from this run's inputs: the least work of each function,
    # whatever layout its kernel takes.  Kernel A and the columns block
    # compute what Kernel B and the rows block do, so all four count N^2/2
    # unordered pairs; the short-range sum counts the layout that needs the
    # fewest operations at these inputs.
    n = 16384
    bounds_ms = {
        "B": bound(OPS_SYM * n * n / 2, 28 * n),
        "A": bound(OPS_SYM * n * n / 2, 28 * n),
        "rows": bound(BLOCK * OPS_SYM * n * n / 2, 52 * n),
        "columns": bound(BLOCK * OPS_SYM * n * n / 2, 52 * n),
        "vjp": bound(OPS_VJP * n * n, 44 * n),
        # One ring_sym block pair: every cross pair once.
        "two_sided": bound(OPS_SYM * (n // 4) ** 2, 28 * 2 * (n // 4)),
        # The ring computes what Kernel B does: N^2/2 unordered pairs.
        "ring": bound(OPS_SYM * n * n / 2, 28 * n),
        # The mxu function: N^2 ordered pairs of the |r|^2 expansion.
        "mxu": bound_mxu(n * n, 28 * n),
    }
    bounds_ms["sr"] = min(
        bound(n_e * pm.SLAB * width * (OPS_SR + OPS_SR_REACTION * sym),
              28 * nslots + 8 * n_e)
        for n_e, width, sym, _, _, nslots, _ in sr.values())
    # The VJP: the pairs this run's data needs in the layout it runs and in
    # the cheapest (pallas_sym); bytes: the tables and the cotangent read,
    # gp and gm written, the worklist read.
    bounds_ms["deposit"] = deposit_bound
    bounds_ms["far_field"] = far_field_bound
    bounds_ms["sr_vjp"] = min(
        bound(inside * OPS_SR_VJP + (pairs - inside) * OPS_SR_TEST
              + react * OPS_SR_VJP_REACTION, 44 * nslots + 8 * n_e)
        for pairs, inside, react, nslots, n_e in vjp_work.values())
    # The row's times: the layout the main path ran.
    sr_default = next(name for name, state in pm.SR_LAYOUTS.items()
                      if state == pm._active_sr_layout(True))
    _, _, _, ms["sr"], ms["sr_plain"], _, sr_skip = sr[sr_default]
    rows = [
        ("sym_pairs_kernel+sym_reduce_kernel (Kernel B)", "sym.cu",
         "nbody_tpu/ops/pallas_sym.py:85", "B"),
        ("tiled_accel_kernel (Kernel A)", "tiled.cu",
         "nbody_tpu/ops/pallas_kernel.py:58", "A"),
        ("fused_rows_kernel (fused block, rows layout)", "fused.cu",
         "nbody_tpu/ops/fused_block.py:163", "rows"),
        ("fused_cols_kernel (fused block, columns layout)", "fused.cu",
         "nbody_tpu/ops/fused_block.py:78", "columns"),
        ("force_vjp_kernel", "vjp.cu", "nbody_tpu/ops/grad.py:102", "vjp"),
        (f"sr_pack_kernel+sr_pairs_kernel+sr_finalize_kernel (P3M short "
         f"range, {sr_default} layout)", "sr.cu", "nbody_tpu/ops/pm.py:1630",
         "sr"),
        ("two_sided_kernel+two_sided_reduce_kernel (two-sided sweep)",
         "two_sided.cu", "nbody_tpu/ops/pallas_sym.py:211", "two_sided"),
        ("ring_kernel (fused ring, K=4)", "ring.cu",
         "nbody_tpu/parallel/ring_kernel.py:55", "ring"),
        ("mxu_accel_kernel (|r|^2 expansion, pallas_mxu)", "mxu.cu",
         "nbody_tpu/ops/pallas_mxu.py:48", "mxu"),
        ("sr_vjp_pack_kernel+sr_vjp_pass_kernel<target>+"
         "sr_vjp_pass_kernel<source>+sr_vjp_finalize_kernel x2+"
         "sr_vjp_combine_kernel+sr_vjp_sum_kernel (P3M short-range VJP, "
         "pallas layout)", "sr_vjp.cu",
         "nbody_tpu/ops/pm.py:1844 _sr_ad_bwd (XLA; no Pallas kernel)",
         "sr_vjp"),
        ("deposit_zero_kernel+deposit_mass_kernel+deposit_cic_kernel+"
         "deposit_convert_kernel (CIC deposit in 64-bit fixed point, uniform "
         "N=1048576, open)", "deposit.cu",
         "none: nbody_tpu/ops/pm.py deposits with an XLA scatter-add",
         "deposit"),
        ("far_field_moments_kernel+far_field_monopoles_kernel (the open "
         "far field, uniform N=1048576)", "far_field.cu",
         "none: nbody_tpu/ops/pm.py _outlier_moments and _monopole are XLA "
         "ops", "far_field"),
    ]
    launches["deposit"] = launches["deposit_p3m"]
    launches["far_field"] = launches["far_field_pm"]
    kernels = [{
        "name": name, "route": "cuda", "source": f"nbody_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": launches[key],
        "max_abs_err": err[key], "ms": ms[key], "plain_ms": ms[f"{key}_plain"],
        "bound_ms": bounds_ms[key][0], "bound_by": bounds_ms[key][1],
        # No one PyTorch call computes any of them but the deposit
        # (_scatter's accumulating index_put_) and the far field (the
        # nine-call chain), which they replace.
        "library_ms": ms.get(f"{key}_library"),
        # ms is a wrapper call's; where its Python outlasts its kernels, the
        # device time of the kernels alone goes beside it.
        **({"device_ms": ms[f"{key}_device"]} if f"{key}_device" in ms
           else {}),
        # The SR kernel skips (warp, source) steps wholly beyond the cutoff,
        # which the bound counts as work: the share it skipped goes beside,
        # and its call and launches on the periodic main path (phase 21).
        **({"skipped_share": sr_skip, "periodic_ms": ms["sr_periodic"],
            "periodic_launches": launches["sr_periodic"],
            "ad_launches": launches["sr_ad"]}
           if key == "sr" else {}),
        # The VJP's call on the periodic row's ghost-extended tables, its
        # main path's run (a 10-step rollout gradient with remat), the
        # share of (warp, other) steps each pass skips and a call's peak
        # memory beyond what it was handed.
        **({"periodic_ms": ms["sr_vjp_periodic"],
            "rollout_ms": ms["rollout_p3m"],
            "skipped_share": ms["sr_vjp_skipped"],
            "peak_mb": ms["sr_vjp_peak_mb"]} if key == "sr_vjp" else {}),
        # The deposit on the periodic row's grid (bodies wrapped).
        **({"periodic_ms": ms["deposit_periodic"]} if key == "deposit"
           else {}),
        # The far field at the Plummer gate (bodies outside the box).
        **({"plummer_ms": ms["far_field_plummer"]} if key == "far_field"
           else {}),
    } for name, src, replaces, key in rows]
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    t_start = time.perf_counter()
    rc = main()
    print(f"# chip_smoke.py: {time.perf_counter() - t_start:.1f} s", file=sys.stderr)
    sys.exit(rc)
