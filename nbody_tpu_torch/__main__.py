"""CLI entry point.

Positional-argument compatible with the reference binaries, like
``python -m nbody_tpu``:
    python -m nbody_tpu_torch [N] [nsteps] [device] [cpu_ratio] [dim0 dim1]
(ver0/main.cpp:25-46; ver5_all/main.cpp:23-66: the device token is echoed,
``cpu`` selects the CPU, cpu_ratio is accepted for parity, and the thread
dims map onto kernel tile sizes).

Options:
    --kernel {naive,pallas,pallas_sym,pallas_mxu,pm,p3m,auto}  force
                                   kernel (auto: the pair-symmetric CUDA
                                   kernel where it fits; pallas_mxu: the
                                   |r|^2-expansion sweep; pm/p3m: the mesh
                                   tiers)
    --precision {f32,bf16}         fp32 pair deltas, or rounded through bf16
                                   (fp32 arithmetic; not with pallas_mxu,
                                   pm, p3m, --fused, ring_sym or rdma)
    --pm-grid/--pm-cutoff/--pm-capacity  mesh points per axis, the P3M split
                                   radius in grid spacings, P3M slots a cell
    --pm-boundary {open,periodic} --pm-box L  the mesh boundary: open
                                   (default), or the fixed cubic box of
                                   edge L (--kernel pm or p3m)
    --pm-sr-layout NAME            the P3M sweep layout (ops/pm.SR_LAYOUTS;
                                   "xla" is the kernel's plain layout)
    --pm-replan                    regrow the P3M plan mid-run on overflow
    --integrator {euler,leapfrog}  parity default / symplectic option
    --fused                        each sample block in one kernel launch
                                   (f32; rows layout, or columns with a
                                   rectangular --tile-i/--tile-j); --kernel
                                   then sets nothing
    --shards K --comm {allgather,ring,ring_sym,rdma}  particle decomposition
                                   over K shards of the card (or the CPU),
                                   driven by this one process
    --sfreq/--dt                   sample frequency and step size
    --distribution {reference,plummer,cold_sphere}  initial conditions
    --energy-check                 report total-energy (KE+PE) drift at the end
    --tile-i/--tile-j              kernel tiles (pallas_sym: tile-i = block)
    --platform {cuda,cpu}          the card (default) or the CPU on request
    --json PATH                    also write the run result as JSON ('-' =
                                   stdout)
    --profile-dir DIR              write a torch.profiler trace of the
                                   sample blocks into DIR, with the
                                   program's nbt.* spans (block, accel,
                                   mesh and P3M stages, sync.*, health)
    --debug-nans                   raise FloatingPointError on a non-finite
                                   position, velocity or energy after a block
    --list-devices                 print the CUDA devices and the CPU, exit

The JAX package's other options are refused with the ROADMAP.md item that
will port them; ``--interpret`` (Pallas interpret mode) is refused for good.
"""

from __future__ import annotations

import argparse
import sys

from .config import SimConfig
from .simulation import Simulation

# Flags of ``python -m nbody_tpu`` that the port does not have yet.
_NOT_PORTED = {
    "--autotune": "queue 1 item 12 (autotuning)",
    "--autotune-online": "queue 1 item 12 (autotuning)",
    "--save-state": "queue 1 item 12 (checkpoints)",
    "--load-state": "queue 1 item 12 (checkpoints)",
    "--checkpoint-every": "queue 1 item 12 (checkpoints)",
    "--checkpoint-backend": "queue 1 item 12 (checkpoints)",
    "--snapshot-every": "queue 1 item 12 (snapshots)",
    "--snapshot-dir": "queue 1 item 12 (snapshots)",
}


# Flags of ``python -m nbody_tpu`` that the port will not have.
_NEVER = {
    "--interpret": 'Pallas interpret mode is not ported (ROADMAP.md "What is '
                   'not ported"); the kernels\' plain PyTorch versions run '
                   "with --platform cpu",
}


class _Refuse(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        if option_string in _NEVER:
            parser.error(f"{option_string}: {_NEVER[option_string]}")
        parser.error(f"{option_string} is not ported to nbody_tpu_torch yet: "
                     f"ROADMAP.md {_NOT_PORTED[option_string]}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"nbody-tpu-torch {__version__}")
    p.add_argument("n", nargs="?", type=int, default=2000)
    p.add_argument("nsteps", nargs="?", type=int, default=500)
    p.add_argument("device", nargs="?", default=None,
                   help="cpu|gpu|cpu+gpu (reference CLI parity)")
    p.add_argument("cpu_ratio", nargs="?", type=float, default=None)
    p.add_argument("dim0", nargs="?", type=int, default=0)
    p.add_argument("dim1", nargs="?", type=int, default=0)
    p.add_argument("--kernel", default="auto",
                   choices=["naive", "pallas", "pallas_sym", "pallas_mxu",
                            "pm", "p3m", "auto"])
    p.add_argument("--pm-grid", type=int, default=0, metavar="NG",
                   help="mesh points per axis for --kernel pm/p3m "
                        "(default 128)")
    p.add_argument("--pm-cutoff", type=int, default=0, metavar="A",
                   help="P3M split radius in grid spacings (default 4 for "
                        "--kernel p3m; error ~ A^-3, short-range cost ~ A^3)")
    p.add_argument("--pm-capacity", type=int, default=0, metavar="C",
                   help="P3M cell-list slots per cell (default: measured on "
                        "the initial state)")
    p.add_argument("--pm-boundary", default="open",
                   choices=["open", "periodic"],
                   help="mesh boundary: open = isolated system in vacuum "
                        "(default), periodic = fixed cubic box, forces of "
                        "all images minus the uniform background (--kernel "
                        "pm or p3m)")
    p.add_argument("--pm-box", type=float, default=0.0, metavar="L",
                   help="periodic box edge for --pm-boundary periodic "
                        "(positions are wrapped into [0, L))")
    p.add_argument("--pm-replan", action="store_true",
                   help="re-measure the P3M plan mid-run when the per-block "
                        "health check finds overflow (grow-only)")
    p.add_argument("--pm-sr-layout", default="",
                   choices=["", "xla", "pallas", "pallas_sym",
                            "pallas_paired", "pallas_paired_sym"],
                   help="P3M short-range sweep layout (default "
                        "pallas_paired on the card, pallas_sym on the "
                        "CPU; xla = the kernel's plain layout)")
    p.add_argument("--precision", default="f32",
                   help="f32, or bf16: pair deltas rounded through bf16")
    p.add_argument("--integrator", default="euler",
                   choices=["euler", "leapfrog"])
    p.add_argument("--distribution", default="reference")
    p.add_argument("--energy-check", action="store_true",
                   help="report total-energy (KE+PE) drift at the end")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--shards", type=int, default=1)
    p.add_argument("--comm", default="allgather",
                   choices=["allgather", "ring", "ring_sym", "rdma"],
                   help="sharded source exchange: all-gather, ppermute "
                        "ring, the pair-symmetric half-ring (~half the "
                        "compute AND hops), or the fused in-kernel ring")
    p.add_argument("--sfreq", type=int, default=50)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--fused", action="store_true",
                   help="run each sample block in one kernel launch")
    p.add_argument("--tile-i", type=int, default=0)
    p.add_argument("--tile-j", type=int, default=0)
    p.add_argument("--platform", default=None, choices=["cuda", "cpu"])
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the run result as JSON ('-' = stdout)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the sample blocks "
                        "into DIR; it holds the program's nbt.* spans "
                        "(utils/spans.py: the block, each force call, the "
                        "mesh and P3M stages, every host sync as nbt.sync.*, "
                        "the P3M health check)")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise on a non-finite position, velocity or energy "
                        "after a sample block")
    p.add_argument("--list-devices", action="store_true",
                   help="print the CUDA devices and the CPU, then exit")
    for flag in (*_NOT_PORTED, *_NEVER):
        p.add_argument(flag, nargs="?", action=_Refuse, help=argparse.SUPPRESS)
    return p


def list_devices() -> None:
    """The CUDA devices, then the CPU, one ``id: platform kind`` line each,
    as ``python -m nbody_tpu --list-devices`` prints them."""
    import platform

    import torch

    for i in range(torch.cuda.device_count()):
        print(f"{i}: cuda {torch.cuda.get_device_name(i)}")
    print(f"0: cpu {platform.machine() or 'cpu'}")


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_devices:
        list_devices()
        return 0
    try:
        cfg = SimConfig(
            n=args.n, nsteps=args.nsteps, dt=args.dt, sfreq=args.sfreq,
            integrator=args.integrator, distribution=args.distribution,
            seed=args.seed, energy_check=args.energy_check, kernel=args.kernel,
            tile_i=args.tile_i or args.dim0, tile_j=args.tile_j or args.dim1,
            precision=args.precision, fused=args.fused,
            shards=args.shards, comm=args.comm,
            pm_grid=args.pm_grid, pm_cutoff=args.pm_cutoff,
            pm_capacity=args.pm_capacity, pm_boundary=args.pm_boundary,
            pm_box=args.pm_box,
            pm_replan=args.pm_replan, pm_sr_layout=args.pm_sr_layout,
            platform=args.platform or ("cpu" if args.device == "cpu" else None),
            profile_dir=args.profile_dir, debug_nans=args.debug_nans,
        )
    except (NotImplementedError, ValueError) as e:
        parser.error(str(e))
    sim = Simulation(cfg)
    sim.init_mpi()
    if args.device is not None:
        # The reference echoes the token, then maps it onto the device
        # selector (ver5_all/main.cpp:42-45: cpu=1, gpu=2, cpu+gpu=3).
        print(args.device)
        selector = {"cpu": 1, "gpu": 2, "cpu+gpu": 3}.get(args.device)
        if selector is not None:
            sim.set_devices(selector)
    if args.cpu_ratio is not None:
        sim.set_cpu_ratio(args.cpu_ratio)
    result = sim.start()
    if args.json:
        import json

        payload = json.dumps(result.to_dict(), indent=1)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
