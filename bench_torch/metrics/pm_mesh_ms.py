"""pm_mesh_ms: the device milliseconds a step inside the spans around the
plain mesh solver's stages: the block's mesh env (box and kernel spectra),
the deposit, the forward transform, the three spectrum products, the
inverse transforms and the gather.  The profiler credits each kernel to
the innermost range, so where a range nests in another (the inverse
transforms in the products' function, in a tree that calls them there) it
keeps its kernels; the union counts each once."""

SPANS = {"mesh.env": "nbody_tpu_torch.ops.pm:make_mesh_env",
         "mesh.deposit": "nbody_tpu_torch.ops.pm:_deposit",
         "mesh.fft": "torch.fft:rfftn",
         "mesh.grids": "nbody_tpu_torch.ops.pm:_pm_force_grids",
         "mesh.ifft": "nbody_tpu_torch.ops.pm:_inverse",
         "mesh.gather": "nbody_tpu_torch.ops.pm:_gather"}


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS)
    return us * 1e-3 / ctx.run.steps if us > 0 else None
