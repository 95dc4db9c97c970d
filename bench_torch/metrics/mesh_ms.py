"""mesh_ms: the device milliseconds a step inside the spans around the mesh
solver's stages: the block's mesh env (box and kernel spectra), the
deposit, the forward and the inverse transforms, the gather."""

SPANS = {"mesh.env": "nbody_tpu_torch.ops.pm:make_mesh_env",
         "mesh.deposit": "nbody_tpu_torch.ops.pm:_deposit",
         "mesh.fft": "torch.fft:rfftn",
         "mesh.ifft": "nbody_tpu_torch.ops.pm:_inverse",
         "mesh.gather": "nbody_tpu_torch.ops.pm:_gather"}


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    us = t.device_us(*SPANS)
    return us * 1e-3 / ctx.run.steps if us > 0 else None
