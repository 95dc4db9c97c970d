"""periodic_mesh_ms: the device milliseconds a step inside the spans around
the periodic mesh solver's stages: the wrapped deposit, the forward
transform, the inverse transforms on the ng^3 grid, the wrapped gather.
The spectra are constants of the box, made once a run at set-up, so no
span holds them."""

SPANS = {"mesh.deposit_periodic": "nbody_tpu_torch.ops.pm:_deposit_periodic",
         "mesh.fft": "torch.fft:rfftn",
         "mesh.ifft_periodic": "nbody_tpu_torch.ops.pm:_periodic_inverse",
         "mesh.gather_periodic": "nbody_tpu_torch.ops.pm:_gather_periodic"}


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS)
    return us * 1e-3 / ctx.run.steps if us > 0 else None
