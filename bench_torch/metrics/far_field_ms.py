"""far_field_ms: the device milliseconds a step inside the spans around the
open boundary's far field: the in-box mask of the bodies, the moments of
the in-box mass and of each octant of the mass outside the box, and the
nine monopole evaluations at the targets.  The ``torch.where`` that gives
outside bodies the in-box monopole and the octants' adds lie outside
them."""

SPANS = {"mesh.inside": "nbody_tpu_torch.ops.pm:_inside",
         "mesh.moments": "nbody_tpu_torch.ops.pm:_outlier_moments",
         "mesh.monopole": "nbody_tpu_torch.ops.pm:_monopole"}


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.run.steps:
        return None
    us = t.device_us(*SPANS)
    return us * 1e-3 / ctx.run.steps if us > 0 else None
