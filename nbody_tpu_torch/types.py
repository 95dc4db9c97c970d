"""Physics constants and the precision policy of the PyTorch port.

The constants are the reference's (ver0/GSimulation.cpp:114-116), as in
``nbody_tpu.types``.  The JAX package offers three force precisions; the
port runs ``f32`` (fp32 deltas and fp32 accumulation) and ``bf16`` (the
bf16 distance mode: deltas subtracted in fp32 and rounded through bf16,
fp32 arithmetic); ``ref64``, the host oracle, is not ported yet.
"""

from __future__ import annotations

# Physics constants, as the reference defines them (ver0/GSimulation.cpp:114-116).
SOFTENING_SQUARED = 1e-3
G_NEWTON = 6.67259e-11

# Precision modes of the JAX package, and those the port runs.
PRECISIONS = ("f32", "bf16", "ref64")
SUPPORTED_PRECISIONS = ("f32", "bf16")
