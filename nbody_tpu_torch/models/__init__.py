"""Physics models: the gravity step, the kinetic energy and the integrators."""
