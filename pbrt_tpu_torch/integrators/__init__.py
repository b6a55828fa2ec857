"""Integrators (counterpart of pbrt_tpu/integrators/): the path integrator
on the megakernel, and the render driver."""
