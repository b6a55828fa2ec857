"""Integrators (counterpart of pbrt_tpu/integrators/): the path integrator
(the megakernel or the general wave), and the render driver."""
