"""Training on one card (port of ``mitsuba_tpu/parallel`` without its
mesh)."""
