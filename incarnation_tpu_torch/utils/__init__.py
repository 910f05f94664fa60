"""Image IO and profiling helpers (port of incarnation_tpu/utils)."""
