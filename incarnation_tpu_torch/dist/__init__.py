"""Band and SPP sharding over a list of torch devices (port of
incarnation_tpu/dist)."""
