"""Command-line renderer, image comparison and the web viewer (port of
incarnation_tpu/app)."""
