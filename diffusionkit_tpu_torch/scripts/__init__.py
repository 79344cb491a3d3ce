"""Command-line entry points of the port: ``generate_images``, the
counterpart of ``diffusionkit-tpu-cli``."""
