"""Native data helpers of the port, each built with ``g++`` at first use:
``native_packer`` (the v2 loader's greedy token packer and the image
pipeline's epoch shuffle) and ``native_jpeg`` (DCT-scaled JPEG decode)."""
