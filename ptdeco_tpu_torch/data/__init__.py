"""Native data helpers of the port (``native_packer``: the v2 loader's
greedy token packer, built with ``g++`` at first use)."""
