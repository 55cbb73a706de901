"""Hand-written Hopper kernels of the port, each beside its plain version.

Every wrapper counts its kernel launches in a plain int attribute
(``syrk_gram.launches`` ...); ``launch_counts``/``reset_launch_counts``
read and clear them together (the reset also clears
``lowrank_matmul.input_copies``, the inputs it had to copy into rows).
"""

from .flash_attention import causal_attention_plain, flash_attention
from .gmm import grouped_matmul, grouped_matmul_plain
from .gmm_int8 import grouped_matmul_int8, grouped_matmul_int8_plain
from .gram import should_use_syrk, syrk_gram, syrk_gram_plain
from .lowrank import lowrank_matmul, lowrank_matmul_plain

__all__ = [
    "KERNEL_WRAPPERS",
    "causal_attention_plain",
    "flash_attention",
    "grouped_matmul",
    "grouped_matmul_int8",
    "grouped_matmul_int8_plain",
    "grouped_matmul_plain",
    "launch_counts",
    "lowrank_matmul",
    "lowrank_matmul_plain",
    "reset_launch_counts",
    "should_use_syrk",
    "syrk_gram",
    "syrk_gram_plain",
]

KERNEL_WRAPPERS = {
    "syrk_gram": syrk_gram,
    "flash_attention": flash_attention,
    "lowrank_matmul": lowrank_matmul,
    "grouped_matmul": grouped_matmul,
    "gmm_int8": grouped_matmul_int8,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    lowrank_matmul.input_copies = 0
    for fn in (grouped_matmul, grouped_matmul_int8):
        for route in fn.route_launches:
            fn.route_launches[route] = 0
