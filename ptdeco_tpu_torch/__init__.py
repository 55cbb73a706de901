"""ptdeco_tpu_torch: the PyTorch + CUDA port of ptdeco_tpu.

Low-rank decomposition (dwain) of torch.nn models, with the JAX package's
TPU kernels rewritten by hand for NVIDIA Hopper (``csrc/``).  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU,
where each kernel's plain PyTorch version runs instead.
"""

from . import nn  # noqa: F401
from . import ops  # noqa: F401
from . import utils  # noqa: F401
from . import engine  # noqa: F401
from . import models  # noqa: F401
from . import dwain  # noqa: F401

__version__ = "0.1.0"
