"""ptdeco_tpu_torch: the PyTorch + CUDA port of ptdeco_tpu.

Low-rank decomposition of torch.nn models by the library's three methods
(dwain, falor and lockd; LLMs, ResNets, ConvNeXt, SwinV2 and
EfficientFormerV2), weight-only int8, and KV-cached serving of llama and
Mixtral causal LMs (sampling, beam search, speculative decoding,
continuous batching), and the trainer CLIs (``apps/trainer_llm``,
``apps/trainer_vision``), with the JAX package's TPU kernels rewritten by
hand for NVIDIA Hopper (``csrc/``).  Entry points
run on the card (``device="cuda"``) unless the caller asks for the CPU,
where each kernel's plain PyTorch version runs instead.
"""

from . import nn  # noqa: F401
from . import ops  # noqa: F401
from . import utils  # noqa: F401
from . import engine  # noqa: F401
from . import models  # noqa: F401
from . import dwain  # noqa: F401
from . import falor  # noqa: F401
from . import lockd  # noqa: F401
from . import quant  # noqa: F401
from . import serving  # noqa: F401
from . import serving_batcher  # noqa: F401

__version__ = "0.1.0"
