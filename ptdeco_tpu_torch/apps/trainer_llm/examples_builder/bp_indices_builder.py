"""Block-pruned custom builder of the port's LLM trainer: builds a tiny
``CausalLM``, prunes the attention and MLP sublayers the builder config
lists (``models.prune_blocks``), optionally loads a state dict into the
pruned model, and returns it for decomposition.  The counterpart of
``apps/trainer_llm/examples_builder/bp_indices_builder.py``, with its config
keys:

  vocab_size (int, default 256)
  seed (int, default 0): the weights' ``torch.Generator`` seed
  bp_attn_indices (list[int]): blocks whose attention sublayer is pruned
  bp_mlp_indices (list[int]):  blocks whose MLP sublayer is pruned
  bp_state_dict (str | None):  a .pt / .safetensors state dict of the
      PRUNED model (the removed sublayers' keys absent)

The model is built on the CPU; the trainer moves it to its device.
"""

import torch

from ptdeco_tpu_torch import models, utils
from ptdeco_tpu_torch.apps.trainer_llm.builder import ByteTokenizer


def make_model_and_tokenizer(config: dict):
    vocab = int(config.get("vocab_size", 256))
    gen = torch.Generator().manual_seed(int(config.get("seed", 0)))
    model = models.CausalLM(models.TransformerConfig.tiny(vocab_size=vocab), device="cpu",
                            generator=gen)
    model = models.prune_blocks(model, attn_indices=list(config.get("bp_attn_indices", [])),
                                mlp_indices=list(config.get("bp_mlp_indices", [])))
    sd_path = config.get("bp_state_dict")
    if sd_path:
        if str(sd_path).endswith(".safetensors"):
            sd = utils.load_state_dict_safetensors(sd_path)
        else:
            sd = utils.load_state_dict_pt(sd_path)
        model = utils.load_state_dict(model, sd)
    return model, ByteTokenizer(vocab)
