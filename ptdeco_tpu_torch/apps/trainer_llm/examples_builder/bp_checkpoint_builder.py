"""Block-pruned checkpoint custom builder of the port's LLM trainer: builds
the original model, prunes it as a pruned-checkpoint directory says and
(optionally) loads that directory's weights.  The counterpart of
``apps/trainer_llm/examples_builder/bp_checkpoint_builder.py``, with its
directory layout and config keys.

Pruned-checkpoint directory (written by any block-pruning run that uses
``models.prune_blocks``):

  bp_config.json             {"attn_indices": [...], "mlp_indices": [...]}
  state_dict.safetensors     the PRUNED model's weights (or state_dict.pt)

Builder config keys (``decomposed_model_custom_builder_config``):
  bp_model_path (str):        the pruned-checkpoint directory
  bp_load_state_dict (bool):  load its weights (default True); False keeps
                              the pruned architecture with the original
                              model's weights
  hf_checkpoint_path (str | None): an HF snapshot of the ORIGINAL model,
                              built through the trainer's builder in bf16
                              with the snapshot's weights (any model type it
                              builds generically); None: a tiny random model
  vocab_size, seed:           the tiny model's knobs (seed also seeds the
                              snapshot model's initial draws)

The model is built on the CPU; the trainer moves it to its device.
"""

import json
import pathlib

import torch

from ptdeco_tpu_torch import models, utils
from ptdeco_tpu_torch.apps.trainer_llm import builder


def make_model_and_tokenizer(config: dict):
    bp_dir = pathlib.Path(config["bp_model_path"])
    bp_cfg = json.loads((bp_dir / "bp_config.json").read_text())
    seed = int(config.get("seed", 0))
    hf_path = config.get("hf_checkpoint_path")
    if hf_path:
        # the original model carries the snapshot's weights before pruning,
        # so bp_load_state_dict=False keeps them, not random ones
        model, tokenizer = builder.make_model_and_tokenizer(
            model_name=str(hf_path), dtype="bfloat16", checkpoint_path=str(hf_path), seed=seed,
            device="cpu")
    else:
        vocab = int(config.get("vocab_size", 256))
        model = models.CausalLM(models.TransformerConfig.tiny(vocab_size=vocab), device="cpu",
                                generator=torch.Generator().manual_seed(seed))
        tokenizer = builder.ByteTokenizer(vocab)
    model = models.prune_blocks(model, attn_indices=list(bp_cfg.get("attn_indices", [])),
                                mlp_indices=list(bp_cfg.get("mlp_indices", [])))
    if config.get("bp_load_state_dict", True):
        sf, pt = bp_dir / "state_dict.safetensors", bp_dir / "state_dict.pt"
        if sf.exists():
            sd = utils.load_state_dict_safetensors(str(sf))
        elif pt.exists():
            sd = utils.load_state_dict_pt(str(pt))
        else:
            raise FileNotFoundError(f"No state_dict.safetensors / state_dict.pt in {bp_dir}")
        model = utils.load_state_dict(model, sd)
    return model, tokenizer
