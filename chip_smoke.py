"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N] [--profile DIR]

Slice 1 is a dwain decomposition of a TinyLlama-1.1B-width causal LM
(vocab 32000, dim 2048, 32 heads / 4 kv heads, MLP 5632, bf16), cut to 2
layers, with random planted-rank weights and synthetic token ids made from
the seed; then the artifact (decompose_config.json + decompose_state_dict.pt)
is written, reloaded into a fresh model, and the decomposed model serves a
probe batch with its factor pairs fused, and answers through the KV-cached
``serving.generate``.

Slice 2 serves a Mixtral-8x7B-v0.1-width MoE (vocab 32000, dim 4096, 32
heads / 8 kv heads, 8 experts of width 14336, top-2, bf16), cut to 2
layers, with random weights from a seeded torch.Generator on the card:
greedy ``generate`` on 4 prompts x 512 tokens with 16 new tokens, in bf16
and then after ``quantize_for_serving`` in weight-only int8.

Slice 6 drives the rest of ``dwain.decompose`` on the same TinyLlama-width
model: interleaved full fine-tuning with covariances precomputed in 2
splits and the randomized EVD, then LoRA fine-tuning with the exact eigh
and a checkpoint directory that a second walk replays; and bench.py's
workload, the 4-layer d 2048 f32 MLP, in its three modes.

Slice 7 runs the library's other two methods on ResNet-50 at full width
(torchvision topology, bf16, channels_last, 224 x 224 images from the
seed): ``falor.decompose`` of a planted-rank model at the falor yaml's
hyperparameters (once plain, once mean-centred), and lockd's gate
training at the lockd yaml's batch of 256, its decomposition, and a
planted half-closed copy decomposed and served fused.

Slice 8 runs the trainer CLI (``python -m ptdeco_tpu_torch.apps.trainer_llm.run``,
in process): its ``decompose_dwain`` task on a local HF snapshot of the
same TinyLlama-width model and a JSONL of the repository's prose, with the
example TinyLlama YAMLs' values, then its ``finetune`` task on the artifact,
whose result is served fused and through ``generate``.

Slice 9 runs the rest of cached serving: the CLI's ``generate`` task on the
slice-8 snapshot and artifact (sampled with the example YAML's values, beam
search, speculative decoding with and without its gate, int8), and the
slice-1 model, original and fused decomposed, through ragged ``generate``,
``generate_beam``, ``generate_speculative``, the continuous batcher and the
sampling filters, its tokens checked on f32 copies.

Slice 10 runs the other decoder families: the CLI's ``decompose_dwain``
task on a local phi-2 snapshot (2 layers, ``model_type: phi``) with
decompose_dwain_phi2.yaml's values, its artifact and its biased pairs
served fused; and slice 1's path (decompose, artifact, fused serve, cached
``generate``, ragged f32 token checks, the CPU f32 reference) on 2-layer
Qwen2-1.5B-width and Gemma-2B-width models, whose attention takes the
flash kernel at head dim 128 (group 6) and 256 (one kv head).

Slice 11 runs the vision trainer CLI (``python -m
ptdeco_tpu_torch.apps.trainer_vision.run``, in process) at the shipped
yamls' widths on 224 x 224 synthetic images with planted-rank weights:
``decompose_dwain`` on ConvNeXt-Tiny and SwinV2-Tiny (f32, cut in depth),
``decompose_lockd`` on EfficientFormerV2-S0 (bf16, batch 256) and the
``finetune`` task (KD) on its artifact, stopped and resumed from its
checkpoint, and ``decompose_falor`` on ResNet-18 as shipped; each
artifact is reloaded bit-equal and a bf16 copy served with its pairs
fused through the low-rank kernel.

Slice 13 runs slice 10's family path on four more decoders at their public
config.json's widths, 2 layers each: Llama-3.2-1B (llama3 rope scaling),
Gemma-2-2B (soft-capped attention and logits, sandwich norms; its
attention is plain, as in the JAX package, so flash launches 0 times),
Gemma-3-1B (a sliding and a full layer: a 512-token window, a local rope
theta, q/k norms; its cached ``generate`` prompt runs past the window) and
Phi-3-mini (32 heads of 96, the flash kernel's head dim 96; its weights
written in phi3's fused layout and split on load).

Slice 14 runs the same path on OLMo-2-1B, GLM-4-9B and SmolLM3-3B, and
slice 15 on the first decoders beyond the llama graph: GPT-2 XL (LayerNorm
blocks, a non-gated gelu_new MLP, learned positions, 25 heads of 64, its
weights written in GPT-2's Conv1D layout), Pythia-1.4B (GPT-NeoX: a quarter
of each head rotated, two-norm parallel blocks, fused per-head
query_key_value) and Falcon-7B (71 query heads over one kv head, one-norm
parallel blocks, widths 4544 and 18176 off the 128 grid of the MLP Gram's
tiles, its fused query_key_value), each at its public config.json's widths.

Slice 16 runs it on the GPT lineage: GPT-J-6B (16 heads of 256 with no
grouping, a quarter of each rotated pair-interleaved, one-norm parallel
blocks, an untied head of 50400 with a bias), OPT-6.7B (32 heads of 128, a
biased relu MLP 4096 <-> 16384, its position table stored with OPT's two
offset rows) and StarCoderBase-1B (GPTBigCode: 16 query heads over one kv
head of 128, learned positions, q/k/v fused in c_attn), each written in its
checkpoint layout.  Since slice 16 the family phases draw their planted
weights on the card.

Slice 17 runs it on the llama lineage with knobs of its own, at the
defaults of transformers' config classes: Persimmon-8B (64 heads of 64,
half of each rotated, q/k LayerNorms with biases, relu^2, its weights in
the per-head fused query_key_value), Nemotron (48 heads of 128,
LayerNorm1P, relu^2, MLP 24576: the largest Gram) and Arcee AFM-4.5B (32
heads of 80: flash at head dim 80, on its 128 instance with 80-wide tensor
maps).  Since slice 17 every planted weight is drawn on the card, slice
1's, its trainer snapshot's and phi-2's too.

Slice 18 runs it on two dense decoders with a position or norm knob of
their own: BLOOM-7B1 (ALiBi over 32 heads of 128, which must launch no
flash kernel in its walk, serve or prefill, as the JAX gate keeps it
plain; an embedding LayerNorm and a 250880-token tied embedding; its
weights in the per-head fused query_key_value) and BitNet at
BitNetConfig()'s defaults (the two sub-norms, flash at 20 query heads
over 5 kv heads of 128).

Slice 19 runs it on the decoders with a mixer of their own and two text
paths, at the defaults of transformers' config classes: Doge (dynamic-mask
attention, whose per-key bias keeps it off flash, and learned residual
scales), DiffLlama (differential attention, off flash too), Mllama's text
model (a cross-attention layer skipped in the 2-layer cut) and Moshi's
temporal transformer (its gating fc1 split on load; MLP 11264); then block
pruning: slice 1's model with layer 1's attention and layer 0's MLP
pruned, walked, its pruned weights and artifact round-tripped through the
trainer's bp_checkpoint_builder directory, served fused, and refused by
the KV cache.

Slice 20 runs it on the llama graph's MoE decoders at their public
config.json's widths: Qwen3-30B-A3B (128 experts of 768, top-8), OLMoE-1B-7B
(64 experts of 1024, top-8, flat q/k norms) and Qwen1.5-MoE-A2.7B (60
experts of 1408, top-4, a shared expert of 5632 under its sigmoid gate).
The walk decomposes layer 0's attention, its shared expert and two of its
experts, so layer 0 runs every expert on every token and layer 1 the
grouped kernels, whose tensor-core routes take these expert counts since
slice 20 (their kernel lines at the walk's and the decode step's rows, the
bf16 walk rows on both routes); the fused model is then quantized and
served through cached generate in int8 too, held against bf16 routed as
the bf16 run was.

Slice 21 adds DeepSeek-V2-Lite and DeepSeek-V3 at their public widths
(DeepSeek-V3 from its third layer, its experts 256 -> 64 in 8 groups):
multi-head latent attention (plain, so flash launches 0 times; the cached
form keeps the normed latent and the shared rope head, kv_b_proj absorbed)
and DeepSeek's routing (V3: sigmoid scores, a planted correction bias,
top-2-sum groups, routed scaling).  The walk takes every site but
kv_b_proj, the routers and the routed experts, so layer 1's experts take
the grouped kernels throughout; the int8 serve keeps kv_b_proj in bf16.
The grouped kernels' lines run at the published 256 and 64 experts, and
the SYRK and low-rank lines at the walks' Gram widths and chosen ranks.

Phases, one JSON line each: device, build (the five CUDA kernels, one nvcc
each, started together), one kernel line per kernel and shape (the kernel
against its plain PyTorch version at the main paths' shapes, with timings),
decompose, artifact, serve, generate (slice 1's fused model), reference
(the served model against the same model on the CPU in f32, on a short
input), decompose_ft (the walk with full fine-tuning, its artifact and
fused serve), finetune_grad (one training step against the f32 twin's,
and a planted fault), decompose_ft_lora (the LoRA walk, its replay, and
LoRA logits before and after the merge), trainer_llm_decompose (the CLI's
walk: summary, ranks, launches, the walk's fine-tuning, eigh and
plain-attention time, peak memory, the artifact reloaded twice),
trainer_llm_finetune (step time, losses, perplexities, the fused serve and
``generate`` of the result), trainer_llm_generate (each run's wall,
tokens/s, tokens, speculative stats and gate, launches), serving_paths (the
f32 token checks with the tokens each compared and its near-tie stops, the
bf16 ragged prefill gate, decode / beam / batcher step ms, speculative
round ms, acceptance and the gate's measured ratio), phi2_cli_decompose
(wall, ranks, launches: SYRK and no flash; the artifact reloaded, the fused
serve against its pairs and its f32 twin), qwen2_1_5b, gemma_2b,
llama3_2_1b, gemma2_2b, gemma3_1b, phi3_mini, olmo2_1b, glm4_9b, smollm3_3b,
gpt2_xl, pythia_1_4b, falcon_7b, gptj_6b, opt_6_7b, starcoderbase_1b,
persimmon_8b, nemotron_hf_default, arcee_hf_default, bloom_7b1,
bitnet_hf_default, doge_hf_default, diffllama_hf_default,
mllama_text_hf_default, moshi_hf_default, qwen3_moe_30b_a3b, olmoe_1b_7b,
qwen1_5_moe_a2_7b, deepseek_v2_lite and deepseek_v3 (walk and phase wall
and its split, cuts, ranks, artifact, fused serve, ``generate``, DeepSeek's
absorbed-pair cost, the MoE phases' int8
``generate`` and int8 against bf16, f32 tokens, reference),
bp_tinyllama (the pruned walk's sites and launches, the bp directory round
trip, the fused serve, the cache's refusal), dwain_mlp,
falor_resnet50 and falor_resnet50_mean (wall, eigh seconds, sites, artifact, fused serve),
lockd_resnet50 (a bf16 step against its f32 twin, ms a step, the trained
and the planted decomposition, artifact, fused serve),
trainer_vision_dwain_convnext, trainer_vision_dwain_swinv2,
trainer_vision_lockd_efficientformer, trainer_vision_finetune and
trainer_vision_falor_resnet18 (wall, decisions, ms a step, peak memory,
the resumed run's difference, the fused serve), moe_serve bf16, moe_reference bf16 (against its f32 twin on the
card), moe_serve int8, moe_reference int8 (the int8 run's step logits and a
128-token forward against the quantized model's f32 twin), kernels (launch
counts of each path).  Then the card's name and power limit as nvidia-smi
reports them, the kernel table as one JSON object, and last {"ok": true,
"device": ...}.  Any failed check raises and
the script exits non-zero; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import json
import logging
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the trainer phases' snapshot holds no tokenizer: offline, ``transformers``
# (where it is installed) fails at once and the trainer takes its byte
# tokenizer, as where it is not installed
os.environ["HF_HUB_OFFLINE"] = "1"
os.environ["TRANSFORMERS_OFFLINE"] = "1"

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")

import ptdeco_tpu_torch as ptt  # noqa: E402
from ptdeco_tpu_torch import dwain, engine, falor, finetune, lockd, models, nn as pnn, ops, quant, serving, utils  # noqa: E402
from ptdeco_tpu_torch import serving_batcher  # noqa: E402
from ptdeco_tpu_torch.dwain import decomposition  # noqa: E402
from ptdeco_tpu_torch.falor import decomposition as falor_decomposition  # noqa: E402
from ptdeco_tpu_torch.models import hf_loader  # noqa: E402
from ptdeco_tpu_torch.lockd import train as lockd_train  # noqa: E402
from ptdeco_tpu_torch.ops import _build, gmm, gmm_int8  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_llm import builder as trainer_builder  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_llm import run as trainer_run  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_llm import run_finetune as trainer_finetune  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_vision import builder as vision_builder  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_vision import configurator as vision_config  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_vision import datasets_image as vision_data  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_vision import metrics as vision_metrics  # noqa: E402
from ptdeco_tpu_torch.apps.trainer_vision import run as vision_run  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 rate outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth

SEQ = 1024
N_LAYERS = 2
PLANTED_RANK = 256
DECOMPOSE_ARGS = dict(
    num_data_steps=8,
    num_metric_steps=2,
    blacklisted_module_names=["lm_head"],
    decompose_in_float64=True,
    trade_off_factor=1000.0,
    max_accepted_ppl_diff=1.0,
    nsr_final_threshold=0.5,
    min_rank=32,
)

# Slice 6's walks: interleaved fine-tuning of the last 8 decomposed pairs,
# 20 steps at lr 1e-4 after every accepted site
FT_LAST_N, FT_STEPS, FT_LR = 8, 20, 1e-4
# One training step, bf16 on the card against its f32 twin, about 3x the
# readings on an H100 at seed 0 (PERF.md): loss 2.5e-4 apart; over the 16
# trained factors' gradients the largest difference 8.8e-3 of the largest
# |g|, RMS-relative 8.5e-3, gain error 1.25e-3 (a gradient scaled by 1.02
# reads a gain error of 0.019 and must fail)
LOSS_ABS_DIFF = 1e-3
GRAD_MAX_REL, GRAD_RMS_REL, GRAD_GAIN_ERR = 0.025, 0.025, 0.004
# LoRA adapters planted for the merge check add this RMS, relative to the
# base weight's
LORA_DELTA_REL = 0.05
# bench.py:99-130's workload: 4-layer d 2048 f32 MLP, batch 256, rank-64
# Gaussian calibration
MLP_DIM, MLP_DEPTH, MLP_BATCH, MLP_RANK = 2048, 4, 256, 64
# its fused serve against its pairs, both f32: a first limit, set before a
# reading (f32 relative rounding is about 6e-8 a step)
MLP_SERVE_MAX_ABS, MLP_SERVE_RMS_REL = 1e-4, 1e-5

# Slice 7: ResNet-50 (torchvision topology, 1000 classes), bf16,
# channels_last, images 224 x 224.  falor at the batch and hyperparameters
# of apps/trainer_vision/examples_config/decompose_falor_resnet18.yaml
RN_BATCH, RN_HW, RN_POOL = 64, 224, 16
RN_BRANCH_GAMMA = 0.2  # the scale of each residual branch's last BatchNorm
FALOR_ARGS = dict(proportion_threshold=0.8, nsr_final_threshold=0.01, kl_final_threshold=0.01,
                  num_data_steps=16, num_metric_steps=8, use_float64=True)
# lockd at decompose_lockd_resnet50.yaml's batch, lmbda, nsr_threshold,
# AdamW, lr, gradient clipping and proportion_threshold; its 10 ImageNet
# epochs cut to 30 steps (PERF.md section 4)
LOCKD_BATCH, LOCKD_POOL, LOCKD_STEPS = 256, 4, 30
LOCKD_LMBDA, LOCKD_NSR, LOCKD_LR, LOCKD_CLIP = 0.1, 0.02, 1e-3, 1.0
LOCKD_PROPORTION_THRESHOLD = 0.9
# the decomposed ResNet-50 fused against its pairs, about 3x the readings
# on an H100 at seed 0 (PERF.md): max 0.0039-0.0156, RMS-relative
# 1.7e-3-2.0e-3
RN_FUSED_MAX_ABS, RN_FUSED_RMS_REL = 0.05, 6e-3
# one bf16 gate-training step against its f32 twin at seed 0: loss 1.45e-3
# apart (relative); over the 163 trained tensors the largest difference
# 0.017 of the largest |g|, RMS-relative 6.1e-3, gain error 4.0e-3 (a
# gradient scaled by 1.02 reads a gain error of 0.016 or more and must fail)
LOCKD_LOSS_REL = 5e-3
LOCKD_GRAD_LIMITS = {"max_rel": 0.05, "rms_rel": 0.02, "gain_err": 0.01}

# Slice 8: the trainer CLI (ptdeco_tpu_torch.apps.trainer_llm.run) on a local
# HF snapshot of the 2-layer TinyLlama-width model, with
# apps/trainer_llm/examples_config/{decompose_dwain,finetune}_tinyllama.yaml's
# values (repeated here, so the script needs no PyYAML) and these cuts
# (PERF.md section 4): calibration and metric steps 2048 / 64 -> 32 / 8;
# the finetune task's train / test samples 4096 / 256 -> 64 / 16, eval steps
# 100 -> 8, warmup 50 -> 4.  Text: the repository's own prose, one
# paragraph a record, byte-tokenized.
TRAINER_PROSE = ("README.md", "SURVEY.md", "COMPONENTS.md", "docs/*.md", "NOTES_ROUND*.md")
TRAINER_SNAPSHOT_NAME = "tinyllama-snapshot"  # not a known config: the generic llama branch
TRAINER_PROMPT, TRAINER_NEW = 128, 16
# the fine-tuned artifact's fused serve against its pairs and its cached
# against its uncached logits (its logits on prose reach [8, 16), where one
# bf16 ulp is 0.0625): read max 0.0625 and RMS-relative 3.6e-3-3.9e-3 at
# seeds 0 and 1 on card-drawn weights, the gate held at 2-3x
TRAINER_MAX_ABS, TRAINER_RMS_REL = 0.125, 1e-2

# Slice 9: the rest of cached serving.  trainer_llm_generate runs the CLI's
# generate task with apps/trainer_llm/examples_config/generate_tinyllama.yaml's
# values (batch 8, 128 new tokens, temperature 0.7, top_p 0.95, eos) on the
# slice-8 snapshot and artifact, for 16 prompts of 64-512 bytes cut from the
# prose; then with 4 beams, speculative (k 4, the auto gate on and off) and
# int8.  serving_paths serves the slice-1 model, original and fused
# decomposed, on 8 ragged prompts of 64-512 random tokens; its token checks
# run on f32 copies over 32 new tokens, a row's comparison stopping at the
# reference's first step whose top-1 minus top-2 logit gap is under NEAR_TIE
# (near ties are common over 32000 logits, and other paths round otherwise)
GEN_PROMPTS, GEN_PROMPT_BYTES, GEN_NEW = 16, (64, 512), 128
PATH_BATCH, PATH_LENS, PATH_NEW, NEAR_TIE = 8, (64, 512), 32, 1e-3
# four beams' best cumulative logprob may not fall below greedy's by more
# than f32 rounding; a sampled token's probability mass before it under
# top-p is summed in f32 (its rounding, ~1e-7 a term over 32000 terms)
BEAM_SLACK, TOP_P_SLACK = 1e-4, 1e-5
# a model drafting for itself over 32 tokens at k 4: 25 of 28 drafts a row
# are emitted (the budget cuts the last round), 0.89
SELF_DRAFT_ACCEPTANCE = 0.75

# Slice 10: the other decoder families, each cut to 2 layers with
# planted-rank weights.  Qwen2-1.5B at TransformerConfig.qwen2_1_5b's widths
# (vocab 151936, dim 1536, 12 / 2 heads of 128, MLP 8960, q/k/v biases,
# tied) and Gemma-2B at its config.json's (google/gemma-2b; the keys the
# converter reads: head dim 256, one kv head, GeGLU, sqrt(dim)-scaled tied
# embeddings, (1 + w) norms) run slice 1's path at its arguments, then
# ragged cached generation on f32 copies (FAMILY_PROMPTS prompts of
# FAMILY_PROMPT_LENS tokens); phi-2 at PhiConfig.phi2's widths (vocab 51200,
# dim 2560, 32 heads of 80 with 32 rotary dims, MLP 10240, every projection
# biased) runs the trainer CLI with decompose_dwain_phi2.yaml's values and
# slice 8's cuts
GEMMA_2B = dict(
    model_type="gemma", vocab_size=256000, hidden_size=2048, intermediate_size=16384,
    num_hidden_layers=18, num_attention_heads=8, num_key_value_heads=1, head_dim=256,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="gelu", attention_bias=False,
    max_position_embeddings=8192,
)
# Slice 13: rope scaling, gemma2, gemma3 and phi3, each at its public
# config.json's widths (the keys the converter reads, written as numbers),
# cut to 2 layers with planted-rank weights, bf16: meta-llama/Llama-3.2-1B
# (llama3 rope scaling, tied), google/gemma-2-2b (soft-caps, sandwich norms,
# query_pre_attn_scalar; its window is logged and not applied, as in the
# JAX package), google/gemma-3-1b-pt (q/k norms, sandwich norms, a
# 512-token window on 5 of each 6 layers with a local rope theta; the two
# layers kept are the published 5th and 6th, sliding and full) and
# microsoft/Phi-3-mini-4k-instruct (32 heads of 96, its planted weights
# written in the fused qkv_proj / gate_up_proj layout and split on load)
LLAMA3_2_1B = dict(
    model_type="llama", vocab_size=128256, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8, head_dim=64,
    rms_norm_eps=1e-5, rope_theta=500000.0, hidden_act="silu", attention_bias=False,
    mlp_bias=False, tie_word_embeddings=True, max_position_embeddings=131072,
    rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                  "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
)
GEMMA2_2B = dict(
    model_type="gemma2", vocab_size=256000, hidden_size=2304, intermediate_size=9216,
    num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4, head_dim=256,
    rms_norm_eps=1e-6, rope_theta=10000.0, hidden_act="gelu_pytorch_tanh",
    hidden_activation="gelu_pytorch_tanh", attention_bias=False, query_pre_attn_scalar=256,
    attn_logit_softcapping=50.0, final_logit_softcapping=30.0, sliding_window=4096,
    max_position_embeddings=8192,
)
GEMMA3_1B = dict(
    model_type="gemma3_text", vocab_size=262144, hidden_size=1152, intermediate_size=6912,
    num_hidden_layers=26, num_attention_heads=4, num_key_value_heads=1, head_dim=256,
    rms_norm_eps=1e-6, rope_theta=1000000.0, rope_local_base_freq=10000.0, rope_scaling=None,
    hidden_activation="gelu_pytorch_tanh", attention_bias=False, query_pre_attn_scalar=256,
    attn_logit_softcapping=None, final_logit_softcapping=None, sliding_window=512,
    sliding_window_pattern=6, max_position_embeddings=32768,
)
PHI3_MINI = dict(
    model_type="phi3", vocab_size=32064, hidden_size=3072, intermediate_size=8192,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-5,
    rope_theta=10000.0, rope_scaling=None, hidden_act="silu", attention_bias=False,
    tie_word_embeddings=False, sliding_window=2047, max_position_embeddings=4096,
    original_max_position_embeddings=4096,
)
# Slice 14: the rest of the dense llama-graph families, the same way:
# allenai/OLMo-2-0425-1B (post-norm-only blocks, q/k RMSNorms over the
# whole projection), THUDM/GLM-4-9B-0414 (half of each 128-dim head rotated
# pair-interleaved, q/k/v biases, sandwich norms; its planted weights written
# in GLM-4's checkpoint layout: fused gate_up_proj, its own norm names) and
# HuggingFaceTB/SmolLM3-3B (every 4th layer NoPE; the two layers kept are
# the published 3rd and 4th, rope and NoPE)
OLMO2_1B = dict(
    model_type="olmo2", vocab_size=100352, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=16, rms_norm_eps=1e-6,
    rope_theta=500000.0, rope_scaling=None, hidden_act="silu", attention_bias=False,
    tie_word_embeddings=False, max_position_embeddings=4096,
)
GLM4_9B = dict(
    model_type="glm4", vocab_size=151552, hidden_size=4096, intermediate_size=13696,
    num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=2, head_dim=128,
    partial_rotary_factor=0.5, attention_bias=True, rms_norm_eps=1e-5, rope_theta=10000.0,
    hidden_act="silu", tie_word_embeddings=False, max_position_embeddings=32768,
)
SMOLLM3_3B = dict(
    model_type="smollm3", vocab_size=128256, hidden_size=2048, intermediate_size=11008,
    num_hidden_layers=36, num_attention_heads=16, num_key_value_heads=4, rms_norm_eps=1e-6,
    rope_theta=5000000.0, rope_scaling=None, hidden_act="silu", attention_bias=False,
    mlp_bias=False, tie_word_embeddings=True, max_position_embeddings=65536,
    use_sliding_window=False, sliding_window=None, no_rope_layer_interval=4,
    no_rope_layers=[int((i + 1) % 4 != 0) for i in range(36)],
)
# Slice 15: the first families beyond the llama graph, the same way:
# openai-community/gpt2-xl (LayerNorm blocks, a non-gated biased gelu_new
# MLP, learned positions, 25 heads of 64; its planted weights written in
# GPT-2's Conv1D layout), EleutherAI/pythia-1.4b (GPT-NeoX: 32 of each
# 128-dim head rotated, two-norm parallel blocks, untied; its weights in the
# per-head fused query_key_value) and tiiuae/falcon-7b (71 heads of 64 over
# one kv head, one-norm parallel blocks, no projection biases, tied; its
# weights in Falcon's fused query_key_value)
GPT2_XL = dict(
    model_type="gpt2", vocab_size=50257, n_embd=1600, n_head=25, n_layer=48, n_positions=1024,
    n_ctx=1024, n_inner=None, activation_function="gelu_new", layer_norm_epsilon=1e-5,
    scale_attn_weights=True, tie_word_embeddings=True,
)
PYTHIA_1_4B = dict(
    model_type="gpt_neox", vocab_size=50304, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=24, num_attention_heads=16, rotary_pct=0.25, rotary_emb_base=10000,
    use_parallel_residual=True, hidden_act="gelu", layer_norm_eps=1e-5,
    max_position_embeddings=2048, tie_word_embeddings=False,
)
FALCON_7B = dict(
    model_type="falcon", vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
    num_attention_heads=71, multi_query=True, parallel_attn=True, new_decoder_architecture=False,
    bias=False, alibi=False, layer_norm_epsilon=1e-5, tie_word_embeddings=True,
)
# Slice 16: the GPT lineage, the same way: EleutherAI/gpt-j-6b (16 heads of
# 256, 64 of each rotated pair-interleaved, one-norm parallel blocks, an
# untied head of 50400 with a bias; its weights in GPT-J's names),
# facebook/opt-6.7b (32 heads of 128, a biased relu MLP, tied; its position
# table stored with OPT's two offset rows) and bigcode/starcoderbase-1b
# (GPTBigCode: 16 query heads over one kv head of 128, learned positions,
# tied; its q/k/v fused in c_attn)
GPTJ_6B = dict(
    model_type="gptj", vocab_size=50400, n_embd=4096, n_head=16, n_layer=28, n_positions=2048,
    rotary_dim=64, n_inner=None, activation_function="gelu_new", layer_norm_epsilon=1e-5,
    tie_word_embeddings=False,
)
OPT_6_7B = dict(
    model_type="opt", vocab_size=50272, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, ffn_dim=16384, max_position_embeddings=2048, word_embed_proj_dim=4096,
    do_layer_norm_before=True, enable_bias=True, layer_norm_elementwise_affine=True,
    activation_function="relu", tie_word_embeddings=True,
)
STARCODERBASE_1B = dict(
    model_type="gpt_bigcode", vocab_size=49152, n_embd=2048, n_head=16, n_layer=24,
    n_positions=8192, n_inner=8192, multi_query=True, activation_function="gelu_pytorch_tanh",
    layer_norm_epsilon=1e-5, scale_attn_weights=True, tie_word_embeddings=True,
)
# Slice 17: the llama lineage with knobs of its own, the same way, at the
# defaults of transformers 4.57.6's config classes (written as numbers; the
# card has no transformers): PersimmonConfig(), which its docstring ties to
# adept/persimmon-8b-base (64 heads of 64, half of each head rotated, q/k LayerNorms with biases, relu^2, biases everywhere; its
# weights written in the per-head fused query_key_value); NemotronConfig(),
# whose docstring names nvidia/nemotron-3-8b-base-4k-hf but whose widths
# are larger than that checkpoint's (48 heads of 128, LayerNorm1P, relu^2,
# MLP 24576: the largest Gram yet); and ArceeConfig(), tied to
# arcee-ai/AFM-4.5B (32 heads of 80, flash's head dim 80; relu^2)
PERSIMMON_8B = dict(
    model_type="persimmon", vocab_size=262144, hidden_size=4096, intermediate_size=16384,
    num_hidden_layers=36, num_attention_heads=64, hidden_act="relu2", layer_norm_eps=1e-5,
    rope_theta=25000.0, rope_scaling=None, qk_layernorm=True, partial_rotary_factor=0.5,
    tie_word_embeddings=False, max_position_embeddings=16384,
)
NEMOTRON_HF_DEFAULT = dict(
    model_type="nemotron", vocab_size=256000, hidden_size=6144, intermediate_size=24576,
    num_hidden_layers=32, num_attention_heads=48, head_dim=128, num_key_value_heads=None,
    hidden_act="relu2", norm_eps=1e-5, rope_theta=10000.0, partial_rotary_factor=0.5,
    attention_bias=False, mlp_bias=False, tie_word_embeddings=False, max_position_embeddings=4096,
)
ARCEE_HF_DEFAULT = dict(
    model_type="arcee", vocab_size=32000, hidden_size=2560, intermediate_size=18432,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32, head_dim=80,
    hidden_act="relu2", rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
    attention_bias=False, mlp_bias=False, tie_word_embeddings=False, max_position_embeddings=4096,
)
# Slice 18: the dense decoders with a position or norm knob of their own,
# the same way: bigscience/bloom-7b1's published config.json (ALiBi over 32
# heads of 128, an embedding LayerNorm, biases everywhere, a tanh-GELU MLP
# of 16384, tied over a 250880-token vocabulary: a 2.05 GB bf16 embedding;
# BloomConfig()'s defaults are toy widths, hidden 64; its weights written in
# the per-head fused query_key_value) and transformers 4.57.6's
# BitNetConfig() defaults, which its docstring ties to
# microsoft/bitnet-b1.58-2B-4T (20 query heads over 5 kv heads of 128, the
# two sub-norms, a gated relu^2 MLP of 6912, untied)
BLOOM_7B1 = dict(
    model_type="bloom", vocab_size=250880, hidden_size=4096, n_layer=30, n_head=32,
    layer_norm_epsilon=1e-5, apply_residual_connection_post_layernorm=False,
    tie_word_embeddings=True,
)
BITNET_HF_DEFAULT = dict(
    model_type="bitnet", vocab_size=128256, hidden_size=2560, intermediate_size=6912,
    num_hidden_layers=30, num_attention_heads=20, num_key_value_heads=5, hidden_act="relu2",
    rms_norm_eps=1e-5, rope_theta=500000.0, attention_bias=False, tie_word_embeddings=False,
    max_position_embeddings=2048,
)
# Slice 19: the decoders with a mixer of their own and two text paths, at
# transformers 4.57.6's config-class defaults (written as numbers):
# DogeConfig() (8 / 8 heads of 128, MLP 2048, a 2048-token dynamic-mask
# window, untied; the bias keeps it off flash), DiffLlamaConfig() (32 / 32
# heads of 64, MLP 8192; plain differential attention, off flash),
# MllamaTextConfig() (Llama-3.2-11B-Vision's text model: 32 / 8 heads of
# 128, MLP 14336, 8 cross-attention layers, 8 more embedding rows) and
# MoshiConfig() (32 / 32 heads of 128, ffn_dim 22528, a gated MLP of 11264,
# one more embedding row; its 3000-token window is past every input here)
DOGE_HF_DEFAULT = dict(
    model_type="doge", vocab_size=32768, hidden_size=1024, intermediate_size=2048,
    num_hidden_layers=32, num_attention_heads=8, num_key_value_heads=8, hidden_act="silu",
    rms_norm_eps=1e-6, rope_theta=10000.0, rope_scaling=None, keep_window_size=2048,
    attention_bias=False, mlp_bias=False, is_moe=False, tie_word_embeddings=False,
    max_position_embeddings=2048,
)
DIFFLLAMA_HF_DEFAULT = dict(
    model_type="diffllama", vocab_size=32000, hidden_size=2048, intermediate_size=8192,
    num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=32, head_dim=64,
    hidden_act="silu", rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None,
    attention_bias=False, lambda_std_dev=0.1, tie_word_embeddings=False,
    max_position_embeddings=2048,
)
MLLAMA_TEXT_HF_DEFAULT = dict(
    model_type="mllama_text_model", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=40, num_attention_heads=32, num_key_value_heads=8, hidden_act="silu",
    rms_norm_eps=1e-5, rope_theta=500000, rope_scaling=None,
    cross_attention_layers=[3, 8, 13, 18, 23, 28, 33, 38], tie_word_embeddings=False,
    max_position_embeddings=131072,
)
MOSHI_HF_DEFAULT = dict(
    model_type="moshi", vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
    num_attention_heads=32, num_key_value_heads=32, head_dim=128, ffn_dim=22528,
    hidden_act="silu", rms_norm_eps=1e-8, rope_theta=10000.0, sliding_window=3000,
    tie_word_embeddings=False, max_position_embeddings=3000,
)
# Slice 20: the llama graph's MoE decoders at their public config.json's
# widths (written as numbers; the keys the converter reads):
# Qwen/Qwen3-30B-A3B (32 / 4 heads of 128 with q/k norms, 128 experts of
# 768, top-8 renormalized, untied), allenai/OLMoE-1B-7B-0924 (16 / 16
# heads of 128 with flat q/k norms, 64 experts of 1024, top-8 not
# renormalized) and Qwen/Qwen1.5-MoE-A2.7B (16 / 16 heads of 128 with q/k/v
# biases, 60 experts of 1408, top-4 not renormalized, a shared expert of
# 5632 under its sigmoid gate); depth 48, 16 and 24 cut to 2
QWEN3_MOE_30B_A3B = dict(
    model_type="qwen3_moe", vocab_size=151936, hidden_size=2048, intermediate_size=6144,
    num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4, head_dim=128,
    hidden_act="silu", rms_norm_eps=1e-6, rope_theta=1000000.0, rope_scaling=None,
    attention_bias=False, num_experts=128, num_experts_per_tok=8, moe_intermediate_size=768,
    norm_topk_prob=True, decoder_sparse_step=1, mlp_only_layers=[], sliding_window=None,
    use_sliding_window=False, tie_word_embeddings=False, max_position_embeddings=40960,
)
OLMOE_1B_7B = dict(
    model_type="olmoe", vocab_size=50304, hidden_size=2048, intermediate_size=1024,
    num_hidden_layers=16, num_attention_heads=16, num_key_value_heads=16, hidden_act="silu",
    rms_norm_eps=1e-5, rope_theta=10000.0, rope_scaling=None, attention_bias=False,
    clip_qkv=None, num_experts=64, num_experts_per_tok=8, norm_topk_prob=False,
    tie_word_embeddings=False, max_position_embeddings=4096,
)
QWEN1_5_MOE_A2_7B = dict(
    model_type="qwen2_moe", vocab_size=151936, hidden_size=2048, intermediate_size=5632,
    num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16, hidden_act="silu",
    rms_norm_eps=1e-6, rope_theta=1000000.0, num_experts=60, num_experts_per_tok=4,
    moe_intermediate_size=1408, shared_expert_intermediate_size=5632, norm_topk_prob=False,
    decoder_sparse_step=1, sliding_window=32768, use_sliding_window=False,
    tie_word_embeddings=False, max_position_embeddings=8192,
)
# Slice 21: DeepSeek's latent-attention MoE decoders at their public
# config.json's widths (written as numbers): deepseek-ai/DeepSeek-V2-Lite
# (16 heads, a direct q_proj, latent 512, qk 128 + 64, v 128; a dense MLP of
# 10944 in layer 0 by first_k_dense_replace; 64 experts of 1408, top-6
# greedy softmax not renormalized, 2 shared experts, no group limit; yarn
# factor 40, mscale 0.707) and deepseek-ai/DeepSeek-V3 (128 heads, a q
# bottleneck of 1536, latent 512; dense MLP 18432 in layers 0-2; 256
# experts of 2048 in 8 groups, 4 kept, top-8 by sigmoid scores plus the
# correction bias, renormalized and scaled by 2.5, 1 shared expert; yarn
# factor 40, mscale 1.0); depth 27 and 61 cut to 2, DeepSeek-V3's from its
# third layer (one dense, one sparse) and its experts 256 -> 64
# (``FAMILY_EXPERTS``: 8 groups of 8, so the group limit still binds)
YARN_40 = {"type": "yarn", "factor": 40, "original_max_position_embeddings": 4096,
           "beta_fast": 32, "beta_slow": 1}
DEEPSEEK_V2_LITE = dict(
    model_type="deepseek_v2", vocab_size=102400, hidden_size=2048, intermediate_size=10944,
    moe_intermediate_size=1408, num_hidden_layers=27, num_attention_heads=16,
    num_key_value_heads=16, q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=64, n_shared_experts=2,
    num_experts_per_tok=6, norm_topk_prob=False, routed_scaling_factor=1.0, topk_method="greedy",
    n_group=1, topk_group=1, first_k_dense_replace=1, moe_layer_freq=1, hidden_act="silu",
    rms_norm_eps=1e-6, rope_theta=10000.0, attention_bias=False, tie_word_embeddings=False,
    max_position_embeddings=163840, rope_scaling={**YARN_40, "mscale": 0.707,
                                                  "mscale_all_dim": 0.707},
)
DEEPSEEK_V3 = dict(
    model_type="deepseek_v3", vocab_size=129280, hidden_size=7168, intermediate_size=18432,
    moe_intermediate_size=2048, num_hidden_layers=61, num_attention_heads=128,
    num_key_value_heads=128, q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128, n_routed_experts=256, n_shared_experts=1,
    num_experts_per_tok=8, norm_topk_prob=True, routed_scaling_factor=2.5, n_group=8,
    topk_group=4, scoring_func="sigmoid", topk_method="noaux_tc", first_k_dense_replace=3,
    moe_layer_freq=1, hidden_act="silu", rms_norm_eps=1e-6, rope_theta=10000.0,
    attention_bias=False, tie_word_embeddings=False, max_position_embeddings=163840,
    rope_scaling={**YARN_40, "mscale": 1.0, "mscale_all_dim": 1.0},
)
MOE_FAMILIES = {"qwen3_moe_30b_a3b": QWEN3_MOE_30B_A3B, "olmoe_1b_7b": OLMOE_1B_7B,
                "qwen1_5_moe_a2_7b": QWEN1_5_MOE_A2_7B, "deepseek_v2_lite": DEEPSEEK_V2_LITE,
                "deepseek_v3": DEEPSEEK_V3}
# the routed experts a cut keeps (all where not named)
FAMILY_EXPERTS = {"deepseek_v3": 64}
# DeepSeek-V3's planted correction bias: large enough to change the
# selection (JAX tests/test_hf_config_family.py:553-555 draws it so)
DEEPSEEK_BIAS_STD = 0.5
FAMILY_CONFIGS = {"gemma_2b": GEMMA_2B, "llama3_2_1b": LLAMA3_2_1B, "gemma2_2b": GEMMA2_2B,
                  "gemma3_1b": GEMMA3_1B, "phi3_mini": PHI3_MINI, "olmo2_1b": OLMO2_1B,
                  "glm4_9b": GLM4_9B, "smollm3_3b": SMOLLM3_3B, "gpt2_xl": GPT2_XL,
                  "pythia_1_4b": PYTHIA_1_4B, "falcon_7b": FALCON_7B, "gptj_6b": GPTJ_6B,
                  "opt_6_7b": OPT_6_7B, "starcoderbase_1b": STARCODERBASE_1B,
                  "persimmon_8b": PERSIMMON_8B, "nemotron_hf_default": NEMOTRON_HF_DEFAULT,
                  "arcee_hf_default": ARCEE_HF_DEFAULT, "bloom_7b1": BLOOM_7B1,
                  "bitnet_hf_default": BITNET_HF_DEFAULT, "doge_hf_default": DOGE_HF_DEFAULT,
                  "diffllama_hf_default": DIFFLLAMA_HF_DEFAULT,
                  "mllama_text_hf_default": MLLAMA_TEXT_HF_DEFAULT,
                  "moshi_hf_default": MOSHI_HF_DEFAULT, **MOE_FAMILIES}
# the first published layer each cut keeps (0 where not named): gemma3's
# 5th and 6th (sliding, full), smollm3's 3rd and 4th (rope, NoPE), mllama's
# 3rd and 4th (self-attention, cross-attention: skipped)
FAMILY_FIRST_LAYER = {"gemma3_1b": 4, "smollm3_3b": 2, "mllama_text_hf_default": 2,
                      "deepseek_v3": 2}
# the families whose attention takes flash in the JAX package: Gemma-2's
# soft-capped attention, BLOOM's ALiBi and Doge's dynamic-mask bias are
# plain there (the kernel has no logit bias), and DiffLlama's differential
# attention and DeepSeek's latent attention (qk head 192, v head 128) have
# no flash path, so flash must launch 0 times
FAMILY_NO_FLASH = ("gemma2_2b", "bloom_7b1", "doge_hf_default", "diffllama_hf_default",
                   "deepseek_v2_lite", "deepseek_v3")
# Doge's planted dynamic-mask parameter A and residual scales, DiffLlama's
# lambda vectors: each drawn off its neutral value (A 0, scales 1, lambda
# pairs equal) by these standard deviations, so that each binds: A *
# softplus(dt) spans about one logit over the keys, and lq . lk (64 terms)
# moves lambda by about 0.6
DOGE_A_STD, DOGE_RESIDUAL_STD, DIFF_LAMBDA_STD = 0.5, 0.2, 0.3
# An MoE family's walk decomposes layer 0's attention projections, its
# shared expert and these two of its routed experts; every other site (the
# routers, the shared-expert gate, the head, the other experts: 768 expert
# sites would not fit the run) is blacklisted, so layer 0 takes the dense
# route once its experts are hooked or decomposed and layer 1's whole
# experts the grouped kernels, in the walk's forwards, the serve and
# generate
MOE_WALK_EXPERTS = (0, 1)
# The family walks take the randomized EVD for output Grams 3072 or more
# wide (``eigh_method="auto"``, the crossover tools/eigh_crossover.py
# measured): their wide MLP Grams' exact f64 eighs were most of their walks
# (Nemotron's 37.2 s against 12.5, Gemma-2B's 18.9 against 4.4, with the
# same ranks and gate readings; PERF.md).  Slice 1's walk keeps the exact
# eigh.  An MoE family's walk scores each candidate on one metric batch:
# its metric forwards run every expert of layer 0 on every token.
FAMILY_DECOMPOSE_ARGS = {**DECOMPOSE_ARGS, "eigh_method": "auto"}
MOE_METRIC_STEPS = 1
# gemma3's cached generate prompt, past its 512-token window
GEMMA3_PROMPT = 640
FAMILY_LAYERS = 2
# 4 prompts each phase (8 until slice 15: the rows repeated each other's
# checks, and the run's time went to the new phases)
FAMILY_PROMPTS, FAMILY_PROMPT_LENS = 4, (128, 256)
PHI_SNAPSHOT_NAME = "phi2-snapshot"  # not a known config: the generic phi branch
# Their model-level gates (max_abs, rms_rel), about 2-3x the readings on an
# H100 at seed 0 (PERF.md): "serve" holds the fused model against its pairs
# and cached against uncached logits, "reference" against an f32 copy (the
# unfused twin on the card for phi, the CPU for the others).  Since slice 16
# the family phases' weights are drawn on the card: every family's gates
# were read again at seeds 0 and 1 and hold 2-3x the larger reading (GLM-4's
# reference max raised 0.075 -> 0.09; PERF.md).  phi-2 read
# 0.031 / 4.2e-3 and 0.029 / 4.4e-3 (on the card's draws since slice 17:
# 0.031 / 4.3e-3 and 0.030 / 4.3e-3); Qwen2-1.5B 0.033-0.035 / 4.5e-3-5.0e-3
# and 0.032 / 5.3e-3; Gemma-2B 0.25 / 6.0e-3-6.2e-3 (one bf16 ulp of logits
# in [32, 64)) and 0.151 / 6.6e-3
FAMILY_GATES = {
    "phi2": {"serve": (0.0625, 1e-2), "reference": (0.06, 1e-2)},
    "qwen2_1_5b": {"serve": (0.1, 1.25e-2), "reference": (0.08, 1.3e-2)},
    "gemma_2b": {"serve": (0.5, 1.5e-2), "reference": (0.4, 1.6e-2)},
    # slice 13, the same at seed 0: Llama-3.2-1B 0.049 / 7.9e-3-8.5e-3 and
    # 0.048 / 8.4e-3; Gemma-2-2B 0.125 / 6.3e-3-7.3e-3 and 0.152 / 7.7e-3;
    # Gemma-3-1B 0.0625-0.125 / 4.6e-3-7.5e-3 and 0.090 / 9.9e-3; Phi-3-mini
    # 0.031 / 1.9e-3-2.1e-3 and 0.024 / 4.1e-3
    "llama3_2_1b": {"serve": (0.125, 2e-2), "reference": (0.125, 2e-2)},
    "gemma2_2b": {"serve": (0.375, 1.8e-2), "reference": (0.4, 2e-2)},
    "gemma3_1b": {"serve": (0.375, 1.8e-2), "reference": (0.25, 2.5e-2)},
    "phi3_mini": {"serve": (0.0625, 5e-3), "reference": (0.06, 1e-2)},
    # slice 14, the same at seed 0: OLMo-2-1B 0.047-0.055 / 7.5e-3-8.1e-3
    # and 0.054 / 7.6e-3; GLM-4-9B 0.031 / 4.3e-3-4.7e-3 (one bf16 ulp of
    # logits in [4, 8)) and 0.029 / 5.0e-3; SmolLM3-3B 0.047-0.051 /
    # 7.6e-3-8.3e-3 and 0.050 / 8.5e-3
    "olmo2_1b": {"serve": (0.125, 2e-2), "reference": (0.125, 2e-2)},
    "glm4_9b": {"serve": (0.09375, 1.25e-2), "reference": (0.09, 1.25e-2)},
    "smollm3_3b": {"serve": (0.125, 2e-2), "reference": (0.125, 2e-2)},
    # slice 15, the same at seed 0: GPT-2 XL 0.031-0.039 / 3.3e-3-4.0e-3 and
    # 0.031 / 4.9e-3; Pythia-1.4B 0.031 / 2.5e-3 and 0.024 / 4.2e-3
    # (0.0625 would be two bf16 ulps of logits in [4, 8)); Falcon-7B
    # 0.031-0.047 / 3.2e-3-5.4e-3 and 0.033 / 4.8e-3
    "gpt2_xl": {"serve": (0.09375, 1e-2), "reference": (0.09, 1.25e-2)},
    "pythia_1_4b": {"serve": (0.09375, 6e-3), "reference": (0.06, 1.1e-2)},
    "falcon_7b": {"serve": (0.125, 1.25e-2), "reference": (0.09, 1.25e-2)},
    # slice 16, the larger reading of seeds 0 and 1 on card-drawn weights:
    # GPT-J-6B 0.031 / 2.4e-3 and 0.025 / 4.2e-3; OPT-6.7B 0.031 / 3.8e-3
    # and 0.026 / 4.4e-3; StarCoderBase-1B 0.031 / 4.1e-3 and 0.030 /
    # 4.8e-3
    "gptj_6b": {"serve": (0.09375, 6e-3), "reference": (0.06, 1.1e-2)},
    "opt_6_7b": {"serve": (0.09375, 1e-2), "reference": (0.06, 1.1e-2)},
    "starcoderbase_1b": {"serve": (0.09375, 1e-2), "reference": (0.075, 1.25e-2)},
    # slice 17, the larger reading of seeds 0 and 1: Persimmon-8B 0.031 /
    # 3.4e-3 and 0.030 / 4.3e-3; Nemotron 0.031 / 2.6e-3 and 0.027 /
    # 4.1e-3; Arcee 0.031 / 3.1e-3 and 0.026 / 4.2e-3
    "persimmon_8b": {"serve": (0.09375, 1e-2), "reference": (0.075, 1.1e-2)},
    "nemotron_hf_default": {"serve": (0.09375, 7.5e-3), "reference": (0.06, 1.1e-2)},
    "arcee_hf_default": {"serve": (0.09375, 9e-3), "reference": (0.06, 1.1e-2)},
    # slice 18, the larger reading of seeds 0 and 1: BLOOM-7B1 0.25 /
    # 5.0e-3 and 0.143 / 5.2e-3 (0.25 is one bf16 ulp of a logit in [32,
    # 64), as Gemma-2B's: its tied head, after the embedding norm, scores
    # each input token's own row high); BitNet 0.039 / 6.4e-3 and 0.037 /
    # 5.9e-3
    "bloom_7b1": {"serve": (0.5, 1.25e-2), "reference": (0.4, 1.3e-2)},
    "bitnet_hf_default": {"serve": (0.09375, 1.5e-2), "reference": (0.09, 1.5e-2)},
    # slice 19, the larger reading of seeds 0 and 1: Doge 0.031 / 2.9e-3 and
    # 0.029 / 5.3e-3; DiffLlama 0.055 / 7.7e-3 and 0.061 / 1.02e-2 (its
    # RMS group-norm rescales each paired head's difference, which carries
    # the bf16 error of two probability-weighted sums); Mllama 0.031 /
    # 1.8e-3 and 0.027 / 3.3e-3; Moshi 0.031 / 2.2e-3 and 0.029 / 4.1e-3.
    # With Doge's bias set to ones on the card its reference read 0.543 /
    # 0.0454, with DiffLlama's lambda at lambda_init 1.757 / 0.278
    "doge_hf_default": {"serve": (0.09375, 9e-3), "reference": (0.075, 1.25e-2)},
    "diffllama_hf_default": {"serve": (0.125, 2e-2), "reference": (0.15, 2.5e-2)},
    "mllama_text_hf_default": {"serve": (0.09375, 6e-3), "reference": (0.06, 1e-2)},
    "moshi_hf_default": {"serve": (0.09375, 6e-3), "reference": (0.075, 1.1e-2)},
    # slice 20, the larger reading of seeds 0 and 1 (the serve gate holds
    # the fused serve and the bf16 and int8 generate checks): Qwen3-30B-A3B
    # serve 0.031 / 4.3e-3, reference 0.032 / 5.1e-3, int8 against bf16
    # 0.0625 / 1.16e-2; OLMoE-1B-7B 0.031 / 3.3e-3, 0.026 / 4.5e-3, 0.057 /
    # 1.03e-2; Qwen1.5-MoE-A2.7B 0.031 / 4.6e-3, 0.030 / 4.9e-3, 0.069 /
    # 1.20e-2.  "near_ties" limits the share of (layer, token) routings a
    # check forced off the model's own, which grows as the gap between the
    # k-th and next expert's logit shrinks with the expert count; the
    # largest read 0.039 (Qwen3-30B-A3B's CPU reference), 0.021 and 0.023
    "qwen3_moe_30b_a3b": {"serve": (0.09375, 1e-2), "reference": (0.075, 1.25e-2),
                          "int8": (0.15, 3e-2), "near_ties": 0.1},
    "olmoe_1b_7b": {"serve": (0.09375, 9e-3), "reference": (0.075, 1.1e-2),
                    "int8": (0.15, 2.5e-2), "near_ties": 0.06},
    "qwen1_5_moe_a2_7b": {"serve": (0.09375, 1.1e-2), "reference": (0.075, 1.2e-2),
                          "int8": (0.175, 3e-2), "near_ties": 0.06},
    # slice 21, the larger reading of seeds 0 and 1: DeepSeek-V2-Lite serve
    # 0.031 / 3.6e-3, reference 0.026 / 4.3e-3, int8 against bf16 0.055 /
    # 9.3e-3, near-ties 4.7% (the CPU reference at seed 1); DeepSeek-V3
    # 0.031 / 5.2e-3, 0.035 / 5.4e-3, 0.070 / 1.29e-2, near-ties 1.0%.  Each
    # V3 knob neutral on the card alone fails its reference gate: the bias
    # zeroed or the group limit lifted move 100% and 97% of its routings,
    # routed scaling 1.0 reads 1.50 / 0.278, the MLA scale multiplier 1.0
    # 0.714 / 0.105 (tools/family_gates.py --neutral)
    "deepseek_v2_lite": {"serve": (0.09375, 1e-2), "reference": (0.075, 1.1e-2),
                         "int8": (0.15, 2.5e-2), "near_ties": 0.1},
    "deepseek_v3": {"serve": (0.09375, 1.25e-2), "reference": (0.09, 1.3e-2),
                    "int8": (0.175, 3e-2), "near_ties": 0.03},
}

# Slice 11: the vision trainer CLI (ptdeco_tpu_torch.apps.trainer_vision.run,
# in process) at the shipped yamls' widths on 224 x 224 images of the
# synthetic pipeline (its batches held on the card), with planted-rank
# weights loaded as a .pt through decompose_model_checkpoint_path.  The
# yamls' values (apps/trainer_vision/examples_config/) are repeated here,
# so no PyYAML is needed, with these cuts (PERF.md section 4):
# ConvNeXt-Tiny's depth (3, 3, 9, 3) -> CONVNEXT_DEPTHS, its calibration
# steps 32 -> 8 and fine-tuning steps 100 -> 4; SwinV2-Tiny's depth
# (2, 2, 6, 2) -> SWIN_DEPTHS (the blacklist trimmed to the blocks left),
# its metric steps 8 -> 2 and fine-tuning steps 50 -> 4; lockd's 10 epochs
# -> 31 steps and the KD task's 20 epochs -> 16 steps, an epoch being
# EF_POOL batches.  The layer scales (init 1e-6 / 1e-5) are set to
# VISION_BRANCH_SCALE so that the planted branches count.
VISION_HW, VISION_POOL, VISION_BRANCH_SCALE = 224, 4, 0.5
CONVNEXT_DEPTHS, SWIN_DEPTHS = (1, 1, 3, 1), (2, 2, 2, 2)
CONVNEXT_CUT, SWIN_CUT = "convnext_tiny_cut", "swinv2_tiny_patch4_window7_224_cut"
DWAIN_CONVNEXT_BATCH, DWAIN_SWIN_BATCH = 64, 80
DWAIN_CONVNEXT = dict(
    task="decompose_dwain", num_data_steps=8, num_metric_steps=8, trade_off_factor=0.5,
    reduction_factor=0.5, max_accepted_ppl_diff=0.1, nsr_final_threshold=0.05, min_rank=16,
    decompose_in_float64=True, precomputing_covariance_num_splits=4, blacklisted_modules=["head"],
    finetuning_run=True, finetuning_lr=1e-4, finetuning_optimizer="AdamW",
    finetuning_reverting=True, finetuning_batch_norms_in_eval=True, finetuning_num_steps=4,
    finetuning_num_log_steps=10, finetuning_num_last_finetuned_modules=8,
)
DWAIN_SWIN = dict(
    task="decompose_dwain", num_data_steps=8, num_metric_steps=2, trade_off_factor=0.5,
    reduction_factor=0.5, max_accepted_ppl_diff=0.1, nsr_final_threshold=1.0, min_rank=4,
    decompose_in_float64=True, precomputing_covariance_num_splits=1,
    blacklisted_modules=[f"stages.{s}.blocks.{b}.attn.cpb_fc{i}"
                         for s, depth in enumerate(SWIN_DEPTHS) for b in range(depth)
                         for i in (1, 2)] + ["head"],
    finetuning_run=True, finetuning_lr=5e-5, finetuning_optimizer="AdamW",
    finetuning_reverting=True, finetuning_batch_norms_in_eval=True, finetuning_num_steps=4,
    finetuning_num_log_steps=10, finetuning_num_last_finetuned_modules=10000,
)
EF_POOL, EF_VAL_BATCH = 8, 64
LOCKD_EF = dict(
    task="decompose_lockd", proportion_threshold=0.9,
    blacklisted_modules=[f"stages.3.blocks.{b}.token_mixer.talking_head{i}"
                         for b in (2, 3) for i in (1, 2)],
    lmbda=0.1, nsr_threshold=0.02, finetune_only_decomposed=True, lr=1e-3, lr_t_warmup="1ep",
    lr_scheduler="cosine", max_duration="31ba", optimizer="AdamW", precision="bf16",
    alg_gradient_clipping_type="norm", alg_gradient_clipping_threshold=1.0, mesh_dp=None,
)
FINETUNE_EF = dict(
    task="finetune", proportion_threshold=0.9, blacklisted_modules=[],
    finetune_only_decomposed=True, lr=3e-4, lr_t_warmup="1ep", lr_scheduler="cosine",
    max_duration="16ba", optimizer="AdamW", precision="bf16", alg_gradient_clipping_type="norm",
    alg_gradient_clipping_threshold=1.0, mesh_dp=None, save_interval_steps=EF_POOL,
)
FALOR_RN18 = dict(task="decompose_falor", proportion_threshold=0.8, nsr_final_threshold=0.01,
                  kl_final_threshold=0.01, num_data_steps=16, num_metric_steps=8,
                  use_float64=True, blacklisted_modules=[])
# fused serves against their pairs (max_abs, rms_rel), bf16, about 3x the
# readings on an H100 at seeds 0-1 (PERF.md): ConvNeXt read 0.0156 /
# 3.6e-4-5.4e-4, Swin 0.0156 / 3.4e-3-3.7e-3; EfficientFormer read 0 / 0
# (its fused logits bit-equal to the pairs'), and is held to two bf16 ulps
# of its largest logits (in [0.5, 1)) and ConvNeXt's relative limit
CONVNEXT_FUSED_GATES, SWIN_FUSED_GATES, EF_FUSED_GATES = (0.05, 1.5e-3), (0.05, 1e-2), (2 ** -7, 1.5e-3)
# the resumed KD run against the unbroken one (f32 masters and BatchNorm
# statistics, relative to each tensor's largest value): it read 0 at seed
# 0, and an f32 rounding over 8 steps is about 1e-7
RESUME_REL = 1e-5


# Model-level gates, about 2-3x the readings on an H100 at seed 0 (PERF.md):
# fused vs unfused logits read max 0.031 (one bf16 ulp), RMS-relative 1.8e-3;
# bf16 on the card vs f32 on the CPU read max 0.025, RMS-relative 4.1e-3.
# On the card's draws (since slice 17), the larger of seeds 0 and 1: 0.031
# / 2.4e-3 and 0.026 / 4.1e-3
FUSED_MAX_ABS, FUSED_RMS_REL = 0.0625, 5e-3
REF_MAX_ABS, REF_RMS_REL = 0.06, 1e-2

# Mixtral-8x7B-v0.1's config.json (mistralai/Mixtral-8x7B-v0.1), the keys
# the converter reads
MIXTRAL_8X7B = dict(
    model_type="mixtral", vocab_size=32000, hidden_size=4096, intermediate_size=14336,
    num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
    num_local_experts=8, num_experts_per_tok=2, rms_norm_eps=1e-5, rope_theta=1e6,
    sliding_window=None, tie_word_embeddings=False,
)
MOE_LAYERS = 2
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 512, 16
MOE_REF_TOKENS = 128
TINY_PROMPT, TINY_NEW = 128, 8

# Serving gates, about 2-3x the readings on an H100 at seeds 0-2 (PERF.md).
# An MoE model's reference is routed as the run it checks (``Routing``), so
# every row is compared; the share of near-ties it overrode is gated too.
# Cached vs uncached logits: TinyLlama read max 0.031 (one bf16 ulp),
# RMS-relative 2.4e-3; the Mixtral-width model, bf16 and int8, max
# 0.023-0.031, RMS-relative 7.8e-3-8.2e-3.
GEN_MAX_ABS, GEN_RMS_REL = 0.0625, 5e-3
CACHED_MAX_ABS, CACHED_RMS_REL = 0.0625, 2e-2
# bf16 vs its f32 twin on the card: max 0.019-0.023, RMS-relative
# 6.2e-3-6.4e-3; the int8 model against its twin (the same bf16 roundings;
# the twin dequantizes the same grids in f32) read max 0.021-0.026,
# RMS-relative 7.2e-3-8.7e-3, and is held to the same limits
MOE_REF_MAX_ABS, MOE_REF_RMS_REL = 0.0625, 2e-2
# int8 vs bf16 (the quantization error): max 0.047-0.055, RMS-relative 1.6e-2
INT8_MAX_ABS, INT8_RMS_REL = 0.15, 5e-2
# near-ties overridden: at most 68 of 4216 routed (layer, token) pairs (1.6%,
# int8 against bf16), 3 of 256 (1.2%) against an f32 twin
MAX_NEAR_TIE_SHARE = 0.05

KERNEL_INFO = {
    "syrk_gram": ("ptdeco_tpu_torch/csrc/syrk_gram.cu", "ptdeco_tpu/ops/gram_pallas.py:45"),
    "flash_attention": (
        "ptdeco_tpu_torch/csrc/flash_attention_fwd.cu",
        "ptdeco_tpu/ops/flash_attention.py:59",
    ),
    "lowrank_matmul": (
        "ptdeco_tpu_torch/csrc/lowrank_matmul.cu",
        "ptdeco_tpu/ops/lowrank_pallas.py:40",
    ),
    "grouped_matmul": (
        "ptdeco_tpu_torch/csrc/grouped_matmul.cu",
        "ptdeco_tpu/models/transformer.py:5252",
    ),
    "gmm_int8": ("ptdeco_tpu_torch/csrc/gmm_int8.cu", "ptdeco_tpu/ops/gmm_int8.py:109"),
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3, graph: bool = False) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up.
    With ``graph`` the call is captured once in a CUDA graph and the
    replays are timed: the device time of its launches without the host's
    Python and launch overhead, which is larger than a small kernel."""
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            fn()
        fn = captured.replay
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(name, kernel_fn, plain_fn, library_fn, flops, nbytes, tol_fn, shape,
                 extra_fns=None, graph=False, plain_graph=True, path=None,
                 peak=PEAK_BF16_FLOPS, other_bounds=None):
    """Hold the kernel against its plain version elementwise: every output
    must satisfy |out - ref| <= tol_fn(ref), a tensor of per-element limits.
    The record is printed before a failure is raised.  ``library_fn`` may
    be None (no single PyTorch call computes the function); ``extra_fns``
    maps a name to another route timed beside the kernel.  With ``graph``
    the kernel, plain and library times are CUDA-graph replays (device
    time) and ``eager_ms`` is the kernel's wrapper called from Python;
    ``plain_graph=False`` times a plain version that syncs with the host
    (which a graph cannot capture) by events.  ``path`` names the kernel's
    route for this shape; ``peak`` is the card's rate for its operations;
    ``other_bounds`` maps a name to (flops, peak) of another way to do the
    same work, recorded as ``bound_<name>_ms`` beside ``bound_ms``."""
    out = kernel_fn().float()
    ref = plain_fn().float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    tol = tol_fn(ref)
    # 0 / 0 where both are exact; a NaN in the kernel's output stays NaN
    err_to_tol = float(torch.where(diff == 0, 0.0, diff / tol).max())
    bound_ms, bound_by = bound(flops, nbytes, peak)
    rec = {
        "name": name,
        **({"path": path} if path else {}),
        "shape": shape,
        "max_abs_err": float(diff.max()),
        "max_rel_err": float(diff.max()) / max(float(ref.abs().max()), 1e-30),
        "err_to_tol": err_to_tol,
    }
    if not (math.isfinite(err_to_tol) and err_to_tol <= 1.0):
        emit({"phase": "kernel", **rec, "ok": False})
        raise AssertionError(f"{name} {shape}: max |out - ref| / tolerance = {err_to_tol} > 1")
    del out, ref, diff, tol
    rec.update({
        "ms": time_ms(kernel_fn, graph=graph),
        "plain_ms": time_ms(plain_fn, graph=graph and plain_graph),
        "library_ms": None if library_fn is None else time_ms(library_fn, graph=graph),
        **({"eager_ms": time_ms(kernel_fn)} if graph else {}),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        **{f"bound_{k}_ms": bound(f, nbytes, pk)[0] for k, (f, pk) in (other_bounds or {}).items()},
        **{f"{k}_ms": time_ms(fn) for k, fn in (extra_fns or {}).items()},
    })
    emit({"phase": "kernel", **rec, "bound_us": bound_ms * 1e3})
    return rec


def attention_term_rss(q, k, v, scale):
    """sqrt(sum_j p_ij^2 v_jd^2) in f32: the size of the rounding error of
    the weighted sum sum_j p_ij v_jd when each p_ij is rounded to bf16."""
    rep = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    logits = (q.float() @ kf.transpose(-1, -2)) * scale
    s = q.shape[2]
    causal = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(logits.masked_fill(~causal, -math.inf), dim=-1)
    return torch.sqrt(p.square() @ vf.square())


def flash_check(dev, g, recs: dict, b: int, s: int, h: int = 32, h_kv: int = 4,
                hd: int = 64, scale: float | None = None) -> None:
    """Flash against its plain version at b x s and the given heads
    (TinyLlama's by default), at softmax ``scale`` (1 / sqrt(hd) when
    None)."""
    bf = torch.bfloat16
    q = torch.randn(b, h, s, hd, device=dev, generator=g).to(bf)
    k = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
    v = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
    scale = hd ** -0.5 if scale is None else scale
    rss = attention_term_rss(q, k, v, scale)
    recs["flash_attention"].append(check_kernel(
        "flash_attention",
        lambda: ops.flash_attention(q, k, v, scale),
        lambda: ops.causal_attention_plain(q, k, v, scale),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale, enable_gqa=True
        ),
        flops=2 * 2 * b * h * hd * s * (s + 1) / 2,
        nbytes=2 * (2 * b * h * s * hd + 2 * b * h_kv * s * hd),
        # each side rounds every probability to bf16 (the kernel before
        # normalising, the plain version after), so the two differ by
        # about 2^-9 * rss per element, and each rounds its output to bf16
        # (at most one ulp, 2^-7 * |ref|); 2^-6 * |ref| + 2^-5 * rss leaves
        # room for 5-sigma tails over the 2M outputs
        tol_fn=lambda ref: 2.0 ** -6 * ref.abs() + 2.0 ** -5 * rss,
        shape={"b": b, "h": h, "h_kv": h_kv, "s": s, "head_dim": hd, "dtype": "bf16",
               **({"scale": scale} if scale != hd ** -0.5 else {})},
        graph=True, path="tma_wgmma",
    ))


def kernel_checks(dev) -> dict[str, list[dict]]:
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    recs: dict[str, list[dict]] = {k: [] for k in KERNEL_INFO}

    # TinyLlama's MLP and model widths; then phi-2's MLP (10240) and
    # Gemma-2B's (16384) Grams (Qwen2-1.5B's 8960 and 1536 lie between);
    # Gemma-2-2B's MLP (9216; Llama-3.2-1B's and Phi-3-mini's 8192 and
    # Gemma-3-1B's 6912 lie below); GLM-4-9B's MLP (13696, 107 tiles of 128
    # a side; SmolLM3-3B's 11008 lies below); the widths of slice 15's
    # Grams: GPT-2 XL's 1600 and Falcon-7B's 4544, off the 128-wide tiles'
    # grid, GPT-2 XL's MLP (6400), Pythia-1.4B's (8192) and Falcon-7B's
    # (18176, a 1.32 GB f32 Gram, the largest); GPT-J-6B's and OPT-6.7B's
    # width (4096; their MLPs' 16384 is Gemma-2B's, StarCoderBase-1B's 2048
    # and 8192 are above); slice 17's: Nemotron's MLP (24576, a 2.42 GB f32
    # Gram, the largest) and width (6144), Arcee's MLP (18432) and width
    # (2560; Persimmon's 4096 and 16384 are above); slice 18's: BitNet's MLP
    # (6912; BLOOM-7B1's 4096 and 16384 are above); slice 19's: Moshi's
    # gated MLP (11264) and Mllama's (14336; Doge's 1024 and 2048 and
    # DiffLlama's 2048 and 8192 are above or too narrow to matter); slice
    # 21's: DeepSeek-V3's width (7168) and q_lora (1536), DeepSeek-V2-Lite's
    # dense MLP (10944, off the 128 grid), shared experts (2816), q_proj
    # (16 heads of 192: 3072) and both models' kv_a_proj_with_mqa (512 + 64;
    # V3's 24576 and 18432 are Nemotron's and Arcee's above)
    for d in (5632, 2048, 10240, 16384, 9216, 13696, 1600, 4544, 6400, 8192, 18176, 4096,
              24576, 6144, 18432, 2560, 6912, 11264, 14336, 7168, 10944, 1536, 2816, 3072,
              576):
        y = torch.randn(SEQ, d, device=dev, generator=g).to(bf)
        recs["syrk_gram"].append(check_kernel(
            "syrk_gram",
            lambda: ops.syrk_gram(y),
            lambda: ops.syrk_gram_plain(y),
            lambda: y.t() @ y,
            flops=SEQ * d * d,
            nbytes=SEQ * d * 2 + d * d * 4,
            # f32 sums of exact bf16 products, in another order
            tol_fn=lambda ref: torch.full_like(ref, 1e-4 * float(ref.abs().max())),
            shape={"N": SEQ, "d": d, "dtype": "bf16"},
            graph=True,
        ))

    # the decompose walk's 1 x 1024 forward; then a ragged batch's padded
    # prefill (serving_paths at seed 0: 8 rows padded to 402, not a
    # multiple of the kernel's 128-row tiles)
    for b, s in ((1, SEQ), (8, 402)):
        flash_check(dev, g, recs, b, s)
    # Qwen2-1.5B's heads (head dim 128, group 6) and Gemma-2B's (head dim
    # 256, one kv head for eight) at the walk's 1 x 1024
    flash_check(dev, g, recs, 1, SEQ, h=12, h_kv=2, hd=128)
    flash_check(dev, g, recs, 1, SEQ, h=8, h_kv=1, hd=256)
    # Phi-3-mini's heads (head dim 96 on the 128 instance, no grouping) and
    # Gemma-3-1B's full layers (head dim 256, one kv head for four)
    flash_check(dev, g, recs, 1, SEQ, h=32, h_kv=32, hd=96)
    flash_check(dev, g, recs, 1, SEQ, h=4, h_kv=1, hd=256)
    # GLM-4-9B's heads (group 16, the largest) and OLMo-2-1B's (no grouping)
    flash_check(dev, g, recs, 1, SEQ, h=32, h_kv=2, hd=128)
    flash_check(dev, g, recs, 1, SEQ, h=16, h_kv=16, hd=128)
    # GPT-2 XL's heads (25, no grouping) and Falcon-7B's (71 query heads over
    # one kv head: 568 query tiles, the widest group); Pythia-1.4B's 16 / 16
    # heads of 128 are OLMo-2-1B's
    flash_check(dev, g, recs, 1, SEQ, h=25, h_kv=25, hd=64)
    flash_check(dev, g, recs, 1, SEQ, h=71, h_kv=1, hd=64)
    # GPT-J-6B's heads (head dim 256 with no grouping: each query head
    # streams its own K/V), OPT-6.7B's (32 / 32 of 128), StarCoderBase-1B's
    # (16 query heads over one kv head of 128), and GPT-Neo-2.7B's 20 / 20
    # heads of 128 at its unscaled logits (scale 1: logits ~11x the usual
    # range, which the kernel's online max and exp2 scaling must carry)
    flash_check(dev, g, recs, 1, SEQ, h=16, h_kv=16, hd=256)
    flash_check(dev, g, recs, 1, SEQ, h=32, h_kv=32, hd=128)
    flash_check(dev, g, recs, 1, SEQ, h=16, h_kv=1, hd=128)
    flash_check(dev, g, recs, 1, SEQ, h=20, h_kv=20, hd=128, scale=1.0)
    # slice 17: Arcee's 32 heads of 80 (head dim 80 on the 128 instance,
    # 80-wide tensor maps) at the walk's 1 x 1024 and its cached generate's
    # 4 x 128 prefill, Persimmon's 64 / 64 heads of 64 and Nemotron's 48 /
    # 48 of 128
    flash_check(dev, g, recs, 1, SEQ, h=32, h_kv=32, hd=80)
    flash_check(dev, g, recs, 4, FAMILY_PROMPT_LENS[0], h=32, h_kv=32, hd=80)
    flash_check(dev, g, recs, 1, SEQ, h=64, h_kv=64, hd=64)
    flash_check(dev, g, recs, 1, SEQ, h=48, h_kv=48, hd=128)
    # slice 18: BitNet's 20 query heads over 5 kv heads of 128 at the walk's
    # 1 x 1024 and its cached generate's 4 x 128 prefill (BLOOM's ALiBi
    # layers never take flash)
    flash_check(dev, g, recs, 1, SEQ, h=20, h_kv=5, hd=128)
    flash_check(dev, g, recs, 4, FAMILY_PROMPT_LENS[0], h=20, h_kv=5, hd=128)
    # slice 19: Mllama's text model's 32 query heads over 8 kv heads of 128
    # at the walk's 1 x 1024 and its cached generate's 4 x 128 prefill
    # (Moshi's 32 / 32 of 128 are OPT-6.7B's; Doge's and DiffLlama's
    # attention never takes flash)
    flash_check(dev, g, recs, 1, SEQ, h=32, h_kv=8, hd=128)
    flash_check(dev, g, recs, 4, FAMILY_PROMPT_LENS[0], h=32, h_kv=8, hd=128)

    # the served pairs' shapes first (bias-free; every site is accepted at
    # rank 32 with this configuration's thresholds: gate/up, then down),
    # then wider ranks with a bias, then the rows `generate` runs them at:
    # a decode step of the batch of 4 and its 4 x 128 prefill; then
    # serving_paths' decode steps: the batch of 8, and 4 beams of it; then
    # phi-2's fc1 and fc2
    shapes = ((SEQ, 2048, 32, 5632, False), (SEQ, 5632, 32, 2048, False),
              (SEQ, 2048, 256, 5632, True), (SEQ, 2048, 44, 5632, True),
              (4, 2048, 32, 5632, False), (4, 5632, 32, 2048, False),
              (512, 2048, 32, 5632, False), (512, 5632, 32, 2048, False),
              (8, 2048, 32, 5632, False), (8, 5632, 32, 2048, False),
              (32, 2048, 32, 5632, False), (32, 5632, 32, 2048, False),
              # phi-2's biased MLP pairs at rank 32
              (SEQ, 2560, 32, 10240, True), (SEQ, 10240, 32, 2560, True),
              # slice 15's MLP pairs at rank 32: GPT-2 XL's and
              # Pythia-1.4B's biased ones, Falcon-7B's unbiased (d 1600 and
              # 4544 off the grid); then the ranks its walks chose at seed
              # 0: GPT-2 XL's 25, Falcon-7B's 142 and 71 (layer 0's MLP) and
              # 17, and its k/v pairs' 64-wide outputs at rank 32
              (SEQ, 1600, 32, 6400, True), (SEQ, 6400, 32, 1600, True),
              (SEQ, 2048, 32, 8192, True), (SEQ, 8192, 32, 2048, True),
              (SEQ, 4544, 32, 18176, False), (SEQ, 18176, 32, 4544, False),
              (SEQ, 1600, 25, 6400, True), (SEQ, 6400, 25, 1600, True),
              (SEQ, 4544, 142, 18176, False), (SEQ, 18176, 71, 4544, False),
              (SEQ, 4544, 17, 18176, False), (SEQ, 18176, 17, 4544, False),
              (SEQ, 4544, 32, 64, False),
              # slice 16's pairs at rank 32: GPT-J-6B's and OPT-6.7B's
              # biased MLP (4096 <-> 16384) and StarCoderBase-1B's biased
              # k/v pairs with 128-wide outputs
              (SEQ, 4096, 32, 16384, True), (SEQ, 16384, 32, 4096, True),
              (SEQ, 2048, 32, 128, True),
              # and the other ranks their walks chose at seeds 0 and 1:
              # OPT-6.7B's layer-0 o_proj at 64 and v_proj at 128,
              # StarCoderBase-1B's o_proj at 64 and v_proj at 64 of 128
              (SEQ, 4096, 64, 4096, True), (SEQ, 4096, 128, 4096, True),
              (SEQ, 2048, 64, 2048, True), (SEQ, 2048, 64, 128, True),
              # slice 17's pairs at the ranks their walks chose at seeds 0
              # and 1: Nemotron's at 24 (6144 <-> 24576, 6144 -> 6144),
              # Arcee's at 40 (layer 0's MLP, 2560 <-> 18432) and 20 (the
              # rest), unbiased; Persimmon's at 32 with biases (its MLP's
              # 4096 <-> 16384 is OPT-6.7B's above)
              (SEQ, 6144, 24, 24576, False), (SEQ, 24576, 24, 6144, False),
              (SEQ, 6144, 24, 6144, False),
              (SEQ, 2560, 40, 18432, False), (SEQ, 18432, 40, 2560, False),
              (SEQ, 2560, 20, 18432, False), (SEQ, 18432, 20, 2560, False),
              (SEQ, 2560, 20, 2560, False), (SEQ, 4096, 32, 4096, True),
              # slice 18's pairs at the ranks their walks chose at seeds 0
              # and 1: BitNet's unbiased MLP at 20 (2560 <-> 6912), its k/v
              # pairs' 640-wide outputs at 20 and layer 0's v_proj at 80 and
              # 40 and o_proj at 80 (its q / o at 20 are Arcee's 2560 ->
              # 2560 above); BLOOM-7B1's biased up_proj at 256 and down_proj
              # at 128 (its q/k/v at 32 and o_proj at 64 are OPT-6.7B's above)
              (SEQ, 2560, 20, 6912, False), (SEQ, 6912, 20, 2560, False),
              (SEQ, 2560, 20, 640, False), (SEQ, 2560, 80, 640, False),
              (SEQ, 2560, 40, 640, False), (SEQ, 2560, 80, 2560, False),
              (SEQ, 4096, 256, 16384, True), (SEQ, 16384, 128, 4096, True),
              # slice 19's MLP pairs: Moshi's (4096 <-> 11264) and Mllama's
              # (4096 <-> 14336), unbiased
              (SEQ, 4096, 32, 11264, False), (SEQ, 11264, 32, 4096, False),
              (SEQ, 4096, 32, 14336, False), (SEQ, 14336, 32, 4096, False),
              # slice 21's pairs at the ranks DeepSeek's walks chose at seeds
              # 0 and 1 (the same at both), no bias: V3's q_a_proj and
              # q_b_proj at 24 (7168 -> 1536 -> 128 heads of 192),
              # kv_a_proj_with_mqa at 18 (-> 512 + 64), o_proj at 28 (128
              # heads of 128 -> 7168), dense MLP at 28 (7168 <-> 18432) and
              # shared expert at 32 (7168 <-> 2048); V2-Lite's q_proj at 32
              # (-> 16 heads of 192), kv_a_proj_with_mqa at 18, o_proj at 32,
              # dense MLP at 32 (2048 <-> 10944, off the 128 grid) and shared
              # experts at 32 (2048 <-> 2816)
              (SEQ, 7168, 24, 1536, False), (SEQ, 1536, 24, 24576, False),
              (SEQ, 7168, 18, 576, False), (SEQ, 16384, 28, 7168, False),
              (SEQ, 7168, 28, 18432, False), (SEQ, 18432, 28, 7168, False),
              (SEQ, 7168, 32, 2048, False), (SEQ, 2048, 32, 7168, False),
              (SEQ, 2048, 32, 3072, False), (SEQ, 2048, 18, 576, False),
              (SEQ, 2048, 32, 2048, False),
              (SEQ, 2048, 32, 10944, False), (SEQ, 10944, 32, 2048, False),
              (SEQ, 2048, 32, 2816, False), (SEQ, 2816, 32, 2048, False))
    for n, d_in, r, d_out, with_bias in shapes:
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        bias = torch.randn(d_out, device=dev, generator=g).to(bf) if with_bias else None
        # the factors as a fused pair holds them: views of the Linear weights
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(bf).t()
        recs["lowrank_matmul"].append(check_kernel(
            "lowrank_matmul",
            lambda: ops.lowrank_matmul(x, k1, k2, bias),
            lambda: ops.lowrank_matmul_plain(x, k1, k2, bias),
            lambda: (x @ k1) @ k2 if bias is None else torch.addmm(bias, x @ k1, k2),
            flops=2 * n * r * (d_in + d_out),
            nbytes=2 * (n * d_in + r * d_in + r * d_out + d_out * with_bias + n * d_out),
            # both round the hidden to bf16 (an f32 sum in another order
            # rarely rounds the other way) and the output (one ulp,
            # at most 2^-7 * |ref|); the terms' scale is the outputs' RMS
            tol_fn=lambda ref: 2.0 ** -6 * (ref.abs() + ref.square().mean().sqrt()),
            shape={"n": n, "d_in": d_in, "r": r, "d_out": d_out, "bias": with_bias,
                   "dtype": "bf16"},
            graph=True,
        ))

    # the f32 path: dwain_mlp's served pairs (rank 32 at d 2048, with the
    # second Linear's bias), a rank the Pallas kernel's gate admits, a
    # decode step's 8 rows into TinyLlama's MLP width, and ConvNeXt-Tiny's
    # f32 pairs at full_rank // 4 (the shipped walks are f32; batch 64):
    # stage 1's pwconv1 over 64 x 56 x 56 pixels and stage 4's pwconv2
    for n, d_in, r, d_out in ((MLP_BATCH, MLP_DIM, 32, MLP_DIM), (MLP_BATCH, MLP_DIM, 256, MLP_DIM),
                              (8, 2048, 32, 5632), (200704, 96, 24, 384), (3136, 3072, 192, 768)):
        x = torch.randn(n, d_in, device=dev, generator=g)
        bias = torch.randn(d_out, device=dev, generator=g)
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).t()
        # the cluster sums its partials in rank order: the same bits every run
        first, again = ops.lowrank_matmul(x, k1, k2, bias), ops.lowrank_matmul(x, k1, k2, bias)
        if not torch.equal(first, again):
            raise AssertionError(f"lowrank_matmul f32 {(n, d_in, r, d_out)}: two launches differ "
                                 f"by up to {float((first - again).abs().max())}")
        del first, again
        flops = 2 * n * r * (d_in + d_out)
        recs["lowrank_matmul"].append(check_kernel(
            "lowrank_matmul",
            lambda: ops.lowrank_matmul(x, k1, k2, bias),
            lambda: ops.lowrank_matmul_plain(x, k1, k2, bias),
            lambda: torch.addmm(bias, x @ k1, k2),
            # the kernel's own work: three TF32 products for each f32 one;
            # beside it, exact f32 on the CUDA cores
            flops=3 * flops,
            nbytes=4 * (n * d_in + r * d_in + r * d_out + d_out + n * d_out),
            # each product within about 2^-20 of |a b| (3xTF32), f32 sums
            # in another order: the error of a sum of K terms is about
            # sqrt(K) * 2^-20 of their RMS, far under 2^-14 of the
            # outputs' RMS (one-pass TF32 breaks it; tests/test_torch_lowrank_f32.py)
            tol_fn=lambda ref: 2.0 ** -14 * (ref.abs() + ref.square().mean().sqrt()),
            shape={"n": n, "d_in": d_in, "r": r, "d_out": d_out, "bias": True, "dtype": "f32",
                   "launch": ops.lowrank.launch_shape_f32(n, d_in, r, d_out)._asdict()},
            graph=True, path="f32_3xtf32", peak=PEAK_TF32_FLOPS,
            other_bounds={"f32": (flops, PEAK_F32_FLOPS)},
        ))
        del x, k1, k2, bias
        torch.cuda.empty_cache()
    return recs


def routed_group_sizes(n_tokens: int, seed: int, n_experts: int = 8, top_k: int = 2):
    """Group sizes of ``n_tokens`` tokens each routed to ``top_k`` distinct
    experts, drawn from a seed with uneven expert popularity."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(n_experts, 4.0))
    ids = [rng.choice(n_experts, top_k, replace=False, p=p) for _ in range(n_tokens)]
    return np.bincount(np.concatenate(ids), minlength=n_experts).astype(np.int32)


def single_rounding_tol(ref: torch.Tensor) -> torch.Tensor:
    """f32 sums of exact bf16 products, rounded once to bf16 on both sides:
    where the sums round apart they differ by one bf16 ulp, which is up to
    2^-7 |ref| (just above a power of two); the limit is two such ulps, and
    2^-9 of the outputs' RMS covers the sums' order near zero."""
    return 2.0 ** -6 * ref.abs() + 2.0 ** -9 * ref.square().mean().sqrt()


def grouped_library(lhs, weights, group_sizes):
    """One PyTorch call for the same grouped product: ``torch._grouped_mm``
    where this PyTorch has it and takes these operands, else one dense
    ``torch.matmul`` over the same rows (named in the record)."""
    stack = torch.stack(weights)  # (E, N, K), a copy made outside the timing
    offs = torch.cumsum(group_sizes, 0).to(torch.int32)
    if hasattr(torch, "_grouped_mm"):
        try:
            fn = lambda: torch._grouped_mm(lhs, stack.transpose(1, 2), offs=offs)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            return fn, "torch._grouped_mm"
        except RuntimeError as exc:
            emit({"phase": "library", "grouped_mm_refused": str(exc)[:200]})
    return (lambda: lhs @ stack[0].t()), "torch.matmul (dense, same rows)"


def grouped_line(dev, g, recs: dict, sizes: np.ndarray, k: int, n: int, what: str,
                 route: str | None = None) -> None:
    """The bf16 grouped kernel against its plain version on ``sizes`` rows
    (random lhs and weights), beside ``torch._grouped_mm``; ``route``
    "mma_sync" forces the mma.sync route on a shape that takes wgmma (the
    route it took before the experts' tensor maps moved into a table)."""
    bf = torch.bfloat16
    m, routed = int(sizes.sum()), int((sizes > 0).sum())
    lhs = torch.randn(m, k, device=dev, generator=g).to(bf)
    weights = [(torch.randn(n, k, device=dev, generator=g) / k ** 0.5).to(bf) for _ in sizes]
    gs = torch.from_numpy(sizes).to(dev)
    library_fn, library = grouped_library(lhs, weights, gs)
    limit = gmm.MAX_TMA_EXPERTS
    if route == "mma_sync":  # the old limit: 16 tensor maps as kernel parameters
        gmm.MAX_TMA_EXPERTS = 16
    try:
        recs["grouped_matmul"].append(check_kernel(
            "grouped_matmul",
            lambda: ops.grouped_matmul(lhs, weights, gs),
            lambda: ops.grouped_matmul_plain(lhs, weights, gs),
            library_fn,
            flops=2 * m * k * n,
            nbytes=2 * m * k + 2 * routed * n * k + 4 * len(sizes) + 2 * m * n,
            tol_fn=single_rounding_tol,
            shape={"what": what, "M": m, "K": k, "N": n, "experts": len(sizes),
                   "routed": routed, "group_sizes": sizes.tolist(),
                   "bm": gmm.block_rows(m, len(sizes)), "dtype": "bf16",
                   "library": library},
            # the plain version reads the group sizes on the host
            graph=True, plain_graph=False, path=gmm.kernel_route(m, k, n, len(sizes)),
        ))
    finally:
        gmm.MAX_TMA_EXPERTS = limit
    del lhs, weights, library_fn
    torch.cuda.empty_cache()


def int8_line(dev, g, recs: dict, sizes: np.ndarray, k: int, n: int, what: str) -> None:
    """The int8 grouped kernel against its plain version on ``sizes`` rows
    (random lhs, grids and scales), beside the dequantize route that
    ``MoEMLP._grouped`` takes (every grid dequantized to bf16, then the
    bf16 grouped kernel)."""
    bf = torch.bfloat16
    m, e, routed = int(sizes.sum()), len(sizes), int((sizes > 0).sum())
    gs = torch.from_numpy(sizes).to(dev)
    xg = torch.randn(m, k, device=dev, generator=g).to(bf)
    w_q = [torch.randint(-127, 128, (n, k), device=dev, generator=g, dtype=torch.int8)
           for _ in sizes]
    scales = [(0.5 + 0.5 * torch.rand(n, device=dev, generator=g)) / (127 * k ** 0.5)
              for _ in sizes]

    def dequant_route():
        deq = [w.to(bf) * s.to(bf)[:, None] for w, s in zip(w_q, scales)]
        return ops.grouped_matmul(xg, deq, gs)

    route = gmm_int8.kernel_route(m, k, n, e)
    tile = ({"bn": gmm_int8.batch_rows(m, e)} if route == "batch" else dict(zip(
        ("k_split", "k_steps_a_split"),
        gmm_int8.decode_split(m, k, n, e, gmm_int8._sm_count(dev.index or 0),
                              gmm_int8.DECODE_BLOCK_K, gmm_int8.DECODE_COLS))))
    recs["gmm_int8"].append(check_kernel(
        "gmm_int8",
        lambda: ops.grouped_matmul_int8(xg, w_q, scales, gs),
        lambda: ops.grouped_matmul_int8_plain(xg, w_q, scales, gs),
        None,
        flops=2 * m * k * n,
        nbytes=2 * m * k + routed * n * k + 4 * routed * n + 2 * m * n,
        tol_fn=single_rounding_tol,
        shape={"what": what, "M": m, "K": k, "N": n, "experts": e, "routed": routed,
               "group_sizes": sizes.tolist(), **tile,
               "dtype": "int8 weights, bf16 activations"},
        # the plain version reads the group sizes on the host; the
        # dequantize route allocates its copies each call: both by events
        graph=True, plain_graph=False, path=route,
        extra_fns={"dequant_route": dequant_route},
    ))
    del xg, w_q, scales
    torch.cuda.empty_cache()


def moe_kernel_checks(dev, recs: dict[str, list[dict]]) -> None:
    """The MoE serving path's kernels at Mixtral-8x7B width: the bf16
    grouped matmul at prefill and decode, the int8 grouped matmul at 8, 16,
    512 and 4096 routed rows, and flash attention at the prefill's head_dim
    128; then both grouped kernels at the slice-20 families' expert counts
    and widths (``MOE_FAMILIES``, at their published expert counts:
    DeepSeek-V3's 256 is ``gmm.MAX_TMA_EXPERTS``): the walk's 1 x 1024
    tokens (the bf16 kernel there on both routes, wgmma and the mma.sync
    route it took before, for the slice-20 families) and the 4-prompt
    decode step."""
    g = torch.Generator(device=dev).manual_seed(2)
    dim, hidden = MIXTRAL_8X7B["hidden_size"], MIXTRAL_8X7B["intermediate_size"]
    n_tokens = MOE_BATCH * MOE_PROMPT
    for n_tok, (k, n), what in ((n_tokens, (dim, hidden), "prefill gate/up"),
                                (n_tokens, (hidden, dim), "prefill down"),
                                (8, (dim, hidden), "decode gate/up"),
                                (8, (hidden, dim), "decode down")):
        grouped_line(dev, g, recs, routed_group_sizes(n_tok, seed=100 + n_tok + k), k, n, what)

    # the int8 kernel at the decode steps (8 and 16 rows), 512 rows and the
    # prefill's 4096
    for n_tok, (k, n), what in ((4, (dim, hidden), "decode gate/up, batch 4"),
                                (4, (hidden, dim), "decode down, batch 4"),
                                (8, (dim, hidden), "decode gate/up, batch 8"),
                                (256, (dim, hidden), "256 tokens gate/up"),
                                (n_tokens, (dim, hidden), "prefill gate/up"),
                                (n_tokens, (hidden, dim), "prefill down")):
        int8_line(dev, g, recs, routed_group_sizes(n_tok, seed=200 + n_tok + k), k, n, what)

    flash_check(dev, g, recs, MOE_BATCH, MOE_PROMPT, h=32, h_kv=8, hd=128)

    for family, hf in MOE_FAMILIES.items():
        cfg = models.TransformerConfig.from_hf_config(hf, dtype=torch.bfloat16)
        e, top_k, width = cfg.n_experts, cfg.n_experts_per_tok, cfg.moe_hidden_dim
        for n_tok, (k, n), what in ((SEQ, (cfg.dim, width), "walk gate/up"),
                                    (SEQ, (width, cfg.dim), "walk down"),
                                    (FAMILY_PROMPTS, (cfg.dim, width), "decode gate/up"),
                                    (FAMILY_PROMPTS, (width, cfg.dim), "decode down")):
            sizes = routed_group_sizes(n_tok, seed=300 + n_tok + k + e, n_experts=e, top_k=top_k)
            grouped_line(dev, g, recs, sizes, k, n, f"{family} {what}")
            if n_tok == SEQ and cfg.kv_lora_rank is None:
                grouped_line(dev, g, recs, sizes, k, n, f"{family} {what}, mma_sync route",
                             route="mma_sync")
            int8_line(dev, g, recs, sizes, k, n, f"{family} {what}")


def tinyllama_2_layer() -> models.TransformerConfig:
    full = models.TransformerConfig.tinyllama_1_1b(dtype=torch.bfloat16)
    return dataclasses.replace(full, n_layers=N_LAYERS)


class _Draws:
    """The planted weights' draws: f32 standard normals from a
    ``torch.Generator`` on ``dev`` seeded ``seed`` (the products on the
    card too), and constant vectors."""

    def __init__(self, seed: int, dev) -> None:
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(self, *shape: int) -> torch.Tensor:
        return torch.randn(shape, device=self.dev, generator=self.gen)

    def full(self, n: int, value: float) -> torch.Tensor:
        return torch.full((n,), value, device=self.dev)

    def planted(self, d_out: int, d_in: int) -> torch.Tensor:
        """``A @ B / sqrt(r * d_in)`` plus 1% noise, r = 256."""
        w = (self.normal(d_out, PLANTED_RANK) @ self.normal(PLANTED_RANK, d_in)) / math.sqrt(
            PLANTED_RANK * d_in)
        w += 0.01 * self.normal(d_out, d_in) / math.sqrt(d_in)
        return w


def planted_moe_weights(cfg: models.TransformerConfig, p: str, draws: "_Draws") -> dict:
    """An MoE layer's weights under prefix ``p``: every expert (and the
    shared expert) planted at rank 256 like a dense MLP, the router and the
    shared expert's gate unit-gain normals (logits of RMS 1 over RMS-1
    inputs), DeepSeek-V3's correction bias normal at ``DEEPSEEK_BIAS_STD``."""
    sd = {p + "gate.weight": draws.normal(cfg.n_experts, cfg.dim) / math.sqrt(cfg.dim)}
    widths = {f"experts.{e}.": cfg.moe_hidden_dim or cfg.hidden_dim
              for e in range(cfg.n_experts)}
    if cfg.shared_expert_hidden_dim is not None:
        widths["shared_expert."] = cfg.shared_expert_hidden_dim
        if cfg.shared_expert_gated:
            sd[p + "shared_expert_gate.weight"] = draws.normal(1, cfg.dim) / math.sqrt(cfg.dim)
    for name, width in widths.items():
        sd[p + name + "gate_proj.weight"] = draws.planted(width, cfg.dim)
        sd[p + name + "up_proj.weight"] = draws.planted(width, cfg.dim)
        sd[p + name + "down_proj.weight"] = draws.planted(cfg.dim, width)
    if cfg.router_correction_bias:
        sd[p + "gate_correction_bias"] = DEEPSEEK_BIAS_STD * draws.normal(cfg.n_experts)
    return sd


def planted_mla_weights(cfg: models.TransformerConfig, p: str, draws: "_Draws") -> dict:
    """A latent attention's weights under prefix ``p``: every projection
    planted at rank 256, the lora norms the identity."""
    h, lat = cfg.n_heads, cfg.kv_lora_rank
    qk_head = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    sd = {p + "kv_a_proj_with_mqa.weight": draws.planted(lat + cfg.qk_rope_head_dim, cfg.dim),
          p + "kv_a_layernorm.weight": draws.full(lat, 1.0),
          p + "kv_b_proj.weight": draws.planted(h * (cfg.qk_nope_head_dim + cfg.v_head_dim), lat),
          p + "o_proj.weight": draws.planted(cfg.dim, h * cfg.v_head_dim)}
    if cfg.q_lora_rank is None:
        sd[p + "q_proj.weight"] = draws.planted(h * qk_head, cfg.dim)
    else:
        sd[p + "q_a_proj.weight"] = draws.planted(cfg.q_lora_rank, cfg.dim)
        sd[p + "q_a_layernorm.weight"] = draws.full(cfg.q_lora_rank, 1.0)
        sd[p + "q_b_proj.weight"] = draws.planted(h * qk_head, cfg.q_lora_rank)
    return sd


def planted_rank_weights(cfg: models.TransformerConfig, seed: int, dev) -> dict:
    """Random weights in HF names, drawn on ``dev`` (``_Draws``); every
    decomposable projection is planted at rank 256 (``_Draws.planted``), a
    non-gated MLP (GPT-2, GPT-NeoX, Falcon, Nemotron) without
    ``gate_proj``, an MoE layer as ``planted_moe_weights`` draws it.  Projection biases (Qwen2's and GLM-4's q/k/v, GPT-2's and
    GPT-NeoX's q/k/v/o and MLP, GPT-J's head) are 0.1-scale noise; norms
    (the sandwich norms, OLMo-2's post norms and flat q/k norms too) are the
    identity (zeros for gemma's and Nemotron's (1 + w) norms, none for
    OLMo's norms without an affine; BLOOM's embedding norm and BitNet's
    sub-norms too), a LayerNorm's offset (Persimmon's q/k LayerNorms' too)
    0.1-scale noise; Doge's ``dt_proj`` a unit-gain normal, its A and
    residual scales and DiffLlama's lambdas off their neutral values
    (``DOGE_A_STD``, ...); mllama's skipped layers have none; a tied
    embedding has RMS 1 /
    sqrt(dim), so the tied head's logits have RMS 1 (and gemma's
    sqrt(dim)-scaled embeddings RMS 1), and GPT-2's position table the same
    RMS as its tied embedding."""
    draws = _Draws(seed, dev)
    planted = draws.planted
    hd = cfg.head_dim
    weight = draws.full(cfg.dim, 0.0 if cfg.norm_plus_one else 1.0)

    def bias(n: int):
        return 0.1 * draws.normal(n)

    def norm(name: str) -> None:
        if cfg.norm_no_affine:
            return
        sd[name + ".weight"] = weight
        if cfg.norm_type == "layernorm" and cfg.norm_bias:
            sd[name + ".bias"] = bias(cfg.dim)

    embed = draws.normal(cfg.embed_vocab_size or cfg.vocab_size, cfg.dim)
    sd = {"model.embed_tokens.weight": embed / math.sqrt(cfg.dim) if cfg.tie_embeddings
          else embed}
    if cfg.learned_pos is not None:
        sd["model.pos_embed.weight"] = draws.normal(cfg.learned_pos, cfg.dim) / math.sqrt(cfg.dim)
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        if i < len(cfg.layer_types) and cfg.layer_types[i] == "skip":
            continue  # mllama's cross-attention layer: a SkipBlock
        if cfg.kv_lora_rank is not None:
            sd.update(planted_mla_weights(cfg, p + "self_attn.", draws))
        else:
            sd[p + "self_attn.q_proj.weight"] = planted(cfg.n_heads * hd, cfg.dim)
            sd[p + "self_attn.k_proj.weight"] = planted(cfg.n_kv_heads * hd, cfg.dim)
            sd[p + "self_attn.v_proj.weight"] = planted(cfg.n_kv_heads * hd, cfg.dim)
            sd[p + "self_attn.o_proj.weight"] = planted(cfg.dim, cfg.n_heads * hd)
        if cfg.layer_is_sparse(i):
            sd.update(planted_moe_weights(cfg, p + "mlp.", draws))
        else:
            if cfg.mlp_gated:
                sd[p + "mlp.gate_proj.weight"] = planted(cfg.hidden_dim, cfg.dim)
            sd[p + "mlp.up_proj.weight"] = planted(cfg.hidden_dim, cfg.dim)
            sd[p + "mlp.down_proj.weight"] = planted(cfg.dim, cfg.hidden_dim)
        if cfg.qkv_bias:
            for proj, heads in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
                sd[p + f"self_attn.{proj}_proj.bias"] = bias(heads * hd)
        if cfg.o_proj_bias:
            sd[p + "self_attn.o_proj.bias"] = bias(cfg.dim)
        if cfg.mlp_bias:
            for proj in ("gate", "up", "down") if cfg.mlp_gated else ("up", "down"):
                width = cfg.dim if proj == "down" else cfg.hidden_dim
                sd[p + f"mlp.{proj}_proj.bias"] = bias(width)
        if cfg.qk_norm or cfg.qk_norm_flat:
            widths = (cfg.n_heads * hd, cfg.n_kv_heads * hd) if cfg.qk_norm_flat else (hd, hd)
            for proj, width in zip("qk", widths):
                sd[p + f"self_attn.{proj}_norm.weight"] = draws.full(
                    width, 0.0 if cfg.norm_plus_one else 1.0)
                if cfg.qk_norm_type == "layernorm":
                    sd[p + f"self_attn.{proj}_norm.bias"] = bias(width)
        if not cfg.post_norm_only:
            norm(p + "input_layernorm")
        if cfg.parallel_residual != "one_norm":
            norm(p + "post_attention_layernorm")
        if cfg.sandwich_norms:
            norm(p + "pre_feedforward_layernorm")
        if cfg.sandwich_norms or cfg.post_norm_only:
            norm(p + "post_feedforward_layernorm")
        if cfg.sub_norms:
            sd[p + "self_attn.attn_sub_norm.weight"] = draws.full(cfg.n_heads * hd, 1.0)
            sd[p + "mlp.ffn_sub_norm.weight"] = draws.full(cfg.hidden_dim, 1.0)
        if cfg.dyn_mask_keep_window is not None:
            sd[p + "self_attn.dt_proj.weight"] = draws.normal(
                cfg.n_kv_heads, cfg.n_kv_heads * hd) / math.sqrt(cfg.n_kv_heads * hd)
            if cfg.qkv_bias:
                sd[p + "self_attn.dt_proj.bias"] = bias(cfg.n_kv_heads)
            sd[p + "self_attn.dyn_mask_A"] = DOGE_A_STD * draws.normal(cfg.n_kv_heads)
        if cfg.residual_scales:
            for name in ("input_residual", "post_attention_residual"):
                sd[p + name] = 1.0 + DOGE_RESIDUAL_STD * draws.normal(cfg.dim)
        if cfg.diff_attention:
            for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
                sd[p + f"self_attn.{name}"] = DIFF_LAMBDA_STD * draws.normal(hd)
    if cfg.embed_norm:
        norm("model.embed_norm")
    if cfg.final_norm:
        norm("model.norm")
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = draws.normal(cfg.vocab_size, cfg.dim) / math.sqrt(cfg.dim)
    if cfg.lm_head_bias:
        sd["tied_head_bias" if cfg.tie_embeddings else "lm_head.bias"] = bias(cfg.vocab_size)
    return sd


def token_batches(vocab: int, seed: int):
    rng = np.random.default_rng(seed)
    while True:
        yield {"input_ids": torch.from_numpy(rng.integers(0, vocab, (1, SEQ), dtype=np.int64))}


def logits_agree(a: torch.Tensor, b: torch.Tensor, max_abs: float, rms_rel: float,
                 what: str) -> dict:
    """Gate ``a`` against ``b`` on the largest difference and on the RMS of
    the difference relative to the RMS of ``b``; returns both readings."""
    d = a.float() - b.float()
    got = {"max_abs_diff": float(d.abs().max()),
           "rms_rel_diff": float(d.square().mean().sqrt() / b.float().square().mean().sqrt()),
           "limit_max_abs": max_abs, "limit_rms_rel": rms_rel}
    if not (torch.isfinite(a).all() and got["max_abs_diff"] <= max_abs
            and got["rms_rel_diff"] <= rms_rel):
        emit({"phase": what, **got, "ok": False})
        raise AssertionError(f"{what}: {got}")
    return got


def require_launches(counts: dict[str, int], names: tuple, what: str) -> None:
    missing = [n for n in names if counts[n] <= 0]
    if missing:
        raise AssertionError(f"{what} did not launch {missing}: {counts}")


class Routing(contextlib.ContextDecorator):
    """Records the top-k expert set each MoE layer routes each token to (it
    wraps the layers' ``_routing``; the expert projections stay unhooked,
    so the grouped routes still run).

    With ``forced`` (per layer, (b, tokens, k) as ``per_layer`` gives them,
    the tokens of successive calls joined in order) each token is routed to
    those experts instead, weighted as the layer weights them
    (``moe_combine_weights`` of its own scores: renormalized, and scaled,
    where the layer does so).  A reference routed as the run it checks has no
    routing flips: a near-tie between the k-th and next expert can break one
    way in one run and the other way in the other, which changes that
    token's output by O(1) and, through attention, every later token's.
    ``near_ties`` counts the (layer, token) pairs whose own top-k differed
    from the forced one.  Routing as given is bit-identical to the
    layer's own where they agree."""

    def __init__(self, model, batch: int, forced: dict | None = None) -> None:
        self.model, self.batch, self.forced = model, batch, forced
        self.calls, self.near_ties, self.routed = [], 0, 0

    def __enter__(self):
        # (a SkipBlock has no MLP)
        self.moes = [(i, layer.mlp) for i, layer in enumerate(self.model.model.layers)
                     if isinstance(getattr(layer, "mlp", None), models.transformer.MoEMLP)]
        for i, moe in self.moes:
            moe._routing = self._wrap(i, moe)
        return self

    def _wrap(self, i, moe):
        own, done = moe._routing, [0]

        def routing(x):
            vals, idx = own(x)
            if self.forced is not None:
                s = idx.numel() // (moe.top_k * self.batch)
                ids = self.forced[i][:, done[0]:done[0] + s].reshape(idx.shape)
                done[0] += s
                self.near_ties += int((idx.sort(dim=-1).values != ids).any(dim=-1).sum())
                self.routed += ids.numel() // moe.top_k
                scores = models.transformer.router_scores(moe, x)
                vals, idx = models.transformer.moe_combine_weights(moe, scores, ids), ids
            self.calls.append((i, idx.sort(dim=-1).values.reshape(self.batch, -1, moe.top_k)))
            return vals, idx

        return routing

    def __exit__(self, *exc):
        for _, moe in self.moes:
            del moe._routing
        return False

    def per_layer(self) -> dict[int, torch.Tensor]:
        """(b, tokens, k) expert sets per layer, the calls joined along the
        token axis in order."""
        out: dict[int, list] = {}
        for i, ids in self.calls:
            out.setdefault(i, []).append(ids)
        return {i: torch.cat(v, dim=1) for i, v in out.items()}

    def gate(self, what: str, limit: float = MAX_NEAR_TIE_SHARE) -> dict:
        """The near-tie reading, gated at ``limit``."""
        share = self.near_ties / max(self.routed, 1)
        got = {"near_ties": self.near_ties, "routed": self.routed, "near_tie_share": share,
               "limit_near_tie_share": limit}
        if share > limit:
            emit({"phase": what, **got, "ok": False})
            raise AssertionError(f"{what}: {got}")
        return got


def cached_generate(model, prompt, new_tokens: int, what: str,
                    max_abs: float = CACHED_MAX_ABS, rms_rel: float = CACHED_RMS_REL,
                    near_ties: float = MAX_NEAR_TIE_SHARE) -> dict:
    """Greedy ``generate`` from a zero launch count, then each step's logits
    held against the uncached forward of the same tokens, routed as the
    cached run was (for an MoE model; ``near_ties`` limits the share of
    routings that overrode the uncached forward's own)."""
    b, s_p = prompt.shape
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with Routing(model, b) as cached:
        toks, step_logits = serving.generate(model, prompt, new_tokens, return_logits=True)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    grouped_routes = dict(ops.grouped_matmul.route_launches)
    int8_routes = dict(ops.grouped_matmul_int8.route_launches)
    full = torch.cat([prompt, toks[:, :-1]], dim=1)
    routes = cached.per_layer()
    with torch.no_grad(), Routing(model, b, forced=routes) as forced:
        uncached = model({"input_ids": full})[:, s_p - 1:]
    got = logits_agree(step_logits, uncached, max_abs, rms_rel, what)
    got.update(forced.gate(what, near_ties))
    # the prefill's row alone: the same tokens through the same kernels
    got["prefill_max_abs_diff"] = float((step_logits[:, 0].float() - uncached[:, 0].float()).abs().max())
    return {"tokens": toks, "full": full, "uncached": uncached, "counts": counts,
            "grouped_routes": grouped_routes, "int8_routes": int8_routes,
            "wall_s": wall, "gate": got, "routes": routes, "step_logits": step_logits}


def serve_timings(model, prompt, tok) -> dict:
    """Prefill of the prompt batch and one decode step, CUDA-event medians
    after warm-up (the cache is rewritten in place each run); then the
    decode step's host time to enqueue its work, and its device busy time
    from a short torch.profiler window."""
    b, s_p = prompt.shape
    caches = serving.init_cache(model, b, s_p + 1)
    last_pos = torch.full((b,), s_p - 1, device=prompt.device)
    prefill = time_ms(lambda: serving.forward_with_cache(model, prompt, caches, 0,
                                                         last_pos=last_pos), reps=10)

    def step():
        return serving.forward_with_cache(model, tok, caches, s_p)

    decode = time_ms(step, reps=25)
    enqueue = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    n = 5
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    return {"prefill_ms": prefill, "decode_step_ms": decode,
            "decode_enqueue_ms": statistics.median(enqueue),
            "decode_device_busy_ms": busy_ms, "decode_device_busy_share": busy_ms / decode,
            "decode_top_kernels_ms": {e.key[:60]: e.self_device_time_total / 1e3 / n for e in top}}


def mixtral_2_layer() -> models.TransformerConfig:
    full = models.TransformerConfig.from_hf_config(MIXTRAL_8X7B, dtype=torch.bfloat16)
    return dataclasses.replace(full, n_layers=MOE_LAYERS)


def f32_twin(model):
    """A deep copy of ``model`` in f32 on the card, its fused factor pairs
    unfused.  f32 takes the plain routes by the dtype rule (the plain
    grouped product, plain attention, int8 grids dequantized exactly in
    f32, cuBLAS for the pairs), so holding the model against its twin holds
    the kernels and their wrappers against the plain path end to end."""
    twin = copy.deepcopy(model)
    pnn.unfuse_factor_pairs(twin)
    return twin.to(torch.float32)


def against_twin(twin, ids: torch.Tensor, routes: dict, logits: torch.Tensor, start: int,
                 max_abs: float, rms_rel: float, what: str) -> dict:
    """``logits`` (b, s - start, vocab), the model's for tokens ``ids`` (b,
    s) from position ``start`` on, against the f32 twin's uncached forward
    of ``ids`` routed as the model was (``routes``); the twin must launch
    no kernel."""
    ops.reset_launch_counts()
    with torch.no_grad(), Routing(twin, ids.shape[0], forced=routes) as forced:
        y32 = twin({"input_ids": ids})[:, start:]
    torch.cuda.synchronize()
    plain_counts = ops.launch_counts()
    if any(plain_counts.values()):
        raise AssertionError(f"{what}: the f32 reference launched kernels: {plain_counts}")
    return {"tokens": list(ids.shape), **logits_agree(logits, y32, max_abs, rms_rel, what),
            **forced.gate(what)}


def forward_against_twin(model, twin, ids: torch.Tensor, what: str) -> dict:
    """The model's uncached forward of ``ids`` against its f32 twin's, at
    the bf16 limits, with the model's launch counts."""
    ops.reset_launch_counts()
    with torch.no_grad(), Routing(model, ids.shape[0]) as routes:
        y = model({"input_ids": ids})
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    got = against_twin(twin, ids, routes.per_layer(), y, 0, MOE_REF_MAX_ABS, MOE_REF_RMS_REL,
                       what)
    return {**got, "launches": counts}


def moe_serve(dev, seed: int) -> dict[str, dict[str, int]]:
    """Slice 2's path: the Mixtral-width model served in bf16, held against
    itself in f32 on the card, then quantized to int8 and served again.
    Returns each run's launch counts."""
    cfg = mixtral_2_layer()
    model = models.CausalLM(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    n_params = utils.get_num_params(model)
    rng = np.random.default_rng(seed + 10)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), dtype=np.int64)
    ).to(dev)

    bf16 = cached_generate(model, prompt, MOE_NEW, "moe_serve_bf16")
    require_launches(bf16["counts"], ("grouped_matmul", "flash_attention"), "moe_serve bf16")
    # the prefill's grouped products take the wgmma route, decode's mma.sync
    require_launches(bf16["grouped_routes"], ("wgmma", "mma_sync"), "moe_serve bf16 routes")
    emit({"phase": "moe_serve", "dtype": "bf16", "layers": cfg.n_layers, "params": n_params,
          "weight_bytes": sum(t.numel() * t.element_size() for t in model.state_dict().values()),
          "batch": MOE_BATCH, "prompt": MOE_PROMPT, "new_tokens": MOE_NEW,
          "generate_wall_s": bf16["wall_s"], **bf16["gate"], "launches": bf16["counts"],
          "grouped_routes": bf16["grouped_routes"],
          **serve_timings(model, prompt, bf16["tokens"][:, :1])})

    # the bf16 model against itself in f32 on the card
    ref_ids = prompt[:1, :MOE_REF_TOKENS]
    twin = f32_twin(model)
    got = forward_against_twin(model, twin, ref_ids, "moe_reference")
    del twin
    torch.cuda.empty_cache()
    emit({"phase": "moe_reference", "dtype": "bf16", **got})

    quant.quantize_for_serving(model)
    int8 = cached_generate(model, prompt, MOE_NEW, "moe_serve_int8")
    require_launches(int8["counts"], ("gmm_int8", "flash_attention"), "moe_serve int8")
    # the card's int8 route takes every row count: the prefill's 4096 rows
    # take the batch route, the decode steps' 8 the decode route, and
    # nothing is dequantized for the bf16 grouped kernel
    require_launches(int8["int8_routes"], ("batch", "decode"), "moe_serve int8 routes")
    if int8["counts"]["grouped_matmul"]:
        raise AssertionError(f"moe_serve int8 dequantized its experts: {int8['counts']}")
    # int8 against bf16 on the same tokens (the bf16 run's), uncached and
    # routed as the bf16 run was: the quantization error
    with torch.no_grad(), Routing(model, MOE_BATCH, forced=bf16["routes"]) as forced:
        y_int8 = model({"input_ids": bf16["full"]})[:, MOE_PROMPT - 1:]
    vs_bf16 = {**logits_agree(y_int8, bf16["uncached"], INT8_MAX_ABS, INT8_RMS_REL,
                              "moe_int8_vs_bf16"),
               **forced.gate("moe_int8_vs_bf16")}
    agree = float((int8["tokens"] == bf16["tokens"]).float().mean())
    emit({"phase": "moe_serve", "dtype": "int8", "generate_wall_s": int8["wall_s"],
          **int8["gate"], "int8_vs_bf16": vs_bf16,
          "tokens_equal_to_bf16": agree, "launches": int8["counts"],
          "int8_routes": int8["int8_routes"],
          "weight_bytes": sum(t.numel() * t.element_size() for t in model.state_dict().values()),
          **serve_timings(model, prompt, int8["tokens"][:, :1])})

    # the int8 model against itself in f32 on the card, at the bf16 limits:
    # the int8 run's own step logits (prefill's last row, then the decode
    # steps that took gmm_int8 at 8 rows) against the twin's uncached
    # forward of the same tokens, and a 128-token forward (256 rows, so
    # gmm_int8's batch route at its 128-row tile)
    twin = f32_twin(model)
    steps = against_twin(twin, int8["full"], int8["routes"], int8["step_logits"],
                         MOE_PROMPT - 1, CACHED_MAX_ABS, CACHED_RMS_REL,
                         "moe_reference_int8_steps")
    forward = forward_against_twin(model, twin, ref_ids, "moe_reference_int8")
    del twin
    torch.cuda.empty_cache()
    require_launches(forward["launches"], ("gmm_int8",), "moe_reference_int8")
    emit({"phase": "moe_reference", "dtype": "int8", "steps": steps, "forward": forward})
    return {"moe_bf16": bf16["counts"], "moe_int8": int8["counts"]}


# --- slice 6: interleaved fine-tuning, precompute, randomized EVD, resume,
# and bench.py's MLP workload, through dwain.decompose --------------------


def causal_lm(cfg, dev):
    """A fresh model of ``cfg``: a PhiCausalLM of a PhiConfig, else a CausalLM."""
    return (models.PhiCausalLM if isinstance(cfg, models.PhiConfig) else models.CausalLM)(
        cfg, device=dev)


def artifact_round_trip(model, config, cfg, probe, dev, what: str) -> dict:
    """Write the artifact (decompose_config.json + decompose_state_dict.pt),
    reload it into a fresh model and require the probe's logits bit-equal:
    the same weights through the same kernels."""
    with torch.no_grad():
        y = model(probe)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        with open(tmp / "decompose_config.json", "w") as f:
            json.dump(config, f)
        utils.save_state_dict_pt(utils.state_dict(model), str(tmp / "decompose_state_dict.pt"))
        sd_bytes = (tmp / "decompose_state_dict.pt").stat().st_size
        with open(tmp / "decompose_config.json") as f:
            config2 = json.load(f)
        fresh = causal_lm(cfg, dev)
        utils.apply_decompose_config(fresh, config2)
        utils.load_state_dict(fresh, utils.load_state_dict_pt(str(tmp / "decompose_state_dict.pt")))
    with torch.no_grad():
        y_fresh = fresh(probe)
    return {"state_dict_bytes": sd_bytes, **logits_agree(y_fresh, y, 0.0, 0.0, what)}


class _FieldLog(logging.Handler):
    """Collects the named ``extra`` fields of the records that carry them."""

    def __init__(self, fields: tuple[str, ...]) -> None:
        super().__init__(logging.INFO)
        self.fields = fields
        self.records: list[dict] = []

    def emit(self, record: logging.LogRecord) -> None:
        if hasattr(record, self.fields[0]):
            self.records.append({f: getattr(record, f) for f in self.fields})


@contextlib.contextmanager
def logged_fields(logger_name: str, *fields: str):
    """The ``fields`` of what the named module logs in the block, one dict
    a record: ``decompose``'s pipelined eigh (per walk that precomputed,
    the worker's seconds in eigh jobs and the walk's seconds blocked on
    them), falor's eigh seconds per site."""
    log, handler = logging.getLogger(logger_name), _FieldLog(fields)
    level = log.level
    log.setLevel(logging.INFO)
    log.addHandler(handler)
    try:
        yield handler.records
    finally:
        log.removeHandler(handler)
        log.setLevel(level)


def pipelined_eigh_log():
    return logged_fields(decomposition.__name__, "eigh_job_s", "eigh_wait_s")


class TimedFinetune:
    """Wraps a ``finetune_fn``: its calls, seconds (synchronized) and the
    flash launches made inside it."""

    def __init__(self, fn) -> None:
        self.fn, self.calls, self.seconds, self.flash_launches = fn, 0, 0.0, 0

    def __call__(self, module, names):
        torch.cuda.synchronize()
        t0, before = time.perf_counter(), ops.flash_attention.launches
        out = self.fn(module, names)
        torch.cuda.synchronize()
        self.calls += 1
        self.seconds += time.perf_counter() - t0
        self.flash_launches += ops.flash_attention.launches - before
        return out


def ft_walk(dev, cfg, weights, seed: int, mode: str, **extra):
    """The 2-layer TinyLlama-width walk with interleaved ``mode`` fine-tuning
    (the last 8 decomposed pairs, 20 steps at lr 1e-4 on token batches from
    seed + 5); returns the model, config, wall seconds, the fine-tune's
    record and the pipelined eigh's record (required where it precomputes)."""
    model = utils.load_state_dict(models.CausalLM(cfg, device=dev), weights)
    ft = TimedFinetune(finetune.make_finetune_fn(
        mode, token_batches(cfg.vocab_size, seed + 5), models.ce_loss,
        num_last_modules_to_finetune=FT_LAST_N, num_steps=FT_STEPS, lr=FT_LR))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pipelined_eigh_log() as eighs:
        model, config = dwain.decompose(
            module=model,
            data_iterator=token_batches(cfg.vocab_size, seed + 1),
            metric_iterator=token_batches(cfg.vocab_size, seed + 2),
            loss_fn=models.ce_loss,
            finetune_fn=ft,
            device=dev,
            **DECOMPOSE_ARGS,
            **extra,
        )
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if extra.get("precomputing_covariance_num_splits") and len(eighs) != 1:
        raise AssertionError(f"ft_walk {mode}: {len(eighs)} pipelined eigh records, not 1")
    return model, config, wall, ft, eighs


def overlap(eighs) -> dict:
    job = sum(e["eigh_job_s"] for e in eighs)
    wait = sum(e["eigh_wait_s"] for e in eighs)
    return {"eigh_job_s": job, "eigh_wait_s": wait,
            "eigh_hidden_share": (job - wait) / job if job > 0 else None}


def decompose_ft(dev, cfg, weights, seed: int, probe) -> tuple:
    """Interleaved full fine-tuning, covariances precomputed in 2 splits, the
    randomized EVD; then the fused serve and the artifact round trip.
    Returns the decomposed model (pairs), its decompose names and the
    path's launch counts."""
    ops.reset_launch_counts()
    model, config, wall, ft, eighs = ft_walk(
        dev, cfg, weights, seed, "full",
        precomputing_covariance_num_splits=2, eigh_method="randomized")
    walk_counts = ops.launch_counts()
    if not config or ft.flash_launches <= 0:
        raise AssertionError(f"decompose_ft: decomposed {len(config)} sites, flash launches "
                             f"in the fine-tune {ft.flash_launches}")
    got = artifact_round_trip(model, config, cfg, probe, dev, "decompose_ft_artifact")
    with torch.no_grad():
        y_pairs = model(probe)
        pnn.fuse_factor_pairs(model)
        before = ops.lowrank_matmul.launches
        y_fused = model(probe)
        fused_launches = ops.lowrank_matmul.launches - before
        pnn.unfuse_factor_pairs(model)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require_launches(counts, ("syrk_gram", "flash_attention", "lowrank_matmul"), "decompose_ft")
    serve = logits_agree(y_fused, y_pairs, FUSED_MAX_ABS, FUSED_RMS_REL, "decompose_ft_serve")
    emit({"phase": "decompose_ft", "wall_s": wall, "finetune_s": ft.seconds,
          "finetune_calls": ft.calls, "finetune_flash_launches": ft.flash_launches,
          "decomposed": len(config),
          "proportions": {k: v["__meta__"]["proportion"] for k, v in config.items()},
          **overlap(eighs), "walk_launches": walk_counts, "launches": counts,
          "fused_lowrank_launches": fused_launches, "artifact": got, "serve": serve})
    return model, list(config), counts


def gradient_gate(g, ref, scale: float = 1.0, limits: dict | None = None) -> dict:
    """``scale * g`` against ``ref`` (f32): the largest difference relative
    to the largest |ref|, the RMS-relative difference and the gain error
    |<g, ref> / <ref, ref> - 1| (a bias that rounding noise averages
    out of); ``ok`` when each is within its limit (``limits``, by default
    ``finetune_grad``'s)."""
    if limits is None:
        limits = {"max_rel": GRAD_MAX_REL, "rms_rel": GRAD_RMS_REL, "gain_err": GRAD_GAIN_ERR}
    g, ref = scale * g.float(), ref.float()
    d = g - ref
    got = {"max_rel": float(d.abs().max() / ref.abs().max()),
           "rms_rel": float(d.square().mean().sqrt() / ref.square().mean().sqrt()),
           "gain_err": abs(float((g * ref).sum() / ref.square().sum()) - 1.0)}
    got["ok"] = all(got[k] <= v for k, v in limits.items())
    return got


def training_step(model, names, batch) -> tuple[float, dict]:
    """One ``finetune._run_training`` step on ``names`` (lr 0 at the first
    update, so nothing moves); returns its loss and each trained
    parameter's gradient."""
    grads, losses = {}, []
    params = dict(model.named_parameters())
    trained = [n for n in params if any(n.startswith(m + ".") for m in names)]
    handles = [params[n].register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().clone()))
               for n in trained]

    def loss_fn(b, y):
        loss = models.ce_loss(b, y)
        losses.append(loss.detach())
        return loss

    try:
        finetune._run_training(model, names, iter([batch]), loss_fn, engine.default_apply,
                               1, FT_LR, torch.Generator().manual_seed(0))
    finally:
        for h in handles:
            h.remove()
    return float(losses[0]), grads


def finetune_grad(model, names, cfg, seed: int) -> None:
    """One training step of the decomposed bf16 model (flash forward, the
    plain recomputed backward) against the same step of its f32 twin
    (plain attention): the loss and each trained factor's gradient gated;
    then a planted fault (the bf16 gradients scaled by 1.02) must fail the
    gate."""
    batch = utils.to_device(next(token_batches(cfg.vocab_size, seed + 6)), model.lm_head.weight.device)
    to_ft = names[-FT_LAST_N:]
    ops.reset_launch_counts()
    loss, grads = training_step(model, to_ft, batch)
    counts = ops.launch_counts()
    twin = f32_twin(model)
    loss32, grads32 = training_step(twin, to_ft, batch)
    del twin
    torch.cuda.empty_cache()
    if set(grads) != set(grads32) or not grads:
        raise AssertionError(f"finetune_grad: gradients of {sorted(grads)} vs {sorted(grads32)}")
    per = {n: gradient_gate(grads[n], grads32[n]) for n in sorted(grads)}
    planted = {n: gradient_gate(grads[n], grads32[n], 1.02) for n in sorted(grads)}
    worst = {k: max(r[k] for r in per.values()) for k in ("max_rel", "rms_rel", "gain_err")}
    rec = {"phase": "finetune_grad", "trained_factors": len(per), "loss_bf16": loss,
           "loss_f32": loss32, "loss_abs_diff": abs(loss - loss32), "limit_loss": LOSS_ABS_DIFF,
           "worst": worst, "limits": {"max_rel": GRAD_MAX_REL, "rms_rel": GRAD_RMS_REL,
                                      "gain_err": GRAD_GAIN_ERR},
           "planted_x1.02_caught": sum(not r["ok"] for r in planted.values()),
           "planted_worst_gain_err": max(r["gain_err"] for r in planted.values()),
           "launches": counts}
    ok = abs(loss - loss32) <= LOSS_ABS_DIFF and all(r["ok"] for r in per.values())
    emit({**rec, "ok": ok})
    require_launches(counts, ("flash_attention",), "finetune_grad")
    if not ok:
        raise AssertionError(f"finetune_grad: {rec} {per}")
    if not all(not r["ok"] for r in planted.values()):
        raise AssertionError(f"finetune_grad: the gate passed a gradient scaled by 1.02: {planted}")


def decompose_ft_lora(dev, cfg, weights, seed: int, probe) -> dict:
    """Interleaved LoRA fine-tuning with the exact eigh and a checkpoint
    directory; a second walk on a fresh model with that directory must
    replay every site, to an equal config and bit-equal logits.  Then a
    LoRA model's logits before and after ``merge_lora``."""
    with tempfile.TemporaryDirectory() as ckpt:
        ops.reset_launch_counts()
        model, config, wall, ft, _ = ft_walk(dev, cfg, weights, seed, "lora",
                                             eigh_method="exact", checkpoint_dir=ckpt)
        counts = ops.launch_counts()
        progress = (pathlib.Path(ckpt) / "progress.jsonl").read_text().splitlines()
        resumed, config2, wall2, ft2, _ = ft_walk(dev, cfg, weights, seed, "lora",
                                                  eigh_method="exact", checkpoint_dir=ckpt)
    if not config or ft.calls <= 0 or ft.flash_launches <= 0:
        raise AssertionError(f"decompose_ft_lora: {len(config)} sites, {ft.calls} fine-tunes")
    if config2 != config or ft2.calls:
        raise AssertionError("decompose_ft_lora: the resumed walk did not replay the first")
    with torch.no_grad():
        replay = logits_agree(resumed(probe), model(probe), 0.0, 0.0, "decompose_ft_lora_resume")
    del resumed
    require_launches(counts, ("syrk_gram", "flash_attention"), "decompose_ft_lora")

    # adapters with a non-zero B on every pair: unmerged against merged
    gen = torch.Generator().manual_seed(seed + 7)
    for name in config:
        for j in ("0", "1"):
            base = pnn.get_submodule(model, f"{name}.{j}")
            lora = finetune.LoRALinear.attach(gen, base, 16, 8.0, dropout=0.0)
            with torch.no_grad():
                lora.lora_b.copy_(torch.randn(lora.lora_b.shape, generator=gen))
                delta = lora.scale * (lora.lora_b @ lora.lora_a)
                rms = base.weight.float().square().mean().sqrt()
                lora.lora_b.mul_(LORA_DELTA_REL * rms / delta.square().mean().sqrt())
            pnn.replace_submodule(model, f"{name}.{j}", lora)
    model.eval()
    with torch.no_grad():
        y_lora = model(probe)
        finetune.merge_lora(model)
        y_merged = model(probe)
    merge = logits_agree(y_merged, y_lora, REF_MAX_ABS, REF_RMS_REL, "lora_merge")
    emit({"phase": "decompose_ft_lora", "wall_s": wall, "finetune_s": ft.seconds,
          "finetune_calls": ft.calls, "finetune_flash_launches": ft.flash_launches,
          "decomposed": len(config), "progress_lines": len(progress),
          "resume_wall_s": wall2, "resume": replay,
          "merge_vs_unmerged": merge, "launches": counts})
    return counts


def gaussian_batches(seed: int, dev):
    """bench.py's rank-64 Gaussian batches, made on the card from the seed:
    z (256, 64) @ P (64, 2048), P from seed 123."""
    proj = torch.randn(MLP_RANK, MLP_DIM, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(123))
    gen = torch.Generator(device=dev).manual_seed(seed)
    while True:
        yield {"inp": torch.randn(MLP_BATCH, MLP_RANK, device=dev, generator=gen) @ proj}


def dwain_mlp(dev, seed: int) -> dict[str, int]:
    """bench.py:99-130's workload through the port: the 4-layer d 2048 f32
    MLP in the modes precompute (1 split, randomized), serial (randomized)
    and serial-exact-f64, rank 32 required at every site; then its pairs
    fused and served one batch through the low-rank kernel's f32 path.  The
    walks launch no kernel: the model is f32 and the SYRK rule wants bf16,
    as the JAX package's does."""
    modes = {"precompute": dict(precomputing_covariance_num_splits=1, eigh_method="randomized"),
             "serial": dict(eigh_method="randomized"), "serial-exact-f64": {}}
    ops.reset_launch_counts()
    rec, model = {}, None
    for mode, extra in modes.items():
        model = models.make_mlp(MLP_DIM, MLP_DEPTH, 16, device=dev,
                                generator=torch.Generator(device=dev).manual_seed(seed))
        it = gaussian_batches(seed + 1, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pipelined_eigh_log() as eighs:
            model, config = dwain.decompose(
                module=model, data_iterator=it, metric_iterator=it,
                loss_fn=lambda b, out: 0.01 * torch.mean(torch.square(out)),
                num_data_steps=8, num_metric_steps=2, nsr_final_threshold=0.5, min_rank=32,
                trade_off_factor=1000.0, reduction_factor=0.5, max_accepted_ppl_diff=1.0,
                decompose_in_float64=True, blacklisted_module_names=["head"], device=dev,
                **extra)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        proportions = {k: v["__meta__"]["proportion"] for k, v in config.items()}
        if len(eighs) != ("precomputing_covariance_num_splits" in extra):
            raise AssertionError(f"dwain_mlp {mode}: {len(eighs)} pipelined eigh records")
        rec[mode] = {"wall_s": wall, "proportions": proportions,
                     **(overlap(eighs) if eighs else {})}
        if len(config) != MLP_DEPTH or any(p != 32 / MLP_DIM for p in proportions.values()):
            emit({"phase": "dwain_mlp", "mode": mode, **rec[mode], "ok": False})
            raise AssertionError(f"dwain_mlp {mode}: expected rank 32 at every site: {proportions}")
    batch = next(gaussian_batches(seed + 2, dev))
    walk_counts = ops.launch_counts()
    with torch.no_grad():
        y_pairs = model(batch)
        pnn.fuse_factor_pairs(model)
        y_fused = model(batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # f32 both ways (cuBLAS without TF32, the kernel's f32 path): sums in
    # another order, four layers deep
    served = logits_agree(y_fused, y_pairs, MLP_SERVE_MAX_ABS, MLP_SERVE_RMS_REL,
                          "dwain_mlp_serve")
    if any(walk_counts.values()) or counts["lowrank_matmul"] != MLP_DEPTH:
        raise AssertionError(f"dwain_mlp: walk launches {walk_counts}, with the serve {counts}")
    # served-forward latency, fused and unfused, after the counts are read
    with torch.no_grad():
        fused_ms = time_ms(lambda: model(batch))
        pnn.unfuse_factor_pairs(model)
        pairs_ms = time_ms(lambda: model(batch))
        pnn.fuse_factor_pairs(model)
    emit({"phase": "dwain_mlp", "dim": MLP_DIM, "depth": MLP_DEPTH, "batch": MLP_BATCH,
          "modes": rec, "serve": served, "serve_fused_ms": fused_ms, "serve_pairs_ms": pairs_ms,
          "walk_launches": walk_counts, "launches": counts,
          "note": "f32 model: the walks launch no kernel (SYRK takes bf16); the fused pairs "
                  "take the low-rank kernel's f32 path"})
    return counts


# --- slice 7: falor and lockd on a full-width ResNet-50 ------------------


def planted_resnet50(seed: int, dev) -> torch.nn.Module:
    """ResNet-50 (torchvision topology, 1000 classes), bf16, channels_last,
    in eval mode.  Every 1x1 conv and the fc are ``A @ B / sqrt(r * d_in)``
    plus 1% noise at r = full_rank // 4, drawn from a numpy seed, so that
    falor's decisions are known in advance; the 3x3 convs and the stem keep
    the seeded uniform init.  BatchNorm's running statistics are then set
    to each layer's own input statistics over two calibration batches (one
    f32 forward in train mode, cumulative averages): every BatchNorm output
    is about zero-mean and unit-variance, so the activations of 16
    residual blocks and the logits stay finite in bf16.  The last
    BatchNorm of each residual branch scales by ``RN_BRANCH_GAMMA`` (as
    zero-init-residual training starts its branches at 0): an untrained
    BatchNorm ResNet amplifies a perturbation exponentially with depth,
    and at scale 1 one bf16 rounding of an early 1x1 weight moved the
    logits by an NSR of 0.2, over falor's threshold at every rank."""
    model = models.resnet50(device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    f32 = np.float32
    with torch.no_grad():
        for name in engine.get_decomposeable_submodule_names(model):
            w = pnn.get_submodule(model, name).weight
            d_out, d_in = w.shape[:2]
            r = min(d_in, d_out) // 4
            a = rng.standard_normal((d_out, r), dtype=f32)
            b = rng.standard_normal((r, d_in), dtype=f32)
            planted = (a @ b) / np.sqrt(r * d_in, dtype=f32)
            planted += 0.01 * rng.standard_normal((d_out, d_in), dtype=f32) / np.sqrt(d_in, dtype=f32)
            w.copy_(torch.from_numpy(planted).reshape(w.shape))
        bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
        for m in bns:
            m.reset_running_stats()
            m.momentum = None  # cumulative average over the calibration batches
        model.train()
        for x in image_batches(seed + 20, 2, RN_BATCH, dev, torch.float32):
            model(x)
        for m in bns:
            m.momentum = 0.1
        for m in model.modules():
            if isinstance(m, models.resnet.Bottleneck):
                m.bn3.weight.fill_(RN_BRANCH_GAMMA)
    return model.eval().to(torch.bfloat16, memory_format=torch.channels_last)


def image_batches(seed: int, n: int, batch: int, dev, dtype=torch.bfloat16) -> list[torch.Tensor]:
    """``n`` batches of standard-normal images (normalized ImageNet's scale),
    (batch, 3, 224, 224), drawn from a numpy seed, channels_last on the card."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((batch, 3, RN_HW, RN_HW), dtype=np.float32))
            .to(dev).to(dtype, memory_format=torch.channels_last) for _ in range(n)]


def cycle(pool):
    while True:
        yield from pool


def resnet_round_trip(model, config, probe, dev, what: str) -> dict:
    """The ResNet-50 artifact written, reloaded into a fresh bf16
    channels_last model and held bit-equal on the probe's logits."""
    with torch.no_grad():
        y = model(probe)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "decompose_config.json").write_text(json.dumps(config))
        utils.save_state_dict_pt(utils.state_dict(model), str(tmp / "decompose_state_dict.pt"))
        sd_bytes = (tmp / "decompose_state_dict.pt").stat().st_size
        fresh = models.resnet50(device=dev).to(torch.bfloat16, memory_format=torch.channels_last)
        utils.apply_decompose_config(fresh, json.loads((tmp / "decompose_config.json").read_text()))
        utils.load_state_dict(fresh, utils.load_state_dict_pt(str(tmp / "decompose_state_dict.pt")))
    fresh = fresh.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        y_fresh = fresh(probe)
    return {"state_dict_bytes": sd_bytes, **logits_agree(y_fresh, y, 0.0, 0.0, what)}


def resnet_fused_serve(model, probe, what: str, max_abs: float = RN_FUSED_MAX_ABS,
                       rms_rel: float = RN_FUSED_RMS_REL) -> tuple[dict, dict[str, int]]:
    """The decomposed model (ResNet-50, or a slice-11 vision model) with its
    plain pairs fused against its pairs: logits gated, the fused forward's
    launches (one for each fused pair) and the inputs it had to copy into
    rows (none for channels_last), and both forwards timed.  Returns the
    record and the fused forward's launch counts."""
    with torch.no_grad():
        y_pairs = model(probe)
        pairs_ms = time_ms(lambda: model(probe), reps=10)
        pnn.fuse_factor_pairs(model)
        fused = sum(isinstance(m, pnn.FusedLowRankLinear) for m in model.modules())
        ops.reset_launch_counts()
        y_fused = model(probe)
        torch.cuda.synchronize()
        counts, copies = ops.launch_counts(), ops.lowrank_matmul.input_copies
        fused_ms = time_ms(lambda: model(probe), reps=10)
        pnn.unfuse_factor_pairs(model)
    if counts["lowrank_matmul"] != fused or fused <= 0 or copies:
        raise AssertionError(f"{what}: {fused} fused pairs, launches {counts}, "
                             f"{copies} input copies")
    return {"fused_pairs": counts["lowrank_matmul"], "input_copies": copies,
            "fused_ms": fused_ms, "pairs_ms": pairs_ms,
            **logits_agree(y_fused, y_pairs, max_abs, rms_rel, what)}, counts


def falor_resnet50(dev, seed: int, use_mean: bool) -> dict[str, int]:
    """``falor.decompose`` of the planted ResNet-50 with the falor yaml's
    hyperparameters on batches of 64 images: every planted site must be
    decomposed at proportion <= 0.5 (each is accepted at full_rank // 4 or
    below), the Grams must take SYRK; then the artifact round trip and the
    fused serve.  Mean-centred, the fc is exempt and its decision is
    reported: the untrained net's logits barely vary across images (the
    record's ``logits_var_to_mean_sq``), so the NSR, normalized by that
    variance, magnifies the loss of the logits' mean, whose direction a
    mean-centred Gram drops.  Returns the path's launch counts."""
    what = "falor_resnet50" + ("_mean" if use_mean else "")
    model = planted_resnet50(seed, dev)
    sites = engine.get_decomposeable_submodule_names(model)
    required = [s for s in sites if not (use_mean and s == "fc")]
    params_before = utils.get_num_params(model)
    pool = image_batches(seed + 21, RN_POOL, RN_BATCH, dev)
    probe = image_batches(seed + 22, 1, RN_BATCH, dev)[0]
    with torch.no_grad():
        y = model(probe).float()
    var_to_mean_sq = float(y.var(dim=0).mean() / y.mean(dim=0).square().mean())
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with logged_fields(falor_decomposition.__name__, "falor_site", "eigh_s") as logged:
        model, config = falor.decompose(module=model, data_iterator=cycle(pool), use_mean=use_mean,
                                        device=dev, **FALOR_ARGS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eighs = {r["falor_site"]: r["eigh_s"] for r in logged}
    walk_counts = ops.launch_counts()
    proportions = {k: v["__meta__"]["proportion"] for k, v in config.items()}
    rec = {"phase": what, "use_mean": use_mean, "batch": RN_BATCH, "wall_s": wall,
           "eigh_s": sum(eighs.values()), "eigh_s_by_site": eighs, "sites": len(sites),
           "required": len(required), "decomposed": len(config), "proportions": proportions,
           "logits_var_to_mean_sq": var_to_mean_sq,
           "params_before": params_before, "params_after": utils.get_num_params(model),
           "walk_launches": walk_counts}
    if not set(required) <= set(config) or any(p > 0.5 for p in proportions.values()):
        emit({**rec, "ok": False})
        raise AssertionError(f"{what}: planted sites not all decomposed at <= 0.5")
    require_launches(walk_counts, ("syrk_gram",), what)
    rec["artifact"] = resnet_round_trip(model, config, probe, dev, what + "_artifact")
    rec["serve"], serve_counts = resnet_fused_serve(model, probe, what + "_serve")
    counts = {k: walk_counts[k] + serve_counts[k] for k in walk_counts}
    require_launches(counts, ("syrk_gram", "lowrank_matmul"), what)
    emit({**rec, "launches": counts})
    del model, pool
    torch.cuda.empty_cache()
    return counts


def lockd_gate_gradients(model, x, seed: int, precision) -> tuple[float, dict]:
    """One gate-training step of ``model`` (a copy, trained in place) on x:
    its loss and each trained parameter's gradient before clipping."""
    params = dict(lockd.trainable_partition(model))
    grads = {}
    handles = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().float().clone()))
               for n, p in params.items()]
    update = lockd_train._make_update(
        model, lockd_train.get_optimizer(params.values(), "AdamW", LOCKD_LR), LOCKD_LMBDA,
        LOCKD_NSR, precision=precision, clip_norm=LOCKD_CLIP)
    try:
        loss, _ = update(x, lockd.Ctx(lockd.make_generators(model, seed)))
    finally:
        for h in handles:
            h.remove()
    return float(loss), grads


def lockd_grad_check(model, x, seed: int) -> dict:
    """One bf16 gate-training step against its f32 twin's on the same
    images and Gumbel noise: the loss and each trained parameter's gradient
    gated on max, RMS-relative and gain error; the bf16 gradients scaled by
    1.02 must fail the gate."""
    loss, grads = lockd_gate_gradients(copy.deepcopy(model), x, seed, "bf16")
    twin = copy.deepcopy(model).float()
    loss32, grads32 = lockd_gate_gradients(twin, x.float(), seed, None)
    del twin
    torch.cuda.empty_cache()
    if set(grads) != set(grads32) or not grads:
        raise AssertionError(f"lockd_grad: gradients of {len(grads)} vs {len(grads32)} tensors")
    per = {n: gradient_gate(grads[n], grads32[n], limits=LOCKD_GRAD_LIMITS) for n in grads}
    planted = {n: gradient_gate(grads[n], grads32[n], 1.02, limits=LOCKD_GRAD_LIMITS)
               for n in grads}
    worst = {k: max(r[k] for r in per.values()) for k in ("max_rel", "rms_rel", "gain_err")}
    worst_at = {k: max(per, key=lambda n: per[n][k]) for k in worst}
    rec = {"trained_tensors": len(per), "batch": int(x.shape[0]), "loss_bf16": loss,
           "loss_f32": loss32, "loss_rel_diff": abs(loss - loss32) / abs(loss32),
           "limit_loss_rel": LOCKD_LOSS_REL, "worst": worst, "worst_at": worst_at,
           "limits": LOCKD_GRAD_LIMITS,
           "planted_x1.02_caught": sum(not r["ok"] for r in planted.values())}
    ok = rec["loss_rel_diff"] <= LOCKD_LOSS_REL and all(r["ok"] for r in per.values())
    if not ok:
        emit({"phase": "lockd_grad", **rec, "ok": False})
        raise AssertionError(f"lockd_grad: {rec}")
    if any(r["ok"] for r in planted.values()):
        emit({"phase": "lockd_grad", **rec, "ok": False})
        raise AssertionError("lockd_grad: the gate passed a gradient scaled by 1.02")
    return rec


def lockd_resnet50(dev, seed: int) -> dict[str, int]:
    """lockd on the planted ResNet-50: wrap its 54 layers, hold one bf16
    step against its f32 twin, train the gates for ``LOCKD_STEPS`` steps at
    batch 256 with the lockd yaml's loss, optimizer and clipping (the loss
    finite, the proportion loss falling), decompose (gates open at logit 3,
    so the layers revert), then decompose a copy whose gates close half of
    each layer's channels: every layer decomposed, the artifact round trip,
    the fused serve.  Returns the path's launch counts."""
    model = planted_resnet50(seed, dev)
    lockd.wrap(model, seed=seed)
    model.to(memory_format=torch.channels_last)
    n_wrapped = len(list(lockd.named_wrapped_modules(model)))
    if n_wrapped != 54:
        raise AssertionError(f"lockd_resnet50: {n_wrapped} wrapped layers, not 54")
    grad = lockd_grad_check(model, image_batches(seed + 23, 1, RN_BATCH, dev)[0], seed)

    ops.reset_launch_counts()
    params = [p for _, p in lockd.trainable_partition(model)]
    update = lockd_train._make_update(
        model, lockd_train.get_optimizer(params, "AdamW", LOCKD_LR), LOCKD_LMBDA, LOCKD_NSR,
        precision="bf16", clip_norm=LOCKD_CLIP)
    pool = image_batches(seed + 24, LOCKD_POOL, LOCKD_BATCH, dev)
    gens = lockd.make_generators(model, seed)
    losses, proportions = [], []
    # the proportion loss of the f32 master logits: the bf16 value the step
    # sees moves in steps of 2^-8 near 0.95
    with torch.no_grad():
        proportion_start = float(lockd.get_proportion_loss(model))
    update(pool[0], lockd.Ctx(gens))  # warm-up step (cuDNN plans, the allocator)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(LOCKD_STEPS):
        loss, (nsr_loss, proportion, _) = update(pool[(i + 1) % LOCKD_POOL], lockd.Ctx(gens))
        losses.append(loss)
        proportions.append(proportion)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / LOCKD_STEPS
    train_counts = ops.launch_counts()
    losses = [float(v) for v in losses]
    with torch.no_grad():
        proportion_end = float(lockd.get_proportion_loss(model))
    rec = {"phase": "lockd_resnet50", "wrapped": n_wrapped, "batch": LOCKD_BATCH,
           "steps": LOCKD_STEPS + 1, "step_ms": step_ms,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "loss_first_last": [losses[0], losses[-1]],
           "proportion_loss_bf16_first_last": [float(proportions[0]), float(proportions[-1])],
           "proportion_loss_f32_start_end": [proportion_start, proportion_end],
           "grad_check": grad}
    if not all(math.isfinite(v) for v in losses) or proportion_end >= proportion_start:
        emit({**rec, "ok": False})
        raise AssertionError("lockd_resnet50: the loss is not finite or the proportion "
                             "loss did not fall")
    del pool
    torch.cuda.empty_cache()

    planted = copy.deepcopy(model)
    _, trained_config = lockd.decompose(model, LOCKD_PROPORTION_THRESHOLD)
    rec["trained_decomposed"] = len(trained_config)
    del model
    for _, m in lockd.named_wrapped_modules(planted):
        with torch.no_grad():
            m.logits[1::2] = -3.0
    planted, config = lockd.decompose(planted, LOCKD_PROPORTION_THRESHOLD)
    if len(config) != n_wrapped:
        emit({**rec, "planted_decomposed": len(config), "ok": False})
        raise AssertionError(f"lockd_resnet50: {len(config)} of {n_wrapped} planted layers "
                             "decomposed")
    planted = planted.to(torch.bfloat16, memory_format=torch.channels_last).eval()
    probe = image_batches(seed + 22, 1, RN_BATCH, dev)[0]
    rec["planted_decomposed"] = len(config)
    rec["artifact"] = resnet_round_trip(planted, config, probe, dev, "lockd_resnet50_artifact")
    rec["serve"], serve_counts = resnet_fused_serve(planted, probe, "lockd_resnet50_serve")
    counts = {k: train_counts[k] + serve_counts[k] for k in train_counts}
    require_launches(counts, ("lowrank_matmul",), "lockd_resnet50")
    emit({**rec, "launches": counts})
    del planted
    torch.cuda.empty_cache()
    return counts


def resnet_kernel_checks(dev, recs: dict[str, list[dict]]) -> None:
    """SYRK and the low-rank kernel at ResNet-50's shapes (batch 64 at
    224 x 224): falor's conv-site Grams of d >= 512 (layer2's 28 x 28,
    layer3's 14 x 14 and layer4's 7 x 7 pixels, and layer2's strided
    downsample, whose Gram takes its input's 56 x 56 pixels), with the
    product that materializes y beside; and the fused pairs of the planted
    decomposition (rank full_rank // 4) at layer1's 200704 rows, layer3,
    layer4 and the fc."""
    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    for n, d_in, d, what in ((50176, 128, 512, "layer2 conv3"), (12544, 256, 1024, "layer3 conv3"),
                             (3136, 512, 2048, "layer4 conv3"),
                             (200704, 256, 512, "layer2.0 downsample")):
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        w = (torch.randn(d, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf)
        y = x @ w.t()
        recs["syrk_gram"].append(check_kernel(
            "syrk_gram",
            lambda: ops.syrk_gram(y),
            lambda: ops.syrk_gram_plain(y),
            lambda: y.t() @ y,
            flops=n * d * d,
            nbytes=n * d * 2 + d * d * 4,
            tol_fn=lambda ref: torch.full_like(ref, 1e-4 * float(ref.abs().max())),
            shape={"what": what, "N": n, "d": d, "dtype": "bf16"},
            graph=True, extra_fns={"y_matmul": lambda: x @ w.t()},
        ))
        del x, w, y
        torch.cuda.empty_cache()
    for n, d_in, r, d_out, with_bias, what in (
            (200704, 256, 16, 64, False, "layer1 conv1"), (200704, 64, 16, 256, False, "layer1 conv3"),
            (12544, 256, 64, 1024, False, "layer3 conv3"), (3136, 2048, 128, 512, False, "layer4 conv1"),
            (RN_BATCH, 2048, 250, 1000, True, "fc")):
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        bias = torch.randn(d_out, device=dev, generator=g).to(bf) if with_bias else None
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(bf).t()
        recs["lowrank_matmul"].append(check_kernel(
            "lowrank_matmul",
            lambda: ops.lowrank_matmul(x, k1, k2, bias),
            lambda: ops.lowrank_matmul_plain(x, k1, k2, bias),
            lambda: (x @ k1) @ k2 if bias is None else torch.addmm(bias, x @ k1, k2),
            flops=2 * n * r * (d_in + d_out),
            nbytes=2 * (n * d_in + r * d_in + r * d_out + d_out * with_bias + n * d_out),
            tol_fn=lambda ref: 2.0 ** -6 * (ref.abs() + ref.square().mean().sqrt()),
            shape={"what": what, "n": n, "d_in": d_in, "r": r, "d_out": d_out,
                   "bias": with_bias, "dtype": "bf16"},
            graph=True,
        ))
        del x, k1, k2, bias
        torch.cuda.empty_cache()


def trainer_inputs(cfg: models.TransformerConfig, seed: int, root: pathlib.Path, dev) -> tuple:
    """A local HF snapshot (TinyLlama's config.json at 2 layers, bf16, and a
    pytorch_model.bin of ``planted_rank_weights``, drawn on ``dev``) and a
    JSONL of the repository's prose, one paragraph a record."""
    snap = root / "snapshot"
    snap.mkdir()
    hf = dict(model_type="llama", architectures=["LlamaForCausalLM"], vocab_size=cfg.vocab_size,
              hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
              num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
              num_key_value_heads=cfg.n_kv_heads, rms_norm_eps=1e-5, rope_theta=10000.0,
              hidden_act="silu", max_position_embeddings=2048, tie_word_embeddings=False,
              torch_dtype="bfloat16")
    (snap / "config.json").write_text(json.dumps(hf, indent=2))
    sd = {k: v.to(torch.bfloat16).cpu() for k, v in planted_rank_weights(cfg, seed, dev).items()}
    torch.save(sd, snap / "pytorch_model.bin")
    here = pathlib.Path(__file__).resolve().parent
    paths = sorted({p for pattern in TRAINER_PROSE for p in here.glob(pattern)})
    paragraphs = [p.strip() for path in paths for p in path.read_text().split("\n\n") if p.strip()]
    data = root / "prose.jsonl"
    data.write_text("".join(json.dumps({"text": p}) + "\n" for p in paragraphs))
    return snap, data, sum(len(p.encode()) for p in paragraphs)


def trainer_decompose_config(snap: pathlib.Path, data: pathlib.Path) -> dict:
    """decompose_dwain_tinyllama.yaml's values, pointed at the snapshot and
    the prose, with the step cuts."""
    return dict(
        task="decompose_dwain",
        decomposed_model_name=TRAINER_SNAPSHOT_NAME,
        decomposed_model_checkpoint_path=str(snap),
        decomposed_model_dtype="bfloat16",
        decomposition_data_name=str(data),
        decomposition_data_separator="\n\n",
        decomposition_data_max_length=2048,
        decomposition_data_batch_size=1,
        perplexity_data_name=str(data),
        perplexity_data_separator="",
        perplexity_data_max_length=2048,
        perplexity_data_batch_size=1,
        num_data_steps=32,
        num_metric_steps=8,
        trade_off_factor=0.5,
        reduction_factor=0.5,
        max_accepted_ppl_diff=0.1,
        nsr_final_threshold=0.1,
        min_rank=32,
        decompose_in_float64=True,
        precomputing_covariance_num_splits=8,
        blacklisted_modules=["lm_head"],
        finetuning_run=True,
        finetuning_use_lora=True,
        finetuning_lora_min_rank=32,
        finetuning_lr=0.0001,
        finetuning_num_steps=50,
        finetuning_num_last_finetuned_modules=8,
        finetuning_use_rank_pattern=False,
        lm_eval_initial=True,
        lm_eval_tasks=["doc_lambada", "doc_continuation"],
        mesh_dp=None,
        mesh_tp=1,
    )


def trainer_finetune_config(snap: pathlib.Path, data: pathlib.Path, artifact: pathlib.Path) -> dict:
    """finetune_tinyllama.yaml's values on the decompose task's artifact,
    with the sample, eval and warmup cuts."""
    return dict(
        task="finetune",
        decomposed_model_name=TRAINER_SNAPSHOT_NAME,
        decomposed_model_checkpoint_path=str(snap),
        decomposed_model_dtype="bfloat16",
        decompose_config=str(artifact / "decompose_config.json"),
        decompose_state_dict=str(artifact / "decompose_state_dict.pt"),
        perplexity_data_name=str(data),
        perplexity_data_separator="",
        perplexity_data_max_length=2048,
        perplexity_data_batch_size=1,
        train_data_name=str(data),
        train_data_separator="\n\n",
        train_data_max_length=2048,
        train_data_batch_size=2,
        train_data_n_samples=64,
        test_data_name=str(data),
        test_data_separator="\n\n",
        test_data_max_length=2048,
        test_data_batch_size=2,
        test_data_n_samples=16,
        num_train_epochs=1,
        eval_steps=8,
        logging_steps=10,
        early_stopping_patience=3,
        learning_rate=0.0001,
        weight_decay=0.0,
        lr_scheduler_type="cosine_with_warmup",
        num_warmup_steps=4,
        lora_r=16,
        lora_alpha=8,
        lora_dropout=0.05,
        lm_eval_initial=False,
    )


class _PlainAttentionTimer:
    """Wraps the model's plain attention: CUDA events around each call on
    the current stream (no synchronization), summed at the end."""

    def __init__(self, fn) -> None:
        self.fn, self.events = fn, []

    def __call__(self, *args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*args, **kwargs)
        end.record()
        self.events.append((start, end))
        return out

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events) / 1e3


@contextlib.contextmanager
def walk_breakdown():
    """The trainer walk's plain-attention forwards (device seconds, calls)
    and its fine-tuning calls (``TimedFinetune``), instrumented for the
    block: the llama-family and phi models' plain attention and
    ``finetune.make_finetune_fn`` are wrapped, and put back after."""
    timer = _PlainAttentionTimer(models.transformer.causal_attention_plain)
    made: list[TimedFinetune] = []
    make = finetune.make_finetune_fn

    def timed_make(*args, **kwargs):
        made.append(TimedFinetune(make(*args, **kwargs)))
        return made[-1]

    models.transformer.causal_attention_plain = models.phi.causal_attention_plain = timer
    finetune.make_finetune_fn = timed_make
    try:
        yield timer, made
    finally:
        models.transformer.causal_attention_plain = models.phi.causal_attention_plain = timer.fn
        finetune.make_finetune_fn = make


def trainer_artifact_reload(run_cfg: dict, config: pathlib.Path, sd: pathlib.Path, dev):
    """An artifact onto a fresh model built, as the run built its own, from
    the snapshot by the trainer's builder."""
    model, tok = trainer_builder.make_model_and_tokenizer(
        model_name=run_cfg["decomposed_model_name"], dtype=run_cfg["decomposed_model_dtype"],
        checkpoint_path=run_cfg["decomposed_model_checkpoint_path"], device=dev)
    trainer_builder.apply_decompose_config_and_state_dict(model, str(config), str(sd))
    return model, tok


@contextlib.contextmanager
def restored_logging():
    """The CLI configures the root logger (``run.setup_logging``); put it
    back after, so the later phases print only their JSON lines."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    try:
        yield
    finally:
        for h in root.handlers[:]:
            if h not in handlers:
                root.removeHandler(h)
        root.setLevel(level)


def trainer_llm_decompose(dev, cfg, seed: int, root: pathlib.Path) -> tuple:
    """``python -m ptdeco_tpu_torch.apps.trainer_llm.run`` (in process) on
    the decompose_dwain config: every summary number finite, parameters
    cut, SYRK launched; the artifact reloads onto two fresh models from
    the snapshot to identical state dicts, equal to the saved one (and to
    the .safetensors where that package is installed)."""
    snap, data, prose_bytes = trainer_inputs(cfg, seed, root, dev)
    cfg_path, out = root / "decompose.json", root / "decompose_out"
    run_cfg = trainer_decompose_config(snap, data)
    cfg_path.write_text(json.dumps(run_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with walk_breakdown() as (attention, fts), pipelined_eigh_log() as eighs:
        rc = trainer_run.main(["--config", str(cfg_path), "--output-path", str(out)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summary = json.loads((out / "summary.json").read_text())
    config = json.loads((out / "decompose_config.json").read_text())
    numbers = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
    if rc != 0 or not all(math.isfinite(v) for v in numbers.values()) \
            or not summary["mparams_frac"] < 100.0 or not config:
        raise AssertionError(f"trainer_llm_decompose: rc {rc}, summary {summary}")
    require_launches(counts, ("syrk_gram",), "trainer_llm_decompose")

    saved = utils.load_state_dict_pt(str(out / "decompose_state_dict.pt"))
    reloads = [utils.state_dict(trainer_artifact_reload(
        run_cfg, out / "decompose_config.json", out / "decompose_state_dict.pt", dev)[0])
        for _ in range(2)]
    for sd in reloads:
        if sd.keys() != saved.keys() or not all(torch.equal(sd[k], saved[k]) for k in saved):
            raise AssertionError("trainer_llm_decompose: the artifact did not reload bit-equal")
    safetensors = out / "decompose_state_dict.safetensors"
    if safetensors.exists():
        st = utils.load_state_dict_safetensors(str(safetensors))
        if st.keys() != saved.keys() or not all(torch.equal(st[k], saved[k]) for k in saved):
            raise AssertionError("trainer_llm_decompose: .pt and .safetensors differ")
    del reloads
    ft_s = sum(f.seconds for f in fts)
    attention_s = attention.seconds()
    emit({"phase": "trainer_llm_decompose", "wall_s": wall,
          "time_decomposition": summary["time_decomposition"],
          "ppl_initial": summary["ppl_initial"], "ppl_final": summary["ppl_final"],
          "mparams_frac": summary["mparams_frac"], "gflops_frac": summary["gflops_frac"],
          "gflops_initial": summary["gflops_initial"],
          "lm_eval_initial": summary["lm_eval_initial"], "lm_eval_final": summary["lm_eval_final"],
          "device": summary["device"], "prose_bytes": prose_bytes,
          "decomposed": len(config), "ranks": {k: v["modules"]["0"]["out_features"]
                                               for k, v in config.items()},
          "finetune_s": ft_s, "finetune_calls": sum(f.calls for f in fts),
          "finetune_share": ft_s / summary["time_decomposition"],
          **overlap(eighs),
          "plain_attention_s": attention_s, "plain_attention_calls": len(attention.events),
          "plain_attention_share_of_wall": attention_s / wall,
          "peak_memory_gb": peak / 1e9, "safetensors": safetensors.exists(),
          "launches": counts, "nvidia_smi": nvidia_smi()})
    return snap, data, out, counts


def trainer_llm_finetune(dev, seed: int, root: pathlib.Path, snap, data, artifact) -> dict:
    """The finetune task on the decompose task's artifact: finite losses,
    the last logged train loss below the first, the fine-tuned state dict
    reloads; then that model served with its pairs fused (gated against the
    pairs) and through ``serving.generate`` from a prompt of the corpus,
    launching the low-rank and flash kernels."""
    cfg_path, out = root / "finetune.json", root / "finetune_out"
    run_cfg = trainer_finetune_config(snap, data, artifact)
    cfg_path.write_text(json.dumps(run_cfg))
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with logged_fields(trainer_finetune.__name__, "train_step", "train_loss", "train_lr") as steps, \
            logged_fields(trainer_finetune.__name__, "eval_loss", "eval_s") as evals:
        rc = trainer_run.main(["--config", str(cfg_path), "--output-path", str(out)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = json.loads((out / "summary.json").read_text())
    losses = [r["train_loss"] for r in steps]
    eval_losses = [e["eval_loss"] for e in evals]
    # training progress is read on fixed rows: the best eval loss below the
    # first, the perplexity after below the one before (one logged train
    # loss is one batch: their spread, +-0.2 on an H100 at seed 0, is more
    # than the ~27 steps at lr 1e-4 move the loss)
    if rc != 0 or len(losses) < 2 or not all(math.isfinite(x) for x in losses + eval_losses) \
            or not min(eval_losses) < eval_losses[0] \
            or not summary["ppl_after"] < summary["ppl_before"]:
        raise AssertionError(f"trainer_llm_finetune: rc {rc}, logged losses {steps}, evals {evals}, "
                             f"summary {summary}")
    train_s = summary["time_finetuning"] - sum(e["eval_s"] for e in evals)
    step_s = train_s / max(summary["steps"], 1)

    model, tok = trainer_artifact_reload(
        run_cfg, artifact / "decompose_config.json", out / "finetuned_state_dict.pt", dev)
    if not isinstance(tok, trainer_builder.ByteTokenizer):
        raise AssertionError(f"trainer_llm_finetune: the trainer built {type(tok)}, not its byte tokenizer")
    model.eval()
    text = "\n\n".join(json.loads(line)["text"] for line in data.read_text().splitlines()[:60])
    probe = {"input_ids": torch.tensor(tok(text)["input_ids"][:SEQ], device=dev)[None]}
    with torch.no_grad():
        y_pairs = model(probe)
        pnn.fuse_factor_pairs(model)
        y_fused = model(probe)
    serve = logits_agree(y_fused, y_pairs, TRAINER_MAX_ABS, TRAINER_RMS_REL, "trainer_llm_serve")
    prompt = probe["input_ids"][:, :TRAINER_PROMPT]
    gen = cached_generate(model, prompt, TRAINER_NEW, "trainer_llm_generate", TRAINER_MAX_ABS,
                          TRAINER_RMS_REL)
    counts = ops.launch_counts()
    require_launches(counts, ("lowrank_matmul", "flash_attention"), "trainer_llm_finetune")
    emit({"phase": "trainer_llm_finetune", "wall_s": wall, "steps": summary["steps"],
          "step_ms": step_s * 1e3,
          "tokens_per_s": run_cfg["train_data_batch_size"] * run_cfg["train_data_max_length"] / step_s,
          "evals": len(evals),
          "loss_first": {"step": steps[0]["train_step"], "loss": losses[0]},
          "loss_last": {"step": steps[-1]["train_step"], "loss": losses[-1]},
          "eval_losses": eval_losses,
          "ppl_before": summary["ppl_before"], "ppl_after": summary["ppl_after"],
          "device": summary["device"], "fused_vs_pairs": serve,
          "generate": {"prompt": TRAINER_PROMPT, "new_tokens": TRAINER_NEW,
                       "text": tok.decode(gen["tokens"][0].tolist()), **gen["gate"]},
          "launches": counts, "nvidia_smi": nvidia_smi()})
    return counts


# --- slice 9: the rest of cached serving -----------------------------------

SUMMARY_KEYS = {"n_prompts", "max_new_tokens", "total_new_tokens", "num_beams",
                "generate_wall_s", "tokens_per_s", "decomposed", "device"}


def generation_prompts(data: pathlib.Path, seed: int) -> list[str]:
    """``GEN_PROMPTS`` prompts cut from the prose's paragraphs, each to a
    length drawn from ``GEN_PROMPT_BYTES`` (a cut inside a UTF-8 character
    drops its bytes)."""
    rng = np.random.default_rng(seed + 20)
    paragraphs = [json.loads(line)["text"] for line in data.read_text().splitlines()]
    usable = [p for p in paragraphs if len(p.encode()) >= GEN_PROMPT_BYTES[0]]
    picks = rng.choice(len(usable), GEN_PROMPTS, replace=False)
    cuts = rng.integers(GEN_PROMPT_BYTES[0], GEN_PROMPT_BYTES[1] + 1, GEN_PROMPTS)
    return [usable[i].encode()[:n].decode("utf-8", errors="ignore") for i, n in zip(picks, cuts)]


def trainer_generate_config(snap: pathlib.Path, artifact: pathlib.Path, prompts: pathlib.Path,
                            **over) -> dict:
    """generate_tinyllama.yaml's values, pointed at the snapshot, the
    decompose task's artifact and the prose prompts; ``over`` replaces
    values (None drops the key)."""
    cfg = dict(task="generate", decomposed_model_name=TRAINER_SNAPSHOT_NAME,
               decomposed_model_checkpoint_path=str(snap), decomposed_model_dtype="bfloat16",
               decompose_config=str(artifact / "decompose_config.json"),
               decompose_state_dict=str(artifact / "decompose_state_dict.pt"),
               prompts_file=str(prompts), max_new_tokens=GEN_NEW, temperature=0.7, top_p=0.95,
               batch_size=8, stop_at_eos=True)
    cfg.update(over)
    return {k: v for k, v in cfg.items() if v is not None}


@contextlib.contextmanager
def served_tokens():
    """Every token tensor that serving's three entry points return while the
    block runs (the CLI and the gate call them through the module)."""
    seen: list[torch.Tensor] = []
    saved = {n: getattr(serving, n) for n in ("generate", "generate_beam", "generate_speculative")}

    def wrap(fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out[0] if isinstance(out, tuple) else out)
            return out
        return recorded

    for n, fn in saved.items():
        setattr(serving, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(serving, n, fn)


def trainer_llm_generate(dev, seed: int, root: pathlib.Path, snap, data, artifact) -> dict:
    """The CLI's generate task on the decompose task's artifact: sampled (the
    example YAML's values), beam search, speculative decoding with and
    without its auto gate, and int8.  Each run's summary has the JAX
    trainer's keys, every token served (the gate's probes included) lies in
    the vocabulary, no generation passes the budget, and flash launched."""
    prompts = generation_prompts(data, seed)
    prompts_file = root / "prompts.jsonl"
    prompts_file.write_text("".join(json.dumps({"text": p}) + "\n" for p in prompts))
    greedy = dict(temperature=0.0, top_p=None)
    runs = {"sampled": {}, "beam": dict(num_beams=4, **greedy),
            "speculative_gated": dict(speculative=True, speculative_k=4, **greedy),
            "speculative": dict(speculative=True, speculative_k=4, speculative_auto_gate=False,
                                **greedy),
            "int8": dict(quantize_int8=True)}
    vocab = tinyllama_2_layer().vocab_size
    recs = {}
    ops.reset_launch_counts()
    for name, over in runs.items():
        cfg_path, out = root / f"generate_{name}.json", root / f"generate_{name}_out"
        cfg_path.write_text(json.dumps(trainer_generate_config(snap, artifact, prompts_file, **over)))
        before = ops.launch_counts()
        with served_tokens() as served:
            rc = trainer_run.main(["--config", str(cfg_path), "--output-path", str(out)])
            torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
        summary = json.loads((out / "summary.json").read_text())
        rows = [json.loads(line) for line in (out / "generations.jsonl").read_text().splitlines()]
        keys = SUMMARY_KEYS | ({"speculative"} if name.startswith("speculative") else set())
        ids = torch.cat([t.reshape(-1) for t in served])
        rec = {"generate_wall_s": summary["generate_wall_s"], "tokens_per_s": summary["tokens_per_s"],
               "total_new_tokens": summary["total_new_tokens"],
               **({"speculative": summary["speculative"]} if "speculative" in summary else {}),
               "served_calls": len(served), "launches": counts}
        recs[name] = rec
        if rc != 0 or set(summary) != keys or len(rows) != GEN_PROMPTS or not served \
                or not (0 <= int(ids.min()) and int(ids.max()) < vocab) \
                or any(r["n_new_tokens"] > GEN_NEW for r in rows) or counts["flash_attention"] <= 0:
            emit({"phase": "trainer_llm_generate", "run": name, **rec, "summary": summary, "ok": False})
            raise AssertionError(f"trainer_llm_generate {name}: rc {rc}, summary {summary}")
    emit({"phase": "trainer_llm_generate", "prompts": GEN_PROMPTS,
          "prompt_bytes": [min(len(p.encode()) for p in prompts), max(len(p.encode()) for p in prompts)],
          "new_tokens": GEN_NEW, "runs": recs, "device": summary["device"],
          "launches": ops.launch_counts(), "nvidia_smi": nvidia_smi()})
    return ops.launch_counts()


def ragged_prompts(vocab: int, seed: int, dev, n: int, lens: tuple[int, int]) -> tuple:
    """``n`` rows of random tokens, their lengths drawn from ``lens``
    (inclusive): the rows, the rows right-padded with zeros, and the
    lengths."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(lens[0], lens[1] + 1, n)
    rows = [torch.from_numpy(rng.integers(0, vocab, k)).to(dev) for k in lens]
    padded = torch.zeros((n, int(lens.max())), dtype=torch.int64, device=dev)
    for i, r in enumerate(rows):
        padded[i, : len(r)] = r
    return rows, padded, torch.from_numpy(lens).to(dev)


def near_tie_stops(ref_logits: torch.Tensor) -> torch.Tensor:
    """(b,) each row's first step whose top-1 minus top-2 logit gap is
    under ``NEAR_TIE`` (the row's length where there is none)."""
    top2 = torch.topk(ref_logits.float(), 2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    return torch.where(tie.any(dim=1), tie.to(torch.int32).argmax(dim=1), tie.shape[1]).cpu()


def tokens_agree(got: torch.Tensor, want: torch.Tensor, ref_logits: torch.Tensor, what: str,
                 limit: list | None = None) -> dict:
    """Each row of ``got`` equals ``want`` up to the first near-tie step of
    the reference's logits (and its ``limit``, where given); returns the
    tokens compared and the rows stopped by a near-tie."""
    limit = torch.tensor(limit if limit is not None else [want.shape[1]] * want.shape[0])
    ties = near_tie_stops(ref_logits)
    stops = torch.minimum(ties, limit)
    got, want = got.cpu(), want.cpu()
    bad = [i for i, s in enumerate(stops.tolist()) if not torch.equal(got[i, :s], want[i, :s])]
    rec = {"compared": int(stops.sum()), "of": int(limit.sum()), "stops": int((ties < limit).sum())}
    if bad:
        emit({"phase": "serving_paths", "check": what, **rec, "rows_differing": bad, "ok": False})
        raise AssertionError(f"serving_paths {what}: rows {bad} differ before a near-tie")
    return rec


def filter_violations(tokens: torch.Tensor, logits: torch.Tensor, temperature: float, *,
                      top_k=None, top_p=None, min_p=None) -> int:
    """Sampled tokens outside the filter, computed here from the logits they
    were drawn from: the top-k logits; the tokens whose mass before them in
    the probability-sorted vocabulary is under top_p (f32 prefix sums,
    ``TOP_P_SLACK``); those at or above min_p times the largest probability."""
    scaled = logits.float() / temperature
    tok = tokens[..., None]
    if top_k is not None:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        ok = torch.gather(scaled, -1, tok) >= kth
    elif top_p is not None:
        p_sorted, order = torch.sort(torch.softmax(scaled, dim=-1), dim=-1, descending=True, stable=True)
        before = torch.cumsum(p_sorted, dim=-1) - p_sorted
        rank = (order == tok).to(torch.int32).argmax(dim=-1, keepdim=True)
        ok = torch.gather(before, -1, rank) < top_p + TOP_P_SLACK
    else:
        p = torch.softmax(scaled, dim=-1)
        ok = torch.gather(p, -1, tok) >= min_p * p.amax(dim=-1, keepdim=True) * (1 - 1e-6)
    return int((~ok).sum())


def timed_s(fn) -> float:
    """Best of two runs of ``fn`` after a warm one, each ending in a
    synchronize, in seconds."""
    fn()
    best = math.inf
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def step_ms(run, hi: int = 64, lo: int = 16) -> float:
    """ms a decode step of ``run(n)`` (n new tokens): the time of hi less
    that of lo tokens, over hi - lo."""
    return (timed_s(lambda: run(hi)) - timed_s(lambda: run(lo))) / (hi - lo) * 1e3


class _ChunkTimer:
    """Wraps the batcher's decode chunk: host clock around each chunk
    between two synchronizes, and the steps it ran."""

    def __init__(self, fn) -> None:
        self.fn, self.seconds, self.steps = fn, 0.0, 0

    def __call__(self, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        self.steps += kwargs["chunk"]
        return out


def serving_paths(dev, cfg, weights, deco_model, seed: int) -> dict:
    """The rest of cached serving on the slice-1 model, the original
    (``weights``) and its fused decomposition (``deco_model``), on ragged
    prompts.  On f32 copies: ragged batch == each row alone, one beam ==
    greedy, four beams' best cumulative logprob >= greedy's, speculative
    decoding with the fused draft == the target's greedy, the batcher's
    stream == each request alone (each up to the reference's first near-tie),
    and every token sampled under top-k, top-p or min-p inside its filter.
    In bf16: the ragged prefill against each row alone at the served-logits
    gates, flash and low-rank launched; decode, beam, batcher and
    speculative timings and the gate's measured ratio."""
    rows, padded, lens_t = ragged_prompts(cfg.vocab_size, seed + 30, dev, PATH_BATCH, PATH_LENS)
    lens = lens_t.cpu().numpy()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    orig = utils.load_state_dict(models.CausalLM(cfg, device=dev), weights)
    deco32 = copy.deepcopy(deco_model).to(dev)
    deco = copy.deepcopy(deco32).to(torch.bfloat16)
    orig32 = f32_twin(orig)
    checks = {}

    # --- f32 token checks ----------------------------------------------
    toks, logits = serving.generate(orig32, padded, PATH_NEW, prompt_lens=lens_t, return_logits=True)
    alone = [serving.generate(orig32, r[None], PATH_NEW, return_logits=True) for r in rows]
    a_toks = torch.cat([a[0] for a in alone])
    a_logits = torch.cat([a[1] for a in alone])
    checks["ragged_vs_alone"] = tokens_agree(toks, a_toks, a_logits, "ragged_vs_alone")
    beam1 = serving.generate_beam(orig32, padded, PATH_NEW, num_beams=1, prompt_lens=lens_t)
    checks["beam1_vs_greedy"] = tokens_agree(beam1, toks, logits, "beam1_vs_greedy")
    _, beam_scores = serving.generate_beam(orig32, padded, PATH_NEW, num_beams=4, length_penalty=0.0,
                                           prompt_lens=lens_t, return_scores=True)
    greedy_lp = torch.gather(torch.log_softmax(logits.float(), -1), -1, toks[..., None])[..., 0].sum(1)
    margin = beam_scores - greedy_lp
    checks["beam4_vs_greedy_logprob"] = {"min_margin": float(margin.min()),
                                         "mean_margin": float(margin.mean()),
                                         "limit": -BEAM_SLACK}
    if float(margin.min()) < -BEAM_SLACK:
        emit({"phase": "serving_paths", "check": "beam4", **checks["beam4_vs_greedy_logprob"],
              "ok": False})
        raise AssertionError(f"serving_paths: 4 beams scored below greedy: {margin.tolist()}")
    spec, spec_stats = serving.generate_speculative(orig32, deco32, padded, PATH_NEW, k=4,
                                                    prompt_lens=lens_t, return_stats=True)
    checks["speculative_vs_greedy"] = {**tokens_agree(spec, toks, logits, "speculative_vs_greedy"),
                                       **spec_stats}
    # the target as its own draft: every draft the verify pass sees is its
    # own greedy pick (but at a layout flip), so the loop's acceptance is
    # bounded only by the budget's cut of the last round
    own, own_stats = serving.generate_speculative(orig32, orig32, padded, PATH_NEW, k=4,
                                                  prompt_lens=lens_t, return_stats=True)
    own_acceptance = own_stats["accepted"] / own_stats["drafted"]
    checks["speculative_self_draft"] = {**tokens_agree(own, toks, logits, "speculative_self_draft"),
                                        **own_stats, "acceptance": own_acceptance,
                                        "limit_acceptance": SELF_DRAFT_ACCEPTANCE}
    if own_acceptance < SELF_DRAFT_ACCEPTANCE:
        emit({"phase": "serving_paths", "check": "self_draft", **checks["speculative_self_draft"],
              "ok": False})
        raise AssertionError(f"serving_paths: self-draft acceptance {own_acceptance}")
    budgets = [PATH_NEW - 4 * (i % 4) for i in range(PATH_BATCH)]
    eng = serving_batcher.ContinuousBatcher(orig32, n_slots=PATH_BATCH // 2,
                                            max_len=int(lens.max()) + PATH_NEW, decode_chunk=8)
    for r, budget in zip(rows, budgets):
        eng.submit(r.cpu().numpy(), budget)
    done = {f.req_id: f.tokens for f in eng.run()}
    stream = torch.zeros_like(a_toks)
    for i, budget in enumerate(budgets):
        if len(done[i]) != budget:
            raise AssertionError(f"serving_paths: request {i} returned {len(done[i])} of {budget} tokens")
        stream[i, :budget] = torch.from_numpy(done[i].astype(np.int64))
    checks["batcher_vs_alone"] = tokens_agree(stream, a_toks, a_logits, "batcher_vs_alone", budgets)
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    filters = {}
    for name, kw in (("top_k", dict(top_k=40)), ("top_p", dict(top_p=0.9)), ("min_p", dict(min_p=0.05))):
        s_toks, s_logits = serving.generate(orig32, padded, PATH_NEW // 2, temperature=0.7,
                                            generator=gen, prompt_lens=lens_t, return_logits=True, **kw)
        filters[name] = {"sampled": s_toks.numel(),
                         "outside": filter_violations(s_toks, s_logits, 0.7, **kw)}
        if filters[name]["outside"]:
            emit({"phase": "serving_paths", "check": name, **filters[name], "ok": False})
            raise AssertionError(f"serving_paths: tokens sampled outside {name}: {filters[name]}")
    checks["filters"] = filters
    del orig32, deco32, logits, a_logits
    torch.cuda.empty_cache()

    # --- bf16: the kernels' path, and timings ---------------------------
    caches = serving.init_cache(deco, PATH_BATCH, padded.shape[1])
    ragged, _ = serving.forward_with_cache(deco, padded, caches, 0, last_pos=lens_t - 1)
    single = torch.cat([serving.forward_with_cache(deco, r[None], serving.init_cache(deco, 1, len(r)), 0,
                                                   last_pos=torch.tensor([len(r) - 1], device=dev))[0]
                        for r in rows])
    checks["bf16_ragged_prefill_vs_alone"] = logits_agree(ragged, single, GEN_MAX_ABS, GEN_RMS_REL,
                                                          "serving_paths_ragged_prefill")
    timings = {
        "decode_step_ms": step_ms(lambda n: serving.generate(deco, padded, n, prompt_lens=lens_t)),
        "decode_step_original_ms": step_ms(
            lambda n: serving.generate(orig, padded, n, prompt_lens=lens_t)),
        "beam4_step_ms": step_ms(lambda n: serving.generate_beam(deco, padded, n, num_beams=4,
                                                                 prompt_lens=lens_t)),
    }
    chunk_timer = _ChunkTimer(serving_batcher._decode_chunk_impl)
    serving_batcher._decode_chunk_impl = chunk_timer
    try:
        eng = serving_batcher.ContinuousBatcher(deco, n_slots=PATH_BATCH,
                                                max_len=int(lens.max()) + 64, decode_chunk=8)
        for r in rows:
            eng.submit(r.cpu().numpy(), 64)
        eng.run()
    finally:
        serving_batcher._decode_chunk_impl = chunk_timer.fn
    timings["batcher_step_ms"] = chunk_timer.seconds / chunk_timer.steps * 1e3
    # one uniform decode step of the batch: host enqueue and device busy
    timings["decode_step_breakdown"] = serve_timings(deco, padded, padded[:, -1:])
    stats = {}

    def speculative():
        stats.update(serving.generate_speculative(orig, deco, padded, 64, k=4, prompt_lens=lens_t,
                                                  return_stats=True)[1])

    spec_s = timed_s(speculative)
    timings["speculative_round_ms"] = spec_s / stats["rounds"] * 1e3
    timings["speculative_ms_per_token"] = spec_s / 64 * 1e3
    acceptance = stats["accepted"] / max(stats["drafted"], 1)
    gate = serving.measure_speculative_speedup_probe(orig, deco, padded, k=4, prompt_lens=lens_t)
    counts = ops.launch_counts()
    require_launches(counts, ("flash_attention", "lowrank_matmul"), "serving_paths")
    emit({"phase": "serving_paths", "batch": PATH_BATCH, "prompt_lens": lens.tolist(),
          "new_tokens": PATH_NEW, "near_tie": NEAR_TIE, "checks": checks, "timings": timings,
          "speculative_stats": stats, "acceptance": acceptance, "gate": gate,
          "wall_s": time.perf_counter() - t_start, "launches": counts, "nvidia_smi": nvidia_smi()})
    return counts


# --- slice 10: phi-2 through the trainer CLI; Qwen2 and Gemma -------------


def f32_token_checks(model, vocab: int, seed: int, dev, what: str) -> dict:
    """Ragged cached generation on the model's f32 twin against
    each row alone, tokens equal up to the first near-tie (serving_paths'
    check); the twin launches no kernel."""
    twin = f32_twin(model)
    rows, padded, lens = ragged_prompts(vocab, seed, dev, FAMILY_PROMPTS, FAMILY_PROMPT_LENS)
    ops.reset_launch_counts()
    toks, _ = serving.generate(twin, padded, PATH_NEW, prompt_lens=lens, return_logits=True)
    alone = [serving.generate(twin, r[None], PATH_NEW, return_logits=True) for r in rows]
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"{what}: the f32 twin launched kernels: {ops.launch_counts()}")
    got = tokens_agree(toks, torch.cat([a[0] for a in alone]), torch.cat([a[1] for a in alone]),
                       what)
    del twin
    torch.cuda.empty_cache()
    return {"prompt_lens": lens.tolist(), "new_tokens": PATH_NEW, **got}


def family_2_layer(name: str) -> tuple[models.TransformerConfig, models.TransformerConfig]:
    """The family's config cut to ``FAMILY_LAYERS`` (and its routed experts
    to ``FAMILY_EXPERTS``), and its published config."""
    if name == "qwen2_1_5b":
        full = models.TransformerConfig.qwen2_1_5b(dtype=torch.bfloat16)
    else:
        full = models.TransformerConfig.from_hf_config(FAMILY_CONFIGS[name], dtype=torch.bfloat16)
    # the kept layers' types, rope flags and dense layers (FAMILY_FIRST_LAYER)
    lo = FAMILY_FIRST_LAYER.get(name, 0)
    kept = slice(lo, lo + FAMILY_LAYERS)
    cut = dataclasses.replace(
        full, n_layers=FAMILY_LAYERS, layer_types=full.layer_types[kept],
        rope_layers=full.rope_layers[kept],
        mlp_only_layers=tuple(i - lo for i in full.mlp_only_layers if lo <= i < lo + FAMILY_LAYERS),
        n_experts=FAMILY_EXPERTS.get(name, full.n_experts))
    return cut, full


def fused_layout(sd: dict[str, torch.Tensor], qkv: bool) -> dict[str, torch.Tensor]:
    """gate/up fused into ``gate_up_proj`` and, with ``qkv``, q/k/v into
    ``qkv_proj`` (phi3's checkpoint layout; GLM-4's fuses gate/up only)."""
    fused_away = ("mlp.up_proj", *(("self_attn.k_proj", "self_attn.v_proj") if qkv else ()))
    fused = {}
    for k, v in sd.items():
        stem = k.rpartition(".")[0]
        if qkv and stem.endswith("self_attn.q_proj"):
            base = stem[: -len("q_proj")]
            fused[base + "qkv_proj.weight"] = torch.cat(
                [sd[base + f"{p}_proj.weight"] for p in "qkv"])
        elif stem.endswith("mlp.gate_proj"):
            base = stem[: -len("gate_proj")]
            fused[base + "gate_up_proj.weight"] = torch.cat(
                [sd[base + "gate_proj.weight"], sd[base + "up_proj.weight"]])
        elif not stem.endswith(fused_away):
            fused[k] = v
    return fused


def glm4_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """GLM-4's checkpoint layout: gate/up fused, and its norm names (the
    attention output's ``post_self_attn_layernorm``, the pre-MLP
    ``post_attention_layernorm``, the MLP output's ``post_mlp_layernorm``)."""
    names = ((".post_attention_layernorm.", ".post_self_attn_layernorm."),
             (".pre_feedforward_layernorm.", ".post_attention_layernorm."),
             (".post_feedforward_layernorm.", ".post_mlp_layernorm."))
    out = {}
    for k, v in fused_layout(sd, qkv=False).items():
        for ours, theirs in names:
            if ours in k:
                k = k.replace(ours, theirs)
                break
        out[k] = v
    return out


def renamed(sd: dict[str, torch.Tensor], names: tuple) -> dict[str, torch.Tensor]:
    """``sd`` with each (ours, theirs) of ``names`` replaced in its keys."""
    out = {}
    for k, v in sd.items():
        for ours, theirs in names:
            k = k.replace(ours, theirs)
        out[k] = v
    return out


def fused_query_key_value(sd: dict[str, torch.Tensor], fuse) -> dict[str, torch.Tensor]:
    """q/k/v (weights and biases) fused by ``fuse`` into
    ``self_attn.query_key_value``."""
    out = {}
    for k, v in sd.items():
        stem, _, leaf = k.rpartition(".")
        if stem.endswith("self_attn.q_proj"):
            base = stem[: -len("q_proj")]
            out[base + "query_key_value." + leaf] = fuse(
                *(sd[f"{base}{p}_proj.{leaf}"] for p in "qkv"))
        elif not stem.endswith(("self_attn.k_proj", "self_attn.v_proj")):
            out[k] = v
    return out


def concatenated(q, k, v):
    return torch.cat([q, k, v])


# GPT-2's names, which GPTBigCode shares on plain Linear weights
GPT2_NAMES = (
    ("model.embed_tokens.", "transformer.wte."), ("model.pos_embed.", "transformer.wpe."),
    ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."),
    (".input_layernorm.", ".ln_1."), (".post_attention_layernorm.", ".ln_2."),
    (".self_attn.query_key_value.", ".attn.c_attn."), (".self_attn.o_proj.", ".attn.c_proj."),
    (".mlp.up_proj.", ".mlp.c_fc."), (".mlp.down_proj.", ".mlp.c_proj."))


def gpt2_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """GPT-2's checkpoint layout: q/k/v fused in ``attn.c_attn``, every
    projection's weight in Conv1D's (in, out), HF's names, no head (tied)."""
    conv1d = (".attn.c_attn.weight", ".attn.c_proj.weight", ".mlp.c_fc.weight",
              ".mlp.c_proj.weight")
    out = renamed(fused_query_key_value(sd, concatenated), GPT2_NAMES)
    return {k: v.T.contiguous() if k.endswith(conv1d) else v for k, v in out.items()}


def per_head(n_heads: int):
    """q/k/v fused a head at a time: [head 0: q k v][head 1: q k v]..."""
    def fuse(q, k, v):
        return torch.stack([t.reshape(n_heads, -1, *t.shape[1:]) for t in (q, k, v)],
                           dim=1).reshape(3 * q.shape[0], *q.shape[1:])

    return fuse


def gpt_neox_layout(sd: dict[str, torch.Tensor], n_heads: int) -> dict[str, torch.Tensor]:
    """GPT-NeoX's checkpoint layout: q/k/v fused a head at a time in
    ``attention.query_key_value``, HF's names, the untied head
    ``embed_out``."""
    return renamed(fused_query_key_value(sd, per_head(n_heads)), (
        ("model.embed_tokens.", "gpt_neox.embed_in."),
        ("model.norm.", "gpt_neox.final_layer_norm."),
        ("model.layers.", "gpt_neox.layers."), ("lm_head.", "embed_out."),
        (".self_attn.query_key_value.", ".attention.query_key_value."),
        (".self_attn.o_proj.", ".attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
        (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


def falcon_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Falcon-7B's checkpoint layout: the query heads, then its one key and
    one value head, in ``self_attention.query_key_value``, HF's names."""
    return renamed(fused_query_key_value(sd, concatenated), (
        ("model.embed_tokens.", "transformer.word_embeddings."),
        ("model.norm.", "transformer.ln_f."),
        ("model.layers.", "transformer.h."),
        (".self_attn.query_key_value.", ".self_attention.query_key_value."),
        (".self_attn.o_proj.", ".self_attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
        (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


def gptj_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """GPT-J's checkpoint layout: its names, the biased head as it is."""
    return renamed(sd, (
        ("model.embed_tokens.", "transformer.wte."), ("model.norm.", "transformer.ln_f."),
        ("model.layers.", "transformer.h."), (".input_layernorm.", ".ln_1."),
        (".self_attn.o_proj.", ".attn.out_proj."), (".self_attn.", ".attn."),
        (".mlp.up_proj.", ".mlp.fc_in."), (".mlp.down_proj.", ".mlp.fc_out.")))


def opt_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """OPT's checkpoint layout: its names, the position table after two
    offset rows (HF adds 2 to every position), the tied head stored too."""
    out = renamed(sd, (
        ("model.embed_tokens.", "model.decoder.embed_tokens."),
        ("model.pos_embed.", "model.decoder.embed_positions."),
        ("model.norm.", "model.decoder.final_layer_norm."),
        ("model.layers.", "model.decoder.layers."), (".self_attn.o_proj.", ".self_attn.out_proj."),
        (".input_layernorm.", ".self_attn_layer_norm."),
        (".post_attention_layernorm.", ".final_layer_norm."), (".mlp.up_proj.", ".fc1."),
        (".mlp.down_proj.", ".fc2.")))
    table = out["model.decoder.embed_positions.weight"]
    out["model.decoder.embed_positions.weight"] = torch.cat([torch.full_like(table[:2], 7.0), table])
    return {**out, "lm_head.weight": sd["model.embed_tokens.weight"]}


def gpt_bigcode_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """StarCoder's checkpoint layout: [q | k | v] rows in ``attn.c_attn``
    (one k and one v head), GPT-2's names on plain Linear weights, the tied
    head stored too."""
    out = renamed(fused_query_key_value(sd, concatenated), GPT2_NAMES)
    return {**out, "lm_head.weight": sd["model.embed_tokens.weight"]}


def persimmon_layout(sd: dict[str, torch.Tensor], n_heads: int) -> dict[str, torch.Tensor]:
    """Persimmon's checkpoint layout: q/k/v fused a head at a time in
    ``self_attn.query_key_value``, its names (``dense``, ``q_layernorm`` /
    ``k_layernorm``, ``dense_h_to_4h`` / ``dense_4h_to_h``,
    ``final_layernorm``)."""
    return renamed(fused_query_key_value(sd, per_head(n_heads)), (
        ("model.norm.", "model.final_layernorm."), (".self_attn.o_proj.", ".self_attn.dense."),
        (".self_attn.q_norm.", ".self_attn.q_layernorm."),
        (".self_attn.k_norm.", ".self_attn.k_layernorm."),
        (".mlp.up_proj.", ".mlp.dense_h_to_4h."), (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


def bloom_layout(sd: dict[str, torch.Tensor], n_heads: int) -> dict[str, torch.Tensor]:
    """BLOOM's checkpoint layout: q/k/v fused a head at a time in
    ``self_attention.query_key_value``, HF's names (``word_embeddings`` and
    its ``word_embeddings_layernorm``, ``h``, ``self_attention.dense``,
    ``dense_h_to_4h`` / ``dense_4h_to_h``, ``ln_f``), no head (tied)."""
    return renamed(fused_query_key_value(sd, per_head(n_heads)), (
        ("model.embed_norm.", "transformer.word_embeddings_layernorm."),
        ("model.embed_tokens.", "transformer.word_embeddings."),
        ("model.norm.", "transformer.ln_f."), ("model.layers.", "transformer.h."),
        (".self_attn.query_key_value.", ".self_attention.query_key_value."),
        (".self_attn.o_proj.", ".self_attention.dense."), (".mlp.up_proj.", ".mlp.dense_h_to_4h."),
        (".mlp.down_proj.", ".mlp.dense_4h_to_h.")))


# the families whose planted weights are written in their checkpoint layout
# and translated back by the loader, as a snapshot's would be
def moshi_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Moshi's: the attention projections nested in ``.linear``, gate and up
    fused into the gating ``mlp.fc1`` ([gate | up]), down as ``mlp.fc2``."""
    out = {}
    for k, v in sd.items():
        if ".mlp.up_proj." in k:
            continue
        if ".mlp.gate_proj." in k:
            k, v = k.replace("gate_proj", "fc1"), torch.cat([v, sd[k.replace("gate", "up")]])
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            k = k.replace(f".self_attn.{proj}.", f".self_attn.{proj}.linear.")
        out[k.replace(".mlp.down_proj.", ".mlp.fc2.")] = v
    return out


def mllama_layout(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A full mllama checkpoint's: the text model under
    ``model.language_model.``, with a vision tower and projector and the
    cross-attention layer's (layer 1 of the cut) own weights, which the
    translator drops."""
    out = {k.replace("model.", "model.language_model.", 1): v for k, v in sd.items()}
    small = torch.ones(8, 8, device=sd["model.embed_tokens.weight"].device)
    return {**out, "model.language_model.layers.1.cross_attn.q_proj.weight": small,
            "vision_model.patch_embedding.weight": small, "multi_modal_projector.weight": small}


FAMILY_LAYOUTS = {"phi3_mini": lambda sd: fused_layout(sd, qkv=True), "glm4_9b": glm4_layout,
                  "gpt2_xl": gpt2_layout,
                  "pythia_1_4b": lambda sd: gpt_neox_layout(sd, PYTHIA_1_4B["num_attention_heads"]),
                  "falcon_7b": falcon_layout, "gptj_6b": gptj_layout, "opt_6_7b": opt_layout,
                  "starcoderbase_1b": gpt_bigcode_layout,
                  "persimmon_8b": lambda sd: persimmon_layout(
                      sd, PERSIMMON_8B["num_attention_heads"]),
                  "bloom_7b1": lambda sd: bloom_layout(sd, BLOOM_7B1["n_head"]),
                  "doge_hf_default": lambda sd: renamed(sd, ((".dyn_mask_A", ".A"),)),
                  "moshi_hf_default": moshi_layout, "mllama_text_hf_default": mllama_layout}


def family_cut_hf(name: str) -> dict:
    """The family's config.json cut as ``family_2_layer`` cuts it, for its
    translator: mllama's cross-attention layers renumbered into the cut."""
    hf = FAMILY_CONFIGS[name]
    if "cross_attention_layers" not in hf:
        return hf
    lo = FAMILY_FIRST_LAYER.get(name, 0)
    return dict(hf, num_hidden_layers=FAMILY_LAYERS, cross_attention_layers=[
        i - lo for i in hf["cross_attention_layers"] if lo <= i < lo + FAMILY_LAYERS])


def family_weights(cfg: models.TransformerConfig, name: str, seed: int,
                   dev) -> dict[str, torch.Tensor]:
    """``planted_rank_weights`` drawn on the card, written in the family's
    checkpoint layout (``FAMILY_LAYOUTS``) and translated back by
    ``hf_loader.translator_for``, which must give the weights again, array
    by array."""
    sd = planted_rank_weights(cfg, seed, dev)
    if name not in FAMILY_LAYOUTS:
        return sd
    back = hf_loader.translator_for(family_cut_hf(name))(FAMILY_LAYOUTS[name](sd))
    if back.keys() != sd.keys() or any(
            back[k] is not sd[k] and not torch.equal(back[k], sd[k]) for k in sd):
        raise AssertionError(f"{name}: the translated checkpoint layout is not the weights")
    return back


def skip_layers_checked(model, config: dict, cfg: models.TransformerConfig, name: str) -> list:
    """The cut's skipped layers (mllama's cross-attention layer): each holds
    no site, no decompose_config entry, no state-dict key and no cache
    entry."""
    skipped = [i for i, t in enumerate(cfg.layer_types) if t == "skip"]
    caches = serving.init_cache(model, 1, 8)
    for i in skipped:
        prefix = f"model.layers.{i}."
        held = ([n for n in engine.get_decomposeable_submodule_names(model) if n.startswith(prefix)]
                + [k for k in config if k.startswith(prefix)]
                + [k for k in model.state_dict() if k.startswith(prefix)])
        if held or caches[i] is not None:
            raise AssertionError(f"{name}: skipped layer {i} holds {held} or a cache entry")
    return skipped


def flash_as_jax(counts: dict[str, int], name: str, what: str) -> None:
    """Flash launched where the JAX package takes it, and not at all where
    its attention is plain (``FAMILY_NO_FLASH``)."""
    if (counts["flash_attention"] > 0) == (name in FAMILY_NO_FLASH):
        raise AssertionError(f"{name} {what}: flash launches against the JAX gate: {counts}")


def moe_walk_sites(model, cfg: models.TransformerConfig) -> list[str]:
    """The sites an MoE family's walk decomposes: layer 0's attention
    projections, its shared expert and its experts ``MOE_WALK_EXPERTS``.
    A DeepSeek model's layer 0 is dense: its walk takes every latent
    attention site but ``kv_b_proj`` (a fused one cannot be absorbed into
    the cache), layer 0's MLP and layer 1's shared expert, and no routed
    expert, so layer 1 takes the grouped kernels throughout."""
    names = engine.get_decomposeable_submodule_names(model, ["lm_head"])
    if cfg.kv_lora_rank is not None:
        return [n for n in names if not n.endswith((".kv_b_proj", ".mlp.gate"))
                and ".mlp.experts." not in n]
    p = "model.layers.0."
    keep = (p + "self_attn.", p + "mlp.shared_expert.",
            *(f"{p}mlp.experts.{e}." for e in MOE_WALK_EXPERTS))
    return [n for n in names if n.startswith(keep)]


def absorbed_pair_cost(cfg: models.TransformerConfig, dev) -> dict:
    """The cost a cached step pays for a decomposed ``kv_b_proj``:
    ``serving._dense_linear_kernel`` multiplies its factor pair out at every
    step (the JAX package once per compiled program); timed on a bf16 pair
    of ``kv_b_proj``'s shape at rank ``PLANTED_RANK``.  The phases' own
    ``kv_b_proj``s stay whole, so their steps do not pay it."""
    out = cfg.n_heads * (cfg.qk_nope_head_dim + cfg.v_head_dim)
    pair = torch.nn.Sequential(
        torch.nn.Linear(cfg.kv_lora_rank, PLANTED_RANK, bias=False),
        torch.nn.Linear(PLANTED_RANK, out, bias=False)).to(dev, torch.bfloat16)
    ms = time_ms(lambda: serving._dense_linear_kernel(pair, "kv_b_proj"))
    return {"rank": PLANTED_RANK, "in_out": [cfg.kv_lora_rank, out], "ms_per_step_per_layer": ms}


def moe_int8_serve(model, prompt, gen: dict, name: str, gates: dict, near_ties: float) -> dict:
    """An MoE family's fused model quantized (a copy: ``quant.
    quantize_for_serving``), served through cached ``generate`` (gmm_int8's
    batch route at the prefill and decode route at the decode steps, no
    expert dequantized for the bf16 grouped kernel), then held against the
    bf16 model on the bf16 run's tokens, routed as that run was.  A
    DeepSeek model's ``kv_b_proj``s stay bf16 (``skip_names``, as a JAX
    user must pass them): an int8 one cannot be absorbed into the cache."""
    qmodel = copy.deepcopy(model)
    quant.quantize_for_serving(qmodel, skip_names=[
        n for n, _ in qmodel.named_modules() if n.endswith(".kv_b_proj")])
    int8 = cached_generate(qmodel, prompt, TINY_NEW, f"{name}_generate_int8", *gates["serve"],
                           near_ties)
    require_launches(int8["counts"], ("gmm_int8", "lowrank_matmul"), f"{name} generate int8")
    require_launches(int8["int8_routes"], ("batch", "decode"), f"{name} generate int8 routes")
    if int8["counts"]["grouped_matmul"]:
        raise AssertionError(f"{name} int8 dequantized its experts: {int8['counts']}")
    with torch.no_grad(), Routing(qmodel, prompt.shape[0], forced=gen["routes"]) as forced:
        y_int8 = qmodel({"input_ids": gen["full"]})[:, prompt.shape[1] - 1:]
    vs_bf16 = {**logits_agree(y_int8, gen["uncached"], *gates["int8"], f"{name}_int8_vs_bf16"),
               **forced.gate(f"{name}_int8_vs_bf16", near_ties)}
    del qmodel
    torch.cuda.empty_cache()
    return {"wall_s": int8["wall_s"], **int8["gate"], "int8_vs_bf16": vs_bf16,
            "tokens_equal_to_bf16": float((int8["tokens"] == gen["tokens"]).float().mean()),
            "int8_routes": int8["int8_routes"], "launches": int8["counts"]}


def family_serve(dev, name: str, seed: int) -> dict[str, dict[str, int]]:
    """Slice 1's path on a 2-layer family model (``FAMILY_CONFIGS``, or
    ``qwen2_1_5b``): ``dwain.decompose`` (SYRK, and flash where the JAX
    package takes it, launched), the artifact round trip, the fused serve
    against its pairs (low-rank launched), greedy cached ``generate`` of 4 x
    128 tokens (640 past gemma3's window) against the uncached forward,
    ragged f32 token checks, and the served model against itself on the
    CPU in f32 on a short input.  An MoE family (``MOE_FAMILIES``) walks
    ``moe_walk_sites`` only, must launch the bf16 grouped kernel (on its
    wgmma route at the prefill), is compared routed as the run it checks
    (``Routing``; the share of overridden routings gated by its
    ``near_ties``), and is served in int8 too (``moe_int8_serve``).
    Returns each part's launch counts; the phase's record splits its wall
    by part (``split_s``)."""
    t_phase = time.perf_counter()
    split = {}

    def lap(part: str) -> None:
        torch.cuda.synchronize()
        split[part] = time.perf_counter() - t_phase - sum(split.values())

    cfg, full = family_2_layer(name)
    gates = FAMILY_GATES[name]
    moe = cfg.n_experts > 0
    near_ties = gates.get("near_ties", MAX_NEAR_TIE_SHARE)
    weights = family_weights(cfg, name, seed, dev)
    lap("planted")
    model = utils.load_state_dict(models.CausalLM(cfg, device=dev), weights)
    del weights
    sites = engine.get_decomposeable_submodule_names(model, ["lm_head"])
    walk_args = FAMILY_DECOMPOSE_ARGS
    if moe:
        walked = moe_walk_sites(model, cfg)
        walk_args = {**FAMILY_DECOMPOSE_ARGS, "num_metric_steps": MOE_METRIC_STEPS,
                     "blacklisted_module_names": [
                         "lm_head", *(n for n in sites if n not in walked)]}
    params_before = utils.get_num_params(model)
    probe = utils.to_device(next(token_batches(cfg.vocab_size, seed + 3)), dev)
    if moe:  # every MoE layer on the grouped route, before the walk sends layer 0 dense
        with torch.no_grad():
            pristine_ms = time_ms(lambda: model(probe), reps=10)
    ops.reset_launch_counts()
    lap("weights")
    t0 = time.perf_counter()
    model, config = dwain.decompose(
        module=model,
        data_iterator=token_batches(cfg.vocab_size, seed + 1),
        metric_iterator=token_batches(cfg.vocab_size, seed + 2),
        loss_fn=models.ce_loss,
        device=dev,
        **walk_args,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lap("walk")
    walk = ops.launch_counts()
    require_launches(walk, ("syrk_gram", *(("grouped_matmul",) if moe else ())),
                     f"{name} decompose")
    flash_as_jax(walk, name, "decompose")
    if not config:
        raise AssertionError(f"{name}: no site decomposed")
    artifact = artifact_round_trip(model, config, cfg, probe, dev, f"{name}_artifact")
    skipped = skip_layers_checked(model, config, cfg, name)
    lap("artifact")

    with torch.no_grad(), Routing(model, 1) as routed:
        y_pairs = model(probe)
    ops.reset_launch_counts()
    pnn.fuse_factor_pairs(model)
    with torch.no_grad(), Routing(model, 1, forced=routed.per_layer()) as forced:
        y_fused = model(probe)
    torch.cuda.synchronize()
    serve_counts = ops.launch_counts()
    require_launches(serve_counts, ("lowrank_matmul", *(("grouped_matmul",) if moe else ())),
                     f"{name} serve")
    flash_as_jax(serve_counts, name, "serve")
    serve = logits_agree(y_fused, y_pairs, *gates["serve"], f"{name}_serve")
    if moe:
        serve.update(forced.gate(f"{name}_serve", near_ties))
    with torch.no_grad():
        fused_ms = time_ms(lambda: model(probe), reps=10)
    del y_pairs, y_fused
    lap("serve")

    _, padded, _ = ragged_prompts(cfg.vocab_size, seed + 4, dev, FAMILY_PROMPTS, FAMILY_PROMPT_LENS)
    prompt = padded[:, :FAMILY_PROMPT_LENS[0]]
    if cfg.sliding_window is not None:  # past the window: the cached window mask binds
        prompt = torch.from_numpy(np.random.default_rng(seed + 4).integers(
            0, cfg.vocab_size, (FAMILY_PROMPTS, GEMMA3_PROMPT))).to(dev)
    gen = cached_generate(model, prompt, TINY_NEW, f"{name}_generate", *gates["serve"],
                          near_ties)
    require_launches(gen["counts"], ("lowrank_matmul", *(("grouped_matmul",) if moe else ())),
                     f"{name} generate")
    flash_as_jax(gen["counts"], name, "generate")
    if moe:
        # the prefill's mean group of 32-64 rows takes the wgmma route
        require_launches(gen["grouped_routes"], ("wgmma",), f"{name} generate routes")
    lap("generate")
    absorb = absorbed_pair_cost(cfg, dev) if cfg.kv_lora_rank is not None else None
    int8 = moe_int8_serve(model, prompt, gen, name, gates, near_ties) if moe else None
    gen_wall, gen_gate, gen_counts = gen["wall_s"], gen["gate"], gen["counts"]
    gen_routes = gen["grouped_routes"]
    del gen
    if moe:
        lap("int8")
    tokens = f32_token_checks(model, cfg.vocab_size, seed + 5, dev, f"{name}_ragged_vs_alone")
    lap("f32_tokens")

    short = {"input_ids": probe["input_ids"][:, :128]}
    with torch.no_grad(), Routing(model, 1) as routed:
        y_card = model(short).float().cpu()
    with torch.no_grad(), Routing(model, 1, forced={
            i: r.cpu() for i, r in routed.per_layer().items()}) as forced:
        short = utils.to_device(short, "cpu")
        y_cpu = model.to("cpu", torch.float32)(short)
    ref = logits_agree(y_card, y_cpu, *gates["reference"], f"{name}_reference")
    if moe:
        ref.update(forced.gate(f"{name}_reference", near_ties))
    lap("reference")
    emit({"phase": name, "layers": cfg.n_layers, "head_dim": cfg.head_dim,
          "heads": [cfg.n_heads, cfg.n_kv_heads], "wall_s": wall, "sites": len(sites),
          "decomposed": len(config), "params_before": params_before,
          "param_fraction": utils.get_num_params(model) / params_before,
          "ranks": {k: v["modules"]["0"]["out_features"] for k, v in config.items()},
          "artifact": artifact, "serve": serve, "fused_ms": fused_ms,
          **({"skipped_layers": skipped} if skipped else {}),
          **({"absorbed_pair": absorb} if absorb else {}),
          "cuts": {"layers": [full.n_layers, cfg.n_layers], "layer_types": cfg.layer_types,
                   **({"experts": [full.n_experts, cfg.n_experts]}
                      if cfg.n_experts != full.n_experts else {}),
                   "rope_layers": cfg.rope_layers,
                   "weights": f"planted rank {PLANTED_RANK}, seed {seed}", "dtype": "bf16"},
          "generate": {"batch": FAMILY_PROMPTS, "prompt": prompt.shape[1],
                       "new_tokens": TINY_NEW, "wall_s": gen_wall, **gen_gate,
                       **({"grouped_routes": gen_routes} if moe else {})},
          **({"experts": [cfg.n_experts, cfg.n_experts_per_tok], "walk_sites": len(walked),
              "pristine_ms": pristine_ms, "int8": int8} if moe else {}),
          "f32_tokens": tokens, "reference": ref, "walk_launches": walk,
          "serve_launches": serve_counts, "generate_launches": gen_counts,
          "split_s": split, "phase_wall_s": time.perf_counter() - t_phase})
    return {f"{name}_decompose": walk, f"{name}_serve": serve_counts,
            f"{name}_generate": gen_counts,
            **({f"{name}_generate_int8": int8["launches"]} if moe else {})}


def phi2_2_layer() -> models.PhiConfig:
    return dataclasses.replace(models.PhiConfig.phi2(dtype=torch.bfloat16), n_layers=FAMILY_LAYERS)


def planted_phi_weights(cfg: models.PhiConfig, seed: int, dev) -> dict[str, torch.Tensor]:
    """Random weights in HF phi names, drawn on ``dev`` (``_Draws``): every
    projection planted at rank 256 with a 0.1-scale bias, LayerNorms the
    identity, the head as slice 1's with a 0.1-scale bias."""
    draws = _Draws(seed, dev)
    planted = draws.planted
    d, hid = cfg.dim, cfg.hidden_dim

    def bias(n: int) -> torch.Tensor:
        return 0.1 * draws.normal(n)

    sd = {"model.embed_tokens.weight": draws.normal(cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        for proj in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj", "self_attn.dense"):
            sd[p + proj + ".weight"], sd[p + proj + ".bias"] = planted(d, d), bias(d)
        sd[p + "mlp.fc1.weight"], sd[p + "mlp.fc1.bias"] = planted(hid, d), bias(hid)
        sd[p + "mlp.fc2.weight"], sd[p + "mlp.fc2.bias"] = planted(d, hid), bias(d)
        sd[p + "input_layernorm.weight"], sd[p + "input_layernorm.bias"] = (draws.full(d, 1.0),
                                                                            draws.full(d, 0.0))
    sd["model.final_layernorm.weight"], sd["model.final_layernorm.bias"] = (draws.full(d, 1.0),
                                                                            draws.full(d, 0.0))
    sd["lm_head.weight"] = draws.normal(cfg.vocab_size, d) / math.sqrt(d)
    sd["lm_head.bias"] = bias(cfg.vocab_size)
    return sd


def phi2_cli_decompose(dev, seed: int, root: pathlib.Path, data: pathlib.Path) -> dict:
    """The trainer CLI's decompose_dwain task on a local phi-2 snapshot (2
    layers, bf16 planted weights, ``model_type: phi``) with
    decompose_dwain_phi2.yaml's values and slice 8's cuts: summary finite,
    parameters cut, SYRK launched and flash not (phi's attention is the
    plain one, as in JAX); the artifact reloads through the trainer's
    builder bit-equal to the saved state dict and to a fresh PhiCausalLM
    given it; that model served with its biased pairs fused (low-rank
    launched) against its pairs and against its unfused f32 twin.  Returns
    the walk's and the serve's launch counts."""
    cfg = phi2_2_layer()
    snap = root / "phi2_snapshot"
    snap.mkdir()
    hf = dict(model_type="phi", architectures=["PhiForCausalLM"], vocab_size=cfg.vocab_size,
              hidden_size=cfg.dim, intermediate_size=cfg.hidden_dim,
              num_hidden_layers=cfg.n_layers, num_attention_heads=cfg.n_heads,
              num_key_value_heads=cfg.n_heads, partial_rotary_factor=cfg.partial_rotary_factor,
              layer_norm_eps=cfg.norm_eps, rope_theta=cfg.rope_theta, hidden_act="gelu_new",
              max_position_embeddings=2048, tie_word_embeddings=False, torch_dtype="bfloat16")
    (snap / "config.json").write_text(json.dumps(hf, indent=2))
    torch.save({k: v.to(torch.bfloat16).cpu() for k, v in planted_phi_weights(cfg, seed, dev).items()},
               snap / "pytorch_model.bin")
    run_cfg = {**trainer_decompose_config(snap, data), "decomposed_model_name": PHI_SNAPSHOT_NAME,
               "decomposed_model_enable_gradient_checkpointing": True,
               "lm_eval_initial": False, "lm_eval_tasks": None}
    cfg_path, out = root / "phi2_decompose.json", root / "phi2_decompose_out"
    cfg_path.write_text(json.dumps(run_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with walk_breakdown() as (attention, fts):
        rc = trainer_run.main(["--config", str(cfg_path), "--output-path", str(out)])
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walk = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    summary = json.loads((out / "summary.json").read_text())
    config = json.loads((out / "decompose_config.json").read_text())
    numbers = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
    if rc != 0 or not all(math.isfinite(v) for v in numbers.values()) \
            or not summary["mparams_frac"] < 100.0 or not config:
        raise AssertionError(f"phi2_cli_decompose: rc {rc}, summary {summary}")
    require_launches(walk, ("syrk_gram",), "phi2_cli_decompose")
    if walk["flash_attention"]:
        raise AssertionError(f"phi2_cli_decompose: phi's attention launched flash: {walk}")

    config_path, sd_path = out / "decompose_config.json", out / "decompose_state_dict.pt"
    saved = utils.load_state_dict_pt(str(sd_path))
    model, tok = trainer_artifact_reload(run_cfg, config_path, sd_path, dev)
    if not isinstance(model, models.PhiCausalLM):
        raise AssertionError(f"phi2_cli_decompose: the builder made {type(model)}")
    reloaded = utils.state_dict(model)
    if reloaded.keys() != saved.keys() or not all(torch.equal(reloaded[k], saved[k]) for k in saved):
        raise AssertionError("phi2_cli_decompose: the artifact did not reload bit-equal")
    del reloaded
    fresh = causal_lm(cfg, dev)
    utils.apply_decompose_config(fresh, config)
    utils.load_state_dict(fresh, saved)
    model.eval()
    text = "\n\n".join(json.loads(line)["text"] for line in data.read_text().splitlines()[:60])
    probe = {"input_ids": torch.tensor(tok(text)["input_ids"][:SEQ], device=dev)[None]}
    ops.reset_launch_counts()
    with torch.no_grad():
        y_pairs = model(probe)
        fresh_equal = logits_agree(fresh(probe), y_pairs, 0.0, 0.0, "phi2_fresh_reload")
        del fresh
        pnn.fuse_factor_pairs(model)
        y_fused = model(probe)
    torch.cuda.synchronize()
    serve_counts = ops.launch_counts()
    require_launches(serve_counts, ("lowrank_matmul",), "phi2_cli_decompose serve")
    serve = logits_agree(y_fused, y_pairs, *FAMILY_GATES["phi2"]["serve"], "phi2_serve")
    fused = [m for m in model.modules() if isinstance(m, pnn.FusedLowRankLinear)]
    twin = f32_twin(model)
    ops.reset_launch_counts()
    with torch.no_grad():
        y32 = twin(probe)
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"phi2_cli_decompose: the f32 twin launched {ops.launch_counts()}")
    vs_f32 = logits_agree(y_fused, y32, *FAMILY_GATES["phi2"]["reference"], "phi2_vs_f32")
    del twin, y32
    torch.cuda.empty_cache()
    ft_s = sum(f.seconds for f in fts)
    emit({"phase": "phi2_cli_decompose", "layers": cfg.n_layers, "wall_s": wall,
          "time_decomposition": summary["time_decomposition"],
          "ppl_initial": summary["ppl_initial"], "ppl_final": summary["ppl_final"],
          "mparams_frac": summary["mparams_frac"], "gflops_frac": summary["gflops_frac"],
          "device": summary["device"], "decomposed": len(config),
          "ranks": {k: v["modules"]["0"]["out_features"] for k, v in config.items()},
          "biased_fused": sum(m.bias is not None for m in fused), "fused": len(fused),
          "finetune_s": ft_s, "finetune_calls": sum(f.calls for f in fts),
          "plain_attention_s": attention.seconds(), "plain_attention_calls": len(attention.events),
          "peak_memory_gb": peak / 1e9, "fresh_reload": fresh_equal, "serve": serve,
          "fused_vs_f32": vs_f32, "walk_launches": walk, "serve_launches": serve_counts,
          "nvidia_smi": nvidia_smi()})
    return {"phi2_cli_decompose": walk, "phi2_serve": serve_counts}


# Block pruning on slice 1's model: layer 1's attention and layer 0's MLP
BP_ATTN, BP_MLP = [1], [0]
BP_BUILDER = "ptdeco_tpu_torch/apps/trainer_llm/examples_builder/bp_checkpoint_builder.py"


def bp_checkpoint_builder():
    """The trainer's block-pruned checkpoint builder, loaded from its file as
    the trainer loads a custom builder."""
    path = pathlib.Path(__file__).resolve().parent / BP_BUILDER
    spec = importlib.util.spec_from_file_location("bp_checkpoint_builder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bp_tinyllama(dev, seed: int, root: pathlib.Path, snap: pathlib.Path) -> dict[str, dict]:
    """Block pruning on slice 1's model (the trainer phases' snapshot, built
    through the trainer's builder): ``models.prune_blocks`` of layer 1's
    attention and layer 0's MLP; the pruned weights written as a
    bp_checkpoint_builder directory (bp_config.json +
    state_dict.safetensors) and rebuilt through that builder bit-equal;
    ``dwain.decompose`` on the rebuilt model (SYRK and flash launched for
    the surviving sites only, no site in a pruned sublayer); the artifact
    reloaded bit-equal into the builder's pruned model; the fused serve
    against its pairs and against the model in f32 on the CPU; and the KV
    cache refusing the pruned attention, as the JAX package does."""
    t_phase = time.perf_counter()
    split = {}

    def lap(part: str) -> None:
        torch.cuda.synchronize()
        split[part] = time.perf_counter() - t_phase - sum(split.values())

    original, _ = trainer_builder.make_model_and_tokenizer(
        model_name=str(snap), dtype="bfloat16", checkpoint_path=str(snap), device=dev)
    n_sites_before = len(engine.get_decomposeable_submodule_names(original, ["lm_head"]))
    pruned = models.prune_blocks(original, attn_indices=BP_ATTN, mlp_indices=BP_MLP)
    bp_dir = root / "bp_checkpoint"
    bp_dir.mkdir()
    (bp_dir / "bp_config.json").write_text(
        json.dumps({"attn_indices": BP_ATTN, "mlp_indices": BP_MLP}))
    utils.save_state_dict_safetensors(utils.state_dict(pruned),
                                      str(bp_dir / "state_dict.safetensors"))
    builder = bp_checkpoint_builder()
    model, _ = builder.make_model_and_tokenizer(
        {"bp_model_path": str(bp_dir), "hf_checkpoint_path": str(snap), "seed": seed})
    model = model.to(dev)
    vocab = model.model.embed_tokens.weight.shape[0]
    probe = utils.to_device(next(token_batches(vocab, seed + 3)), dev)
    with torch.no_grad():
        rebuilt = logits_agree(model(probe), pruned(probe), 0.0, 0.0, "bp_tinyllama_rebuilt")
    del original, pruned
    torch.cuda.empty_cache()
    sites = engine.get_decomposeable_submodule_names(model, ["lm_head"])
    pruned_prefixes = tuple([f"model.layers.{i}.self_attn." for i in BP_ATTN]
                            + [f"model.layers.{i}.mlp." for i in BP_MLP])
    if any(n.startswith(pruned_prefixes) for n in sites):
        raise AssertionError(f"bp_tinyllama: a pruned sublayer holds a site: {sites}")
    lap("build")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    model, config = dwain.decompose(
        module=model, data_iterator=token_batches(vocab, seed + 1),
        metric_iterator=token_batches(vocab, seed + 2), loss_fn=models.ce_loss, device=dev,
        **DECOMPOSE_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    walk = ops.launch_counts()
    require_launches(walk, ("syrk_gram", "flash_attention"), "bp_tinyllama decompose")
    if not config:
        raise AssertionError("bp_tinyllama: no site decomposed")
    lap("walk")

    art = root / "bp_artifact"
    art.mkdir()
    (art / "decompose_config.json").write_text(json.dumps(config))
    utils.save_state_dict_pt(utils.state_dict(model), str(art / "decompose_state_dict.pt"))
    fresh, _ = builder.make_model_and_tokenizer(
        {"bp_model_path": str(bp_dir), "hf_checkpoint_path": str(snap), "seed": seed,
         "bp_load_state_dict": False})
    fresh = trainer_builder.apply_decompose_config_and_state_dict(
        fresh.to(dev), str(art / "decompose_config.json"), str(art / "decompose_state_dict.pt"))
    with torch.no_grad():
        y_pairs = model(probe)
        artifact = logits_agree(fresh(probe), y_pairs, 0.0, 0.0, "bp_tinyllama_artifact")
    del fresh
    lap("artifact")

    with torch.no_grad():
        ops.reset_launch_counts()
        pnn.fuse_factor_pairs(model)
        y_fused = model(probe)
    torch.cuda.synchronize()
    serve_counts = ops.launch_counts()
    require_launches(serve_counts, ("lowrank_matmul", "flash_attention"), "bp_tinyllama serve")
    serve = logits_agree(y_fused, y_pairs, FUSED_MAX_ABS, FUSED_RMS_REL, "bp_tinyllama_serve")
    del y_pairs, y_fused
    try:
        serving.generate(model, probe["input_ids"][:, :16], 2)
    except ValueError as e:
        if "PrunedSublayer" not in str(e):
            raise
        refused = str(e)
    else:
        raise AssertionError("bp_tinyllama: the KV cache took a pruned attention")
    lap("serve")

    short = {"input_ids": probe["input_ids"][:, :128]}
    with torch.no_grad():
        y_card = model(short).float().cpu()
        y_cpu = model.to("cpu", torch.float32)(utils.to_device(short, "cpu"))
    ref = logits_agree(y_card, y_cpu, REF_MAX_ABS, REF_RMS_REL, "bp_tinyllama_reference")
    lap("reference")
    emit({"phase": "bp_tinyllama", "pruned": {"attn": BP_ATTN, "mlp": BP_MLP},
          "sites": [n_sites_before, len(sites)], "decomposed": len(config), "wall_s": wall,
          "ranks": {k: v["modules"]["0"]["out_features"] for k, v in config.items()},
          "rebuilt": rebuilt, "artifact": artifact, "serve": serve, "reference": ref,
          "cache_refusal": refused, "walk_launches": walk, "serve_launches": serve_counts,
          "split_s": split, "phase_wall_s": time.perf_counter() - t_phase})
    del model
    torch.cuda.empty_cache()
    return {"bp_tinyllama_decompose": walk, "bp_tinyllama_serve": serve_counts}


class CardPipeline:
    """``SyntheticImagePipeline``'s batches, made once from the seed and
    held on the card as tensors (the trainers take them as they take the
    numpy batches), so that drawing a batch costs neither the host's
    random draws nor a copy."""

    def __init__(self, batch: int, n_batches: int, seed: int, dev) -> None:
        pipe = vision_data.SyntheticImagePipeline(batch, (VISION_HW, VISION_HW), 1000, n_batches,
                                                  seed=seed)
        self.batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in pipe]

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def plant_sites(model: torch.nn.Module, names: list[str], rng) -> None:
    """Each named Linear or 1x1 conv ``A @ B / sqrt(r * d_in)`` plus 1%
    noise at r = full_rank // 4, as ``planted_resnet50`` plants them."""
    f32 = np.float32
    with torch.no_grad():
        for name in names:
            w = pnn.get_submodule(model, name).weight
            d_out, d_in = w.shape[:2]
            r = min(d_in, d_out) // 4
            planted = (rng.standard_normal((d_out, r), dtype=f32)
                       @ rng.standard_normal((r, d_in), dtype=f32)) / np.sqrt(r * d_in, dtype=f32)
            planted += 0.01 * rng.standard_normal((d_out, d_in), dtype=f32) / np.sqrt(d_in, dtype=f32)
            w.copy_(torch.from_numpy(planted).reshape(w.shape))


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, batches: list[torch.Tensor]) -> None:
    """Every BatchNorm's running statistics set to its own input's over the
    batches (one train-mode f32 forward each, cumulative averages)."""
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None
    model.train()
    for x in batches:
        model(x)
    for m in bns:
        m.momentum = 0.1
    model.eval()


def planted_vision_weights(name: str, seed: int, dev, root: pathlib.Path) -> tuple[str, int]:
    """A ``.pt`` of the named model's planted weights, as the CLI loads it
    through ``decompose_model_checkpoint_path``, and the model's count of
    decomposable sites: those sites planted (not Swin's 2-wide
    position-bias MLPs nor EfficientFormer's 8-wide talking heads), the
    layer scales (init 1e-6 / 1e-5) at ``VISION_BRANCH_SCALE`` so that the
    blocks' branches count, and the BatchNorms calibrated on two batches
    as ``planted_resnet50`` calibrates them (ResNet-18's residual branches
    end at scale ``RN_BRANCH_GAMMA``)."""
    model = vision_builder.make_model(name, seed=seed, input_h_w=(VISION_HW, VISION_HW),
                                      device=dev)
    rng = np.random.default_rng(seed)
    sites = engine.get_decomposeable_submodule_names(model)
    plant_sites(model, [s for s in sites if not s.endswith(
        ("cpb_fc1", "cpb_fc2", "talking_head1", "talking_head2"))], rng)
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n.endswith((".gamma", ".ls1", ".ls2")):
                p.fill_(VISION_BRANCH_SCALE)
        for m in model.modules():
            if isinstance(m, models.resnet.BasicBlock):
                m.bn2.weight.fill_(RN_BRANCH_GAMMA)
    if any(isinstance(m, torch.nn.BatchNorm2d) for m in model.modules()):
        calibrate_batchnorm(model, image_batches(seed + 30, 2, 64, dev, torch.float32))
    path = root / f"{name}-planted.pt"
    utils.save_state_dict_pt(utils.state_dict(model), str(path))
    del model
    torch.cuda.empty_cache()
    return str(path), len(sites)


def vision_cfg(task_values: dict, name: str, weights: str, batch: int) -> dict:
    """A run config: the shipped yaml's values with the model and weights
    swapped in and the ImageNet folders named but unused (the synthetic
    pipeline replaces them)."""
    return {**task_values, "decompose_model_name": name, "decompose_model_checkpoint_path": weights,
            "imagenet_root_dir": "/data/imagenet",
            "trn_imagenet_classes_fname": "/data/imagenet/train_classes.txt",
            "val_imagenet_classes_fname": "/data/imagenet/val_classes.txt",
            "batch_size": batch, "normalization": "imagenet", "input_h_w": [VISION_HW, VISION_HW]}


def vision_cli(run_cfg: dict, root: pathlib.Path, what: str, pipes,
               out: pathlib.Path | None = None) -> dict:
    """The CLI in process on ``run_cfg``: its wall, launches, peak memory,
    summary and config; every summary number finite."""
    cfg_path, out = root / f"{what}.json", out or root / what
    cfg_path.write_text(json.dumps(run_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = vision_run.main(["--config", str(cfg_path), "--output-path", str(out)], *pipes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    summary = json.loads((out / "summary.json").read_text())
    numbers = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
    if rc != 0 or not all(math.isfinite(v) for v in numbers.values()):
        raise AssertionError(f"{what}: rc {rc}, summary {summary}")
    return {"out": out, "wall_s": wall, "launches": ops.launch_counts(),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "summary": summary,
            "config": json.loads((out / "decompose_config.json").read_text())}


def vision_reload(run_cfg: dict, out: pathlib.Path, dev,
                  state_dict: str = "decompose_state_dict.pt") -> torch.nn.Module:
    """The artifact onto a fresh model from the builder (the run's weights),
    every key consumed and reloaded bit-equal; channels_last, eval mode."""
    model = vision_builder.make_model(
        run_cfg["decompose_model_name"], checkpoint_path=run_cfg["decompose_model_checkpoint_path"],
        input_h_w=tuple(run_cfg["input_h_w"]), device=dev)
    utils.apply_decompose_config(model, json.loads((out / "decompose_config.json").read_text()))
    saved = utils.load_state_dict_pt(str(out / state_dict))
    utils.load_state_dict(model, saved)
    sd = utils.state_dict(model)
    if sd.keys() != saved.keys() or not all(torch.equal(sd[k], saved[k]) for k in saved):
        raise AssertionError(f"{out}: the artifact did not reload bit-equal")
    return model.to(memory_format=torch.channels_last).eval()


def fusable_pairs(config: dict) -> int:
    """The config's pairs ``fuse_factor_pairs`` takes: two Linears, or two
    plain 1x1 convs."""
    def plain(m: dict) -> bool:
        return "in_features" in m or (m.get("kernel_size") == [1, 1] and m.get("stride") == [1, 1]
                                      and m.get("padding") in ([0, 0], 0))
    return sum(plain(c["modules"]["0"]) and plain(c["modules"]["1"]) for c in config.values())


def vision_serve(model, probe: torch.Tensor, what: str, gates: tuple[float, float],
                 config: dict) -> tuple[dict, dict[str, int]]:
    """The reloaded artifact's f32 logits finite, then a bf16
    channels_last copy served with its pairs fused against its pairs
    (``resnet_fused_serve``: one low-rank launch for each fused pair, no
    input copied into rows), every pair the kernel takes fused."""
    with torch.no_grad():
        y32 = model(probe.float())
    if not torch.isfinite(y32).all() or tuple(y32.shape) != (probe.shape[0], 1000):
        raise AssertionError(f"{what}: f32 logits {tuple(y32.shape)} not finite")
    served = copy.deepcopy(model).to(torch.bfloat16, memory_format=torch.channels_last)
    rec, counts = resnet_fused_serve(served, probe.to(torch.bfloat16), what, *gates)
    if rec["fused_pairs"] != fusable_pairs(config):
        raise AssertionError(f"{what}: {rec['fused_pairs']} fused pairs of "
                             f"{fusable_pairs(config)} the kernel takes")
    # how much the logits vary across the images: the gates' scale
    return {**rec, "logits_batch_std": float(y32.std(dim=0).mean()),
            "logits_rms": float(y32.square().mean().sqrt())}, counts


def ranks(config: dict) -> dict[str, int]:
    def rank(m: dict) -> int:
        return m.get("out_features", m.get("out_channels"))
    return {k: rank(v["modules"]["0"]) for k, v in config.items()}


def trainer_vision_dwain(dev, seed: int, root: pathlib.Path, what: str, name: str,
                         task_values: dict, batch: int, gates: tuple[float, float]) -> dict[str, int]:
    """The CLI's decompose_dwain task (f32, as shipped) on the planted
    model: sites decomposed and parameters cut, the artifact reloaded
    bit-equal, its bf16 copy served fused.  The f32 walk reaches no kernel
    (SYRK takes bf16 activations); its launches are recorded."""
    weights, n_sites = planted_vision_weights(name, seed, dev, root)
    run_cfg = vision_cfg(task_values, name, weights, batch)
    pipes = (CardPipeline(batch, VISION_POOL, seed + 31, dev), CardPipeline(batch, 1, seed + 32, dev))
    with pipelined_eigh_log() as eighs:
        run = vision_cli(run_cfg, root, what, pipes)
    summary, config = run["summary"], run["config"]
    rec = {"phase": what, "wall_s": run["wall_s"], "batch": batch, "sites": n_sites,
           "time_decomposition": summary["time_decomposition"], "decomposed": len(config),
           "ranks": ranks(config), "mparams_frac": summary["mparams_frac"],
           "gflops_frac": summary["gflops_frac"], "accuracy_initial": summary["accuracy_initial"],
           "accuracy_final": summary["accuracy_final"], **overlap(eighs),
           "peak_memory_gb": run["peak_memory_gb"], "walk_launches": run["launches"],
           "device": summary["device"]}
    if not config or not summary["mparams_frac"] < 100.0:
        emit({**rec, "ok": False})
        raise AssertionError(f"{what}: {len(config)} sites decomposed, summary {summary}")
    model = vision_reload(run_cfg, run["out"], dev)
    probe = vision_metrics.nchw(pipes[1].batches[0]["inputs"], dev)
    rec["serve"], serve_counts = vision_serve(model, probe, what + "_serve", gates, config)
    del model, pipes
    torch.cuda.empty_cache()
    counts = {k: run["launches"][k] + serve_counts[k] for k in serve_counts}
    require_launches(counts, ("lowrank_matmul",), what)
    emit({**rec, "launches": counts})
    return counts


def pointwise_teacher(m: torch.nn.Module) -> torch.nn.Module | None:
    """A wrapped layer's teacher if it is a Linear or a plain 1x1 conv."""
    t = m.lin_orig if isinstance(m, lockd.WrappedLOCKDLinear) else m.conv_orig
    if isinstance(t, torch.nn.Linear) or (t.kernel_size == (1, 1) and t.stride == (1, 1)
                                          and t.padding in ((0, 0), 0)):
        return t
    return None


@torch.no_grad()
def plant_students(m: torch.nn.Module, teacher: torch.nn.Module) -> None:
    """Close every other gate of a wrapped pointwise layer and set its
    student to the teacher's truncated SVD on the open channels (as many
    as the kept rank, which covers the planted full_rank // 4)."""
    w = teacher.weight.float().reshape(teacher.weight.shape[0], -1)
    u, sv, vh = torch.linalg.svd(w, full_matrices=False)
    kept = torch.arange(0, m.logits.numel(), 2, device=w.device)
    r = kept.numel()
    first, second = (m.lin_0, m.lin_1) if isinstance(m, lockd.WrappedLOCKDLinear) else (
        m.conv_1, m.conv_2)
    f = torch.zeros(first.weight.shape[0], w.shape[1], device=w.device)
    g = torch.zeros(w.shape[0], second.weight.shape[1], device=w.device)
    f[kept] = sv[:r, None].sqrt() * vh[:r]
    g[:, kept] = u[:, :r] * sv[:r].sqrt()
    first.weight.copy_(f.reshape(first.weight.shape))
    second.weight.copy_(g.reshape(second.weight.shape))
    if teacher.bias is not None:
        second.bias.copy_(teacher.bias)
    m.logits.fill_(3.0)
    m.logits[1::2] = -3.0


@contextlib.contextmanager
def planted_lockd_gates(record: dict):
    """The lockd task's decomposition, planted: the cut run's 31 steps
    leave the gates open (every layer would revert) and the students near
    their random start, so before ``lockd.decompose`` (wrapped for the
    block) each pointwise layer's gates are half closed and its student
    set to the teacher's truncated SVD on the open half
    (``plant_students``); the 3x3 convs keep their trained gates.
    ``record`` gets how many layers the trained gates would have
    decomposed, the wrapped and the planted counts."""
    decompose = lockd.decompose

    def planted(module, proportion_threshold, blacklisted_module_names=None):
        wrapped = list(lockd.named_wrapped_modules(module))
        record["trained_would_decompose"] = sum(
            float(torch.sigmoid(m.logits.detach().float()).mean()) < proportion_threshold
            for _, m in wrapped)
        record["wrapped"] = len(wrapped)
        record["planted"] = 0
        for _, m in wrapped:
            teacher = pointwise_teacher(m)
            if teacher is not None:
                plant_students(m, teacher)
                record["planted"] += 1
        return decompose(module, proportion_threshold, blacklisted_module_names)

    lockd.decompose = planted
    try:
        yield record
    finally:
        lockd.decompose = decompose


def trainer_vision_lockd_efficientformer(dev, seed: int, root: pathlib.Path) -> tuple:
    """The CLI's decompose_lockd task on the planted EfficientFormerV2-S0
    (bf16 over f32 masters, batch 256, the lockd yaml's loss, AdamW,
    cosine schedule and clipping; 31 steps), its pointwise layers' gates
    then half closed over SVD students (``planted_lockd_gates``): each of
    them decomposed, the artifact reloaded bit-equal, its bf16 copy
    served fused (the 1x1-conv and head pairs).  Returns the launch
    counts, the run config and the output directory."""
    weights, n_sites = planted_vision_weights("efficientformerv2_s0", seed, dev, root)
    run_cfg = vision_cfg(LOCKD_EF, "efficientformerv2_s0", weights, LOCKD_BATCH)
    pipes = (CardPipeline(LOCKD_BATCH, EF_POOL, seed + 33, dev),
             CardPipeline(EF_VAL_BATCH, 1, seed + 34, dev))
    planted: dict = {}
    with planted_lockd_gates(planted):
        run = vision_cli(run_cfg, root, "trainer_vision_lockd_efficientformer", pipes)
    summary, config = run["summary"], run["config"]
    metrics0 = json.loads((run["out"] / "metrics.jsonl").read_text().splitlines()[0])
    steps = vision_config.parse_duration(LOCKD_EF["max_duration"], EF_POOL)
    rec = {"phase": "trainer_vision_lockd_efficientformer", "wall_s": run["wall_s"],
           "batch": LOCKD_BATCH, "steps": steps, "time_training": summary["time_training"],
           "step_ms": summary["time_training"] * 1e3 / steps, "sites": n_sites, **planted,
           "decomposed": len(config), "loss_step0": metrics0["loss"],
           "peak_memory_gb": run["peak_memory_gb"], "train_launches": run["launches"],
           "device": summary["device"]}
    if len(config) < planted["planted"] or not math.isfinite(metrics0["loss"]):
        emit({**rec, "ok": False})
        raise AssertionError(f"trainer_vision_lockd_efficientformer: {len(config)} layers "
                             f"decomposed, {planted['planted']} planted, step-0 loss "
                             f"{metrics0['loss']}")
    model = vision_reload(run_cfg, run["out"], dev)
    probe = vision_metrics.nchw(pipes[1].batches[0]["inputs"], dev)
    rec["serve"], serve_counts = vision_serve(model, probe, "trainer_vision_lockd_efficientformer_serve",
                                              EF_FUSED_GATES, config)
    del model, pipes
    torch.cuda.empty_cache()
    counts = {k: run["launches"][k] + serve_counts[k] for k in serve_counts}
    require_launches(counts, ("lowrank_matmul",), "trainer_vision_lockd_efficientformer")
    emit({**rec, "launches": counts})
    return counts, run_cfg, run["out"]


def trainer_vision_finetune(dev, seed: int, root: pathlib.Path, lockd_cfg: dict,
                            artifact: pathlib.Path) -> dict[str, int]:
    """The CLI's finetune task (finetune_kd_resnet50.yaml's training values:
    bf16, KD against the original, AdamW, cosine, norm clipping) on the
    EfficientFormerV2 artifact, ``FINETUNE_EF_STEPS`` steps checkpointed
    every ``EF_POOL``: then the run resumed from its checkpoint of step
    ``EF_POOL - 1`` (a stop at step ``EF_POOL``; an epoch is ``EF_POOL``
    batches, so the resumed data stream lines up) must end with the
    trainable tensors and BatchNorm statistics of the unbroken run, within
    ``RESUME_REL`` of each tensor's largest value."""
    run_cfg = {**vision_cfg(FINETUNE_EF, lockd_cfg["decompose_model_name"],
                            lockd_cfg["decompose_model_checkpoint_path"], LOCKD_BATCH),
               "decompose_config": str(artifact / "decompose_config.json"),
               "decompose_state_dict": str(artifact / "decompose_state_dict.pt")}
    pipes = (CardPipeline(LOCKD_BATCH, EF_POOL, seed + 35, dev),
             CardPipeline(EF_VAL_BATCH, 1, seed + 34, dev))
    full = vision_cli(run_cfg, root, "trainer_vision_finetune", pipes)
    resumed_out = root / "trainer_vision_finetune_resumed"
    ck = f"step_{EF_POOL - 1:09d}.pt"
    (resumed_out / "checkpoints").mkdir(parents=True)
    shutil.copy(full["out"] / "checkpoints" / ck, resumed_out / "checkpoints" / ck)
    resumed = vision_cli(run_cfg, root, "trainer_vision_finetune_resumed", pipes, out=resumed_out)
    a = utils.load_state_dict_pt(str(full["out"] / "finetuned_state_dict.pt"))
    b = utils.load_state_dict_pt(str(resumed_out / "finetuned_state_dict.pt"))
    kept = full["config"]
    trained = [k for k in a if k.rsplit(".", 2)[0] in kept or k.endswith(("running_mean", "running_var"))]
    worst = max(float((a[k].float() - b[k].float()).abs().max() / a[k].float().abs().max().clamp_min(1e-30))
                for k in trained)
    steps = vision_config.parse_duration(FINETUNE_EF["max_duration"], EF_POOL)
    rec = {"phase": "trainer_vision_finetune", "wall_s": full["wall_s"],
           "resumed_wall_s": resumed["wall_s"], "batch": LOCKD_BATCH, "steps": steps,
           "step_ms": full["summary"]["time_training"] * 1e3 / steps,
           "n_decomposed": full["summary"]["n_decomposed"], "trained_tensors": len(trained),
           "resume_max_rel_diff": worst, "limit_resume_rel": RESUME_REL,
           "accuracy_initial": full["summary"]["accuracy_initial"],
           "accuracy_final": full["summary"]["accuracy_final"],
           "peak_memory_gb": full["peak_memory_gb"], "launches": full["launches"],
           "device": full["summary"]["device"]}
    if a.keys() != b.keys() or not trained or not worst <= RESUME_REL:
        emit({**rec, "ok": False})
        raise AssertionError(f"trainer_vision_finetune: the resumed run ends {worst} from the "
                             "unbroken one")
    emit(rec)
    del pipes
    torch.cuda.empty_cache()
    return full["launches"]


def trainer_vision_falor_resnet18(dev, seed: int, root: pathlib.Path) -> dict[str, int]:
    """The CLI's decompose_falor task as decompose_falor_resnet18.yaml ships
    it (f32, batch 64, 16 data and 8 metric steps) on a planted ResNet-18:
    every planted site (the three strided downsamples and the fc)
    decomposed, the artifact reloaded bit-equal, its bf16 copy served with
    the fc fused (the strided pairs stay pairs)."""
    weights, n_sites = planted_vision_weights("resnet18", seed, dev, root)
    run_cfg = vision_cfg(FALOR_RN18, "resnet18", weights, RN_BATCH)
    pipes = (CardPipeline(RN_BATCH, VISION_POOL, seed + 36, dev),
             CardPipeline(RN_BATCH, 1, seed + 37, dev))
    run = vision_cli(run_cfg, root, "trainer_vision_falor_resnet18", pipes)
    summary, config = run["summary"], run["config"]
    rec = {"phase": "trainer_vision_falor_resnet18", "wall_s": run["wall_s"], "batch": RN_BATCH,
           "sites": n_sites, "decomposed": len(config), "ranks": ranks(config),
           "time_decomposition": summary["time_decomposition"], "time_eval": summary["time_eval"],
           "mparams_frac": summary["mparams_frac"], "kmapps_frac": summary["kmapps_frac"],
           "peak_memory_gb": run["peak_memory_gb"], "walk_launches": run["launches"],
           "device": summary["device"]}
    if len(config) != n_sites:
        emit({**rec, "ok": False})
        raise AssertionError(f"trainer_vision_falor_resnet18: {len(config)} of {n_sites} sites")
    model = vision_reload(run_cfg, run["out"], dev)
    probe = vision_metrics.nchw(pipes[1].batches[0]["inputs"], dev)
    rec["serve"], serve_counts = vision_serve(model, probe, "trainer_vision_falor_resnet18_serve",
                                              (RN_FUSED_MAX_ABS, RN_FUSED_RMS_REL), config)
    del model, pipes
    torch.cuda.empty_cache()
    counts = {k: run["launches"][k] + serve_counts[k] for k in serve_counts}
    emit({**rec, "launches": counts})
    return counts


def trainer_vision(dev, seed: int) -> dict[str, dict[str, int]]:
    """Slice 11's five phases, with the CLI's logging put back after, in one
    temp directory; their launch counts by phase."""
    cut_models()
    with tempfile.TemporaryDirectory() as tmp, restored_logging():
        root = pathlib.Path(tmp)
        out = {
            "trainer_vision_dwain_convnext": trainer_vision_dwain(
                dev, seed, root, "trainer_vision_dwain_convnext", CONVNEXT_CUT, DWAIN_CONVNEXT,
                DWAIN_CONVNEXT_BATCH, CONVNEXT_FUSED_GATES),
            "trainer_vision_dwain_swinv2": trainer_vision_dwain(
                dev, seed, root, "trainer_vision_dwain_swinv2", SWIN_CUT, DWAIN_SWIN,
                DWAIN_SWIN_BATCH, SWIN_FUSED_GATES),
        }
        out["trainer_vision_lockd_efficientformer"], lockd_cfg, artifact = \
            trainer_vision_lockd_efficientformer(dev, seed, root)
        out["trainer_vision_finetune"] = trainer_vision_finetune(dev, seed, root, lockd_cfg, artifact)
        out["trainer_vision_falor_resnet18"] = trainer_vision_falor_resnet18(dev, seed, root)
    torch.cuda.empty_cache()
    return out


def vision_kernel_checks(dev, recs: dict[str, list[dict]]) -> None:
    """SYRK and the low-rank kernel at slice 11's shapes, in bf16: the Grams
    of ConvNeXt-Tiny's stage-1 pwconv1 (batch 64, 56 x 56 pixels, d 384)
    and stage-4 pwconv1 (7 x 7, d 3072) and SwinV2-Tiny's stage-1 fc1
    (batch 80, 3136 tokens, d 384); the fused pairs at full_rank // 4 of
    ConvNeXt's stage-1 pwconv1 and stage-4 pwconv2, and of
    EfficientFormerV2-S0's widest 1x1 convs (stage 4's v, 176 -> 1024, and
    proj, 1024 -> 176, at batch 256's 7 x 7 pixels) as lockd's half-closed
    students leave them (rank 88)."""
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    for n, d_in, d, what in ((200704, 96, 384, "convnext stage1 pwconv1"),
                             (3136, 768, 3072, "convnext stage4 pwconv1"),
                             (250880, 96, 384, "swinv2 stage1 fc1")):
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        w = (torch.randn(d, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf)
        y = x @ w.t()
        recs["syrk_gram"].append(check_kernel(
            "syrk_gram",
            lambda: ops.syrk_gram(y),
            lambda: ops.syrk_gram_plain(y),
            lambda: y.t() @ y,
            flops=n * d * d,
            nbytes=n * d * 2 + d * d * 4,
            tol_fn=lambda ref: torch.full_like(ref, 1e-4 * float(ref.abs().max())),
            shape={"what": what, "N": n, "d": d, "dtype": "bf16"},
            graph=True, extra_fns={"y_matmul": lambda: x @ w.t()},
        ))
        del x, w, y
        torch.cuda.empty_cache()
    for n, d_in, r, d_out, with_bias, what in (
            (200704, 96, 24, 384, True, "convnext stage1 pwconv1"),
            (3136, 3072, 192, 768, True, "convnext stage4 pwconv2"),
            (12544, 176, 88, 1024, False, "efficientformerv2 stage4 v"),
            (12544, 1024, 88, 176, False, "efficientformerv2 stage4 proj")):
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        bias = torch.randn(d_out, device=dev, generator=g).to(bf) if with_bias else None
        k1 = (torch.randn(r, d_in, device=dev, generator=g) / d_in ** 0.5).to(bf).t()
        k2 = (torch.randn(d_out, r, device=dev, generator=g) / r ** 0.5).to(bf).t()
        recs["lowrank_matmul"].append(check_kernel(
            "lowrank_matmul",
            lambda: ops.lowrank_matmul(x, k1, k2, bias),
            lambda: ops.lowrank_matmul_plain(x, k1, k2, bias),
            lambda: (x @ k1) @ k2 if bias is None else torch.addmm(bias, x @ k1, k2),
            flops=2 * n * r * (d_in + d_out),
            nbytes=2 * (n * d_in + r * d_in + r * d_out + d_out * with_bias + n * d_out),
            tol_fn=lambda ref: 2.0 ** -6 * (ref.abs() + ref.square().mean().sqrt()),
            shape={"what": what, "n": n, "d_in": d_in, "r": r, "d_out": d_out,
                   "bias": with_bias, "dtype": "bf16"},
            graph=True,
        ))
        del x, k1, k2, bias
        torch.cuda.empty_cache()


def cut_models() -> None:
    """The depth-cut ConvNeXt-Tiny and SwinV2-Tiny under names of their own
    (the CLI builds the model by name)."""
    vision_builder.register_model(
        CONVNEXT_CUT, lambda num_classes=1000, **kw: models.ConvNeXt(
            CONVNEXT_DEPTHS, (96, 192, 384, 768), num_classes, **kw))

    def swin_cut(num_classes=1000, image_size=224, **kw):
        return models.SwinV2(image_size, 4, 96, SWIN_DEPTHS, (3, 6, 12, 24), 7, num_classes, **kw)

    vision_builder.register_model(SWIN_CUT, swin_cut)


def profiler(out_dir):
    if not out_dir:
        return contextlib.nullcontext()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def write_profile(prof, path: pathlib.Path, wall_s: float) -> None:
    """Device time by kernel name, and the device's busy share of the wall."""
    events = prof.key_averages()
    busy_us = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"wall_s {wall_s}  device_busy_s {busy_us / 1e6}  "
                f"busy_share {busy_us / 1e6 / wall_s}\n")
        f.write(events.table(sort_by="self_device_time_total", row_limit=40, max_name_column_width=90))
    emit({"phase": "profile", "path": str(path), "device_busy_s": busy_us / 1e6,
          "busy_share": busy_us / 1e6 / wall_s})


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile", metavar="DIR",
                        help="profile the decompose phase with torch.profiler and write "
                             "its kernel table to DIR/profile_decompose.txt")
    args = parser.parse_args()
    dev = torch.device("cuda")
    # the f32 references run in full f32 (not TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda, "package": ptt.__version__})

    t0 = time.perf_counter()
    build_s = _build.build_all()
    for name in _build.KERNELS:
        _build.load_library(name)
    emit({"phase": "build", "seconds": build_s, "wall_s": time.perf_counter() - t0,
          "dir": str(_build.BUILD_DIR)})

    recs = kernel_checks(dev)
    moe_kernel_checks(dev, recs)
    resnet_kernel_checks(dev, recs)
    vision_kernel_checks(dev, recs)

    # --- main path: decompose -> artifact -> serve ----------------------
    cfg = tinyllama_2_layer()
    weights = planted_rank_weights(cfg, args.seed, dev)
    model = utils.load_state_dict(models.CausalLM(cfg, device=dev), weights)
    n_sites = len(engine.get_decomposeable_submodule_names(model, ["lm_head"]))
    params_before = utils.get_num_params(model)
    probe = utils.to_device(next(token_batches(cfg.vocab_size, args.seed + 3)), dev)

    ops.reset_launch_counts()
    prof = profiler(args.profile)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        model, config = dwain.decompose(
            module=model,
            data_iterator=token_batches(cfg.vocab_size, args.seed + 1),
            metric_iterator=token_batches(cfg.vocab_size, args.seed + 2),
            loss_fn=models.ce_loss,
            device=dev,
            **DECOMPOSE_ARGS,
        )
        torch.cuda.synchronize()
    deco_s = time.perf_counter() - t0
    if args.profile:
        write_profile(prof, pathlib.Path(args.profile) / "profile_decompose.txt", deco_s)
    counts = ops.launch_counts()
    params_after = utils.get_num_params(model)
    emit({"phase": "decompose", "wall_s": deco_s, "sites": n_sites,
          "decomposed": len(config), "params_before": params_before,
          "params_after": params_after, "param_fraction": params_after / params_before,
          "proportions": {k: v["__meta__"]["proportion"] for k, v in config.items()},
          "launches": counts})
    if not (counts["syrk_gram"] > 0 and counts["flash_attention"] > 0 and len(config) > 0):
        raise AssertionError(f"decompose did not run the kernels or decompose a site: {counts}")

    with torch.no_grad():
        y_pairs = model(probe)
    emit({"phase": "artifact", **artifact_round_trip(model, config, cfg, probe, dev, "artifact")})

    before = ops.lowrank_matmul.launches
    pnn.fuse_factor_pairs(model)
    with torch.no_grad():
        y_fused = model(probe)
        ce_fused = float(models.ce_loss(probe, y_fused))
        ce_pairs = float(models.ce_loss(probe, y_pairs))
    fused_launches = ops.lowrank_matmul.launches - before
    counts = ops.launch_counts()
    if fused_launches <= 0:
        raise AssertionError("the fused forward launched no lowrank_matmul kernel")
    # pairs and fused kernel both round the hidden to bf16; sums differ in
    # order, and two layers of bf16 compound it
    got = logits_agree(y_fused, y_pairs, FUSED_MAX_ABS, FUSED_RMS_REL, "serve")
    if abs(ce_fused - ce_pairs) > 1e-2 * abs(ce_pairs):
        raise AssertionError(f"fused CE {ce_fused} vs pairs CE {ce_pairs}")
    # served-forward latency, fused and unfused, after the counts are read
    with torch.no_grad():
        fused_ms = time_ms(lambda: model(probe))
        pnn.unfuse_factor_pairs(model)
        pairs_ms = time_ms(lambda: model(probe))
        pnn.fuse_factor_pairs(model)
    emit({"phase": "serve", "fused_ms": fused_ms, "pairs_ms": pairs_ms,
          "logits_shape": list(y_fused.shape), "ce_fused": ce_fused, "ce_pairs": ce_pairs,
          **got, "lowrank_launches": fused_launches})

    # --- the fused model answers through the KV-cached generate ----------
    gen_prompt = torch.from_numpy(np.random.default_rng(args.seed + 4).integers(
        0, cfg.vocab_size, (MOE_BATCH, TINY_PROMPT), dtype=np.int64)).to(dev)
    gen = cached_generate(model, gen_prompt, TINY_NEW, "generate", GEN_MAX_ABS, GEN_RMS_REL)
    require_launches(gen["counts"], ("lowrank_matmul", "flash_attention"), "generate")
    emit({"phase": "generate", "batch": MOE_BATCH, "prompt": TINY_PROMPT,
          "new_tokens": TINY_NEW, "wall_s": gen["wall_s"], **gen["gate"],
          "launches": gen["counts"]})

    # --- the served model against its plain f32 version on the CPU --------
    short = {"input_ids": probe["input_ids"][:, :128]}
    with torch.no_grad():
        y_card = model(short).float().cpu()
        short = utils.to_device(short, "cpu")
        y_cpu = model.to("cpu", torch.float32)(short)
    got = logits_agree(y_card, y_cpu, REF_MAX_ABS, REF_RMS_REL, "reference")
    emit({"phase": "reference", "seq": 128, **got,
          "ce_card": float(models.ce_loss(short, y_card)),
          "ce_cpu_f32": float(models.ce_loss(short, y_cpu))})

    # --- slice 6: the rest of dwain.decompose ----------------------------
    ft_model, ft_names, ft_counts = decompose_ft(dev, cfg, weights, args.seed, probe)
    finetune_grad(ft_model, ft_names, cfg, args.seed)
    del ft_model
    torch.cuda.empty_cache()
    lora_counts = decompose_ft_lora(dev, cfg, weights, args.seed, probe)

    # --- slice 8: the trainer CLI's two tasks; slice 9: its generate task,
    # and the rest of cached serving on slice 1's model ------------------
    with tempfile.TemporaryDirectory() as tmp, restored_logging():
        snap, data, artifact, cli_counts = trainer_llm_decompose(dev, cfg, args.seed, pathlib.Path(tmp))
        cli_ft_counts = trainer_llm_finetune(dev, args.seed, pathlib.Path(tmp), snap, data, artifact)
        cli_gen_counts = trainer_llm_generate(dev, args.seed, pathlib.Path(tmp), snap, data, artifact)
        paths_counts = serving_paths(dev, cfg, weights, model, args.seed)
        del model, weights
        torch.cuda.empty_cache()
        # --- slice 10: phi-2 through the CLI, on the same prose ----------
        phi_counts = phi2_cli_decompose(dev, args.seed, pathlib.Path(tmp), data)
        # --- slice 19: block pruning on the CLI's snapshot ----------------
        bp_counts = bp_tinyllama(dev, args.seed, pathlib.Path(tmp), snap)
    torch.cuda.empty_cache()
    family_counts = {}
    for name in ("qwen2_1_5b", *FAMILY_CONFIGS):
        family_counts.update(family_serve(dev, name, args.seed))
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()
    mlp_counts = dwain_mlp(dev, args.seed)

    # --- slice 7: falor and lockd on a full-width ResNet-50 ---------------
    resnet_counts = {"falor_resnet50": falor_resnet50(dev, args.seed, use_mean=False),
                     "falor_resnet50_mean": falor_resnet50(dev, args.seed, use_mean=True),
                     "lockd_resnet50": lockd_resnet50(dev, args.seed)}

    # --- slice 11: the vision trainer CLI's four tasks ---------------------
    vision_counts = trainer_vision(dev, args.seed)

    by_path = {"decompose_serve": counts, "tinyllama_generate": gen["counts"],
               "decompose_ft": ft_counts, "decompose_ft_lora": lora_counts,
               "trainer_llm_decompose": cli_counts, "trainer_llm_finetune": cli_ft_counts,
               "trainer_llm_generate": cli_gen_counts, "serving_paths": paths_counts,
               **phi_counts, **bp_counts, **family_counts,
               "dwain_mlp": mlp_counts, **resnet_counts, **vision_counts,
               **moe_serve(dev, args.seed)}
    emit({"phase": "kernels", "launches": by_path})
    main_path = {"syrk_gram": "decompose_serve", "flash_attention": "decompose_serve",
                 "lowrank_matmul": "decompose_serve", "grouped_matmul": "moe_bf16",
                 "gmm_int8": "moe_int8"}
    table = []
    for name, (source, replaces) in KERNEL_INFO.items():
        main, *other = recs[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": by_path[main_path[name]][name],
                      "launches_by_path": {p: c[name] for p, c in by_path.items()},
                      **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "shape")},
                      **{k: main[k] for k in ("path", "eager_ms") if k in main},
                      **{k: v for k, v in main.items() if k.endswith("route_ms")},
                      "other_shapes": other})
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
