"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N] [--profile DIR]

The main path is a dwain decomposition of a TinyLlama-1.1B-width causal LM
(vocab 32000, dim 2048, 32 heads / 4 kv heads, MLP 5632, bf16), cut to 2
layers, with random planted-rank weights and synthetic token ids made from
the seed; then the artifact (decompose_config.json + decompose_state_dict.pt)
is written, reloaded into a fresh model, and the decomposed model serves a
probe batch with its factor pairs fused.

Phases, one JSON line each: device, build (the three CUDA kernels, one nvcc
each, started together), one kernel line per kernel (the kernel against its
plain PyTorch version at the main path's shapes, with timings), decompose,
artifact, serve, reference (the served model against the same model on the
CPU in f32, on a short input), kernels (launch counts).  Then the card's
name and power limit as nvidia-smi reports them, the kernel table as one
JSON object, and last {"ok": true, "device": ...}.  Any failed check raises
and the script exits non-zero; without a CUDA device it exits 1 at once.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() is false)")

import ptdeco_tpu_torch as ptt  # noqa: E402
from ptdeco_tpu_torch import dwain, engine, models, nn as pnn, ops, utils  # noqa: E402
from ptdeco_tpu_torch.ops import _build  # noqa: E402

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
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

# Model-level gates, about 2-3x the readings on an H100 at seed 0 (PERF.md):
# fused vs unfused logits read max 0.031 (one bf16 ulp), RMS-relative 1.8e-3;
# bf16 on the card vs f32 on the CPU read max 0.025, RMS-relative 4.1e-3
FUSED_MAX_ABS, FUSED_RMS_REL = 0.0625, 5e-3
REF_MAX_ABS, REF_RMS_REL = 0.06, 1e-2

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
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after warm-up."""
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


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(name, kernel_fn, plain_fn, library_fn, flops, nbytes, tol_fn, shape):
    """Hold the kernel against its plain version elementwise: every output
    must satisfy |out - ref| <= tol_fn(ref), a tensor of per-element limits.
    The record is printed before a failure is raised."""
    out = kernel_fn().float()
    ref = plain_fn().float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    tol = tol_fn(ref)
    # 0 / 0 where both are exact; a NaN in the kernel's output stays NaN
    err_to_tol = float(torch.where(diff == 0, 0.0, diff / tol).max())
    bound_ms, bound_by = bound(flops, nbytes)
    rec = {
        "name": name,
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
        "ms": time_ms(kernel_fn),
        "plain_ms": time_ms(plain_fn),
        "library_ms": time_ms(library_fn),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
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


def kernel_checks(dev) -> dict[str, list[dict]]:
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16
    recs: dict[str, list[dict]] = {k: [] for k in KERNEL_INFO}

    for d in (5632, 2048):
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
        ))

    b, h, h_kv, s, hd = 1, 32, 4, SEQ, 64
    q = torch.randn(b, h, s, hd, device=dev, generator=g).to(bf)
    k = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
    v = torch.randn(b, h_kv, s, hd, device=dev, generator=g).to(bf)
    scale = hd ** -0.5
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
        shape={"b": b, "h": h, "h_kv": h_kv, "s": s, "head_dim": hd, "dtype": "bf16"},
    ))

    # the served pairs' shapes first (bias-free; every site is accepted at
    # rank 32 with this configuration's thresholds: gate/up, then down),
    # then wider ranks with a bias
    n = SEQ
    shapes = ((2048, 32, 5632, False), (5632, 32, 2048, False),
              (2048, 256, 5632, True), (2048, 44, 5632, True))
    for d_in, r, d_out, with_bias in shapes:
        x = torch.randn(n, d_in, device=dev, generator=g).to(bf)
        bias = torch.randn(d_out, device=dev, generator=g).to(bf) if with_bias else None
        k1 = (torch.randn(d_in, r, device=dev, generator=g) / d_in ** 0.5).to(bf)
        k2 = (torch.randn(r, d_out, device=dev, generator=g) / r ** 0.5).to(bf)
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
        ))
    return recs


def tinyllama_2_layer() -> models.TransformerConfig:
    full = models.TransformerConfig.tinyllama_1_1b(dtype=torch.bfloat16)
    return dataclasses.replace(full, n_layers=N_LAYERS)


def planted_rank_weights(cfg: models.TransformerConfig, seed: int) -> dict[str, np.ndarray]:
    """Random weights in HF llama names; every decomposable projection is
    ``A @ B / sqrt(r * d_in)`` plus 1% noise, r = 256."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def planted(d_out: int, d_in: int) -> np.ndarray:
        a = rng.standard_normal((d_out, PLANTED_RANK), dtype=f32)
        b = rng.standard_normal((PLANTED_RANK, d_in), dtype=f32)
        w = (a @ b) / np.sqrt(PLANTED_RANK * d_in, dtype=f32)
        w += 0.01 * rng.standard_normal((d_out, d_in), dtype=f32) / np.sqrt(d_in, dtype=f32)
        return w

    hd = cfg.head_dim
    sd = {"model.embed_tokens.weight": rng.standard_normal((cfg.vocab_size, cfg.dim), dtype=f32)}
    for i in range(cfg.n_layers):
        p = f"model.layers.{i}."
        sd[p + "self_attn.q_proj.weight"] = planted(cfg.n_heads * hd, cfg.dim)
        sd[p + "self_attn.k_proj.weight"] = planted(cfg.n_kv_heads * hd, cfg.dim)
        sd[p + "self_attn.v_proj.weight"] = planted(cfg.n_kv_heads * hd, cfg.dim)
        sd[p + "self_attn.o_proj.weight"] = planted(cfg.dim, cfg.n_heads * hd)
        sd[p + "mlp.gate_proj.weight"] = planted(cfg.hidden_dim, cfg.dim)
        sd[p + "mlp.up_proj.weight"] = planted(cfg.hidden_dim, cfg.dim)
        sd[p + "mlp.down_proj.weight"] = planted(cfg.dim, cfg.hidden_dim)
        sd[p + "input_layernorm.weight"] = np.ones(cfg.dim, f32)
        sd[p + "post_attention_layernorm.weight"] = np.ones(cfg.dim, f32)
    sd["model.norm.weight"] = np.ones(cfg.dim, f32)
    sd["lm_head.weight"] = rng.standard_normal((cfg.vocab_size, cfg.dim), dtype=f32) / np.sqrt(
        cfg.dim, dtype=f32
    )
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

    # --- main path: decompose -> artifact -> serve ----------------------
    cfg = tinyllama_2_layer()
    weights = planted_rank_weights(cfg, args.seed)
    model = utils.load_numpy_state_dict(models.CausalLM(cfg, device=dev), weights)
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
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        with open(tmp / "decompose_config.json", "w") as f:
            json.dump(config, f)
        utils.save_state_dict_pt(utils.state_dict(model), str(tmp / "decompose_state_dict.pt"))
        sd_bytes = (tmp / "decompose_state_dict.pt").stat().st_size
        with open(tmp / "decompose_config.json") as f:
            config2 = json.load(f)
        fresh = models.CausalLM(cfg, device=dev)
        utils.apply_decompose_config(fresh, config2)
        utils.load_state_dict(fresh, utils.load_state_dict_pt(str(tmp / "decompose_state_dict.pt")))
    with torch.no_grad():
        y_fresh = fresh(probe)
    # same weights and kernels: the reload must reproduce the logits
    got = logits_agree(y_fresh, y_pairs, 0.0, 0.0, "artifact")
    emit({"phase": "artifact", "state_dict_bytes": sd_bytes, **got})
    del fresh

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

    emit({"phase": "kernels", "launches": counts})
    table = []
    for name, (source, replaces) in KERNEL_INFO.items():
        main, *other = recs[name]
        table.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                      "launches": counts[name],
                      **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms", "shape")},
                      "other_shapes": other})
    print(smi, flush=True)
    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
