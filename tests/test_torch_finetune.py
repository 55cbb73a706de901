"""The port's recovery fine-tuning (``ptdeco_tpu_torch/finetune.py``)
against the JAX package's on the CPU: the learning-rate schedule, full
fine-tuning, the LoRA adapter's forward and merge, LoRA fine-tuning, its
rank filter and rank pattern, the guards, and ``make_finetune_fn``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import finetune as jft, models as jmodels, nn as jnn, utils as jutils
from ptdeco_tpu_torch import finetune, models, nn as tnn, utils

DIM, DEPTH, N_OUT = 16, 3, 4
STEPS, LR = 14, 1e-2  # 10 warmup steps, then 4 of decay


def _batches(n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {"inp": rng.standard_normal((8, DIM)).astype(np.float32),
         "y": rng.standard_normal((8, N_OUT)).astype(np.float32)}
        for _ in range(n)
    ]


def _jax_iter(batches):
    return iter([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])


def _torch_iter(batches):
    return iter([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches])


def _jax_mse(batch, out):
    return jnp.mean(jnp.square(out - batch["y"]))


def _torch_mse(batch, out):
    return torch.mean(torch.square(out - batch["y"]))


def _twins(pairs=None):
    """The JAX MLP and its torch twin (same numpy weights); ``pairs`` maps a
    block index to a rank: that block becomes a factor pair of that rank."""
    jm = jmodels.make_mlp(jax.random.PRNGKey(0), dim=DIM, depth=DEPTH, n_out=N_OUT)
    tm = models.make_mlp(DIM, DEPTH, N_OUT, device="cpu")
    rng = np.random.default_rng(1)
    for i, r in (pairs or {}).items():
        k1 = rng.standard_normal((DIM, r)).astype(np.float32) / math.sqrt(DIM)
        k2 = rng.standard_normal((r, DIM)).astype(np.float32) / math.sqrt(r)
        b = rng.standard_normal(DIM).astype(np.float32) * 0.1
        jm = jnn.replace_submodule(jm, f"blocks.{i}", jnn.Sequential(layers=(
            jnn.Linear(kernel=jnp.asarray(k1), bias=None),
            jnn.Linear(kernel=jnp.asarray(k2), bias=jnp.asarray(b)),
        )))
        pair = torch.nn.Sequential(torch.nn.Linear(DIM, r, bias=False), torch.nn.Linear(r, DIM))
        tnn.replace_submodule(tm, f"blocks.{i}", pair)
    utils.load_numpy_state_dict(tm, jutils.state_dict(jm))
    return jm, tm


def _assert_same_weights(jm, tm, atol):
    theirs = jutils.state_dict(jm)
    ours = utils.state_dict(tm)
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(v), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("num_steps", [1, 5, 10, 11, 25, 100])
def test_schedule_matches_optax(num_steps):
    ours = finetune._linear_warmup_schedule(1e-3, num_steps)
    theirs = jft._linear_warmup_schedule(1e-3, num_steps)
    for count in range(num_steps + 3):
        # optax computes in f32: a few of its ulps of lr
        np.testing.assert_allclose(ours(count), float(theirs(count)), rtol=1e-6,
                                   atol=1e-3 * 2.0 ** -22, err_msg=str(count))
    assert ours(0) == 0.0


def test_finetune_full_matches_jax():
    """AdamW (weight decay 0.01) on the last two of three blocks, warmup and
    decay: the trained weights agree to 1e-5; the rest stay bit-equal."""
    batches = _batches()
    jm, tm = _twins()
    names = ["blocks.0", "blocks.1", "blocks.2"]
    jm = jft.finetune_full(model=jm, ft_iterator=_jax_iter(batches), decomposed_modules=names,
                           loss_fn=_jax_mse, num_last_modules_to_finetune=2, num_steps=STEPS,
                           lr=LR)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    out = finetune.finetune_full(model=tm, ft_iterator=_torch_iter(batches),
                                 decomposed_modules=names, loss_fn=_torch_mse,
                                 num_last_modules_to_finetune=2, num_steps=STEPS, lr=LR)
    assert out is tm
    _assert_same_weights(jm, tm, atol=1e-5)
    after = tm.state_dict()
    for k in ("blocks.0.weight", "blocks.0.bias", "head.weight", "head.bias"):
        assert torch.equal(after[k], before[k]), k
    for k in ("blocks.1.weight", "blocks.2.bias"):
        assert not torch.equal(after[k], before[k]), k
    # requires_grad and the module mode are restored
    assert all(p.requires_grad for p in tm.parameters()) and tm.training


def test_lora_linear_forward_and_merge_match_jax():
    rng = np.random.default_rng(2)
    d_in, d_out, r, scale = 12, 10, 4, 0.75
    kernel = rng.standard_normal((d_in, d_out)).astype(np.float32)
    bias = rng.standard_normal(d_out).astype(np.float32)
    a = rng.standard_normal((d_in, r)).astype(np.float32)
    b = rng.standard_normal((r, d_out)).astype(np.float32)
    x = rng.standard_normal((3, 5, d_in)).astype(np.float32)
    jl = jft.LoRALinear(base=jnn.Linear(kernel=jnp.asarray(kernel), bias=jnp.asarray(bias)),
                        lora_a=jnp.asarray(a), lora_b=jnp.asarray(b), scale=scale)
    base = torch.nn.Linear(d_in, d_out)
    with torch.no_grad():
        base.weight.copy_(torch.from_numpy(kernel.T))
        base.bias.copy_(torch.from_numpy(bias))
    tl = finetune.LoRALinear(base, torch.from_numpy(a.T), torch.from_numpy(b.T), scale,
                             dropout=0.5).eval()
    with torch.no_grad():
        y = tl(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jl(jnp.asarray(x))), atol=1e-5)
    merged = tl.merge()
    assert merged is base
    np.testing.assert_allclose(merged.weight.detach().numpy().T, np.asarray(jl.merge().kernel),
                               atol=1e-5)
    np.testing.assert_array_equal(merged.bias.detach().numpy(), bias)


def test_lora_attach_draws_from_its_generator():
    base = torch.nn.Linear(64, 8)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    one, two = (finetune.LoRALinear.attach(gen(), base, 4, 2.0) for _ in range(2))
    assert torch.equal(one.lora_a, two.lora_a) and one.lora_a.shape == (4, 64)
    assert float(one.lora_a.abs().max()) <= 1 / 8 and not torch.any(one.lora_b)
    assert one.scale == 0.5 and one.dropout == 0.05
    assert torch.equal(one.generator.get_state(), two.generator.get_state())
    x = torch.ones(2, 64)
    torch.testing.assert_close(one(x), base(x))  # B is zero: the adapter adds nothing


def test_finetune_lora_matches_jax(monkeypatch):
    """Adapters on the rank-8 pair only (the rank-2 pair is under
    min_rank_to_finetune), each A as the JAX run draws it, dropout 0; the
    merged weights agree to 1e-5."""
    batches = _batches(seed=3)
    jm, tm = _twins(pairs={1: 8, 2: 2})
    names = ["blocks.1", "blocks.2"]
    kw = dict(num_last_modules_to_finetune=2, num_steps=STEPS, lr=LR, min_rank_to_finetune=4,
              lora_r=3, lora_alpha=6.0, lora_dropout=0.0)
    jm = jft.finetune_lora(model=jm, ft_iterator=_jax_iter(batches), decomposed_modules=names,
                           loss_fn=_jax_mse, **kw)

    attach, seen = finetune.LoRALinear.attach, []

    def attach_jax_a(generator, base, r, alpha, dropout=0.05):
        # finetune_lora's adapter rng_id, as the JAX package folds it into
        # PRNGKey(0)
        rng_id = len(seen)
        seen.append(base)
        a = jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(0), rng_id),
                               (base.in_features, r), jnp.float32,
                               -1 / math.sqrt(base.in_features), 1 / math.sqrt(base.in_features))
        adapter = attach(generator, base, r, alpha, dropout)
        with torch.no_grad():
            adapter.lora_a.copy_(torch.from_numpy(np.array(a).T))
        return adapter

    monkeypatch.setattr(finetune.LoRALinear, "attach", staticmethod(attach_jax_a))
    finetune.finetune_lora(model=tm, ft_iterator=_torch_iter(batches), decomposed_modules=names,
                           loss_fn=_torch_mse, **kw)
    assert len(seen) == 2  # blocks.1.0 and blocks.1.1
    assert not any(isinstance(m, finetune.LoRALinear) for m in tm.modules())
    _assert_same_weights(jm, tm, atol=1e-5)


@pytest.mark.parametrize("use_rank_pattern", [False, True])
def test_lora_rank_filter_and_rank_pattern(monkeypatch, use_rank_pattern):
    _, tm = _twins()
    for i, r in enumerate((64, 32, 16)):
        tnn.replace_submodule(tm, f"blocks.{i}", torch.nn.Sequential(
            torch.nn.Linear(DIM, r, bias=False), torch.nn.Linear(r, DIM)))
    adapters = {}

    def no_training(model, names, *args):
        adapters.update({n: (m.lora_a.shape[0], m.scale) for n, m in model.named_modules()
                         if isinstance(m, finetune.LoRALinear)})
        assert sorted(names) == sorted([f"{n}.lora_a" for n in adapters]
                                       + [f"{n}.lora_b" for n in adapters])
        return model

    monkeypatch.setattr(finetune, "_run_training", no_training)
    finetune.finetune_lora(model=tm, ft_iterator=iter([]), loss_fn=_torch_mse,
                           decomposed_modules=["blocks.0", "blocks.1", "blocks.2"],
                           use_rank_pattern=use_rank_pattern)
    # rank 16 is under the default min_rank_to_finetune of 32
    expected = {64: (4, 0.5), 32: (2, 0.5)} if use_rank_pattern else {64: (16, 0.5), 32: (16, 0.5)}
    assert adapters == {f"blocks.{i}.{j}": expected[r]
                        for i, r in enumerate((64, 32)) for j in (0, 1)}


@pytest.mark.parametrize("fn", [finetune.finetune_full, finetune.finetune_lora])
@pytest.mark.parametrize("names,last_n", [([], 8), (["blocks.0"], 0), (["blocks.0"], -1)])
def test_nothing_selected_trains_nothing(monkeypatch, fn, names, last_n):
    def refuse(*args):
        raise AssertionError("trained")

    monkeypatch.setattr(finetune, "_run_training", refuse)
    _, tm = _twins()
    assert fn(model=tm, ft_iterator=iter([]), decomposed_modules=names, loss_fn=_torch_mse,
              num_last_modules_to_finetune=last_n) is tm


def test_make_finetune_fn_modes(monkeypatch):
    calls = []
    for name in ("finetune_full", "finetune_lora"):
        monkeypatch.setattr(finetune, name,
                            lambda name=name, **kw: calls.append((name, kw)) or kw["model"])
    _, tm = _twins()
    it = iter([])
    for mode in ("full", "lora"):
        fn = finetune.make_finetune_fn(mode, it, _torch_mse, num_steps=3)
        assert fn(tm, ["blocks.0"]) is tm
    assert [(n, kw["decomposed_modules"], kw["num_steps"], kw["ft_iterator"]) for n, kw in calls] \
        == [("finetune_full", ["blocks.0"], 3, it), ("finetune_lora", ["blocks.0"], 3, it)]
    assert finetune.make_finetune_fn("none", it, _torch_mse)(tm, ["blocks.0"]) is tm
    with pytest.raises(ValueError, match="bogus"):
        finetune.make_finetune_fn("bogus", it, _torch_mse)
