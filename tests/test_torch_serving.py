"""The port's KV-cached serving path, on the CPU: cached prefill and decode
logits against the JAX package's ``forward_with_cache`` (the GQA golden
llama, and a tiny Mixtral in f32, weight-only int8 and bf16), and
``generate`` against an uncached re-forward of the port itself."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import quant as jquant, serving as jserving
from ptdeco_tpu_torch import quant as tquant, serving as tserving

from test_torch_moe import jax_twin, probe_ids, tiny_mixtral
from test_torch_transformer import _gqa, make_torch_gqa


def golden_llama():
    _, init_sd, hf_cfg = _gqa()
    return jax_twin(hf_cfg, init_sd), make_torch_gqa(init_sd, hf_cfg)


def model_pair(kind):
    if kind == "gqa_llama":
        return golden_llama()
    if kind == "mixtral_bf16":
        return tiny_mixtral(jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
    jm, tm = tiny_mixtral()
    if kind == "mixtral_int8":
        jm = jquant.quantize_for_serving(jm)
        tquant.quantize_for_serving(tm)
    return jm, tm


@functools.partial(jax.jit, static_argnums=3)
def _jax_step(jm, ids, caches, cache_pos):
    return jserving.forward_with_cache(jm, ids, caches, cache_pos)


# f32 models: matmul reassociation only.  bf16: both frameworks round every
# activation to bf16, at different points; the logits reach ~1.8, where one
# bf16 ulp is 2^-7 (the largest difference read), and the limit is four
TOLERANCE = {"gqa_llama": 1e-4, "mixtral_f32": 1e-4, "mixtral_int8": 1e-4, "mixtral_bf16": 2.0 ** -5}


@pytest.mark.parametrize("kind", sorted(TOLERANCE))
def test_cached_prefill_and_decode_match_jax(kind):
    jm, tm = model_pair(kind)
    vocab = tm.model.embed_tokens.weight.shape[0]
    prompt = probe_ids(vocab, (2, 7), seed=5)
    steps = probe_ids(vocab, (2, 2), seed=6)
    b, s_p = prompt.shape
    max_len = s_p + steps.shape[1]
    jc = jserving.init_cache(jm, b, max_len)
    tc = tserving.init_cache(tm, b, max_len)
    j_logits, jc = _jax_step(jm, jnp.asarray(prompt), jc, 0)
    t_logits, tc = tserving.forward_with_cache(tm, torch.from_numpy(prompt).long(), tc, 0)
    got, want = [t_logits], [j_logits]
    for i in range(steps.shape[1]):
        tok = steps[:, i : i + 1]
        j_logits, jc = _jax_step(jm, jnp.asarray(tok), jc, s_p + i)
        t_logits, tc = tserving.forward_with_cache(tm, torch.from_numpy(tok).long(), tc, s_p + i)
        got.append(t_logits)
        want.append(j_logits)
    for t, j in zip(got, want):
        np.testing.assert_allclose(
            t.float().numpy(), np.asarray(j.astype(jnp.float32)), atol=TOLERANCE[kind]
        )
    # the caches hold the same keys and values
    np.testing.assert_allclose(
        tc[1][0].float().numpy(), np.asarray(jc[1][0].astype(jnp.float32)),
        atol=TOLERANCE[kind],
    )


def naive_greedy(tm, prompt, n_new):
    """Full uncached re-forward per token: tokens and the logits each was
    chosen from."""
    ids, toks, logits = prompt, [], []
    with torch.no_grad():
        for _ in range(n_new):
            last = tm({"input_ids": ids})[:, -1]
            nxt = torch.argmax(last, dim=-1)
            toks.append(nxt)
            logits.append(last)
            ids = torch.cat([ids, nxt[:, None]], dim=1)
    return torch.stack(toks, 1), torch.stack(logits, 1)


@pytest.mark.parametrize("kind", ["gqa_llama", "mixtral_f32", "mixtral_int8"])
def test_generate_matches_uncached_reforward(kind):
    _, tm = model_pair(kind)
    vocab = tm.model.embed_tokens.weight.shape[0]
    prompt = torch.from_numpy(probe_ids(vocab, (2, 6), seed=8)).long()
    toks, logits = tserving.generate(tm, prompt, 5, return_logits=True)
    want_toks, want_logits = naive_greedy(tm, prompt, 5)
    assert torch.equal(toks, want_toks)
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=1e-4)


def test_generate_sampling_and_arguments():
    _, tm = golden_llama()
    prompt = torch.from_numpy(probe_ids(128, (2, 4), seed=9)).long()

    def sample():
        gen = torch.Generator().manual_seed(0)
        return tserving.generate(tm, prompt, 4, temperature=0.8, generator=gen)

    a, b = sample(), sample()
    assert torch.equal(a, b) and a.shape == (2, 4) and int(a.max()) < 128
    greedy = tserving.generate(tm, prompt, 4)
    assert not torch.equal(a, greedy)  # sampling draws other tokens than argmax
    for bad in (dict(max_new_tokens=0), dict(max_new_tokens=2, temperature=-1.0)):
        with pytest.raises(ValueError):
            tserving.generate(tm, prompt, **bad)
