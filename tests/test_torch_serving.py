"""The port's KV-cached serving path, on the CPU: cached prefill and decode
logits against the JAX package's ``forward_with_cache`` (the GQA golden
llama, and a tiny Mixtral in f32, weight-only int8 and bf16), and
``generate`` against an uncached re-forward of the port itself.  Then the
rest of serving on the golden llama: per-row positions and ``kv_mask``,
``generate`` with eos, ragged rows, the repetition penalty and ``max_len``,
``generate_beam``, ``generate_speculative`` with its stats and
``measure_draft_acceptance`` against the JAX package (tokens and stats
exactly, logits 1e-4, beam scores 1e-4, the penalty and the gate's
arithmetic 1e-6); the sampling filters against JAX's ``_sample`` in
support and distribution (4096 draws each, a chi-square test at p > 1e-3);
and the port's own cases of ``tests/test_serving.py`` for the llama
family (naive oracles, sampler limits, the flash gate, the speculative
gate)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import quant as jquant, serving as jserving, utils as jutils
from ptdeco_tpu_torch import models as tmodels, nn as tnn, quant as tquant, serving as tserving
from ptdeco_tpu_torch import utils as tutils

from test_torch_moe import jax_twin, numpy_weights, probe_ids, tiny_mixtral
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


# --- the rest of cached serving: per-row positions, eos, samplers, beams,
# speculative decoding and its gate.  The golden GQA llama (f32) in both
# packages; on the CPU neither takes a flash kernel.

@pytest.fixture(scope="module")
def llama():
    return golden_llama()


def rows_of(lengths, seed, vocab=128):
    """One prompt per length (ids 1..vocab-1) and their right-padded batch."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(1, vocab, n) for n in lengths]
    padded = np.zeros((len(rows), max(lengths)), np.int64)
    for i, r in enumerate(rows):
        padded[i, : len(r)] = r
    return rows, padded, np.asarray(lengths, np.int64)


def t_(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def j_(a):
    return jnp.asarray(np.asarray(a), jnp.int32)


@jax.jit
def _jax_step_rows(jm, ids, caches, cache_pos):
    return jserving.forward_with_cache(jm, ids, caches, cache_pos)


@functools.partial(jax.jit, static_argnums=3)
def _jax_step_masked(jm, ids, caches, cache_pos, kv_mask):
    return jserving.forward_with_cache(jm, ids, caches, cache_pos, kv_mask=kv_mask)


def test_forward_with_cache_per_row_and_kv_mask_match_jax(llama):
    """A right-padded ragged prefill, per-row steps of one and two tokens
    (the last writes past the end of the cache, where both packages drop
    it), and a left-padded prefill with kv_mask then a decode step."""
    jm, tm = llama
    _, padded, lens = rows_of([3, 7, 5], seed=20)
    max_len = 10
    jc, tc = jserving.init_cache(jm, 3, max_len), tserving.init_cache(tm, 3, max_len)
    rng = np.random.default_rng(21)
    steps = [(padded, 0), (rng.integers(0, 128, (3, 1)), lens),
             (rng.integers(0, 128, (3, 2)), lens + 1), (rng.integers(0, 128, (3, 2)), [8, 9, 9])]
    for ids, pos in steps:
        if isinstance(pos, int):
            want, jc = _jax_step(jm, j_(ids), jc, pos)
        else:
            want, jc = _jax_step_rows(jm, j_(ids), jc, j_(pos))
        tpos = pos if isinstance(pos, int) else t_(pos)
        got, tc = tserving.forward_with_cache(tm, t_(ids), tc, tpos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOLERANCE["gqa_llama"])
    for (tk, tv), (jk, jv) in zip(tc, jc):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=TOLERANCE["gqa_llama"])
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOLERANCE["gqa_llama"])

    # left padding: two junk tokens before a 4-token prompt in row 0
    short = rng.integers(1, 128, (2, 4))
    left = np.concatenate([np.full((2, 2), 7), short], axis=1)
    left[1] = rng.integers(1, 128, 6)
    mask = np.ones((2, 9), bool)
    mask[0, :2] = False
    nxt = rng.integers(0, 128, (2, 1))
    jc, tc = jserving.init_cache(jm, 2, 9), tserving.init_cache(tm, 2, 9)
    for ids, pos in ((left, 0), (nxt, 6)):
        want, jc = _jax_step_masked(jm, j_(ids), jc, pos, jnp.asarray(mask))
        got, tc = tserving.forward_with_cache(tm, t_(ids), tc, pos, kv_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOLERANCE["gqa_llama"])
    # rope scores depend on relative positions only: the masked row equals
    # the short prompt alone (and its next step)
    alone, ac = tserving.forward_with_cache(tm, t_(short[:1]), tserving.init_cache(tm, 1, 7), 0)
    step, _ = tserving.forward_with_cache(tm, t_(nxt[:1]), ac, 4)
    np.testing.assert_allclose(got[0, -1].numpy(), step[0, -1].numpy(), atol=1e-4)


GEN_CASES = {
    "ragged_eos_max_len": dict(ragged=True, eos=True, max_len=20),
    "ragged_repetition_penalty": dict(ragged=True, repetition_penalty=1.5),
    "uniform_eos_penalty_below_one": dict(ragged=False, eos=True, repetition_penalty=0.7),
}


@pytest.mark.parametrize("case", sorted(GEN_CASES))
def test_greedy_generate_matches_jax(llama, case):
    jm, tm = llama
    c = GEN_CASES[case]
    _, padded, lens = rows_of([4, 7, 2], seed=22)
    kw = {k: c[k] for k in ("max_len", "repetition_penalty") if k in c}
    t_lens, j_lens = (t_(lens), j_(lens)) if c["ragged"] else (None, None)
    if c.get("eos"):
        # a token the free run emits mid-row
        kw["eos_id"] = int(tserving.generate(tm, t_(padded), 8, prompt_lens=t_lens, **kw)[0, 3])
    got = tserving.generate(tm, t_(padded), 8, prompt_lens=t_lens, **kw)
    if c.get("eos"):
        assert (got[0, 3:] == kw["eos_id"]).all()
    want = jserving.generate(jm, j_(padded), 8, prompt_lens=j_lens, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


BEAM_CASES = {
    "one_beam": dict(num_beams=1),
    "three_beams_ragged_eos_length_penalty": dict(num_beams=3, ragged=True, eos=True,
                                                  length_penalty=2.0),
}


@pytest.mark.parametrize("case", sorted(BEAM_CASES))
def test_generate_beam_matches_jax(llama, case):
    jm, tm = llama
    c = dict(BEAM_CASES[case])
    _, padded, lens = rows_of([6, 4], seed=23)
    ragged, eos = c.pop("ragged", False), c.pop("eos", False)
    if eos:
        c["eos_id"] = int(tserving.generate_beam(tm, t_(padded), 6, num_beams=3,
                                                 prompt_lens=t_(lens))[0, 2])
    got, got_s = tserving.generate_beam(tm, t_(padded), 6, return_scores=True,
                                        prompt_lens=t_(lens) if ragged else None, **c)
    want, want_s = jserving.generate_beam(jm, j_(padded), 6, return_scores=True,
                                          prompt_lens=j_(lens) if ragged else None, **c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-4)


def unrelated_draft():
    """A 1-layer llama of the golden's widths, with other weights."""
    _, _, hf = _gqa()
    hf1 = {**hf, "num_hidden_layers": 1}
    tm = tmodels.CausalLM(tmodels.TransformerConfig.from_hf_config(hf1, dtype=torch.float32),
                          device="cpu")
    sd = numpy_weights(tm, seed=11)
    tutils.load_numpy_state_dict(tm, sd)
    return jax_twin(hf1, sd), tm


DRAFT_SITES = ("model.layers.0.mlp.up_proj", "model.layers.1.mlp.down_proj",
               "model.layers.0.self_attn.q_proj")


def decomposed_draft(rank=8):
    """The golden llama with three sites replaced by rank-``rank`` SVD factor
    pairs: the JAX twin keeps the pairs, the port fuses them."""
    _, sd, hf = _gqa()
    config, new = {}, dict(sd)
    for name in DRAFT_SITES:
        w = sd[name + ".weight"].astype(np.float64)
        u, s, vt = np.linalg.svd(w, full_matrices=False)
        root = np.sqrt(s[:rank])
        new[name + ".0.weight"] = (root[:, None] * vt[:rank]).astype(np.float32)
        new[name + ".1.weight"] = (u[:, :rank] * root).astype(np.float32)
        del new[name + ".weight"]
        config[name] = tutils.get_module_config(torch.nn.Sequential(
            torch.nn.Linear(w.shape[1], rank, bias=False), torch.nn.Linear(rank, w.shape[0], bias=False)))
    tm = make_torch_gqa(sd, hf)
    tutils.apply_decompose_config(tm, config)
    tutils.load_numpy_state_dict(tm, new)
    tnn.fuse_factor_pairs(tm)
    assert sum(type(m).__name__ == "FusedLowRankLinear" for m in tm.modules()) == len(DRAFT_SITES)
    jm = jutils.apply_decompose_config(jax_twin(hf, sd), config)
    return jutils.load_state_dict(jm, new), tm


SPEC_CASES = {
    "k1_eos_self_draft": dict(draft="self", k=1, eos=True),
    "k4_ragged_eos_fused_decomposed_draft": dict(draft="decomposed", k=4, ragged=True, eos=True),
    "k2_ragged_unrelated_draft": dict(draft="unrelated", k=2, ragged=True),
}


@pytest.fixture(scope="module")
def drafts(llama):
    return {"self": llama, "decomposed": decomposed_draft(), "unrelated": unrelated_draft()}


@pytest.mark.parametrize("case", sorted(SPEC_CASES))
def test_generate_speculative_matches_jax(llama, drafts, case):
    """Tokens and stats equal the JAX package's; tokens equal the target's
    greedy ``generate`` (eos-filled)."""
    jm, tm = llama
    c = SPEC_CASES[case]
    jd, td = drafts[c["draft"]]
    _, padded, lens = rows_of([3, 6, 5], seed=24)
    tlens = t_(lens) if c.get("ragged") else None
    jlens = j_(lens) if c.get("ragged") else None
    eos = int(tserving.generate(tm, t_(padded), 9, prompt_lens=tlens)[1, 4]) if c.get("eos") else None
    got, stats = tserving.generate_speculative(tm, td, t_(padded), 9, k=c["k"], eos_id=eos,
                                               prompt_lens=tlens, return_stats=True)
    want, jstats = jserving.generate_speculative(jm, jd, j_(padded), 9, k=c["k"], eos_id=eos,
                                                 prompt_lens=jlens, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == jstats
    greedy = tserving.generate(tm, t_(padded), 9, eos_id=eos, prompt_lens=tlens)
    assert torch.equal(got, greedy)
    if c["draft"] == "self":
        assert stats["accepted"] == stats["drafted"] > 0
    if c["draft"] == "decomposed":
        # the same shapes, k and eos as the speculative call: no new JAX compile
        want_acc = jserving.measure_draft_acceptance(jm, jd, j_(padded), k=4, probe_tokens=9,
                                                     eos_id=eos, prompt_lens=jlens)
        got_acc = tserving.measure_draft_acceptance(tm, td, t_(padded), k=4, probe_tokens=9,
                                                    eos_id=eos, prompt_lens=tlens)
        assert got_acc == want_acc and 0 < got_acc["accepted"] < got_acc["drafted"]


# fixed logits over a vocabulary of 48: each filter keeps tokens of >= 2%
# probability and sits far (in float terms) from every kept/dropped edge
SAMPLE_LOGITS = np.round(np.random.default_rng(25).normal(0.0, 1.5, 48), 2).astype(np.float32)
FILTERS = {"top_k": dict(top_k=9), "top_p": dict(top_p=0.8), "min_p": dict(min_p=0.15)}
N_DRAWS = 4096


@pytest.mark.parametrize("name", sorted(FILTERS))
def test_sampling_filter_matches_jax_in_support_and_distribution(name):
    import scipy.stats

    kw = FILTERS[name]
    temperature = 0.9
    logits = torch.from_numpy(SAMPLE_LOGITS).expand(N_DRAWS, -1)
    gen = torch.Generator().manual_seed(26)
    got = tserving._sample(logits, False, temperature, gen, **kw).numpy()
    jkw = {"top_k": kw.get("top_k"),
           "top_p": None if "top_p" not in kw else jnp.float32(kw["top_p"]),
           "min_p": None if "min_p" not in kw else jnp.float32(kw["min_p"])}
    draw = jax.jit(jax.vmap(lambda key: jserving._sample(
        jnp.asarray(SAMPLE_LOGITS)[None], False, jnp.float32(temperature), key, **jkw)[0]))
    want = np.asarray(draw(jax.random.split(jax.random.PRNGKey(27), N_DRAWS)))
    support = sorted(set(want.tolist()))
    assert sorted(set(got.tolist())) == support and 3 <= len(support) < 48
    counts = np.stack([np.bincount(got, minlength=48)[support],
                       np.bincount(want, minlength=48)[support]])
    assert scipy.stats.chi2_contingency(counts)[1] > 1e-3


def test_repetition_penalty_and_gate_arithmetic_match_jax():
    rng = np.random.default_rng(28)
    logits = rng.normal(0, 2, (3, 40)).astype(np.float32)
    seen = rng.random((3, 40)) < 0.3
    for p in (1.3, 0.6):
        got = tserving._apply_repetition_penalty(torch.from_numpy(logits), torch.from_numpy(seen), p)
        want = jserving._apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(seen), jnp.float32(p))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    costs = {"target_step_s": 3e-3, "target_verify_s": 3.4e-3, "draft_step_s": 4e-4}
    for acc in (0.0, 0.55, 0.95):
        got = tserving.estimate_speculative_speedup(None, None, 8, k=4, acceptance=acc, costs=costs)
        want = jserving.estimate_speculative_speedup(None, None, 8, k=4, acceptance=acc, costs=costs)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key] == pytest.approx(want[key], abs=1e-6)


# --- the port's own cases (tests/test_serving.py's, for the llama family) ----


def test_eos_early_stop_fills_with_eos(llama):
    _, tm = llama
    prompt = t_(probe_ids(128, (2, 4), seed=30))
    eos = int(tserving.generate(tm, prompt, 5)[0, 1])
    row = tserving.generate(tm, prompt, 5, eos_id=eos)[0]
    hit = int(torch.argmax((row == eos).int()))
    assert row[hit] == eos and (row[hit:] == eos).all()


SAMPLER_LIMITS = {
    # (filter kwargs, equals): a vanishing nucleus, top_k 1 and min_p 1 keep
    # only the argmax; top_p 1, top_k = vocab and min_p 0 keep everything and
    # draw what an unfiltered draw from the same generator draws
    "top_p_tiny": (dict(top_p=1e-9), "greedy"),
    "top_p_full": (dict(top_p=1.0), "plain"),
    "top_k_one": (dict(top_k=1), "greedy"),
    "top_k_vocab": (dict(top_k=128), "plain"),
    "min_p_one": (dict(min_p=1.0), "greedy"),
    "min_p_zero": (dict(min_p=0.0), "plain"),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_LIMITS))
def test_sampler_limits(llama, case):
    _, tm = llama
    kw, equals = SAMPLER_LIMITS[case]
    prompt = t_(probe_ids(128, (2, 4), seed=31))

    def sample(**extra):
        gen = torch.Generator().manual_seed(32)
        return tserving.generate(tm, prompt, 5, temperature=0.9, generator=gen, **extra)

    want = tserving.generate(tm, prompt, 5) if equals == "greedy" else sample()
    assert torch.equal(sample(**kw), want)


def test_top_k_restricts_support_to_the_returned_logits(llama):
    """Every token sampled with top_k = 3 is one of the 3 largest logits of
    its own step, read from ``return_logits`` and from an uncached
    re-forward of the emitted prefix."""
    _, tm = llama
    prompt = t_(probe_ids(128, (2, 4), seed=33))
    gen = torch.Generator().manual_seed(34)
    out, logits = tserving.generate(tm, prompt, 5, temperature=2.0, top_k=3, generator=gen,
                                    return_logits=True)
    _, naive_logits = naive_greedy(tm, prompt, 1)
    ids = prompt
    for t in range(5):
        with torch.no_grad():
            ref = tm({"input_ids": ids})[:, -1]
        torch.testing.assert_close(logits[:, t], ref, rtol=0, atol=1e-4)
        top3 = torch.topk(ref, 3).indices
        assert all(int(out[b, t]) in top3[b].tolist() for b in range(2))
        ids = torch.cat([ids, out[:, t : t + 1]], dim=1)
    torch.testing.assert_close(logits[:, :1], naive_logits, rtol=0, atol=1e-4)


def test_forward_with_cache_last_pos(llama):
    _, tm = llama
    ids = t_(probe_ids(128, (2, 6), seed=35))
    full, c_full = tserving.forward_with_cache(tm, ids, tserving.init_cache(tm, 2, 8), 0)
    lp = torch.tensor([5, 3])
    one, c_one = tserving.forward_with_cache(tm, ids, tserving.init_cache(tm, 2, 8), 0, last_pos=lp)
    assert one.shape == (2, 1, 128)
    torch.testing.assert_close(one[:, 0], full[torch.arange(2), lp], rtol=0, atol=1e-6)
    for a, b in zip(c_full, c_one):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def naive_rep_greedy(tm, rows, p, n_new):
    """Full re-forward greedy with HF's repetition penalty on each unpadded
    prompt row (prompt + generated tokens penalized)."""
    outs = []
    for r in rows:
        ids = [int(t) for t in r]
        seen, new = set(ids), []
        for _ in range(n_new):
            with torch.no_grad():
                lg = tm({"input_ids": torch.tensor([ids])})[0, -1].clone()
            for t in seen:
                lg[t] = lg[t] / p if lg[t] > 0 else lg[t] * p
            nxt = int(torch.argmax(lg))
            new.append(nxt)
            seen.add(nxt)
            ids.append(nxt)
        outs.append(new)
    return torch.tensor(outs)


def test_repetition_penalty_matches_naive_and_excludes_the_pad_tail(llama):
    _, tm = llama
    rows, padded, lens = rows_of([5, 3], seed=36)
    got = tserving.generate(tm, t_(padded), 5, repetition_penalty=1.5, prompt_lens=t_(lens))
    assert torch.equal(got, naive_rep_greedy(tm, rows, 1.5, 5))
    same = tserving.generate(tm, t_(padded), 5, repetition_penalty=1.0, prompt_lens=t_(lens))
    assert torch.equal(same, tserving.generate(tm, t_(padded), 5, prompt_lens=t_(lens)))


def test_ragged_batch_matches_per_row(llama):
    _, tm = llama
    rows, padded, lens = rows_of([3, 7, 5], seed=37)
    got = tserving.generate(tm, t_(padded), 5, prompt_lens=t_(lens))
    for i, r in enumerate(rows):
        assert torch.equal(got[i], naive_greedy(tm, t_(r)[None], 5)[0][0]), f"row {i}"


def naive_beam(tm, prompt_row, n_new, m, eos_id=None, length_penalty=1.0):
    """Single-row beam-search oracle: an uncached re-forward per beam per
    step, float64 scores (tests/test_serving.py:naive_beam)."""
    seq0 = [int(t) for t in prompt_row]

    def step_lp(seq):
        with torch.no_grad():
            logits = tm({"input_ids": torch.tensor([seq])})[0, -1]
        return torch.log_softmax(logits.float(), -1).double().numpy()

    lp = step_lp(seq0)
    beams = [([int(t)], float(lp[t]), eos_id is not None and int(t) == eos_id)
             for t in np.argsort(-lp)[:m]]
    for _ in range(n_new - 1):
        cand = []
        for new, s, fin in beams:
            if fin:
                cand.append((new + [eos_id], s, True))
                continue
            lp = step_lp(seq0 + new)
            cand += [(new + [int(t)], s + float(lp[t]), eos_id is not None and int(t) == eos_id)
                     for t in np.argsort(-lp)[:m]]
        cand.sort(key=lambda c: -c[1])
        beams = cand[:m]

    def plen(new):
        return new.index(eos_id) + 1 if eos_id is not None and eos_id in new else len(new)

    best = max(beams, key=lambda c: c[1] / plen(c[0]) ** length_penalty)
    return best[0], best[1] / plen(best[0]) ** length_penalty


BEAM_ORACLE_CASES = {
    "three_beams": dict(num_beams=3),
    "three_beams_eos_length_penalty": dict(num_beams=3, eos=True, length_penalty=2.0),
    "three_beams_ragged": dict(num_beams=3, ragged=True),
}


@pytest.mark.parametrize("case", sorted(BEAM_ORACLE_CASES))
def test_beam_matches_naive(llama, case):
    _, tm = llama
    c = dict(BEAM_ORACLE_CASES[case])
    ragged, eos = c.pop("ragged", False), c.pop("eos", False)
    rows, padded, lens = rows_of([6, 4] if ragged else [4, 4], seed=38)
    lens_kw = dict(prompt_lens=t_(lens)) if ragged else {}
    if eos:
        c["eos_id"] = int(tserving.generate_beam(tm, t_(padded), 6, num_beams=3)[0, 2])
    got, scores = tserving.generate_beam(tm, t_(padded), 6, return_scores=True, **lens_kw, **c)
    for b, row in enumerate(rows):
        want, want_score = naive_beam(tm, row, 6, 3, c.get("eos_id"), c.get("length_penalty", 1.0))
        assert got[b].tolist() == want
        assert float(scores[b]) == pytest.approx(want_score, abs=2e-4)


def test_beam_one_equals_greedy_and_arguments(llama):
    _, tm = llama
    prompt = t_(probe_ids(128, (2, 4), seed=39))
    assert torch.equal(tserving.generate_beam(tm, prompt, 5, num_beams=1),
                       tserving.generate(tm, prompt, 5))
    for bad in (dict(num_beams=0), dict(max_len=6)):
        with pytest.raises(ValueError):
            tserving.generate_beam(tm, prompt, 5, **bad)


def test_max_len_validation(llama):
    _, tm = llama
    prompt = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="max_len"):
        tserving.generate(tm, prompt, 8, max_len=6)
    # a longer cache changes nothing
    assert torch.equal(tserving.generate(tm, prompt, 3, max_len=16), tserving.generate(tm, prompt, 3))
    for bad in (dict(top_k=0), dict(top_p=0.0), dict(min_p=1.5), dict(repetition_penalty=0.0)):
        with pytest.raises(ValueError):
            tserving.generate(tm, prompt, 2, **bad)


def test_flash_prefill_predicate_and_static_zero():
    import types

    card_bf16 = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    plain = types.SimpleNamespace(logit_softcap=None, sliding_window=None, use_alibi=False)
    assert tserving._flash_prefill_ok(plain, 256, 64, card_bf16, None)
    assert tserving._flash_prefill_ok(plain, 100, 128, card_bf16, None)  # the kernel masks its edge
    assert tserving._flash_prefill_ok(plain, 256, 96, card_bf16, None)  # the 128 instance
    assert not tserving._flash_prefill_ok(plain, 1, 64, card_bf16, None)  # a decode step
    assert not tserving._flash_prefill_ok(plain, 256, 64, card_bf16,
                                          torch.ones(2, 12, dtype=torch.bool))
    assert not tserving._flash_prefill_ok(plain, 256, 16, card_bf16, None)  # no kernel for d 16
    assert not tserving._flash_prefill_ok(plain, 256, 64, torch.zeros(1, dtype=torch.bfloat16), None)
    assert not tserving._flash_prefill_ok(
        plain, 256, 64, types.SimpleNamespace(is_cuda=True, dtype=torch.float32), None)
    # Gemma-2's soft-capped, Gemma-3's windowed and BLOOM's ALiBi layers stay
    # plain, as in JAX
    for layer in (dict(logit_softcap=50.0, sliding_window=None, use_alibi=False),
                  dict(logit_softcap=None, sliding_window=512, use_alibi=False),
                  dict(logit_softcap=None, sliding_window=None, use_alibi=True)):
        assert not tserving._flash_prefill_ok(types.SimpleNamespace(**layer), 256, 64, card_bf16,
                                              None)
    assert tserving._is_static_zero(0) and tserving._is_static_zero(np.int32(0))
    for not_static in (3, torch.tensor(0), torch.zeros(2, dtype=torch.int64), False):
        assert not tserving._is_static_zero(not_static)


def test_flash_prefill_path_matches_einsum(llama, monkeypatch):
    """The flash branch forced on the CPU (where ``flash_attention`` runs its
    plain version): a uniform and a right-padded ragged prefill fire it;
    logits, caches and the decode that follows match the einsum path."""
    _, tm = llama
    rows, padded, lens = rows_of([7, 4], seed=40)
    ref, ref_c = tserving.forward_with_cache(tm, t_(padded), tserving.init_cache(tm, 2, 12), 0)
    want = tserving.generate(tm, t_(padded), 5, prompt_lens=t_(lens))
    fired = []
    monkeypatch.setattr(tserving, "_flash_prefill_ok",
                        lambda a, s, hd, q, kv_mask: fired.append(s) or (s > 1 and kv_mask is None))
    got, got_c = tserving.forward_with_cache(tm, t_(padded), tserving.init_cache(tm, 2, 12), 0)
    assert fired
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    for (rk, rv), (gk, gv) in zip(ref_c, got_c):
        torch.testing.assert_close(gk, rk, rtol=0, atol=1e-5)
        torch.testing.assert_close(gv, rv, rtol=0, atol=1e-5)
    # a tensor cache_pos never takes the branch
    fired.clear()
    tserving.forward_with_cache(tm, t_(padded), tserving.init_cache(tm, 2, 12), torch.zeros(2, dtype=torch.int64))
    assert fired == []
    assert torch.equal(tserving.generate(tm, t_(padded), 5, prompt_lens=t_(lens)), want)
    assert fired  # the ragged prefill took it


def test_cache_write_drops_slots_past_the_end():
    cache = torch.arange(2 * 4, dtype=torch.float32).reshape(2, 4, 1)
    new = torch.tensor([[[10.0], [11.0], [12.0]], [[20.0], [21.0], [22.0]]])
    tserving._cache_write(cache, new, torch.tensor([2, 5]))
    # row 0 writes slots 2 and 3 (its third token falls off); row 1 is
    # wholly past the end and keeps what it held
    assert cache[:, :, 0].tolist() == [[0.0, 1.0, 10.0, 11.0], [4.0, 5.0, 6.0, 7.0]]


def test_speculative_auto_gate_decisions(llama, drafts, monkeypatch):
    """Closed and open by a (faked) probe, by caller costs with measured or
    given acceptance, and by the real probe forced open or closed: the
    output is the target's greedy continuation on every branch."""
    jm, tm = llama
    _, td = drafts["decomposed"]
    prompt = t_(probe_ids(128, (2, 5), seed=41))
    want = tserving.generate(tm, prompt, 7)

    def run(**kw):
        got, stats = tserving.generate_speculative(tm, td, prompt, 7, k=3, return_stats=True,
                                                   auto_gate=True, **kw)
        assert torch.equal(got, want)
        return stats

    # the real probe, forced open and closed
    open_ = run(min_estimated_speedup=0.0, probe_tokens=4)
    assert open_["gate"]["used_speculative"] and open_["gate"]["basis"] == "measured_probe_throughput"
    assert open_["gate"]["probe"]["speculative_probe_s"] > 0 and open_["rounds"] >= 1
    closed = run(min_estimated_speedup=1e9, probe_tokens=4)
    assert not closed["gate"]["used_speculative"] and closed["rounds"] == 0
    # caller costs: measured acceptance, then given acceptance flips it
    costs = {"target_step_s": 3e-3, "target_verify_s": 3e-3, "draft_step_s": 4e-4}
    measured = run(costs=costs, probe_tokens=8)["gate"]
    assert measured["acceptance_source"] == "measured_probe"
    assert measured["assumed_acceptance"] == measured["probe"]["acceptance"]
    assert not run(costs=costs, acceptance=0.0)["gate"]["used_speculative"]
    assert run(costs=costs, acceptance=0.95)["gate"]["used_speculative"]
    # a faked probe decides alone
    for speedup, used in ((0.6, False), (2.4, True)):
        monkeypatch.setattr(tserving, "measure_speculative_speedup_probe",
                            lambda *a, s=speedup, **kw: {"measured_speedup": s})
        assert run()["gate"]["used_speculative"] is used
    est = tserving.estimate_speculative_speedup(tm, td, 2, k=3, max_len=32)
    assert est["target_step_s"] > 0 and est["draft_step_s"] > 0 and est["expected_speedup"] > 0


def test_measure_draft_acceptance_self_draft_is_total(llama):
    _, tm = llama
    prompt = t_(probe_ids(128, (2, 4), seed=42))
    probe = tserving.measure_draft_acceptance(tm, tm, prompt, k=2, probe_tokens=8)
    # every draft the target sees is accepted; the budget cuts the last
    # round's emitted drafts, which count as drafted and not as accepted
    assert 0.75 <= probe["acceptance"] <= 1.0 and probe["drafted"] >= probe["accepted"] > 0
