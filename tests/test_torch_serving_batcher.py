"""The port's continuous batcher (``ptdeco_tpu_torch/serving_batcher.py``)
on the CPU: its greedy stream against the JAX package's
``ContinuousBatcher`` on the same requests (tokens and finish reasons
exactly, the golden GQA llama in f32), and the cases of
``tests/test_serving_batcher.py`` other than the tp mesh and the recurrent
families: every request's tokens equal ``serving.generate`` on that prompt
alone, through slot reuse, bucket padding, chunked decode, eos retirement
and writes past the end of the cache."""

import numpy as np
import pytest
import torch

from ptdeco_tpu.serving_batcher import ContinuousBatcher as JaxBatcher
from ptdeco_tpu_torch import quant as tquant, serving as tserving
from ptdeco_tpu_torch.serving_batcher import ContinuousBatcher

from test_torch_serving import golden_llama


@pytest.fixture(scope="module")
def llama():
    return golden_llama()


def oracle(tm, prompt, n_new):
    """Single-request greedy reference: ``serving.generate`` on a batch of 1."""
    return tserving.generate(tm, torch.from_numpy(np.asarray(prompt, np.int64))[None], n_new)[0].numpy()


REQUESTS = [(3, 5), (7, 4), (5, 9), (2, 6), (6, 3)]  # (prompt length, budget)


def requests(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, plen), budget) for plen, budget in REQUESTS]


def _cut_at_eos(full, eos):
    hit = np.nonzero(full == eos)[0]
    if hit.size:
        return full[: hit[0] + 1], "eos"
    return full, "length"


@pytest.mark.parametrize("with_eos", [False, True])
def test_greedy_stream_matches_jax_batcher(llama, with_eos):
    """5 requests through a 2-slot pool of 16 slots a row, chunks of 3:
    slot reuse, and rows that decode past the end of their cache."""
    jm, tm = llama
    reqs = requests(seed=2)
    eos = int(oracle(tm, reqs[2][0], 9)[4]) if with_eos else None
    engines = (ContinuousBatcher(tm, n_slots=2, max_len=16, decode_chunk=3, eos_id=eos),
               JaxBatcher(jm, n_slots=2, max_len=16, decode_chunk=3, eos_id=eos))
    for prompt, budget in reqs:
        for eng in engines:
            eng.submit(prompt.astype(np.int32), budget)
    got, want = ({f.req_id: f for f in eng.run()} for eng in engines)
    assert got.keys() == want.keys() == set(range(5))
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].finish_reason == want[rid].finish_reason
    if with_eos:
        assert any(f.finish_reason == "eos" for f in got.values())


def test_stream_matches_per_request_generate(llama):
    _, tm = llama
    eng = ContinuousBatcher(tm, n_slots=2, max_len=32, decode_chunk=3)
    ids = {eng.submit(prompt, budget): (prompt, budget) for prompt, budget in requests(seed=3)}
    finished = eng.run()
    assert len(finished) == 5 and not eng.has_work
    for f in finished:
        prompt, budget = ids[f.req_id]
        assert f.finish_reason == "length" and len(f.tokens) == budget
        np.testing.assert_array_equal(f.tokens, oracle(tm, prompt, budget))


def test_eos_retires_early_and_slot_is_reused(llama):
    _, tm = llama
    prompt = np.asarray([5, 9, 2, 41])
    full = oracle(tm, prompt, 10)
    # the eos whose first occurrence is latest: a real prefix is decoded
    first_at = {int(t): j for j in range(len(full) - 1, -1, -1) for t in [full[j]]}
    eos = max(first_at, key=first_at.get)
    want1, reason1 = _cut_at_eos(full, eos)
    assert reason1 == "eos" and len(want1) < len(full)
    eng = ContinuousBatcher(tm, n_slots=1, max_len=32, eos_id=eos, decode_chunk=4)
    rid1 = eng.submit(prompt, 10)
    prompt2 = np.asarray([7, 7, 1])
    rid2 = eng.submit(prompt2, 4)
    done = {f.req_id: f for f in eng.run()}
    assert done[rid1].finish_reason == reason1
    np.testing.assert_array_equal(done[rid1].tokens, want1)
    # request 2 ran in the reused slot
    want2, reason2 = _cut_at_eos(oracle(tm, prompt2, 4), eos)
    assert done[rid2].finish_reason == reason2
    np.testing.assert_array_equal(done[rid2].tokens, want2)


def test_first_token_eos_and_budget_one(llama):
    _, tm = llama
    prompt = np.asarray([1, 2, 3])
    first = int(oracle(tm, prompt, 1)[0])
    eng = ContinuousBatcher(tm, n_slots=2, max_len=16, eos_id=first)
    rid = eng.submit(prompt, 5)
    done = {f.req_id: f for f in eng.run()}
    assert done[rid].finish_reason == "eos"
    np.testing.assert_array_equal(done[rid].tokens, [first])
    eng2 = ContinuousBatcher(tm, n_slots=2, max_len=16)
    rid2 = eng2.submit(prompt, 1)  # retires straight from its prefill
    done2 = {f.req_id: f for f in eng2.run()}
    assert done2[rid2].finish_reason == "length"
    np.testing.assert_array_equal(done2[rid2].tokens, [first])


def test_quantized_model_through_engine():
    _, tm = golden_llama()
    qm = tquant.quantize_for_serving(tm)
    prompt = np.asarray([11, 3, 29, 8, 44])
    eng = ContinuousBatcher(qm, n_slots=2, max_len=24, decode_chunk=2)
    rid = eng.submit(prompt, 6)
    done = {f.req_id: f for f in eng.run()}
    np.testing.assert_array_equal(done[rid].tokens, oracle(qm, prompt, 6))


def test_sampling_reproducible_and_valid(llama):
    _, tm = llama

    def stream():
        eng = ContinuousBatcher(tm, n_slots=2, max_len=24, temperature=0.8, top_p=0.9, top_k=20,
                                min_p=0.01, generator=torch.Generator().manual_seed(7))
        rid = eng.submit(np.asarray([1, 2]), 5)
        return {f.req_id: f for f in eng.run()}[rid].tokens

    toks = stream()
    assert toks.shape == (5,) and (toks >= 0).all() and (toks < 128).all()
    np.testing.assert_array_equal(stream(), toks)


def test_refusals(llama):
    _, tm = llama
    eng = ContinuousBatcher(tm, n_slots=1, max_len=16)
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(10), 10)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(np.arange(4), 0)
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros((0,), np.int64), 3)
    for bad, match in ((dict(n_slots=0), "n_slots"), (dict(decode_chunk=0), "decode_chunk"),
                       (dict(top_p=0.0), "top_p"), (dict(top_k=0), "top_k"),
                       (dict(min_p=2.0), "min_p"), (dict(temperature=-1.0), "temperature"),
                       (dict(prefill_buckets=(32,)), "bucket")):
        with pytest.raises(ValueError, match=match):
            ContinuousBatcher(tm, **{"n_slots": 1, "max_len": 16, **bad})


def test_bucket_padding_is_invisible(llama):
    """A prompt padded up to a larger bucket gives the tokens of one that
    lands exactly on its bucket."""
    _, tm = llama
    prompt = np.asarray([4, 8, 15, 16, 23])
    streams = []
    for buckets in ((16, 32), (5, 32)):
        eng = ContinuousBatcher(tm, n_slots=1, max_len=32, prefill_buckets=buckets)
        rid = eng.submit(prompt, 4)
        streams.append({f.req_id: f for f in eng.run()}[rid].tokens)
    np.testing.assert_array_equal(streams[0], oracle(tm, prompt, 4))
    np.testing.assert_array_equal(streams[1], streams[0])


def test_submit_validation_against_buckets_and_req_ids(llama):
    _, tm = llama
    eng = ContinuousBatcher(tm, n_slots=1, max_len=64, prefill_buckets=(8,))
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(np.arange(9), 4)
    assert not eng.has_work
    assert eng.submit(np.asarray([1, 2, 3]), 2, req_id=5) == 5
    with pytest.raises(ValueError, match="duplicates"):
        eng.submit(np.asarray([4]), 2, req_id=5)
    auto = eng.submit(np.asarray([4]), 2)
    assert auto > 5
    assert {f.req_id for f in eng.run()} == {5, auto}
