"""The PyTorch port's engine against the JAX package's, on a small MLP with
the same numpy weights and batches, on the CPU: site discovery, the
calibration Grams, the damped eigenbasis, candidate weights, factors and
the candidate metrics' iterator order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptdeco_tpu import engine as jengine, models as jmodels, utils as jutils
from ptdeco_tpu_torch import engine, models, utils

DIM, DEPTH, N_OUT = 48, 2, 8


@pytest.fixture(scope="module")
def twins():
    jm = jmodels.make_mlp(jax.random.PRNGKey(0), dim=DIM, depth=DEPTH, n_out=N_OUT)
    sd = jutils.state_dict(jm)
    tm = utils.load_numpy_state_dict(models.make_mlp(DIM, DEPTH, N_OUT, device="cpu"), sd)
    rng = np.random.default_rng(0)
    batches = [rng.standard_normal((6, DIM)).astype(np.float32) for _ in range(5)]
    return jm, tm, batches


def test_site_discovery_matches(twins):
    jm, tm, _ = twins
    assert engine.get_decomposeable_submodule_names(tm, ["head"]) == (
        jengine.get_decomposeable_submodule_names(jm, ["head"])
    )
    site = engine.get_site(tm, "blocks.1")
    assert (site.kind, site.in_features, site.out_features, site.full_rank) == (
        "linear", DIM, DIM, DIM,
    )
    assert engine.fired_site_names(tm, ["blocks.0", "head"], torch.zeros(1, DIM)) == [
        "blocks.0", "head",
    ]


def test_output_grams_match(twins):
    jm, tm, batches = twins
    names = ["blocks.0", "blocks.1", "head"]
    ours = engine.compute_output_grams(
        tm, names, iter([torch.from_numpy(b) for b in batches]), len(batches), device="cpu"
    )
    theirs, _ = jengine.compute_output_grams(
        jm, names, iter([jnp.asarray(b) for b in batches]), len(batches)
    )
    for n in names:
        np.testing.assert_allclose(ours[n].numpy(), np.asarray(theirs[n]), rtol=1e-5, atol=1e-5)


def test_eigenbasis_candidates_and_factors_match(twins):
    jm, tm, batches = twins
    gram = engine.compute_output_grams(
        tm, ["blocks.1"], iter([torch.from_numpy(b) for b in batches]), 5, device="cpu"
    )["blocks.1"]
    for top_k in (None, DIM // 4):
        u = engine.eigenvectors_from_gram(gram, top_k=top_k)
        uj = jengine.eigenvectors_from_gram(jnp.asarray(gram.numpy()), top_k=top_k)
        assert u.dtype == torch.float64 and tuple(u.shape) == uj.shape
        # eigenvector signs may differ; the rank-k projectors may not
        for k in (4, 12):
            pu = u[:, -k:] @ u[:, -k:].t()
            pj = uj[:, -k:] @ uj[:, -k:].T
            np.testing.assert_allclose(pu.numpy(), pj, atol=1e-8)

    u32 = engine.eigenvectors_from_gram(gram).to(torch.float32)
    w = engine.get_site_weight2d(tm, engine.get_site(tm, "blocks.1"))
    kernel = jnp.asarray(w.numpy().T)
    uj32 = jnp.asarray(u32.numpy())
    for rank in (DIM, 12):
        deco = engine.compose_deco_kernel(w, u32, rank)
        deco_j = jengine.compose_deco_kernel(kernel, uj32, jnp.int32(rank))
        np.testing.assert_allclose(deco.numpy(), np.asarray(deco_j).T, atol=1e-5)
    # full rank reproduces the weight
    np.testing.assert_allclose(engine.compose_deco_kernel(w, u32, DIM).numpy(), w.numpy(), atol=1e-5)

    w1, w2 = engine.build_factors(w, u32, 12)
    k1, k2 = jengine.build_factors(kernel, u32.numpy(), 12)
    np.testing.assert_allclose(w1.numpy(), np.asarray(k1).T, atol=1e-5)
    np.testing.assert_allclose(w2.numpy(), np.asarray(k2).T, atol=1e-6)
    pair = engine.build_decomposed_module(tm, engine.get_site(tm, "blocks.1"), w1, w2)
    x = torch.from_numpy(batches[0])
    with torch.no_grad():
        np.testing.assert_allclose(
            pair(x).numpy(), (x @ (w2 @ w1).t() + tm.blocks[1].bias).numpy(), atol=1e-5
        )
    assert pair[0].bias is None and pair[1].bias is not None


def test_candidate_evaluator_draws_batches_candidate_major(twins):
    _, tm, batches = twins
    site = engine.get_site(tm, "blocks.1")
    drawn = []

    def metric_iter():
        for i in range(100):
            drawn.append(i)
            yield torch.full((2, DIM), float(i))

    def metric_fn(batch, y_deco, y_orig):
        return torch.stack([batch[0, 0], (y_deco - y_orig).abs().max()])

    w = engine.get_site_weight2d(tm, site).clone()
    u = torch.linalg.eigh(torch.eye(DIM) + torch.diag(torch.arange(DIM, dtype=torch.float32)))[1]
    raw = engine.CandidateEvaluator(site, engine.default_apply, metric_fn, "cpu")(
        tm, w, u, [24, 12, 6], metric_iter(), 2
    )
    assert raw.shape == (3, 2, 2) and raw.dtype == np.float32
    np.testing.assert_array_equal(raw[:, :, 0], [[0, 1], [2, 3], [4, 5]])
    assert drawn == list(range(6))
    assert (raw[:, :, 1] > 0).all()  # the deco forward saw the candidate weight
    torch.testing.assert_close(tm.blocks[1].weight.detach(), w, rtol=0, atol=0)  # restored


def test_param_accounting_matches():
    for p, i, o in [(0.5, 64, 32), (0.25, 2048, 5632), (1.0, 10, 10), (0.9, 16, 16)]:
        assert engine.get_params_for_proportion(p, i, o) == jengine.get_params_for_proportion(p, i, o)
        assert engine.is_num_params_reduced(p, i, o) == jengine.is_num_params_reduced(p, i, o)
