"""The rest of the port's ``dwain.decompose`` on the CPU: interleaved
fine-tuning on the GQA golden, covariances precomputed in splits, the
randomized top-k EVD, the attention toy golden, and resumable checkpoints,
against the goldens of the torch reference and against the JAX package."""

import functools
import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptdeco_tpu import dwain as jdwain, engine as jengine, models as jmodels, nn as jnn
from ptdeco_tpu import utils as jutils
from ptdeco_tpu_torch import dwain, engine, models, utils
from ptdeco_tpu_torch.dwain import decomposition

from test_dwain_e2e import loss_fn as jax_e2e_loss, lowrank_data_iter, make_mlp as jax_e2e_mlp
from test_randomized_evd import _make_gram, _run_decompose as _jax_run_decompose
from test_torch_dwain import _CNN, _MLP, _cycle_ids, _cycle_labelled, _hf_cfg, _probe
from test_torch_transformer import make_torch_gqa
from test_transformer_parity import _hparams, _load, assert_decisions

GOLDEN = pathlib.Path(__file__).parent / "golden"


def make_torch_sgd_finetune(ft_ids, last_n, lr, steps):
    """Torch mirror of tests/test_transformer_parity.py:make_native_sgd_finetune
    (the generator's SGD recovery fine-tune): the last_n decomposed pairs
    train with plain SGD on a fixed pool restarted each call."""

    def ft(module, decomposed_names):
        names = decomposed_names[-last_n:]
        if not names:
            return module
        params = [p for n in names for p in module.get_submodule(n).parameters()]
        chosen = {id(p) for p in params}
        frozen = [p for p in module.parameters() if id(p) not in chosen]
        for p in frozen:
            p.requires_grad_(False)
        opt = torch.optim.SGD(params, lr=lr)
        try:
            for i in range(steps):
                batch = {"input_ids": torch.from_numpy(ft_ids[i % len(ft_ids)].astype(np.int64))}
                opt.zero_grad()
                models.ce_loss(batch, module(batch)).backward()
                opt.step()
        finally:
            for p in frozen:
                p.requires_grad_(True)
            for p in params:
                p.grad = None
        return module

    return ft


def test_gqa_interleaved_finetune_matches_golden():
    """The gqa_ft walk as tests/test_transformer_parity.py:228-248 runs it
    for the JAX package: decisions equal the reference's, probe logits
    within 2e-2 of its fine-tuned model's."""
    hp, ft = _hparams()["gqa"], _hparams()["ft"]
    data, init_sd = _load("gqa")
    model, config = dwain.decompose(
        module=make_torch_gqa(init_sd, _hf_cfg()),
        data_iterator=_cycle_ids(data["calib_ids"]),
        loss_fn=models.ce_loss,
        metric_iterator=_cycle_ids(data["metric_ids"]),
        finetune_fn=make_torch_sgd_finetune(data["ft_ids"], ft["last_n"], ft["lr"], ft["steps"]),
        blacklisted_module_names=["lm_head"],
        device="cpu",
        **hp,
    )
    assert_decisions(config, "gqa_ft", check_meta_values=False)
    with torch.no_grad():
        y = model(_probe(data)).numpy()
    np.testing.assert_allclose(y, data["y_gqa_ft"], atol=2e-2)


class _Attn(torch.nn.Module):
    """Torch twin of tests/test_whole_model_parity.py:Attn (the reference
    generator's single-head attention toy)."""

    def __init__(self):
        super().__init__()
        self.ln1, self.ln2 = torch.nn.LayerNorm(48), torch.nn.LayerNorm(48)
        self.q, self.k, self.v, self.o = (torch.nn.Linear(48, 48) for _ in range(4))
        self.fc1, self.fc2 = torch.nn.Linear(48, 96), torch.nn.Linear(96, 48)
        self.head = torch.nn.Linear(48, 10)

    def forward(self, batch):
        x = batch["inp"] if isinstance(batch, dict) else batch
        h = self.ln1(x)
        a = torch.softmax(self.q(h) @ self.k(h).transpose(-2, -1) / 48.0 ** 0.5, dim=-1)
        x = x + self.o(a @ self.v(h))
        x = x + self.fc2(torch.relu(self.fc1(self.ln2(x))))
        return self.head(x.mean(dim=1))


def _cnn_channels_last():
    return _CNN().to(memory_format=torch.channels_last)


@pytest.mark.parametrize(
    "family,make,stem,out_key,extra",
    [("mlp", _MLP, "whole_dwain_mlp_pre", "y_dwain_pre", {"precomputing_covariance_num_splits": 2}),
     ("attn", _Attn, "whole_dwain_attn", "y_dwain", {}),
     ("cnn", _cnn_channels_last, "whole_dwain_cnn", "y_dwain", {})],
    ids=["mlp_pre", "attn", "cnn_channels_last"],
)
def test_whole_model_goldens(family, make, stem, out_key, extra):
    """The precompute mode (2 splits), the attention toy and the CNN toy run
    channels_last (its 1x1 sites' rows are views of the activations)
    against the torch reference's decisions and final outputs."""
    with open(GOLDEN / "whole_model_hparams.json") as f:
        hp = json.load(f)["dwain"]
    data = np.load(GOLDEN / f"whole_{family}_data.npz")
    init_sd = {k[len("init__"):]: data[k] for k in data.files if k.startswith("init__")}
    model, config = dwain.decompose(
        module=utils.load_numpy_state_dict(make(), init_sd),
        data_iterator=_cycle_labelled(data["calib_x"], data["calib_y"]),
        loss_fn=lambda batch, logits: torch.nn.functional.cross_entropy(logits, batch["labels"]),
        metric_iterator=_cycle_labelled(data["metric_x"], data["metric_y"]),
        device="cpu",
        **hp,
        **extra,
    )
    assert_decisions(config, stem)
    ref_sd = dict(np.load(GOLDEN / f"{stem}_sd.npz").items())
    assert {k: tuple(v.shape) for k, v in utils.state_dict(model).items()} == {
        k: tuple(v.shape) for k, v in ref_sd.items()
    }
    with torch.no_grad():
        y = model(torch.from_numpy(data["probe"])).numpy()
    np.testing.assert_allclose(y, data[out_key], atol=5e-4)


# --- the randomized top-k EVD ---------------------------------------------


def test_randomized_projector_matches_jax():
    """Inside the spectral gap the rank-k projector is unique: the port's
    randomized eigenvectors give the JAX package's projector and the exact
    one (tests/test_randomized_evd.py's Gram and limit)."""
    g = _make_gram()
    u = engine.randomized_topk_eigenvectors(torch.from_numpy(np.array(g)), top_k=128)
    assert u.shape == (256, 128) and u.dtype == torch.float32
    u_jax = np.asarray(jengine.randomized_topk_eigenvectors(g, top_k=128))
    u_exact = engine.eigenvectors_from_gram(torch.from_numpy(np.array(g))).numpy()
    for rank in (4, 8, 16):
        p = u[:, -rank:].numpy() @ u[:, -rank:].numpy().T
        np.testing.assert_allclose(p, u_jax[:, -rank:] @ u_jax[:, -rank:].T, atol=5e-4)
        np.testing.assert_allclose(p, u_exact[:, -rank:] @ u_exact[:, -rank:].T, atol=5e-4)
    # ascending: the last column spans the top eigenvalue's direction
    lam = (u.t() @ torch.from_numpy(np.array(g)) @ u).diagonal()
    assert torch.all(lam[1:] >= lam[:-1] - 1e-4)


def test_split_phases_match_fused_helper():
    g = torch.from_numpy(np.array(_make_gram(seed=3)))
    u1 = engine.randomized_topk_eigenvectors(g, top_k=64)
    q, b = engine.sketch_for_randomized_eigh(g, 64)
    assert b.dtype == torch.float64
    u2 = engine.finish_randomized_eigh(q, torch.linalg.eigh(b)[1], 64)
    torch.testing.assert_close(u1, u2, rtol=0, atol=0)


class _E2EMLP(torch.nn.Module):
    """Torch twin of tests/test_dwain_e2e.py:MLP."""

    def __init__(self, d=64, n_out=8):
        super().__init__()
        self.fc1, self.fc2, self.head = (
            torch.nn.Linear(d, d), torch.nn.Linear(d, d), torch.nn.Linear(d, n_out)
        )

    def forward(self, batch):
        x = batch["inp"] if isinstance(batch, dict) else batch
        return self.head(torch.relu(self.fc2(torch.relu(self.fc1(x)))))


def _e2e_twin(d=64):
    return utils.load_numpy_state_dict(_E2EMLP(d), jutils.state_dict(jax_e2e_mlp(d)))


def _torch_lowrank_iter(seed, bs, d):
    """tests/test_dwain_e2e.py:lowrank_data_iter's batches, as torch tensors."""
    for b in lowrank_data_iter(jax.random.PRNGKey(seed), bs, d):
        yield {"inp": torch.from_numpy(np.asarray(b["inp"]))}


def _e2e_loss(batch, out):
    return torch.mean(torch.square(out)) * 0.01


def _run_e2e(eigh_method="exact", precompute=None, **kw):
    """tests/test_randomized_evd.py:_run_decompose's walk through the port."""
    return dwain.decompose(
        module=_e2e_twin(),
        data_iterator=_torch_lowrank_iter(0, 16, 64),
        loss_fn=_e2e_loss,
        num_data_steps=3,
        metric_iterator=_torch_lowrank_iter(1, 16, 64),
        num_metric_steps=2,
        nsr_final_threshold=0.2,
        blacklisted_module_names=["head"],
        min_rank=2,
        trade_off_factor=1000.0,
        max_accepted_ppl_diff=1.0,
        eigh_method=eigh_method,
        precomputing_covariance_num_splits=precompute,
        device="cpu",
        **kw,
    )


@functools.lru_cache(maxsize=None)
def _jax_modules(eigh_method, precompute=None):
    """Each site's "modules" entry of the JAX package's walk on the model the
    twin is loaded from, with the same batches."""
    _, cfg = _jax_run_decompose(eigh_method, precompute)
    return {k: v["modules"] for k, v in cfg.items()}


def _modules(cfg):
    return {k: v["modules"] for k, v in cfg.items()}


@pytest.fixture(scope="module")
def e2e_exact():
    return _run_e2e("exact")


@pytest.fixture(scope="module")
def e2e_randomized():
    return _run_e2e("randomized")


def test_randomized_decisions_equal_exact(e2e_exact, e2e_randomized):
    _, cfg_exact = e2e_exact
    _, cfg_rand = e2e_randomized
    assert cfg_exact.keys() == cfg_rand.keys() and len(cfg_exact) == 2
    for k in cfg_exact:
        assert cfg_exact[k]["modules"] == cfg_rand[k]["modules"]
    # and each equals the JAX package's walk with the same method
    assert _modules(cfg_exact) == _jax_modules("exact")
    assert _modules(cfg_rand) == _jax_modules("randomized")


@pytest.mark.parametrize("method", ["randomized", "auto"])
def test_pipelined_precompute_equals_direct_walk(e2e_exact, e2e_randomized, method, caplog):
    """The precompute's worker-thread eighs reproduce the direct walk's
    decisions (auto takes the exact eigh at these widths) and the JAX
    package's pipelined walk's; the walk logs the pipeline's job and wait
    seconds."""
    _, cfg_direct = e2e_randomized if method == "randomized" else e2e_exact
    with caplog.at_level(logging.INFO, logger=decomposition.__name__):
        _, cfg_pipe = _run_e2e(method, precompute=1)
    assert cfg_direct.keys() == cfg_pipe.keys()
    for k in cfg_direct:
        assert cfg_direct[k]["modules"] == cfg_pipe[k]["modules"]
    assert _modules(cfg_pipe) == _jax_modules(method, 1)
    logged = [r for r in caplog.records if hasattr(r, "eigh_job_s")]
    assert len(logged) == 1 and logged[0].eigh_job_s >= 0 and logged[0].eigh_wait_s >= 0


def test_exact_precompute_is_deterministic(e2e_exact):
    m1, cfg1 = _run_e2e("exact", precompute=1)
    m2, cfg2 = _run_e2e("exact", precompute=1)
    assert cfg1 == cfg2 and cfg1.keys() == e2e_exact[1].keys()
    assert _modules(cfg1) == _jax_modules("exact", 1)
    batch = next(_torch_lowrank_iter(7, 8, 64))
    with torch.no_grad():
        torch.testing.assert_close(m1(batch), m2(batch), rtol=0, atol=0)


def test_resolve_eigh_method():
    small = engine.Site("s", "linear", 64, 64, True, torch.float32)
    wide = engine.Site("w", "linear", 8192, 4096, True, torch.float32)
    # auto keys on the output Gram's width: TinyLlama's up projection
    # (2048 -> 5632) takes the randomized EVD, its down projection
    # (5632 -> 2048) the exact eigh
    up = engine.Site("u", "linear", 2048, 5632, False, torch.bfloat16)
    down = engine.Site("d", "linear", 5632, 2048, False, torch.bfloat16)
    assert decomposition._resolve_eigh_method(small, "auto") == "exact"
    assert decomposition._resolve_eigh_method(wide, "auto") == "randomized"
    assert decomposition._resolve_eigh_method(up, "auto") == "randomized"
    assert decomposition._resolve_eigh_method(down, "auto") == "exact"
    assert decomposition._resolve_eigh_method(small, "randomized") == "randomized"


def test_provider_pops_in_any_order():
    provider = decomposition._AsyncUProvider("cpu")
    provider.submit("a", lambda: torch.ones(2))
    provider.submit("b", lambda: torch.zeros(3), lambda t: t + 5)
    provider.put("c", torch.full((1,), 7.0))
    assert len(provider) == 3
    torch.testing.assert_close(provider.pop("b"), torch.full((3,), 5.0))
    torch.testing.assert_close(provider.pop("c"), torch.full((1,), 7.0))
    torch.testing.assert_close(provider.pop("a"), torch.ones(2))
    assert provider.pop("a", "none") == "none" and len(provider) == 0
    assert provider.job_s >= 0 and provider.wait_s >= 0
    provider.shutdown()


# --- resumable checkpoints ---------------------------------------------------


def _resume_walk(model, tmp, **kw):
    """tests/test_dwain_resume.py's walk through the port."""
    return dwain.decompose(
        module=model,
        data_iterator=_torch_lowrank_iter(0, 16, 64),
        loss_fn=_e2e_loss,
        num_data_steps=2,
        metric_iterator=_torch_lowrank_iter(1, 16, 64),
        num_metric_steps=1,
        nsr_final_threshold=0.2,
        blacklisted_module_names=["head"],
        min_rank=2,
        trade_off_factor=1000.0,
        max_accepted_ppl_diff=1.0,
        checkpoint_dir=str(tmp),
        device="cpu",
        **kw,
    )


def test_resume_replays_completed_sites(tmp_path):
    m1, cfg1 = _resume_walk(_e2e_twin(), tmp_path / "ckpt")
    progress = (tmp_path / "ckpt" / "progress.jsonl").read_text().splitlines()
    assert [json.loads(line)["site"] for line in progress] == ["fc2", "fc1"]
    assert sorted(p.name for p in (tmp_path / "ckpt").glob("*.pt")) == ["fc1.pt", "fc2.pt"]
    # a restart on the original model with the same directory replays both
    # sites without drawing a batch
    m2, cfg2 = dwain.decompose(
        module=_e2e_twin(), data_iterator=iter([next(_torch_lowrank_iter(0, 16, 64))]),
        loss_fn=_e2e_loss, num_data_steps=2, metric_iterator=iter([]), num_metric_steps=1,
        nsr_final_threshold=0.2, blacklisted_module_names=["head"], min_rank=2,
        trade_off_factor=1000.0, max_accepted_ppl_diff=1.0,
        checkpoint_dir=str(tmp_path / "ckpt"), device="cpu",
    )
    assert cfg2 == cfg1
    batch = next(_torch_lowrank_iter(9, 8, 64))
    with torch.no_grad():
        torch.testing.assert_close(m1(batch), m2(batch), rtol=0, atol=0)
    assert len(progress) == len((tmp_path / "ckpt" / "progress.jsonl").read_text().splitlines())


def test_checkpoint_records_skips(tmp_path):
    model = models.make_mlp(dim=16, depth=2, n_out=4, device="cpu")

    def it(seed):
        g = torch.Generator().manual_seed(seed)
        while True:
            yield {"inp": torch.randn(32, 16, generator=g)}

    _, cfg = dwain.decompose(
        module=model, data_iterator=it(0), loss_fn=_e2e_loss, num_data_steps=1,
        metric_iterator=it(1), num_metric_steps=1,
        nsr_final_threshold=1e-9,  # everything rejected
        min_rank=2, trade_off_factor=0.5, max_accepted_ppl_diff=1e-9,
        checkpoint_dir=str(tmp_path / "c2"), device="cpu",
    )
    assert cfg == {}
    recs = [json.loads(line) for line in (tmp_path / "c2" / "progress.jsonl").read_text().splitlines()]
    assert [r["site"] for r in recs] == ["head", "blocks.1", "blocks.0"]
    assert all(r["config"] is None for r in recs)


def test_fingerprint_mismatch_raises(tmp_path):
    _resume_walk(_e2e_twin(), tmp_path / "ckpt")
    fingerprint = (tmp_path / "ckpt" / "fingerprint.txt").read_text()
    assert json.loads(fingerprint)["sites"] == ["fc1", "fc2"]
    with pytest.raises(ValueError, match="fingerprint"):
        _resume_walk(_e2e_twin(), tmp_path / "ckpt", eigh_method="randomized")


# --- interleaved fine-tuning against the JAX package's progress ----------

FT_DIM, FT_DEPTH, FT_LAST_N, FT_LR, FT_STEPS = 32, 3, 2, 0.05, 2


def _ft_pool():
    return [np.asarray(next(lowrank_data_iter(jax.random.PRNGKey(50 + i), 8, FT_DIM))["inp"])
            for i in range(3)]


def _jax_sgd_finetune(pool):
    def ft(module, names):
        names = names[-FT_LAST_N:]
        paths = jnn.tree_paths_of(module, names)
        trainable, frozen = jnn.partition(
            module, lambda p, leaf: jax.tree_util.keystr(p) in paths
        )
        tx = optax.sgd(FT_LR)
        opt = tx.init(trainable)
        for i in range(FT_STEPS):
            batch = {"inp": jnp.asarray(pool[i % len(pool)])}
            grads = jax.grad(lambda tr: jax_e2e_loss(batch, jnn.combine(tr, frozen)(batch)))(
                trainable
            )
            updates, opt = tx.update(grads, opt, trainable)
            trainable = optax.apply_updates(trainable, updates)
        return jnn.combine(trainable, frozen)

    return ft


def _torch_sgd_finetune(pool):
    def ft(module, names):
        params = [p for n in names[-FT_LAST_N:] for p in module.get_submodule(n).parameters()]
        opt = torch.optim.SGD(params, lr=FT_LR)
        for i in range(FT_STEPS):
            batch = {"inp": torch.from_numpy(pool[i % len(pool)])}
            opt.zero_grad()
            _e2e_loss(batch, module(batch)).backward()
            opt.step()
        for p in module.parameters():
            p.grad = None
        return module

    return ft


def _ft_walk_kw():
    return dict(num_data_steps=2, num_metric_steps=1, nsr_final_threshold=0.2,
                blacklisted_module_names=["head"], min_rank=2, trade_off_factor=1000.0,
                max_accepted_ppl_diff=1.0)


def _torch_ft_walk(tmp):
    jm = jmodels.make_mlp(jax.random.PRNGKey(3), dim=FT_DIM, depth=FT_DEPTH, n_out=4)
    tm = utils.load_numpy_state_dict(
        models.make_mlp(FT_DIM, FT_DEPTH, 4, device="cpu"), jutils.state_dict(jm)
    )
    return dwain.decompose(
        module=tm, data_iterator=_torch_lowrank_iter(10, 16, FT_DIM), loss_fn=_e2e_loss,
        metric_iterator=_torch_lowrank_iter(11, 16, FT_DIM),
        finetune_fn=_torch_sgd_finetune(_ft_pool()), checkpoint_dir=str(tmp), device="cpu",
        **_ft_walk_kw(),
    )


def _sites(directory):
    lines = (directory / "progress.jsonl").read_text().splitlines()
    return [json.loads(line)["site"] for line in lines]


def test_progress_under_interleaved_finetune_matches_jax(tmp_path):
    """Each accepted site re-records exactly the earlier pairs the fine-tune
    changed (here the one before it, in the last-2 window), in the JAX
    package's order; a restart replays the fine-tuned pairs bit-equal."""
    jm = jmodels.make_mlp(jax.random.PRNGKey(3), dim=FT_DIM, depth=FT_DEPTH, n_out=4)
    _, jax_cfg = jdwain.decompose(
        module=jm, data_iterator=lowrank_data_iter(jax.random.PRNGKey(10), 16, FT_DIM),
        loss_fn=jax_e2e_loss, metric_iterator=lowrank_data_iter(jax.random.PRNGKey(11), 16, FT_DIM),
        finetune_fn=_jax_sgd_finetune(_ft_pool()), checkpoint_dir=str(tmp_path / "jax"),
        **_ft_walk_kw(),
    )
    m1, cfg1 = _torch_ft_walk(tmp_path / "port")
    assert {k: v["modules"] for k, v in cfg1.items()} == {
        k: v["modules"] for k, v in jax_cfg.items()
    }
    sites = _sites(tmp_path / "port")
    assert sites == _sites(tmp_path / "jax")
    assert sites == ["blocks.2", "blocks.2", "blocks.1", "blocks.1", "blocks.0"]
    m2, cfg2 = _torch_ft_walk(tmp_path / "port")
    assert cfg2 == cfg1 and _sites(tmp_path / "port") == sites
    batch = next(_torch_lowrank_iter(12, 8, FT_DIM))
    with torch.no_grad():
        torch.testing.assert_close(m1(batch), m2(batch), rtol=0, atol=0)
