"""The port's vision trainer CLI against the JAX trainer on the CPU: the
four tasks run through both ``main``s on the same synthetic pipelines and
the same weights (a ``.pt`` both builders load): falor's and dwain's
``decompose_config.json`` equal, their pairs' products within 1e-5
(an eigenvector's sign is free), the same summary keys; lockd fed the JAX
run's students and Gumbel noise; the KD task's loss and trained weights;
the training checkpointer's three cases; the shipped yamls through the
port's configurator; the refusals and the FLOPs counts."""

import json
import logging
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apps.trainer_vision import builder as jbuilder
from apps.trainer_vision import run_decompose_dwain as jrun_dwain
from apps.trainer_vision import run_decompose_falor as jrun_falor
from apps.trainer_vision import run_decompose_lockd as jrun_lockd
from apps.trainer_vision import run_finetune as jrun_finetune
from ptdeco_tpu import lockd as jlockd, nn as jnn, utils as jutils
from ptdeco_tpu_torch import lockd, utils
from ptdeco_tpu_torch.apps.trainer_vision import (
    builder,
    configurator,
    datasets_image,
    run,
    run_decompose_dwain,
    run_decompose_lockd,
    run_finetune,
)
from ptdeco_tpu_torch.models.convnext import init_uniform
from ptdeco_tpu_torch.utils.train_ckpt import TrainCheckpointer

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "apps" / "trainer_vision" / "examples_config"
NAME = "tinycnn_twin"


class TinyCNN(torch.nn.Module):
    """tests/test_trainer_vision.py's TinyCNN: a 3x3 conv + BatchNorm, a
    1x1 conv site and the fc, under the JAX model's names."""

    def __init__(self, num_classes=1000, device="cpu", generator=None):
        super().__init__()
        self.conv1 = torch.nn.Conv2d(3, 8, 3, padding=1, bias=False, device=device)
        self.bn1 = torch.nn.BatchNorm2d(8, device=device)
        self.conv2 = torch.nn.Conv2d(8, 16, 1, device=device)
        self.fc = torch.nn.Linear(16, num_classes, device=device)
        init_uniform(self, generator)

    def forward(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        return self.fc(torch.relu(self.conv2(x)).mean(dim=(2, 3)))


class JTinyCNN(jnn.Module):
    conv1: jnn.Conv2d
    bn1: jnn.BatchNorm2d
    conv2: jnn.Conv2d
    fc: jnn.Linear

    def __call__(self, x, ctx=None):
        x = jax.nn.relu(self.bn1(self.conv1(x, ctx), ctx))
        x = jax.nn.relu(self.conv2(x, ctx))
        return self.fc(jnp.mean(x, axis=(1, 2)), ctx)


def _jtiny(key, num_classes=1000):
    ks = jax.random.split(key, 3)
    return JTinyCNN(conv1=jnn.Conv2d.create(ks[0], 3, 8, 3, padding=1, use_bias=False),
                    bn1=jnn.BatchNorm2d.create(8, stat_id=0),
                    conv2=jnn.Conv2d.create(ks[1], 8, 16, 1),
                    fc=jnn.Linear.create(ks[2], 16, num_classes))


builder.register_model(NAME, TinyCNN)
jbuilder.register_model(NAME, _jtiny)

DATA_CFG = dict(imagenet_root_dir="/nonexistent", trn_imagenet_classes_fname="/nonexistent",
                val_imagenet_classes_fname="/nonexistent", batch_size=4,
                normalization="imagenet", input_h_w=[16, 16])


def _pipelines():
    return (datasets_image.SyntheticImagePipeline(4, (16, 16), 1000, 4, seed=0),
            datasets_image.SyntheticImagePipeline(4, (16, 16), 1000, 2, seed=1))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A .pt of TinyCNN weights and BatchNorm statistics from a numpy seed."""
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in TinyCNN().state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        a = torch.from_numpy((0.5 * rng.standard_normal(tuple(v.shape))).astype(np.float32))
        sd[k] = a.abs() + 0.5 if k.endswith("running_var") else a
    path = tmp_path_factory.mktemp("weights") / "tinycnn.pt"
    torch.save(sd, path)
    return str(path)


def _pair_products(sd, config):
    """The state dict with each decomposed site's pair as its product."""
    out = {k: v for k, v in sd.items()
           if not any(k.startswith((s + ".0.", s + ".1.")) for s in config)}
    for s in config:
        w1 = torch.as_tensor(np.asarray(sd[f"{s}.0.weight"], np.float32))
        w2 = torch.as_tensor(np.asarray(sd[f"{s}.1.weight"], np.float32))
        out[f"{s}.product"] = (w2.flatten(1) @ w1.flatten(1)).numpy()
        if f"{s}.1.bias" in sd:
            out[f"{s}.1.bias"] = sd[f"{s}.1.bias"]
    return out


def _same_artifact(ours: pathlib.Path, theirs: pathlib.Path, atol=1e-5, products=True):
    cfg, jcfg = (json.loads((d / "decompose_config.json").read_text()) for d in (ours, theirs))

    def strip(c):
        return {n: {k: v for k, v in e.items() if k != "__meta__"} for n, e in c.items()}

    assert cfg and strip(cfg) == strip(jcfg)
    for n in cfg:
        for k, v in jcfg[n].get("__meta__", {}).items():
            assert cfg[n]["__meta__"][k] == pytest.approx(v, rel=1e-4, abs=1e-6), (n, k)
    sd = utils.load_state_dict_pt(str(ours / "decompose_state_dict.pt"))
    jsd = jutils.load_state_dict_pt(str(theirs / "decompose_state_dict.pt"))
    if products:
        sd, jsd = _pair_products(sd, cfg), _pair_products(jsd, cfg)
    assert set(sd) == set(jsd)
    for k in sd:
        np.testing.assert_allclose(np.asarray(sd[k], np.float64), np.asarray(jsd[k], np.float64),
                                   atol=atol, err_msg=k)
    keys = [set(json.loads((d / "summary.json").read_text())) for d in (ours, theirs)]
    assert keys[0] == keys[1]
    return cfg


@pytest.fixture(scope="module")
def falor_runs(weights, tmp_path_factory):
    """falor through both CLIs; the port's through ``run.main`` (argv and a
    JSON config)."""
    out = tmp_path_factory.mktemp("falor")
    cfg = dict(task="decompose_falor", decompose_model_name=NAME,
               decompose_model_checkpoint_path=weights, proportion_threshold=1.1,
               nsr_final_threshold=10.0, kl_final_threshold=100.0, num_data_steps=2,
               num_metric_steps=1, use_float64=True, blacklisted_modules=["fc"], **DATA_CFG)
    jrun_falor.main(cfg, out / "jax", *_pipelines())
    (out / "cfg.json").write_text(json.dumps(cfg))
    assert run.main(["--config", str(out / "cfg.json"), "--output-path", str(out / "port"),
                     "--device", "cpu"], *_pipelines()) == 0
    return out


def test_falor_matches_jax(falor_runs):
    cfg = _same_artifact(falor_runs / "port", falor_runs / "jax")
    assert set(cfg) == {"conv2"}
    assert (falor_runs / "port" / "repro" / "config.yaml").exists()


def test_dwain_matches_jax(weights, tmp_path):
    """dwain with loss-reverting fine-tuning (AdamW, BatchNorms in eval) on
    the 1x1 conv: the same decisions and pairs."""
    cfg = dict(task="decompose_dwain", decompose_model_name=NAME,
               decompose_model_checkpoint_path=weights, num_data_steps=2, num_metric_steps=1,
               trade_off_factor=1e6, reduction_factor=0.5, max_accepted_ppl_diff=10.0,
               nsr_final_threshold=10.0, min_rank=2, decompose_in_float64=True,
               eigh_method="exact", precomputing_covariance_num_splits=None,
               blacklisted_modules=["fc"], finetuning_run=True, finetuning_lr=1e-2,
               finetuning_optimizer="AdamW", finetuning_reverting=True,
               finetuning_batch_norms_in_eval=True, finetuning_num_steps=2,
               finetuning_num_log_steps=1, finetuning_num_last_finetuned_modules=8, **DATA_CFG)
    jrun_dwain.main(cfg, tmp_path / "jax", *_pipelines())
    run_decompose_dwain.main(cfg, tmp_path / "port", *_pipelines(), device="cpu")
    assert set(_same_artifact(tmp_path / "port", tmp_path / "jax")) == {"conv2"}


def _jax_noise(wrapped, key):
    return {m.rng_id: torch.from_numpy(np.array(jax.random.gumbel(
        jax.random.fold_in(key, m.rng_id), (2,) + m.logits.shape, jnp.float32)))
        for _, m in jlockd.named_wrapped_modules(wrapped)}


def test_lockd_matches_jax_with_its_noise(weights, tmp_path, monkeypatch):
    """lockd (SGD, 6 steps) with the JAX run's students and each step's
    Gumbel noise given to the port: the same metrics record, decisions
    and pairs."""
    cfg = dict(task="decompose_lockd", decompose_model_name=NAME,
               decompose_model_checkpoint_path=weights, proportion_threshold=0.99,
               blacklisted_modules=[], lmbda=10.0, nsr_threshold=0.05,
               finetune_only_decomposed=True, lr=0.5, lr_t_warmup="1ba", lr_scheduler="fixed",
               max_duration="6ba", optimizer="SGD", precision=None,
               alg_gradient_clipping_type=None, alg_gradient_clipping_threshold=None,
               mesh_dp=None, **DATA_CFG)
    jrun_lockd.main(cfg, tmp_path / "jax", *_pipelines())

    jwrapped = jlockd.wrap(jbuilder.make_model(NAME, checkpoint_path=weights),
                           jax.random.PRNGKey(0), [])
    students = jutils.state_dict(jwrapped)
    wrap = lockd.wrap

    def wrap_with_jax_students(model, seed=0, blacklisted_module_names=None):
        wrap(model, seed, blacklisted_module_names)
        return utils.load_numpy_state_dict(model, students)

    monkeypatch.setattr(lockd, "wrap", wrap_with_jax_students)
    monkeypatch.setattr(run_decompose_lockd, "step_ctx", lambda model, step: lockd.Ctx(
        noise=_jax_noise(jwrapped, jax.random.fold_in(jax.random.PRNGKey(42), step))))
    run_decompose_lockd.main(cfg, tmp_path / "port", *_pipelines(), device="cpu")

    rec, jrec = (json.loads((tmp_path / d / "metrics.jsonl").read_text().splitlines()[0])
                 for d in ("port", "jax"))
    assert rec["step"] == jrec["step"] == 0 and set(rec) == set(jrec)
    for k in ("loss", "loss_nsr", "loss_proportion", "loss_entropy"):
        assert rec[k] == pytest.approx(jrec[k], rel=1e-5), k
    for k in ("per_layer_nsr", "per_layer_p"):
        assert rec[k].keys() == jrec[k].keys()
        for n in rec[k]:
            assert rec[k][n] == pytest.approx(jrec[k][n], rel=1e-5, abs=1e-7), (k, n)
    # the students train directly: their factors have no free sign
    assert _same_artifact(tmp_path / "port", tmp_path / "jax", atol=1e-5, products=False)


_KD_LOG = re.compile(r"step (\d+)/\d+ kd_loss=([0-9.]+)")


def test_kd_finetune_matches_jax(falor_runs, weights, tmp_path, caplog):
    """The KD task on the falor artifact, 2 steps in train mode (AdamW,
    cosine after a 1-step warmup, norm clipping): the logged step-0 KD
    loss within 1e-5 and the trained weights and BatchNorm statistics
    within 1e-5."""
    art = falor_runs / "jax"
    cfg = dict(task="finetune", decompose_model_name=NAME,
               decompose_model_checkpoint_path=weights,
               decompose_config=str(art / "decompose_config.json"),
               decompose_state_dict=str(art / "decompose_state_dict.pt"),
               proportion_threshold=1.0, blacklisted_modules=[],
               finetune_only_decomposed=True, lr=1e-2, lr_t_warmup="1ba",
               lr_scheduler="cosine", max_duration="2ba", optimizer="AdamW", precision=None,
               alg_gradient_clipping_type="norm", alg_gradient_clipping_threshold=1.0,
               mesh_dp=None, **DATA_CFG)
    losses = {}
    for who, main in (("jax", jrun_finetune.main), ("port", run_finetune.main)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            kw = {"device": "cpu"} if who == "port" else {}
            main(cfg, tmp_path / who, *_pipelines(), **kw)
        losses[who] = {int(m.group(1)): float(m.group(2))
                       for m in map(_KD_LOG.search, caplog.messages) if m}
    assert 0 in losses["port"] and losses["port"].keys() == losses["jax"].keys()
    for step, v in losses["port"].items():
        assert v == pytest.approx(losses["jax"][step], abs=1e-5)
    sd = utils.load_state_dict_pt(str(tmp_path / "port" / "finetuned_state_dict.pt"))
    jsd = jutils.load_state_dict_pt(str(tmp_path / "jax" / "finetuned_state_dict.pt"))
    kept = json.loads((tmp_path / "port" / "decompose_config.json").read_text())
    assert set(kept) == {"conv2"}
    assert set(sd) - {k for k in sd if k.endswith("num_batches_tracked")} <= set(jsd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(v.numpy(), jsd[k], atol=1e-5, err_msg=k)
    assert not np.allclose(sd["bn1.running_mean"].numpy(),
                           utils.load_state_dict_pt(weights)["bn1.running_mean"].numpy())


def test_checkpointer_saves_and_autoresumes(tmp_path):
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), save_interval_steps=1)
    w = {"fc2.weight": torch.randn(2, 8)}
    assert ckpt.restore_or(w, {"state": {}}) == (w, {"state": {}}, 0)
    opt = torch.optim.Adam([torch.nn.Parameter(torch.randn(3))], lr=1e-2)
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    opt.step()
    ckpt.maybe_save(0, w, opt.state_dict())
    tr, state, start = TrainCheckpointer(str(tmp_path / "ck"), 1).restore_or(None, None)
    assert start == 1 and torch.equal(tr["fc2.weight"], w["fc2.weight"])
    assert torch.equal(state["state"][0]["exp_avg"], opt.state_dict()["state"][0]["exp_avg"])
    assert not list((tmp_path / "ck").glob("*.tmp*"))


def test_chunked_save_covers_unaligned_intervals(tmp_path):
    """8-step chunks with an interval of 100: the chunks that cover 0, 100
    and 200 save at their last steps, the last two are kept, and a resume
    continues at 208."""
    ckpt = TrainCheckpointer(str(tmp_path / "ck"), save_interval_steps=100)
    for start in range(0, 240, 8):
        ckpt.maybe_save_chunk(start, 8, {"w": torch.arange(4.0)}, {})
    assert ckpt.all_steps() == [103, 207]
    assert TrainCheckpointer(str(tmp_path / "ck"), 100).restore_or(None, None)[2] == 208


def test_disabled_checkpointer_is_noop(tmp_path):
    ckpt = TrainCheckpointer(None, save_interval_steps=0)
    assert ckpt.restore_or(1, 2) == (1, 2, 0)
    ckpt.maybe_save(0, 1, 2)
    ckpt.maybe_save_chunk(0, 8, 1, 2)
    assert not TrainCheckpointer(str(tmp_path / "ck"), 0).enabled


@pytest.mark.parametrize("path", sorted(CONFIGS.glob("*.yaml")), ids=lambda p: p.stem)
def test_shipped_configs_validate(path):
    """Each of the six shipped yamls through the port's schema, and each
    names a model the port's builder has."""
    import yaml

    raw = yaml.safe_load(path.read_text())
    schema = {"decompose_dwain": configurator.DecomposeDWAINConfig,
              "decompose_falor": configurator.DecomposeFALORConfig,
              "decompose_lockd": configurator.DecomposeLOCKDConfig,
              "finetune": configurator.FinetuneConfig}[raw["task"]]
    config = schema.from_dict(raw)
    assert config.input_h_w == (224, 224) and config.device == "cuda"
    assert config.decompose_model_name in builder._ZOO


def test_refusals(weights, tmp_path):
    base = yaml_config("decompose_dwain_convnext.yaml")
    with pytest.raises(ValueError, match="extra fields not permitted"):
        configurator.DecomposeDWAINConfig.from_dict({**base, "ppl_diff_threshold": 0.1})
    with pytest.raises(NotImplementedError, match="use_pallas_gram"):
        configurator.DecomposeDWAINConfig.from_dict({**base, "use_pallas_gram": False})
    lockd_cfg = yaml_config("decompose_lockd_resnet50.yaml")
    with pytest.raises(NotImplementedError, match="mesh_dp"):
        configurator.DecomposeLOCKDConfig.from_dict({**lockd_cfg, "mesh_dp": 4})
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        builder.make_model("vit_tiny_patch16_224", device="cpu")
    with pytest.raises(NotImplementedError, match="build_from_hf_snapshot"):
        builder.make_model(NAME, checkpoint_path=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        builder.make_model("no_such_model", device="cpu")
    official = {"layers.0.blocks.0.attn.q_bias": torch.zeros(3)}
    torch.save(official, tmp_path / "official.pt")
    with pytest.raises(NotImplementedError, match="translate_official_state_dict"):
        builder.make_model("swinv2_tiny_patch4_window7_224",
                           checkpoint_path=str(tmp_path / "official.pt"), device="cpu",
                           input_h_w=(64, 64))
    assert configurator.parse_duration("10ep", 7) == 70
    with pytest.raises(ValueError, match="Bad duration"):
        configurator.parse_duration("10", 7)


def yaml_config(name):
    import yaml

    return yaml.safe_load((CONFIGS / name).read_text())


def test_schedules_match_optax():
    """The cosine and fixed schedules at every step against the JAX
    trainer's optax schedules."""
    raw = {**yaml_config("finetune_kd_resnet50.yaml"), "lr_t_warmup": "3ba"}
    for kind in ("cosine", "fixed"):
        config = configurator.FinetuneConfig.from_dict({**raw, "lr_scheduler": kind})
        from apps.trainer_vision import configurator as jconfigurator

        ours = configurator.get_lr_schedule(config, 12, 4)
        theirs = jconfigurator.get_lr_schedule(config, 12, 4)
        np.testing.assert_allclose([ours(i) for i in range(16)],
                                   [float(theirs(i)) for i in range(16)], rtol=1e-6, atol=1e-10)


def test_flops_and_stats_match_jax(weights):
    """Per-module fpops (fvcore's MAC counts, gflops and kmapps), the
    decomposeable stats and the class count as the JAX builder's."""
    model = builder.make_model(NAME, checkpoint_path=weights, device="cpu")
    jmodel = jbuilder.make_model(NAME, checkpoint_path=weights)
    for units in ("gflops", "kmapps"):
        ours = builder.get_fpops_dict(model, (1, 16, 16, 3), units=units)
        theirs = jbuilder.get_fpops_dict(jmodel, (1, 16, 16, 3), units=units)
        assert ours == pytest.approx(theirs, rel=1e-9)
    assert builder.get_decomposeable_model_stats(model, (1, 16, 16, 3)) == pytest.approx(
        jbuilder.get_decomposeable_model_stats(jmodel, (1, 16, 16, 3)))
    stats = builder.get_model_stats(model, (1, 16, 16, 3))
    # the products and convolutions alone: conv1, conv2, fc
    assert stats["gflops"] == pytest.approx(2 * (16 * 16 * 8 * 27 + 16 * 16 * 16 * 8 + 16000) / 1e9)
    assert builder.infer_num_classes(model, (16, 16)) == 1000


def test_imagenet_pipelines_match_jax(tmp_path):
    """The folder pipelines (native JPEG decode, the native epoch shuffle,
    random-resized crops and flips, rotation, the centre crop) yield the
    JAX trainer's bytes on a small folder of JPEGs, two epochs."""
    from PIL import Image

    from apps.trainer_vision import datasets_image as jdatasets

    rng = np.random.default_rng(0)
    lines = []
    for i in range(6):
        h, w = (40, 56) if i % 2 else (64, 48)
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / f"{i}.jpg")
        lines.append(f"{i}.jpg {i % 3}")
    (tmp_path / "classes.txt").write_text("\n".join(lines) + "\n")
    kw = dict(imagenet_root_dir=str(tmp_path), trn_imagenet_classes_fname=str(tmp_path / "classes.txt"),
              val_imagenet_classes_fname=str(tmp_path / "classes.txt"), batch_size=2,
              normalization="imagenet", input_h_w=(24, 24), num_classes=3, use_rotation=True)
    ours, theirs = datasets_image.make_imagenet_pipelines(**kw), jdatasets.make_imagenet_pipelines(**kw)
    assert len(ours[0]) == len(theirs[0]) == 3
    for a, b in zip(ours, theirs):
        for _ in range(2):
            batches = list(zip(a, b, strict=True))
            assert len(batches) == 3
            for x, y in batches:
                assert x["inputs"].shape == (2, 24, 24, 3)
                np.testing.assert_array_equal(x["inputs"], y["inputs"])
                np.testing.assert_array_equal(x["targets"], y["targets"])
    from ptdeco_tpu_torch.data import native_jpeg

    assert native_jpeg.available()
