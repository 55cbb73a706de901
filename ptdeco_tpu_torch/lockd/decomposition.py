"""LOCKD (LOCal Knowledge Distillation) decomposition, in PyTorch.

Counterpart of ``ptdeco_tpu/lockd/decomposition.py`` (reference
``ptdeco.lockd``): every Linear and groups-1 Conv2d is shadowed by a
trainable two-factor student whose hidden channels pass Gumbel-sigmoid
gates; after a short local-distillation run, the channels whose gate
logits are positive are kept and the student pair replaces the layer.

Where the JAX package threads an ``nn.Ctx`` through the forward, a wrapped
layer here reads the ``Ctx`` that ``bind`` attaches to it for one forward:
its Gumbel noise (one ``torch.Generator`` stream per wrapped layer, as the
JAX package folds the layer's ``rng_id`` into the step key; or noise given
by the caller) and the sink its student NSR is recorded in (the JAX
package's ``ctx.sow``).  Without a Ctx, or a Ctx without noise, the gate is
the deterministic expected gate.  ``wrap`` and ``decompose`` change the
model in place, as the reference's ``wrap_in_place`` and
``decompose_in_place`` do.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Any, Iterator, Optional

import numpy as np
import torch

from .. import nn as pnn, utils

__all__ = [
    "Ctx",
    "bind",
    "sample_from_logits",
    "expected_gate",
    "gumbel_noise",
    "calc_propotion_from_logits",
    "WrappedLOCKDLinear",
    "WrappedLOCKDConv2d",
    "wrap",
    "decompose",
    "is_wrapped_module",
    "named_wrapped_modules",
    "trainable_partition",
    "make_generators",
]

logger = logging.getLogger(__name__)

GUMBEL_TAU = 0.5  # reference lockd:50
LOGIT_INIT = 3.0  # gates start open (reference lockd:218-220)


def layer_seed(seed: int, rng_id: int) -> int:
    """A 63-bit seed of wrapped layer ``rng_id``'s own stream under ``seed``."""
    state = np.random.SeedSequence([seed, rng_id]).generate_state(1, np.uint64)[0]
    return int(state) & (2**63 - 1)


def gumbel_noise(shape: tuple[int, ...], generator: torch.Generator,
                 device: Any = None) -> torch.Tensor:
    """(2, *shape) standard Gumbel draws in f32, ``jax.random.gumbel``'s
    transform of uniforms in [tiny, 1)."""
    u = torch.rand((2, *shape), generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_from_logits(logits: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Relaxed 2-class Gumbel-softmax gate, zeroed where logits < 0
    (reference lockd:47-54): for classes [logit, 0] the softmax is
    ``sigmoid((logit + g0 - g1) / tau)``.  The Gumbel pair comes from
    ``generator``, or is ``noise`` (2, *logits.shape) as given."""
    if noise is None:
        noise = gumbel_noise(tuple(logits.shape), generator, logits.device)
    gs = torch.sigmoid((logits.to(torch.float32) + noise[0] - noise[1]) / GUMBEL_TAU)
    return torch.where(logits < 0.0, 0.0, gs).to(logits.dtype)


def expected_gate(logits: torch.Tensor) -> torch.Tensor:
    """Deterministic (eval) gate: the zero-noise relaxation."""
    gs = torch.sigmoid(logits.to(torch.float32) / GUMBEL_TAU)
    return torch.where(logits < 0.0, 0.0, gs).to(logits.dtype)


def calc_propotion_from_logits(logits: torch.Tensor) -> torch.Tensor:
    # (sic) the reference's name, lockd:291-292
    return torch.mean(torch.sigmoid(logits))


class Ctx:
    """What the wrapped layers read during one forward: Gumbel noise, from
    ``generators`` ({rng_id: torch.Generator}) or as given in ``noise``
    ({rng_id: (2, hidden) tensor}), and the ``sink`` ({layer name: NSR})
    they fill.  With neither, every gate is the expected gate."""

    def __init__(self, generators: Optional[dict[int, torch.Generator]] = None,
                 noise: Optional[dict[int, torch.Tensor]] = None) -> None:
        self.generators = generators
        self.noise = noise
        self.sink: dict[str, torch.Tensor] = {}

    def gate(self, logits: torch.Tensor, rng_id: int) -> torch.Tensor:
        if self.noise is not None:
            return sample_from_logits(logits, noise=self.noise[rng_id].to(logits.device))
        if self.generators is not None:
            return sample_from_logits(logits, self.generators[rng_id])
        return expected_gate(logits)


@contextlib.contextmanager
def bind(root: torch.nn.Module, ctx: Ctx) -> Iterator[Ctx]:
    """Attach ``ctx`` to every wrapped layer of ``root`` for the block."""
    wrapped = [m for _, m in named_wrapped_modules(root)]
    for m in wrapped:
        m.ctx = ctx
    try:
        yield ctx
    finally:
        for m in wrapped:
            m.ctx = None


def _gate(m: "torch.nn.Module", logits: torch.Tensor) -> torch.Tensor:
    return m.ctx.gate(logits, m.rng_id) if m.ctx is not None else expected_gate(logits)


def _uniform(shape, fan_in: int, dtype, device, gen: torch.Generator) -> torch.nn.Parameter:
    """U(-1/sqrt(fan_in), 1/sqrt(fan_in)), torch's default layer init."""
    bound = 1.0 / fan_in ** 0.5
    w = torch.empty(shape, dtype=torch.float32, device=device).uniform_(-bound, bound,
                                                                         generator=gen)
    return torch.nn.Parameter(w.to(dtype))


def _kept_channels(logits: torch.Tensor) -> torch.Tensor:
    """Indices of the open gates (logits > 0); when every gate is closed the
    strongest channel stays, since a zero-width pair would reduce the layer
    to its bias (the reference guards only its conv path, lockd:152-154)."""
    lg = logits.detach().float().cpu()
    idx = torch.nonzero(lg > 0).flatten()
    if idx.numel() == 0:
        idx = torch.nonzero(lg >= lg.max()).flatten()
    logger.info(f"Leaving {idx.numel()} out of {lg.numel()} intermediate channels "
                f"({idx.numel() / lg.numel() * 100.0:4.1f} %)")
    return idx


class WrappedLOCKDLinear(torch.nn.Module):
    """Teacher Linear + gated two-factor student (reference lockd:191-285).
    The forward returns the teacher's output, so later layers see the
    original activations, and records the student's NSR in the bound
    Ctx's sink under this layer's name."""

    def __init__(self, module_orig: torch.nn.Linear, name: str, rng_id: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        in_f, out_f = module_orig.in_features, module_orig.out_features
        hidden = min(in_f, out_f)
        kw = {"dtype": module_orig.weight.dtype, "device": "meta"}
        dev = module_orig.weight.device
        self.lin_orig = module_orig
        self.lin_0 = torch.nn.Linear(in_f, hidden, bias=False, **kw)
        self.lin_1 = torch.nn.Linear(hidden, out_f, bias=module_orig.bias is not None, **kw)
        self.lin_0.weight = _uniform((hidden, in_f), in_f, kw["dtype"], dev, generator)
        self.lin_1.weight = _uniform((out_f, hidden), hidden, kw["dtype"], dev, generator)
        if module_orig.bias is not None:
            self.lin_1.bias = _uniform((out_f,), hidden, kw["dtype"], dev, generator)
        self.logits = torch.nn.Parameter(
            torch.full((hidden,), LOGIT_INIT, dtype=torch.float32, device=dev))
        self.name, self.rng_id, self.ctx = name, rng_id, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y_orig = self.lin_orig(x)
        hidden = self.lin_0(x)
        mask = _gate(self, self.logits)
        # in the activation dtype: an f32 gate would promote a bf16 hidden
        y_deco = self.lin_1(mask.to(hidden.dtype) * hidden)
        if not 2 <= x.dim() <= 4:
            raise NotImplementedError(f"WrappedLOCKDLinear: input of shape {tuple(x.shape)}")
        nsr = utils.calc_per_channel_noise_to_signal_ratio(
            y=y_orig, x=y_deco, non_channel_dim=tuple(range(x.dim() - 1)))
        if self.ctx is not None:
            self.ctx.sink[self.name] = nsr
        return y_orig

    def get_decomposed_module_and_meta(self) -> tuple[torch.nn.Module, dict[str, Any]]:
        idx = _kept_channels(self.logits)
        w0 = self.lin_0.weight.detach()[idx.to(self.lin_0.weight.device)]
        w1 = self.lin_1.weight.detach()[:, idx.to(self.lin_1.weight.device)]
        first = torch.nn.Linear(w0.shape[1], w0.shape[0], bias=False, device="meta")
        second = torch.nn.Linear(w1.shape[1], w1.shape[0], bias=self.lin_1.bias is not None,
                                 device="meta")
        first.weight = torch.nn.Parameter(w0.clone())
        second.weight = torch.nn.Parameter(w1.clone())
        if self.lin_1.bias is not None:
            second.bias = torch.nn.Parameter(self.lin_1.bias.detach().clone())
        return torch.nn.Sequential(first, second), {"proportion": idx.numel() / self.logits.numel()}

    def get_orig_module(self) -> torch.nn.Module:
        return self.lin_orig


class WrappedLOCKDConv2d(torch.nn.Module):
    """Teacher Conv2d + gated student: a 1x1 conv to min(in, out) channels,
    the gate, then a conv with the teacher's kernel, stride, padding and
    dilation (reference WrappedLOCKConv2d, lockd:83-188).  NCHW: the gate
    broadcasts over dim 1."""

    def __init__(self, module_orig: torch.nn.Conv2d, name: str, rng_id: int,
                 generator: torch.Generator) -> None:
        super().__init__()
        if module_orig.groups != 1:
            raise ValueError("LOCKD wraps only groups==1 convolutions")
        in_f, out_f = module_orig.in_channels, module_orig.out_channels
        mid = min(in_f, out_f)
        kh, kw_ = module_orig.kernel_size
        dtype, dev = module_orig.weight.dtype, module_orig.weight.device
        self.conv_orig = module_orig
        self.conv_1 = torch.nn.Conv2d(in_f, mid, 1, bias=False, dtype=dtype, device="meta")
        self.conv_2 = torch.nn.Conv2d(
            mid, out_f, module_orig.kernel_size, stride=module_orig.stride,
            padding=module_orig.padding, dilation=module_orig.dilation,
            padding_mode=module_orig.padding_mode, bias=module_orig.bias is not None,
            dtype=dtype, device="meta")
        self.conv_1.weight = _uniform((mid, in_f, 1, 1), in_f, dtype, dev, generator)
        self.conv_2.weight = _uniform((out_f, mid, kh, kw_), mid * kh * kw_, dtype, dev, generator)
        if module_orig.bias is not None:
            self.conv_2.bias = _uniform((out_f,), mid * kh * kw_, dtype, dev, generator)
        self.logits = torch.nn.Parameter(
            torch.full((mid,), LOGIT_INIT, dtype=torch.float32, device=dev))
        self.name, self.rng_id, self.ctx = name, rng_id, None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y0 = self.conv_orig(x)
        mask = _gate(self, self.logits)
        z = self.conv_1(x)
        z = self.conv_2(mask.to(z.dtype)[:, None, None] * z)
        nsr = utils.calc_per_channel_noise_to_signal_ratio(y=y0, x=z, non_channel_dim=(0, 2, 3))
        if self.ctx is not None:
            self.ctx.sink[self.name] = nsr
        return y0

    def get_decomposed_module_and_meta(self) -> tuple[torch.nn.Module, dict[str, Any]]:
        idx = _kept_channels(self.logits)
        w1 = self.conv_1.weight.detach()[idx.to(self.conv_1.weight.device)]
        w2 = self.conv_2.weight.detach()[:, idx.to(self.conv_2.weight.device)]
        c2 = self.conv_2
        first = torch.nn.Conv2d(w1.shape[1], w1.shape[0], 1, bias=False, device="meta")
        second = torch.nn.Conv2d(
            w2.shape[1], w2.shape[0], c2.kernel_size, stride=c2.stride, padding=c2.padding,
            dilation=c2.dilation, padding_mode=c2.padding_mode, bias=c2.bias is not None,
            device="meta")
        first.weight = torch.nn.Parameter(w1.clone())
        second.weight = torch.nn.Parameter(w2.clone())
        if c2.bias is not None:
            second.bias = torch.nn.Parameter(c2.bias.detach().clone())
        return torch.nn.Sequential(first, second), {"proportion": idx.numel() / self.logits.numel()}

    def get_orig_module(self) -> torch.nn.Module:
        return self.conv_orig


_WRAPPED_TYPES = (WrappedLOCKDLinear, WrappedLOCKDConv2d)


def is_wrapped_module(m: Any) -> bool:
    """A wrapped layer, or a module holding one."""
    return isinstance(m, torch.nn.Module) and any(
        isinstance(sub, _WRAPPED_TYPES) for sub in m.modules())


def named_wrapped_modules(root: torch.nn.Module) -> Iterator[tuple[str, torch.nn.Module]]:
    for name, m in root.named_modules():
        if isinstance(m, _WRAPPED_TYPES):
            yield name, m


def _wrappable(m: Any) -> bool:
    # the reference skips grouped convs silently (lockd:338-342)
    return type(m) is torch.nn.Linear or (type(m) is torch.nn.Conv2d and m.groups == 1)


def wrap(module: torch.nn.Module, seed: int = 0,
         blacklisted_module_names: Optional[list[str]] = None) -> torch.nn.Module:
    """Wrap every Linear and groups-1 Conv2d of ``module`` in place with a
    gated student (reference ``wrap_in_place``, lockd:304-377).  Wrapped
    layers are numbered (``rng_id``) in module order; each layer's student
    is drawn from its own generator, seeded from (seed, rng_id) on the
    layer's device.  Returns the module."""
    blacklist = set(blacklisted_module_names or [])
    targets = []
    for name, m in module.named_modules():
        if isinstance(m, _WRAPPED_TYPES):
            raise ValueError(f"Model already wrapped at {name}")
        if name and _wrappable(m):
            if name in blacklist:
                logger.info(f"Blacklisted - not wrapping {name}")
                continue
            targets.append((name, m))
    counter: dict[str, int] = {}
    for rng_id, (name, m) in enumerate(targets):
        gen = torch.Generator(device=m.weight.device).manual_seed(layer_seed(seed, rng_id))
        cls = WrappedLOCKDLinear if isinstance(m, torch.nn.Linear) else WrappedLOCKDConv2d
        pnn.replace_submodule(module, name, cls(m, name, rng_id, gen))
        tname = utils.get_type_name(m)
        counter[tname] = counter.get(tname, 0) + 1
    for tname, count in counter.items():
        logger.info(f"Wrapped {count} instances of {tname}")
    return module


def make_generators(root: torch.nn.Module, seed: int) -> dict[int, torch.Generator]:
    """One Gumbel stream per wrapped layer, ``{rng_id: torch.Generator}`` on
    the layer's device, seeded from (seed, rng_id)."""
    return {m.rng_id: torch.Generator(device=m.logits.device).manual_seed(layer_seed(seed, m.rng_id))
            for _, m in named_wrapped_modules(root)}


def decompose(module: torch.nn.Module, proportion_threshold: float,
              blacklisted_module_names: Optional[list[str]] = None
              ) -> tuple[torch.nn.Module, dict[str, Any]]:
    """Prune the closed channels and swap in the student pairs, in place
    (reference ``decompose_in_place``, lockd:398-459): a wrapped layer is
    decomposed iff its mean gate probability is below
    ``proportion_threshold`` and it is not blacklisted; otherwise the
    original layer is restored.  Returns ``(module, decompose_config)``."""
    blacklist = set(blacklisted_module_names or [])
    config: dict[str, Any] = {}
    counter: dict[str, int] = {}
    for name, m in list(named_wrapped_modules(module)):
        p = float(calc_propotion_from_logits(m.logits.detach().float()))
        tname = utils.get_type_name(m)
        if name not in blacklist and p < proportion_threshold:
            logger.info(f"Decomposing {name} [{tname}], proportion={p:.3f}")
            new, meta = m.get_decomposed_module_and_meta()
            pnn.replace_submodule(module, name, new)
            counter[tname] = counter.get(tname, 0) + 1
            entry = utils.get_module_config(new)
            entry[utils.MODCONFIG_META_KEY] = meta
            config[name] = entry
        else:
            pnn.replace_submodule(module, name, m.get_orig_module())
            reason = "blacklisted" if name in blacklist else "proportion too high"
            logger.info(f"Reverting to orig module, {reason} - {name} p={p:.3f}")
    for tname, count in counter.items():
        logger.info(f"Decomposed {count} instances of {tname}")
    return module, config


def trainable_partition(root: torch.nn.Module) -> list[tuple[str, torch.nn.Parameter]]:
    """The parameters that train, by name: each wrapped layer's student
    factors and gate logits (reference get_parameters_trainable,
    lockd:462-473).  Everything else, the teachers included, is frozen."""
    out = []
    for name, m in named_wrapped_modules(root):
        students = ("lin_0", "lin_1") if isinstance(m, WrappedLOCKDLinear) else ("conv_1", "conv_2")
        for sub in students:
            out += [(f"{name}.{sub}.{k}", p) for k, p in getattr(m, sub).named_parameters()]
        out.append((f"{name}.logits", m.logits))
    return out
