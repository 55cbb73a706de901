from . import modconfig  # noqa: F401
from .common import (
    get_default_dtype,
    get_num_params,
    get_type_name,
    split_module_parent_child_name,
    to_device,
)
from .losses_primitives import (
    calc_kl_divergence,
    calc_kl_loss,
    calc_per_channel_noise_to_signal_ratio,
)
from .modconfig import (
    MODCONFIG_META_KEY,
    apply_decompose_config,
    build_module_from_config,
    get_module_config,
)
from .statedict import (
    load_numpy_state_dict,
    load_state_dict,
    load_state_dict_pt,
    load_state_dict_safetensors,
    save_state_dict_pt,
    save_state_dict_safetensors,
    state_dict,
)

__all__ = [
    "get_default_dtype",
    "get_num_params",
    "get_type_name",
    "split_module_parent_child_name",
    "to_device",
    "calc_kl_divergence",
    "calc_kl_loss",
    "calc_per_channel_noise_to_signal_ratio",
    "MODCONFIG_META_KEY",
    "apply_decompose_config",
    "build_module_from_config",
    "get_module_config",
    "load_numpy_state_dict",
    "load_state_dict",
    "load_state_dict_pt",
    "load_state_dict_safetensors",
    "save_state_dict_pt",
    "save_state_dict_safetensors",
    "state_dict",
]
