"""Weight conversion into the port's ``state_dict`` layout: JAX variables
(``from_jax``) and robust-ImageNet checkpoints (``pir``)."""

from robseg_torch.convert.from_jax import (  # noqa: F401
    ddcat_state_dict_from_jax, deeplab_state_dict_from_jax,
    load_params_npz, npz_state_dict, pspnet_state_dict_from_jax,
    segmenter_state_dict_from_jax, state_dict_from_jax,
    upernet_state_dict_from_jax)
from robseg_torch.convert.pir import load_pir, pir_state_dict  # noqa: F401
