"""Weight conversion into the port's ``state_dict`` layout."""

from robseg_torch.convert.from_jax import (  # noqa: F401
    ddcat_state_dict_from_jax, deeplab_state_dict_from_jax,
    pspnet_state_dict_from_jax, segmenter_state_dict_from_jax,
    upernet_state_dict_from_jax)
