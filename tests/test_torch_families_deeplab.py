"""PSPNet-DDCAT, DeepLabV3 and DeepLabV3-DDCAT of the port against the JAX
modules, on the CPU: logits and the input gradient of sum(mask-ce-avg),
and the ``--precision bf16`` dtype trail, with the helpers, sizes and
tolerances of tests/test_torch_families.py (PSPNet-DDCAT at one bottleneck
a stage and narrow planes on 33 x 33; the DeepLab models, which have no
geometry fields in JAX, at full width on 17 x 17). A file of its own so
that the two halves of the families' checks run on two test workers.
"""

import pytest

from test_torch_families import (check_bf16_dtype_trail,
                                 check_logits_and_input_grad)


@pytest.mark.parametrize("name", ["pspnet_ddcat", "deeplabv3",
                                  "deeplabv3_ddcat"])
def test_logits_and_input_grad_match_jax(name):
    check_logits_and_input_grad(name)


@pytest.mark.parametrize("name", ["pspnet_ddcat", "deeplabv3_ddcat"])
def test_bf16_dtype_trail_matches_jax(name):
    check_bf16_dtype_trail(name)
