"""Byte-identical quantized model text of ``train()`` against the JAX
package at ``max_bin`` 15 and 255, split off ``tests/test_torch_train_options.py``
(with ``tests/test_torch_binary_quantized_text_mid.py`` for 31 and 63) so
the test workers can run the cases side by side.
"""

import pytest

from _torch_train_options_cases import SEEDS, quantized_text_case
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("max_bin", [15, 255])
@pytest.mark.parametrize("seed,n,extra", SEEDS)
def test_quantized_model_text_is_the_references(ref, seed, n, extra, max_bin):
    quantized_text_case(ref, seed, n, extra, max_bin)
