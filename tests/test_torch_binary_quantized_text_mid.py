"""Byte-identical quantized model text of ``train()`` against the JAX
package at ``max_bin`` 31 and 63: the cases of
``tests/test_torch_binary_quantized_text.py`` at the other two widths, in
a file of their own so the test workers can run them side by side.
"""

import pytest

from _torch_train_options_cases import SEEDS, quantized_text_case
from _torch_train_options_cases import _time_limit, ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("max_bin", [31, 63])
@pytest.mark.parametrize("seed,n,extra", SEEDS)
def test_quantized_model_text_is_the_references(ref, seed, n, extra, max_bin):
    quantized_text_case(ref, seed, n, extra, max_bin)
