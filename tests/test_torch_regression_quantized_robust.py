"""Byte-identical quantized model text of the huber, quantile, poisson and
tweedie objectives against the JAX package: the cases of
``tests/test_torch_regression_quantized.py`` for the other objectives, in a
file of their own so the test workers can run them side by side.
"""

import pytest

from _torch_regression_cases import quantized_regression_case
from _torch_regression_cases import ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("objective,max_bin", [
    (objective, max_bin) for objective in ("huber", "quantile")
    for max_bin in (15, 63, 255)] + [("poisson", 63), ("tweedie", 63)])
def test_quantized_model_text_is_the_references(ref, objective, max_bin):
    quantized_regression_case(ref, objective, max_bin)
