"""Byte-identical quantized model text of the l2 and l1 regression
objectives against the JAX package, split off
``tests/test_torch_regression.py`` (huber, quantile, poisson and tweedie
are in ``tests/test_torch_regression_quantized_robust.py``) so the test
workers can run the files side by side.
"""

import pytest

from _torch_regression_cases import quantized_regression_case
from _torch_regression_cases import ref  # noqa: F401  (fixtures)


@pytest.mark.parametrize("objective,max_bin", [
    (objective, max_bin) for objective in ("regression", "regression_l1")
    for max_bin in (15, 63, 255)])
def test_quantized_model_text_is_the_references(ref, objective, max_bin):
    quantized_regression_case(ref, objective, max_bin)
