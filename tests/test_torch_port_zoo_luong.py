"""The stage matrix's luong heads (dot, general, concat; ResNet -> BiLSTM
-> Attn) against the JAX package, held as
``torch_port_zoo_cases.check_case_matches_jax`` says (the rest of the
matrix is ``test_torch_port_zoo.py``'s).
"""

from __future__ import annotations

import pytest

from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import LUONG, STAGE_MATRIX, check_case_matches_jax


@pytest.mark.parametrize("case", LUONG)
def test_zoo_case_matches_jax(case):
    check_case_matches_jax(STAGE_MATRIX[case])
