"""The ViT's patch embeddings against the JAX package
(``torch_port_zoo_cases.check_case_matches_jax``): the GCB backbone, 1-d
patching and raw patches.  The learned tables are
``test_torch_port_zoo_tables.py``'s.
"""

from __future__ import annotations

import pytest

from torch_port_threads import one_torch_thread  # noqa: F401
from torch_port_zoo_cases import VIT, VIT_TABLES, check_case_matches_jax


@pytest.mark.parametrize("case", sorted(set(VIT) - set(VIT_TABLES)))
def test_zoo_case_matches_jax(case):
    check_case_matches_jax(VIT[case])
