"""Parity of ``partmanip_tpu_torch/ops/rotations.py`` with the JAX package on
the same random inputs — part c of three (see ``_torch_ops_cases.py`` for the
inputs and the tolerance)."""

import pytest

import _torch_ops_cases as cases


@pytest.mark.parametrize("name", cases.rotation_names(2))
def test_rotations_match_jax(name):
    cases.check_rotation(name)
