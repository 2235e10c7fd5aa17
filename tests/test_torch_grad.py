"""Reverse-mode gradients of the port's float64 non-resonant march against
``jax.grad``, on the CPU: tests/test_grad.py's non-resonant family (the
``trisolve`` march, power-law source) and ``march="loop"`` on the same
point, each with tests/test_grad.py's central-difference gate (1e-5) kept
beside it. Cases and point: ``torch_grad_cases``.

``loop`` is held to the JAX ``trisolve`` gradient: the same derivative of
the same tables (the two marches agree to 1e-11 forward,
tests/test_torch_modes.py), so one JAX compile serves both. Gate: <= 1e-8
relative; measured when this file was written: trisolve 3.8e-12, loop
3.2e-12 (the central differences: 6.0e-7 of the gradient).
"""

import pytest
import torch

import torch_grad_cases as cases

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jref():
    return cases.jax_value_and_grad("trisolve")


@pytest.mark.parametrize("family", ["trisolve", "loop"])
def test_grad_matches_jax(family, jref):
    cases.check_against_jax(family, jref)


@pytest.mark.parametrize("family", ["trisolve", "loop"])
def test_grad_matches_finite_differences(family):
    cases.check_finite_differences(family)
