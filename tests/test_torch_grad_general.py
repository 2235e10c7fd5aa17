"""The reverse-mode gradient of the port's ``evolve_general`` against
``jax.grad``, on the CPU: tests/test_grad.py's general-coupling family (Q
from a flavour texture with (mu, mu) = 0.5 and (tau, tau) = 1), with its
central-difference gate (1e-4) kept beside it. Cases and point:
``torch_grad_cases``. Gate: <= 1e-8 relative; measured when this file was
written: 1.0e-12 (the central differences: 1.1e-6 of the gradient).
"""

import pytest
import torch

import torch_grad_cases as cases

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jref():
    return cases.jax_value_and_grad("general")


def test_grad_matches_jax(jref):
    cases.check_against_jax("general", jref)


def test_grad_matches_finite_differences():
    cases.check_finite_differences("general")
