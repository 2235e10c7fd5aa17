"""The reverse-mode gradient of the port's phi-phi evolve against
``jax.grad``, on the CPU: tests/test_grad.py's phi-phi family (the
``trisolve`` march with the phi-phi channel from one spline in both
packages), with its central-difference gate (1e-4) kept beside it. Cases
and point: ``torch_grad_cases``. Gate: <= 1e-8 relative; measured when
this file was written: 3.2e-12 (the central differences: 6.0e-7 of
the gradient).
"""

import pytest
import torch

import torch_grad_cases as cases

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jref():
    return cases.jax_value_and_grad("phiphi")


def test_grad_matches_jax(jref):
    cases.check_against_jax("phiphi", jref)


def test_grad_matches_finite_differences():
    cases.check_finite_differences("phiphi")
