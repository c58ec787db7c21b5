"""The rest of the ``mx.np`` parity sweep (``torch_np_sweep``): the
functions whose output shape depends on the data, the shape and
indexing functions, creation and grids, ``np.linalg``, ``np.fft`` and
``np.random``, each through the reference package and the port on the
CPU from the same numpy inputs, at the tolerance each case states
(values and dtypes; factorizations by reconstruction; samplers by their
moments).  The elementwise and reduction families are in
``test_torch_numpy.py``.
"""
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

import torch_np_sweep as S

FAMILIES = ("np_eager", "np_shape", "np_create", "np_linalg", "np_fft",
            "np_random")
CASES = [c for c in S.CASES if c.family in FAMILIES]


@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c.family}-{c.id}" for c in CASES])
def test_np_sweep(case):
    S.check_against(jmx, mx, case)


def test_every_case_is_in_a_file():
    """The sweep's families are split between this file and
    ``test_torch_numpy.py``; none is left out."""
    import test_torch_numpy
    np_families = {c.family for c in S.CASES
                   if not c.family.startswith("op")}
    assert np_families == set(FAMILIES) | set(test_torch_numpy.FAMILIES)
