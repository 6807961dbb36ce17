"""``grad_accum=2`` in the port's train step, on the CPU: two steps against
the reference's own ``grad_accum=2`` (the tolerances of
``tests/test_torch_train_parity.py``, whose helpers this file shares),
and against the port's ``grad_accum=1`` on the reference's
``test_grad_accum_matches_single_batch`` archs at its atol 2e-3, over
every leaf after both steps."""

import numpy as np
import pytest

from test_torch_train_parity import (  # noqa: F401  (one_torch_thread: the autouse fixture, here too)
    check_float_leaves,
    check_metrics,
    flat,
    one_torch_thread,
    port_run,
    reference_run,
)

ACCUM_ARCHS = ("mixtral-8x22b", "mamba2-370m", "zamba2-2.7b", "deepseek-v2-lite-16b", "whisper-tiny")


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_grad_accum_matches_single_batch_and_reference(arch):
    start, want_metrics, want = reference_run(arch, grad_accum=2)
    metrics, state = port_run(arch, grad_accum=2)
    check_metrics(metrics, want_metrics)
    check_float_leaves(flat(state["params"]), flat(want["params"]))
    _, single = port_run(arch, start=start)
    got, one = flat(state["params"]), flat(single["params"])
    for k in one:
        np.testing.assert_allclose(got[k], one[k], rtol=0, atol=2e-3, err_msg=k)
