"""The frozen-stage train step of test_torch_port_hrnet_frozen.py with
``norm_eval`` True, so every BN of the image backbone runs on running
statistics: the same tests and tolerances against the JAX package's
make_train_step. A file of its own so that the two JAX train steps, which
take nearly all of the time, can run on two test workers."""

import pytest

from test_torch_port_hrnet_frozen import (  # noqa: F401
    test_frozen_bn_statistics_do_not_move,
    test_frozen_gradients_are_exactly_zero_and_others_match,
    test_frozen_parameters_are_all_but_stage_4, test_loss_terms_match,
    test_parameters_after_the_step_match, train_step_pair)
from test_torch_port_support import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[True], ids=["norm_eval=True"])
def run(request):
    return train_step_pair(request.param)
