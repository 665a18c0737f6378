"""The port's training step against the JAX package's Trainer on the dense
frontend (factorized_frontend=False), which rasterizes the generator's
layouts (the CUDA kernel on the card, its plain version here) and takes its
backward: the same tests and tolerances as tests/test_torch_train.py, in a
file of their own so that each file stays well inside the test run's time
limit."""

import pytest

from tests.test_torch_train import (  # noqa: F401
    run_parity, test_discriminator_losses_match, test_generator_losses_match,
    test_gradients_match, test_graph_loss_matches,
    test_loss_values_before_the_optimizer, test_no_step_skipped,
    test_norm_state_after_one_step, test_second_step_losses_match)


@pytest.fixture(scope="module")
def parity():
    return run_parity(factorized=False)
