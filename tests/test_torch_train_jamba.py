"""``test_torch_train.py``'s comparisons (loss and gradients in f32 and
bf16, the remat modes, one whole train step at accum 1 and 2 and with
compression) for jamba on randomized leaves: the mamba chunks, each
recomputed in the backward, beside attention and MoE layers, at the
tolerances of that file's docstring."""
import pytest

from test_torch_train import (STEPS, check_bf16, check_f32, check_remat,
                              check_step, make_case, one_thread)  # noqa: F401


@pytest.fixture(scope="module")
def case():
    return make_case("jamba_v01_52b")


def test_loss_and_grads_f32_equal_jax(case):
    check_f32(case)


def test_loss_and_grads_bf16_within_the_reference_band(case):
    check_bf16(case)


def test_remat_modes_give_equal_grads(case):
    check_remat(case)


@pytest.mark.parametrize("accum,compress", STEPS)
def test_train_step_equals_jax(case, accum, compress):
    check_step(case, accum, compress)
