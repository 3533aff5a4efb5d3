"""``test_torch_train.py``'s comparisons (loss and gradients in f32 and
bf16, the remat modes, one whole train step at accum 1 and 2 and with
compression) for the attention archs with a sliding window (h2o-danube)
and a multimodal prefix (paligemma: its positions carry label -1), at the
tolerances of that file's docstring; ``test_torch_train_moe.py`` holds the
MoE archs."""
import pytest

from test_torch_train import (STEPS, check_bf16, check_f32, check_remat,
                              check_step, make_case, one_thread)  # noqa: F401


@pytest.fixture(scope="module", params=("h2o_danube_1p8b", "paligemma_3b"))
def case(request):
    return make_case(request.param)


def test_loss_and_grads_f32_equal_jax(case):
    check_f32(case)


def test_loss_and_grads_bf16_within_the_reference_band(case):
    check_bf16(case)


def test_remat_modes_give_equal_grads(case):
    check_remat(case)


@pytest.mark.parametrize("accum,compress", STEPS)
def test_train_step_equals_jax(case, accum, compress):
    check_step(case, accum, compress)
