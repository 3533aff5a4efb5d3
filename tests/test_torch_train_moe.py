"""``test_torch_train.py``'s comparisons (loss and gradients in f32 and
bf16, the remat modes, one whole train step at accum 1 and 2 and with
compression) for the MoE archs (qwen3-moe with its token groups, each
recomputed in the backward; dbrx): the router's gradient through the
gathered top-k gates, capacity per microbatch in both packages, at the
tolerances of that file's docstring."""
import pytest

from test_torch_train import (STEPS, check_bf16, check_f32, check_remat,
                              check_step, make_case, one_thread)  # noqa: F401


@pytest.fixture(scope="module", params=("qwen3_moe_235b_a22b", "dbrx_132b"))
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
