"""The general backward pair above head dim 576 on the zero-padded route:
at head dim 700, run at 704 with the true head dim's softmax scale,
``flash_attention``'s output and gradients against the JAX package's under
full attention, a sliding window, segment ids, and a window with segment
ids and grouped-query attention (``tests/test_torch_flash_head_dim_wide_
general.py``'s cases and tolerances at 640, with its helpers).
"""

import pytest

from tests.test_torch_flash_head_dim_wide_general import (  # noqa: F401  (the fixture)
    MASKS,
    _one_torch_thread,
    check_16bit,
    check_f32,
)

HEAD_DIM = 700


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_f32_padded_general_output_and_gradients_match_reference(mask):
    check_f32(HEAD_DIM, mask)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_16bit_padded_general_output_and_gradients_match_reference(dtype, mask):
    check_16bit(HEAD_DIM, mask, dtype)
