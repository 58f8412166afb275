"""The hand-written CUDA kernels against their plain PyTorch versions, on a
CUDA card. Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test skips. Tolerance: bit-exact (each plain version
repeats its kernel's arithmetic).
"""

import numpy as np
import pytest
import torch

from othello_reinforcement_learning_test_tpu_torch.kernels.trunk_int8_dx3 import (
    trunk_int8_dx3,
    trunk_int8_dx3_plain,
)
from othello_reinforcement_learning_test_tpu_torch.models.convert import (
    from_jax_variables,
    init_numpy_variables,
)
from othello_reinforcement_learning_test_tpu_torch.models.fused_resnet import FusedInference
from othello_reinforcement_learning_test_tpu_torch.models.resnet import OthelloResNet


@pytest.fixture(scope="module")
def fused():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU mode")
    m = OthelloResNet(10, 128)
    m.load_state_dict(from_jax_variables(init_numpy_variables(10, 128, seed=0)))
    return FusedInference(m.cuda().eval())


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1024, 24, 3])
def test_trunk_kernel_matches_plain(fused, batch):
    rng = np.random.default_rng(batch)
    h = np.abs(rng.standard_normal((batch, 8, 8, 128))) * rng.random((batch, 1, 1, 1)) * 2
    x = torch.from_numpy(h.astype(np.float32)).to(torch.bfloat16).cuda()
    args = (fused.trunk_w, fused.trunk_scale, fused.trunk_bias)
    before = trunk_int8_dx3.launches
    out = trunk_int8_dx3(x, *args)
    assert trunk_int8_dx3.launches == before + 20
    assert torch.equal(out, trunk_int8_dx3_plain(x, *args))


@pytest.mark.cuda
def test_fused_inference_kernel_matches_plain_trunk(fused):
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (64, 8, 8, 3)).astype(np.float32))
    x = x.cuda()
    lp, v = fused(x)
    lp_p, v_p = fused.heads(trunk_int8_dx3_plain(fused.stem(x), fused.trunk_w,
                                                 fused.trunk_scale, fused.trunk_bias))
    assert torch.equal(lp, lp_p) and torch.equal(v, v_p)
