"""The CUDA panel kernel on the card, against its plain PyTorch version.

Imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (skip the JAX-pinning conftest there)::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Without a GPU every test skips.
"""

import numpy as np
import pytest
import torch

from pnmol_tpu_torch.ops import qr_householder as tq

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "rows, cols, off, zero_rows",
    [(128, 3586, 0, ()), (128, 600, 40, ()), (32, 3586, 0, ()),
     (128, 1538, 0, range(2, 128)), (2, 1538, 0, ())],
    ids=["step-panel", "offset", "leaf-form", "ragged-zero-rows", "two-rows"],
)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_matches_the_plain_version(cuda, rows, cols, off, zero_rows, dtype):
    rng = np.random.default_rng(rows + cols + off)
    slab = rng.standard_normal((rows, cols))
    slab[list(zero_rows)] = 0.0
    x = torch.tensor(slab, dtype=dtype, device=cuda)
    before = tq.panel_lq.launches
    lv, tT = tq.panel_lq(x, off)
    torch.cuda.synchronize()
    assert tq.panel_lq.launches == before + 1
    lv_ref, tT_ref = tq.panel_lq_reference(x, off)
    # rounding of one panel: ~1e-14 (f64) / ~1e-6 (f32) of the slab's scale
    tol = (1e-12 if dtype == torch.float64 else 1e-4) * np.abs(slab).max()
    assert (lv - lv_ref).abs().max().item() <= tol
    assert (tT - tT_ref).abs().max().item() <= tol


def test_blocked_sweep_matches_the_gram(cuda):
    W = torch.tensor(np.random.default_rng(1).standard_normal((300, 520)), device=cuda)
    L = tq.blocked_lq_l(W, block=64)
    G = W @ W.T
    assert ((L @ L.T - G).abs().max() / G.abs().max()).item() <= 1e-12


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tq.panel_lq(x.to(torch.float16), 0)
    with pytest.raises(ValueError):
        tq.panel_lq(x.T, 0)  # not contiguous
    with pytest.raises(ValueError):
        tq.panel_lq(x, 5)  # rows > cols - off
