"""The CUDA kernels on the card (skipped where there is none).

This file imports neither JAX nor tpinn, so it runs on the machine with the
card, where those are not installed; the repo's conftest files import JAX,
so run it there without them:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpinn_torch.geometry import Normalization
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.pipeline import NSPhysics

torch.set_num_threads(1)

W3 = (10.0, 1.0, 1.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc (see chip_smoke.py)")
    return torch.device("cuda")


def _case(d_in, n, seed, device):
    rng = np.random.default_rng(seed)
    widths = (d_in, 32, 32, 32, 3)
    params = []
    for a, b in zip(widths[:-1], widths[1:]):
        lim = np.sqrt(6.0 / (a + b))
        params.append({
            "kernel": torch.tensor(rng.uniform(-lim, lim, (a, b)), device=device),
            "bias": torch.tensor(rng.uniform(-0.1, 0.1, b), device=device)})
    x = torch.tensor(rng.uniform(0, 1, (n, d_in)), device=device)
    if d_in == 2:
        phys = NSPhysics(conv=3100.0, visc=890.0)
        norm = Normalization(np.array([0.0, 500.0]), np.array([0.0, 250.0]),
                             np.array([-1e4, 1e4]))
    else:
        phys = NSPhysics(conv=1.0, visc=1.0, time=1.0)
        norm = Normalization(np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                             np.array([-2.0, 2.0]))
    return params, x, phys, norm


def _plain_grads(params, x, phys, norm, gbar, n_valid, n_mean):
    leaves = [{k: p[k].detach().clone().requires_grad_(True)
               for k in ("kernel", "bias")} for p in params]
    mses = mb.ns_residual_mse_plain(leaves, x, phys, norm, n_valid, n_mean)
    loss = (gbar * mses).sum()
    flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
    return loss.detach(), mses.detach(), torch.autograd.grad(loss, flat)


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,n,n_valid", [(2, 1000, None), (2, 4099, 4000),
                                            (3, 1000, None)])
def test_kernels_match_plain_on_card(cuda, d_in, n, n_valid):
    """Both kernels against their plain versions at the reference's bars,
    and bit-identical repeat calls."""
    params, x, phys, norm = _case(d_in, n, 9, cuda)
    gbar = torch.tensor(W3, dtype=torch.float64, device=cuda)
    dp, mses, loss = mb.ns_residual_bwd(params, x, phys, norm, gbar, n_valid,
                                        n_valid, with_loss=True)
    ref_l, ref_m, ref_g = _plain_grads(params, x, phys, norm, gbar, n_valid,
                                       n_valid)
    torch.testing.assert_close(loss, ref_l, rtol=1e-11, atol=0)
    torch.testing.assert_close(mses, ref_m, rtol=1e-11, atol=0)
    got = [t for p in dp for t in (p["kernel"], p["bias"])]
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    dp2, mses2, loss2 = mb.ns_residual_bwd(params, x, phys, norm, gbar,
                                           n_valid, n_valid, with_loss=True)
    assert torch.equal(loss, loss2) and torch.equal(mses, mses2)
    assert all(torch.equal(a, b) for a, b in
               zip(got, [t for p in dp2 for t in (p["kernel"], p["bias"])]))
    m_fwd = mb.ns_residual_fwd(params, x, phys, norm, n_valid, n_valid)
    torch.testing.assert_close(m_fwd, ref_m, rtol=1e-11, atol=0)


@pytest.mark.cuda
def test_poiseuille_round_on_card_matches_cpu(cuda, tmp_path):
    """Ten Adam epochs of the slice on the card and on the CPU (plain
    versions) from the same seed give the same history."""
    from tpinn_torch.cases import poiseuille_flow

    mb.reset_launch_counts()
    gpu = poiseuille_flow.main(str(tmp_path / "gpu"), adam_epochs=10,
                               device=cuda)
    assert mb.LAUNCHES["ns_residual_bwd"] == 10
    assert mb.LAUNCHES["ns_residual_fwd"] == 2
    cpu = poiseuille_flow.main(str(tmp_path / "cpu"), adam_epochs=10,
                               device="cpu")
    a = np.array(gpu.pb.history.loss_global)
    b = np.array(cpu.pb.history.loss_global)
    np.testing.assert_allclose(a, b, rtol=1e-10)
