"""The CUDA kernels on the card (skipped where there is none): the NS
kernels 1-2, the Poisson kernels 3-4 and the Taylor-bundle kernel 5 against
their plain versions (the main widths, widths that the tile layout pads,
d_in 3, ragged and masked batches; kernel 5 also with dim 1-3, a one-layer
net and streamed weights), bit-identical repeats, the forward MSEs equal to
the backward's, float32 against float64, one device kernel per call, and a
short round of each slice on the card against the CPU; the dense BFGS
round on the card (against the CPU, one kernel-1 launch per evaluation,
bit-identical repeats, and an exact resume from its run folder); the
L-BFGS round on the card (against the CPU, a bit-identical repeat, one
kernel-1 launch per line-search trial).

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


def _case(d_in, n, seed, device, widths=None):
    rng = np.random.default_rng(seed)
    widths = widths or (d_in, 32, 32, 32, 3)
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
                               device=cuda, second_round="none")
    assert mb.LAUNCHES["ns_residual_bwd"] == 10
    assert mb.LAUNCHES["ns_residual_fwd"] == 2
    cpu = poiseuille_flow.main(str(tmp_path / "cpu"), adam_epochs=10,
                               device="cpu", second_round="none")
    a = np.array(gpu.pb.history.loss_global)
    b = np.array(cpu.pb.history.loss_global)
    np.testing.assert_allclose(a, b, rtol=1e-10)


def _poisson_case(n, seed, device, widths=(2, 20, 20, 20, 1)):
    rng = np.random.default_rng(seed)
    params = []
    for a, b in zip(widths[:-1], widths[1:]):
        lim = np.sqrt(6.0 / (a + b))
        params.append({
            "kernel": torch.tensor(rng.uniform(-lim, lim, (a, b)), device=device),
            "bias": torch.tensor(rng.uniform(-0.1, 0.1, b), device=device)})
    x = torch.tensor(rng.uniform(0, 2 * np.pi, (n, 2)), device=device)
    f = 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])
    return params, x, f


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_valid,normalization", [(200, None, 1.0),
                                                     (4099, 4000, 1.0),
                                                     (200, None, 3.0)])
def test_poisson_kernels_match_plain_on_card(cuda, n, n_valid, normalization):
    """Kernels 3 and 4 against their plain versions at the reference's
    bars; repeat calls bit-identical; kernel 4's MSE equals kernel 3's."""
    params, x, f = _poisson_case(n, 11, cuda)
    gbar = torch.tensor([2.0], dtype=torch.float64, device=cuda)
    dp, mse, loss = mb.poisson_residual_bwd(params, x, f, gbar, normalization,
                                            n_valid, n_valid, with_loss=True)
    leaves = [{k: p[k].detach().clone().requires_grad_(True)
               for k in ("kernel", "bias")} for p in params]
    ref_m = mb.poisson_residual_mse_plain(leaves, x, f, normalization,
                                          n_valid, n_valid)
    flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
    ref_g = torch.autograd.grad(2.0 * ref_m, flat, materialize_grads=True)
    torch.testing.assert_close(loss, 2.0 * ref_m.detach(), rtol=1e-11, atol=0)
    torch.testing.assert_close(mse, ref_m.detach(), rtol=1e-11, atol=0)
    got = [t for p in dp for t in (p["kernel"], p["bias"])]
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    dp2, mse2, loss2 = mb.poisson_residual_bwd(params, x, f, gbar,
                                               normalization, n_valid,
                                               n_valid, with_loss=True)
    assert torch.equal(loss, loss2) and torch.equal(mse, mse2)
    assert all(torch.equal(a, b) for a, b in
               zip(got, [t for p in dp2 for t in (p["kernel"], p["bias"])]))
    m_fwd = mb.poisson_residual_fwd(params, x, f, normalization, n_valid,
                                    n_valid)
    assert torch.equal(m_fwd, mse)


@pytest.mark.cuda
def test_poisson_round_on_card_matches_cpu(cuda, tmp_path):
    """The Poisson case's 100 Adam epochs and five L-BFGS-B iterations on
    the card and on the CPU (plain versions) from the same seed."""
    from tpinn_torch.cases import poisson

    mb.reset_launch_counts()
    gpu, _ = poisson.main(5, out_dir=str(tmp_path / "gpu"), device=cuda)
    assert mb.LAUNCHES["poisson_residual_bwd"] >= 100 + 5
    assert mb.LAUNCHES["poisson_residual_fwd"] >= 11
    cpu, _ = poisson.main(5, out_dir=str(tmp_path / "cpu"), device="cpu")
    assert gpu.history.iters == cpu.history.iters
    a = np.array(gpu.history.loss_global)
    b = np.array(cpu.history.loss_global)
    np.testing.assert_allclose(a, b, rtol=1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_valid", [
    ((2, 7, 7, 3), 1000, None),
    ((2, 24, 24, 3), 1003, 997),
    ((2, 64, 64, 3), 4099, 4000),
    ((3, 16, 16, 3), 777, None),
    ((3, 7, 7, 3), 50, 45),
])
def test_ns_kernels_padded_widths_on_card(cuda, widths, n, n_valid):
    """Widths that the tile layout pads to multiples of 8, d_in 3, ragged
    last tiles and masked tails: kernel 1 against its plain version, repeats
    bit-identical, kernel 2's MSEs bit-equal to kernel 1's."""
    params, x, phys, norm = _case(widths[0], n, 17, cuda, widths)
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
    assert torch.equal(mb.ns_residual_fwd(params, x, phys, norm, n_valid,
                                          n_valid), mses)


@pytest.mark.cuda
@pytest.mark.parametrize("widths,n,n_valid", [
    ((2, 7, 7, 1), 1000, None),
    ((2, 20, 20, 20, 1), 203, 197),
    ((2, 64, 64, 1), 4099, 4000),
])
def test_poisson_kernels_padded_widths_on_card(cuda, widths, n, n_valid):
    """Kernels 3 and 4 at padded widths and ragged or masked batches."""
    params, x, f = _poisson_case(n, 19, cuda, widths)
    gbar = torch.tensor([2.0], dtype=torch.float64, device=cuda)
    dp, mse, loss = mb.poisson_residual_bwd(params, x, f, gbar, 1.5, n_valid,
                                            n_valid, with_loss=True)
    leaves = [{k: p[k].detach().clone().requires_grad_(True)
               for k in ("kernel", "bias")} for p in params]
    ref_m = mb.poisson_residual_mse_plain(leaves, x, f, 1.5, n_valid, n_valid)
    flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
    ref_g = torch.autograd.grad(2.0 * ref_m, flat, materialize_grads=True)
    torch.testing.assert_close(mse, ref_m.detach(), rtol=1e-11, atol=0)
    got = [t for p in dp for t in (p["kernel"], p["bias"])]
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)
    _, mse2, loss2 = mb.poisson_residual_bwd(params, x, f, gbar, 1.5, n_valid,
                                             n_valid, with_loss=True)
    assert torch.equal(mse, mse2) and torch.equal(loss, loss2)
    assert torch.equal(mb.poisson_residual_fwd(params, x, f, 1.5, n_valid,
                                               n_valid), mse)


@pytest.mark.cuda
def test_ticket_resets_between_calls_on_card(cuda):
    """Back-to-back calls at two batch sizes (two grids) on one stream:
    each launch's last block resets the ticket, so every result is right."""
    small = _case(2, 1000, 3, cuda)
    large = _case(2, 50_000, 4, cuda)
    gbar = torch.tensor(W3, dtype=torch.float64, device=cuda)
    outs = [mb.ns_residual_bwd(*c, gbar, with_loss=True)
            for c in (small, large, small, large, small)]
    for c, (dp, mses, loss) in zip((small, large), outs[:2]):
        ref_l, ref_m, _ = _plain_grads(*c, gbar, None, None)
        torch.testing.assert_close(mses, ref_m, rtol=1e-11, atol=0)
    for a, b in zip(outs, outs[2:]):
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


@pytest.mark.cuda
def test_float32_kernels_on_card(cuda):
    """The float32 instances (FFMA tiles, no TF32) against float64."""
    params, x, phys, norm = _case(2, 2000, 5, cuda)
    gbar = torch.tensor(W3, dtype=torch.float64, device=cuda)
    dp, mses, _ = mb.ns_residual_bwd(params, x, phys, norm, gbar)
    p32 = [{k: t.float() for k, t in p.items()} for p in params]
    dp32, m32, _ = mb.ns_residual_bwd(p32, x.float(), phys, norm, gbar.float())
    torch.testing.assert_close(m32.double(), mses, rtol=1e-5, atol=0)
    scale = max(float(t.abs().max()) for p in dp for t in p.values())
    for a, b in zip(dp32, dp):
        for k in a:
            assert float((a[k].double() - b[k]).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_one_device_kernel_per_call(cuda):
    """Each wrapper call of kernels 1-4 is one device kernel (no second
    reduction launch), as torch.profiler sees it."""
    from torch.profiler import ProfilerActivity, profile

    params, x, phys, norm = _case(2, 1000, 9, cuda)
    pp, px, pf = _poisson_case(200, 11, cuda)
    gbar = torch.tensor(W3, dtype=torch.float64, device=cuda)
    g1 = torch.tensor([2.0], dtype=torch.float64, device=cuda)
    calls = {
        "ns_residual_bwd": lambda: mb.ns_residual_bwd(params, x, phys, norm,
                                                      gbar, with_loss=True),
        "ns_residual_fwd": lambda: mb.ns_residual_fwd(params, x, phys, norm),
        "poisson_residual_bwd": lambda: mb.poisson_residual_bwd(
            pp, px, pf, g1, with_loss=True),
        "poisson_residual_fwd": lambda: mb.poisson_residual_fwd(pp, px, pf),
    }
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):  # a profiler session now and then drops records
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            kernels = [e for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(kernels) >= 5:
                break
        assert len(kernels) == 5, (name, [e.name for e in kernels])
        assert all("residual_kernel" in e.name for e in kernels), name


def _bundle_case(d_in, d_out, n, seed, device, widths=(32, 32, 32)):
    rng = np.random.default_rng(seed)
    sizes = (d_in,) + widths + (d_out,)
    params = []
    for a, b in zip(sizes[:-1], sizes[1:]):
        lim = np.sqrt(6.0 / (a + b))
        params.append({
            "kernel": torch.tensor(rng.uniform(-lim, lim, (a, b)), device=device),
            "bias": torch.tensor(rng.uniform(-0.1, 0.1, b), device=device)})
    x = torch.tensor(rng.uniform(-1, 1, (n, d_in)), device=device)
    return params, x


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,d_out,n,dim", [(2, 3, 1000, None),
                                              (2, 3, 4099, None),
                                              (3, 3, 1000, None),
                                              (3, 3, 1000, 2),
                                              (2, 1, 1000, None)])
def test_taylor_bundle_matches_plain_on_card(cuda, d_in, d_out, n, dim):
    """Kernel 5 against its plain version (max |Δ| ≤ 1e-12·max|ref| per
    output), repeat calls bit-identical, one launch per call."""
    params, x = _bundle_case(d_in, d_out, n, 13, cuda)
    before = mb.LAUNCHES["taylor_bundle"]
    got = mb.mlp_taylor_bundle(params, x, dim)
    assert mb.LAUNCHES["taylor_bundle"] == before + 1
    ref = mb.mlp_taylor_bundle_plain(params, x, dim)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float(torch.max(torch.abs(a - b))) <= \
            1e-12 * float(torch.max(torch.abs(b)))
    again = mb.mlp_taylor_bundle(params, x, dim)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d_in,hidden,d_out,n,dim", [
    (3, (20, 20, 20), 3, 1001, 1),
    (3, (20, 20, 20), 3, 1001, 2),
    (3, (20, 20, 20), 3, 1001, 3),
    (3, (64, 64), 3, 777, 3),
    (2, (64, 64, 64), 1, 4099, 2),
    (2, (), 3, 999, 2),
    (3, (), 1, 1003, 3),
    (3, (64,) * 7, 3, 333, 3),
])
def test_taylor_bundle_tiles_on_card(cuda, d_in, hidden, d_out, n, dim):
    """Kernel 5 at ragged n (no multiple of any tile), d_in 3 with dim 1-3,
    widths 20 and 64, a one-layer net and a net whose weights are streamed
    layer by layer: against its plain version at 1e-12·max|ref| per
    output, repeats bit-identical, the launch plan equal to its mirror."""
    params, x = _bundle_case(d_in, d_out, n, 23, cuda, hidden)
    got = mb.mlp_taylor_bundle(params, x, dim)
    ref = mb.mlp_taylor_bundle_plain(params, x, dim)
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        assert float(torch.max(torch.abs(a - b))) <= \
            1e-12 * float(torch.max(torch.abs(b)))
    again = mb.mlp_taylor_bundle(params, x, dim)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    widths = (d_in,) + hidden + (d_out,)
    plan = mb._PLANS[("taylor_bundle", x.device.index, x.dtype,
                      widths, dim, n)]
    assert (plan.P, bool(plan.streamed), plan.smem) == \
        mb.bundle_plan(widths, d_in, dim, 8)


@pytest.mark.cuda
def test_taylor_bundle_float32_on_card(cuda):
    """The float32 instance (FFMA tiles, no TF32) against float64."""
    params, x = _bundle_case(2, 3, 3001, 29, cuda)
    ref = mb.mlp_taylor_bundle(params, x)
    p32 = [{k: t.float() for k, t in p.items()} for p in params]
    got = mb.mlp_taylor_bundle(p32, x.float())
    for a, b in zip(got, ref):
        assert a.dtype == torch.float32
        err = float(torch.max(torch.abs(a.double() - b)))
        assert err <= 1e-5 * float(torch.max(torch.abs(b))), err


@pytest.mark.cuda
def test_taylor_bundle_back_to_back_on_card(cuda):
    """Calls at two batch sizes (two grids) in turns on one stream: every
    call bit-equal to the first at its size, which matches the plain
    version."""
    cases = {n: _bundle_case(2, 3, n, 31, cuda) for n in (1000, 50_000)}
    first = {}
    for _ in range(3):
        for n, (params, x) in cases.items():
            got = mb.mlp_taylor_bundle(params, x)
            ref = first.setdefault(n, got)
            assert all(torch.equal(a, b) for a, b in zip(got, ref)), n
    for n, (params, x) in cases.items():
        for a, b in zip(first[n], mb.mlp_taylor_bundle_plain(params, x)):
            assert float(torch.max(torch.abs(a - b))) <= \
                1e-12 * float(torch.max(torch.abs(b)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 1 << 20])
def test_taylor_bundle_one_device_kernel_per_call(cuda, n):
    """Each kernel-5 call is one device kernel, as torch.profiler sees it."""
    from torch.profiler import ProfilerActivity, profile

    params, x = _bundle_case(2, 3, n, 9, cuda)
    mb.mlp_taylor_bundle(params, x)
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then drops records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                mb.mlp_taylor_bundle(params, x)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(kernels) >= 3:
            break
    assert len(kernels) == 3, [e.name for e in kernels]
    assert all("taylor_bundle_kernel" in e.name for e in kernels)


@pytest.mark.cuda
def test_taylor_bundle_backward_raises_on_card(cuda):
    params, x = _bundle_case(2, 3, 64, 5, cuda)
    leaves = [{k: t.clone().requires_grad_(True) for k, t in p.items()}
              for p in params]
    value, jac, hdiag = mb.mlp_taylor_bundle(leaves, x)
    flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
    with pytest.raises(RuntimeError, match="TPINN_USE_PALLAS"):
        torch.autograd.grad((value.sum() + jac.sum() + hdiag.sum()), flat)


def _bfgs_driver(tmp, device, iters, adam_epochs=10, resume_from=None):
    """The Poiseuille case (reference options, float64) on ``device``:
    Adam, then ``iters`` dense BFGS iterations, the artifacts written."""
    from tpinn_torch.cases import poiseuille_flow

    return poiseuille_flow.main(str(tmp), adam_epochs=adam_epochs,
                                device=device, second_round="jax-bfgs",
                                epochs=iters, resume_from=resume_from)


def _logs(h):
    return np.array([h.loss_global]
                    + [e["log"] for e in h.losses.values()]
                    + [e["log"] for e in h.losses_test.values()])


@pytest.mark.cuda
def test_bfgs_round_on_card_matches_cpu(cuda, tmp_path):
    """Ten BFGS iterations after ten Adam epochs, on the card and on the
    CPU (plain versions) from the same seed: the same variant and the same
    history within 1e-8 relative."""
    gpu = _bfgs_driver(tmp_path / "gpu", cuda, 10)
    cpu = _bfgs_driver(tmp_path / "cpu", "cpu", 10)
    assert gpu.pb.last_opt_state["kind"] == "bfgs_plain"
    assert gpu.pb.history.iters == cpu.pb.history.iters
    a, b = _logs(gpu.pb.history), _logs(cpu.pb.history)
    assert np.max(np.abs(a - b) / np.abs(b)) < 1e-8
    assert a[0, -1] < a[0, 0]


@pytest.mark.cuda
def test_bfgs_one_kernel_launch_per_evaluation(cuda, tmp_path):
    """On the main path every value and gradient of the BFGS round is one
    kernel-1 launch, and every logged evaluation one kernel-2 launch."""
    mb.reset_launch_counts()
    drv = _bfgs_driver(tmp_path, cuda, 10, adam_epochs=0)
    counts = drv.pb.bfgs_counts
    assert counts["iterations"] == 10
    assert mb.LAUNCHES["ns_residual_bwd"] == counts["evaluations"] \
        == counts["trials"] + 2 * 10 + 1
    assert mb.LAUNCHES["ns_residual_fwd"] == len(drv.pb.history.iters)
    assert mb.LAUNCHES["taylor_bundle"] == 0


@pytest.mark.cuda
def test_bfgs_round_repeats_bit_identical_on_card(cuda, tmp_path):
    a = _bfgs_driver(tmp_path / "a", cuda, 10)
    b = _bfgs_driver(tmp_path / "b", cuda, 10)
    np.testing.assert_array_equal(_logs(a.pb.history), _logs(b.pb.history))
    for p, q in zip(a.model.flat_params(), b.model.flat_params()):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_bfgs_resume_exact_on_card(cuda, tmp_path):
    """20 iterations straight against 10, the artifacts, and 10 more in a
    new driver resuming the run folder: the same logs bit for bit (the
    resumed round logs iteration 10 again as its iteration 0)."""
    straight = _bfgs_driver(tmp_path / "a", cuda, 20)
    first = _bfgs_driver(tmp_path / "b", cuda, 10)
    resumed = _bfgs_driver(tmp_path / "b", cuda, 10, resume_from=first.folder)
    hs, hr = straight.pb.history, resumed.pb.history
    assert hr.round_names == ["keras_Adam", "jax_BFGS", "jax_BFGS"]
    assert resumed.pb.resume_opt_state is None  # the carry was adopted
    s = _logs(hs)[:, [i for i, r in enumerate(hs.rounds_idx) if r == 2]]
    r = _logs(hr)
    r2 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 2]]
    r3 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 3]]
    np.testing.assert_array_equal(r2, s[:, :2])
    np.testing.assert_array_equal(r3, s[:, 1:])
    for p, q in zip(straight.model.flat_params(),
                    resumed.model.flat_params()):
        assert torch.equal(p, q)


def _lbfgs_driver(tmp, device, iters, adam_epochs=10):
    """The Poiseuille case (reference options, float64) on ``device``:
    Adam, then ``iters`` on-device L-BFGS iterations."""
    from tpinn_torch.cases import poiseuille_flow

    return poiseuille_flow.main(str(tmp), adam_epochs=adam_epochs,
                                device=device, second_round="jax",
                                epochs=iters)


@pytest.mark.cuda
def test_lbfgs_round_on_card_matches_cpu(cuda, tmp_path):
    """Ten L-BFGS iterations after ten Adam epochs, on the card and on the
    CPU (plain versions) from the same seed: the same history within 1e-8
    relative."""
    gpu = _lbfgs_driver(tmp_path / "gpu", cuda, 10)
    cpu = _lbfgs_driver(tmp_path / "cpu", "cpu", 10)
    assert gpu.pb.history.round_names == ["keras_Adam", "jax_L-BFGS"]
    assert gpu.pb.history.iters == cpu.pb.history.iters
    a, b = _logs(gpu.pb.history), _logs(cpu.pb.history)
    assert np.max(np.abs(a - b) / np.abs(b)) < 1e-8
    assert a[0, -1] < a[0, 0]


@pytest.mark.cuda
def test_lbfgs_round_repeats_bit_identical_on_card(cuda, tmp_path):
    a = _lbfgs_driver(tmp_path / "a", cuda, 10)
    b = _lbfgs_driver(tmp_path / "b", cuda, 10)
    np.testing.assert_array_equal(_logs(a.pb.history), _logs(b.pb.history))
    for p, q in zip(a.model.flat_params(), b.model.flat_params()):
        assert torch.equal(p, q)


@pytest.mark.cuda
def test_lbfgs_one_kernel_launch_per_trial(cuda, tmp_path):
    """On the main path every line-search trial of the L-BFGS round is one
    kernel-1 launch, plus one for the first iteration's value and
    gradient; every logged evaluation is one kernel-2 launch."""
    mb.reset_launch_counts()
    drv = _lbfgs_driver(tmp_path, cuda, 10, adam_epochs=0)
    counts = drv.pb.lbfgs_counts
    assert counts["iterations"] == 10
    assert mb.LAUNCHES["ns_residual_bwd"] == counts["evaluations"] \
        == counts["trials"] + 1
    assert mb.LAUNCHES["ns_residual_fwd"] == len(drv.pb.history.iters)
    assert mb.LAUNCHES["taylor_bundle"] == 0
