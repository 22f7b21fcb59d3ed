"""The CUDA kernels on the card (skipped where there is none): the NS
kernels 1-2, the Poisson kernels 3-4 and the Taylor-bundle kernel 5 against
their plain versions (the main widths from 1,000 to 4,194,304 points, widths
that the tile layout pads,
d_in 3, ragged and masked batches; kernel 5 also with dim 1-3, a one-layer
net and streamed weights), bit-identical repeats, the forward MSEs equal to
the backward's, float32 against float64, one device kernel per call, and a
short round of each slice on the card against the CPU; the dense BFGS
round on the card (against the CPU, one kernel-1 launch per evaluation,
bit-identical repeats, and an exact resume from its run folder); the
L-BFGS round on the card (against the CPU, a bit-identical repeat, one
kernel-1 launch per line-search trial; its kernel launches inside the
program's spans, one per ``lbfgs.direction`` span); the L-BFGS direction
kernel against the plain op sequence (float32 and float64, four rings,
n 921-40,000; bit-identical repeats, one launch a call, 60 chained steps
past the ring's wrap); kernels 1/2 over no valid row;
the roofline probe's kernels
against their plain versions and their SASS; the cavity oracle on the card
against the CPU; an unsteady round through kernels 1/2 at d_in 3 against
the CPU.

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
                                            (3, 1000, None),
                                            (2, 1 << 20, None)])
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
def test_kernels_over_no_valid_row(cuda):
    """A shard of padding alone (n_valid 0): kernels 1 and 2 return zero
    sums and gradients without a launch, as their plain versions do."""
    params, x, phys, norm = _case(2, 8, 9, cuda)
    gbar = torch.tensor(W3, dtype=torch.float64, device=cuda)
    before = dict(mb.LAUNCHES)
    dp, mses, loss = mb.ns_residual_bwd(params, x, phys, norm, gbar, 0, 70,
                                        with_loss=True)
    m_fwd = mb.ns_residual_fwd(params, x, phys, norm, 0, 70)
    assert mb.LAUNCHES == before
    ref_l, ref_m, ref_g = _plain_grads(params, x, phys, norm, gbar, 0, 70)
    assert float(loss) == float(ref_l) == 0.0
    assert not mses.any() and not m_fwd.any() and not ref_m.any()
    assert all(not t.any() for p in dp for t in p.values())
    assert all(not g.any() for g in ref_g)


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
                                                     (200, None, 3.0),
                                                     (1 << 20, None, 1.0)])
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


def _kernel_run(kind, n, dtype, device):
    """Kernels 1/2 (ns) or 3/4 (poisson) at n points: one backward and one
    forward call, each one launch, the backward repeated bit for bit and
    the forward's MSEs bit-equal to it.  Returns (params, inputs, flat
    dparams, mses, loss)."""
    if kind == "ns":
        params, x, phys, norm = _case(2, n, 37, device)
        gbar = torch.tensor(W3, dtype=torch.float64, device=device)
        params = [{k: t.to(dtype) for k, t in p.items()} for p in params]
        x, gbar = x.to(dtype), gbar.to(dtype)
        inputs = (x, phys, norm)
        bwd = lambda: mb.ns_residual_bwd(params, x, phys, norm, gbar,
                                         with_loss=True)
        fwd = lambda: mb.ns_residual_fwd(params, x, phys, norm)
    else:
        params, x, f = _poisson_case(n, 41, device)
        gbar = torch.tensor([2.0], dtype=dtype, device=device)
        params = [{k: t.to(dtype) for k, t in p.items()} for p in params]
        x, f = x.to(dtype), f.to(dtype)
        inputs = (x, f)
        bwd = lambda: mb.poisson_residual_bwd(params, x, f, gbar,
                                              with_loss=True)
        fwd = lambda: mb.poisson_residual_fwd(params, x, f)
    key = f"{kind}_residual"
    before = dict(mb.LAUNCHES)
    dp, mses, loss = bwd()
    m_fwd = fwd()
    assert mb.LAUNCHES[key + "_bwd"] == before[key + "_bwd"] + 1
    assert mb.LAUNCHES[key + "_fwd"] == before[key + "_fwd"] + 1
    dp2, mses2, loss2 = bwd()
    flat = [t for p in dp for t in (p["kernel"], p["bias"])]
    assert torch.equal(loss, loss2) and torch.equal(mses, mses2)
    assert all(torch.equal(a, b) for a, b in
               zip(flat, [t for p in dp2 for t in (p["kernel"], p["bias"])]))
    assert torch.equal(m_fwd, mses)
    return params, inputs, flat, mses, loss


@pytest.mark.cuda
@pytest.mark.parametrize("kind,n", [("ns", 1000), ("ns", 1 << 20),
                                    ("poisson", 1000), ("poisson", 1 << 20)])
def test_float32_against_float64_both_heads_on_card(cuda, kind, n):
    """Kernels 1-4 in float32 (FFMA tiles) against float64 (m16n8k8 tiles
    of two streams) at 1,000 and 1,048,576 points: the MSEs at 1e-5, the
    gradients at the float32 test's 1e-5 of the largest at 1,000 points
    and at 1e-4 at 1,048,576 (summed over 1M points in float32 they drift
    1.8e-5 of the largest from float64 on the H100, with the m8n8k4 tile
    as with this one); in each
    dtype repeats bit-identical, the forward MSEs bit-equal to the
    backward's, one launch a call."""
    _, _, got, mses, _ = _kernel_run(kind, n, torch.float64, cuda)
    _, _, got32, m32, _ = _kernel_run(kind, n, torch.float32, cuda)
    torch.testing.assert_close(m32.double(), mses, rtol=1e-5, atol=0)
    bound = 1e-5 if n <= 10_000 else 1e-4
    scale = max(float(t.abs().max()) for t in got)
    for a, b in zip(got32, got):
        assert float((a.double() - b).abs().max()) <= bound * scale


def _plain_in_blocks(kind, params, inputs, gbar, block=1 << 18):
    """The plain version's MSEs and the gradients of gbar·MSEs over the
    whole batch (the mean over all its points), summed over blocks of
    points so that the autograd graph of one block is held at a time."""
    x = inputs[0]
    n = int(x.shape[0])
    leaves = [{k: p[k].detach().clone().requires_grad_(True)
               for k in ("kernel", "bias")} for p in params]
    flat = [t for p in leaves for t in (p["kernel"], p["bias"])]
    mses, grads = 0.0, [torch.zeros_like(t) for t in flat]
    for i in range(0, n, block):
        if kind == "ns":
            m = mb.ns_residual_mse_plain(leaves, x[i:i + block], *inputs[1:],
                                         None, n)
        else:
            m = mb.poisson_residual_mse_plain(leaves, x[i:i + block],
                                              inputs[1][i:i + block], 1.0,
                                              None, n)
        g = torch.autograd.grad((gbar * m).sum(), flat, materialize_grads=True)
        mses = mses + m.detach()
        grads = [a + b for a, b in zip(grads, g)]
    return mses, grads


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ns", "poisson"])
def test_kernels_at_benchmark_shape_on_card(cuda, kind):
    """At the benchmark's 4,194,304 points (16-point tiles), float64:
    one launch a call, repeats bit-identical, the forward MSEs bit-equal
    to the backward's, and the MSEs and gradients against the plain
    version (in blocks of points) at the reference's bars."""
    n = 1 << 22
    params, inputs, got, mses, _ = _kernel_run(kind, n, torch.float64, cuda)
    widths = [2, 32, 32, 32, 3] if kind == "ns" else [2, 20, 20, 20, 1]
    plan = mb.residual_plan(f"{kind}_residual", True, inputs[0], widths, n, n)
    assert plan.P == 16
    gbar = (torch.tensor(W3, dtype=torch.float64, device=cuda) if kind == "ns"
            else torch.tensor([2.0], dtype=torch.float64, device=cuda))
    ref_m, ref_g = _plain_in_blocks(kind, params, inputs, gbar)
    torch.testing.assert_close(mses.reshape(-1), ref_m.reshape(-1),
                               rtol=1e-11, atol=0)
    for a, b in zip(got, ref_g):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


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


# the CUDA runtime and CUDA API calls that launch a kernel, as the trace
# names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


@pytest.mark.cuda
def test_lbfgs_launches_lie_in_program_spans(cuda, tmp_path):
    """The spans share the device trace's clock on the card: under a
    profiler that records the card's activity alone (as the benchmark's
    traced round does), every kernel launch of the L-BFGS iterations lies
    inside a span other than ``round``, each ``lbfgs.direction`` span holds
    one launch (the direction kernel's), and every trial's ``host_read``
    holds the runtime call that copies its flags to the host."""
    from torch.profiler import ProfilerActivity, profile

    from tpinn_torch import profiling
    from tpinn_torch.cases import poiseuille_flow
    from tpinn_torch.optimize import minimize

    drv = poiseuille_flow.main(str(tmp_path), adam_epochs=10,
                               save_results=False, device=cuda,
                               second_round="none")
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        minimize(drv.pb, "jax", "L-BFGS", num_epochs=10)
        torch.cuda.synchronize()
    spans = profiling.spans()
    profiling.clear_spans()
    steps = [s for s in spans if s.name == "step"]
    assert len(steps) == 10
    first, last = steps[0].start_ns, steps[-1].end_ns
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    launches = [h for h in host if h[0] in LAUNCH_CALLS
                and first <= h[1] <= last]
    assert len(launches) >= 10 * 100
    inner = [s for s in spans if s.name != "round"]
    for name, a, b in launches:
        assert any(s.start_ns <= a and b <= s.end_ns for s in inner), \
            (name, a, b)
    directions = [s for s in spans if s.name == "lbfgs.direction"]
    assert len(directions) == 10
    for s in directions:
        held = [h for h in launches if s.start_ns <= h[1] <= s.end_ns]
        assert len(held) == 1, held
    reads = [s for s in spans if s.name == "host_read"
             and spans[s.parent].name == "linesearch.trial"]
    copies = [h for h in host if h[0].startswith(("cudaMemcpy",
                                                  "cudaStreamSynchronize"))]
    assert len(reads) == drv.pb.lbfgs_counts["trials"]
    for s in reads:
        assert any(s.start_ns <= a and b <= s.end_ns
                   for _, a, b in copies), s


# ---------------------------------------------------------------------------
# the L-BFGS direction kernel
# ---------------------------------------------------------------------------

def _lbfgs_state(n, ring, dtype, seed, m=50):
    """(state, x, g) on the CPU: an L-BFGS state of ``ring`` ("count0" a
    fresh one; "partial" count 7, six pairs stored; "wrapped" and
    "zero_curvature" count 123, every slot filled) whose pairs have
    y = D s + noise, D diagonal in [0.5, 2] (positive curvature, as the
    round's line search keeps it), and a gradient g at x whose newest pair
    is of the same kind; with "zero_curvature" the newest pair's Δw and Δu
    have disjoint supports, so ⟨Δu, Δw⟩ = 0 exactly and its weight is 0."""
    from tpinn_torch.optimize import LBFGSState

    rng = np.random.default_rng(seed)
    count = {"count0": 0, "partial": 7, "wrapped": 123,
             "zero_curvature": 123}[ring]
    st = LBFGSState(torch.zeros(n, dtype=dtype), m)
    st.count = count
    pair = lambda s: s * rng.uniform(0.5, 2.0, n) + 1e-3 * rng.normal(size=n) * s
    if count:
        for i in range(m if count > m else count - 1):
            s = 1e-2 * rng.normal(size=n)
            st.diff_params_memory[i] = torch.tensor(s, dtype=dtype)
            st.diff_updates_memory[i] = torch.tensor(pair(s), dtype=dtype)
            st.weights_memory[i] = 1.0 / torch.dot(
                st.diff_updates_memory[i], st.diff_params_memory[i]).double()
        st.params = torch.tensor(rng.normal(size=n), dtype=dtype)
        st.updates = torch.tensor(rng.normal(size=n), dtype=dtype)
    dx = 1e-2 * rng.normal(size=n)
    dg = pair(dx)
    if ring == "zero_curvature":
        dx[n // 2:] = 0.0
        dg[:n // 2] = 0.0
    x = st.params + torch.tensor(dx, dtype=dtype)
    g = st.updates + torch.tensor(dg, dtype=dtype)
    return st, x, g


def _state_to(st, device):
    from tpinn_torch.optimize import LBFGSState

    out = LBFGSState(st.params.to(device), st.weights_memory.shape[0])
    out.count = st.count
    for k in ("params", "updates", "diff_params_memory",
              "diff_updates_memory", "weights_memory"):
        setattr(out, k, getattr(st, k).to(device).clone())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("ring", ["count0", "partial", "wrapped",
                                  "zero_curvature"])
@pytest.mark.parametrize("n", [921, 2307, 2339, 40000])
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_lbfgs_direction_kernel_matches_plain(cuda, dtype, bar, n, ring):
    """The kernel against the plain op sequence on the CPU
    (``_scale_by_lbfgs``'s CPU route), from the same state: the direction
    within ``bar`` of the plain one's norm (the dots sum in another order,
    each off by rounding, and the 100-step recursion carries that on:
    1e-12 in float64; float32's dots round at 6e-8, so 1e-5), the ring's
    rows bit-equal (the differences are elementwise), the newest weight and
    the identity scale within 8 ulps (one dot's rounding, then a division),
    every other weight untouched; two calls agree bit for bit; one launch a
    call."""
    from tpinn_torch.kernels.lbfgs_direction import lbfgs_direction
    from tpinn_torch.optimize import _scale_by_lbfgs, _store_pair

    st, x, g = _lbfgs_state(n, ring, dtype, seed=n)
    ref = _state_to(st, "cpu")
    d_ref = _scale_by_lbfgs(g, ref, x)
    scale_ref = float(_store_pair(g, _state_to(st, "cpu"), x))
    xc, gc = x.to(cuda), g.to(cuda)
    outs = []
    for _ in range(2):
        card = _state_to(st, cuda)
        scale = torch.zeros(1, dtype=torch.float64, device=cuda)
        before = mb.LAUNCHES["lbfgs_direction"]
        d = lbfgs_direction(gc, xc, card.updates, card.params,
                            card.diff_params_memory, card.diff_updates_memory,
                            card.weights_memory, card.count, scale_out=scale)
        torch.cuda.synchronize()
        assert mb.LAUNCHES["lbfgs_direction"] == before + 1
        outs.append((d.cpu(), card, float(scale)))
    (d, card, scale), (d2, card2, scale2) = outs
    assert d.dtype == dtype and d.shape == (n,)
    assert torch.equal(d, d2) and scale == scale2
    assert torch.equal(card.weights_memory, card2.weights_memory)
    gap = float(torch.linalg.norm((d - d_ref).double())
                / torch.linalg.norm(d_ref.double()))
    assert gap < bar, gap
    assert torch.equal(card.diff_params_memory.cpu(), ref.diff_params_memory)
    assert torch.equal(card.diff_updates_memory.cpu(),
                       ref.diff_updates_memory)
    assert card.count == st.count  # the wrapper leaves the count to the caller
    ulp = 8 * torch.finfo(dtype).eps
    prev = (st.count - 1) % 50
    w, w_ref = card.weights_memory.cpu(), ref.weights_memory
    keep = [i for i in range(50) if i != prev]
    assert torch.equal(w[keep], w_ref[keep])
    assert abs(float(w[prev]) - float(w_ref[prev])) <= ulp * abs(float(w_ref[prev]))
    if ring == "zero_curvature":
        assert float(w[prev]) == 0.0 == scale
    assert abs(scale - scale_ref) <= ulp * abs(scale_ref)


@pytest.mark.cuda
def test_lbfgs_direction_on_the_round_matches_plain_each_step(cuda):
    """``_scale_by_lbfgs`` chained over 60 steps of a quadratic on the card
    and on the CPU, past the ring's wrap, each side fed the same gradients
    and positions: every direction within 1e-12 of the plain one, the card's
    state moving on as the plain one (count, x_prev, g_prev), one launch a
    step."""
    from tpinn_torch.optimize import LBFGSState, _scale_by_lbfgs

    rng = np.random.default_rng(7)
    n = 2307
    diag = torch.tensor(rng.uniform(0.5, 2.0, n))
    x = torch.tensor(rng.normal(size=n))
    cpu, card = LBFGSState(x, 50), LBFGSState(x.to(cuda), 50)
    before = mb.LAUNCHES["lbfgs_direction"]
    for k in range(60):
        g = diag * x + 1e-3 * torch.tensor(rng.normal(size=n))
        d_ref = _scale_by_lbfgs(g, cpu, x)
        xc, gc = x.to(cuda), g.to(cuda)
        d = _scale_by_lbfgs(gc, card, xc).cpu()
        gap = float(torch.linalg.norm(d - d_ref) / torch.linalg.norm(d_ref))
        assert gap < 1e-12, (k, gap)
        assert card.count == cpu.count == k + 1
        assert card.params is xc and card.updates is gc
        x = x + 0.5 * d_ref
    assert mb.LAUNCHES["lbfgs_direction"] == before + 60


# ---------------------------------------------------------------------------
# the roofline probe's kernels, the cavity oracle and the unsteady path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bar", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_roofline_probe_matches_plain_on_card(cuda, dtype, bar):
    """Every probe body, S 5 and 6, C 8, 16 and 32, against its plain
    version on the card (max |Δ| within bar·max|ref|; 8 reps keep float32
    chains normal), and a repeat bit-identical."""
    from tpinn_torch.kernels import roofline_probe as rp

    for S in rp.STREAMS:
        for C in rp.CHUNKS:
            w, s = rp.inputs(S, C, 7, dtype, cuda, seed=S + C)
            for body in rp.BODIES:
                got = rp.probe(body, w, s, 8)
                ref = rp.PLAIN[body](w, s, 8)
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                assert err <= bar * scale, (body, S, C, err, scale)
                assert torch.equal(rp.probe(body, w, s, 8), got)


@pytest.mark.cuda
def test_roofline_probe_sass_counts(cuda):
    """Each instance's DMMA / DFMA / FFMA as expected_sass says (one rep's
    in float64, whole unrolled steps in float32), no HMMA (TF32)."""
    from tpinn_torch.kernels import build
    from tpinn_torch.kernels import roofline_probe as rp

    build.library("roofline_probe.cu")
    counts = rp.sass_counts(build.last_build().paths["roofline_probe.cu"])
    if counts is None:
        pytest.skip("the toolkit has no cuobjdump")
    assert len(counts) == len(rp.BODIES) * 2 * len(rp.STREAMS) * len(rp.CHUNKS)
    for key, got in counts.items():
        assert rp.sass_problems(key, got) == [], (key, got)


@pytest.mark.cuda
def test_cavity_oracle_on_card_matches_cpu(cuda):
    """n = 32 over 20 output steps: every field within 1e-9·max|field| and
    the same CG iterations in every pressure solve."""
    from tpinn_torch.oracles import cavity

    runs = {}
    for device in (cuda, "cpu"):
        counts = cavity.CGCounts()
        runs[str(device)] = (cavity.solve_cavity_unsteady(
            n=32, t_end=2e-3, dt_out=1e-4, device=device, counts=counts),
            counts.iterations())
    (t_g, snaps_g), its_g = runs[str(cuda)]
    (t_c, snaps_c), its_c = runs["cpu"]
    assert its_g == its_c and len(its_g) == 20
    np.testing.assert_array_equal(t_g, t_c)
    for a, b in zip(snaps_c, snaps_g):
        for fa, fb in zip(a, b):
            assert np.max(np.abs(fa - fb)) <= 1e-9 * max(np.max(np.abs(fa)),
                                                         1e-300)


@pytest.mark.cuda
def test_unsteady_round_on_card_matches_cpu(cuda, tmp_path):
    """The unsteady path at small options (3-32-32-32-3, a decaying vortex
    as exact solution on 10 slices of a 21 × 21 grid): Adam 10 + BFGS 5
    through kernels 1/2 at d_in 3 on the card against the CPU within 1e-8,
    one kernel-1 launch per value and gradient."""
    from tpinn_torch.config import SimulationOptions
    from tpinn_torch.driver import CaseSpec, StandardNSDriver

    def vortex(k, c):
        def f(q):
            decay = torch.exp(-k * np.pi ** 2 * q[:, 0])
            x, y = np.pi * q[:, 1], np.pi * q[:, 2]
            return c(x, y) * decay
        return f

    u = vortex(2, lambda x, y: -torch.cos(x) * torch.sin(y))
    v = vortex(2, lambda x, y: torch.sin(x) * torch.cos(y))
    p = vortex(4, lambda x, y: -0.25 * (torch.cos(2 * x) + torch.cos(2 * y)))
    spec = CaseSpec(name="Vortex", extents=[(0.0, 1.0), (0.0, 1.0)],
                    grid_shape=(20, 20),
                    physics=NSPhysics(conv=1.0, visc=1.0, time=1.0),
                    exact=(u, v, p),
                    bnd_val={0: {e: u for e in ("BOT", "DX", "TOP", "SX")},
                             1: {e: v for e in ("BOT", "DX", "TOP", "SX")}},
                    weights={"PDE_MASS": 1e1}, unsteady=True,
                    time_horizon=1e-2, dt=1e-3)
    opts = SimulationOptions(epochs=5, noise_fit=0.05, noise_bnd=0.05,
                             n_pde=500, n_bc=50, n_ic=50, n_vel=20, n_pres=0,
                             n_test=100)
    runs = {}
    for device in (cuda, "cpu"):
        mb.reset_launch_counts()
        drv = StandardNSDriver(spec, opts, base_dir=str(tmp_path),
                               save_results=False, device=device,
                               second_round="jax-bfgs", adam_epochs=10)
        drv.train(callbacks=False)
        runs[str(device)] = (drv, dict(mb.LAUNCHES))
    (gpu, launches), (cpu, _) = runs[str(cuda)], runs["cpu"]
    h, hc = gpu.pb.history, cpu.pb.history
    assert h.iters == hc.iters
    a, b = _logs(h), _logs(hc)
    assert np.max(np.abs(a - b) / np.abs(b)) < 1e-8
    assert launches["ns_residual_bwd"] == 10 + gpu.pb.bfgs_counts["evaluations"]
    assert launches["ns_residual_fwd"] == len(h.iters)
