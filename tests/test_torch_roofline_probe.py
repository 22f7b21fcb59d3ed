"""The roofline probe's plain bodies (tpinn_torch/kernels/roofline_probe.py)
against the JAX package's TPU bodies (scripts/roofline_probe.py:101-149).

Those bodies are closures inside the script's ``main`` and take Pallas
refs, so they are restated here as functions of arrays on one (S, W, C)
tile, with the package's own ``_dot_fwd`` / ``_dot_gram`` (the float64
precision policy, None); the port's plain versions run on a batch of such
tiles.  Bar: 1e-12·max|ref| in float64 at small C and R.  The kernels
themselves run on the card (tests/test_torch_cuda.py, chip_smoke.py phase
24).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpinn.pallas.mlp_bundle import _dot_fwd, _dot_gram
from tpinn_torch.kernels import mlp_bundle as mb
from tpinn_torch.kernels import roofline_probe as rp

torch.set_num_threads(1)

BAR = 1e-12
DT = jnp.float64


def _fwd(w, s, S, R):
    accs = [s[si] for si in range(S)]
    for _ in range(R):
        accs = [_dot_fwd(w, a, DT, None) * 1e-3 for a in accs]
    return jnp.stack(accs)


def _gram(w, s, S, R):
    W, C = s.shape[1:]
    accs = [s[si] for si in range(S)]
    gs = [jnp.zeros((W, W), DT) for _ in range(S)]
    for _ in range(R):
        gs = [g + _dot_gram(a, a, DT, None) for g, a in zip(gs, accs)]
        accs = [a * 0.999 for a in accs]
    g = sum(gs[1:], gs[0])
    return jnp.broadcast_to(g[:, :1], (S, W, C)) + s * 0.0


def _vpu(w, s, S, R):
    accs = [s[si] for si in range(S)]
    bs = [s[(si + 1) % S] for si in range(S)]
    for _ in range(R):
        accs = [a * b + 0.5 for a, b in zip(accs, bs)]
    return jnp.stack(accs)


def _tanh(w, s, S, R):
    accs = [s[si] for si in range(S)]
    for _ in range(R):
        accs = [jnp.tanh(a) for a in accs]
    return jnp.stack(accs)


def _overlap(w, s, S, R):
    accs = [s[si] for si in range(S)]
    bs = [s[(si + 1) % S or 1] for si in range(S)]
    for _ in range(R):
        accs = [_dot_fwd(w, accs[0], DT, None) * 1e-3] + [
            a * b + 0.5 for a, b in zip(accs[1:], bs[1:])]
    return jnp.stack(accs)


TPU_BODIES = {"fwd_dot": _fwd, "gram_dot": _gram, "vpu_fma": _vpu,
              "tanh_elems": _tanh, "overlap_mix": _overlap}


@pytest.mark.parametrize("body", rp.BODIES)
@pytest.mark.parametrize("S,C,R", [(5, 8, 3), (6, 16, 2), (5, 32, 1),
                                   (6, 8, 0)])
def test_plain_body_matches_tpinn(body, S, C, R):
    rng = np.random.default_rng(S * 100 + C + R)
    w = rng.normal(size=(32, 32)) * 0.1
    s = rng.normal(size=(3, S, 32, C)) * 0.1
    got = rp.probe(body, torch.as_tensor(w), torch.as_tensor(s), R).numpy()
    assert got.shape == s.shape
    for t in range(s.shape[0]):
        ref = np.asarray(TPU_BODIES[body](jnp.asarray(w), jnp.asarray(s[t]),
                                          S, R))
        scale = float(np.max(np.abs(ref)))
        assert float(np.max(np.abs(got[t] - ref))) <= BAR * scale, body


def test_work_counts_match_tpinn():
    """The counts the rates divide by: tpinn's run() arguments."""
    W, C, S, R = 32, 8, 5, 96
    assert rp.work("fwd_dot", C, S, R) == 2.0 * W * W * C * S * R
    assert rp.work("gram_dot", C, S, R) == 2.0 * W * W * C * S * R
    assert rp.work("vpu_fma", C, S, R) == 2.0 * W * C * S * R
    assert rp.work("tanh_elems", C, S, R) == 1.0 * W * C * S * R
    assert rp.work("overlap_mix", C, S, R) == (2.0 * W * W * C * R
                                               + 2.0 * W * C * (S - 1) * R)


def test_default_chunk_is_the_residual_tile():
    """C is the residual kernels' points per tile on the unsteady main path
    (3-32-32-32-3, float64, 10,000 points), one of the tile candidates."""
    assert rp.default_chunk() == mb.plan_points((3, 32, 32, 32, 3), 3, 3, 0,
                                                8, 10_000) == 8
    assert set(rp.CHUNKS) <= set(mb.TILE_POINTS)


def test_wrapper_checks_and_counts_nothing_on_the_cpu():
    w = torch.zeros(32, 32, dtype=torch.float64)
    s = torch.zeros(2, 5, 32, 8, dtype=torch.float64)
    rp.reset_launch_counts()
    rp.probe("fwd_dot", w, s, 2)
    assert sum(rp.LAUNCHES.values()) == 0
    bad = [("fwd", w, s), ("fwd_dot", w, torch.zeros(2, 4, 32, 8,
                                                     dtype=torch.float64)),
           ("fwd_dot", w, torch.zeros(2, 5, 32, 12, dtype=torch.float64)),
           ("fwd_dot", w.float(), s), ("fwd_dot", w[:16], s)]
    for body, ww, ss in bad:
        with pytest.raises(ValueError):
            rp.probe(body, ww, ss, 1)
    with pytest.raises(ValueError, match="no path"):
        rp.probe("fwd_dot", w.to("meta"), s.to("meta"), 1)


def test_expected_sass_counts():
    """Per instance: the float64 dot job's 4 steps of an m16n8k8 DMMA per
    pair of streams and two m8n8k4 for an odd S's last stream, the gram's
    C/8 DMMA (m16n8k8) per stream, the fma chains' DFMA, one rep each; float32 a whole number of the unrolled steps' FFMA; no DMMA in
    float32 and no HMMA (TF32) anywhere; and one rep's instructions give the
    probe's FLOPs."""
    assert rp.expected_sass("fwd_dot", "float64", 6, 8) == {"HMMA": 0,
                                                           "DMMA": 12}
    assert rp.expected_sass("fwd_dot", "float64", 5, 8)["DMMA"] == 16
    assert rp.expected_sass("gram_dot", "float64", 5, 32)["DMMA"] == 20
    assert rp.expected_sass("fwd_dot", "float32", 5, 8) == {
        "HMMA": 0, "DMMA": 0, "FFMA": (20, 640)}
    assert rp.expected_sass("vpu_fma", "float64", 5, 16)["DFMA"] == 10
    assert rp.expected_sass("overlap_mix", "float64", 5, 8) == {
        "HMMA": 0, "DMMA": 8, "DFMA": 8}
    assert rp.expected_sass("tanh_elems", "float32", 6, 8) == {"HMMA": 0,
                                                               "DMMA": 0}
    # what nvcc 12.8 made for the H100: f32 fwd 80 FFMA and f32
    # gram 40 at S 5, f32 overlap 16 + 16; a folded or TF32 body is refused
    zero = {"DMMA": 0, "HMMA": 0, "DFMA": 0, "FFMA": 0}
    assert rp.sass_problems(("fwd_dot", "float32", 5, 8),
                            {**zero, "FFMA": 80}) == []
    assert rp.sass_problems(("gram_dot", "float32", 5, 8),
                            {**zero, "FFMA": 40}) == []
    assert rp.sass_problems(("overlap_mix", "float32", 5, 8),
                            {**zero, "FFMA": 32}) == []
    assert rp.sass_problems(("gram_dot", "float32", 5, 8),
                            {**zero, "FFMA": 41})
    assert rp.sass_problems(("fwd_dot", "float64", 5, 8),
                            {**zero, "DMMA": 40, "HMMA": 1})
    assert rp.sass_problems(("fwd_dot", "float64", 5, 8), {**zero, "DMMA": 8})
    for S, C in ((5, 8), (6, 32)):
        f64 = {b: rp.expected_sass(b, "float64", S, C) for b in rp.BODIES}
        jobs64 = (C // 8) * 4
        pairs, odd = S // 2, S % 2  # m16n8k8 2048 flops, m8n8k4 512
        assert f64["fwd_dot"]["DMMA"] == 4 * (pairs + 2 * odd)
        assert jobs64 * 4 * (pairs * 2048 + odd * 2 * 512) == rp.work(
            "fwd_dot", C, S, 1)
        assert 8 * f64["gram_dot"]["DMMA"] * 2048 == rp.work("gram_dot", C, S,
                                                               1)
        assert 256 * f64["vpu_fma"]["DFMA"] * 2 == rp.work("vpu_fma", C, S, 1)
        # float32: the most FFMA a body may hold is one rep's
        jobs32 = (C // 8) * 2
        most = rp.expected_sass("fwd_dot", "float32", S, C)["FFMA"][1]
        assert jobs32 * 32 * most * 2 == rp.work("fwd_dot", C, S, 1)
        most = rp.expected_sass("gram_dot", "float32", S, C)["FFMA"][1]
        assert 8 * 32 * most * 2 == rp.work("gram_dot", C, S, 1)


def test_sass_listing_parsed_per_instance():
    """build.parse_sass counts each op per instruction line of each matching
    function, and the probe names its instances by body, dtype, S and C;
    a function that does not match is not counted."""
    from tpinn_torch.kernels import build

    listing = "\n".join([
        "\tcode for sm_90a",
        "\t\tFunction : _Z10fwd_kernelIdLi5ELi8EEvPKT_S2_PS0_i",
        "        /*0100*/   DMMA.884 R4, R8, R10, R4 ;",
        "        /*0110*/   DMMA.884 R12, R8, R14, R12 ;",
        "        /*0120*/   DFMA R2, R4, R6, R2 ;",
        "\t\tFunction : _Z11elem_kernelIfLi6ELi16ELb1EEvPKT_S2_PS0_i",
        "        /*0100*/   FFMA R2, R4, R6, R2 ;",
        "\t\tFunction : _Z12other_kernelPd",
        "        /*0100*/   DMMA.884 R4, R8, R10, R4 ;",
        "\t\tFunction : _Z11elem_kernelIdLi5ELi8ELb0EEvPKT_S2_PS0_i",
        "        /*0100*/   DFMA R2, R4, R6, R2 ;",
        "        /*0110*/   HMMA.1688.F32.TF32 R2, R4, R6, R2 ;",
    ])
    got = build.parse_sass(listing, rp._KERNEL_RE, rp._SASS_OPS)
    named = {rp._sass_key(*k): v for k, v in got.items()}
    assert named == {
        ("fwd_dot", "float64", 5, 8): {"DMMA": 2, "HMMA": 0, "DFMA": 1,
                                       "FFMA": 0},
        ("tanh_elems", "float32", 6, 16): {"DMMA": 0, "HMMA": 0, "DFMA": 0,
                                           "FFMA": 1},
        ("vpu_fma", "float64", 5, 8): {"DMMA": 0, "HMMA": 1, "DFMA": 1,
                                       "FFMA": 0}}
