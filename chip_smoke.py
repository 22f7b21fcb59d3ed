#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpinn_torch) once on one CUDA card.

    python3 chip_smoke.py [--out results.json]

Phases, each printing its seconds; any failed check raises and the script
exits non-zero:

1. device and build: the card's name and power limit, the nvcc build of
   tpinn_torch/kernels/csrc into .cache/tpinn_torch (seconds and the ptxas
   report), TF32 switched off;
2. kernel 1 (ns_residual_bwd) against its plain PyTorch version in float64:
   widths 2-32-32-32-3 at n = 1000, n = 4099 masked to n_valid = 4000, and
   the unsteady layout (d_in = 3); loss and MSEs at rtol 1e-11, dW/db at
   rtol 1e-9 / atol 1e-12; two calls at the same parameters bit-identical;
   the float32 instantiation's error against float64;
3. kernel 2 (ns_residual_fwd) against its plain version at the same bars,
   its MSEs against kernel 1's, and ns_residual_mse's gradient (kernel 2
   forward, kernel 1 backward) against autograd;
4. the slice: the Poiseuille Adam round (100 epochs, float64, 2-32-32-32-3,
   the reference options) through tpinn_torch.cases.poiseuille_flow.main,
   with the launch counts read around it, held against the same round run
   through the plain versions on the CPU;
5. times of the NS kernels and their plain versions at 1,000, 262,144 and
   1,048,576 points, and of the Poisson kernels at 200, 262,144 and
   1,048,576 points, in float32 and float64 (CUDA events around 20
   back-to-back calls at the small size and around single calls above,
   median of 10 such runs);
6. kernel 3 (poisson_residual_bwd) against its plain version in float64:
   widths 2-20-20-20-1 at n = 200, n = 4099 masked to n_valid = 4000, and
   normalization 3; loss and MSE at rtol 1e-11, dW/db at rtol 1e-9 /
   atol 1e-12; repeat calls bit-identical; the float32 error against
   float64;
7. kernel 4 (poisson_residual_fwd) at the same bars, its MSE bit-identical
   to kernel 3's, and poisson_residual_mse's gradient (kernel 4 forward,
   kernel 3 backward) against autograd;
8. the slice: both Poisson cases through tpinn_torch.cases.poisson.main
   (Adam 100 epochs, L-BFGS-B 100 iterations) and poisson_misto.main (Adam
   100, L-BFGS-B 50), float64, each with the launch counts read around it
   and held against the same case run through the plain versions on the
   CPU: the Adam round at 1e-8, the L-BFGS-B round's first 20 iterations at
   1e-8 and its final global loss at 5 % (L-BFGS-B amplifies rounding about
   tenfold per ten iterations, so later log points follow another
   trajectory; PERF.md section 2); the cost of one scipy function
   evaluation and of its two host/device copies;
9. kernel 5 (taylor_bundle, the per-point value, Jacobian and Hessian
   diagonal) against its plain version in float64: 2-32-32-32-3 at n =
   1000, 100, 33 and 3000 (the coronary LM route's outflow and PDE
   batches) and 4099 (not a tile multiple), d_in = 3 (seven streams),
   2-20-20-20-1 (a scalar head), 3-20-20-20-3 with dim 1, 2 and 3 at a
   ragged n, widths 64 (3-64-64-3, 2-64-64-64-1), one-layer nets, and an
   8-layer width-64 net whose weights are streamed layer by layer; max
   |Δ| ≤ 1e-12·max|ref| per output; repeat calls bit-identical; the launch
   plan (points per tile, streaming, shared bytes) equal to its Python
   mirror (`mlp_bundle.bundle_plan`); the float32 instantiation's error
   against float64 (at most 1e-5 of max|ref|); back-to-back calls at two
   batch sizes, each bit-equal to the first at its size; the DMMA count of
   each float64 instance and no HMMA (TF32) in any, from `cuobjdump -sass`;
10. times of kernel 5 and its plain version at 33, 100, 1,000, 3,000,
   262,144 and 1,048,576 points, float32 and float64, as in phase 5, with
   the plan's tile and grid;
11. the slice: the Poiseuille Levenberg–Marquardt round (10 iterations
   after a 0-epoch Adam round, float64, the reference options) through
   tpinn_torch.cases.poiseuille_flow.main with TPINN_USE_PALLAS=1, the
   launch counts read around it (kernel 5 launches, kernels 1-4 do not),
   held against the same round through the plain versions on the CPU and
   against the round on the card with the opt-in off (kernel 5 then does
   not launch), all at the history bar 1e-8; the LM iteration's time split
   into residual evaluation, fast Gram, the JᵀJ download, the host eigh and
   the accept loop;
12. kernels 1-4 against their plain versions in float64 at widths that the
   tile layout pads (2-7-7-3, 2-24-24-3, 2-64-64-3, 3-16-16-3, 2-7-7-1,
   2-20-20-20-1, 2-64-64-1), d_in = 3, ragged last tiles and masked tails
   (n_valid < n), at the bars of phases 2 and 6; repeats bit-identical;
   kernel 2's / 4's MSEs bit-equal to kernel 1's / 3's; the launch plan
   (points per tile, shared bytes) equal to its Python mirror;
13. back-to-back calls of kernels 1 and 3 at two batch sizes (two grids) on
   one stream, each result bit-equal to the first call at its size: every
   launch's last block resets the ticket;
14. the device time per launch of kernels 1-5 under torch.profiler beside
   the event-timed call time, the device kernels one call launches (1 for
   each), at the main shapes and at 1,048,576 points (kernel 5 also at 33
   and 3,000);
15. the slice: the Poiseuille main path, Adam 100 epochs then the dense
   BFGS round ("jax-bfgs", 40 iterations), float64, through
   tpinn_torch.cases.poiseuille_flow.main, with the launch counts read
   around it (one kernel-1 launch per value and gradient, one kernel-2
   launch per logged evaluation), the plain variant, held against the same
   run on the CPU (every log through BFGS iteration 20 at 1e-8, the final
   global loss at 5 %); a repeat of the BFGS round from the same state
   bit-identical, with the host synchronisations it issues counted (torch's
   sync debug mode); the iteration split (direction, evaluations, H update)
   from a timed repeat, also bit-identical; the host scipy BFGS round
   ("scipy-parity", 20 iterations) per iteration beside it; a float32 round
   of 20 iterations, finite and descending, against float64;
16. the paired variant (TPINN_USE_PALLAS=0, every loss a residual vector),
   20 BFGS iterations on the card against the CPU at 1e-8;
17. the Poisson case's "jax-bfgs" round (Adam 100 + BFGS 20, kernels 3/4,
   one kernel-3 launch per evaluation) against the CPU at 1e-8;
18. the artifacts and an exact resume on the card: 20 BFGS iterations
   straight against 10, the run folder written (Model.json, the weights as
   Weights.npz where h5py is missing, History_Loss.json, checkpoint.pkl,
   Test_Options.txt), and 10 more in a new driver resuming it, every log
   bit-identical; ``checkpoint.load_experiment`` reproduces the model's
   outputs bit for bit;
19. the slice: the Poiseuille main path with the on-device L-BFGS round,
   Adam 100 epochs then L-BFGS ("jax", 100 iterations), float64, through
   tpinn_torch.cases.poiseuille_flow.main, with the launch counts read
   around it (one kernel-1 launch per line-search trial plus one for the
   first iteration, one kernel-2 launch per logged evaluation), held
   against the same run on the CPU (every log through L-BFGS iteration 20
   at 1e-8, the final global loss at 5 %); a repeat from the same state
   bit-identical, with its host synchronisations counted; the iteration
   split (direction, that is the two-loop recursion, and the line search's
   evaluations) from a timed repeat, also bit-identical; the ms per
   iteration beside phase 15's dense BFGS;
20. the slice at full width: colliding flow at its reference options
   (1000 PDE points, 100 per edge, 5 velocity and 1 pressure fitting
   points, 10,000 test points, 2-32-32-32-3, float64, NS kernels at
   convection 1/40) through tpinn_torch.cases.colliding_flow.main: Adam
   100 then the default "scipy" round (the dense BFGS, 20 iterations), on
   the card against the CPU (the history at 1e-8, the final global loss at
   5 %), with the launch counts read around it and the run folder written;
   then the Poisson case's L-BFGS branch (Adam 100 + L-BFGS 20, kernels
   3/4, one kernel-3 launch per evaluation) against the CPU at 1e-8;
21. the cosine-decay Adam second round ("adam", 100 epochs) on Poiseuille,
   card against CPU at 1e-8.
22. the unsteady slice at full width: Cavity_Unsteady at its reference
   options (10,000 PDE, 1,000 boundary and 1,000 initial points, 50
   velocity-fitting points, 1,000 test points, 5 % noise; 3-32-32-32-3,
   float64; the 100 × 101 × 101 space-time grid) through
   tpinn_torch.cases.cavity_unsteady.main: the exact data from the port's
   cavity oracle on the card (n = 100, 500 projection steps; its seconds,
   CG iterations and host synchronisations printed; writing the
   regular-grid csv is timed apart), then Adam 100 and the
   default "scipy" round (the dense BFGS, 20 iterations) through kernels
   1/2 at d_in = 3, held against the same run on the CPU fed the card's
   oracle arrays (the Adam logs and every log to BFGS iteration 20 at 1e-8,
   the final global loss at 5 %), one kernel-1 launch per value and
   gradient, the ms per Adam epoch and per BFGS iteration, the run folder;
23. the cavity oracle on the card against the CPU at n = 32 over 20 output
   steps: every field within 1e-9·max|field|, the same CG iterations;
24. the roofline probe (tpinn_torch/kernels/roofline_probe.py): its five
   bodies against their plain versions (float64 within 1e-12·max|ref|,
   float32 within 1e-5, S 5 and 6, C 8, 16 and 32, repeats bit-identical),
   their SASS (one rep's DMMA / DFMA / FFMA per instance, no HMMA), then
   each body's rate in float64 and float32 at the residual tile (C = 8)
   beside the same reps as PyTorch calls, no rate above the data sheet's
   peak, the plain versions' time, and the attainable bound of kernels 1-5
   at their main shapes from the probe's float64 rates;
25. the steady cavity oracle on the card through
   tpinn_torch.oracles.generate.generate_cavity_steady at the case's
   n_solver 128 and U 500, its march (13,150 projection steps to t_end 40)
   cut to 4 blocks of 50 steps (t_end 0.5): its seconds, CG iterations per
   step, host reads and the extrapolated seconds of the full march, the
   files written; then card against CPU at n_solver 32 over one block of
   50 steps (the fields and both csv files within 1e-9·max, the same CG
   iterations);
26. the steady slice at full width: Cavity_Steady at its reference options
   (1,000 PDE and 1,000 boundary points, 100 velocity and 1 pressure
   fitting points, 1,000 test points, 1 % noise; 2-32-32-32-3, float64) on
   phase 25's data through tpinn_torch.cases.cavity_steady.main: Adam 100
   then the default "scipy" round (the dense BFGS, 20 iterations) through
   kernels 1/2, held against the same run on the CPU (the Adam logs and
   every log to BFGS iteration 20 at 1e-8, the final global loss at 5 %),
   one kernel-1 launch per value and gradient, the ms per Adam epoch and
   per BFGS iteration, the run folder, and a ``load_from`` reload giving
   the same test losses;
27. the two old-style cavity scripts on the tape path (no residual kernel
   launches): tpinn_torch.cases.cavity_steady_csv at its own sizes with
   ``press_mode`` Mean and the save / load round trip (bit-identical
   outputs), and tpinn_torch.cases.cavity_unsteady_old at its defaults on
   phase 22's series (the regular-grid csv derived from it, timed), each
   Adam 100 then the host scipy BFGS cut to 10 iterations, card against
   CPU at phase 26's bars;
28. the coronary oracle on the card's host: the mesh and boundary points
   the package carries (their SHA-256 held to the port's constants, 10,833
   nodes and 20,864 triangles), the P1-FEM steady solve through
   tpinn_torch.oracles.coronary.generate_coronary into a temporary dir
   (npz where h5py is missing), its seconds and Picard solves, the fields'
   max |.| and L2 norms within 1e-9 of the committed fields' (constants in
   the port);
29. the coronary slice at full width: examples/Coronary_Flow's reference
   options (3,000 PDE, 50 velocity-fitting and 2,000 test points, 1 % fit
   noise; 2-32-32-32-3, float64; 13 training losses on the mesh's nodes
   and labeled boundary points) on phase 28's data through
   tpinn_torch.cases.coronary_flow_steady.main: Adam 100 then the default
   "scipy" round (the dense BFGS, 20 iterations) on the closed-form
   bundles (kernels 1-5 launch 0 times, as in the example), held against
   the same run on the CPU (the Adam logs and every log to BFGS iteration
   20 at 1e-8, the final global loss at 5 %), the ms per Adam epoch and
   per BFGS iteration, the run folder (weights, history, ``sol_pinn``,
   recap);
30. the LM routes: phase 29's run resumed (``resume_from``) with the LM
   round for 5 iterations under TPINN_USE_PALLAS=1 on the card, with the
   launch counts read around it (kernel 5 three times, for the PDE batch
   of 3,000 and the two outflows of 33 points, per evaluation of the
   training losses; kernels 1-4 not at all), held against the same resume
   on the CPU and on the card with the opt-in off (kernel 5 then does not
   launch) at 1e-8 over every log, each with its LM iteration split
   (residuals, Gram, download, eigh, accept); then the Poisson case's LM
   route (Adam 100 + LM 10, the tape PDE loss, no kernel) card against CPU
   at 1e-8; phases 11 and 30 take the host eigh (TPINN_LM_SOLVER=host);
31. the device damping ladder at full width: phase 30's coronary resume
   (LM 5, TPINN_USE_PALLAS=1) on the card's default solver, which is the
   ladder, with kernel 5 three times per evaluation of the training
   losses (the ladder's candidates included), held against the ladder
   forced on the CPU at 1e-8 over every log and against phase 30's host
   eigh (the loss falls, the final loss within 5 %); its iteration split
   (residuals, Gram, power iteration, and per rung the Cholesky, solve and
   candidate evaluation), rungs per iteration and ms per iteration beside
   the host eigh's; phase 11's Poiseuille LM 10 on the ladder against its
   host eigh at rtol 1e-3 (tpinn's own bar);
32. LM resume on the card: Poiseuille LM 3, then its run folder resumed
   by LM 2, equal to LM 5 straight bit for bit (the carry θ and the last
   logs), on the host eigh and on the ladder;
33. LM's chunked Jacobian: the Poisson case (Adam 100 + LM 10) with every
   point residual stripped, against the same run on the fast Gram: JᵀJ
   and Jᵀr at the LM round's θ0 within 1e-10 of the largest entry, every
   log within 1e-8, and ms per LM iteration of both;
34. the float32 split carries: Poiseuille at the reference options in
   float32 with TPINN_USE_PALLAS=0 (residual losses): Adam 100, dense
   BFGS 20 (``bfgs_split``) and LM 5 (the split carry) on the card against
   the CPU over every log: Adam and BFGS at 1e-4, LM at 1e-2 (the two
   float32 Grams' rounding, amplified by the damped solve), also the LM
   round on the card from the CPU's BFGS result; the witnesses of that
   gap, each an LM 5 from the CPU's BFGS result: the card's loop fed the
   CPU's JᵀJ at 1e-3, and both sides with JᵀJ promoted to float64 before
   the eigh (recorded); the lo channel nonzero after each round, ms per
   BFGS and LM iteration;
35. the generic operators: ``vtaylor_bundle`` of a 2-32-32-32-3 tanh net
   at 1,000 points against ``mlp_taylor_batched`` at 1e-12 of the largest
   value, then a 2-32-32-32-3 sin net on Poiseuille's reference points
   through the generic ``ResidualBundle`` (the Poiseuille driver's model
   replaced and its losses built anew; Adam 100 + LM 5, the ladder forced
   on both sides) card against CPU at 1e-8;
36. the sharded slice: Poiseuille at its reference options on a point mesh
   of 3 ranks (processes, gloo, all on the one card; no batch divides 3;
   where the host has several cards, one rank per card over NCCL instead),
   through ``tpinn_torch.sharding`` and the driver's ``mesh``: (a) Adam
   100 + the default "scipy" dense BFGS 20, kernels 1/2 on every rank's
   shard; (b) Adam 100 + L-BFGS 20; (c) LM 5 on the device ladder under
   TPINN_USE_PALLAS=1, kernel 5 on every rank's shard, the fast Gram; each
   held against the same run unsharded on the card in this process
   (every log at 1e-8), θ byte-identical on every rank after every round,
   the kernels' launches per rank read around each round; the sharded
   objectives on the card (1,000 rows, and 2 rows that leave one rank
   padding alone) against the unsharded kernels; kernels 1/2 over no
   valid row (zeros, no launch); (a) again on 1 rank over NCCL; the ms per
   Adam epoch and per second-round iteration of each (ranks sharing one
   card: not a scaling measurement);
37. the recipe runner (``tpinn_torch.recipes.run_case``) on cut-down
   recipes, each stage a process on the card (the runner's default
   device): Poisson Adam 100 + LM 3; Poiseuille Adam 10 + cosine Adam 10
   -> dense BFGS 3 -> LM 2 x 2, every stage resuming stage 1's run folder
   (every exit code 0, one run folder, the history's rounds running on
   with no gap); the same Poiseuille recipe with targets stage 1 meets
   stops there; each chained history held against the same stages called
   in this process on the card (bit for bit expected, 1e-8 over every log
   failing) and on the CPU (the LM stages on the device ladder forced
   there; every log at 1e-8, the final loss at 5 %); the in-process
   chains' kernel launches (kernels 1/2 in Poiseuille's Adam and BFGS
   stages, none in Poisson's LM route); one checkpoint of the dense BFGS
   carry (2,307 parameters) timed, as the callbacks write it every 100
   iterations.

The line before the last is the kernels' JSON record (each kernel's
launches on every path that runs it, ``launches`` being its slice's main
path (kernel 5: phase 30's coronary LM round, with its times at that
route's shapes under ``by_n``), and ``bound_probe_ms`` its attainable bound
from phase 24; the probe's
bodies with the launches of phase 24's rate runs), the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): float64 through the tensor cores
# 67 TFLOP/s, float32 outside the tensor cores 67 TFLOP/s, HBM3 3.35 TB/s.
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
WIDTHS = (32, 32, 32)
SIZES = (1000, 262_144, 1_048_576)
POISSON_WIDTHS = (2, 20, 20, 20, 1)
POISSON_SIZES = (200, 262_144, 1_048_576)
REPS = 10
# L-BFGS-B rounds: the history of the first 20 iterations at the Adam bar;
# after that the two runs follow different trajectories (L-BFGS-B amplifies
# rounding about tenfold per ten iterations), so the whole round is held by
# its final global loss (PERF.md section 2)
SCIPY_HEAD_ITERS = 20
FINAL_LOSS_BAR = 0.05
# kernel 5 at the coronary LM route's shapes too: n = 33 (each outflow) and
# 3,000 (the PDE batch)
BUNDLE_SIZES = (33, 100, 1000, 3000, 262_144, 1_048_576)
LM_ITERS = 10
HISTORY_BAR = 1e-8
# the dense BFGS round (phase 15): 40 iterations on the card and the CPU, the
# history held at the bar over iterations 0-20 and by its final global loss
# after that (quasi-Newton rounds amplify rounding, PERF.md section 2)
BFGS_ITERS = 40
BFGS_HEAD_ITERS = 20
SCIPY_BFGS_ITERS = 20
F32_BFGS_ITERS = 20
PAIRED_ITERS = 20
RESUME_ITERS = 20
# the L-BFGS round (phase 19): 100 iterations, held like phase 15's round
LBFGS_ITERS = 100
LBFGS_HEAD_ITERS = 20
# colliding flow's dense BFGS round and Poisson's L-BFGS round (phase 20)
COLLIDING_ITERS = 20
POISSON_LBFGS_ITERS = 20
# the cosine-decay Adam second round (phase 21)
COSINE_EPOCHS = 100
# Cavity_Unsteady's default "scipy" round (phase 22), held like phase 20's
CAVITY_ITERS = 20
# the cavity oracle card against CPU (phase 23): max |Δ| / max|field|
ORACLE_BAR = 1e-9
# the roofline probe (phase 24): reps of the comparison with the plain
# versions (few enough that float32 chains stay normal), then the rates
PROBE_CHECK_REPS = 8
PROBE_REPS = 96
PROBE_OUTER = 10
# the steady oracle (phase 25): examples/Cavity_Steady's march (n_solver
# 128, t_end 40, 13,150 projection steps) cut to 4 blocks of 50 steps
STEADY_T_END = 0.5
# Cavity_Steady's default "scipy" round (phase 26), held like phase 20's
STEADY_ITERS = 20
# the old-style cavity scripts' second round (phase 27)
OLD_ITERS = 10
# the coronary default route's dense BFGS round (phase 29), held like
# phase 20's; the LM resume of its run and the Poisson LM round (phase 30)
CORONARY_ITERS = 20
CORONARY_LM_ITERS = 5
POISSON_LM_ITERS = 10
# the device ladder against the host eigh on Poiseuille (phase 31): tpinn's
# own bar (tests/test_lm_fast_gram.py)
LADDER_BAR = 1e-3
# the float32 split carries (phase 34): dense BFGS, then LM, card vs CPU
# over every log
SPLIT_BFGS_ITERS = 20
SPLIT_LM_ITERS = 5
SPLIT_BAR = 1e-4
# float32 LM, card vs CPU: the two float32 Grams differ by 2.7e-6 to
# 7.5e-6 of JᵀJ's largest entry (two summation orders), and the damped
# solve amplifies that by about 1/μ: measured 5.71e-3 from one starting
# point and 5.77e-3 chained after the BFGS round, the same in every run;
# JᵀJ promoted to float64 before the eigh still 5.26e-3 (the eigh is not
# the cause); the card's loop fed the CPU's JᵀJ 3.10e-4, Jᵀr's rounding
# amplified alike (phase 34, PERF.md section 5)
SPLIT_LM_BAR = 1e-2
SPLIT_LM_FED_BAR = 1e-3
# the sin net's LM round on the generic bundles (phase 35)
GENERIC_LM_ITERS = 5
# the sharded slice (phase 36): ranks sharing the card, the rounds' lengths
SHARD_RANKS = 3
SHARD_ADAM = 100
SHARD_ITERS = 20
SHARD_LM_ITERS = 5
# the recipe runner (phase 37): writes of the dense BFGS checkpoint timed
CHECKPOINT_WRITES = 5


def phase(name):
    """Context manager printing a phase's seconds."""

    class _P:
        def __enter__(self):
            print(f"== {name}", flush=True)
            self.t0 = time.perf_counter()

        def __exit__(self, *exc):
            if exc[0] is None:
                print(f"== {name}: {time.perf_counter() - self.t0:.2f} s",
                      flush=True)

    return _P()


def ns_work_split(widths, d_in, bwd):
    """Floating-point operations one point needs in the NS-residual
    kernels, by the unit that does the work: "dot" the per-stream layer
    products and, for the backward, the back-propagation of the stream
    cotangents; "gram" the dW contractions; "tanh" one per hidden neuron;
    "fma" the rest: the tanh stream algebra, the residual rows and the
    cotangent algebra."""
    S = 1 + d_in + 2
    L = len(widths) - 1
    w = {"dot": 0, "gram": 0, "tanh": 0, "fma": 0}
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        w["dot"] += 2 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo
        if l < L - 1:  # tanh; tanh', a, g streams, h streams
            w["tanh"] += wo
            w["fma"] += wo * (2 + 2 + d_in + 2 * (3 if l == 0 else 5))
    w["fma"] += 2 * 14 + 6  # residual rows and squares
    if not bwd:
        return w
    w["fma"] += 30  # residual cotangents
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l < L - 1:
            w["fma"] += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                              + d_in + 2 * 3 + 2)
        w["gram"] += 3 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo
        if l > 0:
            w["dot"] += 2 * S * wi * wo
    return w


def poisson_work_split(widths, bwd):
    """The same for the Poisson-residual kernels: the hidden layers carry
    all five streams (value, two gradient and two Hessian-diagonal streams);
    at the scalar head only the two Hessian-diagonal streams are needed,
    forward and backward (the other head cotangents are structural zeros),
    and the head bias gets no gradient."""
    d_in, S = 2, 5
    L = len(widths) - 1
    w = {"dot": 0, "gram": 0, "tanh": 0, "fma": 0}
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            w["dot"] += 2 * 2 * wi * wo
            continue
        w["dot"] += 2 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo + wo * (2 + 2 + d_in + 2 * (3 if l == 0 else 5))
        w["tanh"] += wo
    w["fma"] += 5  # r = (h_x + h_y + f)·scale, r², the sum
    if not bwd:
        return w
    w["fma"] += 3  # c = ḡ·(2/n)·r·scale
    for l in range(L - 1, -1, -1):
        wi, wo = widths[l], widths[l + 1]
        if l == L - 1:
            w["gram"] += 2 * 2 * wi * wo
            if l > 0:
                w["dot"] += 2 * 2 * wi * wo
            continue
        w["fma"] += wo * (6 + 1 + 3 * d_in + 2 * (7 if l > 0 else 5)
                          + d_in + 2 * 3 + 2) + wo
        w["gram"] += 3 * wi * wo if l == 0 else 2 * S * wi * wo
        if l > 0:
            w["dot"] += 2 * S * wi * wo
    return w


def bundle_work_split(widths, dim):
    """The same for kernel 5: layer 0 forms the value stream only (its
    tangent streams are rows of W0, its second-order streams zero); every
    later layer multiplies all 1 + 2·dim streams; per hidden neuron tanh,
    tanh' (2), a = −2·v·tanh' (2), dim tangent products and per
    second-order stream a·z_g·z_g + tanh'·z_h (4, 2 at layer 0 where z_h
    is zero)."""
    S = 1 + 2 * dim
    L = len(widths) - 1
    w = {"dot": 0, "gram": 0, "tanh": 0, "fma": 0}
    for l in range(L):
        wi, wo = widths[l], widths[l + 1]
        w["dot"] += 2 * wi * wo if l == 0 else 2 * S * wi * wo
        w["fma"] += wo
        if l < L - 1:
            w["tanh"] += wo
            w["fma"] += wo * (2 + 2 + dim + dim * (2 if l == 0 else 4))
    return w


def ns_flops_per_point(widths, d_in, bwd):
    return sum(ns_work_split(widths, d_in, bwd).values())


def poisson_flops_per_point(widths, bwd):
    return sum(poisson_work_split(widths, bwd).values())


def bundle_flops_per_point(widths, dim):
    return sum(bundle_work_split(widths, dim).values())


def sass_counts(lib_path):
    """{kernel-5 instance: {"DMMA": n, "HMMA": n}} from ``cuobjdump -sass``
    of the built library (instances named by their template arguments:
    Id / If for float64 / float32, then d_in and dim); None where the
    toolkit has no cuobjdump."""
    from tpinn_torch.kernels import build

    counts = build.sass_op_counts(
        lib_path, r"Function : \S*taylor_bundle_kernelI(\w)Li(\d)ELi(\d)E",
        ("DMMA", "HMMA"))
    return None if counts is None else {
        f"I{t} d_in {d_in} dim {dim}": v for (t, d_in, dim), v in counts.items()}


def bundle_problem(widths, n, seed, dtype, device):
    """Seeded params of the given widths and points in (-1, 1)^d_in."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = random_params(rng, widths, dtype, device)
    x = torch.tensor(rng.uniform(-1.0, 1.0, (n, widths[0])), dtype=dtype,
                     device=device)
    return params, x


def poisson_problem(n, seed, dtype, device, widths=POISSON_WIDTHS):
    """Seeded params (2-20-20-20-1 by default), points in (0, 2π)² and the
    forcing."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    params = random_params(rng, widths, dtype, device)
    x = torch.tensor(rng.uniform(0.0, 2 * np.pi, (n, 2)), dtype=dtype,
                     device=device)
    f = 2.0 * torch.sin(x[:, 0]) * torch.sin(x[:, 1])
    return params, x, f


def bound(n_ops, n_bytes, dname):
    """(bound ms, what bounds it) from the operations and bytes of a call."""
    t_ops = 1e3 * n_ops / PEAK_FLOPS[dname]
    t_bytes = 1e3 * n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def rel_dev(h_ref, h, sel):
    """Largest relative deviation of every logged value of two histories
    at the log-point indices ``sel``."""
    import numpy as np

    series = [(h_ref.loss_global, h.loss_global)]
    for group in ("losses", "losses_test"):
        ref, got = getattr(h_ref, group), getattr(h, group)
        series += [(ref[k]["log"], got[k]["log"]) for k in ref]
    return max(float(np.max(np.abs(np.array(b)[sel] - np.array(a)[sel])
                            / np.abs(np.array(a)[sel]))) for a, b in series)


def leaves_of(params):
    """Fresh leaf copies of params that require grad, and their flat list."""
    fl = [p.clone().requires_grad_(True) for p in flat(params)]
    return [{"kernel": fl[i], "bias": fl[i + 1]}
            for i in range(0, len(fl), 2)], fl


def random_params(rng, widths, dtype, device):
    import torch

    params = []
    for wi, wo in zip(widths[:-1], widths[1:]):
        lim = (6.0 / (wi + wo)) ** 0.5
        params.append({
            "kernel": torch.tensor(rng.uniform(-lim, lim, (wi, wo)),
                                   dtype=dtype, device=device),
            "bias": torch.tensor(rng.uniform(-0.1, 0.1, wo), dtype=dtype,
                                 device=device),
        })
    return params


def problem(d_in, n, seed, dtype, device, hidden=WIDTHS):
    """A seeded batch, params and physics: the Poiseuille coefficients and
    normalization for the steady layout, unit coefficients unsteady."""
    import numpy as np
    import torch

    from tpinn_torch.geometry import Normalization
    from tpinn_torch.oracles import analytic
    from tpinn_torch.pipeline import NSPhysics

    rng = np.random.default_rng(seed)
    widths = (d_in,) + tuple(hidden) + (3,)
    params = random_params(rng, widths, dtype, device)
    if d_in == 2:
        x = rng.uniform(0.0, 1.0, (n, 2)) * np.array([1.0, 0.1])
        prm = analytic.PoiseuilleParams()
        g = torch.tensor(x)
        norm = Normalization(analytic.poiseuille_u(g, prm),
                             analytic.poiseuille_v(g, prm),
                             analytic.poiseuille_p(g, prm))
        physics = NSPhysics(conv=prm.rho, visc=prm.mu)
    else:
        x = rng.uniform(0.0, 1.0, (n, 3))
        norm = Normalization(np.array([0.0, 1.0]), np.array([0.0, 1.0]),
                             np.array([-2.0, 2.0]))
        physics = NSPhysics(conv=1.0, visc=1.0, time=1.0)
    return params, torch.tensor(x, dtype=dtype, device=device), physics, norm


def flat(params):
    return [t for p in params for t in (p["kernel"], p["bias"])]


def rel(a, b):
    import torch

    return float(torch.max(torch.abs(a - b) / torch.abs(b)))


def check_close(name, got, ref, rtol, atol=0.0):
    """Raise unless |got − ref| <= atol + rtol·|ref| everywhere; return the
    largest absolute error."""
    import torch

    err = torch.abs(got - ref)
    over = float(torch.max(err - (atol + rtol * torch.abs(ref))))
    max_abs = float(torch.max(err))
    if over > 0.0 or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max abs err {max_abs:.3e} exceeds "
                             f"rtol {rtol} / atol {atol}")
    return max_abs


def cuda_ms(fn, inner, reps=REPS, warmup=2):
    """Milliseconds per call of ``fn``: the median over ``reps`` runs, each
    ``inner`` back-to-back calls between two CUDA events, after ``warmup``
    calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def device_profile(fn, calls=20):
    """(device ms per launch, device kernels per call, kernel names) of
    ``fn`` under torch.profiler (CUDA activity, after a warm-up call), as
    tpinn_torch/profiling.py reads a trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then drops kernel records
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if len(ks) >= calls:
            break
    if not ks:
        raise AssertionError("the profiler saw no device kernel")
    return (sum(e.time_range.elapsed_us() for e in ks) / len(ks) / 1e3,
            len(ks) / calls, sorted({e.name[:80] for e in ks}))


def host_ms(fn, reps=50, warmup=3):
    """Milliseconds per call of ``fn`` on the host clock, the median over
    ``reps`` calls, each ended by a device synchronisation."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times.sort()
    return times[len(times) // 2]


def sharded_phase(work_dir, dev):
    """Phase 36: the sharded slice on a point mesh of ranks against the
    same runs in one process: SHARD_RANKS ranks sharing the one device
    over gloo (NCCL refuses two ranks on one GPU), or, where the host has
    several cards, one rank per card over NCCL.  Returns (the kernels'
    launches summed over the ranks and the paths, the record)."""
    import numpy as np
    import torch

    from tpinn_torch import sharded_runs, sharding
    from tpinn_torch.history import History
    from tpinn_torch.kernels import mlp_bundle as mb

    f64 = torch.float64
    case = "tpinn_torch.cases.poiseuille_flow"
    drv = {"device": dev.type, "save_results": False, "seed": 0,
           "adam_epochs": SHARD_ADAM, "base_dir": work_dir}
    jobs = {
        "a": {"case": case, "driver": dict(drv, second_round="scipy"),
              "rounds": [["keras", SHARD_ADAM], ["scipy", SHARD_ITERS]]},
        "b": {"case": case, "driver": dict(drv, second_round="jax"),
              "rounds": [["keras", SHARD_ADAM], ["jax", SHARD_ITERS]]},
        "c": {"case": case, "driver": dict(drv, second_round="lm"),
              "rounds": [["keras", 0], ["lm", SHARD_LM_ITERS]],
              "env": {"TPINN_USE_PALLAS": "1"}},
    }
    # the sharded objectives on the card: the main path's batch and a batch
    # shorter than the mesh (the last rank holds padding alone)
    params, x, physics, norm = problem(2, 1000, 36, f64, dev)
    x2 = x[:2]
    cot = (0.3, 1.7, -0.4)
    jobs["objectives"] = {
        "kind": "objectives", "device": dev.type, "norm": norm,
        "physics": {"conv": physics.conv, "visc": physics.visc},
        "params": [{k: p[k].cpu().numpy() for k in ("kernel", "bias")}
                   for p in params],
        "batches": {"1000": (x.cpu().numpy(), 1000),
                    "2": (x2.cpu().numpy(), 2)},
        "weights": (10.0, 1.0, 1.0), "cotangent": cot}
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    n_ranks, backend = (cards, "nccl") if cards > 1 else (SHARD_RANKS, "gloo")
    out = {"ranks": n_ranks, "backend": backend}
    t0 = time.perf_counter()
    mb.reset_launch_counts()
    sharding.spawn(sharded_runs.run_jobs, n_ranks,
                   args=(list(jobs.values()), work_dir), backend=backend,
                   device=dev.type, timeout=60.0, threads=2, deadline=600.0)
    ranks = sharded_runs.load(work_dir, n_ranks)
    out["spawn_s"] = time.perf_counter() - t0
    if any(mb.LAUNCHES.values()):
        raise AssertionError("the parent launched a kernel while ranks ran")
    res = {name: [r[i] for r in ranks] for i, name in enumerate(jobs)}
    where = (f"one per card of {cards}" if cards > 1
             else f"sharing {dev}, not a scaling measurement")
    print(f"  {n_ranks} ranks ({backend}, {where}): "
          f"{out['spawn_s']:.2f} s, processes and builds included")

    # the sharded objectives against the unsharded kernels on the card
    for name, (xb, n_true) in (("1000", (x, 1000)), ("2", (x2, 2))):
        leaves, fl = leaves_of(params)
        loss, mses = mb.ns_residual_weighted_obj(leaves, xb, physics, norm,
                                                 (10.0, 1.0, 1.0))
        g = torch.autograd.grad(loss, fl)
        leaves, fl = leaves_of(params)
        m = mb.ns_residual_mse(leaves, xb, physics, norm)
        gm = torch.autograd.grad(
            torch.dot(m, torch.tensor(cot, dtype=f64, device=dev)), fl)
        got = [r[f"batch {name}"] for r in res["objectives"]]
        for r in got[1:]:
            same = all(np.array_equal(r[k], got[0][k])
                       for k in ("loss", "mses", "mse"))
            same &= all(np.array_equal(a, b) for a, b in zip(
                r["grads"] + r["mse_grads"],
                got[0]["grads"] + got[0]["mse_grads"]))
            if not same:
                raise AssertionError(f"sharded objective {name}: ranks differ")
        t = lambda a: torch.as_tensor(a, device=dev)
        e = max(check_close(f"sharded {name} loss", t(got[0]["loss"]),
                            loss.detach(), 1e-11),
                check_close(f"sharded {name} mses", t(got[0]["mses"]), mses,
                            1e-11),
                check_close(f"sharded {name} mse", t(got[0]["mse"]),
                            m.detach(), 1e-11))
        eg = max(check_close(f"sharded {name} grad", t(a), b, 1e-9, 1e-12)
                 for a, b in zip(got[0]["grads"] + got[0]["mse_grads"],
                                 list(g) + list(gm)))
        print(f"  sharded objectives at n = {name} (valid rows by rank "
              f"{[r['n_valid'] for r in got]}): loss / MSEs max abs "
              f"{e:.2e}, dW/db {eg:.2e}, the same bits on every rank")
        out[f"objectives_{name}"] = {"loss_err": e, "grad_err": eg}
    # kernels 1/2 over no valid row: zeros and no launch
    before = dict(mb.LAUNCHES)
    dp, m0, l0 = mb.ns_residual_bwd(params, x, physics, norm,
                                    torch.tensor((10.0, 1.0, 1.0), dtype=f64,
                                                 device=dev), 0, 1000,
                                    with_loss=True)
    m1 = mb.ns_residual_fwd(params, x, physics, norm, 0, 1000)
    if (mb.LAUNCHES != before or m0.any() or m1.any() or l0.any()
            or any(t_.any() for t_ in flat(dp))):
        raise AssertionError("kernels 1/2 over no valid row")
    print("  kernels 1/2 at n_valid = 0: zeros, no launch")

    # the runs against one process, unsharded, on the card
    totals = {k: 0 for k in mb.LAUNCHES}
    refs = {}
    for name in ("a", "b", "c"):
        got = res[name]
        if any(r["thetas"] != got[0]["thetas"] for r in got[1:]):
            raise AssertionError(f"({name}): θ differs across ranks")
        ref = refs[name] = sharded_runs.run_job(0, None, jobs[name])
        hs, hr = History.from_dict(got[0]["history"]), \
            History.from_dict(ref["history"])
        dev_all = rel_dev(hr, hs, list(range(len(hr.iters))))
        per_rank = [[{k: v for k, v in l.items() if v} for l in r["launches"]]
                    for r in got]
        ms = [[1e3 * s_ / max(n, 1) for s_, (_, n) in
               zip(r["seconds"], jobs[name]["rounds"])] for r in got]
        ms_ref = [1e3 * s_ / max(n, 1) for s_, (_, n) in
                  zip(ref["seconds"], jobs[name]["rounds"])]
        for r in got:
            for l in r["launches"]:
                for k, v in l.items():
                    totals[k] += v
        if name == "c":
            # the median LM iteration (each rank a cold process: the round's
            # wall above carries its first calls)
            lm_ms = [1e3 * float(np.median([sum(t_.values()) for t_ in
                                            r["lm_times"]]))
                     for r in got + [ref]]
            print(f"  (c) median ms per LM iteration by rank "
                  f"{[round(v, 2) for v in lm_ms[:-1]]} (one process "
                  f"{lm_ms[-1]:.2f})")
        print(f"  ({name}) {hs.round_names}: every log against one process "
              f"{dev_all:.2e}; θ the same bytes on every rank after each "
              f"round; launches by rank and round {per_rank}; ms per "
              f"epoch / iteration by rank ({where}) "
              f"{[[round(v, 2) for v in m_] for m_ in ms]}"
              f" (one process {[round(v, 2) for v in ms_ref]})")
        want = ({"taylor_bundle"} if name == "c"
                else {"ns_residual_bwd", "ns_residual_fwd"})
        launched = {k for r in got for l in r["launches"] for k, v in
                    l.items() if v}
        ok = (hs.iters == hr.iters and hs.round_names == hr.round_names
              and dev_all <= HISTORY_BAR and launched == want
              and all(r["launches"][-1][k] > 0 for r in got for k in want)
              and hs.loss_global[-1] < hs.loss_global[0])
        if name == "c":
            ok &= all(r["lm_used_fast_gram"] and r["lm_solver"] ==
                      "device_ladder" for r in got)
        if not ok:
            raise AssertionError(f"sharded run ({name}) failed its checks")
        out[name] = {"dev": dev_all, "ms_by_rank": ms, "ms_one_process": ms_ref,
                     "launches_by_rank": per_rank}
        if name == "c":
            out[name]["lm_median_ms"] = lm_ms

    # the main path on one rank over NCCL
    t0 = time.perf_counter()
    nccl_dir = os.path.join(work_dir, "nccl")
    os.makedirs(nccl_dir, exist_ok=True)
    sharding.spawn(sharded_runs.run_jobs, 1, args=([jobs["a"]], nccl_dir),
                   backend="nccl" if dev.type == "cuda" else "gloo",
                   device=dev.type, timeout=60.0, threads=2, deadline=300.0)
    one = sharded_runs.load(nccl_dir, 1)[0][0]
    hs = History.from_dict(one["history"])
    hr = History.from_dict(refs["a"]["history"])
    d1 = rel_dev(hr, hs, list(range(len(hr.iters))))
    ms1 = [1e3 * s_ / n for s_, (_, n) in zip(one["seconds"],
                                              jobs["a"]["rounds"])]
    print(f"  (a) on 1 rank over NCCL: every log against one process "
          f"{d1:.2e}; ms per epoch / iteration {[round(v, 2) for v in ms1]}; "
          f"{time.perf_counter() - t0:.2f} s with its process")
    if d1 > HISTORY_BAR or hs.iters != hr.iters:
        raise AssertionError("the NCCL rank disagrees")
    out["nccl"] = {"dev": d1, "ms": ms1}
    return totals, out


def recipes_phase(work_dir):
    """Phase 37: ``tpinn_torch.recipes.run_case`` on the cut-down recipes,
    each stage a process on the card (the runner's default device), the
    three chains in threads while the same stages run here on the card
    (bit for bit expected); then those stages on the CPU (the LM stages on
    the device ladder, the card's default solver, forced there once no
    stage process is left to inherit it); the cost of one checkpoint of
    the dense BFGS carry.  Returns (the kernels' launches in the card's
    in-process chains, the record)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from tpinn_torch import recipes
    from tpinn_torch.cases import poiseuille_flow, poisson
    from tpinn_torch.history import History
    from tpinn_torch.kernels import mlp_bundle as mb
    from tpinn_torch.utils import CheckpointCallback

    root = os.path.join(work_dir, "recipes")
    q = recipes.QUICK
    never, met_at_once = recipes.quick_specs(0.0), recipes.quick_specs(1e9)
    specs = {"poisson": never[0], "poiseuille": never[1],
             "early": met_at_once[1]}

    def chain(key):
        name = "poisson" if key == "poisson" else "poiseuille"
        log_dir = os.path.join(root, key)
        met = recipes.run_case(name, specs[key], log_dir=log_dir,
                               base_dir=os.path.join(root, key, "runs"))
        return met, recipes.read_summary(name, log_dir)

    # the same stages in this process, on the card and on the CPU
    def in_process(device, base):
        p_pb = poisson.main(q["poisson_lm"], out_dir=base,
                            second_round="lm", device=device)[0]
        p_launches = dict(mb.LAUNCHES)
        mb.reset_launch_counts()
        drv = poiseuille_flow.main(base, adam_epochs=q["adam"],
                                   second_round="adam", epochs=q["cosine"],
                                   device=device, seed=0)
        stages = [drv]
        for second_round, n in [("jax-bfgs", q["bfgs"])] + [
                ("lm", q["lm"])] * q["lm_repeat"]:
            stages.append(poiseuille_flow.main(
                base, second_round=second_round, epochs=n, device=device,
                seed=0, resume_from=stages[-1].folder))
        return p_pb, p_launches, stages, dict(mb.LAUNCHES)

    runs = {}
    with ThreadPoolExecutor(len(specs)) as pool:
        futures = {key: pool.submit(chain, key) for key in specs}
        mb.reset_launch_counts()
        runs["cuda"] = in_process("cuda", os.path.join(root, "cuda"))
        reports = {key: f.result() for key, f in futures.items()}
    os.environ["TPINN_LM_SOLVER"] = "device"
    try:
        mb.reset_launch_counts()
        runs["cpu"] = in_process("cpu", os.path.join(root, "cpu"))
    finally:
        os.environ.pop("TPINN_LM_SOLVER", None)
    for key, (met, report) in reports.items():
        if report["failed"]:
            with open(report["failed"]) as f:
                print(f.read()[-3000:])
            raise AssertionError(f"recipe stage failed: {report['failed']}")
        print(f"  {key}: met {met}, stages "
              + ", ".join(f"{s['tag']} {s['wall_s']:.2f} s"
                          for s in report["stages"]))
    (p_met, p_rep), (z_met, z_rep), (e_met, e_rep) = reports.values()
    folder = z_rep["folder"]
    tags = [s["tag"] for s in z_rep["stages"]]
    resumed = {s["args"][s["args"].index("--resume") + 1]
               for s in z_rep["stages"][1:]}
    rounds = [r["name"] for r in z_rep["history"]["rounds"]]
    if (p_met or z_met or not e_met or p_rep["stopped_at"]
            or [s["tag"] for s in p_rep["stages"]] != ["stage1_lm"]
            or tags != ["stage1_adam", "stage2_bfgs"] + [
                f"stage3_lm_r{r + 1}" for r in range(q["lm_repeat"])]
            or resumed != {folder}
            or os.listdir(os.path.dirname(folder)) != ["Test_Case_#001"]
            or not z_rep["history"]["runs_on"]
            or rounds != ["keras_Adam"] * 2 + ["jax_BFGS"]
            + ["jax_LM"] * q["lm_repeat"]
            or e_rep["stopped_at"] != "stage1_adam"
            or len(e_rep["stages"]) != 1):
        raise AssertionError(f"recipe runner: {tags}, {rounds}, {resumed}")
    chained = {"poisson": os.path.join(root, "poisson", "runs", "poisson",
                                       "Images", "Poisson_history_loss.json"),
               "poiseuille": os.path.join(folder, "History_Loss.json")}
    early = recipes.history_without_walls(
        os.path.join(e_rep["folder"], "History_Loss.json"))
    full = recipes.history_without_walls(chained["poiseuille"])
    n_early = len(early["log"]["iter"])
    if early["log"]["loss_global"] != full["log"]["loss_global"][:n_early]:
        raise AssertionError("the early-stopped stage 1 left the chain's")

    p_gpu, p_launches, z_gpu, z_launches = runs["cuda"]
    p_cpu, _, z_cpu, _ = runs["cpu"]
    refs = {"poisson": {"cuda": os.path.join(root, "cuda", "Images",
                                             "Poisson_history_loss.json"),
                        "cpu": os.path.join(root, "cpu", "Images",
                                            "Poisson_history_loss.json")},
            "poiseuille": {d: os.path.join(runs[d][2][-1].folder,
                                           "History_Loss.json")
                           for d in ("cuda", "cpu")}}
    same, devs = {}, {}
    for case, path in chained.items():
        same[case] = (recipes.history_without_walls(path)
                      == recipes.history_without_walls(refs[case]["cuda"]))
        h, h_cpu = History.load(path), History.load(refs[case]["cpu"])
        h_gpu = History.load(refs[case]["cuda"])
        every = list(range(len(h.iters)))
        devs[case] = {"card": rel_dev(h_gpu, h, every),
                      "cpu": rel_dev(h_cpu, h, every),
                      "cpu_final": abs(h.loss_global[-1]
                                       / h_cpu.loss_global[-1] - 1.0)}
        print(f"  {case}: chained history against this process's card run "
              f"bit-identical {same[case]} (every log "
              f"{devs[case]['card']:.2e}), against the CPU "
              f"{devs[case]['cpu']:.2e}, final loss "
              f"{devs[case]['cpu_final']:.2e} apart")
    bfgs = z_gpu[1].pb
    evaluations = bfgs.bfgs_counts["evaluations"]
    print(f"  launches in this process: Poisson {p_launches}; Poiseuille "
          f"{z_launches} (Adam {q['adam']} + cosine {q['cosine']} + "
          f"{evaluations} BFGS evaluations)")
    if (any(d["card"] > HISTORY_BAR or d["cpu"] > HISTORY_BAR
            or d["cpu_final"] > FINAL_LOSS_BAR for d in devs.values())
            or any(p_launches.values())
            or z_launches["ns_residual_bwd"]
            < q["adam"] + q["cosine"] + evaluations
            or z_launches["ns_residual_fwd"] < 1):
        raise AssertionError(f"recipe chains disagree: {devs}, launches "
                             f"{p_launches} {z_launches}")

    # one checkpoint of the dense BFGS carry, as the callbacks write it
    # every 100 iterations
    path = os.path.join(root, "checkpoint.pkl")
    callback = CheckpointCallback(path)
    writes = []
    for _ in range(CHECKPOINT_WRITES):
        t0 = time.perf_counter()
        callback(bfgs, 0, force=True)
        writes.append(time.perf_counter() - t0)
    ckpt_ms = 1e3 * float(np.median(writes))
    ckpt_mb = os.path.getsize(path) / 1e6
    n_params = sum(p[k].numel() for p in bfgs.model.params
                   for k in ("kernel", "bias"))
    print(f"  checkpoint of the dense BFGS carry ({n_params} parameters): "
          f"{ckpt_mb:.2f} MB, {ckpt_ms:.2f} ms per write (median of "
          f"{CHECKPOINT_WRITES}); 50 writes per 5,000 iterations "
          f"{50 * ckpt_ms / 1e3:.2f} s")
    launches = {k: p_launches.get(k, 0) + z_launches.get(k, 0)
                for k in mb.LAUNCHES}
    return launches, {
        "stages_s": {k: {s["tag"]: s["wall_s"] for s in r["stages"]}
                     for k, (_, r) in reports.items()},
        "bit_identical": same, "devs": devs, "launches": launches,
        "checkpoint_mb": ckpt_mb, "checkpoint_ms": ckpt_ms}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write every measured number as JSON here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from tpinn_torch.history import History
    from tpinn_torch.kernels import build
    from tpinn_torch.kernels import mlp_bundle as mb

    dev = torch.device("cuda", 0)
    # phases 1-10 run the default routing; phase 11 sets the opt-in itself,
    # and each LM phase its solver
    os.environ.pop("TPINN_USE_PALLAS", None)
    os.environ.pop("TPINN_LM_SOLVER", None)
    t_all = time.perf_counter()
    record = {}
    # data that later phases read again (phase 22's series, phase 25's
    # steady fields); removed at the end or when the process exits
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_")

    with phase("1 device and build"):
        smi = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(f"card: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        info = build.build()
        print(f"nvcc build: {info.seconds:.2f} s, all sources at once "
              f"({'compiled' if info.compiled else 'cached'}) -> "
              + ", ".join(os.path.relpath(p) for p in info.paths.values()))
        for source in build.SOURCES:
            build.library(source)
        for line in info.log.splitlines():
            if "Used" in line or "spill" in line:
                print("  ptxas:", line.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        record["card"] = smi
        record["build_s"] = info.seconds

    f64 = torch.float64
    w3 = (10.0, 1.0, 1.0)
    errs = {k: 0.0 for k in mb.LAUNCHES}

    with phase("2 kernel 1 (ns_residual_bwd) vs plain, float64"):
        cases = [("steady n=1000", 2, 1000, None),
                 ("masked n=4099 n_valid=4000", 2, 4099, 4000),
                 ("unsteady n=1000", 3, 1000, None)]
        for name, d_in, n, n_valid in cases:
            params, x, physics, norm = problem(d_in, n, 1 + d_in, f64, dev)
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            n_mean = n_valid or n
            dp, mses, loss = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                                n_valid, n_mean, with_loss=True)
            torch.cuda.synchronize()
            fl = [p.clone().requires_grad_(True) for p in flat(params)]
            pl = [{"kernel": fl[i], "bias": fl[i + 1]}
                  for i in range(0, len(fl), 2)]
            loss_p, mses_p = mb.ns_residual_weighted_obj_plain(
                pl, x, physics, norm, w3, n_valid, n_mean)
            grads_p = torch.autograd.grad(loss_p, fl)
            e_l = check_close(f"{name} loss", loss, loss_p.detach(), 1e-11)
            e_m = check_close(f"{name} mses", mses, mses_p, 1e-11)
            e_g = max(check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p)))
            dp2, mses2, loss2 = mb.ns_residual_bwd(params, x, physics, norm,
                                                   gbar, n_valid, n_mean,
                                                   with_loss=True)
            same = (torch.equal(loss, loss2) and torch.equal(mses, mses2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2))))
            if not same:
                raise AssertionError(f"{name}: repeat call not bit-identical")
            print(f"  {name}: loss rel {rel(loss, loss_p.detach()):.2e}, "
                  f"mses rel {rel(mses, mses_p):.2e}, grads max abs {e_g:.2e}, "
                  f"repeat bit-identical")
            if name.startswith("steady"):
                errs["ns_residual_bwd"] = max(e_l, e_m, e_g)
            # the float32 instantiation against float64
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            dp32, m32, l32 = mb.ns_residual_bwd(p32, x.float(), physics, norm,
                                                gbar.float(), n_valid, n_mean,
                                                with_loss=True)
            g_scale = max(float(torch.max(torch.abs(g))) for g in flat(dp))
            g_err = max(float(torch.max(torch.abs(a.double() - b)))
                        for a, b in zip(flat(dp32), flat(dp))) / g_scale
            if not all(bool(torch.isfinite(t).all()) for t in flat(dp32)):
                raise AssertionError(f"{name}: float32 grads not finite")
            print(f"  {name}: float32 vs float64: loss rel "
                  f"{rel(l32.double(), loss):.2e}, mses rel "
                  f"{rel(m32.double(), mses):.2e}, grads max abs / max|g| "
                  f"{g_err:.2e}")
            record[f"f32_err {name}"] = [rel(l32.double(), loss), g_err]

    with phase("3 kernel 2 (ns_residual_fwd) vs plain, float64"):
        for name, d_in, n, n_valid in cases:
            params, x, physics, norm = problem(d_in, n, 1 + d_in, f64, dev)
            n_mean = n_valid or n
            m2 = mb.ns_residual_fwd(params, x, physics, norm, n_valid, n_mean)
            m_p = mb.ns_residual_mse_plain(params, x, physics, norm, n_valid,
                                           n_mean)
            e = check_close(f"{name} fwd mses", m2, m_p, 1e-11)
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            _, m1, _ = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                          n_valid, n_mean)
            check_close(f"{name} fwd vs bwd mses", m2, m1, 1e-12)
            # ns_residual_mse: kernel 2 forward, kernel 1 backward
            fl = [p.clone().requires_grad_(True) for p in flat(params)]
            pl = [{"kernel": fl[i], "bias": fl[i + 1]}
                  for i in range(0, len(fl), 2)]
            g_k = torch.autograd.grad(
                (gbar * mb.ns_residual_mse(pl, x, physics, norm, n_valid,
                                           n_mean)).sum(), fl)
            g_p = torch.autograd.grad(
                (gbar * mb.ns_residual_mse_plain(pl, x, physics, norm,
                                                 n_valid, n_mean)).sum(), fl)
            e_g = max(check_close(f"{name} mse grad {i}", a, b, 1e-9, 1e-12)
                      for i, (a, b) in enumerate(zip(g_k, g_p)))
            print(f"  {name}: mses rel {rel(m2, m_p):.2e}, bit-identical to "
                  f"kernel 1: {torch.equal(m2, m1)}, ns_residual_mse grads "
                  f"max abs {e_g:.2e}")
            if name.startswith("steady"):
                errs["ns_residual_fwd"] = e

    with phase("4 the slice: Poiseuille Adam round, 100 epochs, float64"):
        from tpinn_torch.cases import poiseuille_flow

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv = poiseuille_flow.main(td, adam_epochs=100, device="cuda",
                                       second_round="none")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(mb.LAUNCHES)
            hist = History.load(os.path.join(drv.folder, "History_Loss.json"))
        print(f"  launches on the main path: {launches}; wall {wall:.2f} s "
              f"({1e3 * wall / 100:.2f} ms/epoch with logging)")
        if launches["ns_residual_bwd"] < 100 or launches["ns_residual_fwd"] < 1:
            raise AssertionError(f"main path missed a kernel: {launches}")
        logs = [hist.loss_global] + [e["log"] for e in hist.losses.values()] \
            + [e["log"] for e in hist.losses_test.values()]
        if not all(np.isfinite(v).all() for v in logs):
            raise AssertionError("non-finite logged loss")
        if not hist.loss_global[-1] < hist.loss_global[0]:
            raise AssertionError("loss did not fall")
        if hist.iters != list(range(0, 101, 10)):
            raise AssertionError(f"unexpected log iterations {hist.iters}")
        with tempfile.TemporaryDirectory() as td:
            ref = poiseuille_flow.main(td, adam_epochs=100, device="cpu",
                                       second_round="none")
        a = np.array(hist.loss_global)
        b = np.array(ref.pb.history.loss_global)
        dev_rel = float(np.max(np.abs(a - b) / np.abs(b)))
        print(f"  loss_global {a[0]:.6e} -> {a[-1]:.6e}; against the plain "
              f"versions on the CPU: max rel deviation {dev_rel:.2e}")
        if dev_rel > 1e-8:
            raise AssertionError("card and CPU histories disagree")
        record["slice"] = {"launches": launches, "wall_s": wall,
                           "loss_first": a[0], "loss_last": a[-1],
                           "cpu_rel_dev": dev_rel}

    with phase("5 times (CUDA events, median of 10 runs)"):
        times = {}
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for n in SIZES:
                params, x, physics, norm = problem(2, n, 7, dtype, dev)
                gbar = torch.tensor(w3, dtype=dtype, device=dev)
                pl, fl = leaves_of(params)

                def plain_bwd():
                    loss, _ = mb.ns_residual_weighted_obj_plain(
                        pl, x, physics, norm, w3)
                    torch.autograd.grad(loss, fl)

                def plain_fwd():
                    with torch.no_grad():
                        mb.ns_residual_mse_plain(params, x, physics, norm)

                inner = 20 if n <= 10_000 else 1
                row = {
                    "bwd": cuda_ms(lambda: mb.ns_residual_bwd(
                        params, x, physics, norm, gbar, with_loss=True), inner),
                    "fwd": cuda_ms(lambda: mb.ns_residual_fwd(
                        params, x, physics, norm), inner),
                    "plain_bwd": cuda_ms(plain_bwd, inner),
                    "plain_fwd": cuda_ms(plain_fwd, inner),
                }
                widths = (2,) + WIDTHS + (3,)
                item = x.element_size()
                n_par = sum((a + 1) * b for a, b in zip(widths[:-1], widths[1:]))
                for k, bwd in (("bwd", True), ("fwd", False)):
                    ops = n * ns_flops_per_point(widths, 2, bwd)
                    nbytes = item * (n * 2 + n_par + 3 + (n_par + 4 if bwd else 0))
                    row[f"{k}_bound"], row[f"{k}_bound_by"] = bound(
                        ops, nbytes, dname)
                    row[f"{k}_flops_per_point"] = ops / n
                times[("ns", dname, n)] = row
                print(f"  NS {dname} n={n}: bwd {row['bwd']:.4f} ms (bound "
                      f"{row['bwd_bound']:.4f}, plain {row['plain_bwd']:.4f}); "
                      f"fwd {row['fwd']:.4f} ms (bound {row['fwd_bound']:.4f}, "
                      f"plain {row['plain_fwd']:.4f})", flush=True)
                del params, x, fl, pl
                torch.cuda.empty_cache()
            for n in POISSON_SIZES:
                params, x, f = poisson_problem(n, 7, dtype, dev)
                gbar = torch.tensor([2.0], dtype=dtype, device=dev)
                pl, fl = leaves_of(params)

                def plain_bwd():
                    loss, _ = mb.poisson_residual_weighted_obj_plain(
                        pl, x, f, 2.0)
                    torch.autograd.grad(loss, fl, materialize_grads=True)

                def plain_fwd():
                    with torch.no_grad():
                        mb.poisson_residual_mse_plain(params, x, f)

                inner = 20 if n <= 10_000 else 1
                row = {
                    "bwd": cuda_ms(lambda: mb.poisson_residual_bwd(
                        params, x, f, gbar, with_loss=True), inner),
                    "fwd": cuda_ms(lambda: mb.poisson_residual_fwd(
                        params, x, f), inner),
                    "plain_bwd": cuda_ms(plain_bwd, inner),
                    "plain_fwd": cuda_ms(plain_fwd, inner),
                }
                item = x.element_size()
                n_par = sum((a + 1) * b for a, b in
                            zip(POISSON_WIDTHS[:-1], POISSON_WIDTHS[1:]))
                for k, bwd in (("bwd", True), ("fwd", False)):
                    ops = n * poisson_flops_per_point(POISSON_WIDTHS, bwd)
                    nbytes = item * (n * 3 + n_par + 1 + (n_par + 1 if bwd else 0))
                    row[f"{k}_bound"], row[f"{k}_bound_by"] = bound(
                        ops, nbytes, dname)
                    row[f"{k}_flops_per_point"] = ops / n
                times[("poisson", dname, n)] = row
                print(f"  Poisson {dname} n={n}: bwd {row['bwd']:.4f} ms "
                      f"(bound {row['bwd_bound']:.5f}, plain "
                      f"{row['plain_bwd']:.4f}); fwd {row['fwd']:.4f} ms "
                      f"(bound {row['fwd_bound']:.5f}, plain "
                      f"{row['plain_fwd']:.4f})", flush=True)
                del params, x, f, fl, pl
                torch.cuda.empty_cache()
        record["times"] = {" ".join(map(str, k)): r for k, r in times.items()}

    with phase("6 kernel 3 (poisson_residual_bwd) vs plain, float64"):
        p_cases = [("n=200", 200, None, 1.0),
                   ("masked n=4099 n_valid=4000", 4099, 4000, 1.0),
                   ("n=200 normalization 3", 200, None, 3.0)]
        for name, n, n_valid, norm_c in p_cases:
            params, x, f = poisson_problem(n, 11, f64, dev)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            dp, mse, loss = mb.poisson_residual_bwd(
                params, x, f, gbar, norm_c, n_valid, n_valid, with_loss=True)
            torch.cuda.synchronize()
            pl, fl = leaves_of(params)
            loss_p, mse_p = mb.poisson_residual_weighted_obj_plain(
                pl, x, f, 2.0, norm_c, n_valid, n_valid)
            grads_p = torch.autograd.grad(loss_p, fl, materialize_grads=True)
            e_l = check_close(f"{name} loss", loss, loss_p.detach(), 1e-11)
            e_m = check_close(f"{name} mse", mse, mse_p, 1e-11)
            e_g = max(check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p)))
            dp2, mse2, loss2 = mb.poisson_residual_bwd(
                params, x, f, gbar, norm_c, n_valid, n_valid, with_loss=True)
            if not (torch.equal(loss, loss2) and torch.equal(mse, mse2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"{name}: repeat call not bit-identical")
            print(f"  {name}: loss rel {rel(loss, loss_p.detach()):.2e}, "
                  f"mse rel {rel(mse, mse_p):.2e}, grads max abs {e_g:.2e}, "
                  f"repeat bit-identical")
            if name == "n=200":
                errs["poisson_residual_bwd"] = max(e_l, e_m, e_g)
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            dp32, m32, l32 = mb.poisson_residual_bwd(
                p32, x.float(), f.float(), gbar.float(), norm_c, n_valid,
                n_valid, with_loss=True)
            g_scale = max(float(torch.max(torch.abs(g))) for g in flat(dp))
            g_err = max(float(torch.max(torch.abs(a.double() - b)))
                        for a, b in zip(flat(dp32), flat(dp))) / g_scale
            if not all(bool(torch.isfinite(t).all()) for t in flat(dp32)):
                raise AssertionError(f"{name}: float32 grads not finite")
            print(f"  {name}: float32 vs float64: loss rel "
                  f"{rel(l32.double(), loss):.2e}, grads max abs / max|g| "
                  f"{g_err:.2e}")
            record[f"f32_err poisson {name}"] = [rel(l32.double(), loss), g_err]

    with phase("7 kernel 4 (poisson_residual_fwd) vs plain, float64"):
        for name, n, n_valid, norm_c in p_cases:
            params, x, f = poisson_problem(n, 11, f64, dev)
            m4 = mb.poisson_residual_fwd(params, x, f, norm_c, n_valid, n_valid)
            m_p = mb.poisson_residual_mse_plain(params, x, f, norm_c, n_valid,
                                                n_valid)
            e = check_close(f"{name} fwd mse", m4, m_p, 1e-11)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            _, m3, _ = mb.poisson_residual_bwd(params, x, f, gbar, norm_c,
                                               n_valid, n_valid)
            if not torch.equal(m4, m3):
                raise AssertionError(f"{name}: kernel 4's MSE is not kernel "
                                     f"3's bit for bit ({float(m4)!r} vs "
                                     f"{float(m3)!r})")
            pl, fl = leaves_of(params)
            g_k = torch.autograd.grad(
                0.5 * mb.poisson_residual_mse(pl, x, f, norm_c, n_valid,
                                              n_valid), fl)
            g_p = torch.autograd.grad(
                0.5 * mb.poisson_residual_mse_plain(pl, x, f, norm_c, n_valid,
                                                    n_valid), fl,
                materialize_grads=True)
            e_g = max(check_close(f"{name} mse grad {i}", a, b, 1e-9, 1e-12)
                      for i, (a, b) in enumerate(zip(g_k, g_p)))
            print(f"  {name}: mse rel {rel(m4, m_p):.2e}, bit-identical to "
                  f"kernel 3, poisson_residual_mse grads max abs {e_g:.2e}")
            if name == "n=200":
                errs["poisson_residual_fwd"] = e

    with phase("8 the slice: Poisson cases, Adam 100 + L-BFGS-B, float64"):
        from tpinn_torch.cases import poisson, poisson_misto

        slices = {}
        for case, epochs in ((poisson, 100), (poisson_misto, 50)):
            name = case.__name__.rsplit(".", 1)[1]
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pb, model = case.main(epochs, out_dir=td, device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = dict(mb.LAUNCHES)
                written = sorted(os.listdir(os.path.join(td, "Images")))
            h = pb.history
            n_bwd, n_fwd = (counts["poisson_residual_bwd"],
                            counts["poisson_residual_fwd"])
            print(f"  {name}: launches {counts}; {n_bwd - 100} scipy "
                  f"function evaluations; wall {wall:.2f} s (Adam "
                  f"{1e3 * h.wall_times[0] / 100:.2f} ms/epoch, L-BFGS-B "
                  f"{1e3 * h.wall_times[1] / max(n_bwd - 100, 1):.2f} ms per "
                  f"evaluation, logging included); wrote {written}")
            if n_bwd <= 100 or n_fwd < 1 or counts["ns_residual_bwd"]:
                raise AssertionError(f"{name}: main path missed a kernel: "
                                     f"{counts}")
            logs = [h.loss_global] + [e["log"] for e in h.losses.values()] \
                + [e["log"] for e in h.losses_test.values()]
            if not all(np.isfinite(v).all() for v in logs):
                raise AssertionError(f"{name}: non-finite logged loss")
            if not h.loss_global[-1] < h.loss_global[0]:
                raise AssertionError(f"{name}: loss did not fall")
            if h.round_names != ["keras_Adam", "scipy_L-BFGS-B"]:
                raise AssertionError(f"{name}: rounds {h.round_names}")
            with tempfile.TemporaryDirectory() as td:
                ref, _ = case.main(epochs, out_dir=td, device="cpu")
            hr = ref.history
            if hr.iters != h.iters:
                raise AssertionError(f"{name}: card and CPU log at other "
                                     f"iterations ({h.iters} / {hr.iters})")
            adam = [i for i, r in enumerate(hr.rounds_idx) if r == 1]
            head = [i for i, r in enumerate(hr.rounds_idx)
                    if r == 2 and hr.iter_round[i] <= SCIPY_HEAD_ITERS]
            scipy_all = [i for i, r in enumerate(hr.rounds_idx) if r == 2]
            d_adam, d_head, d_all = (rel_dev(hr, h, adam),
                                     rel_dev(hr, h, head),
                                     rel_dev(hr, h, scipy_all))
            d_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
            test_mse = h.losses_test["fit"]["log"][-1]
            print(f"  {name}: against the plain versions on the CPU: Adam "
                  f"{d_adam:.2e}, L-BFGS-B first {SCIPY_HEAD_ITERS} "
                  f"iterations {d_head:.2e}, whole round ({h.iter_round[-1]} "
                  f"iterations) {d_all:.2e}, final global loss "
                  f"{h.loss_global[-1]:.6e} (CPU {hr.loss_global[-1]:.6e}, "
                  f"{d_final:.2e} apart); final test MSE {test_mse:.6e} "
                  f"(CPU {hr.losses_test['fit']['log'][-1]:.6e})")
            if d_adam > 1e-8 or d_head > 1e-8 or d_final > FINAL_LOSS_BAR:
                raise AssertionError(f"{name}: card and CPU histories "
                                     "disagree")
            slices[name] = {"launches": counts, "wall_s": wall,
                            "adam_s": h.wall_times[0],
                            "scipy_s": h.wall_times[1],
                            "scipy_evals": n_bwd - 100,
                            "scipy_iters": h.iter_round[-1],
                            "dev_adam": d_adam, "dev_scipy_head": d_head,
                            "dev_scipy_round": d_all,
                            "final_loss_rel": d_final, "test_mse": test_mse,
                            "loss_first": h.loss_global[0],
                            "loss_last": h.loss_global[-1]}
            if name == "poisson":
                p_launches = counts
                # one scipy function evaluation, and its two copies alone
                vec = pb.get_vector()
                eval_ms = host_ms(lambda: pb.value_and_grad_vector(vec))
                h2d_ms = host_ms(lambda: pb.set_vector(vec))
                grad = torch.zeros(vec.size + 1, dtype=f64, device=dev)
                d2h_ms = host_ms(lambda: grad.cpu())
                print(f"  poisson: one scipy evaluation {eval_ms:.3f} ms "
                      f"(host clock, median of 50), of which the parameter "
                      f"upload {h2d_ms:.3f} ms and the loss+gradient "
                      f"download {d2h_ms:.3f} ms ({vec.size} float64 values)")
                slices[name].update(eval_ms=eval_ms, h2d_ms=h2d_ms,
                                    d2h_ms=d2h_ms)
        record["poisson_slice"] = slices

    with phase("9 kernel 5 (taylor_bundle) vs plain, float64"):
        main_w = (2,) + WIDTHS + (3,)
        b_cases = [("2-32-32-32-3 n=1000", main_w, 1000, None),
                   ("2-32-32-32-3 n=100", main_w, 100, None),
                   ("2-32-32-32-3 n=33 (an outflow)", main_w, 33, None),
                   ("2-32-32-32-3 n=3000 (coronary PDE)", main_w, 3000, None),
                   ("2-32-32-32-3 n=4099", main_w, 4099, None),
                   ("3-32-32-32-3 n=1000", (3,) + WIDTHS + (3,), 1000, None),
                   ("2-20-20-20-1 n=1000", POISSON_WIDTHS, 1000, None),
                   ("3-20-20-20-3 n=1001 dim=1", (3, 20, 20, 20, 3), 1001, 1),
                   ("3-20-20-20-3 n=1001 dim=2", (3, 20, 20, 20, 3), 1001, 2),
                   ("3-20-20-20-3 n=1001 dim=3", (3, 20, 20, 20, 3), 1001, 3),
                   ("3-64-64-3 n=777", (3, 64, 64, 3), 777, None),
                   ("2-64-64-64-1 n=4099", (2, 64, 64, 64, 1), 4099, None),
                   ("2-3 n=999 (one layer)", (2, 3), 999, None),
                   ("3-1 n=1003 dim=2 (one layer)", (3, 1), 1003, 2),
                   ("3-64x7-3 n=333 (streamed weights)",
                    (3,) + (64,) * 7 + (3,), 333, None)]
        for name, widths, n, dim in b_cases:
            params, x = bundle_problem(widths, n, 21, f64, dev)
            got = mb.mlp_taylor_bundle(params, x, dim)
            torch.cuda.synchronize()
            ref = mb.mlp_taylor_bundle_plain(params, x, dim)
            errs_b = []
            for part, a, b in zip(("value", "jac", "hdiag"), got, ref):
                if a.shape != b.shape:
                    raise AssertionError(f"{name} {part}: shape {a.shape} "
                                         f"!= {b.shape}")
                scale = float(torch.max(torch.abs(b)))
                e = float(torch.max(torch.abs(a - b)))
                if not e <= 1e-12 * scale:
                    raise AssertionError(f"{name} {part}: max abs err "
                                         f"{e:.3e} above 1e-12 x {scale:.3e}")
                errs_b.append((part, e, e / scale if scale else 0.0))
            again = mb.mlp_taylor_bundle(params, x, dim)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: repeat call not bit-identical")
            n_cols = widths[0] if dim is None else dim
            plan = mb._PLANS[("taylor_bundle", 0, f64, widths, n_cols, n)]
            mirror = mb.bundle_plan(widths, widths[0], n_cols, 8)
            if (plan.P, bool(plan.streamed), plan.smem) != mirror:
                raise AssertionError(f"{name}: plan (P, streamed, smem) "
                                     f"{(plan.P, plan.streamed, plan.smem)} "
                                     f"!= mirror {mirror}")
            p32 = [{k: t.float() for k, t in p.items()} for p in params]
            got32 = mb.mlp_taylor_bundle(p32, x.float(), dim)
            e32 = max(float(torch.max(torch.abs(a.double() - b)))
                      / max(float(torch.max(torch.abs(b))), 1e-300)
                      for a, b in zip(got32, got))
            if not e32 <= 1e-5:
                raise AssertionError(f"{name}: float32 vs float64 {e32:.2e}")
            print(f"  {name}: P {plan.P}, G {plan.G}, {plan.smem} B"
                  f"{', weights streamed' if plan.streamed else ''}; " + ", ".join(
                f"{p} max abs {e:.2e} (rel to max {r:.2e})"
                for p, e, r in errs_b)
                + f"; repeat bit-identical; float32 vs float64 max abs / "
                f"max|ref| {e32:.2e}")
            record[f"bundle {name}"] = {"errs": errs_b, "f32_err": e32,
                                        "P": plan.P, "G": plan.G,
                                        "streamed": plan.streamed}
            if name == "2-32-32-32-3 n=1000":
                errs["taylor_bundle"] = max(e for _, e, _ in errs_b)
        # back-to-back calls at two batch sizes (two grids) on one stream
        b_in = {n: bundle_problem(main_w, n, 25, f64, dev)
                for n in (1000, 50_000)}
        first = {}
        for _ in range(3):
            for n, (params, x) in b_in.items():
                got = mb.mlp_taylor_bundle(params, x)
                ref_ = first.setdefault(n, got)
                if not all(torch.equal(a, b) for a, b in zip(got, ref_)):
                    raise AssertionError(f"kernel 5 at n={n}: a later call "
                                         "differs")
        for n, (params, x) in b_in.items():
            for a, b in zip(first[n], mb.mlp_taylor_bundle_plain(params, x)):
                if not float(torch.max(torch.abs(a - b))) <= \
                        1e-12 * float(torch.max(torch.abs(b))):
                    raise AssertionError(f"kernel 5 at n={n}: off the plain "
                                         "version")
        print("  kernel 5 alternating n = 1000 / 50,000, three rounds: every "
              "call bit-equal to the first at its size, which matches the "
              "plain version")
        # what the compiler made of the f64 and f32 instances
        sass = sass_counts(info.paths["taylor_bundle.cu"])
        print(f"  cuobjdump -sass: {sass}")
        if sass is not None:
            if any(v["DMMA"] == 0 for k, v in sass.items() if "Id" in k):
                raise AssertionError(f"an f64 instance issues no DMMA: {sass}")
            if any(v["HMMA"] for v in sass.values()):
                raise AssertionError(f"an instance issues HMMA (TF32): {sass}")
        record["bundle_sass"] = sass

    with phase("10 kernel 5 times (CUDA events, median of 10 runs)"):
        widths = (2,) + WIDTHS + (3,)
        n_par = sum((a + 1) * b for a, b in zip(widths[:-1], widths[1:]))
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            for n in BUNDLE_SIZES:
                params, x = bundle_problem(widths, n, 7, dtype, dev)

                def plain():
                    with torch.no_grad():
                        mb.mlp_taylor_bundle_plain(params, x)

                inner = 20 if n <= 10_000 else 1
                row = {"kernel": cuda_ms(lambda: mb.mlp_taylor_bundle(
                           params, x), inner),
                       "plain": cuda_ms(plain, inner)}
                item = x.element_size()
                ops = n * bundle_flops_per_point(widths, 2)
                nbytes = item * (n * 2 + n_par + n * 3 * 5)
                row["bound"], row["bound_by"] = bound(ops, nbytes, dname)
                row["ops_ms"] = 1e3 * ops / PEAK_FLOPS[dname]
                row["bytes_ms"] = 1e3 * nbytes / PEAK_BYTES
                row["flops_per_point"] = ops / n
                plan = mb._PLANS[("taylor_bundle", 0, dtype, widths, 2, n)]
                row["P"], row["G"] = plan.P, plan.G
                times[("bundle", dname, n)] = row
                print(f"  kernel 5 {dname} n={n} (P {plan.P}, G {plan.G}): "
                      f"{row['kernel']:.4f} ms "
                      f"(bound {row['bound']:.5f} by {row['bound_by']}: "
                      f"operations {row['ops_ms']:.5f}, bytes "
                      f"{row['bytes_ms']:.5f}; plain {row['plain']:.4f})",
                      flush=True)
                del params, x
                torch.cuda.empty_cache()
        record["times"].update({" ".join(map(str, k)): r
                                for k, r in times.items()
                                if k[0] == "bundle"})

    with phase("11 the slice: Poiseuille LM round under TPINN_USE_PALLAS=1"):
        from tpinn_torch.cases import poiseuille_flow

        def lm_round(device, opt_in, solver="host"):
            # the host eigh (phase 31 runs the card's default, the ladder)
            os.environ["TPINN_LM_SOLVER"] = solver
            if opt_in:
                os.environ["TPINN_USE_PALLAS"] = "1"
            try:
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    drv = poiseuille_flow.main(
                        td, adam_epochs=0, second_round="lm",
                        epochs=LM_ITERS, device=device)
                    torch.cuda.synchronize()
                    return (drv.pb, time.perf_counter() - t0,
                            dict(mb.LAUNCHES))
            finally:
                os.environ.pop("TPINN_USE_PALLAS", None)
                os.environ.pop("TPINN_LM_SOLVER", None)

        lm_pb, lm_wall, lm_launches = lm_round("cuda", True)
        h = lm_pb.history
        n_iters = len(lm_pb.lm_times)
        print(f"  launches on the main path: {lm_launches}; {n_iters} LM "
              f"iterations, wall {lm_wall:.2f} s")
        others = {k: v for k, v in lm_launches.items() if k != "taylor_bundle"}
        if lm_launches["taylor_bundle"] < 1 or any(others.values()):
            raise AssertionError(f"main path missed kernel 5 or ran another "
                                 f"kernel: {lm_launches}")
        if lm_launches["taylor_bundle"] % 3:
            raise AssertionError("kernel 5 launched other than three times "
                                 "(PDE bundle + two outflow bundles) per "
                                 f"residual evaluation: {lm_launches}")
        logs = [h.loss_global] + [e["log"] for e in h.losses.values()] \
            + [e["log"] for e in h.losses_test.values()]
        if not all(np.isfinite(v).all() for v in logs):
            raise AssertionError("non-finite logged loss")
        if h.round_names != ["keras_Adam", "jax_LM"]:
            raise AssertionError(f"rounds {h.round_names}")
        if not h.loss_global[-1] < 0.1 * h.loss_global[0]:
            raise AssertionError("LM did not reduce the loss tenfold")
        cpu_pb, cpu_wall, _ = lm_round("cpu", True)
        off_pb, off_wall, off_launches = lm_round("cuda", False)
        if off_launches["taylor_bundle"]:
            raise AssertionError(f"kernel 5 launched with the opt-in off: "
                                 f"{off_launches}")
        devs = {}
        for name, other in (("cpu", cpu_pb), ("opt-in off", off_pb)):
            if other.history.iters != h.iters:
                raise AssertionError(f"{name}: logs at other iterations "
                                     f"({other.history.iters} / {h.iters})")
            devs[name] = rel_dev(other.history, h,
                                 list(range(len(h.iters))))
        print(f"  loss_global {h.loss_global[0]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; max rel deviation of every log "
              f"against the plain versions on the CPU {devs['cpu']:.2e} "
              f"(CPU wall {cpu_wall:.2f} s), against the card with the "
              f"opt-in off {devs['opt-in off']:.2e} (wall {off_wall:.2f} s)")
        if max(devs.values()) > HISTORY_BAR:
            raise AssertionError(f"LM histories disagree: {devs}")
        split = {}
        for name, pb_ in (("opt-in", lm_pb), ("opt-in off", off_pb),
                          ("cpu", cpu_pb)):
            parts = sorted({k for t in pb_.lm_times for k in t})
            later = pb_.lm_times[1:] or pb_.lm_times
            split[name] = {
                "first": pb_.lm_times[0],
                "median": {k: float(np.median([t.get(k, 0.0)
                                               for t in later]))
                           for k in parts}}
            med = split[name]["median"]
            print(f"  LM iteration ({name}), median of iterations 2-"
                  f"{len(pb_.lm_times)}, ms: " + ", ".join(
                      f"{k} {1e3 * med[k]:.2f}" for k in
                      ("residuals", "gram", "download", "eigh", "accept",
                       "log") if k in med)
                  + f"; first iteration {1e3 * sum(split[name]['first'].values()):.1f}")
        record["lm_slice"] = {"launches": lm_launches, "wall_s": lm_wall,
                              "cpu_wall_s": cpu_wall,
                              "off_wall_s": off_wall, "devs": devs,
                              "loss_first": h.loss_global[0],
                              "loss_last": h.loss_global[-1],
                              "split": split}

    with phase("12 kernels 1-4 at padded widths, d_in 3, ragged and masked"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = {}

        def check_plan(kind, widths, d_in, n_sq, x_extra, n_eff, n_mean):
            plan = mb._PLANS[(kind, 0, f64, tuple(widths), n_eff, n_mean,
                              True)]
            P = mb.plan_points(widths, d_in, n_sq, x_extra, 8, n_eff, sms)
            acc = mb._tile_fits(widths, d_in, n_sq, x_extra, 8, P, True)
            smem = 8 * mb.smem_elems(widths, d_in, P, True, n_sq, x_extra, acc)
            if (plan.P, plan.smem) != (P, smem):
                raise AssertionError(f"{kind} {widths}: plan (P, smem) "
                                     f"{(plan.P, plan.smem)} != mirror "
                                     f"{(P, smem)}")
            return plan

        for widths, n, n_valid in (((2, 7, 7, 3), 1000, None),
                                   ((2, 24, 24, 3), 1003, 997),
                                   ((2, 64, 64, 3), 4099, 4000),
                                   ((3, 16, 16, 3), 777, None),
                                   ((3,) + WIDTHS + (3,), 1001, 995)):
            name = "-".join(map(str, widths)) + f" n={n} n_valid={n_valid}"
            params, x, physics, norm = problem(widths[0], n, 31, f64, dev,
                                               widths[1:-1])
            gbar = torch.tensor(w3, dtype=f64, device=dev)
            n_mean = n_valid or n
            dp, mses, loss = mb.ns_residual_bwd(params, x, physics, norm, gbar,
                                                n_valid, n_mean, with_loss=True)
            pl, fl = leaves_of(params)
            loss_p, mses_p = mb.ns_residual_weighted_obj_plain(
                pl, x, physics, norm, w3, n_valid, n_mean)
            grads_p = torch.autograd.grad(loss_p, fl)
            e = max(check_close(f"{name} loss", loss, loss_p.detach(), 1e-11),
                    check_close(f"{name} mses", mses, mses_p, 1e-11),
                    *[check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p))])
            dp2, mses2, loss2 = mb.ns_residual_bwd(params, x, physics, norm,
                                                   gbar, n_valid, n_mean,
                                                   with_loss=True)
            m2 = mb.ns_residual_fwd(params, x, physics, norm, n_valid, n_mean)
            if not (torch.equal(loss, loss2) and torch.equal(mses, mses2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"NS {name}: repeat not bit-identical")
            if not torch.equal(m2, mses):
                raise AssertionError(f"NS {name}: kernel 2's MSEs are not "
                                     "kernel 1's bit for bit")
            plan = check_plan("ns_residual", widths, widths[0], 3, 0,
                              n_valid or n, n_mean)
            print(f"  NS {name}: P {plan.P}, G {plan.G}, {plan.smem} B; max "
                  f"abs err {e:.2e}; repeat bit-identical; kernel 2 = "
                  f"kernel 1 bit for bit")
            tiles[f"ns {name}"] = {"max_abs_err": e, "P": plan.P, "G": plan.G}
        for widths, n, n_valid in (((2, 7, 7, 1), 1000, None),
                                   (POISSON_WIDTHS, 203, 197),
                                   ((2, 64, 64, 1), 4099, 4000)):
            name = "-".join(map(str, widths)) + f" n={n} n_valid={n_valid}"
            params, x, f = poisson_problem(n, 33, f64, dev, widths)
            gbar = torch.tensor([2.0], dtype=f64, device=dev)
            dp, mse, loss = mb.poisson_residual_bwd(
                params, x, f, gbar, 1.5, n_valid, n_valid, with_loss=True)
            pl, fl = leaves_of(params)
            loss_p, mse_p = mb.poisson_residual_weighted_obj_plain(
                pl, x, f, 2.0, 1.5, n_valid, n_valid)
            grads_p = torch.autograd.grad(loss_p, fl, materialize_grads=True)
            e = max(check_close(f"{name} loss", loss, loss_p.detach(), 1e-11),
                    check_close(f"{name} mse", mse, mse_p, 1e-11),
                    *[check_close(f"{name} grad {i}", g, gp, 1e-9, 1e-12)
                      for i, (g, gp) in enumerate(zip(flat(dp), grads_p))])
            dp2, mse2, loss2 = mb.poisson_residual_bwd(
                params, x, f, gbar, 1.5, n_valid, n_valid, with_loss=True)
            m4 = mb.poisson_residual_fwd(params, x, f, 1.5, n_valid, n_valid)
            if not (torch.equal(loss, loss2) and torch.equal(mse, mse2)
                    and all(torch.equal(a, b)
                            for a, b in zip(flat(dp), flat(dp2)))):
                raise AssertionError(f"Poisson {name}: repeat not "
                                     "bit-identical")
            if not torch.equal(m4, mse):
                raise AssertionError(f"Poisson {name}: kernel 4's MSE is not "
                                     "kernel 3's bit for bit")
            plan = check_plan("poisson_residual", widths, 2, 1, 1,
                              n_valid or n, n_valid or n)
            print(f"  Poisson {name}: P {plan.P}, G {plan.G}, {plan.smem} B; "
                  f"max abs err {e:.2e}; repeat bit-identical; kernel 4 = "
                  f"kernel 3 bit for bit")
            tiles[f"poisson {name}"] = {"max_abs_err": e, "P": plan.P,
                                        "G": plan.G}
        record["tiles"] = tiles

    with phase("13 back-to-back calls at two batch sizes (ticket reset)"):
        gbar3 = torch.tensor(w3, dtype=f64, device=dev)
        gbar1 = torch.tensor([2.0], dtype=f64, device=dev)
        ns_in = {n: problem(2, n, 41, f64, dev) for n in (1000, 50_000)}
        p_in = {n: poisson_problem(n, 43, f64, dev) for n in (200, 50_000)}
        first = {}
        for _ in range(3):
            for n, (params, x, physics, norm) in ns_in.items():
                got = mb.ns_residual_bwd(params, x, physics, norm, gbar3,
                                         with_loss=True)
                ref_ = first.setdefault(("ns", n), got)
                if not (torch.equal(got[1], ref_[1])
                        and torch.equal(got[2], ref_[2])):
                    raise AssertionError(f"kernel 1 at n={n}: a later call "
                                         "differs")
            for n, (params, x, f) in p_in.items():
                got = mb.poisson_residual_bwd(params, x, f, gbar1,
                                              with_loss=True)
                ref_ = first.setdefault(("poisson", n), got)
                if not (torch.equal(got[1], ref_[1])
                        and torch.equal(got[2], ref_[2])):
                    raise AssertionError(f"kernel 3 at n={n}: a later call "
                                         "differs")
        for n, (params, x, physics, norm) in ns_in.items():
            check_close(f"kernel 1 n={n} mses", first[("ns", n)][1],
                        mb.ns_residual_mse_plain(params, x, physics, norm),
                        1e-11)
        for n, (params, x, f) in p_in.items():
            check_close(f"kernel 3 n={n} mse", first[("poisson", n)][1],
                        mb.poisson_residual_mse_plain(params, x, f), 1e-11)
        print("  kernels 1 and 3 alternating n = 1000 / 50,000 and 200 / "
              "50,000, three rounds: every call bit-equal to the first at its "
              "size, which matches the plain version")

    with phase("14 device time per launch (torch.profiler)"):
        dev_t = {}
        gbar3 = torch.tensor(w3, dtype=f64, device=dev)
        gbar1 = torch.tensor([2.0], dtype=f64, device=dev)
        for n in (1000, 1_048_576):
            params, x, physics, norm = problem(2, n, 7, f64, dev)
            calls = 20 if n <= 10_000 else 3
            for key, fn in (
                    ("ns_residual_bwd", lambda: mb.ns_residual_bwd(
                        params, x, physics, norm, gbar3, with_loss=True)),
                    ("ns_residual_fwd", lambda: mb.ns_residual_fwd(
                        params, x, physics, norm))):
                dev_t[(key, n)] = device_profile(fn, calls)
            del params, x
        for n in (200, 1_048_576):
            params, x, f = poisson_problem(n, 7, f64, dev)
            calls = 20 if n <= 10_000 else 3
            for key, fn in (
                    ("poisson_residual_bwd", lambda: mb.poisson_residual_bwd(
                        params, x, f, gbar1, with_loss=True)),
                    ("poisson_residual_fwd", lambda: mb.poisson_residual_fwd(
                        params, x, f))):
                dev_t[(key, n)] = device_profile(fn, calls)
            del params, x, f
        for n in (33, 1000, 3000, 1_048_576):
            params, x = bundle_problem((2,) + WIDTHS + (3,), n, 7, f64, dev)
            dev_t[("taylor_bundle", n)] = device_profile(
                lambda: mb.mlp_taylor_bundle(params, x),
                20 if n <= 10_000 else 3)
            del params, x
        torch.cuda.empty_cache()
        call_ms = {("ns_residual_bwd", 1000): times[("ns", "float64", 1000)]["bwd"],
                   ("ns_residual_fwd", 1000): times[("ns", "float64", 1000)]["fwd"],
                   ("poisson_residual_bwd", 200): times[("poisson", "float64", 200)]["bwd"],
                   ("poisson_residual_fwd", 200): times[("poisson", "float64", 200)]["fwd"],
                   ("ns_residual_bwd", 1_048_576): times[("ns", "float64", 1_048_576)]["bwd"],
                   ("ns_residual_fwd", 1_048_576): times[("ns", "float64", 1_048_576)]["fwd"],
                   ("poisson_residual_bwd", 1_048_576): times[("poisson", "float64", 1_048_576)]["bwd"],
                   ("poisson_residual_fwd", 1_048_576): times[("poisson", "float64", 1_048_576)]["fwd"],
                   ("taylor_bundle", 33): times[("bundle", "float64", 33)]["kernel"],
                   ("taylor_bundle", 1000): times[("bundle", "float64", 1000)]["kernel"],
                   ("taylor_bundle", 3000): times[("bundle", "float64", 3000)]["kernel"],
                   ("taylor_bundle", 1_048_576): times[("bundle", "float64", 1_048_576)]["kernel"]}
        for (key, n), (d_ms, per_call, names) in dev_t.items():
            print(f"  {key} n={n}: device {1e3 * d_ms:.2f} us per launch, "
                  f"{per_call:g} device kernels per call, call "
                  f"{call_ms[(key, n)]:.4f} ms (events); {names}")
            if per_call != 1:
                raise AssertionError(f"{key}: {per_call} device kernels per "
                                     f"call: {names}")
        record["device"] = {f"{k} {n}": {"device_ms": d, "per_call": c,
                                         "call_ms": call_ms[(k, n)]}
                            for (k, n), (d, c, _) in dev_t.items()}

    with phase("15 the slice: Poiseuille Adam 100 + dense BFGS 40, float64"):
        from tpinn_torch import config
        from tpinn_torch.cases import poiseuille_flow
        from tpinn_torch.optimize import minimize

        def bfgs_case(td, device, second_round="jax-bfgs",
                      iters=BFGS_ITERS, adam_epochs=100, resume_from=None):
            return poiseuille_flow.main(
                td, adam_epochs=adam_epochs, device=device,
                second_round=second_round, epochs=iters,
                resume_from=resume_from)

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bfgs_drv = bfgs_case(td, "cuda")
            torch.cuda.synchronize()
            bfgs_wall = time.perf_counter() - t0
            bfgs_launches = dict(mb.LAUNCHES)
        pb = bfgs_drv.pb
        h = pb.history
        counts = pb.bfgs_counts
        n_it = counts["iterations"]
        print(f"  launches on the main path: {bfgs_launches}; wall "
              f"{bfgs_wall:.2f} s; {counts}")
        if pb.last_opt_state["kind"] != "bfgs_plain":
            raise AssertionError(f"variant {pb.last_opt_state['kind']}")
        if h.round_names != ["keras_Adam", "jax_BFGS"] or n_it != BFGS_ITERS:
            raise AssertionError(f"rounds {h.round_names}, {n_it} iterations")
        if not np.isfinite(np.concatenate(
                [h.loss_global] + [e["log"] for e in h.losses.values()]
                + [e["log"] for e in h.losses_test.values()])).all():
            raise AssertionError("non-finite logged loss")
        i_bfgs = [i for i, r in enumerate(h.rounds_idx) if r == 2]
        if not h.loss_global[i_bfgs[-1]] < h.loss_global[i_bfgs[0]]:
            raise AssertionError("BFGS did not reduce the loss")
        k1 = bfgs_launches["ns_residual_bwd"] - 100
        if (k1 != counts["evaluations"]
                or bfgs_launches["ns_residual_fwd"] != len(h.iters)
                or bfgs_launches["taylor_bundle"]
                or bfgs_launches["poisson_residual_bwd"]):
            raise AssertionError(f"main path launches {bfgs_launches} for "
                                 f"{counts}")
        trials = counts["trials"] / n_it
        bfgs_ms = 1e3 * h.wall_times[1] / n_it
        print(f"  per BFGS iteration: {(k1 - 1) / n_it:.3f} kernel-1 "
              f"launches (line-search trials + 2 = {trials + 2:.3f}), "
              f"{trials:.3f} trials, {bfgs_ms:.2f} ms (round wall / "
              f"iterations, logging and checkpoints included)")
        with tempfile.TemporaryDirectory() as td:
            ref = bfgs_case(td, "cpu")
        hr = ref.pb.history
        if hr.iters != h.iters:
            raise AssertionError(f"card and CPU log at other iterations "
                                 f"({h.iters} / {hr.iters})")
        head = [i for i, r in enumerate(hr.rounds_idx)
                if r == 1 or hr.iter_round[i] <= BFGS_HEAD_ITERS]
        d_head = rel_dev(hr, h, head)
        d_all = rel_dev(hr, h, list(range(len(h.iters))))
        d_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
        print(f"  loss_global {h.loss_global[i_bfgs[0]]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; against the plain versions on the "
              f"CPU: Adam + BFGS iterations 0-{BFGS_HEAD_ITERS} "
              f"{d_head:.2e}, every log {d_all:.2e}, final global loss "
              f"{d_final:.2e} apart (CPU {hr.loss_global[-1]:.6e}, variant "
              f"{ref.pb.last_opt_state['kind']})")
        if d_head > HISTORY_BAR or d_final > FINAL_LOSS_BAR:
            raise AssertionError("card and CPU BFGS histories disagree")

        def logs(hist):
            return np.array([hist.loss_global]
                            + [e["log"] for e in hist.losses.values()]
                            + [e["log"] for e in hist.losses_test.values()])

        # a repeat from the same state (its callbacks off, so no checkpoint
        # is written), with every synchronising operation the host issues
        # recorded (torch's sync debug mode)
        import warnings

        with tempfile.TemporaryDirectory() as td, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drv_b = bfgs_case(td, "cuda", second_round="none")
            drv_b.pb.callbacks.clear()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                minimize(drv_b.pb, "jax", "BFGS", num_epochs=BFGS_ITERS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        same = np.array_equal(logs(drv_b.pb.history), logs(h))
        print(f"  repeat from the same state bit-identical: {same}; host "
              f"synchronisations in the round (sync debug mode) {syncs}, "
              f"{syncs / n_it:.2f} per iteration (line-search flags "
              f"{trials:.2f}, logged evaluations {len(i_bfgs) / n_it:.2f})")
        if not same:
            dev = np.max(np.abs(logs(drv_b.pb.history) - logs(h)))
            raise AssertionError(f"repeat differs by {dev:.3e}")
        with tempfile.TemporaryDirectory() as td:
            drv_c = bfgs_case(td, "cuda", second_round="none")
            drv_c.pb.callbacks.clear()
            minimize(drv_c.pb, "jax", "BFGS", num_epochs=BFGS_ITERS,
                     timed=True)
        iter_times = drv_c.pb.bfgs_times[1:]
        split = {k: 1e3 * float(np.median([t[k] for t in iter_times]))
                 for k in ("direction", "evaluations", "update")}
        split["round wall per iteration"] = (
            1e3 * drv_c.pb.history.wall_times[1] / n_it)
        timed_same = np.array_equal(logs(drv_c.pb.history), logs(h))
        print("  iteration split (device synchronised at each boundary, "
              "median of iterations 2-" + str(BFGS_ITERS) + "), ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; timed round bit-identical too: {timed_same}")
        if not timed_same:
            raise AssertionError("the timed round differs")
        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            drv_d = bfgs_case(td, "cuda", second_round="scipy-parity",
                              iters=SCIPY_BFGS_ITERS)
            scipy_evals = mb.LAUNCHES["ns_residual_bwd"] - 100
        hd = drv_d.pb.history
        scipy_ms = 1e3 * hd.wall_times[1] / hd.iter_round[-1]
        print(f"  host scipy BFGS (scipy-parity), {hd.iter_round[-1]} "
              f"iterations: {scipy_ms:.2f} ms per iteration, "
              f"{scipy_evals / hd.iter_round[-1]:.2f} evaluations per "
              f"iteration; on-device BFGS {bfgs_ms:.2f} ms")
        if hd.round_names != ["keras_Adam", "scipy_BFGS"] or not scipy_evals:
            raise AssertionError(f"scipy round {hd.round_names}, "
                                 f"{scipy_evals} evaluations")
        config.set_dtype(torch.float32)
        try:
            with tempfile.TemporaryDirectory() as td:
                drv_e = bfgs_case(td, "cuda", iters=F32_BFGS_ITERS)
        finally:
            config.set_dtype(None)
        he = drv_e.pb.history
        e_bfgs = [i for i, r in enumerate(he.rounds_idx) if r == 2]
        f32_loss = np.array(he.loss_global)[e_bfgs]
        f64_loss = np.array([h.loss_global[i] for i in i_bfgs
                             if h.iter_round[i] <= F32_BFGS_ITERS])
        f32_err = float(np.max(np.abs(f32_loss - f64_loss) / f64_loss))
        print(f"  float32 round ({drv_e.pb.last_opt_state['kind']}), "
              f"{F32_BFGS_ITERS} iterations: loss_global {f32_loss[0]:.6e} "
              f"-> {f32_loss[-1]:.6e}; max rel deviation from float64 at "
              f"its log points {f32_err:.2e}")
        if (not np.isfinite(logs(he)).all() or not f32_loss[-1] < f32_loss[0]
                or drv_e.pb.last_opt_state["carry"][0].dtype != torch.float32):
            raise AssertionError("float32 BFGS round failed")
        record["bfgs_slice"] = {
            "launches": bfgs_launches, "counts": counts, "wall_s": bfgs_wall,
            "ms_per_iteration": bfgs_ms, "trials_per_iteration": trials,
            "kernel1_per_iteration": (k1 - 1) / n_it,
            "syncs_per_iteration": syncs / n_it, "split_ms": split,
            "scipy_ms_per_iteration": scipy_ms,
            "scipy_evals_per_iteration": scipy_evals / hd.iter_round[-1],
            "dev_head": d_head, "dev_all": d_all, "final_loss_rel": d_final,
            "f32_rel_err": f32_err, "loss_first": h.loss_global[i_bfgs[0]],
            "loss_last": h.loss_global[-1]}

    with phase("16 the paired variant: TPINN_USE_PALLAS=0, BFGS 20"):
        os.environ["TPINN_USE_PALLAS"] = "0"
        try:
            paired = {}
            for device in ("cuda", "cpu"):
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    paired[device] = (bfgs_case(td, device, adam_epochs=0,
                                                iters=PAIRED_ITERS),
                                      dict(mb.LAUNCHES))
        finally:
            os.environ.pop("TPINN_USE_PALLAS", None)
        (gpu, g_launch), (cpu, _) = paired["cuda"], paired["cpu"]
        kinds = [d.pb.last_opt_state["kind"] for d in (gpu, cpu)]
        d_paired = rel_dev(cpu.pb.history, gpu.pb.history,
                           list(range(len(gpu.pb.history.iters))))
        print(f"  variant {kinds}; launches {g_launch}; loss_global "
              f"{gpu.pb.history.loss_global[0]:.6e} -> "
              f"{gpu.pb.history.loss_global[-1]:.6e}; against the CPU: max "
              f"rel deviation of every log {d_paired:.2e}")
        if kinds != ["bfgs_paired"] * 2 or d_paired > HISTORY_BAR:
            raise AssertionError("paired round failed")
        record["paired"] = {"dev": d_paired, "launches": g_launch}

    with phase("17 Poisson jax-bfgs (kernels 3/4), Adam 100 + BFGS 20"):
        from tpinn_torch.cases import poisson

        runs = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                runs[device] = (poisson.main(PAIRED_ITERS, out_dir=td,
                                             device=device,
                                             second_round="jax-bfgs")[0],
                                dict(mb.LAUNCHES))
        (p_gpu, p_bfgs_launches), (p_cpu, _) = runs["cuda"], runs["cpu"]
        hp = p_gpu.history
        d_poisson = rel_dev(p_cpu.history, hp, list(range(len(hp.iters))))
        pc = p_gpu.bfgs_counts
        print(f"  launches {p_bfgs_launches}; {pc}; variant "
              f"{p_gpu.last_opt_state['kind']}; loss_global "
              f"{hp.loss_global[0]:.6e} -> {hp.loss_global[-1]:.6e}; "
              f"against the CPU: max rel deviation of every log "
              f"{d_poisson:.2e}; BFGS {1e3 * hp.wall_times[1] / PAIRED_ITERS:.2f}"
              " ms per iteration")
        if (p_bfgs_launches["poisson_residual_bwd"] != 100 + pc["evaluations"]
                or p_bfgs_launches["poisson_residual_fwd"] != len(hp.iters)
                or p_gpu.last_opt_state["kind"] != "bfgs_plain"
                or hp.round_names != ["keras_Adam", "jax_BFGS"]
                or d_poisson > HISTORY_BAR):
            raise AssertionError("Poisson BFGS round failed")
        record["poisson_bfgs"] = {"launches": p_bfgs_launches, "counts": pc,
                                  "dev": d_poisson,
                                  "ms_per_iteration":
                                      1e3 * hp.wall_times[1] / PAIRED_ITERS}

    with phase("18 artifacts and exact resume on the card"):
        from tpinn_torch import checkpoint, utils

        with tempfile.TemporaryDirectory() as td:
            straight = bfgs_case(os.path.join(td, "a"), "cuda",
                                 iters=RESUME_ITERS)
            first = bfgs_case(os.path.join(td, "b"), "cuda",
                              iters=RESUME_ITERS // 2)
            resumed = bfgs_case(os.path.join(td, "b"), "cuda",
                                iters=RESUME_ITERS // 2,
                                resume_from=first.folder)
            written = sorted(os.listdir(first.folder))
            model, _ = checkpoint.load_experiment(first.folder,
                                                  device="cuda")
        hs, hr = straight.pb.history, resumed.pb.history
        s = logs(hs)[:, [i for i, r in enumerate(hs.rounds_idx) if r == 2]]
        r = logs(hr)
        r2 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 2]]
        r3 = r[:, [i for i, k in enumerate(hr.rounds_idx) if k == 3]]
        d_resume = max(float(np.max(np.abs(r2 - s[:, :2]))),
                       float(np.max(np.abs(r3 - s[:, 1:]))))
        weights = "Weights.h5" if utils.has_module("h5py") else "Weights.npz"
        expect = sorted(["History_Loss.json", "Model.json",
                         "Test_Options.txt", weights, "checkpoint.pkl"]
                        + (["Graphic.jpg", "Loss_Trend_Full.png",
                            "Loss_Trend_Reduced.png"]
                           if utils.has_module("matplotlib") else []))
        x = torch.tensor(np.random.default_rng(3).uniform(0, 1, (1000, 2))
                         * np.array([1.0, 0.1]), device=dev)
        with torch.no_grad():
            same_out = torch.equal(model(x), resumed.model(x))
        print(f"  rounds {hr.round_names}; the carry adopted: "
              f"{resumed.pb.resume_opt_state is None}; straight "
              f"{RESUME_ITERS} against {RESUME_ITERS // 2} + resume "
              f"{RESUME_ITERS // 2}: largest difference of every log "
              f"{d_resume:.3e}; files {written}; load_experiment "
              f"reproduces the outputs bit for bit: {same_out}")
        if d_resume != 0.0 or resumed.pb.resume_opt_state is not None:
            raise AssertionError(f"resumed round differs from the straight "
                                 f"one by {d_resume:.3e}")
        if written != expect or not same_out:
            raise AssertionError(f"artifacts {written} (expected {expect}), "
                                 f"outputs equal {same_out}")
        record["resume"] = {"dev": d_resume, "files": written}

    with phase("19 the slice: Poiseuille Adam 100 + L-BFGS 100, float64"):
        def lbfgs_case(td, device, second_round="jax", iters=LBFGS_ITERS):
            return poiseuille_flow.main(td, adam_epochs=100, device=device,
                                        second_round=second_round,
                                        epochs=iters)

        with tempfile.TemporaryDirectory() as td:
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lbfgs_drv = lbfgs_case(td, "cuda")
            torch.cuda.synchronize()
            lbfgs_wall = time.perf_counter() - t0
            lbfgs_launches = dict(mb.LAUNCHES)
        pb = lbfgs_drv.pb
        h = pb.history
        counts = pb.lbfgs_counts
        n_it = counts["iterations"]
        print(f"  launches on the main path: {lbfgs_launches}; wall "
              f"{lbfgs_wall:.2f} s; {counts}")
        if h.round_names != ["keras_Adam", "jax_L-BFGS"] or n_it != LBFGS_ITERS:
            raise AssertionError(f"rounds {h.round_names}, {n_it} iterations")
        if not np.isfinite(logs(h)).all():
            raise AssertionError("non-finite logged loss")
        i_lb = [i for i, r in enumerate(h.rounds_idx) if r == 2]
        if not h.loss_global[i_lb[-1]] < h.loss_global[i_lb[0]]:
            raise AssertionError("L-BFGS did not reduce the loss")
        k1 = lbfgs_launches["ns_residual_bwd"] - 100
        if (k1 != counts["evaluations"] or k1 != counts["trials"] + 1
                or lbfgs_launches["ns_residual_fwd"] != len(h.iters)
                or lbfgs_launches["taylor_bundle"]
                or lbfgs_launches["poisson_residual_bwd"]):
            raise AssertionError(f"main path launches {lbfgs_launches} for "
                                 f"{counts}")
        lb_trials = counts["trials"] / n_it
        lbfgs_ms = 1e3 * h.wall_times[1] / n_it
        print(f"  per L-BFGS iteration: {k1 / n_it:.3f} kernel-1 launches "
              f"(trials {lb_trials:.3f}, + 1 on iteration 0), "
              f"{lbfgs_ms:.2f} ms (round wall / iterations, logging and "
              f"checkpoints included); dense BFGS (phase 15) {bfgs_ms:.2f} "
              f"ms")
        with tempfile.TemporaryDirectory() as td:
            ref = lbfgs_case(td, "cpu")
        hr = ref.pb.history
        if hr.iters != h.iters:
            raise AssertionError(f"card and CPU log at other iterations "
                                 f"({h.iters} / {hr.iters})")
        head = [i for i, r in enumerate(hr.rounds_idx)
                if r == 1 or hr.iter_round[i] <= LBFGS_HEAD_ITERS]
        lb_head = rel_dev(hr, h, head)
        lb_all = rel_dev(hr, h, list(range(len(h.iters))))
        lb_final = abs(h.loss_global[-1] / hr.loss_global[-1] - 1.0)
        print(f"  loss_global {h.loss_global[i_lb[0]]:.6e} -> "
              f"{h.loss_global[-1]:.6e}; against the plain versions on the "
              f"CPU: Adam + L-BFGS iterations 0-{LBFGS_HEAD_ITERS} "
              f"{lb_head:.2e}, every log {lb_all:.2e}, final global loss "
              f"{lb_final:.2e} apart (CPU {hr.loss_global[-1]:.6e}, "
              f"{ref.pb.lbfgs_counts})")
        if lb_head > HISTORY_BAR or lb_final > FINAL_LOSS_BAR:
            raise AssertionError("card and CPU L-BFGS histories disagree")
        with tempfile.TemporaryDirectory() as td, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            drv_b = lbfgs_case(td, "cuda", second_round="none")
            drv_b.pb.callbacks.clear()
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                minimize(drv_b.pb, "jax", "L-BFGS", num_epochs=LBFGS_ITERS)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        lb_syncs = sum("synchroniz" in str(w.message) for w in caught)
        same = np.array_equal(logs(drv_b.pb.history), logs(h))
        print(f"  repeat from the same state bit-identical: {same}; host "
              f"synchronisations in the round (sync debug mode) {lb_syncs}, "
              f"{lb_syncs / n_it:.2f} per iteration (line-search flags "
              f"{lb_trials:.2f}, logged evaluations {len(i_lb) / n_it:.2f})")
        if not same:
            dev_b = np.max(np.abs(logs(drv_b.pb.history) - logs(h)))
            raise AssertionError(f"repeat differs by {dev_b:.3e}")
        with tempfile.TemporaryDirectory() as td:
            drv_c = lbfgs_case(td, "cuda", second_round="none")
            drv_c.pb.callbacks.clear()
            minimize(drv_c.pb, "jax", "L-BFGS", num_epochs=LBFGS_ITERS,
                     timed=True)
        iter_times = drv_c.pb.lbfgs_times[1:]
        lb_split = {k: 1e3 * float(np.median([t[k] for t in iter_times]))
                    for k in ("direction", "evaluations")}
        lb_split["round wall per iteration"] = (
            1e3 * drv_c.pb.history.wall_times[1] / n_it)
        timed_same = np.array_equal(logs(drv_c.pb.history), logs(h))
        print("  iteration split (device synchronised at each boundary, "
              "median of iterations 2-" + str(LBFGS_ITERS) + "), ms: "
              + ", ".join(f"{k} {v:.3f}" for k, v in lb_split.items())
              + f"; timed round bit-identical too: {timed_same}")
        if not timed_same:
            raise AssertionError("the timed round differs")
        record["lbfgs_slice"] = {
            "launches": lbfgs_launches, "counts": counts,
            "wall_s": lbfgs_wall, "ms_per_iteration": lbfgs_ms,
            "bfgs_ms_per_iteration": bfgs_ms,
            "trials_per_iteration": lb_trials,
            "kernel1_per_iteration": k1 / n_it,
            "syncs_per_iteration": lb_syncs / n_it, "split_ms": lb_split,
            "dev_head": lb_head, "dev_all": lb_all,
            "final_loss_rel": lb_final, "loss_first": h.loss_global[i_lb[0]],
            "loss_last": h.loss_global[-1]}

    with phase("20 the slice at full width: colliding flow, Adam 100 + "
               "BFGS 20; Poisson L-BFGS"):
        from tpinn_torch.cases import colliding_flow

        cf = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drv = colliding_flow.main(td, adam_epochs=100, device=device,
                                          epochs=COLLIDING_ITERS)
                torch.cuda.synchronize()
                cf[device] = (drv, dict(mb.LAUNCHES),
                              time.perf_counter() - t0,
                              sorted(os.listdir(drv.folder)))
        (cf_gpu, cf_launches, cf_wall, cf_files), (cf_cpu, _, cf_cpu_wall,
                                                  _) = cf["cuda"], cf["cpu"]
        hc, hcr = cf_gpu.pb.history, cf_cpu.pb.history
        cc = cf_gpu.pb.bfgs_counts
        names = [l.name for l in cf_gpu.losses]
        d_cf = rel_dev(hcr, hc, list(range(len(hc.iters))))
        d_cf_final = abs(hc.loss_global[-1] / hcr.loss_global[-1] - 1.0)
        cf_ms = 1e3 * hc.wall_times[1] / cc["iterations"]
        print(f"  losses {names}; launches {cf_launches}; {cc}; variant "
              f"{cf_gpu.pb.last_opt_state['kind']}; loss_global "
              f"{hc.loss_global[0]:.6e} -> {hc.loss_global[-1]:.6e}; "
              f"against the CPU: every log {d_cf:.2e}, final global loss "
              f"{d_cf_final:.2e} apart; BFGS {cf_ms:.2f} ms per iteration; "
              f"wall {cf_wall:.2f} s (CPU {cf_cpu_wall:.2f} s); final test "
              f"losses {cf_gpu.final_test_losses()}; files {cf_files}")
        if (hc.round_names != ["keras_Adam", "jax_BFGS"]
                or names[-1] != "Fit_p" or hc.iters != hcr.iters
                or cf_launches["ns_residual_bwd"] != 100 + cc["evaluations"]
                or cf_launches["ns_residual_fwd"] != len(hc.iters)
                or not np.isfinite(logs(hc)).all()
                or not hc.loss_global[-1] < hc.loss_global[0]
                or d_cf > HISTORY_BAR or d_cf_final > FINAL_LOSS_BAR):
            raise AssertionError("colliding flow round failed")
        if not {"History_Loss.json", "Model.json", "Test_Options.txt",
                "checkpoint.pkl"} <= set(cf_files):
            raise AssertionError(f"colliding flow artifacts {cf_files}")
        runs = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                runs[device] = (poisson.main(POISSON_LBFGS_ITERS, out_dir=td,
                                             device=device,
                                             second_round="jax")[0],
                                dict(mb.LAUNCHES))
        (pl_gpu, p_lbfgs_launches), (pl_cpu, _) = runs["cuda"], runs["cpu"]
        hpl = pl_gpu.history
        d_pl = rel_dev(pl_cpu.history, hpl, list(range(len(hpl.iters))))
        plc = pl_gpu.lbfgs_counts
        pl_ms = 1e3 * hpl.wall_times[1] / POISSON_LBFGS_ITERS
        print(f"  Poisson L-BFGS: launches {p_lbfgs_launches}; {plc}; "
              f"loss_global {hpl.loss_global[0]:.6e} -> "
              f"{hpl.loss_global[-1]:.6e}; against the CPU: max rel "
              f"deviation of every log {d_pl:.2e}; {pl_ms:.2f} ms per "
              f"iteration")
        if (p_lbfgs_launches["poisson_residual_bwd"] != 100 + plc["evaluations"]
                or p_lbfgs_launches["poisson_residual_fwd"] != len(hpl.iters)
                or hpl.round_names != ["keras_Adam", "jax_L-BFGS"]
                or d_pl > HISTORY_BAR):
            raise AssertionError("Poisson L-BFGS round failed")
        record["colliding"] = {
            "launches": cf_launches, "counts": cc, "dev": d_cf,
            "final_loss_rel": d_cf_final, "ms_per_iteration": cf_ms,
            "wall_s": cf_wall, "cpu_wall_s": cf_cpu_wall,
            "test_losses": cf_gpu.final_test_losses(), "files": cf_files}
        record["poisson_lbfgs"] = {"launches": p_lbfgs_launches,
                                   "counts": plc, "dev": d_pl,
                                   "ms_per_iteration": pl_ms}

    with phase("21 the cosine-decay Adam second round, 100 epochs"):
        cos = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                cos[device] = (poiseuille_flow.main(
                    td, adam_epochs=0, device=device, second_round="adam",
                    epochs=COSINE_EPOCHS), dict(mb.LAUNCHES))
        (cos_gpu, cos_launches), (cos_cpu, _) = cos["cuda"], cos["cpu"]
        hk = cos_gpu.pb.history
        d_cos = rel_dev(cos_cpu.pb.history, hk, list(range(len(hk.iters))))
        cos_ms = 1e3 * hk.wall_times[1] / COSINE_EPOCHS
        print(f"  rounds {hk.round_names}; launches {cos_launches}; "
              f"loss_global {hk.loss_global[0]:.6e} -> "
              f"{hk.loss_global[-1]:.6e}; against the CPU: max rel "
              f"deviation of every log {d_cos:.2e}; {cos_ms:.2f} ms per "
              f"epoch (round wall, logging included)")
        if (hk.round_names != ["keras_Adam", "keras_Adam"]
                or cos_launches["ns_residual_bwd"] != COSINE_EPOCHS
                or d_cos > HISTORY_BAR
                or not hk.loss_global[-1] < hk.loss_global[0]):
            raise AssertionError("cosine Adam round failed")
        record["cosine_adam"] = {"launches": cos_launches, "dev": d_cos,
                                 "ms_per_epoch": cos_ms}

    with phase("22 the slice at full width: Cavity_Unsteady, Adam 100 + "
               "BFGS 20, float64"):
        import warnings

        from tpinn_torch import utils
        from tpinn_torch.cases import cavity_unsteady
        from tpinn_torch.losses import PrecomputedMeanSquares
        from tpinn_torch.oracles import cavity, generate

        # the exact data: the cavity oracle on the card at the case's size
        # (n = 100, 100 output steps of 5 projection steps), its host
        # synchronisations counted by the oracle and by torch's debug mode;
        # the regular-grid csv that the generator also writes (host numpy,
        # not read by this case) is timed apart and left out of the
        # oracle's seconds, which keep their meaning of PR 11
        cg = cavity.CGCounts()
        # the series stays in the work folder for phase 27
        td = os.path.join(work.name, "unsteady")
        write_csv, csv_s = generate._write_unsteady_regular_csv, []

        def timed_csv(*args):
            t = time.perf_counter()
            write_csv(*args)
            csv_s.append(time.perf_counter() - t)

        generate._write_unsteady_regular_csv = timed_csv
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            try:
                exact = cavity_unsteady.load_exact(td, device="cuda",
                                                   counts=cg)
            finally:
                torch.cuda.set_sync_debug_mode("default")
                generate._write_unsteady_regular_csv = write_csv
            oracle_s = time.perf_counter() - t0 - sum(csv_s)
        oracle_syncs = sum("synchroniz" in str(w.message) for w in caught)
        cg_its = cg.iterations()
        n_xy = 101 ** 2
        if len(csv_s) != 1:
            raise AssertionError(f"regular-grid csv written {len(csv_s)} "
                                 "times")
        print(f"  oracle on the card: {oracle_s:.2f} s for {len(cg_its)} "
              f"projection steps (the regular-grid csv apart: "
              f"{csv_s[0]:.2f} s); CG iterations per step mean "
              f"{np.mean(cg_its):.1f}, max {max(cg_its)}, total "
              f"{sum(cg_its)}; host reads {cg.syncs} (sync debug mode "
              f"{oracle_syncs}), {cg.syncs / len(cg_its):.2f} per step")
        if (len(cg_its) != 500 or max(cg_its) >= cavity.CG_MAXITER
                or any(a.shape != (100 * n_xy,) for a in exact)
                or not all(np.isfinite(a).all() for a in exact)
                or np.max(exact[0][99 * n_xy:]) != 1.0
                or np.any(exact[0][:n_xy] != 0.0)):
            raise AssertionError("cavity oracle on the card failed")

        cav = {}
        for device in ("cuda", "cpu"):
            with tempfile.TemporaryDirectory() as td:
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                drv = cavity_unsteady.main(
                    epochs=CAVITY_ITERS, base_dir=td, second_round="scipy",
                    seed=0, device=device, adam_epochs=100,
                    exact_data=exact, dtype=torch.float64)
                torch.cuda.synchronize()
                cav[device] = (drv, dict(mb.LAUNCHES),
                               time.perf_counter() - t0,
                               sorted(os.listdir(drv.folder)))
        (cv_gpu, cav_launches, cv_wall, cv_files), (cv_cpu, _, cv_cpu_wall,
                                                    _) = cav["cuda"], cav["cpu"]
        hv, hvr = cv_gpu.pb.history, cv_cpu.pb.history
        cvc = cv_gpu.pb.bfgs_counts
        i_adam = [i for i, r in enumerate(hv.rounds_idx) if r == 1]
        d_cv_adam = rel_dev(hvr, hv, i_adam)
        d_cv = rel_dev(hvr, hv, list(range(len(hv.iters))))
        d_cv_final = abs(hv.loss_global[-1] / hvr.loss_global[-1] - 1.0)
        cv_adam_ms = 1e3 * hv.wall_times[0] / 100
        cv_bfgs_ms = 1e3 * hv.wall_times[1] / cvc["iterations"]
        fused = all(isinstance(l, PrecomputedMeanSquares)
                    for l in cv_gpu.losses[:3])
        print(f"  losses {[l.name for l in cv_gpu.losses]}; widths "
              f"{cv_gpu.model.layer_sizes}; fused PDE losses {fused}; "
              f"launches {cav_launches}; {cvc}; variant "
              f"{cv_gpu.pb.last_opt_state['kind']}; loss_global "
              f"{hv.loss_global[0]:.6e} -> {hv.loss_global[-1]:.6e}; against "
              f"the CPU: Adam logs {d_cv_adam:.2e}, every log (BFGS "
              f"iterations 0-{CAVITY_ITERS}) {d_cv:.2e}, final global loss "
              f"{d_cv_final:.2e} apart; {cv_adam_ms:.2f} ms per Adam epoch, "
              f"{cv_bfgs_ms:.2f} ms per BFGS iteration; wall {cv_wall:.2f} s "
              f"(CPU {cv_cpu_wall:.2f} s); final test losses "
              f"{cv_gpu.final_test_losses()}; files {cv_files}")
        if (hv.round_names != ["keras_Adam", "jax_BFGS"] or not fused
                or cv_gpu.model.layer_sizes != (3, 32, 32, 32, 3)
                or hv.iters != hvr.iters
                or cav_launches["ns_residual_bwd"] != 100 + cvc["evaluations"]
                or cav_launches["ns_residual_fwd"] != len(hv.iters)
                or cav_launches["taylor_bundle"]
                or not np.isfinite(logs(hv)).all()
                or not hv.loss_global[-1] < hv.loss_global[0]
                or d_cv_adam > HISTORY_BAR or d_cv > HISTORY_BAR
                or d_cv_final > FINAL_LOSS_BAR):
            raise AssertionError("Cavity_Unsteady round failed")
        want = {"History_Loss.json", "Model.json", "Test_Options.txt",
                "checkpoint.pkl"}
        if utils.has_module("matplotlib"):
            want |= {f"Graphic_{i}_of_5.jpg" for i in range(1, 6)}
        if not (want <= set(cv_files) and ({"Weights.npz", "Weights.h5"}
                                            & set(cv_files))):
            raise AssertionError(f"Cavity_Unsteady artifacts {cv_files}")
        record["cavity_unsteady"] = {
            "oracle_s": oracle_s, "csv_write_s": csv_s[0],
            "oracle_steps": len(cg_its),
            "cg_iterations": sum(cg_its), "cg_max": max(cg_its),
            "oracle_syncs": cg.syncs, "oracle_syncs_debug": oracle_syncs,
            "launches": cav_launches, "counts": cvc,
            "dev_adam": d_cv_adam, "dev": d_cv, "final_loss_rel": d_cv_final,
            "ms_per_adam_epoch": cv_adam_ms, "ms_per_bfgs_iteration":
            cv_bfgs_ms, "wall_s": cv_wall, "cpu_wall_s": cv_cpu_wall,
            "test_losses": cv_gpu.final_test_losses(), "files": cv_files}

    with phase("23 the cavity oracle, card against CPU, n = 32, 20 steps"):
        runs = {}
        for device in ("cuda", "cpu"):
            cg = cavity.CGCounts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cavity.solve_cavity_unsteady(n=32, t_end=2e-3, dt_out=1e-4,
                                               device=device, counts=cg)
            runs[device] = (out, cg.iterations(), time.perf_counter() - t0)
        ((tg, snaps_g), its_g, s_g), ((tc, snaps_c), its_c, s_c) = (
            runs["cuda"], runs["cpu"])
        d_or = max(float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)),
                                                      1e-300))
                   for sc, sg in zip(snaps_c, snaps_g) for a, b in zip(sc, sg))
        print(f"  card {s_g:.2f} s, CPU {s_c:.2f} s; CG iterations equal: "
              f"{its_g == its_c} ({sum(its_g)} in {len(its_g)} solves); max "
              f"|Δ| / max|field| {d_or:.2e}")
        if (its_g != its_c or len(its_g) != 20 or d_or > ORACLE_BAR
                or not np.array_equal(tg, tc)):
            raise AssertionError("cavity oracle card vs CPU failed")
        record["cavity_oracle"] = {"dev": d_or, "cg_iterations": sum(its_g),
                                   "card_s": s_g, "cpu_s": s_c}

    with phase("24 the roofline probe: five bodies vs plain, SASS, rates"):
        from tpinn_torch.kernels import roofline_probe as rp

        probe_err = {b: 0.0 for b in rp.BODIES}
        for dtype, bar in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for S in rp.STREAMS:
                for C in rp.CHUNKS:
                    w, s = rp.inputs(S, C, 7, dtype, dev, seed=S + C)
                    for body in rp.BODIES:
                        got = rp.probe(body, w, s, PROBE_CHECK_REPS)
                        ref = rp.PLAIN[body](w, s, PROBE_CHECK_REPS)
                        scale = float(ref.abs().max())
                        err = float((got - ref).abs().max())
                        if (err > bar * scale or not torch.equal(
                                rp.probe(body, w, s, PROBE_CHECK_REPS), got)):
                            raise AssertionError(
                                f"probe {body} {dtype} S {S} C {C}: max "
                                f"|Δ| {err:.3e} of max|ref| {scale:.3e}")
                        if dtype == torch.float64:
                            probe_err[body] = max(probe_err[body], err)
        print(f"  every body against its plain version (S 5, 6; C 8, 16, "
              f"32; {PROBE_CHECK_REPS} reps): max |Δ| float64 {probe_err}")
        sass = rp.sass_counts(build.last_build().paths["roofline_probe.cu"]
                              if build.last_build() else
                              build.build().paths["roofline_probe.cu"])
        if sass is not None:
            bad = {k: rp.sass_problems(k, v) for k, v in sass.items()
                   if rp.sass_problems(k, v)}
            print("  SASS per instance (DMMA, DFMA, FFMA, HMMA), S 5, C 8: "
                  + "; ".join(f"{k[0]} {k[1]}: {v}" for k, v in sass.items()
                              if k[2] == 5 and k[3] == 8))
            if bad or len(sass) != len(rp.BODIES) * 2 * 2 * 3:
                raise AssertionError(f"probe SASS not as expected: {bad}")
        else:
            print("  no cuobjdump: SASS not counted")
        chunk = rp.default_chunk()
        rp.reset_launch_counts()
        probe_rows = {}
        for dname in ("float64", "float32"):
            for S in rp.STREAMS:
                for body in rp.BODIES:
                    r = rp.measure(body, getattr(torch, dname), S, chunk,
                                   PROBE_REPS, PROBE_OUTER, repeats=3)
                    probe_rows[(body, dname, S)] = r
                    print("  " + json.dumps(r))
        probe_launches = dict(rp.LAUNCHES)
        for (body, dname, S), r in probe_rows.items():
            if body != "tanh_elems" and r["rate_per_sec"] > PEAK_FLOPS[dname]:
                raise AssertionError(f"probe {body} {dname} reads an "
                                     f"impossible rate {r['rate_per_sec']}")

        def probe_rate(body, S=5):
            return probe_rows[(body, "float64", S)]["rate_per_sec"]

        # each kernel's operations split into products (the layer products
        # at the fwd_dot rate, the dW contractions at the gram_dot rate),
        # tanh elements and the other elementwise work (at the vpu_fma rate),
        # over the probe's float64 rates at the kernel's stream count
        def attainable_ms(work_split, n, S):
            return 1e3 * n * (work_split["dot"] / probe_rate("fwd_dot", S)
                              + work_split["gram"] / probe_rate("gram_dot", S)
                              + work_split["fma"] / probe_rate("vpu_fma", S)
                              + work_split["tanh"]
                              / probe_rate("tanh_elems", S))

        attain = {
            "ns_residual_bwd": attainable_ms(
                ns_work_split((2,) + WIDTHS + (3,), 2, True), 1000, 5),
            "ns_residual_fwd": attainable_ms(
                ns_work_split((2,) + WIDTHS + (3,), 2, False), 1000, 5),
            "poisson_residual_bwd": attainable_ms(
                poisson_work_split(POISSON_WIDTHS, True), 200, 5),
            "poisson_residual_fwd": attainable_ms(
                poisson_work_split(POISSON_WIDTHS, False), 200, 5),
            "taylor_bundle": attainable_ms(
                bundle_work_split((2,) + WIDTHS + (3,), 2), 1000, 5),
            "ns_residual_bwd d_in 3, n 10000": attainable_ms(
                ns_work_split((3,) + WIDTHS + (3,), 3, True), 10_000, 6),
        }
        print("  attainable bound at the main shapes from the probe's "
              "float64 rates, ms: " + ", ".join(f"{k} {v:.5f}"
                                                 for k, v in attain.items()))
        # the plain versions' time for one launch's work, on the card
        plain_ms = {}
        for body in rp.BODIES:
            w, s = rp.inputs(5, chunk, rp.TILES, torch.float64, dev)
            plain_ms[body] = cuda_ms(
                lambda: rp.PLAIN[body](w, s, PROBE_REPS), 1, reps=3,
                warmup=1)
        print(f"  plain versions, ms per launch's work (float64, S 5): "
              f"{plain_ms}")
        record["roofline_probe"] = {
            "rows": [dict(r) for r in probe_rows.values()],
            "errors": probe_err, "sass": {" ".join(map(str, k)): v for k, v
                                          in (sass or {}).items()},
            "attainable_ms": attain, "plain_ms": plain_ms,
            "launches": probe_launches}

    with phase("25 the steady oracle on the card: n_solver 128, U 500, "
               f"t_end cut to {STEADY_T_END}"):
        from tpinn_torch.oracles import generate
        from tpinn_torch.oracles import io as oio

        # the march of examples/Cavity_Steady (n_solver 128, t_end 40) cut
        # to its first blocks of 50 projection steps; its full length from
        # the same dt rule as the oracle's
        h = 1.0 / 128
        dt_s = 0.4 * min(h, 0.25 * h * h * 500.0)
        full_steps = (int(40.0 / dt_s / 50) + 1) * 50
        steady_data = os.path.join(work.name, "steady", "data")
        cg = cavity.CGCounts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        folder = generate.generate_cavity_steady(
            steady_data, U=500.0, n_solver=128, t_end=STEADY_T_END,
            device="cuda", counts=cg)
        steady_s = time.perf_counter() - t0
        st_its = cg.iterations()
        n_steps = len(st_its)
        extrap_s = steady_s / n_steps * full_steps
        st_files = sorted(os.listdir(folder))
        u_s, v_s, p_s = oio.read_fields(oio.find_steady_path(folder))
        print(f"  {n_steps} projection steps (of the full march's "
              f"{full_steps}, dt {dt_s:.6e}) in {steady_s:.2f} s, "
              f"{1e3 * steady_s / n_steps:.2f} ms per step; CG iterations "
              f"per step mean {np.mean(st_its):.1f}, max {max(st_its)}, "
              f"total {sum(st_its)}, {1e3 * steady_s / sum(st_its):.3f} ms "
              f"per iteration; host reads {cg.syncs} "
              f"({cg.syncs / n_steps:.2f} per step); extrapolated full "
              f"march {extrap_s:.0f} s ({extrap_s / 60:.1f} min); files "
              f"{st_files}")
        if (n_steps != int(STEADY_T_END / dt_s / 50 + 1) * 50
                or max(st_its) >= cavity.CG_MAXITER
                or u_s.shape != (101 ** 2,)
                or not all(np.isfinite(a).all() for a in (u_s, v_s, p_s))
                or abs(np.max(u_s) - 500.0) > 1e-9
                or not {generate.STEADY_CSV, generate.STEADY_RANDOM_CSV}
                <= set(st_files)):
            raise AssertionError("steady oracle on the card failed")
        # card against CPU at n_solver 32 over one block of 50 steps
        runs = {}
        for device in ("cuda", "cpu"):
            cg = cavity.CGCounts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f = generate.generate_cavity_steady(
                os.path.join(work.name, f"steady32_{device}"), U=500.0,
                n_solver=32, t_end=0.5, device=device, counts=cg)
            runs[device] = (f, cg.iterations(), time.perf_counter() - t0)
        (fg, its_g, s_g), (fc, its_c, s_c) = runs["cuda"], runs["cpu"]
        pairs = list(zip(oio.read_fields(oio.find_steady_path(fc)),
                         oio.read_fields(oio.find_steady_path(fg))))
        for name in (generate.STEADY_CSV, generate.STEADY_RANDOM_CSV):
            cc = oio.read_regular_csv(os.path.join(fc, name))
            cgp = oio.read_regular_csv(os.path.join(fg, name))
            pairs += [(cc[k], cgp[k]) for k in cc]
        d_st = max(float(np.max(np.abs(a - b)) / max(np.max(np.abs(a)),
                                                      1e-300))
                   for a, b in pairs)
        print(f"  n_solver 32, 50 steps: card {s_g:.2f} s, CPU {s_c:.2f} s; "
              f"CG iterations equal: {its_g == its_c} ({sum(its_g)} in "
              f"{len(its_g)} solves); fields and csv values max |Δ| / max "
              f"{d_st:.2e}")
        if its_g != its_c or len(its_g) != 50 or d_st > ORACLE_BAR:
            raise AssertionError("steady oracle card vs CPU failed")
        record["steady_oracle"] = {
            "t_end": STEADY_T_END, "steps": n_steps, "full_steps": full_steps,
            "seconds": steady_s, "cg_iterations": sum(st_its),
            "cg_mean": float(np.mean(st_its)), "cg_max": max(st_its),
            "syncs": cg.syncs, "extrapolated_full_s": extrap_s,
            "dev_32": d_st, "card_32_s": s_g, "cpu_32_s": s_c}

    with phase("26 the slice at full width: Cavity_Steady, Adam 100 + "
               f"BFGS {STEADY_ITERS}, float64"):
        from tpinn_torch.cases import cavity_steady

        st = {}
        for device in ("cuda", "cpu"):
            base = os.path.join(work.name, f"cavity_steady_{device}")
            os.makedirs(base)
            os.symlink(steady_data, os.path.join(base, "data"))
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drv = cavity_steady.main(epochs=STEADY_ITERS, base_dir=base,
                                     device=device)
            torch.cuda.synchronize()
            st[device] = (drv, dict(mb.LAUNCHES), time.perf_counter() - t0,
                          sorted(os.listdir(drv.folder)))
        (cs_gpu, cs_launches, cs_wall, cs_files), (cs_cpu, _, cs_cpu_wall,
                                                   _) = st["cuda"], st["cpu"]
        hs, hsr = cs_gpu.pb.history, cs_cpu.pb.history
        csc = cs_gpu.pb.bfgs_counts
        i_adam = [i for i, r in enumerate(hs.rounds_idx) if r == 1]
        d_cs_adam = rel_dev(hsr, hs, i_adam)
        d_cs = rel_dev(hsr, hs, list(range(len(hs.iters))))
        d_cs_final = abs(hs.loss_global[-1] / hsr.loss_global[-1] - 1.0)
        cs_adam_ms = 1e3 * hs.wall_times[0] / 100
        cs_bfgs_ms = 1e3 * hs.wall_times[1] / csc["iterations"]
        fused = all(isinstance(l, PrecomputedMeanSquares)
                    for l in cs_gpu.losses[:3])
        opts = cs_gpu.opts
        print(f"  options {vars(opts)}; losses "
              f"{[l.name for l in cs_gpu.losses]}; widths "
              f"{cs_gpu.model.layer_sizes}; fused PDE losses {fused}; "
              f"launches {cs_launches}; {csc}; variant "
              f"{cs_gpu.pb.last_opt_state['kind']}; loss_global "
              f"{hs.loss_global[0]:.6e} -> {hs.loss_global[-1]:.6e}; against "
              f"the CPU: Adam logs {d_cs_adam:.2e}, every log (BFGS "
              f"iterations 0-{STEADY_ITERS}) {d_cs:.2e}, final global loss "
              f"{d_cs_final:.2e} apart; {cs_adam_ms:.2f} ms per Adam epoch, "
              f"{cs_bfgs_ms:.2f} ms per BFGS iteration; wall {cs_wall:.2f} s "
              f"(CPU {cs_cpu_wall:.2f} s); final test losses "
              f"{cs_gpu.final_test_losses()}; files {cs_files}")
        if (hs.round_names != ["keras_Adam", "jax_BFGS"] or not fused
                or cs_gpu.model.layer_sizes != (2, 32, 32, 32, 3)
                or (opts.n_pde, opts.n_bc, opts.n_vel, opts.n_pres,
                    opts.n_test, opts.noise_fit) != (1000, 1000, 100, 1,
                                                     1000, 0.01)
                or hs.iters != hsr.iters
                or cs_launches["ns_residual_bwd"] != 100 + csc["evaluations"]
                or cs_launches["ns_residual_fwd"] != len(hs.iters)
                or cs_launches["taylor_bundle"]
                or not np.isfinite(logs(hs)).all()
                or not hs.loss_global[-1] < hs.loss_global[0]
                or d_cs_adam > HISTORY_BAR or d_cs > HISTORY_BAR
                or d_cs_final > FINAL_LOSS_BAR):
            raise AssertionError("Cavity_Steady round failed")
        if not ({"History_Loss.json", "Model.json", "Test_Options.txt",
                 "checkpoint.pkl"} <= set(cs_files)
                and {"Weights.npz", "Weights.h5"} & set(cs_files)):
            raise AssertionError(f"Cavity_Steady artifacts {cs_files}")
        # a reload of the saved run skips training and gives the same test
        # losses at the same parameters
        test_now = [float(l.raw_value().detach())
                    for l in cs_gpu.losses_test]
        loaded = cavity_steady.main(base_dir=os.path.dirname(cs_gpu.folder),
                                    load_from=cs_gpu.folder, device="cuda")
        test_loaded = [float(l.raw_value().detach())
                       for l in loaded.losses_test]
        print(f"  reload: test losses {test_loaded} (trained {test_now}); "
              f"history kept {loaded.pb.history.loss_global == hs.loss_global}")
        if (test_loaded != test_now
                or loaded.pb.history.loss_global != hs.loss_global):
            raise AssertionError("Cavity_Steady load_from failed")
        record["cavity_steady"] = {
            "launches": cs_launches, "counts": csc, "dev_adam": d_cs_adam,
            "dev": d_cs, "final_loss_rel": d_cs_final,
            "ms_per_adam_epoch": cs_adam_ms,
            "ms_per_bfgs_iteration": cs_bfgs_ms, "wall_s": cs_wall,
            "cpu_wall_s": cs_cpu_wall,
            "test_losses": cs_gpu.final_test_losses(), "files": cs_files}

    with phase("27 the old-style cavity scripts on the card, Adam 100 + "
               f"scipy BFGS {OLD_ITERS}"):
        from tpinn_torch.cases import cavity_steady_csv, cavity_unsteady_old

        def link_files(src, folder):
            os.makedirs(folder)
            for name in os.listdir(src):
                os.symlink(os.path.join(src, name),
                           os.path.join(folder, name))

        unsteady_series = os.path.join(work.name, "unsteady", "UnsteadyCase")
        old = {"cavity_steady_csv": {}, "cavity_unsteady_old": {}}
        for device in ("cuda", "cpu"):
            out = os.path.join(work.name, f"csv_{device}")
            os.makedirs(out)
            os.symlink(steady_data, os.path.join(out, "data"))
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pb, model = cavity_steady_csv.main(
                epochs=OLD_ITERS, press_mode="Mean", out_dir=out,
                save_mode=True, model_name_save="cavity_csv", device=device)
            torch.cuda.synchronize()
            old["cavity_steady_csv"][device] = (
                pb, time.perf_counter() - t0, dict(mb.LAUNCHES))
            if device == "cuda":
                csv_run = (pb, model, out)
            # the old unsteady script on phase 22's series, each file linked
            # (on the card without the regular-grid csv, which it derives)
            out_u = os.path.join(work.name, f"old_{device}")
            link_files(unsteady_series if device == "cuda" else os.path.join(
                work.name, "old_cuda", "data", "UnsteadyCase"),
                os.path.join(out_u, "data", "UnsteadyCase"))
            if device == "cuda":
                os.remove(os.path.join(out_u, "data", "UnsteadyCase",
                                       generate.UNSTEADY_CSV))
                t0 = time.perf_counter()
                generate.generate_cavity_unsteady(os.path.join(out_u, "data"))
                derive_s = time.perf_counter() - t0
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            upb, _ = cavity_unsteady_old.main(
                epochs=OLD_ITERS, out_dir=out_u, device=device,
                save_plots=device == "cuda")
            torch.cuda.synchronize()
            old["cavity_unsteady_old"][device] = (
                upb, time.perf_counter() - t0, dict(mb.LAUNCHES))
        res = {}
        for name, runs in old.items():
            (pb_g, wall_g, launches_g), (pb_c, wall_c, _) = (runs["cuda"],
                                                             runs["cpu"])
            hg, hc = pb_g.history, pb_c.history
            i_adam = [i for i, r in enumerate(hg.rounds_idx) if r == 1]
            n_it = hg.iters[-1] - hg.iters[len(i_adam)]
            res[name] = r = {
                "dev_adam": rel_dev(hc, hg, i_adam),
                "dev": rel_dev(hc, hg, list(range(len(hg.iters)))),
                "final_loss_rel": abs(hg.loss_global[-1]
                                      / hc.loss_global[-1] - 1.0),
                "ms_per_adam_epoch": 1e3 * hg.wall_times[0] / 100,
                "bfgs_iterations": n_it,
                "ms_per_bfgs_iteration": 1e3 * hg.wall_times[1] / n_it,
                "wall_s": wall_g, "cpu_wall_s": wall_c,
                "launches": launches_g,
                "losses": [l.name for l in pb_g.losses],
                "round_names": hg.round_names,
                "loss_first": hg.loss_global[0],
                "loss_last": hg.loss_global[-1]}
            print(f"  {name}: losses {r['losses']}; rounds "
                  f"{r['round_names']}; loss_global {r['loss_first']:.6e} -> "
                  f"{r['loss_last']:.6e}; against the CPU: Adam logs "
                  f"{r['dev_adam']:.2e}, every log {r['dev']:.2e}, final "
                  f"global loss {r['final_loss_rel']:.2e} apart; "
                  f"{r['ms_per_adam_epoch']:.2f} ms per Adam epoch, "
                  f"{r['ms_per_bfgs_iteration']:.2f} ms per BFGS iteration "
                  f"({n_it}); wall {wall_g:.2f} s (CPU {wall_c:.2f} s); "
                  f"kernel launches {launches_g}")
            if (hg.round_names != ["keras_Adam", "scipy_BFGS"]
                    or hg.iters != hc.iters or not 0 < n_it <= OLD_ITERS
                    or any(launches_g.values())
                    or not np.isfinite(logs(hg)).all()
                    or not r["loss_last"] < r["loss_first"]
                    or r["dev_adam"] > HISTORY_BAR or r["dev"] > HISTORY_BAR
                    or r["final_loss_rel"] > FINAL_LOSS_BAR):
                raise AssertionError(f"{name} on the card failed")
        # the save / load round trip on the card
        pb, model, out = csv_run
        _, loaded = cavity_steady_csv.main(
            out_dir=out, load_mode=True, model_name_load="cavity_csv",
            device="cuda", save_plots=False)
        x = torch.rand(1000, 2, dtype=f64, device=dev)
        with torch.no_grad():
            same = torch.equal(loaded(x), model(x))
        saved = sorted(os.listdir(os.path.join(out, "Saved_Model")))
        print(f"  cavity_steady_csv save / load: {saved}, outputs "
              f"bit-identical {same}; the unsteady csv derived from the "
              f"series in {derive_s:.2f} s")
        if not same or "cavity_csv.json" not in saved:
            raise AssertionError("cavity_steady_csv save/load failed")
        record["old_scripts"] = {**res, "derive_csv_s": derive_s}

    with phase("28 the coronary oracle on the card host: the packaged mesh, "
               "the P1-FEM steady solve"):
        import shutil

        from tpinn_torch.oracles import coronary as coro
        from tpinn_torch.oracles import io as oio
        from tpinn_torch.oracles.mesh import read_gmsh

        digests = {"coroParam.msh": coro.sha256(coro.MESH_PATH),
                   "bpoints.npy": coro.sha256(coro.BPOINTS_PATH)}
        if digests != {"coroParam.msh": coro.MESH_SHA256,
                       "bpoints.npy": coro.BPOINTS_SHA256}:
            raise AssertionError(f"packaged coronary files differ: {digests}")
        mesh = read_gmsh(coro.MESH_PATH)
        bp_sizes = {k: len(v) for k, v in
                    oio.load_bpoints(coro.BPOINTS_PATH).items()}
        coro_data = os.path.join(work.name, "coronary_data")
        picard = {}
        t0 = time.perf_counter()
        folder = coro.generate_coronary(coro_data, coro.MESH_PATH,
                                        coro.BPOINTS_PATH, counts=picard)
        oracle_s = time.perf_counter() - t0
        fields_path = coro.steady_fields_path(folder)
        fields = dict(zip("uvp", oio.read_fields(fields_path)))
        norms = {k: (float(np.max(np.abs(a))), float(np.linalg.norm(a)))
                 for k, a in fields.items()}
        norm_dev = max(abs(got / ref - 1.0)
                       for k in "uvp" for got, ref in zip(
                           norms[k], coro.FIELD_NORMS[k]))
        print(f"  mesh {mesh.nodes.shape[0]} nodes, "
              f"{mesh.triangles.shape[0]} triangles, SHA-256 as committed; "
              f"boundary points {bp_sizes}; oracle {oracle_s:.2f} s, "
              f"{picard['picard']} Picard solves, wrote "
              f"{sorted(os.listdir(folder))}; field max|.| / L2 {norms}, "
              f"largest relative deviation from the committed fields' "
              f"{norm_dev:.2e}")
        if (mesh.nodes.shape[0], mesh.triangles.shape[0]) != (10833, 20864) \
                or norm_dev > ORACLE_BAR:
            raise AssertionError("coronary oracle off the committed fields")
        record["coronary_oracle"] = {"seconds": oracle_s,
                                     "picard": picard["picard"],
                                     "norms": norms, "norm_dev": norm_dev,
                                     "layout": os.path.basename(fields_path)}

    with phase("29 the coronary slice at full width: Adam 100 + dense BFGS "
               f"{CORONARY_ITERS}, float64, card and CPU"):
        from tpinn_torch.cases import coronary_flow_steady as cfs

        def coronary_base(name):
            base = os.path.join(work.name, name)
            os.makedirs(base)
            os.symlink(coro_data, os.path.join(base, "data"))
            return base

        co = {}
        for device in ("cuda", "cpu"):
            base = coronary_base(f"coronary_{device}")
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pb, model = cfs.main(CORONARY_ITERS, base_dir=base, device=device)
            torch.cuda.synchronize()
            co[device] = (pb, model, dict(mb.LAUNCHES),
                          time.perf_counter() - t0,
                          os.path.join(base, "Test_Case_#001"))
        (co_pb, co_model, co_launches, co_wall, co_folder), \
            (co_cpu, _, _, co_cpu_wall, _) = co["cuda"], co["cpu"]
        hc, hcr = co_pb.history, co_cpu.history
        i_adam = [i for i, r in enumerate(hc.rounds_idx) if r == 1]
        d_co_adam = rel_dev(hcr, hc, i_adam)
        d_co = rel_dev(hcr, hc, list(range(len(hc.iters))))
        d_co_final = abs(hc.loss_global[-1] / hcr.loss_global[-1] - 1.0)
        coc = co_pb.bfgs_counts
        co_adam_ms = 1e3 * hc.wall_times[0] / 100
        co_bfgs_ms = 1e3 * hc.wall_times[1] / coc["iterations"]
        co_files = sorted(os.listdir(co_folder))
        n_rows = sum(int(l.point_residual[1][0].shape[0])
                     for l in co_pb.losses)
        print(f"  losses {[l.name for l in co_pb.losses]} ({n_rows} residual "
              f"rows); widths {co_model.layer_sizes}; launches "
              f"{co_launches}; {coc}; loss_global {hc.loss_global[0]:.6e} -> "
              f"{hc.loss_global[-1]:.6e}; against the CPU: Adam logs "
              f"{d_co_adam:.2e}, every log (BFGS iterations 0-"
              f"{CORONARY_ITERS}) {d_co:.2e}, final global loss "
              f"{d_co_final:.2e} apart; {co_adam_ms:.2f} ms per Adam epoch, "
              f"{co_bfgs_ms:.2f} ms per BFGS iteration; wall {co_wall:.2f} s "
              f"(CPU {co_cpu_wall:.2f} s, {1e3 * hcr.wall_times[0] / 100:.2f}"
              f" ms per Adam epoch); files {co_files}")
        if (hc.round_names != ["keras_Adam", "jax_BFGS"]
                or co_model.layer_sizes != (2, 32, 32, 32, 3)
                or len(co_pb.losses) != 13
                or len(co_pb.losses[0].point_residual[1][0]) != 3000
                or len(co_pb.losses[-1].point_residual[1][0]) != 50
                or len(co_pb.losses_test[0].fn()) != 2000
                or hc.iters != hcr.iters or any(co_launches.values())
                or not np.isfinite(logs(hc)).all()
                or not hc.loss_global[-1] < hc.loss_global[0]
                or d_co_adam > HISTORY_BAR or d_co > HISTORY_BAR
                or d_co_final > FINAL_LOSS_BAR):
            raise AssertionError("coronary default route failed")
        if not ({"History_Loss.json", "Model.json", "Test_Options.txt",
                 "checkpoint.pkl"} <= set(co_files)
                and {"Weights.npz", "Weights.h5"} & set(co_files)
                and {"sol_pinn.npz", "sol_pinn.h5"} & set(co_files)):
            raise AssertionError(f"coronary artifacts {co_files}")
        record["coronary"] = {
            "launches": co_launches, "counts": coc, "dev_adam": d_co_adam,
            "dev": d_co, "final_loss_rel": d_co_final,
            "ms_per_adam_epoch": co_adam_ms,
            "ms_per_bfgs_iteration": co_bfgs_ms, "wall_s": co_wall,
            "cpu_wall_s": co_cpu_wall, "residual_rows": n_rows,
            "files": co_files}

    with phase(f"30 the LM routes: coronary --resume, LM {CORONARY_LM_ITERS} "
               "(kernel 5 under TPINN_USE_PALLAS=1), and Poisson LM"):
        from tpinn_torch.cases import poisson
        from tpinn_torch.problem import OptimizationProblem

        # every evaluation of the training losses at a parameter state:
        # the stacked residuals and the logged evaluations
        evaluations = []
        real_methods = {name: getattr(OptimizationProblem, name)
                        for name in ("residuals_at", "residuals_flat",
                                     "eval_all")}

        def counted(real):
            def method(self, *args):
                evaluations.append(1)
                return real(self, *args)
            return method

        def coronary_lm(name, device, opt_in, solver="host"):
            base = coronary_base(f"coronary_lm_{name}")
            folder = os.path.join(base, "Test_Case_#001")
            shutil.copytree(co_folder, folder)
            os.environ["TPINN_LM_SOLVER"] = solver
            if opt_in:
                os.environ["TPINN_USE_PALLAS"] = "1"
            for attr, real in real_methods.items():
                setattr(OptimizationProblem, attr, counted(real))
            try:
                evaluations.clear()
                mb.reset_launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pb, _ = cfs.main(CORONARY_LM_ITERS, base_dir=base,
                                 second_round="lm", resume_from=folder,
                                 device=device)
                torch.cuda.synchronize()
                return (pb, time.perf_counter() - t0, dict(mb.LAUNCHES),
                        len(evaluations))
            finally:
                os.environ.pop("TPINN_USE_PALLAS", None)
                os.environ.pop("TPINN_LM_SOLVER", None)
                for attr, real in real_methods.items():
                    setattr(OptimizationProblem, attr, real)

        lm_co = {"opt-in": coronary_lm("opt_in", "cuda", True),
                 "cpu": coronary_lm("cpu", "cpu", True),
                 "opt-in off": coronary_lm("off", "cuda", False)}
        co_lm_pb, co_lm_wall, co_lm_launches, co_lm_evals = lm_co["opt-in"]
        hl = co_lm_pb.history
        others = {k: v for k, v in co_lm_launches.items()
                  if k != "taylor_bundle"}
        print(f"  launches on the main path: {co_lm_launches} over "
              f"{co_lm_evals} evaluations of the training losses; "
              f"{len(co_lm_pb.lm_times)} LM iterations, wall "
              f"{co_lm_wall:.2f} s; rounds {hl.round_names}")
        if (co_lm_launches["taylor_bundle"] != 3 * co_lm_evals
                or not co_lm_evals or any(others.values())):
            raise AssertionError("kernel 5 not launched three times (PDE, "
                                 "OUT1, OUT2) per evaluation, or another "
                                 f"kernel ran: {co_lm_launches}, "
                                 f"{co_lm_evals} evaluations")
        if lm_co["opt-in off"][2]["taylor_bundle"]:
            raise AssertionError("kernel 5 launched with the opt-in off")
        if (hl.round_names != ["keras_Adam", "jax_BFGS", "jax_LM"]
                or not np.isfinite(logs(hl)).all()
                or not hl.loss_global[-1] < hc.loss_global[-1]):
            raise AssertionError("coronary LM round failed")
        co_lm_devs = {}
        for name in ("cpu", "opt-in off"):
            other = lm_co[name][0].history
            if other.iters != hl.iters:
                raise AssertionError(f"{name}: logs at other iterations")
            co_lm_devs[name] = rel_dev(other, hl, list(range(len(hl.iters))))
        co_split = {}
        for name, (pb_, wall_, _, _) in lm_co.items():
            later = pb_.lm_times[1:] or pb_.lm_times
            co_split[name] = {k: float(np.median([t.get(k, 0.0)
                                                  for t in later]))
                              for k in ("residuals", "gram", "download",
                                        "eigh", "accept", "log")}
            co_split[name]["first_s"] = sum(pb_.lm_times[0].values())
            co_split[name]["wall_s"] = wall_
            med = co_split[name]
            print(f"  LM iteration ({name}), median of iterations 2-"
                  f"{len(pb_.lm_times)}, ms: " + ", ".join(
                      f"{k} {1e3 * med[k]:.2f}" for k in
                      ("residuals", "gram", "download", "eigh", "accept",
                       "log")) + f"; first iteration "
                  f"{1e3 * med['first_s']:.1f}; wall {wall_:.2f} s")
        print(f"  loss_global {hl.loss_global[len(hc.iters) - 1]:.6e} -> "
              f"{hl.loss_global[-1]:.6e}; max rel deviation of every log "
              f"against the CPU {co_lm_devs['cpu']:.2e}, against the card "
              f"with the opt-in off {co_lm_devs['opt-in off']:.2e}")
        if max(co_lm_devs.values()) > HISTORY_BAR:
            raise AssertionError(f"coronary LM histories disagree: "
                                 f"{co_lm_devs}")
        # the Poisson case's LM route: the tape PDE loss, no kernel
        plm = {}
        os.environ["TPINN_LM_SOLVER"] = "host"
        try:
            for device in ("cuda", "cpu"):
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    pb, _ = poisson.main(POISSON_LM_ITERS, out_dir=td,
                                         second_round="lm", device=device)
                    torch.cuda.synchronize()
                    plm[device] = (pb, time.perf_counter() - t0,
                                   dict(mb.LAUNCHES))
        finally:
            os.environ.pop("TPINN_LM_SOLVER", None)
        hp, hpr = plm["cuda"][0].history, plm["cpu"][0].history
        d_plm = rel_dev(hpr, hp, list(range(len(hp.iters))))
        p_lm_ms = 1e3 * hp.wall_times[1] / len(plm["cuda"][0].lm_times)
        print(f"  Poisson Adam 100 + LM {POISSON_LM_ITERS}: rounds "
              f"{hp.round_names}, loss_global {hp.loss_global[0]:.6e} -> "
              f"{hp.loss_global[-1]:.6e}; every log against the CPU "
              f"{d_plm:.2e}; {1e3 * hp.wall_times[0] / 100:.2f} ms per Adam "
              f"epoch, {p_lm_ms:.2f} ms per LM iteration; wall "
              f"{plm['cuda'][1]:.2f} s (CPU {plm['cpu'][1]:.2f} s); launches "
              f"{plm['cuda'][2]}")
        if (hp.round_names != ["keras_Adam", "jax_LM"]
                or hp.iters != hpr.iters or d_plm > HISTORY_BAR
                or any(plm["cuda"][2].values())
                or not hp.loss_global[-1] < hp.loss_global[0]):
            raise AssertionError("Poisson LM route failed")
        record["coronary_lm"] = {
            "launches": co_lm_launches, "evaluations": co_lm_evals,
            "devs": co_lm_devs, "split": co_split,
            "loss_first": hl.loss_global[len(hc.iters) - 1],
            "loss_last": hl.loss_global[-1],
            "poisson": {"dev": d_plm, "ms_per_lm_iteration": p_lm_ms,
                        "wall_s": plm["cuda"][1],
                        "cpu_wall_s": plm["cpu"][1]}}

    with phase(f"31 the device damping ladder at full width: coronary LM "
               f"{CORONARY_LM_ITERS} and Poiseuille LM {LM_ITERS}"):
        # the card's default solver ("auto": the ladder), held against the
        # ladder forced on the CPU and against phase 30's host eigh
        lad = {"card": coronary_lm("ladder", "cuda", True, solver="auto"),
               "cpu": coronary_lm("ladder_cpu", "cpu", True,
                                  solver="device")}
        lad_pb, lad_wall, lad_launches, lad_evals = lad["card"]
        host_pb = lm_co["opt-in"][0]
        hd, hh = lad_pb.history, host_pb.history
        others = {k: v for k, v in lad_launches.items()
                  if k != "taylor_bundle"}
        if (lad_pb.lm_solver != "device_ladder"
                or lad["cpu"][0].lm_solver != "device_ladder"):
            raise AssertionError("the ladder did not run: "
                                 f"{lad_pb.lm_solver}, "
                                 f"{lad['cpu'][0].lm_solver}")
        if (lad_launches["taylor_bundle"] != 3 * lad_evals or not lad_evals
                or any(others.values())):
            raise AssertionError("kernel 5 not launched three times per "
                                 f"evaluation: {lad_launches}, {lad_evals} "
                                 "evaluations")
        if lad["cpu"][0].history.iters != hd.iters:
            raise AssertionError("ladder: the CPU logs at other iterations")
        d_lad = rel_dev(lad["cpu"][0].history, hd,
                        list(range(len(hd.iters))))
        lm0 = len(hc.iters) - 1  # the LM round's first log point
        d_lad_host = abs(hd.loss_global[-1] / hh.loss_global[-1] - 1.0)
        rungs = list(lad_pb.lm_rungs)
        later = lad_pb.lm_times[1:] or lad_pb.lm_times
        lad_split = {k: float(np.median([t.get(k, 0.0) for t in later]))
                     for k in ("residuals", "gram", "power", "cholesky",
                               "solve", "candidate", "log")}
        # per rung over iterations 2 on (the first one's include the
        # solver libraries' first calls)
        n_rungs = max(sum(rungs[1:]), 1)
        per_rung = {k: sum(t.get(k, 0.0) for t in later) / n_rungs
                    for k in ("cholesky", "solve", "candidate")}
        lad_ms = 1e3 * float(np.median([sum(t.values()) for t in later]))
        eigh_later = host_pb.lm_times[1:] or host_pb.lm_times
        eigh_ms = 1e3 * float(np.median([sum(t.values())
                                         for t in eigh_later]))
        print(f"  coronary LM {CORONARY_LM_ITERS} on the ladder: launches "
              f"{lad_launches} over {lad_evals} evaluations; rungs per "
              f"iteration {rungs}; loss_global {hd.loss_global[lm0]:.6e} -> "
              f"{hd.loss_global[-1]:.6e} (host eigh "
              f"{hh.loss_global[-1]:.6e}, {d_lad_host:.2e} apart); every "
              f"log against the CPU's ladder {d_lad:.2e}; wall "
              f"{lad_wall:.2f} s (CPU {lad['cpu'][1]:.2f} s)")
        print("  ladder iteration, median of iterations 2-"
              f"{len(lad_pb.lm_times)}, ms: " + ", ".join(
                  f"{k} {1e3 * v:.2f}" for k, v in lad_split.items())
              + f"; per rung: " + ", ".join(
                  f"{k} {1e3 * v:.2f}" for k, v in per_rung.items())
              + f"; iteration {lad_ms:.2f} against the host eigh's "
              f"{eigh_ms:.2f}")
        if (hd.round_names != ["keras_Adam", "jax_BFGS", "jax_LM"]
                or not np.isfinite(logs(hd)).all()
                or not hd.loss_global[-1] < hd.loss_global[lm0]
                or d_lad > HISTORY_BAR or d_lad_host > FINAL_LOSS_BAR):
            raise AssertionError(f"coronary ladder failed: {d_lad:.2e} vs "
                                 f"the CPU, {d_lad_host:.2e} vs host eigh")
        # Poiseuille at phase 11's shape: the ladder against the host eigh
        # at tpinn's own bar (tests/test_lm_fast_gram.py)
        # every evaluation counted as in phase 30's coronary runs
        for attr, real in real_methods.items():
            setattr(OptimizationProblem, attr, counted(real))
        try:
            evaluations.clear()
            pz_pb, pz_wall, pz_launches = lm_round("cuda", True,
                                                   solver="auto")
            pz_evals = len(evaluations)
        finally:
            for attr, real in real_methods.items():
                setattr(OptimizationProblem, attr, real)
        hz, h11 = pz_pb.history, lm_pb.history
        d_pz = float(np.max(np.abs(np.array(hz.loss_global)
                                   - h11.loss_global)
                            / np.array(h11.loss_global)))
        print(f"  Poiseuille LM {LM_ITERS} on the ladder: rungs "
              f"{pz_pb.lm_rungs}; launches {pz_launches} over {pz_evals} "
              f"evaluations; loss_global "
              f"{hz.loss_global[-1]:.6e} (host eigh "
              f"{h11.loss_global[-1]:.6e}), max rel deviation {d_pz:.2e}; "
              f"wall {pz_wall:.2f} s (host eigh {lm_wall:.2f} s)")
        if (pz_pb.lm_solver != "device_ladder" or hz.iters != h11.iters
                or d_pz > LADDER_BAR or not pz_evals
                or pz_launches["taylor_bundle"] != 3 * pz_evals):
            raise AssertionError("Poiseuille ladder failed")
        record["ladder"] = {
            "launches": lad_launches, "evaluations": lad_evals,
            "rungs": rungs, "split_ms": {k: 1e3 * v
                                         for k, v in lad_split.items()},
            "per_rung_ms": {k: 1e3 * v for k, v in per_rung.items()},
            "ms_per_iteration": lad_ms, "eigh_ms_per_iteration": eigh_ms,
            "dev_cpu": d_lad, "final_vs_host": d_lad_host,
            "wall_s": lad_wall, "cpu_wall_s": lad["cpu"][1],
            "poiseuille": {"rungs": pz_pb.lm_rungs, "dev_host": d_pz,
                           "launches": pz_launches, "evaluations": pz_evals,
                           "wall_s": pz_wall,
                           "host_wall_s": lm_wall}}

    with phase("32 LM resume on the card: LM 3 + resume LM 2 against LM 5, "
               "host eigh and ladder"):
        resume_devs = {}
        for solver in ("host", "device"):
            os.environ["TPINN_LM_SOLVER"] = solver
            try:
                with tempfile.TemporaryDirectory() as td:
                    lm_case = lambda base, n, **kw: poiseuille_flow.main(
                        os.path.join(td, base), adam_epochs=0,
                        second_round="lm", epochs=n, device="cuda", **kw)
                    part1 = lm_case("a", 3)
                    part2 = lm_case("a", 2, resume_from=part1.folder)
                    whole = lm_case("b", 5)
            finally:
                os.environ.pop("TPINN_LM_SOLVER", None)
            h2, hw = part2.pb.history, whole.pb.history
            same = (np.array_equal(part2.pb.last_theta64,
                                   whole.pb.last_theta64)
                    and logs(h2)[:, -1].tolist() == logs(hw)[:, -1].tolist())
            d = float(np.max(np.abs(part2.pb.last_theta64
                                    - whole.pb.last_theta64)
                             / np.maximum(np.abs(whole.pb.last_theta64),
                                          1e-300)))
            resume_devs[solver] = d
            print(f"  {solver}: rounds {h2.round_names}, loss_global "
                  f"{h2.loss_global[-1]!r} (resumed) / "
                  f"{hw.loss_global[-1]!r} (straight); bit-identical "
                  f"{same}; max rel deviation of θ {d:.2e}")
            if (h2.round_names != ["keras_Adam", "jax_LM", "jax_LM"]
                    or part2.pb.resume_opt_state is not None
                    or not same):
                raise AssertionError(f"LM resume ({solver}) is not "
                                     "bit-identical")
        record["lm_resume"] = resume_devs

    with phase(f"33 LM's chunked Jacobian: Poisson Adam 100 + LM "
               f"{POISSON_LM_ITERS}, point residuals stripped"):
        from tpinn_torch import optimizers

        def poisson_lm(strip):
            """Poisson as poisson.main builds it, on the card's default
            solver; the normal equations at the LM round's θ0 from a
            problem of their own."""
            gen = torch.Generator().manual_seed(1)
            model = poisson.make_model("cuda", generator=gen)
            pb = poisson.build(model, *poisson.sample_points(gen, model),
                               second_round="lm")
            if strip:
                for loss in pb.losses:
                    loss.point_residual = None
            minimize(pb, "keras", optimizers.Adam(learning_rate=1e-2),
                     num_epochs=poisson.ADAM_EPOCHS)
            probe = OptimizationProblem(model, pb.losses, [])
            minimize(probe, "jax", "LM", num_epochs=0)
            eqs = probe.lm_normal_eqs(probe.get_vector())
            mb.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            minimize(pb, "jax", "LM", num_epochs=POISSON_LM_ITERS)
            torch.cuda.synchronize()
            return pb, eqs, time.perf_counter() - t0, dict(mb.LAUNCHES)

        ch_pb, ch_eqs, ch_wall, ch_launches = poisson_lm(True)
        fg_pb, fg_eqs, fg_wall, _ = poisson_lm(False)
        gram_err = {name: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
                    for name, a, b in (("JTJ", ch_eqs[1], fg_eqs[1]),
                                       ("JTr", ch_eqs[2], fg_eqs[2]))}
        hch, hfg = ch_pb.history, fg_pb.history
        d_ch = rel_dev(hfg, hch, list(range(len(hch.iters))))
        ch_ms = 1e3 * hch.wall_times[1] / len(ch_pb.lm_times)
        fg_ms = 1e3 * hfg.wall_times[1] / len(fg_pb.lm_times)
        ch_gram = 1e3 * float(np.median([t["gram"]
                                         for t in ch_pb.lm_times]))
        fg_gram = 1e3 * float(np.median([t["gram"]
                                         for t in fg_pb.lm_times]))
        print(f"  chunked ({ch_pb.lm_solver}, fast Gram "
              f"{ch_pb.lm_used_fast_gram}) against the fast Gram "
              f"({fg_pb.lm_solver}): JᵀJ / Jᵀr at θ0 "
              f"{gram_err['JTJ']:.2e} / {gram_err['JTr']:.2e} of the "
              f"largest; every log {d_ch:.2e}; ms per LM iteration "
              f"{ch_ms:.2f} (Gram {ch_gram:.2f}) against {fg_ms:.2f} (Gram "
              f"{fg_gram:.2f}); loss_global {hch.loss_global[-1]:.6e}; "
              f"launches {ch_launches}")
        if (ch_pb.lm_used_fast_gram or not fg_pb.lm_used_fast_gram
                or max(gram_err.values()) > 1e-10 or d_ch > HISTORY_BAR
                or hch.iters != hfg.iters or any(ch_launches.values())
                or not hch.loss_global[-1] < hch.loss_global[0]):
            raise AssertionError("chunked Jacobian failed")
        record["chunked"] = {"gram_err": gram_err, "dev": d_ch,
                             "ms_per_iteration": ch_ms,
                             "fast_ms_per_iteration": fg_ms,
                             "gram_ms": ch_gram, "fast_gram_ms": fg_gram,
                             "wall_s": ch_wall, "fast_wall_s": fg_wall}

    with phase(f"34 the float32 split carries: Poiseuille Adam 100 + dense "
               f"BFGS {SPLIT_BFGS_ITERS} + LM {SPLIT_LM_ITERS}, "
               "TPINN_USE_PALLAS=0"):
        from tpinn_torch.driver import StandardNSDriver

        def split_driver(device, td, **kw):
            return StandardNSDriver(
                poiseuille_flow.build_spec(),
                poiseuille_flow.default_options(), base_dir=td,
                save_results=False, seed=0, device=device, **kw)

        real_eigh = np.linalg.eigh

        def split_case(device, theta_bfgs=None, eigh=None):
            """Adam 100 + dense BFGS + LM in float32 on residual losses, or,
            given ``theta_bfgs``, the LM round alone from it; ``eigh(pb,
            JTJ)`` takes the place of the LM loop's host eigh of JᵀJ."""
            os.environ["TPINN_USE_PALLAS"] = "0"
            config.set_dtype(torch.float32)
            if eigh is not None:
                np.linalg.eigh = lambda JTJ: eigh(pb, JTJ)
            try:
                with tempfile.TemporaryDirectory() as td:
                    mb.reset_launch_counts()
                    if theta_bfgs is None:
                        pb = split_driver(device, td, adam_epochs=100,
                                          second_round="jax-bfgs").train(
                            epochs=SPLIT_BFGS_ITERS, callbacks=False)
                        kind = pb.last_opt_state["kind"]
                        lo_bfgs = int(torch.count_nonzero(
                            pb.last_opt_state["carry"][1]))
                    else:
                        drv = split_driver(device, td, adam_epochs=0,
                                           second_round="lm")
                        pb = OptimizationProblem(drv.model, drv.losses,
                                                 drv.losses_test)
                        pb.set_vector(theta_bfgs)
                        kind, lo_bfgs = None, None
                    theta = pb.get_vector()
                    minimize(pb, "jax", "LM", num_epochs=SPLIT_LM_ITERS)
                    launches = dict(mb.LAUNCHES)
            finally:
                np.linalg.eigh = real_eigh
                config.set_dtype(None)
                os.environ.pop("TPINN_USE_PALLAS", None)
            lo_lm = int(np.count_nonzero(pb.last_theta64 - pb.get_vector()))
            return pb, kind, lo_bfgs, lo_lm, launches, theta

        sp = {device: split_case(device) for device in ("cuda", "cpu")}
        sp_pb, sp_kind, lo_bfgs, lo_lm, sp_launches, _ = sp["cuda"]
        cpu_pb, theta_cpu = sp["cpu"][0], sp["cpu"][5]
        hs, hsr = sp_pb.history, cpu_pb.history
        d_sp = {name: rel_dev(hsr, hs, [i for i, r in enumerate(hs.rounds_idx)
                                        if r == k])
                for k, name in ((1, "Adam"), (2, "BFGS"), (3, "LM"))}
        # the LM round on the card from the CPU's BFGS result: the card's
        # own deviation, apart from the float32 rounding it inherits
        same_pb = split_case("cuda", theta_cpu)[0]
        i_lm = [i for i, r in enumerate(hsr.rounds_idx) if r == 3]
        lm_logs = lambda h, sel: np.array(
            [np.array(h.loss_global)[sel]]
            + [np.array(e["log"])[sel] for e in h.losses.values()]
            + [np.array(e["log"])[sel] for e in h.losses_test.values()])
        ref_lm = lm_logs(hsr, i_lm)
        lm_dev = lambda h, ref: float(np.max(np.abs(
            lm_logs(h, list(range(len(h.iters)))) - ref) / np.abs(ref))) \
            if len(h.iters) == ref.shape[1] else float("inf")
        d_sp["LM from the CPU's θ"] = lm_dev(same_pb.history, ref_lm)
        # the witnesses of the LM gap, each LM round from the CPU's θ: the
        # card's loop on the CPU's JᵀJ (taken at the card's θ64), so the
        # two sides decompose the same float32 matrix; then both sides
        # with their own JᵀJ promoted to float64 before the eigh
        config.set_dtype(torch.float32)
        os.environ["TPINN_USE_PALLAS"] = "0"
        try:
            with tempfile.TemporaryDirectory() as td:
                eq_drv = split_driver("cpu", td, adam_epochs=0,
                                      second_round="lm")
                eq_pb = OptimizationProblem(eq_drv.model, eq_drv.losses, [])
                eq_pb.set_vector(theta_cpu)
                minimize(eq_pb, "jax", "LM", num_epochs=0)
        finally:
            config.set_dtype(None)
            os.environ.pop("TPINN_USE_PALLAS", None)
        gram_gaps = []

        def cpu_gram_eigh(pb, JTJ):
            JTJ_cpu = eq_pb.lm_normal_eqs(pb.last_opt_state["theta64"])[1]
            gram_gaps.append(float(np.max(np.abs(JTJ - JTJ_cpu))
                                   / np.max(np.abs(JTJ_cpu))))
            return real_eigh(JTJ_cpu)

        eigh64 = lambda pb, JTJ: real_eigh(JTJ.astype(np.float64))
        fed_pb = split_case("cuda", theta_cpu, eigh=cpu_gram_eigh)[0]
        d_sp["LM on the CPU's JᵀJ"] = lm_dev(fed_pb.history, ref_lm)
        e64 = {device: split_case(device, theta_cpu, eigh=eigh64)[0]
               for device in ("cuda", "cpu")}
        d_sp["LM, JᵀJ in float64 before eigh"] = lm_dev(
            e64["cuda"].history, lm_logs(e64["cpu"].history, list(range(
                len(e64["cpu"].history.iters)))))
        sp_bfgs_ms = 1e3 * hs.wall_times[1] / SPLIT_BFGS_ITERS
        sp_lm_ms = 1e3 * hs.wall_times[2] / len(sp_pb.lm_times)
        lm_med = {k: 1e3 * float(np.median([t.get(k, 0.0)
                                            for t in sp_pb.lm_times[1:]]))
                  for k in ("residuals", "gram", "download", "eigh",
                            "accept")}
        print(f"  the card's float32 JᵀJ against the CPU's at the same θ64, "
              f"of the largest entry: {', '.join(f'{g:.2e}' for g in gram_gaps)}"
              f"; rungs: card {sp_pb.lm_rungs}, from the CPU's θ "
              f"{same_pb.lm_rungs}, on the CPU's JᵀJ {fed_pb.lm_rungs}, "
              f"CPU {cpu_pb.lm_rungs}, float64 eigh card "
              f"{e64['cuda'].lm_rungs} / CPU {e64['cpu'].lm_rungs}")
        print(f"  variant {sp_kind} / {sp['cpu'][1]}; lo channel nonzero in "
              f"{lo_bfgs} of {sp_pb.get_vector().size} parameters after "
              f"BFGS, {lo_lm} after LM; loss_global {hs.loss_global[0]:.6e}"
              f" -> {hs.loss_global[-1]:.6e}; against the CPU, max rel "
              f"deviation: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in d_sp.items())
              + f"; {sp_bfgs_ms:.2f} ms per BFGS iteration, {sp_lm_ms:.2f} "
              f"per LM iteration (" + ", ".join(
                  f"{k} {v:.2f}" for k, v in lm_med.items())
              + f"); rungs {sp_pb.lm_rungs}; launches {sp_launches}")
        if (sp_kind != "bfgs_split" or sp["cpu"][1] != "bfgs_split"
                or not lo_bfgs or not lo_lm or hs.iters != hsr.iters
                or hs.round_names != ["keras_Adam", "jax_BFGS", "jax_LM"]
                or max(d_sp["Adam"], d_sp["BFGS"]) > SPLIT_BAR
                or max(d_sp["LM"], d_sp["LM from the CPU's θ"]) > SPLIT_LM_BAR
                or d_sp["LM on the CPU's JᵀJ"] > SPLIT_LM_FED_BAR
                or any(sp_launches.values())
                or not np.isfinite(logs(hs)).all()
                or not hs.loss_global[-1] < hs.loss_global[0]):
            raise AssertionError(f"float32 split carries failed: {d_sp}")
        record["split"] = {"devs": d_sp, "lo_bfgs": lo_bfgs, "lo_lm": lo_lm,
                           "ms_per_bfgs_iteration": sp_bfgs_ms,
                           "ms_per_lm_iteration": sp_lm_ms,
                           "lm_split_ms": lm_med,
                           "rungs": list(sp_pb.lm_rungs),
                           "gram_gaps": gram_gaps}

    with phase(f"35 the generic operators: vtaylor_bundle on the card, a sin "
               f"net's Poiseuille Adam 100 + LM {GENERIC_LM_ITERS}"):
        from tpinn_torch.models import MLP, Model
        from tpinn_torch.operators import mlp_taylor_batched, vtaylor_bundle

        rng = np.random.default_rng(35)
        tp = random_params(rng, (2, 32, 32, 32, 3), torch.float64, dev)
        tx = torch.tensor(rng.uniform(-1, 1, (1000, 2)), device=dev)
        tanh_net = Model([2, 32, 32, 32, 3], device=dev)
        got = vtaylor_bundle(lambda xi: tanh_net.apply(tp, xi[None, :])[0],
                             tx, 2)
        closed = mlp_taylor_batched(tp, tx, 2)
        gen_err = max(float(torch.max(torch.abs(a - b))
                            / torch.max(torch.abs(b)))
                      for a, b in zip(got, closed))
        print(f"  vtaylor_bundle of a 2-32-32-32-3 tanh net at 1,000 points "
              f"against mlp_taylor_batched: {gen_err:.2e} of the largest")
        if gen_err > 1e-12:
            raise AssertionError("generic bundle disagrees")
        spec = poiseuille_flow.build_spec()
        gn = {}
        os.environ["TPINN_LM_SOLVER"] = "device"
        try:
            for device in ("cuda", "cpu"):
                mb.reset_launch_counts()
                drv = StandardNSDriver(
                    spec, poiseuille_flow.default_options(),
                    base_dir=work.name, save_results=False, seed=0,
                    second_round="lm",
                    adam_epochs=100, device=device)
                # the same widths with sin units, the losses built anew on
                # it: no case takes a sin net
                drv.model = MLP(spec.dim_in, 3, width=spec.width,
                                depth=spec.depth, activation="sin", seed=0,
                                input_extents=spec.extents, dtype=drv.dtype,
                                device=drv.device)
                drv.losses, drv.losses_test = drv._build_losses()
                gn[device] = (drv.train(epochs=GENERIC_LM_ITERS,
                                        callbacks=False),
                              dict(mb.LAUNCHES))
        finally:
            os.environ.pop("TPINN_LM_SOLVER", None)
        gpb, g_launches = gn["cuda"]
        hg, hgr = gpb.history, gn["cpu"][0].history
        d_gen = rel_dev(hgr, hg, list(range(len(hg.iters))))
        g_adam_ms = 1e3 * hg.wall_times[0] / 100
        g_lm_ms = 1e3 * hg.wall_times[1] / len(gpb.lm_times)
        print(f"  sin net: rounds {hg.round_names}, fast Gram "
              f"{gpb.lm_used_fast_gram}, {gpb.lm_solver}; loss_global "
              f"{hg.loss_global[0]:.6e} -> {hg.loss_global[-1]:.6e}; every "
              f"log against the CPU {d_gen:.2e}; {g_adam_ms:.2f} ms per "
              f"Adam epoch (CPU {1e3 * hgr.wall_times[0] / 100:.2f}), "
              f"{g_lm_ms:.2f} per LM iteration; launches {g_launches}")
        if (hg.round_names != ["keras_Adam", "jax_LM"]
                or gpb.model.activation_name != "sin"
                or not gpb.lm_used_fast_gram or hg.iters != hgr.iters
                or d_gen > HISTORY_BAR or any(g_launches.values())
                or not hg.loss_global[-1] < hg.loss_global[0]):
            raise AssertionError("the sin net's generic path failed")
        record["generic"] = {"bundle_err": gen_err, "dev": d_gen,
                             "ms_per_adam_epoch": g_adam_ms,
                             "ms_per_lm_iteration": g_lm_ms}

    with phase(f"36 the sharded slice: Poiseuille on a point mesh of ranks, "
               f"Adam {SHARD_ADAM} + dense BFGS "
               f"{SHARD_ITERS}, Adam {SHARD_ADAM} + L-BFGS {SHARD_ITERS}, "
               f"LM {SHARD_LM_ITERS} (opt-in), against one process"):
        shard_launches, record["sharded"] = sharded_phase(work.name, dev)

    from tpinn_torch.recipes import QUICK as quick

    with phase(f"37 the recipe runner on the card: Poisson Adam 100 + LM "
               f"{quick['poisson_lm']}; Poiseuille Adam {quick['adam']} + "
               f"cosine Adam {quick['cosine']} -> dense BFGS "
               f"{quick['bfgs']} -> LM {quick['lm']} x {quick['lm_repeat']}, "
               f"each stage a process, against the same stages in this "
               f"process"):
        recipe_launches, record["recipes"] = recipes_phase(work.name)

    # launches on each path that runs the kernel, each read around its run;
    # "launches" is the count on the main path of the kernel's slice
    paths = {"4 Poiseuille Adam": launches,
             "8 Poisson Adam + L-BFGS-B": p_launches,
             "11 Poiseuille LM (opt-in)": lm_launches,
             "15 Poiseuille Adam + BFGS": bfgs_launches,
             "17 Poisson Adam + BFGS": p_bfgs_launches,
             "19 Poiseuille Adam + L-BFGS": lbfgs_launches,
             "20 colliding flow Adam + BFGS": cf_launches,
             "20 Poisson Adam + L-BFGS": p_lbfgs_launches,
             "21 Poiseuille cosine Adam": cos_launches,
             "22 Cavity_Unsteady Adam + BFGS (d_in 3)": cav_launches,
             "26 Cavity_Steady Adam + BFGS": cs_launches,
             "29 Coronary Adam + BFGS": co_launches,
             "30 Coronary LM (opt-in)": co_lm_launches,
             "30 Poisson LM": plm["cuda"][2],
             "31 Coronary LM ladder (opt-in)": lad_launches,
             "31 Poiseuille LM ladder (opt-in)": pz_launches,
             "36 sharded": shard_launches,
             "37 recipes": recipe_launches}

    def kernel_row(name, key, route_src, replaces, main, row, n):
        d_ms, per_call, _ = dev_t[(name, n)]
        return {"name": name, "route": "cuda", "source": route_src,
                "replaces": replaces, "launches": main[name],
                "max_abs_err": errs[name], "ms": row[key],
                "plain_ms": row[f"plain_{key}"],
                "bound_ms": row[f"{key}_bound"],
                "bound_by": row[f"{key}_bound_by"], "library_ms": None,
                "device_ms": d_ms, "launches_per_call": per_call,
                "bound_probe_ms": attain[name],
                "launches_by_path": {k: v[name] for k, v in paths.items()
                                     if v[name]}}

    ns_row = times[("ns", "float64", 1000)]
    p_row = times[("poisson", "float64", 200)]
    ns_src = "tpinn_torch/kernels/csrc/ns_residual.cu"
    p_src = "tpinn_torch/kernels/csrc/poisson_residual.cu"
    ref = "tpinn/pallas/mlp_bundle.py"
    kernels = [
        kernel_row("ns_residual_bwd", "bwd", ns_src, f"{ref}:556",
                   bfgs_launches, ns_row, 1000),
        kernel_row("ns_residual_fwd", "fwd", ns_src, f"{ref}:473",
                   bfgs_launches, ns_row, 1000),
        kernel_row("poisson_residual_bwd", "bwd", p_src, f"{ref}:1268",
                   p_launches, p_row, 200),
        kernel_row("poisson_residual_fwd", "fwd", p_src, f"{ref}:1209",
                   p_launches, p_row, 200),
    ]
    b_row = times[("bundle", "float64", 1000)]
    b_dev, b_per_call, _ = dev_t[("taylor_bundle", 1000)]
    kernels.append({
        "name": "taylor_bundle", "route": "cuda",
        "source": "tpinn_torch/kernels/csrc/taylor_bundle.cu",
        "replaces": f"{ref}:235",
        "launches": co_lm_launches["taylor_bundle"],
        "max_abs_err": errs["taylor_bundle"], "ms": b_row["kernel"],
        "plain_ms": b_row["plain"], "bound_ms": b_row["bound"],
        "bound_by": b_row["bound_by"], "library_ms": None,
        "device_ms": b_dev, "launches_per_call": b_per_call,
        "bound_probe_ms": attain["taylor_bundle"],
        "launches_by_path": {k: v["taylor_bundle"] for k, v in paths.items()
                             if v["taylor_bundle"]},
        # the coronary LM route's shapes (phase 30): each outflow and the
        # PDE batch, beside the main shape
        "by_n": {n: {"ms": times[("bundle", "float64", n)]["kernel"],
                     "plain_ms": times[("bundle", "float64", n)]["plain"],
                     "bound_ms": times[("bundle", "float64", n)]["bound"],
                     "device_ms": dev_t[("taylor_bundle", n)][0]}
                 for n in (33, 1000, 3000)}})
    # the probe's bodies: a measurement entry point, on no slice's path;
    # "launches" counts phase 24's rate runs, the times are float64, S 5
    for body in rp.BODIES:
        r = probe_rows[(body, "float64", 5)]
        per = r["tiles"] * r["streams"] * r["width"] * r["chunk"]
        n_ops = rp.work(body, r["chunk"], 5, r["reps"]) * r["tiles"]
        b_ms, b_by = bound(n_ops, 8 * (2 * per + 32 * 32), "float64")
        kernels.append({
            "name": f"roofline_{body}", "route": "cuda", "source": rp.SOURCE,
            "replaces": rp.REPLACES[body],
            "launches": probe_launches[body],
            "max_abs_err": probe_err[body],
            "ms": 1e3 * r["seconds"] / r["outer"], "plain_ms": plain_ms[body],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": (None if r["library_seconds"] is None
                           else 1e3 * r["library_seconds"] / r["outer"]),
            "rate_per_sec": r["rate_per_sec"],
            "launches_by_path": {"24 roofline probe": probe_launches[body]}})
    work.cleanup()
    total = time.perf_counter() - t_all
    print(f"total {total:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"kernels": kernels, **record, "total_s": total}, f,
                      indent=1, default=float)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
