#!/usr/bin/env python3
"""Drive the PyTorch port's smoke, Burgers and tokamak paths on one CUDA card.

Run from the repository root with no arguments: `python3 chip_smoke.py`. It
needs one CUDA card and the CUDA toolkit (nvcc); without a card it exits
non-zero before printing any result, and it has no CPU path. Any phase that
fails ends the run with a non-zero exit.

  1. device: the card's name and power limit, torch version, TF32 flags;
  2. build: kernels K1 (safediffcon_torch/csrc/pressure_cg.cu) and K2, its
     tensor-core form (csrc/conv3d_wgmma.cu) and its SIMT form
     (csrc/conv3d_simt.cu), into build/kernels/, one nvcc each, started
     together;
  3. K1 against its plain PyTorch version on the card at the serving shapes
     (B = 8, 10 and 50 samples of 127^2, warm start, accuracy 1e-6 and 1e-8,
     max_iter 500, convergence checks every 1 and every 32 iterations),
     the residual |A p - div|, and the gradient (a solve of the cotangent);
     K1's cluster layout, how many of its clusters fit on the card at once,
     and us per iteration;
  4. the serving path at the reference model's full width (UNet3D dim 64,
     mults (1, 2, 4), 7 channels, 32 frames of 64^2, seeded weights):
     generate 16 train, 50 cal and 50 test sims with the port's solver (256
     frames at 128^2, CG 1e-6; its phases timed, K1 by CUDA events), then
     SmokePipeline.calibrate on 10 of the cal sims (the script's budget
     cut) and guided evaluate on the 50 test sims with the
     SmokeConformalConfig defaults but DDIM 20 (the reference's 100 cut for
     phases 15 and 14; eta 1, solver 1e-8 / 500, backend "auto" = K1) and the
     pipeline's default chunks, so each runs
     one batch and reports its peak device memory. K1's launch count
     is zeroed just before calibrate and read just after evaluate, and must
     be 255 per evaluated batch;
  5. a small input run on the card and on the CPU (whose path the CPU tests
     hold against the JAX package) with the same weights and noise, in
     float32 without TF32: the metrics must agree;
  6. K2 against its plain PyTorch version on the card at the 10 (H, Cin,
     Cout) of UNet3D's 3x3x3 convs, B = 16, F = 32: the forward and dx
     (through the autograd Function) in 3xTF32 (TF32 off, within 1e-4) and
     in TF32 (TF32 on, within twice cuDNN's own TF32 error + 1e-4 and 5e-3
     of max), dW against autograd of the plain version (TF32 off); in
     bfloat16 (phase 10b's mode) at the same 10 shapes the forward, dx and
     dW through the autograd Function against the plain version and its
     autograd on the same bf16 inputs, within 1e-2 of max; the SIMT kernel
     at one shape; the kernel's, the plain version's and F.conv3d's times
     (TF32, float32, bfloat16) and bounds;
  7. a small pretrain on the card (K2 in 3xTF32) and on the CPU (its plain
     version, which the CPU tests hold against the JAX package) with the
     same weights and draws, TF32 off: the losses must agree; then the same
     with steps_per_call 2 and a device pool (12d);
  8. pretraining at the reference width on K2 (SmokePretrainConfig with
     conv_impl "pallas": batch 16, remat "full", float32, default flags, so
     K2 in TF32) for PRETRAIN_STEPS steps after one warm-up step; K2's
     launch counts are zeroed just before and must read 90 per step on the
     tensor-core kernel and 0 on the SIMT kernel just after;
  9. one posttrain epoch and one InfFT epoch through run_inference from
     the pretrained EMA weights, on 8 cal + 8 test sims with DDIM 10 (the
     reference's 100 cut to keep the script inside its budget; the
     SmokePipeline model, framework conv; K1 in evaluate), then one InfFT
     step at Q = 1, where its loss has a gradient;
 10. UNet3D in bfloat16 compute and with remat "save_heavy":
     10a. two pretrain steps of a small bf16 UNet3D(conv_impl="pallas") on
          the card (K2 in bf16) and on the CPU from the same weights and
          draws: the losses within 1.5e-3, each step's gradients within
          1e-1 (relative L2), the weight updates pointing the
          same way (cosine > 0.9);
     10b. the smoke pretrain at the reference width in bf16 on K2 (batch
          16, remat "full") for 1 + SMOKE_STEPS steps, timed after the
          first; K2's counts are zeroed just before and must read 90
          tensor-core launches per step, all in bf16 mode, and 0 SIMT;
          s per step, K2's share by CUDA events, peak memory;
     10c. the same in float32 (TF32) and in bf16 with "save_heavy";
     10d. SMOKE_STEPS guided DDIM steps of SmokePipeline at B = 50 in float32
          and in bf16 compute: ms per step and peak memory;
 11. the serving path with sampler "dpm" (DPM-Solver++(2M), 25 steps, inside
     the JAX docstring's ~20-50) at phase 4's width, weights and data:
     SmokePipeline.calibrate on 10 of the cal sims and guided evaluate on
     the 50 test sims, each one batch, the solver on K1; K1's launch count
     is zeroed just before calibrate and must read 255 just after evaluate,
     K2's must read 0; seconds per DPM step and peak memory.

The Burgers 1D task (no kernel of the TPU package lies on its path; K1 and
K2 must not launch while B1-B7 run), at the reference "turbo" UNet2D (dim 128,
mults (1, 2, 4, 8), 3 channels, 140,710,147 parameters, seeded weights):

  B1. the FD solver (10 chunks of 1,000 explicit-Euler steps at 128 cells)
      on the card and on the CPU from the same u0 and f, B = 50: within
      1e-5 of max|u|; ms per rollout at B = 50 and at datagen's batch;
      kernel launches per Euler step (torch.profiler);
  B2. datagen: 2,048 train, 1,000 cal and 50 test sims in one solve batch;
  B3. a tiny UNet2D (dim 16) on the card and on the CPU with the same
      weights and draws, TF32 off: calibrate, evaluate, one InfFT step and
      one post-training step must agree;
  B4. serving with the BurgersConformalConfig defaults (DDIM 200, eta 1,
      w_score 500, u_bound 0.8, alpha 0.98): calibrate on the 1,000 cal sims
      (4 x 250 in chunks of 50), guided evaluate on the 50 test sims, both
      float32 at the default flags; then guided sampling of the same 50 in
      bfloat16 compute; ms per guided step, the solver's share of evaluate,
      peak memory, the step's bound from the forward's FLOPs
      (FlopCounterMode) at the TF32 and bf16 peaks, and a torch.profiler
      breakdown of the forward in each dtype (device busy share, kernels
      per forward, the kernels that take the most time);
  B5. pretraining with the BurgersPretrainConfig defaults (batch 16) for 10
      steps after one warm-up step, the loop's set-up timed apart;
  B6. from B5's EMA: posttrain, 2 epochs of 2 steps at batch 380, one
      recalibration, then one evaluate, and the same posttrain on an eager
      pipeline (capture=False) for its seconds and peak memory beside the
      captured one's; InfFT_iters 2 (one step at B = 50, calibrate,
      evaluate); both calibrate on 50 cal sims, all at DDIM 50 (the
      configs' 200);
  B7. the samplers beyond DDIM and two-model composition:
      (a) tiny UNet2Ds (dim 16) on the card and on the CPU with the same
          weights and draws, TF32 off: a two-model (prior_beta 0.5) DPM
          calibrate and guided evaluate (Q-hat and the loss within 1e-4
          relative, J 1e-3, a rate one cell), an ancestral chain of 100
          steps with the guidance at x_{t-1} and self-recurrence (within
          1e-4), one pretrain(model_w=True) step (the loss within 1e-4
          relative, the weights within 2 lr);
      (b) pretrain(model_w=True), the w-only prior, as B5: batch 16, 10
          steps after one warm-up step;
      (c) BurgersPipeline(two_model=True, prior_beta=0.5), the JAX CLI's
          default beta, with B5's EMA as the main model and (b)'s as the
          prior, DDIM 25: calibrate on 50 cal sims, guided
          evaluate on the 50 test sims;
      (d) sampler "dpm", 25 steps, B5's EMA: calibrate on 50 cal sims,
          guided evaluate on the 50 test sims;
      (e) the ancestral sampler through calibrate (ddim_sampling_steps
          = timesteps, B7_E_T = 100 conditioned steps, the reference's
          1,000 cut for phases 16 and 14) on 50 cal sims;
      ms per step and peak memory of each.

Depth cuts of the Burgers phases against the reference: 2,048 train sims
(40,000), 10 pretrain steps (200,000; also the w-prior's), posttrain 2
epochs x 2 steps (5 x 3,200), InfFT 2 iterations (3), B4's and B7(d)'s
calibration, the fine-tuning calibration and B7(c)'s and (e)'s on 50 cal
sims (1,000), B7(c) at DDIM 50 (200; these cuts
keep the whole script inside its
budget).
Widths, DDIM steps, batch sizes and the solver are the reference's.

The tokamak task (no kernel of the TPU package lies on its path; K1 and K2
counts are zeroed before T1 and must read 0 after T7), at the reference
"turbo" UNet1D (dim 128, mults (1, 2, 4, 8), 12 channels, 57,341,452
parameters, seeded weights):

  T1. the KSTAR surrogate on the card and on the CPU: the three reference
      golden rollouts (tests/golden/kstar_reference_rollouts.npz) within
      1e-4 relative; ms per rollout at B = 50 and at datagen's batch, open
      and closed loop; kernel launches per solver step (torch.profiler);
  T2. datagen: 2,048 train, 1,000 cal and 50 test closed-loop trajectories
      in one batch, the rollout and the npz save timed apart;
  T3. a tiny UNet1D (dim 16) on the card and on the CPU with the same
      weights and draws, TF32 off: calibrate, an unguided and a guided
      evaluate, one post-training step and one InfFT step must agree (the
      losses, each step's gradients within 2e-5 relative L2, 99 % of the
      weights within 1e-4 lr after the two steps);
  T4. serving with the TokamakConformalConfig defaults (DDIM 200, eta 1,
      alpha 0.9, threshold 4.98): calibrate on the 1,000 cal sims as one
      chunk (T_CAL_CHUNK; the JAX default chunk is 50), evaluate the 50
      test sims unguided (the default) and guided with guidance_scaler 5;
      ms per step, the surrogate's share of evaluate, peak memory, and a
      torch.profiler breakdown of one forward at B = 50 with its bound from
      its FLOPs (FlopCounterMode) at the TF32 peak;
  T5. pretraining with the TokamakPretrainConfig defaults (batch 16) for 10
      steps after one warm-up step, the loop's set-up timed apart;
  T6. from T5's EMA: run_inference with posttrain_config() for 1 epoch of
      1 step at batch 1,000, and with finetune_config() for 1 epoch of 1
      InfFT step at B = 50, both at DDIM 50 (the configs' 200 and 250), each
      epoch calibrating on 250 of the cal sims in one chunk; peak memory;
  T7. from T5's EMA, sampler "dpm" with 25 steps: calibrate on the 1,000
      cal sims as one chunk, then an unguided evaluate on the 50 test sims;
      ms per step and peak memory.

Depth cuts of the tokamak phases against the reference: 2,048 train
trajectories (48,950), 10 pretrain steps (200,000), posttrain 1 epoch (8),
InfFT 1 epoch (5). Widths, DDIM steps, batch sizes and the surrogate are the
reference's.

The command line (phase 12; `python -m safediffcon_torch.cli.main <task>
<phase>`), with the launch counts zeroed before each part and read after:

 12a. `python3 -m safediffcon_torch.cli.main burgers generate-data` in a
      process of its own (64 train, 50 cal, 50 test sims into
      build/chip_smoke/cli/burgers): exit code 0, and `-X importtime` shows
      no module of JAX or the JAX package imported;
 12b. smoke through `main([...])` in this process, at the reference width:
      generate-data (16 + 8 + 8 sims; K1 255 launches per generated batch);
      a library generate_smoke_dataset with conservation bounds set around
      the median mass ratio of an unfiltered batch of 8: the kept ratios lie
      inside them and sims were regenerated; pretrain --conv-impl pallas
      --steps 2 --steps-per-call 2, then --steps 4 --resume (milestones 2
      and 4; K2 90 tensor-core launches per step, 0 SIMT); a library
      pretrain(steps_per_call=2, device_pool=8, pool_refresh_every=4) of 6
      steps at phase 8's configuration (s per step and peak memory beside
      phase 8's, set-up included in both); eval --ddim-steps 10
      --checkpoints 2:4:2 (K1 255 launches per evaluated chunk per
      milestone, K2 0);
 12c. Burgers (on 12a's data) and tokamak (generate-data 64 + 50 + 50)
      through the command line at their "turbo" widths: pretrain --steps 2
      --steps-per-call 2, eval --ddim-steps 20; K1 and K2 stay idle;
 12d. (in phase 7) a second small pretrain with steps_per_call 2 and a
      bfloat16 device pool of 3 of the 4 sims, card (K2 in 3xTF32) against
      CPU within phase 7's 1e-4.

Depth cut to make room for phase 12: phase 11's calibrate on 25 cal sims
(50 before), B4's and B7(d)'s on 100 (250), B7(c) at DDIM 100 (200).

Data parallelism and frame-axis sequence parallelism (phase 13;
safediffcon_torch/parallel/mesh.py), each run's card count checked and its
backend named in its log line:

 13a. `python -m torch.distributed.run --standalone --nproc_per_node=1
      chip_smoke.py --cli-rank smoke pretrain --steps 2 --conv-impl pallas`
      (12b's data): the rank joins a one-rank NCCL group, all-reduces and
      all-gathers through it, then runs the command line on its card;
      rc 0 and 90 tensor-core K2 launches per step (TF32), 0 SIMT;
 13b-e run on two ranks spawned on the one card over gloo (NCCL refuses two
      ranks on one device; gloo's all-gather and reduce-scatter are
      all-reduces of zero-filled buffers there, exact), TF32 off, each held
      against the same work in this process:
 13b. two smoke pretrain steps at the reference width, global batch 16 (8
      per rank), K2 in 3xTF32, from one seed: the losses within 1e-5
      relative, every weight within 2.5 lr (an Adam first step moves an
      entry with a near-zero gradient by up to 2 lr either way), the
      ranks' weights equal; 90 K2 launches per step on each rank;
 13c. one forward and backward of the reference UNet3D (conv_impl
      "pallas", remat "full", B = 2, seeded weights) split over sp = 2
      frame ranks (K2 on 16 + 2 frames): the output and every weight's
      gradient within 1e-4 of their largest entry; 90 K2 launches per
      rank, 0 SIMT; peak memory per rank against unsharded;
 13d. smoke calibrate on 8 cal sims and guided evaluate on 8 test sims,
      DDIM 10, the reference width, seeded weights: Q-hat within 1e-5
      relative; each rank's rollout on K1 (255 launches per rank, as in one
      process; K1 solves each chunk of up to 8 samples as one system, so the
      metrics agree within 1e-3 relative and a threshold rate within one
      sample); K2 idle;
 13e. Burgers and tokamak calibrate at the turbo widths on 24 cal sims,
      DDIM 5: Q-hat within 1e-5 relative; K1 and K2 idle.
      Times of two ranks sharing one card are a correctness check and say
      nothing of scaling over NVLink; NCCL across cards is phase 17's
      (`--cards 4`, below), which runs 13(b) and 13(d) at dp 4.

Depth cut to make room for phase 13: phase 4's and phase 11's calibrate on
10 cal sims (25 before), phase 9 at DDIM 15 (25).

The round-1 validation runs (phase 14; safediffcon_torch/experiments/
round1.py, the port of the JAX package's experiments/run_*_validation.py):

 14a. K2 in bfloat16 against its plain version (the forward, and dx and dW
      through the autograd Function, within 1e-2 of max, as phase 6) at
      every distinct conv shape of one forward of the smoke recipe's UNet3D
      (dim 32, mults (1, 2), 4 x 32 frames of 64^2) and of its tiny cut
      (dim 8, 2 x 2 frames of 32^2);
 14b. the nine recipes (burgers, burgers_infft, tokamak, smoke,
      smoke_posttrain, burgers_20k, tokamak_refscale, burgers_refscale,
      burgers_dpm_refscale: five sampler arms, each calibration's three
      chunks a warm-up, a capture and a replay as its pipeline counts its
      graphs) at --scale tiny on the card, one
      evaluation per phase, K1 and K2 counts zeroed before each and read
      after: each SUMMARY has exactly the keys of the JAX run's results JSON
      and finite values, and prints its comparison lines; the two smoke
      recipes launch K1 in datagen and in every evaluation (smoke_posttrain:
      in each posttrain and backward fine-tuning epoch's) and K2 in pretrain
      (bf16), the Burgers and tokamak ones neither.

Depth cut to make room for phase 14: 13(e)'s calibrate at DDIM 10 on 24
cal sims (DDIM 20 on 50 before). For its ninth recipe,
burgers_dpm_refscale: phase 4's calibrate and evaluate at DDIM 10 (20
before), B7(c)'s two-model serving at DDIM 25 (50 before), B6's and T6's
epochs at DDIM 50 (the configs' 200 and 250 before), B7(e)'s ancestral
calibration at 100 timesteps (250 before).

Depth cut to make room for phase 15: phase 4's calibrate and evaluate at
DDIM 50 (100 before).

The training chunk as one captured CUDA graph (phase 15;
safediffcon_torch/core/train.py::ChunkGraph, the counterpart of JAX's jitted
step and `lax.scan` chunk), K1 and K2 counts zeroed before and required 0
after:

 15. Burgers turbo UNet2D at the burgers_20k recipe's batch 32 and tokamak
     turbo UNet1D at its recipe's batch 16, both in bf16 compute: for
     steps_per_call 5 and 1 (10 and 1 before phase 16's cut), `pretrain`
     eagerly (capture=False) and with
     its chunks captured, G_STEPS steps each from the same seeded weights
     and generator seed: the losses, the final weights and the EMA must
     be equal bit for bit; steps/s of each over G_TIME, and for
     steps_per_call 1 the device (kernel) time, kernels, kernel launch
     calls and graph launch calls (one per step) per step by
     torch.profiler over G_PROFILE.

The serving and fine-tuning calls as captured CUDA graphs (phase 16; the
pipelines' `capture`, core/train.py::Graphs / StaticCall / CapturedCall,
the counterpart of JAX's jitted _cal_batch, _evaluate, InfFT step and
fine-tuning chunks), K1 and K2 counts zeroed before and required 0 after,
bf16 compute, seeded weights, DDIM S_DDIM (10), Q-hat values that bf16 does not
hold exactly: each case calls an eager pipeline or step (`capture=False`)
once, then a captured one three times: the warm-up (eager, on the static
buffers), the capture on other inputs, draws and Q-hat, and a replay on
the first inputs again (for a step, from the same starting state, restored
in place). The warm-up and the replay must each equal the eager call bit
for bit. Seconds and CUDA-event ms per call, the graph's nodes by type
(kernel, memcpy, memset; libcuda's cuGraphGetNodes), the peak memory of
each arm, and, with `--serving-graphs` only (below), torch.profiler over
one eager call and one replay (at DDIM 4 where the case samples; device ms,
kernels, kernel launch calls, graph launch calls):

 16a. Burgers turbo UNet2D calibrate, 50 cal sims (one chunk);
 16b. Burgers guided evaluate of the 50 test sims with the 10,000-step
      rollout;
 16c. Burgers posttrain, 30 steps at batch 64 in chunks of 10, one epoch,
      eagerly and captured (loss, weights, EMA, AdamW moments);
 16d. Burgers InfFT step at B = 50, Q-hat 1.1-1.6;
 16e. tokamak turbo UNet1D calibrate, 250 cal sims in one chunk;
 16f. tokamak unguided evaluate of the 50 test sims with the KSTAR rollout;
 16g. tokamak post-training step at batch 1,000 (make_finetune_steps);
 16h. tokamak backward fine-tuning step at B = 50 (w_obj 1).

Depth cuts of phase 16: DDIM 10 (the configs' 200; `python3 chip_smoke.py
--serving-graphs` runs phase 16 alone at DDIM 200 on B2's and T2's data,
with each eager arm's second call, a fourth 16c chunk, and the profiler
windows, those of 16b, 16c and 16f holding 50,000-145,000 kernels each and
taking the profiler up to a minute), the tokamak calibration chunk 250
(1,000), posttrain 30 steps. Cut to make
room for it: B6's calibrations in one chunk of 100 (two of 50), phase 15 at
steps_per_call 5 and 1 with 15 steps per arm (10 and 1, 30), B7(e) at 500
timesteps (1,000).

Cut to make room for the two reference-scale recipes in phase 14: phase 4
at DDIM 20 (50), phase 9 at DDIM 10 (15), B4's, B6's and B7(d)'s
calibrations on 50 cal sims (100), B7(c) at DDIM 50 (100), B7(e) at 250
timesteps (500), T6's calibrations on 250 cal sims (1,000), 13(e) at DDIM 5
(10), phase 15's profiler over one step per arm (three), phase 16 at DDIM
10 (25) with its profiler windows under `--serving-graphs` only.

Four cards over NCCL (phase 17; `python3 chip_smoke.py --cards 4`, a mode
of its own that needs exactly four visible cards and exits non-zero before
any result with fewer; the default run above is unchanged, needs one card
and still ends with `"count": 1`). Phase 2's build, once (ranks find the
libraries by hash), then, comparisons with TF32 off and speed arms at the
default flags, each rank on its own card (phase 13's spawned ranks, here
four NCCL ranks of one group) against the same work in one process on
card 0:

 17a. each card's name and power limit and `nvidia-smi topo -m`; pmesh's
      all-reduce, all-gather and reduce-scatter over the four ranks, each
      equal to its exact value, on the native route; a captured all-reduce
      of the turbo UNet2D's gradient size equal to the eager one bit for
      bit; the all-reduce's ms (the slowest rank's, CUDA events) and bus
      bandwidth at the UNet3D's, the turbo UNet1D's and the turbo UNet2D's
      float32 gradient sizes (92.3, 229.4 and 562.8 MB);
 17b. from this process, its current device cuda:0, K1 (B = 8 and 50,
      127^2, 1e-8) and K2 (TF32 and bf16 at (64, 64, 64), B = 16, F = 32)
      on cuda:1-3 against their plain versions there: K1 within 1e-4 of
      max|x| and a residual under 1e-3 (phase 3), K2 TF32 within twice
      cuDNN's TF32 error + 1e-4 and 5e-3 of max, bf16 within 1e-2 of max
      (phase 6); each launch counted once, its output on its card; the
      kernels' ms, their plain versions' and F.conv3d's on cuda:1;
 17c. 13(b) at dp 4 (global batch 16, 4 rows per rank; losses within 1e-5
      relative, weights within 2.5 lr, the ranks' weights equal, 90 K2
      3xTF32 launches per rank and step) and 13(d) at dp 4 (8 cal and 8
      test sims, Q-hat within 1e-5 relative, the metrics within 1e-3
      relative and a rate within one sample; 255 K1 launches per rank, K2
      idle);
 17d. 13(c) at sp 4 (8 + 2 halo frames per rank) and at dp 2 x sp 2 (a
      rank's row, 16 + 2 frames): the output and every gradient within
      1e-4 of their largest entry; 90 K2 launches per rank (tensor-core and
      SIMT forms reported), peak memory per rank;
 17e. Burgers (turbo UNet2D, global batch 16) and tokamak (turbo UNet1D,
      32) at dp 4 on P17_SPLITS sims: with TF32 off in float32, a captured
      pretrain of 9 steps in chunks of 3 (a warm-up chunk, the capture, a
      replay) and a captured calibrate (three chunks of 8) and evaluate
      (three calls, DDIM 5) against one process: losses and Q-hat within
      1e-5 relative, metrics within 1e-3; at the default flags in bf16 (the
      recipes' dtype), the same calls eagerly and captured on the four
      ranks, equal bit for bit (losses, weights, EMA, Q-hat, metrics), and
      the graphs counted; steps/s (steps 20-40 in chunks of 10) on one card
      captured, four cards eager and four cards captured, with each card's
      peak memory; K1 and K2 idle;
 17f. `torchrun --nproc_per_node=4 -m safediffcon_torch.cli.main burgers
      pretrain`, the same command with no launcher (it starts four
      workers) and `smoke pretrain --sp 2 --conv-impl pallas` on four
      torchrun ranks (`--cli-rank`), each with a few steps: exit 0 and the
      NCCL group in the log; the smoke ranks each 90 K2 launches per step.
 17g. The fine-tuning phases, each as a user runs it, with TF32 off in
      float32, eagerly on the four ranks against the same phase in one
      process (Q-hat and epoch losses within 1e-5 relative, metrics within
      1e-3, weights within 2.5 lr and equal on every rank) and, Burgers and
      tokamak, at the default flags in bf16 eagerly and captured on the
      ranks, equal bit for bit (Q-hat, epoch records, weights, EMA) with
      each phase's step graph replayed and no graph in the eager arm:
      (b) Burgers (turbo UNet2D, DDIM 5): calibrate, `posttrain` one epoch
      of 7 steps at a global batch of 32 in chunks of 3 (a warm-up chunk,
      the captured chunk, one step left over) and its evaluation, then
      `inference_finetune`, two epochs of one step on the 16 test sims,
      each recalibrated and evaluated; (t) tokamak (turbo UNet1D, DDIM 5)
      `run_inference` one epoch of 3 steps at a global batch of 32, with
      `posttrain_config()` and with `finetune_config()` on a
      `finetune_set="test"` pipeline; (s) smoke (UNet3D dim 64, eager as on
      one card) `run_inference` post-training (2 steps of 8 from a device
      pool of 16) and the backward fine-tune, each calibrated and evaluated
      on 13(d)'s 8 + 8 sims at DDIM 10, at dp 4 and dp 2 x sp 2: 13(d)'s
      tolerances (the backward loss within 1e-3), 255 K1 launches per rank
      and evaluation; (f) on four torchrun ranks `burgers posttrain
      --resume --steps 2 --ddim-steps 5` from 17f's pretrain checkpoint,
      the same command again once its last epoch's state is set aside (it
      resumes from the state rank 0 wrote and ends on the uninterrupted
      run's state bit for bit), and `tokamak infft` from a checkpoint of
      seeded weights: exit 0 and the NCCL group in each log. Seconds and
      peak memory per rank and case.

17e's one-card arms at a rank's share of the batch were dropped (PERF.md
§6 records what they measured), and 17f's Burgers commands take 2 steps (4
before), to make room for 17g.

It prints a `kernels` line of phase 17's launches with 17b's errors and
times, the four cards' `nvidia-smi` lines and {"ok": true, "device": {...,
"count": 4}}.

`python3 chip_smoke.py --cli-rank <command line>` is the rank of 13a's and
17f's torchrun, not a way to run the script.

Its last three lines are the `kernels` JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# H100 SXM data-sheet peaks: HBM3 bandwidth, float32 outside the tensor cores,
# TF32 and bf16 dense tensor-core rates
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
# CG work per cell per iteration: 5-point stencil (9), three dot products
# (6), max |r| (2), three axpy updates (6)
CG_FLOPS_PER_CELL = 23
CELLS = 127
N_CAL, N_TEST = 50, 50  # sims per split (reference: 200 cal, 50 test)
SERVE_CAL = 10  # cal sims of phase 4's calibrate, to keep the script in its budget
SERVE_DDIM = 10  # DDIM steps of phase 4 (reference 100; 50, then 20, before the refscale recipes)
N_TRAIN = 16  # one pretrain batch (reference: 19,800 train sims)
GEN_BATCH = 50
K1_REPS = 20  # timed K1 calls per case
# K1 launches per evaluated batch: one pressure solve per step of the
# 256-frame rollout, 32 record frames x time_scale 8 less the last
# (solvers/smoke.py::evaluate_control)
SOLVER_STEPS = 255
# K2 at UNet3D dim 64, mults (1, 2, 4), 32 frames of 64^2: (H = W, Cin, Cout)
# of each 3x3x3 conv and its launches per forward (models/unet3d.py)
K2_SHAPES = [(64, 64, 64, 8), (64, 128, 64, 2), (32, 64, 128, 1), (32, 128, 128, 3),
             (32, 256, 64, 1), (32, 64, 64, 3), (16, 128, 256, 1), (16, 256, 256, 7),
             (16, 512, 128, 1), (16, 128, 128, 3)]
K2_BATCH, FRAMES = 16, 32
K2_SIMT = (32, 64, 64)  # the shape at which the SIMT kernel is checked
K2_REPS = 10  # timed calls of K2 and F.conv3d per case (the plain version: 1)
PRETRAIN_STEPS = 10  # the EMA first moves at step 10
FT_SIMS = 8  # cal and test sims of the posttrain / InfFT epochs
POSTTRAIN_STEPS = 3
FT_DDIM = 10  # DDIM steps of phase 9 (reference 100; 15 before the refscale recipes)
DPM_STEPS = 25  # DPM-Solver++(2M) steps of phases 11, B7 and T7 (JAX docstring: ~20-50)
# Burgers: the reference "turbo" UNet2D; sims per split (reference 40,000
# train, 1,000 cal, 50 test; the train split cut to what B5-B6 read)
B_MODEL = dict(dim=128, dim_mults=(1, 2, 4, 8))
B_N_TRAIN, B_N_CAL, B_N_TEST = 2048, 1000, 50
B_SOLVER_BATCH = 50
B_PRETRAIN_STEPS = 10  # the EMA first moves at step 10
B_FT_CAL = 50  # cal sims of the fine-tuning phases (reference 1,000; 100 before)
B4_CAL = 50  # cal sims of B4's and B7(d)'s calibrate (reference 1,000; 100 before)
B_FT_DDIM = 50  # DDIM steps of B6's epochs (the configs' 200)
B7_CAL = 50  # cal sims of B7's two-model and ancestral calibrations (reference 1,000)
B7_DDIM = 25  # DDIM steps of B7(c)'s two-model serving (reference 200; 100, then 50, before)
B7_ANCESTRAL_T = 100  # timesteps of B7(a)'s ancestral chain
B7_E_T = 100  # timesteps of B7(e)'s ancestral calibration (reference 1,000; 500, then 250, before)
SMOKE_STEPS = 5  # timed pretrain steps (after one more) and guided DDIM steps of phase 10
# Tokamak: the reference "turbo" UNet1D; trajectories per split (reference
# 48,950 train, 1,000 cal, 50 test; the train split cut to what T5-T6 read)
T_N_TRAIN, T_N_CAL, T_N_TEST = 2048, 1000, 50
T_BATCH = 50  # test batch (reference)
T_CAL_CHUNK = 1000  # calibrate the reference's batch of 1,000 as one chunk
T_FT_CAL = 250  # cal sims of T6's epochs, one chunk (reference 1,000)
T_FT_DDIM = 50  # DDIM steps of T6's epochs (the configs' 200 and 250)
T_PRETRAIN_STEPS = 10  # the EMA first moves at step 10
# Phase 12: the command line's scratch directory (under the gitignored build/),
# its splits (train, cal, test) for Burgers and tokamak and for smoke, smoke
# eval's DDIM steps, and the device-pool pretrain's pool and steps
CLI_DIR = ROOT / "build" / "chip_smoke" / "cli"
CLI_B_SPLITS = (64, 50, 50)
CLI_S_SPLITS = (16, 8, 8)
CLI_S_DDIM = 10
POOL_SIMS, POOL_STEPS = 8, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cg_bound_ms(batch: int, iters: list) -> tuple:
    """Least time for one solve: each input read once and the output written
    once over HBM bandwidth, against this run's iterations' flops at the
    float32 peak. Returns (ms, "bytes" | "operations")."""
    cells = CELLS * CELLS
    nbytes = 4 * cells * (3 * batch + 5)  # div, guess, x; 5 stencil planes
    chunk_sizes = [min(8, batch - 8 * c) for c in range(len(iters))]
    flops = CG_FLOPS_PER_CELL * cells * sum(i * s for i, s in zip(iters, chunk_sizes))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel_vs_plain(K, S):
    """K1 against its plain version at the serving shapes; returns the case
    records, the main-path case (B=50 as evaluate runs it, 1e-8, check
    every iteration) and the cluster layout."""
    masks = S.build_masks("cuda")
    planes = masks.planes
    lay = K.cluster_layout(CELLS)
    cluster = dict(size=lay.cluster, rows=lay.rows, smem_bytes=lay.smem_bytes,
                   max_active_clusters=K.max_active_clusters(CELLS),
                   chunks_at_main_batch=-(-N_TEST // K.CHUNK))
    log(f"K1 layout: clusters of {lay.cluster} blocks x {lay.rows} rows (last band "
        f"{lay.bands(CELLS)[-1][1]}), {lay.smem_bytes} B of shared memory per block, "
        f"{cluster['max_active_clusters']} clusters fit at once, B = {N_TEST} needs "
        f"{cluster['chunks_at_main_batch']}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for batch in (8, 10, N_TEST):
        # a rollout-like pair of frames: the previous frame's pressure is the
        # warm start of the next one's solve
        v = 0.3 * torch.randn((batch, 128, 128, 2), generator=gen, device="cuda")
        v_prev = v + 0.05 * torch.randn(v.shape, generator=gen, device="cuda")
        div = S.divergence(v * masks.velocity_mask).contiguous()
        div_prev = S.divergence(v_prev * masks.velocity_mask).contiguous()
        guess, _ = K.pressure_cg_plain(div_prev, torch.zeros_like(div), planes, 1e-6, 500)
        for accuracy in (1e-6, 1e-8):
            for check_every in (1, K.BLOCK_K):
                case = check_k1(K, planes, (div, guess, planes, accuracy, 500, check_every))
                case.update(variant="v1" if check_every == 1 else "v2", batch=batch)
                log("K1 " + json.dumps(case))
                cases.append(case)
                if (batch, accuracy, check_every) == (N_TEST, 1e-8, 1):
                    main = case
    return masks, cases, main, cluster


def check_k1(K, planes, args) -> dict:
    """One K1 case against its plain version: error, residuals, iterations,
    times, bound."""
    div, _, _, accuracy, max_iter, check_every = args
    xk, ik = K.pressure_cg_cuda(*args)
    xp, ip = K.pressure_cg_plain(*args)
    torch.cuda.synchronize()
    diff = float((xk - xp).abs().max())
    scale = float(xp.abs().max())
    res_k = float((K.apply_A_planes(planes, xk) - div).abs().max())
    res_p = float((K.apply_A_planes(planes, xp) - div).abs().max())
    kernel_ms = cuda_ms(lambda: K.pressure_cg_cuda(*args), reps=K1_REPS)
    plain_ms = cuda_ms(lambda: K.pressure_cg_plain(*args), reps=2)
    iters, plain_iters = ik.tolist(), ip.tolist()
    bound_ms, bound_by = cg_bound_ms(div.shape[0], iters)
    case = dict(check_every=check_every, accuracy=accuracy, max_iter=max_iter,
                kernel_ms=kernel_ms, us_per_iter=1e3 * kernel_ms / max(max(iters), 1),
                plain_ms=plain_ms, iterations=iters, plain_iterations=plain_iters,
                max_diff=diff, max_abs_x=scale, residual=res_k, plain_residual=res_p,
                bound_ms=bound_ms, bound_by=bound_by)
    # Both run the same recurrence; their float32 dot products sum in other
    # orders, so the iterates differ by rounding that CG does not amplify
    # past the solve's own accuracy: 1e-4 of max|x| (the CPU tests see 1e-6
    # of it against Pallas).
    if not diff <= 1e-4 * scale:
        raise AssertionError(f"K1 differs from its plain version: {diff} > 1e-4 * {scale}")
    # float32 recursive-residual termination leaves a small true residual
    # (tests/test_ops_pallas.py bounds it by 1e-3)
    if not (res_k < 1e-3 and res_k <= 2 * res_p + 1e-5):
        raise AssertionError(f"K1 residual {res_k} (plain {res_p})")
    if max(abs(a - b) for a, b in zip(iters, plain_iters)) > max(check_every, 5):
        raise AssertionError(f"K1 iterations {iters} vs plain {plain_iters}")
    return case


def phase_gradient(K, S, masks):
    """The backward pass launches K1 on the cotangent: A (dL/ddiv) = w, and
    the gradient equals the plain solve of w."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    div = torch.randn((8, CELLS, CELLS), generator=gen, device="cuda").requires_grad_()
    w = torch.randn((8, CELLS, CELLS), generator=gen, device="cuda")
    before = K.pressure_cg_cuda.launches
    (K.pressure_solve_kernel(masks, div, 1e-7, 2000) * w).sum().backward()
    torch.cuda.synchronize()
    if K.pressure_cg_cuda.launches - before != 2:
        raise AssertionError("the backward pass did not launch K1")
    adjoint = float((S._apply_A(masks, div.grad) - w).abs().max())
    plain, _ = K.pressure_cg_plain(w, torch.zeros_like(w), masks.planes, 1e-7, 2000)
    diff = float((div.grad - plain).abs().max())
    log(f"K1 gradient: max|A g - w| = {adjoint:.3e}, max|g - plain| = {diff:.3e} "
        f"(max|g| = {float(plain.abs().max()):.3e})")
    if not (adjoint < 1e-3 and diff <= 1e-4 * float(plain.abs().max())):
        raise AssertionError("K1 gradient check failed")


def phase_serving(K, smoke):
    """Datagen, then calibrate + guided evaluate at full width."""
    out_dir = ROOT / "build" / "chip_smoke"
    path = str(out_dir / "smoke.npz")
    K.pressure_cg_cuda.iterations = []
    K.pressure_cg_cuda.events = []
    launches0 = K.pressure_cg_cuda.launches
    datagen_phases = {}
    t0 = time.perf_counter()
    smoke.generate_smoke_dataset(path, n_train=N_TRAIN, n_cal=N_CAL, n_test=N_TEST, seed=0,
                                 gen_batch=GEN_BATCH, accuracy=1e-6, max_iter=500, device="cuda",
                                 phase_seconds=datagen_phases)
    torch.cuda.synchronize()
    datagen_s = time.perf_counter() - t0
    gen_iters = torch.cat(K.pressure_cg_cuda.iterations).float()
    datagen_phases["k1_events"] = sum(a.elapsed_time(b) for a, b in K.pressure_cg_cuda.events) / 1e3
    K.pressure_cg_cuda.events = None
    log(f"phase datagen: {N_TRAIN + N_CAL + N_TEST} sims x 255 solver steps in {datagen_s:.2f} s "
        f"(batches of {GEN_BATCH}); seconds per phase {json.dumps(datagen_phases)} (K1 by CUDA "
        f"events, inside the rollout); "
        f"K1 launches {K.pressure_cg_cuda.launches - launches0}, iterations per chunk "
        f"mean {float(gen_iters.mean()):.1f} max {int(gen_iters.max())} (accuracy 1e-6)")
    cal = smoke.SmokeDataset.load(path, "cal")
    test = smoke.SmokeDataset.load(path, "test")
    train = smoke.SmokeDataset.load(path, "train")

    ccfg = smoke.SmokeConformalConfig(cal_batch_size=SERVE_CAL, num_cal_batch=1,
                                      n_test_samples=N_TEST, test_batch_size=N_TEST,
                                      ddim_sampling_steps=SERVE_DDIM)
    pipe = smoke.SmokePipeline(ccfg, device="cuda")
    log(f"depth cut: calibrate on {SERVE_CAL} of the {N_CAL} cal sims, {N_TEST} test sims "
        f"(reference 200 + 50), DDIM {ccfg.ddim_sampling_steps} steps (reference 100); width, "
        f"frames and the 256-frame solver are the reference's; default chunks: calibrate "
        f"{pipe.cal_chunk}, evaluate {pipe.eval_chunk}")
    from safediffcon_torch.tasks.smoke.pipeline import init_params
    init_params(pipe.model, seed=0)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    log(f"UNet3D dim 64 mults (1, 2, 4): {n_params} parameters; solver {pipe.solver_kw}")

    # the main path: counts zeroed just before, read just after
    K.pressure_cg_cuda.launches = 0
    K.pressure_cg_cuda.iterations = []
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = pipe.calibrate(smoke.SmokeDataset(cal.data[:SERVE_CAL], cal.raw[:SERVE_CAL]), 0.0,
                       generator=torch.Generator(device="cuda").manual_seed(1))
    q = float(q)
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    pipe.phase_seconds = {}
    t0 = time.perf_counter()
    metrics = pipe.evaluate(test, q, generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launches = K.pressure_cg_cuda.launches
    iters = torch.cat(K.pressure_cg_cuda.iterations)
    K.pressure_cg_cuda.iterations = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    steps = ccfg.ddim_sampling_steps
    sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]
    at_max = float((iters >= 500).float().mean())
    log(f"phase calibrate: {calibrate_s:.2f} s ({1e3 * calibrate_s / steps:.1f} ms per "
        f"conditioned DDIM step at B={SERVE_CAL}); Q-hat {q:.6f}; peak device memory "
        f"{cal_peak_gb:.2f} GB")
    log(f"phase evaluate: {evaluate_s:.2f} s = sampling {sampling_s:.2f} s "
        f"({1e3 * sampling_s / steps:.1f} ms per guided step at B={N_TEST}) + solver rollout "
        f"{rollout_s:.2f} s; peak device memory {peak_gb:.2f} GB")
    log(f"K1 on the main path: {launches} launches, iterations per chunk mean "
        f"{float(iters.float().mean()):.1f}, share at max_iter 500: {at_max:.3f} "
        f"(accuracy {pipe.solver_kw['accuracy']})")
    log("metrics " + json.dumps(metrics, sort_keys=True))
    expected = SOLVER_STEPS * -(-N_TEST // pipe.eval_chunk)
    if launches != expected:
        raise AssertionError(f"the serving path launched K1 {launches} times, expected {expected}")
    if not (math.isfinite(q) and all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"non-finite result: Q {q}, metrics {metrics}")
    return (train, cal, test), launches, dict(
        datagen_s=datagen_s, datagen_phases=datagen_phases, calibrate_s=calibrate_s, sampling_s=sampling_s,
        rollout_s=rollout_s, ms_per_guided_step=1e3 * sampling_s / steps, peak_gb=peak_gb,
        cal_peak_gb=cal_peak_gb, iter_share_at_max=at_max)


def phase_small_input_agreement(K, smoke, test):
    """The same small evaluate on the card and on the CPU, float32 without
    TF32: the CPU path is the one the tests hold against the JAX package."""
    from safediffcon_torch.tasks.smoke.pipeline import init_params
    conf = smoke.SmokeConformalConfig(ddim_sampling_steps=3, timesteps=6,
                                      standard_fixed_ratio=10.0, safe_bound=0.001)
    kw = dict(dim=8, dim_mults=(1, 2), solver_accuracy=1e-4, solver_max_iter=60,
              solver_time_scale=8, solver_space_scale=4)
    raw = test.raw[:2, ::8, ::2, ::2]  # 4 frames of 32^2
    small = smoke.SmokeDataset(data=raw / smoke.RESCALER, raw=raw)
    gen = torch.Generator().manual_seed(3)
    init = torch.randn(raw.shape, generator=gen)
    steps = [torch.randn(raw.shape, generator=gen) for _ in range(2)]
    results = {}
    with tf32_flag(False):
        for device in ("cuda", "cpu"):
            pipe = smoke.SmokePipeline(conf, device=device, **kw)
            init_params(pipe.model, seed=0)
            noise = iter([(init.to(device), [s.to(device) for s in steps])])
            results[device] = pipe.evaluate(small, 0.05, noise=noise)
    log("small input: card " + json.dumps(results["cuda"], sort_keys=True))
    log("small input: cpu  " + json.dumps(results["cpu"], sort_keys=True))
    for name, ref in results["cpu"].items():
        got = results["cuda"][name]
        # float32 on both, sums in other orders: 1e-3 relative (percentages exact)
        tol = 1e-9 if "percentage" in name else 1e-3 * abs(ref) + 1e-6
        if not abs(got - ref) <= tol:
            raise AssertionError(f"card and CPU disagree on {name}: {got} vs {ref}")


def conv_bound_ms(batch: int, h: int, cin: int, cout: int, dtype, passes: int = 1) -> tuple:
    """Least time for one stride-1 SAME 3x3x3 conv of (batch, FRAMES, h, h,
    cin): x, the weight and the output each moved once over HBM bandwidth,
    against its flops (times `passes`: 3 for 3xTF32) at the dense
    tensor-core rate of its input type (TF32 for float32). Returns
    (ms, "bytes" | "operations")."""
    voxels = batch * FRAMES * h * h
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (voxels * (cin + cout) + 27 * cin * cout)
    flops = passes * 2 * voxels * 27 * cin * cout
    peak = TF32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class tf32_flag:
    """Sets torch.backends.cudnn.allow_tf32 (which also picks K2's float32
    mode) for the block, and restores it."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32 = self.saved


def k2_launches(C) -> int:
    """Launches of the tensor-core K2 over its precision modes."""
    return sum(C.conv3d_fused_cuda.launches.values())


def zero_k2_counts(C) -> None:
    C.conv3d_fused_cuda.launches = dict.fromkeys(C.MODES, 0)
    C.conv3d_fused_simt_cuda.launches = 0


class GradRecorder:
    """While active, keeps a float32 CPU copy of the gradients handed to each
    `Adam.step` (every optimizer step of the port), flattened into one
    vector per step."""

    def __enter__(self):
        from safediffcon_torch.core.train import Adam

        self.steps, self.saved = [], Adam.step
        saved, steps = self.saved, self.steps

        def step(opt, params, grads, state, scalars=None):
            grads = list(grads)
            steps.append(torch.cat([g.detach().float().flatten().cpu() for g in grads]))
            return saved(opt, params, grads, state, scalars)

        Adam.step = step
        return self

    def __exit__(self, *exc):
        from safediffcon_torch.core.train import Adam

        Adam.step = self.saved


def grad_rel_errs(card: list, cpu: list) -> list:
    """|g_card - g_cpu| / |g_cpu| (L2 over all parameters) of each step."""
    if len(card) != len(cpu) or not cpu:
        raise AssertionError(f"{len(card)} card and {len(cpu)} CPU optimizer steps")
    return [float((a - b).norm() / b.norm()) for a, b in zip(card, cpu)]


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, max |ref|), in float32."""
    got, ref = got.detach().float(), ref.detach().float()
    return float((got - ref).abs().max()), float(ref.abs().max())


def phase_conv_kernel_vs_plain(C):
    """K2 against its plain version at UNet3D's 10 conv shapes (B = 16,
    F = 32), in each precision mode of the tensor-core kernel: float32 in
    3xTF32 (TF32 off) and TF32 (TF32 on), forward and dx through the
    autograd Function, dW against autograd of the plain version (TF32 off);
    bfloat16 (the bf16 main path's mode) likewise, against the plain
    version on the same bf16 inputs. Times of each mode, the plain version,
    and one F.conv3d call (cuDNN) in TF32, in float32 and in bfloat16. The
    SIMT kernel against its plain version at one shape."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    for h, cin, cout, per_forward in K2_SHAPES:
        shape = (K2_BATCH, FRAMES, h, h, cin)
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda") / (27 * cin) ** 0.5
        g = torch.randn((*shape[:-1], cout), generator=gen, device="cuda")
        wf = C.flatten_weight(w)
        wt = C.flatten_weight(C.flip_transpose(w))
        if C.wgmma_tile(shape, torch.float32) is None:
            raise AssertionError(f"the tensor-core K2 does not take the UNet3D shape {shape}")
        xn, gn = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)  # NCDHW views
        w_dx = C.flip_transpose(w).contiguous()

        # references: the plain version in float32, dx and dW by its autograd
        with tf32_flag(False):
            plain = C.conv3d_fused_plain(x, wf)
            xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
            C.conv3d_fused_plain(xp, C.flatten_weight(wp)).backward(g)
            plain_ms = cuda_ms(lambda: C.conv3d_fused_plain(x, wf), reps=1)
            library_fp32_ms = cuda_ms(lambda: F.conv3d(xn, w, padding=1), reps=K2_REPS)
        with tf32_flag(True):
            library_ms = cuda_ms(lambda: F.conv3d(xn, w, padding=1), reps=K2_REPS)
            lib_diff, _ = rel_err(F.conv3d(xn, w, padding=1).permute(0, 2, 3, 4, 1), plain)
            lib_dx_diff, _ = rel_err(F.conv3d(gn, w_dx, padding=1).permute(0, 2, 3, 4, 1),
                                     xp.grad)
        case = dict(h=h, cin=cin, cout=cout, batch=K2_BATCH, frames=FRAMES, dtype="float32",
                    launches_per_forward=per_forward, plain_ms=plain_ms, library_ms=library_ms,
                    library_fp32_ms=library_fp32_ms, library_err=lib_diff,
                    library_dx_err=lib_dx_diff)
        flops = 2 * K2_BATCH * FRAMES * h * h * 27 * cin * cout
        for mode, on, passes in (("3xtf32", False, 3), ("tf32", True, 1)):
            with tf32_flag(on):
                before = k2_launches(C), C.conv3d_fused_cuda.launches[mode]
                out = C.conv3d_fused(x, wf)
                xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
                C.conv3d_fused_fn(xk, wk).backward(g)
                torch.cuda.synchronize()
                launched = C.conv3d_fused_cuda.launches[mode] - before[1]
                if k2_launches(C) - before[0] != launched:
                    raise AssertionError(f"K2 {mode} ran in another mode")
                ms = cuda_ms(lambda: C.conv3d_fused(x, wf), reps=K2_REPS)
                dx_ms = cuda_ms(lambda: C.conv3d_fused(g, wt), reps=K2_REPS)
            diff, scale = rel_err(out, plain)
            dx_diff, dx_scale = rel_err(xk.grad, xp.grad)
            bound_ms, bound_by = conv_bound_ms(K2_BATCH, h, cin, cout, torch.float32, passes)
            case[mode] = dict(kernel_ms=ms, dx_kernel_ms=dx_ms, bound_ms=bound_ms,
                              bound_by=bound_by, tflops=flops / ms / 1e9, max_diff=diff,
                              dx_max_diff=dx_diff, launches=launched)
            case.update(max_abs=scale, dx_max_abs=dx_scale)
            # the call, the Function's forward and its dx
            if launched != 3:
                raise AssertionError(f"K2 {mode} ran {launched} of 3 calls on the tensor cores")
            if mode == "3xtf32":
                # float32-level sums of K = 27 * Cin <= 13,824 products in another order
                if not (diff <= 1e-4 * scale and dx_diff <= 1e-4 * dx_scale):
                    raise AssertionError(f"K2 3xTF32 differs from its plain version: {case}")
                # dW: cuDNN's weight gradient in float32 on both sides, 2.1M voxels
                dw_diff, dw_scale = rel_err(wk.grad, wp.grad)
                case.update(dw_max_diff=dw_diff, dw_max_abs=dw_scale)
                if not dw_diff <= 1e-4 * dw_scale:
                    raise AssertionError(f"K2's weight gradient differs: {case}")
            else:
                # one TF32 pass: operands rounded to 10 mantissa bits, like cuDNN's
                for d, lib, sc in ((diff, lib_diff, scale), (dx_diff, lib_dx_diff, dx_scale)):
                    if not (d <= 2 * lib + 1e-4 * sc and d <= 5e-3 * sc):
                        raise AssertionError(f"K2 TF32 error {d} against cuDNN's {lib}: {case}")
            del out, xk, wk
        # the main path's mode (pretrain at the default flags) is TF32
        case.update({k: case["tf32"][k] for k in
                     ("kernel_ms", "dx_kernel_ms", "bound_ms", "bound_by", "tflops", "max_diff",
                      "dx_max_diff")})
        log("K2 " + json.dumps(case))
        cases.append(case)
        del xp, wp

        # bfloat16: the forward, and dx and dW through the autograd Function,
        # against the plain version and its autograd on the same bf16 inputs
        xb, wb, gb = x.bfloat16(), w.bfloat16(), g.bfloat16()
        wbf, wbt = C.flatten_weight(wb), C.flatten_weight(C.flip_transpose(wb))
        xp, wp = xb.clone().requires_grad_(), wb.clone().requires_grad_()
        ref = C.conv3d_fused_plain(xp, C.flatten_weight(wp))
        ref.backward(gb)
        before = dict(C.conv3d_fused_cuda.launches)
        out = C.conv3d_fused(xb, wbf)
        xk, wk = xb.clone().requires_grad_(), wb.clone().requires_grad_()
        C.conv3d_fused_fn(xk, wk).backward(gb)
        torch.cuda.synchronize()
        launched = {m: n - before[m] for m, n in C.conv3d_fused_cuda.launches.items()}
        finite = all(bool(torch.isfinite(t.float()).all()) for t in (out, xk.grad, wk.grad))
        diff, scale = rel_err(out, ref)
        dx_diff, dx_scale = rel_err(xk.grad, xp.grad)
        dw_diff, dw_scale = rel_err(wk.grad, wp.grad)
        bound_ms, bound_by = conv_bound_ms(K2_BATCH, h, cin, cout, torch.bfloat16)
        ms = cuda_ms(lambda: C.conv3d_fused(xb, wbf), K2_REPS)
        bf16 = dict(h=h, cin=cin, cout=cout, batch=K2_BATCH, frames=FRAMES, dtype="bfloat16",
                    mode="bf16", launches_per_forward=per_forward, kernel_ms=ms,
                    dx_kernel_ms=cuda_ms(lambda: C.conv3d_fused(gb, wbt), K2_REPS),
                    plain_ms=cuda_ms(lambda: C.conv3d_fused_plain(xb, wbf), 1),
                    library_ms=cuda_ms(lambda: F.conv3d(xb.permute(0, 4, 1, 2, 3), wb,
                                                        padding=1), K2_REPS),
                    bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
                    max_diff=diff, max_abs=scale, dx_max_diff=dx_diff, dx_max_abs=dx_scale,
                    dw_max_diff=dw_diff, dw_max_abs=dw_scale, launches=launched)
        log("K2 " + json.dumps(bf16))
        # each side rounds one float32 sum to bfloat16 (8 bits): 1e-2 of max;
        # the call, the Function's forward and its dx, all in bf16 mode
        if not (out.dtype == xk.grad.dtype == wk.grad.dtype == torch.bfloat16 and finite
                and diff <= 1e-2 * scale and dx_diff <= 1e-2 * dx_scale
                and dw_diff <= 1e-2 * dw_scale
                and launched == dict(dict.fromkeys(C.MODES, 0), bf16=3)):
            raise AssertionError(f"K2 bfloat16 differs from its plain version: {bf16}")
        cases.append(bf16)
        del xb, wb, gb, wbf, wbt, xp, wp, ref, out, xk, wk

        if (h, cin, cout) == K2_SIMT:
            before = C.conv3d_fused_simt_cuda.launches
            out = C.conv3d_fused_simt_cuda(x, wf)
            torch.cuda.synchronize()
            launched = C.conv3d_fused_simt_cuda.launches - before
            diff, scale = rel_err(out, plain)
            bound_ms, bound_by = conv_bound_ms(K2_BATCH, h, cin, cout, torch.float32)
            ms = cuda_ms(lambda: C.conv3d_fused_simt_cuda(x, wf), K2_REPS)
            simt = dict(h=h, cin=cin, cout=cout, batch=K2_BATCH, frames=FRAMES, dtype="float32",
                        kernel_ms=ms, plain_ms=plain_ms, library_ms=library_fp32_ms,
                        bound_ms=bound_ms, bound_by=bound_by, tflops=flops / ms / 1e9,
                        max_diff=diff, max_abs=scale)
            log("K2 SIMT " + json.dumps(simt))
            # float32 FMAs, sums in another order: 1e-4 of max
            if not (diff <= 1e-4 * scale and launched == 1):
                raise AssertionError(f"the SIMT K2 differs from its plain version: {simt}")
            del out
        del x, w, g, wf, wt, xn, gn, w_dx, plain
        torch.cuda.empty_cache()
    return cases, simt


def count_fused_convs(model) -> int:
    from safediffcon_torch.models.unet3d import FusedConv3x3x3

    return sum(isinstance(m, FusedConv3x3x3) for m in model.modules())


def phase_pretrain(C, smoke, train):
    """Pretraining at the reference width with every 3x3x3 conv on K2."""
    from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

    cfg = smoke.SmokePretrainConfig(conv_impl="pallas")
    n_convs = count_fused_convs(build_model(cfg.dim, cfg.dim_mults, conv_impl="pallas",
                                            device="meta"))
    if n_convs != sum(n for *_, n in K2_SHAPES):
        raise AssertionError(f"UNet3D has {n_convs} fused convs, K2_SHAPES lists "
                             f"{sum(n for *_, n in K2_SHAPES)}")
    log(f"pretrain: {cfg}; {len(train)} train sims; depth cut to {PRETRAIN_STEPS} steps "
        f"(reference {cfg.train_num_steps})")
    smoke.pretrain(cfg, train, num_steps=1, device="cuda")  # warm-up, not counted
    init = init_params(build_model(cfg.dim, cfg.dim_mults, device="cuda"), seed=cfg.seed)
    init = {k: v.detach() for k, v in init.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts zeroed just before, read just after
    zero_k2_counts(C)
    C.conv3d_fused_cuda.events = []
    mode = C.kernel_mode(torch.float32)
    losses = []
    t0 = time.perf_counter()
    state = smoke.pretrain(cfg, train, num_steps=PRETRAIN_STEPS, device="cuda", losses=losses)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = C.conv3d_fused_cuda.launches[mode]
    simt_launches = C.conv3d_fused_simt_cuda.launches
    k2_s = sum(a.elapsed_time(b) for a, b in C.conv3d_fused_cuda.events) / 1e3
    C.conv3d_fused_cuda.events = None
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [float(v) for v in losses]
    ema_moved = max(float((state.ema_params[k] - init[k]).abs().max()) for k in init)
    weights_moved = max(float((p.detach() - init[k]).abs().max())
                        for k, p in state.model.named_parameters())
    log(f"phase pretrain: {PRETRAIN_STEPS} steps in {seconds:.2f} s = "
        f"{seconds / PRETRAIN_STEPS:.3f} s per step at batch {cfg.batch_size}; K2 {launches} "
        f"launches on the tensor cores in {mode}, {simt_launches} SIMT, {k2_s:.2f} s of kernel "
        f"time ({100 * k2_s / seconds:.1f} % of the steps); peak device memory {peak_gb:.2f} GB")
    log(f"pretrain losses {json.dumps(losses)}; max |EMA - init| {ema_moved:.3e}, "
        f"max |weights - init| {weights_moved:.3e}")
    # per step: each conv's forward, its recomputation, its dx (3 x 30 = 90)
    if (launches != 3 * n_convs * PRETRAIN_STEPS or k2_launches(C) != launches
            or simt_launches != 0):
        raise AssertionError(f"K2 launched {launches} times on the tensor cores and "
                             f"{simt_launches} on the SIMT kernel, expected {3 * n_convs} x "
                             f"{PRETRAIN_STEPS} and 0")
    if not all(math.isfinite(v) for v in losses) or len(losses) != PRETRAIN_STEPS:
        raise AssertionError(f"pretrain losses {losses}")
    if not (state.step == PRETRAIN_STEPS and ema_moved > 0 and weights_moved > 0):
        raise AssertionError("pretrain did not move the weights and the EMA")
    ema = {k: v.clone() for k, v in state.ema_params.items()}
    return ema, launches, dict(pretrain_s=seconds, s_per_step=seconds / PRETRAIN_STEPS,
                               k2_s=k2_s, k2_share=k2_s / seconds, pretrain_peak_gb=peak_gb,
                               k2_mode=mode, simt_launches=simt_launches, losses=losses)


def phase_finetune(K, smoke, data, params):
    """One posttrain epoch and one InfFT epoch through run_inference from
    the pretrained EMA weights, on FT_SIMS cal and test sims with DDIM FT_DDIM
    (reference 100);
    then one more InfFT step at Q = 1. InfFT's loss with finetune_config
    (w_safe 1) is w_safe * mean(relu(final safe rate + Q - bound)^2): it is 0,
    with a zero gradient, while every predicted safe rate lies below
    bound - Q-hat, as with barely trained weights; at Q = 1 the relu is
    active for any prediction above -0.9, so that step must move the
    weights."""
    from safediffcon_torch.tasks.smoke import make_finetune_steps, run_inference

    train, cal, test = data
    cal = smoke.SmokeDataset(cal.data[:FT_SIMS], cal.raw[:FT_SIMS])
    test = smoke.SmokeDataset(test.data[:FT_SIMS], test.raw[:FT_SIMS])
    cut = dict(cal_batch_size=FT_SIMS, num_cal_batch=1, n_test_samples=FT_SIMS,
               test_batch_size=FT_SIMS, ddim_sampling_steps=FT_DDIM)
    runs = {
        "posttrain": dataclasses.replace(smoke.posttrain_config(), finetune_epoch=1,
                                         finetune_steps=POSTTRAIN_STEPS),
        "infft": dataclasses.replace(smoke.finetune_config(), finetune_epoch=1),
    }
    times = {}
    for name, cfg in runs.items():
        cfg = dataclasses.replace(cfg, conformal=dataclasses.replace(cfg.conformal, **cut))
        pipe = smoke.SmokePipeline(cfg.conformal, device="cuda")
        cal_s = []
        calibrate = pipe.calibrate

        def timed_calibrate(*a, **kw):
            t = time.perf_counter()
            q = calibrate(*a, **kw)
            torch.cuda.synchronize()
            cal_s.append(time.perf_counter() - t)
            return q

        pipe.calibrate = timed_calibrate
        pipe.phase_seconds = {}
        K.pressure_cg_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        new, _, hist = run_inference(cfg, pipe, params, train, cal, test)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        evaluate_s = pipe.phase_seconds["sampling"] + pipe.phase_seconds["rollout"]
        changed = max(float((new[k] - params[k]).abs().max()) for k in params)
        times[name] = dict(epochs=len(hist), total_s=total,
                           finetune_s=total - sum(cal_s) - evaluate_s, calibrate_s=sum(cal_s),
                           evaluate_s=evaluate_s, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                           k1_launches=K.pressure_cg_cuda.launches,
                           quantiles=[r["quantile"] for r in hist],
                           losses=[r["loss"] for r in hist], max_weight_change=changed)
        log(f"phase {name}: {json.dumps(times[name])}; {cfg.finetune_steps} step(s) per epoch "
            f"at batch {cfg.finetune_batch_size if name == 'posttrain' else FT_SIMS}, DDIM "
            f"{cfg.conformal.ddim_sampling_steps}")
        for rec in hist:
            log(f"{name} epoch {rec['epoch']} metrics " + json.dumps(rec["eval"], sort_keys=True))
            values = [rec["quantile"], rec["loss"], *rec["eval"].values()]
            if not all(math.isfinite(v) for v in values):
                raise AssertionError(f"{name}: non-finite result {rec}")
        if len(hist) != cfg.finetune_epoch or K.pressure_cg_cuda.launches == 0:
            raise AssertionError(f"{name}: {len(hist)} of {cfg.finetune_epoch} epochs ran, "
                                 f"{K.pressure_cg_cuda.launches} K1 launches")
        if name == "posttrain" and not changed > 0:
            raise AssertionError("posttrain left the weights unchanged")
        if name == "infft":
            tx, _, backward_step = make_finetune_steps(cfg, pipe)
            before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
            batch = torch.as_tensor(test.data, device="cuda")
            t0 = time.perf_counter()
            loss = float(backward_step(tx.init(list(pipe.model.parameters())), batch,
                                       torch.tensor(1.0, device="cuda"),
                                       generator=torch.Generator(device="cuda").manual_seed(7)))
            step_s = time.perf_counter() - t0
            moved = max(float((v - before[k]).abs().max())
                        for k, v in pipe.model.state_dict().items())
            times["infft_step_at_q1"] = dict(seconds=step_s, loss=loss, max_weight_change=moved)
            log(f"InfFT step at Q = 1: {json.dumps(times['infft_step_at_q1'])}")
            if not (math.isfinite(loss) and loss > 0 and moved > 0):
                raise AssertionError(f"the InfFT step at Q = 1 did not train: loss {loss}, "
                                     f"weights moved {moved}")
        del pipe, new
        torch.cuda.empty_cache()
    return times


def phase_small_pretrain_agreement(C, smoke, train):
    """Two pretrain steps of a small UNet3D(conv_impl="pallas") on the card
    (K2) and on the CPU (its plain version) from the same weights and draws,
    float32 without TF32: the losses must agree."""
    from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

    cfg = smoke.SmokePretrainConfig(dim=16, dim_mults=(1, 2), timesteps=6, batch_size=2,
                                    conv_impl="pallas")
    raw = train.raw[:4, ::8, ::4, ::4]  # 4 frames of 16^2
    small = smoke.SmokeDataset(data=raw / smoke.RESCALER, raw=raw)
    params = init_params(build_model(16, (1, 2), device="cpu"), seed=5).state_dict()
    gen = torch.Generator().manual_seed(6)
    draws = [(torch.randint(0, cfg.timesteps, (2,), generator=gen),
              torch.randn((2, *raw.shape[1:]), generator=gen)) for _ in range(2)]
    n_convs = count_fused_convs(build_model(16, (1, 2), conv_impl="pallas", device="cpu"))
    # the second run (12d): both steps in one chunk, batches gathered from a
    # bfloat16 pool of 3 of the 4 sims on the device
    for options in ({}, dict(steps_per_call=2, device_pool=3)):
        losses = {}
        before = k2_launches(C)
        simt_before = C.conv3d_fused_simt_cuda.launches
        with tf32_flag(False):
            for device in ("cuda", "cpu"):
                noise = iter([(t.to(device), n.to(device)) for t, n in draws])
                out = []
                smoke.pretrain(cfg, small, num_steps=2, params=params, device=device,
                               noise=noise, losses=out, **options)
                losses[device] = [float(v) for v in out]
        log(f"small pretrain {json.dumps(options)}: card {losses['cuda']}, cpu {losses['cpu']}")
        # per step: each conv's forward, its recomputation, its dx, all in 3xTF32
        if (k2_launches(C) - before != 2 * 3 * n_convs
                or C.conv3d_fused_simt_cuda.launches != simt_before):
            raise AssertionError("the small pretrain on the card did not run on the "
                                 "tensor-core K2")
        for got, ref in zip(losses["cuda"], losses["cpu"]):
            # float32 on both, sums in another order, after one Adam step
            if not abs(got - ref) <= 1e-4 * abs(ref):
                raise AssertionError(f"card and CPU pretrain losses disagree: {losses}")


# ---------------------------------------------------------------------------
# Burgers 1D (phases B1-B7): UNet2D, the FD solver, guided DDIM, training
# ---------------------------------------------------------------------------

def burgers_tolerance_rates(n_samples: int) -> dict:
    """One cell's worth of each violation rate of an (n, 11, 128) rollout."""
    return {"point_exceed_ratio (R_p)": 1 / (n_samples * 11 * 128),
            "time_exceed_ratio (R_t)": 1 / (n_samples * 11),
            "sample_exceed_ratio (R_s)": 1 / n_samples}


def phase_burgers_solver(burgers):
    """B1: the solver on the card and on the CPU from the same u0 and f (the
    datagen distributions, B = 50 at 128 cells, 10 chunks of 1,000 steps);
    ms per rollout at B = 50 and at datagen's batch; kernel launches per
    Euler step (torch.profiler over a 100-step rollout)."""
    from safediffcon_torch.solvers.burgers import burgers_solve
    from safediffcon_torch.tasks.burgers import data as bdata

    rng = np.random.default_rng(10)
    u0 = torch.as_tensor(bdata._two_gaussian_u0(rng, B_SOLVER_BATCH, 128), dtype=torch.float32)
    f = torch.as_tensor(bdata._varying_f(rng, B_SOLVER_BATCH, 128, 10), dtype=torch.float32)
    card = burgers_solve(u0.cuda(), f.cuda())
    cpu = burgers_solve(u0, f)
    err, scale = rel_err(card.cpu(), cpu)
    rollout_ms = cuda_ms(lambda: burgers_solve(u0.cuda(), f.cuda()), reps=2)
    n_gen = B_N_TRAIN + B_N_CAL + B_N_TEST
    big_u0 = u0.cuda().repeat(-(-n_gen // B_SOLVER_BATCH), 1)[:n_gen]
    big_f = f.cuda().repeat(-(-n_gen // B_SOLVER_BATCH), 1, 1)[:n_gen]
    big_ms = cuda_ms(lambda: burgers_solve(big_u0, big_f), reps=1)
    steps = 100
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        burgers_solve(u0.cuda(), f.cuda(), T=steps * 1e-4, num_t=10)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out = dict(batch=B_SOLVER_BATCH, cells=128, euler_steps=10_000, max_diff=err, max_abs=scale,
               ms_per_rollout=rollout_ms, datagen_batch=n_gen, ms_per_rollout_datagen=big_ms,
               launches_per_step=kernels / steps if kernels else "not measured")
    log("B1 solver " + json.dumps(out))
    # the same float32 stencil in the same order on both devices
    if not (torch.isfinite(card).all() and err <= 1e-5 * scale):
        raise AssertionError(f"Burgers solver: card and CPU differ by {err} (max |u| {scale})")
    return out


def phase_burgers_datagen(burgers):
    """B2: n_train + n_cal + n_test sims in one solve batch (seed 0)."""
    path = str(ROOT / "build" / "chip_smoke" / "burgers.npz")
    t0 = time.perf_counter()
    burgers.generate_burgers_dataset(path, n_train=B_N_TRAIN, n_cal=B_N_CAL, n_test=B_N_TEST,
                                     seed=0, solve_batch=4096, device="cuda")
    seconds = time.perf_counter() - t0
    data = {s: burgers.BurgersDataset.load(path, s) for s in ("train", "cal", "test")}
    log(f"B2 datagen: {B_N_TRAIN} + {B_N_CAL} + {B_N_TEST} sims (reference 40,000 train "
        f"sims, cut to what B5-B6 read) in {seconds:.2f} s, one solve batch")
    for name, d in data.items():
        if not (np.isfinite(d.data).all() and d.data.shape[1:] == (16, 128, 3)):
            raise AssertionError(f"Burgers datagen: {name} split is not finite or misshapen")
    return data, seconds


BURGERS_SMALL_CONF = dict(cal_batch_size=4, num_cal_batch=2, n_cal_samples=8, n_test_samples=4,
                         test_batch_size=4, ddim_sampling_steps=3, timesteps=100, w_score=5.0,
                         alpha=0.7)


def burgers_small_run(burgers, data, device, draws) -> dict:
    """A tiny UNet2D (dim 16, seeded weights) on `device` with the given
    draws: calibrate on 8 cal sims, evaluate 4 test sims; then, from weights
    whose final x0 estimate of s lies below the clip (so that InfFT's max
    loss reaches every weight), one InfFT step and one post-training step."""
    from safediffcon_torch.core.train import make_optimizer
    from safediffcon_torch.tasks.burgers.pipeline import (
        infft_step, init_params, make_train_state, weighted_step,
    )

    sampler_noise, train_noise = draws

    def moved(x):
        return x.to(device)

    test = burgers.BurgersDataset(data["test"].data[:4], data["test"].u_phys[:4],
                                  data["test"].f_phys[:4])
    pipe = burgers.BurgersPipeline(burgers.BurgersConformalConfig(**BURGERS_SMALL_CONF), dim=16,
                                   dim_mults=(1, 2), device=device)
    init_params(pipe.model, seed=0)
    noise = iter([(moved(i), [moved(z) for z in st]) for i, st in sampler_noise])
    q = float(pipe.calibrate(None, data["cal"].data[:8], 0.0, noise=noise))
    m = pipe.evaluate(None, test, q, noise=noise)
    with torch.no_grad():
        pipe.model.final_conv.weight.mul_(0.01)
        pipe.model.final_conv.bias[2] = 2.0
    state = make_train_state(pipe, None, make_optimizer("adamw", 1e-3, betas=(0.9, 0.999)),
                             0.995, 10)
    batch = torch.as_tensor(test.data, device=device)
    infft = float(infft_step(pipe, state, batch, 0.0, noise=next(noise)))
    post = float(weighted_step(pipe, state, batch, torch.ones(4, device=device),
                               noise=tuple(moved(x) for x in train_noise)))
    weights = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    return dict(q=q, metrics=m, infft_loss=infft, posttrain_loss=post, weights=weights)


def phase_burgers_small_agreement(burgers, data):
    """B3: `burgers_small_run` on the card and on the CPU (whose path the CPU
    tests hold against the JAX package) with the same draws, float32 without
    TF32: Q-hat, the metrics, both losses and the weights after the two
    steps must agree."""
    gen = torch.Generator().manual_seed(3)
    shape = (4, 16, 128, 3)

    def sampler_draws():
        return torch.randn(shape, generator=gen), [torch.randn(shape, generator=gen)
                                                   for _ in range(2)]

    draws = ([sampler_draws() for _ in range(4)],  # 2 calibrate, 1 evaluate, 1 InfFT
             (torch.randint(0, 100, (4,), generator=gen), torch.randn(shape, generator=gen)))
    with tf32_flag(False):
        results = {device: burgers_small_run(burgers, data, device, draws)
                   for device in ("cuda", "cpu")}
    for device, r in results.items():
        log(f"B3 small input ({device}): Q-hat {r['q']:.6f}, InfFT loss {r['infft_loss']:.6f}, "
            f"posttrain loss {r['posttrain_loss']:.6f}, metrics "
            + json.dumps(r["metrics"], sort_keys=True))
    card, cpu = results["cuda"], results["cpu"]
    unit = burgers_tolerance_rates(4)
    # float32 on both sides, sums in other orders: Q and the losses 1e-4,
    # J 1e-3; a rate may move by one cell across the bound
    checks = [abs(card["q"] - cpu["q"]) <= 1e-4 * abs(cpu["q"]) + 1e-7,
              abs(card["infft_loss"] - cpu["infft_loss"]) <= 1e-4 * abs(cpu["infft_loss"]),
              abs(card["posttrain_loss"] - cpu["posttrain_loss"])
              <= 1e-4 * abs(cpu["posttrain_loss"]),
              cpu["infft_loss"] > 0]
    for name, ref in cpu["metrics"].items():
        tol = unit[name] + 1e-6 if name in unit else 1e-3 * abs(ref) + 1e-7
        checks.append(abs(card["metrics"][name] - ref) <= tol)
    # two AdamW steps of lr 1e-3 from equal weights: within 2 lr, as the CPU
    # tests hold the port against optax
    diff = max(float((card["weights"][k] - v).abs().max()) for k, v in cpu["weights"].items())
    checks.append(diff < 2e-3)
    log(f"B3 small input: max |card - cpu| of the weights after the two steps {diff:.3e}")
    if not all(checks):
        raise AssertionError(f"Burgers small input: card and CPU disagree ({checks})")


def forward_flops(model, shape) -> int:
    """FLOPs of one no-grad forward of a denoiser on (B, ...) input."""
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.zeros(shape, device="cuda")
    t = torch.zeros((shape[0],), dtype=torch.long, device="cuda")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, t)
    return counter.get_total_flops()


def profile_forward(model, shape, reps: int = 5) -> dict:
    """torch.profiler over `reps` no-grad forwards of a denoiser on input of
    `shape`: wall and device (kernel) ms per forward, the device's busy
    share, kernels per forward, and the kernels that take the most device
    time."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = torch.randn(shape, generator=gen, device="cuda")
    t = torch.randint(0, 1000, (shape[0],), generator=gen, device="cuda")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        model(x, t)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model(x, t)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / reps
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                kernels_per_forward=sum(e.count for e in kernels) / reps,
                top=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3 / reps,
                          calls=e.count / reps) for e in top])


def phase_burgers_serving(burgers, data):
    """B4: calibrate on B4_CAL cal sims (reference 1,000) and guided evaluate
    on 50 test sims at full width in float32 (default flags), then the same
    guided sampling in bfloat16 compute."""
    from safediffcon_torch.tasks.burgers.pipeline import init_params

    ccfg = burgers.BurgersConformalConfig()
    pipe = burgers.BurgersPipeline(ccfg, device="cuda", capture=False, **B_MODEL)
    init_params(pipe.model, seed=0)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    steps = ccfg.ddim_sampling_steps
    cal = data["cal"].data[:B4_CAL]
    log(f"B4 serving: UNet2D {B_MODEL}, {n_params} parameters, seeded weights; {ccfg}; "
        f"calibrate on {len(cal)} of the {ccfg.num_cal_batch} x {ccfg.cal_batch_size} sims "
        f"in chunks of {pipe.cal_chunk}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = float(pipe.calibrate(None, cal, 0.0,
                             generator=torch.Generator(device="cuda").manual_seed(1)))
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    pipe.phase_seconds = {}
    t0 = time.perf_counter()
    metrics = pipe.evaluate(None, data["test"], q,
                            generator=torch.Generator(device="cuda").manual_seed(2))
    evaluate_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]

    pipe16 = burgers.BurgersPipeline(ccfg, device="cuda", compute_dtype="bfloat16",
                                     capture=False, **B_MODEL)
    pipe16.model.load_state_dict(pipe.model.state_dict())
    state = torch.as_tensor(data["test"].data, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(2)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        pred16 = pipe16._sample_test(None, state, q, generator=gen)
    torch.cuda.synchronize()
    bf16_s = time.perf_counter() - t0
    bf16_peak_gb = torch.cuda.max_memory_allocated() / 1e9

    shape = (B_N_TEST, 16, 128, 3)
    flops = forward_flops(pipe.model, shape)
    profiles = {"float32": profile_forward(pipe.model, shape),
                "bfloat16": profile_forward(pipe16.model, shape)}
    for name, prof in profiles.items():
        log(f"B4 UNet2D forward at B = {B_N_TEST}, {name}: " + json.dumps(prof))
    out = dict(
        calibrate_s=calibrate_s, cal_sims=len(cal),
        ms_per_cal_step=1e3 * calibrate_s / (steps * -(-len(cal) // pipe.cal_chunk)),
        evaluate_s=evaluate_s, sampling_s=sampling_s, rollout_s=rollout_s,
        solver_share=rollout_s / (sampling_s + rollout_s),
        ms_per_guided_step_fp32=1e3 * sampling_s / steps,
        guided_steps_per_s_fp32=steps / sampling_s,
        ms_per_guided_step_bf16=1e3 * bf16_s / steps, guided_steps_per_s_bf16=steps / bf16_s,
        peak_gb_calibrate=cal_peak_gb, peak_gb_evaluate=peak_gb, peak_gb_bf16=bf16_peak_gb,
        forward_gflop=flops / 1e9,
        step_bound_ms_tf32=1e3 * flops / TF32_FLOPS_PER_S,
        step_bound_ms_bf16=1e3 * flops / BF16_FLOPS_PER_S,
        forward_profile={k: {m: v[m] for m in ("wall_ms", "device_ms", "busy_share",
                                                  "kernels_per_forward")}
                         for k, v in profiles.items()},
        q=q, flags=dict(cudnn_tf32=torch.backends.cudnn.allow_tf32,
                        matmul_tf32=torch.backends.cuda.matmul.allow_tf32))
    log("B4 serving " + json.dumps(out, sort_keys=True))
    log("B4 metrics (float32) " + json.dumps(metrics, sort_keys=True))
    values = [q, *metrics.values()]
    if not (all(math.isfinite(v) for v in values) and bool(torch.isfinite(pred16).all())
            and tuple(pred16.shape) == (B_N_TEST, 16, 128, 3)):
        raise AssertionError(f"Burgers serving: non-finite result: Q {q}, metrics {metrics}")
    return out


def phase_burgers_pretrain(burgers, data, model_w: bool = False):
    """B5 (B7(b) with model_w, the w-only prior): BurgersPretrainConfig
    defaults for B_PRETRAIN_STEPS steps after one warm-up step, from seeded
    weights (cfg.seed); the loop's set-up, timed alone, is taken off the
    steps' time."""
    from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params

    cfg = dataclasses.replace(burgers.BurgersPretrainConfig(), **B_MODEL)
    train = data["train"]
    init = init_params(build_model(cfg.dim, cfg.dim_mults, device="cuda"), seed=cfg.seed)
    init = {k: v.detach() for k, v in init.state_dict().items()}
    burgers.pretrain(cfg, train, num_steps=1, params=init, device="cuda",
                     model_w=model_w)  # warm-up
    # the set-up (model, optimizer and EMA state) alone: a deadline in the
    # past stops the loop before its first step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    burgers.pretrain(cfg, train, num_steps=B_PRETRAIN_STEPS, params=init, device="cuda",
                     deadline=0.0, model_w=model_w)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    state = burgers.pretrain(cfg, train, num_steps=B_PRETRAIN_STEPS, params=init,
                             device="cuda", losses=losses, model_w=model_w)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - setup_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [float(v) for v in losses]
    ema_moved = max(float((state.ema_params[k] - init[k]).abs().max()) for k in init)
    out = dict(steps=B_PRETRAIN_STEPS, batch=cfg.batch_size, setup_s=setup_s,
               seconds=seconds, s_per_step=seconds / B_PRETRAIN_STEPS, peak_gb=peak_gb,
               losses=losses, ema_moved=ema_moved)
    log(f"{'B7(b) w-prior' if model_w else 'B5'} pretrain: {cfg}; " + json.dumps(out))
    if not (all(math.isfinite(v) for v in losses) and len(losses) == B_PRETRAIN_STEPS
            and state.step == B_PRETRAIN_STEPS and ema_moved > 0):
        raise AssertionError(f"Burgers pretrain: {out}")
    return {k: v.clone() for k, v in state.ema_params.items()}, out


def phase_burgers_finetune(burgers, data, params):
    """B6: posttrain (2 epochs of 2 steps at batch 380, one recalibration),
    then one evaluate, and the same posttrain eagerly (its seconds and peak
    memory against the captured run's, and its weights' largest difference
    from them); InfFT (InfFT_iters 2: one step at B = 50, calibrate,
    evaluate); both from the pretrained EMA, calibrating on B_FT_CAL sims.
    InfFT's loss MSE(relu(max s + Q - bound^2), 0) is 0 with no gradient
    when every predicted max lies below bound^2 - Q; one more step at Q = 1
    then runs."""
    from safediffcon_torch.tasks.burgers.pipeline import infft_step, make_train_state
    from safediffcon_torch.core.train import make_optimizer

    cut = dict(cal_batch_size=B_FT_CAL, num_cal_batch=1, ddim_sampling_steps=B_FT_DDIM)
    cal, test, train = data["cal"], data["test"], data["train"]
    out = {}
    for name in ("posttrain", "infft"):
        if name == "posttrain":
            base = burgers.BurgersPostTrainConfig()
            cfg = dataclasses.replace(base, finetune_epoch=2, finetune_steps=2,
                                      conformal=dataclasses.replace(base.conformal, **cut))
        else:
            base = burgers.BurgersInfFTConfig()
            cfg = dataclasses.replace(base, InfFT_iters=2,
                                      conformal=dataclasses.replace(base.conformal, **cut))
        # its calibrations in one chunk: one call of a captured calibration
        # is its eager warm-up, a second would be its capture
        pipe = burgers.BurgersPipeline(cfg.conformal, device="cuda", cal_chunk=B_FT_CAL,
                                       **B_MODEL)
        cal_s, marks = [], [time.perf_counter()]
        calibrate = pipe.calibrate

        def timed_calibrate(*a, **kw):
            t = time.perf_counter()
            q = calibrate(*a, **kw)
            torch.cuda.synchronize()
            cal_s.append(time.perf_counter() - t)
            return q

        def on_epoch(rec):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        pipe.calibrate = timed_calibrate
        pipe.phase_seconds = {}
        torch.cuda.reset_peak_memory_stats()
        if name == "posttrain":
            t0 = time.perf_counter()
            state, q, hist = burgers.posttrain(cfg, pipe, params, train, cal, test,
                                               on_epoch=on_epoch)
            torch.cuda.synchronize()
            captured = dict(seconds=time.perf_counter() - t0,
                            peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                            reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
            t0 = time.perf_counter()
            final = pipe.evaluate(state.ema_params, test, q,
                                  generator=torch.Generator(device="cuda").manual_seed(3))
            evaluate_s = time.perf_counter() - t0
        else:
            state, q, hist = burgers.inference_finetune(cfg, pipe, params, cal, test,
                                                        on_epoch=on_epoch)
            final = hist[-1]["eval"]
            evaluate_s = sum(pipe.phase_seconds.values())  # "evaluate" when captured
        changed = max(float((p.detach() - params[k]).abs().max())
                      for k, p in state.model.named_parameters())
        rec = dict(epochs=[dict(epoch=r["epoch"], loss=r["loss"], quantile=r["quantile"],
                                seconds=b - a) for r, a, b in zip(hist, marks, marks[1:])],
                   calibrate_s=cal_s, evaluate_s=evaluate_s,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, max_weight_change=changed,
                   metrics=final)
        if name == "posttrain":
            rec["batch"] = cfg.finetune_batch_size
            weights = {k: p.detach().clone() for k, p in state.model.named_parameters()}
            pipe = state = None  # the captured run's graphs and state freed
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            eager_pipe = burgers.BurgersPipeline(cfg.conformal, device="cuda",
                                                 cal_chunk=B_FT_CAL, capture=False, **B_MODEL)
            t0 = time.perf_counter()
            e_state, _, _ = burgers.posttrain(cfg, eager_pipe, params, train, cal, test)
            torch.cuda.synchronize()
            rec["posttrain_memory"] = dict(captured=captured, eager=dict(
                seconds=time.perf_counter() - t0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
                weights_max_diff=_same(weights, dict(e_state.model.named_parameters()))))
            del eager_pipe, e_state, weights
        log(f"B6 {name}: " + json.dumps(rec, sort_keys=True))
        values = [q, *final.values(), *(r["loss"] for r in hist)]
        if not (all(math.isfinite(float(v)) for v in values) and len(hist) == (
                cfg.finetune_epoch if name == "posttrain" else cfg.InfFT_iters - 1)):
            raise AssertionError(f"Burgers {name}: {rec}")
        if name == "posttrain" and not changed > 0:
            raise AssertionError("Burgers posttrain left the weights unchanged")
        if name == "infft" and hist[0]["loss"] == 0.0:
            tx = make_optimizer("adamw", cfg.finetune_lr, weight_decay=cfg.weight_decay,
                                betas=(0.9, 0.999), max_grad_norm=cfg.max_grad_norm)
            st = make_train_state(pipe, params, tx, cfg.ema_decay, cfg.ema_update_every)
            batch = torch.as_tensor(test.data, device="cuda")
            t0 = time.perf_counter()
            loss = float(infft_step(pipe, st, batch, 1.0,
                                    generator=torch.Generator(device="cuda").manual_seed(7)))
            rec["step_at_q1"] = dict(seconds=time.perf_counter() - t0, loss=loss)
            log(f"B6 InfFT step at Q = 1: {json.dumps(rec['step_at_q1'])}")
            if not (math.isfinite(loss) and loss > 0):
                raise AssertionError(f"Burgers InfFT step at Q = 1: loss {loss}")
        out[name] = rec
        del pipe, state
        torch.cuda.empty_cache()
    return out


def burgers_b7_small_run(burgers, data, device, draws) -> dict:
    """B7(a) on `device`, tiny UNet2Ds (dim 16, seeded 0 and 1): a two-model
    (prior_beta 0.5) DPM calibrate on 8 cal sims and guided evaluate of 4
    test sims; an ancestral chain of B7_ANCESTRAL_T steps with the guidance
    at x_{t-1} (guidance_on_x0=False) and self-recurrence, conditioned on
    the 4 test sims; one pretrain(model_w=True) step (Adam, lr 1e-3)."""
    from safediffcon_torch.core.diffusion import DiffusionConfig
    from safediffcon_torch.core.sampling import ancestral_sample
    from safediffcon_torch.core.schedules import make_schedule
    from safediffcon_torch.tasks.burgers.pipeline import build_model, init_params
    from safediffcon_torch.tasks.burgers.task import COND_IDX, BurgersConditioner

    dpm_draws, chain_draws, train_draws = draws

    def moved(x):
        return x.to(device)

    small = dict(dim=16, dim_mults=(1, 2))
    nets = [init_params(build_model(**small, device=device), seed=seed) for seed in (0, 1)]
    pair = tuple({k: v.detach() for k, v in net.state_dict().items()} for net in nets)
    test = burgers.BurgersDataset(data["test"].data[:4], data["test"].u_phys[:4],
                                  data["test"].f_phys[:4])
    conf = burgers.BurgersConformalConfig(**dict(BURGERS_SMALL_CONF, sampler="dpm",
                                                 ddim_sampling_steps=5))
    pipe = burgers.BurgersPipeline(conf, two_model=True, prior_beta=0.5, device=device, **small)
    noise = iter([(moved(z), []) for z in dpm_draws])
    q = float(pipe.calibrate(pair, data["cal"].data[:8], 0.0, noise=noise))
    m = pipe.evaluate(pair, test, q, noise=noise)

    T = B7_ANCESTRAL_T
    state = torch.as_tensor(test.data, device=device)
    init, steps = chain_draws
    with torch.no_grad():
        chain = ancestral_sample(
            nets[0], make_schedule(T, "cosine", device=device), DiffusionConfig(timesteps=T),
            state.shape, cond=BurgersConditioner(u0=state[:, 0, :, 0], uT=state[:, COND_IDX, :, 0]),
            guidance_grad=burgers.guidance_grad_fn(12.0, burgers.BurgersTaskConfig(w_score=5.0)),
            guidance_on_x0=False, recurrence=True, init_noise=moved(init),
            step_noise=[moved(z) for z in steps])

    cfg = dataclasses.replace(burgers.BurgersPretrainConfig(), **small, timesteps=100,
                              batch_size=4, lr=1e-3)
    losses = []
    st = burgers.pretrain(cfg, data["train"], num_steps=1, params=pair[0], device=device,
                          noise=iter([tuple(moved(x) for x in train_draws)]), losses=losses,
                          model_w=True)
    return dict(q=q, metrics=m, chain=chain.cpu(), w_loss=float(losses[0]),
                weights={k: v.detach().cpu() for k, v in st.model.state_dict().items()})


def phase_burgers_b7_agreement(burgers, data):
    """B7(a): `burgers_b7_small_run` on the card and on the CPU (whose paths
    the CPU tests hold against the JAX package) with the same weights and
    draws, TF32 off: Q-hat, the metrics, the ancestral chain, the w-prior's
    loss and its weights after the step must agree."""
    gen = torch.Generator().manual_seed(17)
    shape = (4, 16, 128, 3)
    T = B7_ANCESTRAL_T
    draws = ([torch.randn(shape, generator=gen) for _ in range(3)],  # 2 calibrate, 1 evaluate
             # the chain: per step the posterior draw, the second posterior
             # draw (guidance at x_{t-1}) and the recurrence's
             (torch.randn(shape, generator=gen),
              [torch.randn(shape, generator=gen) for _ in range(3 * (T - 1))]),
             (torch.randint(0, 100, (4,), generator=gen), torch.randn(shape, generator=gen)))
    with tf32_flag(False):
        results = {device: burgers_b7_small_run(burgers, data, device, draws)
                   for device in ("cuda", "cpu")}
    card, cpu = results["cuda"], results["cpu"]
    chain_diff = float((card["chain"] - cpu["chain"]).abs().max())
    w_diff = max(float((card["weights"][k] - v).abs().max()) for k, v in cpu["weights"].items())
    for device, r in results.items():
        log(f"B7(a) small input ({device}): two-model DPM Q-hat {r['q']:.6f}, w-prior loss "
            f"{r['w_loss']:.6f}, ancestral chain max |x| {float(r['chain'].abs().max()):.4f}, "
            f"metrics " + json.dumps(r["metrics"], sort_keys=True))
    log(f"B7(a): max |card - cpu| of the ancestral chain {chain_diff:.3e}, of the w-prior's "
        f"weights after its step {w_diff:.3e}")
    unit = burgers_tolerance_rates(4)
    # float32 on both sides, sums in other orders: Q and the loss 1e-4, J
    # 1e-3, a rate may move by one cell across the bound; the chain's 100
    # steps of a UNet2D evaluation and two guidance gradients each, on values
    # of order 1: 1e-4 (an H100 saw 4.3e-6); one Adam step of lr 1e-3 from
    # equal weights: 2 lr
    checks = [abs(card["q"] - cpu["q"]) <= 1e-4 * abs(cpu["q"]) + 1e-7,
              abs(card["w_loss"] - cpu["w_loss"]) <= 1e-4 * abs(cpu["w_loss"]),
              chain_diff <= 1e-4, bool(torch.isfinite(cpu["chain"]).all()), w_diff < 2e-3]
    for name, ref in cpu["metrics"].items():
        tol = unit[name] + 1e-6 if name in unit else 1e-3 * abs(ref) + 1e-7
        checks.append(abs(card["metrics"][name] - ref) <= tol)
    if not all(checks):
        raise AssertionError(f"B7(a): card and CPU disagree ({checks})")
    return dict(chain_max_diff=chain_diff, weights_max_diff=w_diff, q=cpu["q"])


def burgers_serve(burgers, label: str, ccfg, params, cal, test=None, **pipe_kw) -> dict:
    """Calibrate on `cal` (and guided evaluate on `test`) at the turbo width
    with `ccfg`; ms per sampler step, peak memory."""
    pipe = burgers.BurgersPipeline(ccfg, device="cuda", capture=False, **B_MODEL, **pipe_kw)
    # model evaluations per sampler call: the ancestral sampler takes every
    # timestep when ddim_sampling_steps >= timesteps
    steps = min(ccfg.ddim_sampling_steps, ccfg.timesteps)
    chunks = -(-len(cal) // min(pipe.cal_chunk, ccfg.cal_batch_size))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = float(pipe.calibrate(params, cal, 0.0,
                             generator=torch.Generator(device="cuda").manual_seed(1)))
    calibrate_s = time.perf_counter() - t0
    out = dict(sampler=ccfg.sampler, steps=steps, cal_sims=len(cal), calibrate_s=calibrate_s,
               ms_per_cal_step=1e3 * calibrate_s / (steps * chunks),
               peak_gb_calibrate=torch.cuda.max_memory_allocated() / 1e9, q=q, **pipe_kw)
    values = [q]
    if test is not None:
        pipe.phase_seconds = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = pipe.evaluate(params, test, q,
                                generator=torch.Generator(device="cuda").manual_seed(2))
        sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]
        out.update(evaluate_s=time.perf_counter() - t0, sampling_s=sampling_s,
                   rollout_s=rollout_s, ms_per_guided_step=1e3 * sampling_s / steps,
                   peak_gb_evaluate=torch.cuda.max_memory_allocated() / 1e9, metrics=metrics)
        values += list(metrics.values())
    log(f"{label}: " + json.dumps(out, sort_keys=True))
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: non-finite result {out}")
    del pipe
    torch.cuda.empty_cache()
    return out


def phase_burgers_b7(burgers, data, main_params):
    """B7: the samplers beyond DDIM and two-model composition. (a) card
    against CPU on tiny UNet2Ds; (b) the w-only prior's pretrain (batch 16,
    B_PRETRAIN_STEPS steps after one); at the turbo width, from B5's EMA as
    the main model: (c) two-model serving with (b)'s EMA as the prior,
    prior_beta 0.5 (the JAX CLI's default), DDIM B7_DDIM, calibrate on B7_CAL
    cal sims and guided evaluate on the 50 test sims; (d) sampler "dpm" with
    DPM_STEPS steps, calibrate on B4_CAL cal sims and guided evaluate; (e)
    the ancestral sampler through calibrate (ddim_sampling_steps 1,000 =
    timesteps) on B7_CAL cal sims."""
    out = dict(agreement=phase_burgers_b7_agreement(burgers, data))
    prior, out["w_prior_pretrain"] = phase_burgers_pretrain(burgers, data, model_w=True)
    base = burgers.BurgersConformalConfig()
    cal, test = data["cal"].data, data["test"]
    out["two_model"] = burgers_serve(
        burgers, "B7(c) two-model DDIM serving",
        dataclasses.replace(base, ddim_sampling_steps=B7_DDIM), (main_params, prior),
        cal[:B7_CAL], test, two_model=True, prior_beta=0.5)
    out["dpm"] = burgers_serve(
        burgers, "B7(d) DPM serving",
        dataclasses.replace(base, sampler="dpm", ddim_sampling_steps=DPM_STEPS), main_params,
        cal[:B4_CAL], test)
    out["ancestral"] = burgers_serve(
        burgers, "B7(e) ancestral calibrate",
        dataclasses.replace(base, timesteps=B7_E_T, ddim_sampling_steps=B7_E_T), main_params,
        cal[:B7_CAL])
    return out


# ---------------------------------------------------------------------------
# Phase 10: UNet3D in bfloat16 (K2 in bf16) and remat "save_heavy"
# ---------------------------------------------------------------------------

class StepClock(list):
    """A `losses` list for `pretrain` that syncs and marks the time after
    each step, and calls `on_first` after the first (warm-up) one."""

    def __init__(self, on_first=None):
        super().__init__()
        self.marks = []
        self.on_first = on_first

    def append(self, loss):
        torch.cuda.synchronize()
        self.marks.append(time.perf_counter())
        super().append(loss)
        if len(self.marks) == 1 and self.on_first is not None:
            self.on_first()


def phase_smoke_bf16_agreement(C, smoke, train):
    """10a: two pretrain steps of a small UNet3D(conv_impl="pallas",
    compute_dtype="bfloat16") on the card (K2 in bf16) and on the CPU (its
    plain version, which the CPU tests hold against the JAX package) from
    the same weights and draws."""
    from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

    cfg = smoke.SmokePretrainConfig(dim=16, dim_mults=(1, 2), timesteps=6, batch_size=2,
                                    conv_impl="pallas", compute_dtype="bfloat16")
    raw = train.raw[:4, ::8, ::4, ::4]  # 4 frames of 16^2
    small = smoke.SmokeDataset(data=raw / smoke.RESCALER, raw=raw)
    params = init_params(build_model(16, (1, 2), device="cpu"), seed=5).state_dict()
    gen = torch.Generator().manual_seed(6)
    draws = [(torch.randint(0, cfg.timesteps, (2,), generator=gen),
              torch.randn((2, *raw.shape[1:]), generator=gen)) for _ in range(2)]
    n_convs = count_fused_convs(build_model(16, (1, 2), conv_impl="pallas", device="cpu"))
    zero_k2_counts(C)
    results = {}
    for device in ("cuda", "cpu"):
        noise = iter([(t.to(device), n.to(device)) for t, n in draws])
        losses = []
        with GradRecorder() as grads:
            state = smoke.pretrain(cfg, small, num_steps=2, params=params, device=device,
                                   noise=noise, losses=losses)
        moved = torch.cat([(p.detach().cpu() - params[k]).flatten()
                           for k, p in state.model.named_parameters()])
        results[device] = ([float(v) for v in losses], moved, grads.steps)
    modes = dict(C.conv3d_fused_cuda.launches)
    (card_l, card_m, card_g), (cpu_l, cpu_m, cpu_g) = results["cuda"], results["cpu"]
    cosine = float(card_m @ cpu_m / (card_m.norm() * cpu_m.norm()))
    out = dict(card_losses=card_l, cpu_losses=cpu_l, grad_rel_errs=grad_rel_errs(card_g, cpu_g),
               update_cosine=cosine, k2_modes=modes, simt=C.conv3d_fused_simt_cuda.launches)
    log("10a small bf16 pretrain " + json.dumps(out))
    # per step: each conv's forward, its recomputation and its dx, in bf16
    if modes != dict(tf32=0, **{"3xtf32": 0}, bf16=2 * 3 * n_convs) or out["simt"]:
        raise AssertionError(f"10a: the card's small bf16 pretrain ran K2 as {modes}")
    # bf16 on both sides, the same roundings with float32 sums in other
    # orders: the losses within 1.5e-3 (about 10x the 1.3e-4 an H100 saw),
    # each step's gradients within 1e-1 (3-9x the 1.1e-2 and 3.0e-2 an
    # H100 saw; the second step starts from weights that differ); two Adam
    # steps move each weight by about lr * sign(g), so the updates point
    # the same way (cosine near 1) unless the gradients disagree
    if not (all(abs(a - b) <= 1.5e-3 * abs(b) for a, b in zip(card_l, cpu_l))
            and max(out["grad_rel_errs"]) <= 1e-1 and cosine > 0.9):
        raise AssertionError(f"10a: card and CPU bf16 pretrain disagree: {out}")
    return out


def phase_smoke_bf16_training(C, smoke, train):
    """10b-10c: the smoke pretrain at the reference width on K2 (conv_impl
    "pallas", batch 16) in bf16 with remat "full", then float32 (TF32) and
    bf16 with "save_heavy"; each 1 + SMOKE_STEPS steps in one call, timed
    after the first. K2's counts are zeroed just before each call and read
    just after: 90 tensor-core launches per step, all in the run's mode."""
    from safediffcon_torch.tasks.smoke.pipeline import build_model

    n_convs = count_fused_convs(build_model(conv_impl="pallas", device="meta"))
    runs = {"bf16_full": dict(compute_dtype="bfloat16"),
            "tf32_save_heavy": dict(remat_policy="save_heavy"),
            "bf16_save_heavy": dict(compute_dtype="bfloat16", remat_policy="save_heavy")}
    out = {}
    for name, kw in runs.items():
        cfg = smoke.SmokePretrainConfig(conv_impl="pallas", **kw)
        mode = "bf16" if cfg.compute_dtype else C.kernel_mode(torch.float32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def start_events():
            C.conv3d_fused_cuda.events = []

        clock = StepClock(on_first=start_events)
        zero_k2_counts(C)
        smoke.pretrain(cfg, train, num_steps=1 + SMOKE_STEPS, device="cuda", losses=clock)
        modes = dict(C.conv3d_fused_cuda.launches)
        simt = C.conv3d_fused_simt_cuda.launches
        k2_s = sum(a.elapsed_time(b) for a, b in C.conv3d_fused_cuda.events) / 1e3
        C.conv3d_fused_cuda.events = None
        seconds = clock.marks[-1] - clock.marks[0]
        losses = [float(v) for v in clock]
        out[name] = dict(s_per_step=seconds / SMOKE_STEPS, k2_s=k2_s, k2_share=k2_s / seconds,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9, k2_modes=modes,
                         simt_launches=simt, losses=losses, mode=mode)
        log(f"10 pretrain {name}: {cfg}; " + json.dumps(out[name]))
        expected = dict.fromkeys(C.MODES, 0)
        expected[mode] = 3 * n_convs * (1 + SMOKE_STEPS)
        if modes != expected or simt:
            raise AssertionError(f"10 pretrain {name}: K2 ran {modes} (SIMT {simt}), expected "
                                 f"{expected}")
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"10 pretrain {name}: losses {losses}")
    return out


def phase_smoke_bf16_sampling(smoke, test):
    """10d: guided DDIM steps of SmokePipeline at B = 50 (the framework conv,
    as in phase 4), float32 (TF32) and bf16 compute, SMOKE_STEPS steps each
    after one warm-up forward."""
    from safediffcon_torch.tasks.smoke.pipeline import init_params

    ccfg = dataclasses.replace(smoke.SmokeConformalConfig(), ddim_sampling_steps=SMOKE_STEPS)
    state = torch.as_tensor(test.data[:N_TEST], device="cuda")
    out = {}
    for name, dtype in (("float32", None), ("bfloat16", "bfloat16")):
        pipe = smoke.SmokePipeline(ccfg, compute_dtype=dtype, device="cuda")
        init_params(pipe.model, seed=0)
        t = torch.full((N_TEST,), 500, device="cuda")
        with torch.no_grad():
            pipe.model(state, t)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pred = pipe._sample_test(state, 0.05, guided=True,
                                 generator=torch.Generator(device="cuda").manual_seed(2))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[name] = dict(ms_per_guided_step=1e3 * seconds / SMOKE_STEPS,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         finite=bool(torch.isfinite(pred).all()))
        del pipe, pred
        torch.cuda.empty_cache()
    log(f"10d guided DDIM at B = {N_TEST}, {SMOKE_STEPS} steps: " + json.dumps(out))
    if not all(v["finite"] for v in out.values()):
        raise AssertionError(f"10d: non-finite samples {out}")
    return out


def phase_smoke_dpm_serving(K, C, smoke, data):
    """11: SmokePipeline with sampler "dpm" (DPM-Solver++(2M), DPM_STEPS
    steps) at full width with phase 4's seeded weights and data: calibrate
    on SERVE_CAL cal sims and guided evaluate on the N_TEST test sims, each
    one batch, the solver on K1 (backend "auto"). K1's count is zeroed just
    before calibrate and must read 255 per evaluated batch just after
    evaluate; K2's counts must read 0."""
    from safediffcon_torch.tasks.smoke.pipeline import init_params

    _, cal, test = data
    ccfg = smoke.SmokeConformalConfig(sampler="dpm", ddim_sampling_steps=DPM_STEPS,
                                      cal_batch_size=SERVE_CAL, num_cal_batch=1,
                                      n_test_samples=N_TEST, test_batch_size=N_TEST)
    pipe = smoke.SmokePipeline(ccfg, device="cuda")
    init_params(pipe.model, seed=0)
    # the main path: counts zeroed just before, read just after
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = float(pipe.calibrate(smoke.SmokeDataset(cal.data[:SERVE_CAL], cal.raw[:SERVE_CAL]), 0.0,
                             generator=torch.Generator(device="cuda").manual_seed(1)))
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    pipe.phase_seconds = {}
    t0 = time.perf_counter()
    metrics = pipe.evaluate(test, q, generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    evaluate_s = time.perf_counter() - t0
    launches = K.pressure_cg_cuda.launches
    k2 = (k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]
    out = dict(steps=DPM_STEPS, cal_sims=SERVE_CAL, calibrate_s=calibrate_s,
               s_per_conditioned_step=calibrate_s / DPM_STEPS, evaluate_s=evaluate_s,
               sampling_s=sampling_s, rollout_s=rollout_s,
               s_per_guided_step=sampling_s / DPM_STEPS, peak_gb_calibrate=cal_peak_gb,
               peak_gb_evaluate=torch.cuda.max_memory_allocated() / 1e9, q=q,
               k1_launches=launches, k2_launches=k2[0], k2_simt_launches=k2[1])
    log("phase 11 smoke DPM serving " + json.dumps(out, sort_keys=True))
    log("phase 11 metrics " + json.dumps(metrics, sort_keys=True))
    expected = SOLVER_STEPS * -(-N_TEST // pipe.eval_chunk)
    if launches != expected or any(k2):
        raise AssertionError(f"phase 11 launched K1 {launches} times (expected {expected}) and "
                             f"K2 {k2} times (expected 0)")
    if not (math.isfinite(q) and all(math.isfinite(v) for v in metrics.values())):
        raise AssertionError(f"phase 11: non-finite result: Q {q}, metrics {metrics}")
    return launches, out


# ---------------------------------------------------------------------------
# Tokamak (phases T1-T7): UNet1D, the KSTAR surrogate, guided DDIM, training
# ---------------------------------------------------------------------------

def count_launches(fn, per: int) -> float:
    """CUDA kernels per unit of `fn`'s work (`per` units), by torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernels / per if kernels else "not measured"


def phase_tokamak_solver(kstar):
    """T1: the surrogate on the card and on the CPU: the three reference
    golden rollouts; ms per rollout at B = 50 and at datagen's batch, open
    loop and closed loop; kernel launches per solver step."""
    golden = np.load(ROOT / "tests" / "golden" / "kstar_reference_rollouts.npz")
    actions = torch.from_numpy(np.stack([golden[f"actions_{i}"] for i in range(3)]))
    ref = np.stack([golden[f"outputs_{i}"] for i in range(3)])
    card_p, cpu_p = kstar.load_kstar_params(device="cuda"), kstar.load_kstar_params(device="cpu")
    card = kstar.simulate_batch(card_p, actions.cuda()).cpu().numpy()
    cpu = kstar.simulate_batch(cpu_p, actions).numpy()
    golden_err = float((np.abs(card - ref) / (np.abs(ref) + 1e-6)).max())
    cpu_err = float((np.abs(card - cpu) / (np.abs(cpu) + 1e-6)).max())
    n_gen = T_N_TRAIN + T_N_CAL + T_N_TEST
    acts50 = actions.cuda().repeat(-(-T_BATCH // 3), 1, 1)[:T_BATCH]
    acts_gen = actions.cuda().repeat(-(-n_gen // 3), 1, 1)[:n_gen]
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = dict(
        golden_max_rel_err=golden_err, card_vs_cpu_max_rel_err=cpu_err,
        ms_per_rollout_50=cuda_ms(lambda: kstar.simulate_batch(card_p, acts50), reps=2),
        ms_per_rollout_datagen=cuda_ms(lambda: kstar.simulate_batch(card_p, acts_gen), reps=1),
        ms_per_closed_loop_50=cuda_ms(lambda: kstar.closed_loop_batch(card_p, T_BATCH, gen),
                                      reps=1),
        ms_per_closed_loop_datagen=cuda_ms(lambda: kstar.closed_loop_batch(card_p, n_gen, gen),
                                           reps=1),
        launches_per_step=count_launches(lambda: kstar.simulate_batch(card_p, acts50[:, :10]),
                                         10),
        launches_per_closed_loop_step=count_launches(
            lambda: kstar.closed_loop_batch(card_p, T_BATCH, gen), kstar.NT_ACTIONS),
        datagen_batch=n_gen, steps=kstar.NT_ACTIONS)
    log("T1 solver " + json.dumps(out))
    # the reference's own bound (tests/test_kstar_solver.py); the same
    # float32 arithmetic on both devices, sums in other orders
    if not (np.isfinite(card).all() and golden_err < 1e-4 and cpu_err < 1e-4):
        raise AssertionError(f"T1: the surrogate on the card misses the goldens: {out}")
    return out


def phase_tokamak_datagen(tokamak):
    """T2: T_N_TRAIN + T_N_CAL + T_N_TEST closed-loop trajectories in one
    batch (seed 0), the rollout and the npz save timed apart."""
    path = str(ROOT / "build" / "chip_smoke" / "tokamak.npz")
    phases = {}
    tokamak.generate_tokamak_dataset(path, n_train=T_N_TRAIN, n_cal=T_N_CAL, n_test=T_N_TEST,
                                     seed=0, gen_batch=8192, device="cuda",
                                     phase_seconds=phases)
    data = {s: tokamak.TokamakDataset.load(path, s) for s in ("train", "cal", "test")}
    log(f"T2 datagen: {T_N_TRAIN} + {T_N_CAL} + {T_N_TEST} trajectories (reference 48,950 "
        f"train, cut to what T5-T6 read) in one batch; seconds {json.dumps(phases)}")
    for name, d in data.items():
        if not (np.isfinite(d.data).all() and d.data.shape[1:] == (128, 12)):
            raise AssertionError(f"tokamak datagen: {name} split is not finite or misshapen")
    return data, phases


TOKAMAK_SMALL_CONF = dict(cal_batch_size=4, num_cal_batch=2, n_cal_samples=8, n_test_samples=4,
                          test_batch_size=4, ddim_sampling_steps=4, timesteps=8, w_obj=1.0)


def tokamak_small_run(tokamak, data, device, draws) -> dict:
    """A tiny UNet1D (dim 16, seeded weights) on `device` with the given
    draws: calibrate on 8 cal sims, evaluate 4 test sims unguided and
    guided, then one post-training step and one InfFT step (w_obj 1, so the
    loss reaches the weights through the βp and li channels)."""
    from safediffcon_torch.tasks.tokamak.pipeline import init_params, make_finetune_steps

    def moved(x):
        return x.to(device)

    sampler_draws, train_draws = draws
    cal = tokamak.TokamakDataset(data["cal"].data[:8], data["cal"].state_phys[:8])
    test = tokamak.TokamakDataset(data["test"].data[:4], data["test"].state_phys[:4])
    pipe = tokamak.TokamakPipeline(tokamak.TokamakConformalConfig(**TOKAMAK_SMALL_CONF), dim=16,
                                   dim_mults=(1, 2), device=device)
    init_params(pipe.model, seed=0)
    noise = iter([(moved(i), [moved(z) for z in st]) for i, st in sampler_draws])
    q = float(pipe.calibrate(None, cal, 0.0, noise=noise))
    m = pipe.evaluate(None, test, q, noise=noise)
    g = pipe.evaluate(None, test, q, guided=True, noise=noise)
    cfg = dataclasses.replace(tokamak.posttrain_config(), conformal=pipe.ccfg, finetune_lr=1e-3)
    tx, weighted_step, backward_step = make_finetune_steps(cfg, pipe)
    opt_state = tx.init(list(pipe.model.parameters()))
    batch = torch.as_tensor(test.data, device=device)
    target = torch.as_tensor(test.state_phys, device=device)
    with GradRecorder() as grads:
        post = float(weighted_step(opt_state, batch, torch.ones(4, device=device),
                                   noise=tuple(moved(x) for x in train_draws)))
        infft = float(backward_step(opt_state, batch, target, q, noise=next(noise)))
    weights = {k: v.detach().cpu() for k, v in pipe.model.state_dict().items()}
    return dict(q=q, metrics=m, guided_metrics=g, posttrain_loss=post, infft_loss=infft,
                weights=weights, grads=grads.steps)


def phase_tokamak_small_agreement(tokamak, data):
    """T3: `tokamak_small_run` on the card and on the CPU (whose path the CPU
    tests hold against the JAX package) with the same draws, TF32 off:
    Q-hat, the metrics, both losses, each step's gradients and the weights
    after the two steps must agree."""
    gen = torch.Generator().manual_seed(12)
    shape = (4, 128, 12)

    def sampler_draws():
        return torch.randn(shape, generator=gen), [torch.randn(shape, generator=gen)
                                                   for _ in range(3)]

    draws = ([sampler_draws() for _ in range(5)],  # 2 calibrate, 2 evaluate, 1 InfFT
             (torch.randint(0, 8, (4,), generator=gen), torch.randn(shape, generator=gen)))
    with tf32_flag(False):
        results = {device: tokamak_small_run(tokamak, data, device, draws)
                   for device in ("cuda", "cpu")}
    card, cpu = results["cuda"], results["cpu"]
    for device, r in results.items():
        log(f"T3 small input ({device}): Q-hat {r['q']:.6f}, posttrain loss "
            f"{r['posttrain_loss']:.6f}, InfFT loss {r['infft_loss']:.6f}, metrics "
            + json.dumps(r["metrics"], sort_keys=True) + ", guided "
            + json.dumps(r["guided_metrics"], sort_keys=True))
    # float32 on both sides, sums in other orders: Q and the losses 1e-4;
    # the metrics 1e-3 (the surrogate's 1e-3 action quantisation can turn a
    # rounding difference into one step), a ratio may move by one row or
    # one sample across the threshold
    unit = {"time_below_ratio": 1 / (4 * 122), "sample_below_ratio": 1 / 4}
    checks = [abs(card["q"] - cpu["q"]) <= 1e-4 * abs(cpu["q"]) + 1e-7,
              abs(card["posttrain_loss"] - cpu["posttrain_loss"])
              <= 1e-4 * abs(cpu["posttrain_loss"]),
              abs(card["infft_loss"] - cpu["infft_loss"]) <= 1e-4 * abs(cpu["infft_loss"]),
              cpu["infft_loss"] > 0]
    for key in ("metrics", "guided_metrics"):
        for name, ref in cpu[key].items():
            tol = unit[name] + 1e-6 if name in unit else 1e-3 * abs(ref) + 1e-7
            checks.append(abs(card[key][name] - ref) <= tol)
    # the gradients of the post-training and the InfFT step, float32 sums
    # in other orders: 2e-5 relative (an H100 saw 1.8e-7 and 1.8e-6); then
    # Adam (lr 1e-3) steps each weight by about lr * sign(g), so an entry
    # whose gradient is near 0 may step either way: 99 % of the weights
    # within 1e-4 lr (an H100 saw 1.5e-8)
    errs = grad_rel_errs(card["grads"], cpu["grads"])
    checks.append(max(errs) <= 2e-5)
    diff = torch.cat([(card["weights"][k] - v).abs().flatten()
                      for k, v in cpu["weights"].items()])
    checks.append(float(diff.quantile(0.99)) <= 1e-4 * 1e-3)
    log(f"T3 small input: gradients' relative L2 error (posttrain, InfFT) {errs}; |card - cpu| "
        f"of the weights after the two steps: 99th percentile "
        f"{float(diff.quantile(0.99)):.3e}, max {float(diff.max()):.3e}")
    if not all(checks):
        raise AssertionError(f"tokamak small input: card and CPU disagree ({checks})")


def phase_tokamak_serving(tokamak, data):
    """T4: the TokamakConformalConfig defaults (DDIM 200, eta 1, alpha 0.9,
    threshold 4.98) at the turbo width, float32 at the default flags:
    calibrate on the 1,000 cal sims in one chunk, evaluate the 50 test sims
    unguided (the default), then guided with guidance_scaler 5 (as
    posttrain_config sets it); ms per step, the surrogate's share of
    evaluate, peak memory, and a torch.profiler breakdown of one forward at
    B = 50 with its bound from its FLOPs at the TF32 peak."""
    from safediffcon_torch.tasks.tokamak.pipeline import init_params

    ccfg = tokamak.TokamakConformalConfig()
    pipe = tokamak.TokamakPipeline(ccfg, cal_chunk=T_CAL_CHUNK, device="cuda", capture=False)
    init_params(pipe.model, seed=0)
    n_params = sum(p.numel() for p in pipe.model.parameters())
    steps = ccfg.ddim_sampling_steps
    log(f"T4 serving: UNet1D turbo, {n_params} parameters, seeded weights; {ccfg}; calibrate "
        f"{len(data['cal'])} sims in chunks of {pipe.cal_chunk} (the JAX default is 50)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = float(pipe.calibrate(None, data["cal"], 0.0,
                             generator=torch.Generator(device="cuda").manual_seed(1)))
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = {}
    guided_pipe = tokamak.TokamakPipeline(dataclasses.replace(ccfg, guidance_scaler=5.0),
                                          device="cuda", capture=False)
    guided_pipe.model.load_state_dict(pipe.model.state_dict())
    for name, p, guided in (("unguided", pipe, False), ("guided", guided_pipe, True)):
        p.phase_seconds = {}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = p.evaluate(None, data["test"], q, guided=guided,
                             generator=torch.Generator(device="cuda").manual_seed(2))
        evaluate_s = time.perf_counter() - t0
        sampling_s, rollout_s = p.phase_seconds["sampling"], p.phase_seconds["rollout"]
        runs[name] = dict(evaluate_s=evaluate_s, sampling_s=sampling_s, rollout_s=rollout_s,
                          solver_share=rollout_s / (sampling_s + rollout_s),
                          ms_per_step=1e3 * sampling_s / steps,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9, metrics=metrics)
    shape = (T_BATCH, 128, 12)
    flops = forward_flops(pipe.model, shape)
    prof = profile_forward(pipe.model, shape)
    out = dict(calibrate_s=calibrate_s, cal_sims=len(data["cal"]), cal_chunk=pipe.cal_chunk,
               ms_per_cal_step=1e3 * calibrate_s / steps, peak_gb_calibrate=cal_peak_gb,
               evaluate=runs, q=q, forward_gflop=flops / 1e9,
               forward_bound_ms_tf32=1e3 * flops / TF32_FLOPS_PER_S, forward_profile=prof,
               flags=dict(cudnn_tf32=torch.backends.cudnn.allow_tf32,
                          matmul_tf32=torch.backends.cuda.matmul.allow_tf32))
    log("T4 serving " + json.dumps(out, sort_keys=True))
    values = [q, *runs["unguided"]["metrics"].values(), *runs["guided"]["metrics"].values()]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"tokamak serving: non-finite result: {out}")
    return out


def phase_tokamak_pretrain(tokamak, data):
    """T5: TokamakPretrainConfig defaults (batch 16) for T_PRETRAIN_STEPS
    steps after one warm-up step, from seeded weights; the loop's set-up,
    timed alone, is taken off the steps' time."""
    from safediffcon_torch.tasks.tokamak.pipeline import build_model, init_params

    cfg = tokamak.TokamakPretrainConfig()
    train = data["train"]
    init = init_params(build_model(cfg.dim, cfg.dim_mults, cfg.resnet_block_groups,
                                   device="cuda"), seed=cfg.seed)
    init = {k: v.detach() for k, v in init.state_dict().items()}
    tokamak.pretrain(cfg, train, num_steps=1, params=init, device="cuda")  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokamak.pretrain(cfg, train, num_steps=T_PRETRAIN_STEPS, params=init, device="cuda",
                     deadline=0.0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    state = tokamak.pretrain(cfg, train, num_steps=T_PRETRAIN_STEPS, params=init,
                             device="cuda", losses=losses)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - setup_s
    losses = [float(v) for v in losses]
    ema_moved = max(float((state.ema_params[k] - init[k]).abs().max()) for k in init)
    out = dict(steps=T_PRETRAIN_STEPS, batch=cfg.batch_size, setup_s=setup_s, seconds=seconds,
               s_per_step=seconds / T_PRETRAIN_STEPS,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, losses=losses,
               ema_moved=ema_moved)
    log(f"T5 pretrain: {cfg}; " + json.dumps(out))
    if not (all(math.isfinite(v) for v in losses) and len(losses) == T_PRETRAIN_STEPS
            and state.step == T_PRETRAIN_STEPS and ema_moved > 0):
        raise AssertionError(f"tokamak pretrain: {out}")
    return {k: v.clone() for k, v in state.ema_params.items()}, out


def phase_tokamak_finetune(tokamak, data, params):
    """T6: from T5's EMA, run_inference with posttrain_config() for 1 epoch
    of 1 step at batch 1,000, and with finetune_config() for 1 epoch of 1
    InfFT step at B = 50, both at DDIM T_FT_DDIM; each epoch calibrates on
    T_FT_CAL cal sims in one chunk. InfFT's loss relu(threshold - min q95 + Q) has no
    gradient where the sample's x0 estimate of q95 sits at the clip, as with
    barely trained weights; one more InfFT step with w_obj 1 (the βp and li
    objective) must then move the weights."""
    from safediffcon_torch.tasks.tokamak.pipeline import make_finetune_steps

    cal, test, train = data["cal"], data["test"], data["train"]
    cal = tokamak.TokamakDataset(data=cal.data[:T_FT_CAL], state_phys=cal.state_phys[:T_FT_CAL])
    runs = {name: dataclasses.replace(cfg, finetune_epoch=1, conformal=dataclasses.replace(
                cfg.conformal, ddim_sampling_steps=T_FT_DDIM))
            for name, cfg in (("posttrain", tokamak.posttrain_config()),
                              ("infft", tokamak.finetune_config()))}
    out = {}
    for name, cfg in runs.items():
        pipe = tokamak.TokamakPipeline(cfg.conformal, cal_chunk=T_CAL_CHUNK, device="cuda")
        cal_s, marks = [], [time.perf_counter()]
        calibrate = pipe.calibrate

        def timed_calibrate(*a, **kw):
            t = time.perf_counter()
            q = calibrate(*a, **kw)
            torch.cuda.synchronize()
            cal_s.append(time.perf_counter() - t)
            return q

        def on_epoch(rec):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

        pipe.calibrate = timed_calibrate
        pipe.phase_seconds = {}
        torch.cuda.reset_peak_memory_stats()
        new, q, hist = tokamak.run_inference(cfg, pipe, params, train, cal, test,
                                             on_epoch=on_epoch)
        changed = max(float((new[k] - params[k]).abs().max()) for k in params)
        rec = dict(epochs=[dict(epoch=r["epoch"], loss=r["loss"], quantile=r["quantile"],
                                seconds=b - a) for r, a, b in zip(hist, marks, marks[1:])],
                   calibrate_s=cal_s,
                   evaluate_s=sum(pipe.phase_seconds.values()),  # "evaluate" when captured
                   rollout_s=pipe.phase_seconds.get("rollout", "captured with the sampler"),
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9, max_weight_change=changed,
                   metrics=hist[-1]["eval"])
        log(f"T6 {name}: " + json.dumps(rec, sort_keys=True))
        values = [float(q), *hist[-1]["eval"].values(), *(r["loss"] for r in hist)]
        if not (all(math.isfinite(v) for v in values) and len(hist) == cfg.finetune_epoch):
            raise AssertionError(f"tokamak {name}: {rec}")
        if name == "posttrain" and not changed > 0:
            raise AssertionError("tokamak posttrain left the weights unchanged")
        if name == "infft" and not changed > 0:
            pipe.task_cfg = dataclasses.replace(pipe.task_cfg, w_obj=1.0)
            tx, _, backward_step = make_finetune_steps(cfg, pipe)
            before = {k: v.clone() for k, v in pipe.model.state_dict().items()}
            t0 = time.perf_counter()
            loss = float(backward_step(
                tx.init(list(pipe.model.parameters())), torch.as_tensor(test.data, device="cuda"),
                torch.as_tensor(test.state_phys, device="cuda"), q,
                generator=torch.Generator(device="cuda").manual_seed(7)))
            moved = max(float((v - before[k]).abs().max())
                        for k, v in pipe.model.state_dict().items())
            rec["step_with_objective"] = dict(seconds=time.perf_counter() - t0, loss=loss,
                                              max_weight_change=moved)
            log(f"T6 InfFT step with w_obj 1: {json.dumps(rec['step_with_objective'])}")
            if not (math.isfinite(loss) and loss > 0 and moved > 0):
                raise AssertionError(f"tokamak InfFT step with w_obj 1: loss {loss}, weights "
                                     f"moved {moved}")
        out[name] = rec
        del pipe, new
        torch.cuda.empty_cache()
    return out


def phase_tokamak_dpm(tokamak, data, params):
    """T7: sampler "dpm" with DPM_STEPS steps at the turbo width from T5's
    EMA: calibrate on the 1,000 cal sims as one chunk, then an unguided
    evaluate (the default) on the 50 test sims; ms per step, peak memory."""
    ccfg = tokamak.TokamakConformalConfig(sampler="dpm", ddim_sampling_steps=DPM_STEPS)
    pipe = tokamak.TokamakPipeline(ccfg, cal_chunk=T_CAL_CHUNK, device="cuda", capture=False)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = float(pipe.calibrate(params, data["cal"], 0.0,
                             generator=torch.Generator(device="cuda").manual_seed(1)))
    calibrate_s = time.perf_counter() - t0
    cal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    pipe.phase_seconds = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = pipe.evaluate(params, data["test"], q,
                            generator=torch.Generator(device="cuda").manual_seed(2))
    evaluate_s = time.perf_counter() - t0
    sampling_s, rollout_s = pipe.phase_seconds["sampling"], pipe.phase_seconds["rollout"]
    out = dict(steps=DPM_STEPS, cal_sims=len(data["cal"]), cal_chunk=pipe.cal_chunk,
               calibrate_s=calibrate_s, ms_per_cal_step=1e3 * calibrate_s / DPM_STEPS,
               peak_gb_calibrate=cal_peak_gb, evaluate_s=evaluate_s, sampling_s=sampling_s,
               rollout_s=rollout_s, ms_per_step=1e3 * sampling_s / DPM_STEPS,
               peak_gb_evaluate=torch.cuda.max_memory_allocated() / 1e9, q=q, metrics=metrics)
    log("T7 DPM serving " + json.dumps(out, sort_keys=True))
    if not all(math.isfinite(v) for v in [q, *metrics.values()]):
        raise AssertionError(f"tokamak DPM serving: non-finite result: {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 12: the command line (python -m safediffcon_torch.cli.main) and the
# training-loop options
# ---------------------------------------------------------------------------

def run_cli(argv: list) -> None:
    """One in-process command of the port's command line, so that the launch
    counters can be read; it must return 0."""
    from safediffcon_torch.cli.main import main as cli_main

    t0 = time.perf_counter()
    rc = cli_main(argv)
    torch.cuda.synchronize()
    log(f"12 cli {' '.join(argv)}: rc {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError(f"the command line returned {rc} for {argv}")


def phase_cli_subprocess() -> dict:
    """12a: `python3 -m safediffcon_torch.cli.main burgers generate-data` as
    a user runs it, in a process of its own; `-X importtime` lists every
    module it imports, and none may be JAX's or the JAX package's."""
    import importlib.util
    import re

    out = CLI_DIR / "burgers"
    out.mkdir(parents=True, exist_ok=True)
    argv = [sys.executable, "-X", "importtime", "-m", "safediffcon_torch.cli.main", "burgers",
            "generate-data",
            "--n-train", str(CLI_B_SPLITS[0]), "--n-cal", str(CLI_B_SPLITS[1]),
            "--n-test", str(CLI_B_SPLITS[2]), "--out", str(out)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    jax_here = importlib.util.find_spec("jax") is not None
    modules = re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s*(\S+)", proc.stderr, re.M)
    forbidden = sorted({m for m in modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "safediffcon_tpu")})
    log(f"12a {' '.join(argv[1:])}: rc {proc.returncode} in {seconds:.2f} s (process start "
        f"included); {len(modules)} modules imported, of JAX or the JAX package: {forbidden} "
        f"(jax importable on this host: {jax_here}); last line "
        f"{proc.stdout.strip().splitlines()[-1:]}")
    if ("safediffcon_torch.parallel.mesh" not in modules or proc.returncode != 0
            or not (out / "burgers.npz").exists() or forbidden):
        raise AssertionError(f"12a: the command line failed or imported {forbidden}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return dict(seconds=seconds, modules_imported=len(modules), jax_importable=jax_here)


def phase_cli_smoke(K, C, smoke, pretrain_ref: dict) -> dict:
    """12b: the smoke task through the command line on the card: generate-data
    (K1 in the rollout), a library datagen with the conservation filter,
    pretrain on K2 with --steps-per-call 2 (2 steps, then 2 more with
    --resume: milestones 2 and 4), a library pretrain with a device pool at
    the reference width, and eval --checkpoints 2:4:2 (K1 in each
    evaluate, K2 idle)."""
    from safediffcon_torch.tasks.smoke.pipeline import build_model

    out_dir = CLI_DIR / "smoke"
    c = ["--out", str(out_dir)]
    n_train, n_cal, n_test = CLI_S_SPLITS
    res = {}
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t0 = time.perf_counter()
    run_cli(["smoke", "generate-data", "--n-train", str(n_train), "--n-cal", str(n_cal),
             "--n-test", str(n_test)] + c)
    gen_batches = -(-(n_train + n_cal + n_test) // 16)  # the default gen_batch
    res["generate_data"] = dict(seconds=time.perf_counter() - t0,
                                k1_launches=K.pressure_cg_cuda.launches, batches=gen_batches)
    if K.pressure_cg_cuda.launches != SOLVER_STEPS * gen_batches or k2_launches(C):
        raise AssertionError(f"12b generate-data launched K1 {K.pressure_cg_cuda.launches} "
                             f"times, expected {SOLVER_STEPS * gen_batches}")

    # the conservation filter: bounds around the median mass ratio of an
    # unfiltered batch, so that sims are rejected on both sides
    t0 = time.perf_counter()
    probe = smoke.generate_smoke_dataset(str(out_dir / "probe.npz"), n_train=8, n_cal=0,
                                         n_test=0, gen_batch=8, seed=5, device="cuda")
    r = np.sort(probe)
    lo, hi = float(r[1] + r[2]) / 2, float(r[5] + r[6]) / 2
    launches0 = K.pressure_cg_cuda.launches
    kept = smoke.generate_smoke_dataset(str(out_dir / "filtered.npz"), n_train=8, n_cal=0,
                                        n_test=0, gen_batch=8, seed=6, conservation_min=lo,
                                        conservation_max=hi, device="cuda")
    attempts = (K.pressure_cg_cuda.launches - launches0) // SOLVER_STEPS
    res["conservation"] = dict(seconds=time.perf_counter() - t0, bounds=[lo, hi],
                               probe_ratios=probe.tolist(), kept_ratios=kept.tolist(),
                               batches=attempts)
    log("12b conservation filter " + json.dumps(res["conservation"]))
    if not (len(kept) == 8 and ((kept > lo) & (kept < hi)).all() and attempts > 1):
        raise AssertionError(f"12b conservation filter: kept {kept} in ({lo}, {hi}) after "
                             f"{attempts} batches")

    # pretrain on K2 through the command line: 90 tensor-core launches per step
    n_convs = count_fused_convs(build_model(conv_impl="pallas", device="meta"))
    mode = C.kernel_mode(torch.float32)
    zero_k2_counts(C)
    K.pressure_cg_cuda.launches = 0
    t0 = time.perf_counter()
    for steps, extra in ((2, []), (4, ["--resume"])):
        run_cli(["smoke", "pretrain", "--conv-impl", "pallas", "--steps", str(steps),
                 "--steps-per-call", "2", *extra] + c)
    launches = C.conv3d_fused_cuda.launches[mode]
    res["pretrain"] = dict(seconds=time.perf_counter() - t0, k2_launches=launches,
                           k2_mode=mode, simt=C.conv3d_fused_simt_cuda.launches,
                           milestones=sorted(os.listdir(out_dir / "smoke-pretrain")))
    log("12b pretrain " + json.dumps(res["pretrain"]))
    if (launches != 3 * n_convs * 4 or k2_launches(C) != launches
            or C.conv3d_fused_simt_cuda.launches or K.pressure_cg_cuda.launches
            or res["pretrain"]["milestones"] != ["ckpt-2.pt", "ckpt-4.pt"]):
        raise AssertionError(f"12b pretrain: {res['pretrain']}, expected {3 * n_convs} "
                             f"tensor-core launches per step over 4 steps")
    k2_cli = launches

    # the library pretrain with a device pool, at phase 8's configuration
    train = smoke.SmokeDataset.load(str(out_dir / "smoke.npz"), "train")
    cfg = smoke.SmokePretrainConfig(conv_impl="pallas")
    pool = dict(steps_per_call=2, device_pool=POOL_SIMS, pool_refresh_every=4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_k2_counts(C)
    losses = []
    t0 = time.perf_counter()
    state = smoke.pretrain(cfg, train, num_steps=POOL_STEPS, device="cuda", losses=losses,
                           **pool)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = C.conv3d_fused_cuda.launches[mode]
    losses = [float(v) for v in losses]
    res["device_pool_pretrain"] = dict(
        pool, steps=POOL_STEPS, train_sims=len(train), seconds=seconds,
        s_per_step=seconds / POOL_STEPS, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase8_s_per_step=pretrain_ref["s_per_step"],
        phase8_peak_gb=pretrain_ref["pretrain_peak_gb"], k2_launches=launches, losses=losses)
    log("12b device-pool pretrain (set-up included, as phase 8) "
        + json.dumps(res["device_pool_pretrain"]))
    if (launches != 3 * n_convs * POOL_STEPS or k2_launches(C) != launches
            or not all(math.isfinite(v) for v in losses) or state.step != POOL_STEPS):
        raise AssertionError(f"12b device-pool pretrain: {res['device_pool_pretrain']}")
    k2_pool = launches
    del state
    torch.cuda.empty_cache()

    # eval of both milestones: K1 in each evaluate, K2 idle (cuDNN serving)
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t0 = time.perf_counter()
    run_cli(["smoke", "eval", "--ddim-steps", str(CLI_S_DDIM), "--checkpoints", "2:4:2"] + c)
    k1 = K.pressure_cg_cuda.launches
    with open(out_dir / "smoke_eval_sweep.json") as f:
        table = json.load(f)
    res["eval"] = dict(seconds=time.perf_counter() - t0, k1_launches=k1, k2=k2_launches(C),
                       table=table)
    log("12b eval sweep " + json.dumps(res["eval"], sort_keys=True))
    expected = SOLVER_STEPS * -(-n_test // 50) * 2  # per evaluated chunk per milestone
    values = [v for m in table.values() for v in m.values() if isinstance(v, float)]
    if (k1 != expected or k2_launches(C) or sorted(table) != ["2", "4"]
            or any("error" in m for m in table.values())
            or not all(math.isfinite(v) for v in values)):
        raise AssertionError(f"12b eval: K1 {k1} (expected {expected}), K2 {k2_launches(C)}, "
                             f"table {table}")
    res["launches"] = dict(k1_eval=k1, k2_cli_pretrain=k2_cli, k2_pool_pretrain=k2_pool)
    return res


def phase_cli_burgers_tokamak(K, C) -> dict:
    """12c: Burgers (on 12a's data) and tokamak through the command line at
    their "turbo" widths: pretrain --steps 2 --steps-per-call 2, then eval
    --ddim-steps 20; K1 and K2 stay idle."""
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    res = {}
    for task in ("burgers", "tokamak"):
        out_dir = CLI_DIR / task
        c = ["--out", str(out_dir)]
        t0 = time.perf_counter()
        if task == "tokamak":
            run_cli(["tokamak", "generate-data", "--n-train", str(CLI_B_SPLITS[0]),
                     "--n-cal", str(CLI_B_SPLITS[1]), "--n-test", str(CLI_B_SPLITS[2])] + c)
        run_cli([task, "pretrain", "--steps", "2", "--steps-per-call", "2"] + c)
        run_cli([task, "eval", "--ddim-steps", "20"] + c)
        with open(out_dir / f"{task}_eval_results.json") as f:
            metrics = json.load(f)
        res[task] = dict(seconds=time.perf_counter() - t0, metrics=metrics)
        log(f"12c {task}: " + json.dumps(res[task], sort_keys=True))
        if not all(math.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"12c {task}: non-finite metrics {metrics}")
    idle = (K.pressure_cg_cuda.launches, k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    if any(idle):
        raise AssertionError(f"12c: a TPU-kernel counterpart ran on the Burgers or tokamak "
                             f"path: {idle}")
    return res


# ---------------------------------------------------------------------------
# Phase 13: data parallelism and frame-axis sequence parallelism
# (safediffcon_torch/parallel/mesh.py)
# ---------------------------------------------------------------------------

P13_DIR = ROOT / "build" / "chip_smoke" / "p13"
P13_STEPS = 2  # pretrain steps of 13(a) and 13(b)
P13_SMOKE_DDIM, P13_SMOKE_SIMS = 10, 8  # 13(d): DDIM steps; cal and test sims
# 13(e); DDIM 20 on 50 before phase 14, DDIM 10 before the reference-scale recipes
P13_CAL_DDIM, P13_CAL_SIMS = 5, 24
P13_SP_BATCH = 2  # 13(c)


def _p13_rank(rank: int, world: int, backend: str, init_file: str, parts: list,
              out_dir: str) -> None:
    """One spawned rank of phase 13 or 17 (its card, TF32 off): joins the
    group, runs each (name, (dp, sp)) part on that mesh and saves what it
    measured to out_dir/rank<r>.pt, with the parts done before a failure
    and its traceback. A collective that waits P17_TIMEOUT_S fails."""
    import datetime
    import traceback

    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from safediffcon_torch.parallel import mesh as pmesh

    results = {}
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=P17_TIMEOUT_S))
        for name, (dp, sp) in parts:
            t0 = time.perf_counter()
            mesh = pmesh.get_mesh_2d(dp, sp) if sp > 1 else pmesh.get_mesh()
            pmesh.activate_mesh(mesh)
            results[name] = {**P13_PARTS, **P17_PARTS}[name]()
            results[name]["route"] = pmesh.describe(mesh)
            pmesh.activate_mesh(None)
            torch.cuda.empty_cache()
            if rank == 0:
                log(f"rank 0: part {name} on {results[name]['route']} in "
                    f"{time.perf_counter() - t0:.1f} s")
        dist.destroy_process_group()
        torch.save({"ok": results}, path)
    except BaseException as e:
        torch.save({"ok": results, "error": f"{type(e).__name__}: {e}\n"
                    f"{traceback.format_exc()[-3000:]}"}, path)
        raise


def _p13_counts():
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.ops import pressure_cg as K

    return dict(k2=dict(C.conv3d_fused_cuda.launches), k2_simt=C.conv3d_fused_simt_cuda.launches,
                k1=K.pressure_cg_cuda.launches)


def _p13_zero():
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.ops import pressure_cg as K

    zero_k2_counts(C)
    K.pressure_cg_cuda.launches = 0


def p13_pretrain() -> dict:
    """13(b): P13_STEPS smoke pretrain steps at the reference width, K2 in
    3xTF32, global batch 16 (this rank's rows of each)."""
    import safediffcon_torch.tasks.smoke as smoke

    data = np.load(P13_DIR / "train.npy", mmap_mode="r")
    train = smoke.SmokeDataset(data=data, raw=data)
    cfg = smoke.SmokePretrainConfig(conv_impl="pallas")
    losses = []
    _p13_zero()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = smoke.pretrain(cfg, train, num_steps=P13_STEPS, device="cuda", losses=losses)
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, losses=[float(v) for v in losses],
                counts=_p13_counts(), peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                params={k: v.detach().cpu() for k, v in state.model.state_dict().items()})


def _p13_sp_inputs():
    rng = np.random.default_rng(13)
    shape = (P13_SP_BATCH, FRAMES, 64, 64, 7)
    x = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
    cot = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
    return x, torch.tensor([100, 900], device="cuda")[:P13_SP_BATCH], cot


def p13_unet3d() -> dict:
    """13(c), 17(d) and their unsharded reference: one forward and backward
    of the reference UNet3D (conv_impl "pallas", remat "full") on seeded
    weights, loss = sum(out * cot) over the batch; a rank of a data split
    takes its rows and weighs its part of the sum by dp, which the
    gradient reduce averages over the data ranks."""
    from safediffcon_torch.parallel import mesh as pmesh
    from safediffcon_torch.tasks.smoke.pipeline import build_model, init_params

    net = init_params(build_model(conv_impl="pallas", device="cuda"), seed=3)
    x, t, cot = _p13_sp_inputs()
    sh = pmesh.batch_shard(P13_SP_BATCH, frames=FRAMES)
    x, t, cot = sh.take(x), sh.take(t), sh.take(cot)
    params = list(net.parameters())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _p13_zero()
    t0 = time.perf_counter()
    y = net(x, t)
    loss = (y * cot).sum() * sh.dp
    loss, grads = sh.reduce(loss, torch.autograd.grad(loss, params))
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, counts=_p13_counts(), rows=(sh.lo, sh.hi),
                frames=None if sh.frames is None else sh.frames.length,
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, out=y.detach().cpu(),
                loss=float(loss), grads=[g.cpu() for g in grads])


def p13_smoke_serving() -> dict:
    """13(d): calibrate on P13_SMOKE_SIMS cal sims and guided evaluate on as
    many test sims at DDIM P13_SMOKE_DDIM, the reference width, seeded
    weights, the solver on K1."""
    import safediffcon_torch.tasks.smoke as smoke
    from safediffcon_torch.tasks.smoke.pipeline import init_params

    cal = np.load(P13_DIR / "smoke_cal.npy")
    test, test_raw = np.load(P13_DIR / "smoke_test.npy"), np.load(P13_DIR / "smoke_test_raw.npy")
    ccfg = smoke.SmokeConformalConfig(ddim_sampling_steps=P13_SMOKE_DDIM)
    pipe = smoke.SmokePipeline(ccfg)
    init_params(pipe.model, seed=3)
    _p13_zero()
    t0 = time.perf_counter()
    q = pipe.calibrate(smoke.SmokeDataset(data=cal, raw=cal), 0.0,
                       generator=torch.Generator(device="cuda").manual_seed(1))
    calibrate_counts = _p13_counts()
    m = pipe.evaluate(smoke.SmokeDataset(data=test, raw=test_raw), q,
                      generator=torch.Generator(device="cuda").manual_seed(2))
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0, q=float(q), metrics=m,
                calibrate_counts=calibrate_counts, counts=_p13_counts())


def p13_calibrate() -> dict:
    """13(e): Burgers and tokamak calibrate at their turbo widths on
    P13_CAL_SIMS cal sims, DDIM P13_CAL_DDIM, with torch's default init of
    the weights from one seed (flax's lecun-normal init of 200 M weights on
    the CPU generator would take most of the part's time)."""
    import safediffcon_torch.tasks.burgers as burgers
    import safediffcon_torch.tasks.tokamak as tokamak

    _p13_zero()
    clock = [time.perf_counter()]

    def lap() -> float:
        torch.cuda.synchronize()
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    torch.manual_seed(3)
    bp = burgers.BurgersPipeline(burgers.BurgersConformalConfig(
        ddim_sampling_steps=P13_CAL_DDIM))
    laps = dict(burgers_build=lap())
    qb = bp.calibrate(None, np.load(P13_DIR / "burgers_cal.npy"), 0.0,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    laps["burgers_calibrate"] = lap()
    tp = tokamak.TokamakPipeline(tokamak.TokamakConformalConfig(
        ddim_sampling_steps=P13_CAL_DDIM))
    laps["tokamak_build"] = lap()
    cal = tokamak.TokamakDataset(np.load(P13_DIR / "tokamak_cal.npy"),
                                 np.load(P13_DIR / "tokamak_cal_state.npy"))
    qt = tp.calibrate(None, cal, 0.0, generator=torch.Generator(device="cuda").manual_seed(1))
    laps["tokamak_calibrate"] = lap()
    return dict(seconds=clock[-1] - clock[0], laps=laps, q_burgers=float(qb),
                q_tokamak=float(qt), counts=_p13_counts())


P13_PARTS = {"b": p13_pretrain, "c": p13_unet3d, "d": p13_smoke_serving, "e": p13_calibrate}


def p13_spawn(parts: list, world: int, backend: str):
    """Run the parts on `world` spawned ranks of one group; returns (each
    rank's results of the parts it finished, the failures: a rank that
    failed or hung)."""
    import multiprocessing as mp
    import shutil

    out_dir = P13_DIR / f"ranks-{backend}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_p13_rank, args=(r, world, backend, str(out_dir / "rendezvous"),
                                                 parts, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    out, errors = [], []
    for r in range(world):
        path = out_dir / f"rank{r}.pt"
        got = torch.load(path, weights_only=False) if path.exists() else {
            "ok": {}, "error": "no result"}
        if "error" in got or hung:
            errors.append(f"rank {r} of {world} ({backend}): {got.get('error', 'hung')}")
        out.append(got["ok"])
    return out, errors


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_p13_torchrun(C) -> dict:
    """13(a): `torchrun --nproc_per_node=1` of `smoke pretrain` at the
    reference width, K2 (TF32, the command line's defaults), in a process of
    its own that joins a one-rank NCCL group (`--cli-rank` below)."""
    data = CLI_DIR / "smoke" / "smoke.npz"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
           str(ROOT / "chip_smoke.py"), "--cli-rank", "smoke", "pretrain", "--data", str(data),
           "--out", str(P13_DIR / "torchrun"), "--steps", str(P13_STEPS), "--conv-impl",
           "pallas"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    (P13_DIR / "torchrun.log").write_text(proc.stdout + proc.stderr)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("P13A ")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"13(a) torchrun exited {proc.returncode}:\n"
                             f"{(proc.stdout + proc.stderr)[-3000:]}")
    rep = json.loads(lines[-1][5:])
    tc = sum(rep["k2"].values())
    log(f"13(a) torchrun --nproc_per_node=1 smoke pretrain --steps {P13_STEPS}: rc 0 in "
        f"{seconds:.1f} s; {rep['group']}; K2 {tc} tensor-core launches {rep['k2']}, "
        f"{rep['k2_simt']} SIMT")
    n_convs = sum(n for *_, n in K2_SHAPES)
    if tc != 3 * n_convs * P13_STEPS or rep["k2_simt"] or not rep["group"].startswith("nccl"):
        raise AssertionError(f"13(a): K2 {rep}, expected {3 * n_convs} per step on the "
                             f"tensor cores in an NCCL group")
    return dict(seconds=seconds, k2=tc, group=rep["group"])


def cli_rank(argv: list) -> int:
    """`python3 chip_smoke.py --cli-rank <command line>` under torchrun: join
    the launch's NCCL group, run an all-reduce and an all-gather through it,
    then the command line on this rank's card; print the K2 counts."""
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    from safediffcon_torch.cli.main import main as cli_main
    from safediffcon_torch.ops import build
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.parallel import mesh as pmesh

    build.build_all(["conv3d_wgmma", "conv3d_simt"])  # the parent's build, found by hash
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    pmesh.init_distributed(backend="nccl")
    x = torch.full((4,), float(pmesh.rank() + 1), device="cuda")
    dist.all_reduce(x)
    g = pmesh.all_gather(x, 0, None)
    torch.cuda.synchronize()
    group = (f"{dist.get_backend()} group of {pmesh.world_size()}, all-reduce {x.tolist()}, "
             f"all-gather of {tuple(g.shape)} ({pmesh.collective_route(None)})")
    zero_k2_counts(C)
    rc = cli_main(argv)
    print("P13A " + json.dumps(dict(k2=C.conv3d_fused_cuda.launches,
                                    k2_simt=C.conv3d_fused_simt_cuda.launches, group=group,
                                    rank=int(os.environ["RANK"]))), flush=True)
    return rc


def save_p13_smoke(train, cal, test) -> None:
    """The smoke sims that parts b and d read, from the smoke splits."""
    P13_DIR.mkdir(parents=True, exist_ok=True)
    np.save(P13_DIR / "train.npy", np.ascontiguousarray(train.data[:K2_BATCH]))
    np.save(P13_DIR / "smoke_cal.npy", np.ascontiguousarray(cal.data[:P13_SMOKE_SIMS]))
    np.save(P13_DIR / "smoke_test.npy", np.ascontiguousarray(test.data[:P13_SMOKE_SIMS]))
    np.save(P13_DIR / "smoke_test_raw.npy", np.ascontiguousarray(test.raw[:P13_SMOKE_SIMS]))


def phase_p13(C, smoke, train, cal, test, b_data, t_data) -> dict:
    """Phase 13: (a) torchrun with one NCCL rank; (b)-(e) two gloo ranks on
    the one card against the same work in this process, TF32 off."""
    P13_DIR.mkdir(parents=True, exist_ok=True)
    res = dict(a=phase_p13_torchrun(C))
    save_p13_smoke(train, cal, test)
    np.save(P13_DIR / "burgers_cal.npy", np.ascontiguousarray(b_data["cal"].data[:P13_CAL_SIMS]))
    np.save(P13_DIR / "tokamak_cal.npy", np.ascontiguousarray(t_data["cal"].data[:P13_CAL_SIMS]))
    np.save(P13_DIR / "tokamak_cal_state.npy",
            np.ascontiguousarray(t_data["cal"].state_phys[:P13_CAL_SIMS]))

    # the references: the same work in this process, no mesh
    ref = {}
    with tf32_flag(False):
        for name in ("b", "c", "d", "e"):
            ref[name] = P13_PARTS[name]()
            torch.cuda.empty_cache()
    parts = [("b", (2, 1)), ("c", (1, 2)), ("d", (2, 1)), ("e", (2, 1))]
    t0 = time.perf_counter()
    ranks, errors = p13_spawn(parts, 2, "gloo")
    if errors:
        raise AssertionError("phase 13 " + "\n".join(errors))
    res["spawn_s"] = time.perf_counter() - t0
    n_convs = sum(n for *_, n in K2_SHAPES)

    # (b) two ranks' pretrain against one process's
    rb = ref["b"]
    for r, got in enumerate(ranks):
        g = got["b"]
        tc = g["counts"]["k2"]["3xtf32"]
        lerr = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], rb["losses"]))
        werr = max(_rel(g["params"][k], v) for k, v in rb["params"].items())
        lr = smoke.SmokePretrainConfig().lr
        wabs = max(float((g["params"][k] - v).abs().max()) for k, v in rb["params"].items())
        log(f"13(b) rank {r} ({g['route']}): losses {g['losses']} against {rb['losses']} "
            f"(rel {lerr:.2e}); weights max |diff| {wabs:.3e} = {wabs / lr:.3f} lr "
            f"(rel {werr:.2e}); K2 {tc} 3xTF32 launches, {g['counts']['k2_simt']} SIMT; "
            f"{g['seconds']:.2f} s, peak {g['peak_gb']:.2f} GB (one process "
            f"{rb['seconds']:.2f} s, {rb['peak_gb']:.2f} GB)")
        # the mean of two half-batch means in float32 (3xTF32 K2): 1e-5 of the
        # loss; one Adam step from gradients equal to rounding moves an entry
        # whose gradient is near 0 by up to 2 lr
        if not (lerr <= 1e-5 and wabs <= 2.5 * lr):
            raise AssertionError(f"13(b): two ranks' pretrain disagrees with one process's")
        if tc != 3 * n_convs * P13_STEPS or g["counts"]["k2_simt"] or sum(
                g["counts"]["k2"].values()) != tc:
            raise AssertionError(f"13(b): rank {r} K2 counts {g['counts']}")
    for k, v in ranks[0]["b"]["params"].items():
        if not torch.equal(v, ranks[1]["b"]["params"][k]):
            raise AssertionError("13(b): the ranks' weights differ")
    res["b"] = dict(k2_per_rank=[g["b"]["counts"]["k2"]["3xtf32"] for g in ranks],
                    seconds=[g["b"]["seconds"] for g in ranks], ref_s=rb["seconds"],
                    peak_gb=[g["b"]["peak_gb"] for g in ranks], ref_peak_gb=rb["peak_gb"])

    # (c) SP = 2 against unsharded
    rc = ref["c"]
    for r, got in enumerate(ranks):
        g = got["c"]
        oerr = _rel(g["out"], rc["out"])
        gerr = max(_rel(a, b) for a, b in zip(g["grads"], rc["grads"]))
        tc = g["counts"]["k2"]["3xtf32"]
        log(f"13(c) rank {r} ({g['route']}): {g['frames']} + 2 frames per rank; out rel "
            f"{oerr:.2e}, gradients rel {gerr:.2e} (each of max |g|); K2 {tc} 3xTF32 "
            f"launches, {g['counts']['k2_simt']} SIMT; {g['seconds']:.2f} s, peak "
            f"{g['peak_gb']:.2f} GB above the weights and inputs (unsharded "
            f"{rc['seconds']:.2f} s, {rc['peak_gb']:.2f} GB)")
        # float32 (3xTF32 K2, cuDNN without TF32), sums in another order: 1e-4
        # of each tensor's largest entry, phase 7's tolerance
        if g["frames"] != FRAMES // 2 or not (oerr <= 1e-4 and gerr <= 1e-4):
            raise AssertionError("13(c): the frame-parallel UNet3D disagrees with unsharded")
        if tc != 3 * n_convs or g["counts"]["k2_simt"]:
            raise AssertionError(f"13(c): rank {r} K2 counts {g['counts']}")
    res["c"] = dict(k2_per_rank=[g["c"]["counts"]["k2"]["3xtf32"] for g in ranks],
                    peak_gb=[g["c"]["peak_gb"] for g in ranks], ref_peak_gb=rc["peak_gb"],
                    seconds=[g["c"]["seconds"] for g in ranks], ref_s=rc["seconds"])

    # (d) smoke calibrate + guided evaluate
    rd = ref["d"]
    log(f"13(d) one process: metrics {json.dumps(rd['metrics'])}")
    for r, got in enumerate(ranks):
        g = got["d"]
        qerr = abs(g["q"] - rd["q"]) / abs(rd["q"])
        log(f"13(d) rank {r} ({g['route']}): Q {g['q']:.6g} against {rd['q']:.6g} (rel "
            f"{qerr:.2e}); K1 {g['counts']['k1']} launches (one process "
            f"{rd['counts']['k1']}), K2 {sum(g['counts']['k2'].values())}; "
            f"{g['seconds']:.2f} s (one process {rd['seconds']:.2f} s); metrics "
            f"{json.dumps(g['metrics'])}")
        if (not qerr <= 1e-5 or g["counts"]["k1"] != SOLVER_STEPS
                or sum(g["counts"]["k2"].values())):
            raise AssertionError(f"13(d): rank {r}: Q {g['q']} vs {rd['q']}, {g['counts']}")
        for name, v in rd["metrics"].items():
            # K1 solves each chunk of 8 samples as one system; a rank's chunk
            # holds 4: the rollout agrees within the solver's 1e-8 stopping
            # test, not to the bit; a threshold rate may move by one sample
            if "percentage" in name:
                ok = abs(g["metrics"][name] - v) <= 100 / P13_SMOKE_SIMS + 1e-9
            else:
                ok = abs(g["metrics"][name] - v) <= 1e-3 * abs(v) + 1e-9
            if not ok:
                raise AssertionError(f"13(d): {name} {g['metrics'][name]} against {v}")
    res["d"] = dict(k1_per_rank=[g["d"]["counts"]["k1"] for g in ranks],
                    k1_one_process=rd["counts"]["k1"], q=[g["d"]["q"] for g in ranks],
                    q_ref=rd["q"], seconds=[g["d"]["seconds"] for g in ranks],
                    ref_s=rd["seconds"])

    # (e) Burgers and tokamak calibrate
    re_ = ref["e"]
    for r, got in enumerate(ranks):
        g = got["e"]
        errs = {t: abs(g[f"q_{t}"] - re_[f"q_{t}"]) / abs(re_[f"q_{t}"])
                for t in ("burgers", "tokamak")}
        log(f"13(e) rank {r} ({g['route']}): Q-hat Burgers {g['q_burgers']:.6g} / tokamak "
            f"{g['q_tokamak']:.6g} against {re_['q_burgers']:.6g} / {re_['q_tokamak']:.6g} "
            f"(rel {errs['burgers']:.2e} / {errs['tokamak']:.2e}); K1 / K2 "
            f"{g['counts']['k1']} / {sum(g['counts']['k2'].values())}; {g['seconds']:.2f} s "
            f"{json.dumps(g['laps'])} (one process {re_['seconds']:.2f} s "
            f"{json.dumps(re_['laps'])})")
        if (not all(math.isfinite(g[f"q_{t}"]) for t in ("burgers", "tokamak"))
                or not max(errs.values()) <= 1e-5 or g["counts"]["k1"]
                or sum(g["counts"]["k2"].values())):
            raise AssertionError(f"13(e): rank {r} {errs} {g['counts']}")
    res["e"] = dict(q=[(g["e"]["q_burgers"], g["e"]["q_tokamak"]) for g in ranks],
                    q_ref=(re_["q_burgers"], re_["q_tokamak"]),
                    seconds=[g["e"]["seconds"] for g in ranks], ref_s=re_["seconds"])

    return res


# ---------------------------------------------------------------------------
# Phase 14: the round-1 validation runs (safediffcon_torch/experiments/round1.py)
# ---------------------------------------------------------------------------

R1_DIR = ROOT / "build" / "chip_smoke" / "round1"
R1_EVAL_SEEDS = 1  # evaluations per phase of phase 14's tiny runs (the script's draw)


def unet3d_conv_shapes(pre_kw: dict, batch: int, sample_shape: tuple) -> list:
    """(x shape, Cin, Cout) of every distinct K2 call of one forward of the
    smoke recipe's UNet3D (`pre_kw`: its SmokePretrainConfig fields)."""
    from safediffcon_torch.models.unet3d import FusedConv3x3x3
    from safediffcon_torch.tasks.smoke.pipeline import build_model

    model = build_model(pre_kw["dim"], pre_kw.get("dim_mults", (1, 2, 4)),
                        pre_kw.get("compute_dtype"), conv_impl="pallas", device="cuda")
    seen = []

    def hook(mod, args):
        key = (tuple(args[0].shape), mod.weight.shape[1], mod.weight.shape[0])
        if key not in seen:
            seen.append(key)

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, FusedConv3x3x3)]
    with torch.no_grad():
        model(torch.zeros((batch, *sample_shape), device="cuda"),
              torch.zeros((batch,), dtype=torch.long, device="cuda"))
    for h in handles:
        h.remove()
    del model
    return seen


def check_k2_bf16(C, shapes: list) -> list:
    """K2 in bf16 at each (x shape, Cin, Cout): the forward, and dx and dW
    through the autograd Function, against the plain version and its
    autograd on the same bf16 inputs, within 1e-2 of max (phase 6's
    bf16 tolerance); returns the cases, with the kernel each call took."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = []
    for shape, cin, cout in shapes:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = (torch.randn((cout, cin, 3, 3, 3), generator=gen, device="cuda")
             / (27 * cin) ** 0.5).bfloat16()
        g = torch.randn((*shape[:-1], cout), generator=gen, device="cuda").bfloat16()
        xp, wp = x.clone().requires_grad_(), w.clone().requires_grad_()
        ref = C.conv3d_fused_plain(xp, C.flatten_weight(wp))
        ref.backward(g)
        before = k2_launches(C), C.conv3d_fused_simt_cuda.launches
        xk, wk = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = C.conv3d_fused_fn(xk, wk)
        out.backward(g)
        torch.cuda.synchronize()
        errs = [rel_err(out, ref), rel_err(xk.grad, xp.grad), rel_err(wk.grad, wp.grad)]
        case = dict(shape=list(shape), cin=cin, cout=cout, dtype="bfloat16",
                    tensor_core=k2_launches(C) - before[0],
                    simt=C.conv3d_fused_simt_cuda.launches - before[1],
                    max_diff=[e[0] for e in errs], max_abs=[e[1] for e in errs])
        if not (all(d <= 1e-2 * m for d, m in errs) and case["tensor_core"] + case["simt"] == 2
                and all(bool(torch.isfinite(t.float()).all()) for t in (out, xk.grad, wk.grad))):
            raise AssertionError(f"K2 bf16 differs from its plain version: {case}")
        cases.append(case)
    return cases


def _finite_numbers(x) -> bool:
    if isinstance(x, dict):
        return all(_finite_numbers(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite_numbers(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def _key_structure(x):
    if isinstance(x, dict):
        return {k: _key_structure(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_key_structure(x[0])] if x else []
    return None


def phase_round1(K, C) -> dict:
    """14: the nine recipes of the validation runner (`python -m
    safediffcon_torch.experiments.round1 <recipe> --scale tiny`) on the
    card, K1 and K2 counts zeroed before each and read after; K2 in bf16
    first held against its plain version at the tiny smoke model's conv
    shapes and at the full smoke recipe's."""
    from safediffcon_torch.experiments import round1 as R1

    t0 = time.perf_counter()
    tiny, full = R1.recipe("smoke", "tiny", "cuda"), R1.recipe("smoke", "full", "cuda")
    rec_shape = lambda kw: (kw.get("record_frames", FRAMES),  # noqa: E731
                            128 // kw.get("space_scale", 2), 128 // kw.get("space_scale", 2), 7)
    shapes = [s for r in (tiny, full) for s in unet3d_conv_shapes(
        r["SmokePretrainConfig"], r["SmokePretrainConfig"]["batch_size"],
        rec_shape(r["generate_smoke_dataset"]))]
    k2_cases = check_k2_bf16(C, shapes)
    log(f"14: K2 bf16 = plain at {len(k2_cases)} conv shapes of the smoke recipe's UNet3D "
        f"(tiny and full), tensor-core / SIMT calls "
        f"{sum(c['tensor_core'] for c in k2_cases)} / {sum(c['simt'] for c in k2_cases)}, "
        f"largest error {max(d / m for c in k2_cases for d, m in zip(c['max_diff'], c['max_abs'])):.2e} "
        f"of max")
    runs = {}
    for name in R1.RUNS:
        K.pressure_cg_cuda.launches = 0
        zero_k2_counts(C)
        t = time.perf_counter()
        lines = []
        # from an empty directory: the refscale recipes reuse a data file
        # they find there, and each run here is to generate its own
        shutil.rmtree(R1_DIR / name, ignore_errors=True)
        res = R1.RUNS[name](scale="tiny", eval_seeds=R1_EVAL_SEEDS, device="cuda",
                            out=str(R1_DIR / name), emit=lines.append)
        counts = dict(k1=K.pressure_cg_cuda.launches, k2=dict(C.conv3d_fused_cuda.launches),
                      k2_simt=C.conv3d_fused_simt_cuda.launches)
        with open(ROOT / R1.JAX_RESULTS[name]) as f:
            jax_keys = _key_structure(json.load(f))
        if _key_structure(res["summary"]) != jax_keys:
            raise AssertionError(f"14 {name}: SUMMARY keys differ from the JAX results'")
        if not _finite_numbers(res["summary"]):
            raise AssertionError(f"14 {name}: a SUMMARY value is not finite: {res['summary']}")
        if sum(x.startswith("COMPARE ") for x in lines) != len(res["comparison"]):
            raise AssertionError(f"14 {name}: the comparison lines are missing")
        if any(x.split()[:2] != ["DATA", "generated"] for x in lines if x.startswith("DATA ")):
            raise AssertionError(f"14 {name}: its data were not generated on the card")
        if name == "burgers_dpm_refscale":
            # each few-step arm's FEWSTEP line; as each arm's pipeline counted
            # its graphs: the calibration's three chunks a warm-up, a capture
            # and a replay, the evaluation's eval seeds likewise
            n = R1_EVAL_SEEDS
            route = dict(calibrate=dict(graphs=1, replays=1),
                         evaluate=dict(graphs=int(n > 1), replays=max(n - 2, 0)))
            if (sum(x.startswith("FEWSTEP ") for x in lines) != len(res["summary"]) - 1
                    or sum(x.startswith("ROUTE ") for x in lines) != len(res["summary"])
                    or any(r != route for r in res["routes"].values())):
                raise AssertionError(f"14 {name}: FEWSTEP or ROUTE lines wrong: {res['routes']}")
        runs[name] = dict(seconds=time.perf_counter() - t, launches=counts,
                          stages=res["stages"], per_stage=res["launches"])
        k2_total = sum(counts["k2"].values()) + counts["k2_simt"]
        log(f"14 {name} --scale tiny: {runs[name]['seconds']:.1f} s, K1 {counts['k1']}, "
            f"K2 {counts['k2']} + SIMT {counts['k2_simt']}")
        if name.startswith("smoke"):
            st = res["launches"]
            # smoke evaluates in its own stage; smoke_posttrain inside each
            # fine-tuning stage (one evaluation per epoch at one eval seed)
            evals = (["pretrain_evaluate"] if name == "smoke" else ["posttrain", "backward"])
            if not (st["datagen"]["K1"] > 0 and all(st[e]["K1"] > 0 for e in evals)
                    and sum(st["pretrain"]["K2"].values()) + st["pretrain"]["K2_simt"] > 0):
                raise AssertionError(f"14 {name}: K1 in datagen and evaluate and K2 in pretrain "
                                     f"must launch: {st}")
        elif counts["k1"] or k2_total:
            raise AssertionError(f"14 {name}: a TPU-kernel counterpart ran off its path: {counts}")
    return dict(seconds=time.perf_counter() - t0, k2_cases=k2_cases, runs=runs)


# Phase 15: each arm's steps, the steps whose wall time gives steps/s (past
# the warm-up and the capture at either chunk size), the steps torch.profiler
# traces in the steps_per_call 1 arms (few: ~5,900 kernels per eager step),
# and the chunk sizes compared
G_STEPS = 15
G_TIME = (10, 15)
G_PROFILE = (5, 6)
G_CHUNKS = (5, 1)


class StepMarks(list):
    """A `losses` list for `pretrain` that calls marks[n]() once n step
    losses have been appended (a captured chunk's after its replay is
    enqueued)."""

    def __init__(self, marks: dict):
        super().__init__()
        self.marks = marks

    def append(self, loss):
        super().append(loss)
        fn = self.marks.get(len(self))
        if fn is not None:
            fn()


def graph_arm(pretrain, cfg, train, init, k: int, capture: bool) -> dict:
    """One phase-15 arm: G_STEPS steps of `pretrain` from `init` with
    steps_per_call k, the steps of G_TIME timed and, when k is 1, those of
    G_PROFILE traced. Returns the losses, the final weights and EMA,
    steps/s, and per traced step the device (kernel) time, kernels, kernel
    launch calls and graph launch calls."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    clock = {}

    def stamp(n):
        def fn():
            torch.cuda.synchronize()
            clock[n] = time.perf_counter()
        return fn

    def start():
        torch.cuda.synchronize()
        prof.start()

    def stop():
        torch.cuda.synchronize()
        prof.stop()

    marks = {G_TIME[0]: stamp(G_TIME[0]), G_TIME[1]: stamp(G_TIME[1])}
    if k == 1:
        marks.update({G_PROFILE[0]: start, G_PROFILE[1]: stop})
    marks = StepMarks(marks)
    state = pretrain(cfg, train, num_steps=G_STEPS, params=init, device="cuda",
                     steps_per_call=k, losses=marks, capture=capture)
    torch.cuda.synchronize()
    out = dict(losses=[float(v) for v in marks],
               params={k_: v.detach().clone() for k_, v in state.model.state_dict().items()},
               ema={k_: v.clone() for k_, v in state.ema_params.items()},
               steps_per_s=(G_TIME[1] - G_TIME[0]) / (clock[G_TIME[1]] - clock[G_TIME[0]]),
               step=state.step)
    if k != 1:
        return out
    n = G_PROFILE[1] - G_PROFILE[0]
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {e.key: e.count for e in ev if e.device_type == torch.autograd.DeviceType.CPU
             and (e.key.startswith(("cudaLaunch", "cuLaunch")) or e.key == "cudaGraphLaunch")}
    return dict(out, device_ms_per_step=(sum(e.self_device_time_total for e in kernels) / 1e3 / n
                                         if kernels else "not measured"),
                kernels_per_step=sum(e.count for e in kernels) / n,
                launch_calls_per_step=sum(v for k_, v in calls.items()
                                          if k_ != "cudaGraphLaunch") / n,
                graph_launches_per_step=calls.get("cudaGraphLaunch", 0) / n)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def graph_case(name: str, pretrain, cfg, train, mod) -> dict:
    """Phase 15 for one task: for steps_per_call 5 and 1, an eager arm and
    a captured arm of `pretrain`, each G_STEPS steps from the same seeded
    weights and generator seed. The captured arm must equal the eager one
    bit for bit: the same kernels on the same float32 step values (found
    so on the card, where two eager arms are bitwise equal too)."""
    init = mod.init_params(mod.build_model(cfg.dim, cfg.dim_mults, cfg.resnet_block_groups,
                                           device="cuda"), seed=cfg.seed)
    init = {k: v.detach() for k, v in init.state_dict().items()}
    res = dict(batch=cfg.batch_size, compute_dtype=cfg.compute_dtype)
    for k in G_CHUNKS:
        eager = graph_arm(pretrain, cfg, train, init, k, capture=False)
        graph = graph_arm(pretrain, cfg, train, init, k, capture=True)
        diff = dict(loss=max(abs(a - b) for a, b in zip(eager["losses"], graph["losses"])),
                    params=_max_diff(eager["params"], graph["params"]),
                    ema=_max_diff(eager["ema"], graph["ema"]))
        strip = ("losses", "params", "ema")
        res[f"k{k}"] = r = dict(eager={a: v for a, v in eager.items() if a not in strip},
                                captured={a: v for a, v in graph.items() if a not in strip},
                                captured_vs_eager=diff,
                                speedup=graph["steps_per_s"] / eager["steps_per_s"])
        log(f"15 {name} k={k}: " + json.dumps(r))
        launches = (k != 1 or (graph["graph_launches_per_step"] == 1
                               and eager["graph_launches_per_step"] == 0))
        if not (all(math.isfinite(v) for v in graph["losses"])
                and len(graph["losses"]) == G_STEPS == graph["step"]
                and not any(diff.values()) and launches):
            raise AssertionError(f"phase 15 {name} k={k}: {r}")
    return res


def phase_train_graphs(burgers, tokamak, b_data, t_data) -> dict:
    """15: the training chunk as one captured CUDA graph against the same
    chunk run eagerly (`graph_case`), for the Burgers turbo UNet2D at the
    burgers_20k recipe's batch 32 and the tokamak turbo UNet1D at its
    recipe's batch 16, both in bf16 compute; steps/s of each arm, and the
    profiler's device time, kernels, kernel launch calls and graph launch
    calls per step."""
    from safediffcon_torch.tasks.burgers import pipeline as bp
    from safediffcon_torch.tasks.tokamak import pipeline as tp

    return dict(
        burgers=graph_case("burgers", burgers.pretrain, dataclasses.replace(
            burgers.BurgersPretrainConfig(), **B_MODEL, batch_size=32, compute_dtype="bfloat16"),
            b_data["train"], bp),
        tokamak=graph_case("tokamak", tokamak.pretrain, dataclasses.replace(
            tokamak.TokamakPretrainConfig(), batch_size=16, compute_dtype="bfloat16"),
            t_data["train"], tp))


# ---------------------------------------------------------------------------
# Phase 16: the serving and fine-tuning calls as captured CUDA graphs
# ---------------------------------------------------------------------------

S_DDIM = 10  # DDIM steps of phase 16 in the whole run (`--serving-graphs`: 200)
S_SHORT_DDIM = 4  # DDIM steps of the profiled short windows
# `--serving-graphs`: also each eager arm's second call, and the profiler
# windows (those over a rollout, 16b and 16f, and over ten eager training
# steps, 16c, take up to a minute of the profiler's own time each)
S_EXTENDED = False
S_POST_CHUNKS = 3  # 16c: chunks of 10 steps at batch 64 (`--serving-graphs`: 4)
S_T_CAL = 250  # tokamak cal sims per calibrate call, one chunk (recipe: 1,000 in one)


class KeptGraphs:
    """While open, CUDA graphs are made with keep_graph=True, so that their
    nodes can be counted (`graph_nodes`); `graphs` lists them."""

    def __enter__(self):
        self.orig, self.graphs = torch.cuda.CUDAGraph, []

        def make():
            g = self.orig(keep_graph=True)
            self.graphs.append(g)
            return g

        torch.cuda.CUDAGraph = make
        return self

    def __exit__(self, *exc):
        torch.cuda.CUDAGraph = self.orig


def graph_nodes(graphs: list) -> dict:
    """The nodes of kept graphs by type (libcuda's cuGraphGetNodes
    and cuGraphNodeGetType): kernel, memcpy, memset, other."""
    import ctypes

    lib = ctypes.CDLL("libcuda.so.1")
    out = {}
    for graph in graphs:
        g = ctypes.c_void_p(graph.raw_cuda_graph())
        n = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(g, None, ctypes.byref(n)) != 0:
            return "not measured"
        nodes = (ctypes.c_void_p * n.value)()
        lib.cuGraphGetNodes(g, nodes, ctypes.byref(n))
        kind = ctypes.c_int()
        for node in nodes:
            lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
            name = {0: "kernel", 1: "memcpy", 2: "memset"}.get(kind.value, "other")
            out[name] = out.get(name, 0) + 1
    return out


def timed_call(fn):
    """(fn(), wall seconds, CUDA-event ms of the work it enqueued), synced
    before and after."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, start.elapsed_time(end)


PROFILE = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]


def profile_stats(prof) -> dict:
    """Device (kernel) ms, kernels, kernel launch calls and graph launch
    calls of a finished torch.profiler window."""
    ev = prof.key_averages()
    kernels = [e for e in ev if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = {e.key: e.count for e in ev if e.device_type == torch.autograd.DeviceType.CPU
             and (e.key.startswith(("cudaLaunch", "cuLaunch")) or e.key == "cudaGraphLaunch")}
    return dict(device_ms=(sum(e.self_device_time_total for e in kernels) / 1e3
                           if kernels else "not measured"),
                kernels=sum(e.count for e in kernels),
                launch_calls=sum(v for k, v in calls.items() if k != "cudaGraphLaunch"),
                graph_launches=calls.get("cudaGraphLaunch", 0))


def profile_call(fn) -> dict:
    """torch.profiler over one call (a short window): `profile_stats`."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILE) as prof:
        fn()
        torch.cuda.synchronize()
    return profile_stats(prof)


def profiled_calls(fn, first: int, n: int, into: dict, key: str):
    """`fn`, with torch.profiler over its calls first .. first + n - 1
    (counted from 0); their `profile_stats` go to into[key]."""
    count, prof = [0], []

    def wrapped(*a, **kw):
        i = count[0]
        count[0] += 1
        if i == first:
            torch.cuda.synchronize()
            prof.append(torch.profiler.profile(activities=PROFILE))
            prof[0].__enter__()
        out = fn(*a, **kw)
        if i == first + n - 1:
            torch.cuda.synchronize()
            prof[0].__exit__(None, None, None)
            into[key] = profile_stats(prof[0])
        return out

    return wrapped


def _same(a, b) -> float:
    """0 where two results (tensors and numbers in dicts, lists and tuples)
    are equal bit for bit, else their largest difference (inf for a shape
    or key mismatch)."""
    if isinstance(a, dict):
        if a.keys() != b.keys():
            return math.inf
        return max((_same(a[k], b[k]) for k in a), default=0.0)
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return math.inf
        return max((_same(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(a, torch.Tensor):
        if a.shape != b.shape:
            return math.inf
        return 0.0 if torch.equal(a, b) else float((a.double() - b.double()).abs().max())
    return 0.0 if a == b or (a != a and b != b) else abs(float(a) - float(b))


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return math.isfinite(float(x))


def serving_case(label: str, make, call, state=None, short=None) -> dict:
    """One phase-16 case: the eager arm, `make(False)`'s pipeline or step
    called once as `call(obj, 0)` on the first inputs, draws and Q-hat;
    then `make(True)`'s captured one called three times, i = 0, 1, 0: the
    warm-up (eager on the static buffers), the capture on other inputs,
    and a replay on the first inputs again (the static buffers refilled
    after the capture's). The warm-up and the replay must each equal the
    eager arm bit for bit. With `state` = (snapshot, restore), a case
    whose calls update weights, the replay starts from the warm-up's
    starting state, restored in place (each arm starts from the same
    seeded weights). Seconds and CUDA-event ms per call, the graph's nodes
    by type, the peak memory of each arm; with S_EXTENDED, the eager arm's
    second call (free of first-call costs, from the same state), which
    must equal its first, and torch.profiler over one eager call and one
    replay of `short(capture)` (the case at DDIM S_SHORT_DDIM), or of
    `make`."""
    obj = make(False)
    snap = state[0](obj) if state is not None else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eager = timed_call(lambda: call(obj, 0))
    res = dict(seconds=dict(eager=eager[1]), event_ms=dict(eager=eager[2]),
               peak_gb=dict(eager=torch.cuda.max_memory_allocated() / 1e9))
    diffs = {}
    if S_EXTENDED:
        if state is not None:
            state[1](obj, snap)
        steady = timed_call(lambda: call(obj, 0))
        res["seconds"]["eager_steady"], res["event_ms"]["eager_steady"] = steady[1:]
        diffs["eager_steady"] = _same(eager[0], steady[0])
        del steady
    del obj, snap
    obj = make(True)
    snap = state[0](obj) if state is not None else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    got = []
    with KeptGraphs() as kept:
        for n, i in enumerate((0, 1, 0)):
            if n == 2 and state is not None:
                state[1](obj, snap)
            got.append(timed_call(lambda: call(obj, i)))
    for name, g in zip(("warm_up", "capture", "replay"), got):
        res["seconds"][name], res["event_ms"][name] = g[1:]
    res["peak_gb"]["captured"] = torch.cuda.max_memory_allocated() / 1e9
    res["reserved_gb"] = torch.cuda.memory_reserved() / 1e9
    res["nodes"] = graph_nodes(kept.graphs)
    diffs.update(warm_up=_same(eager[0], got[0][0]), replay=_same(eager[0], got[2][0]))
    res["max_diff"] = diffs
    res["replay_speedup"] = res["seconds"].get("eager_steady", eager[1]) / got[2][1]
    finite = _finite(got[2][0])
    del obj, kept, got, snap, eager
    prof = {}
    for capture in (True, False) if S_EXTENDED else ():
        obj = (short or make)(capture)
        for i in range(2 if capture else 0):
            call(obj, i)  # the warm-up and the capture
        prof["captured" if capture else "eager"] = profile_call(lambda: call(obj, 0))
        del obj
    if prof:
        res["profile" if short is None else f"profile_ddim{S_SHORT_DDIM}"] = prof
    torch.cuda.empty_cache()
    log(f"16 {label}: " + json.dumps(res))
    if any(diffs.values()) or not finite:
        raise AssertionError(f"phase 16 {label}: a call differs from the eager arm "
                             f"({diffs}) or is not finite")
    return res


def burgers_posttrain_case(burgers, bp, b_conf, b_pipe, init, b_data) -> dict:
    """16c: `posttrain` of S_POST_CHUNKS chunks of 10 steps at batch 64
    (one epoch, no evaluation) from the same weights, eagerly and captured
    (a warm-up chunk, the capture, replays): the epoch's loss, the weights,
    the EMA and the AdamW moments bit for bit; the seconds of each of the
    first three chunks (eagerly: of their steps), peak memory, and
    torch.profiler over a fourth chunk (S_EXTENDED)."""
    steps = 10 * S_POST_CHUNKS
    post = dataclasses.replace(burgers.BurgersPostTrainConfig(), conformal=b_conf,
                               finetune_epoch=1, finetune_steps=steps,
                               finetune_batch_size=64, steps_per_call=10)
    res, outs = {}, {}
    orig_chunks, orig_step = bp.ChunkGraph, bp.weighted_step
    try:
        for capture in (False, True):
            timing, prof = [], {}
            if capture:
                class TimedChunks(orig_chunks):
                    def run(self):
                        if len(timing) == 3:
                            return profiled_calls(super().run, 0, 1, prof, "profile")()
                        got, s, _ = timed_call(super().run)
                        timing.append(s)
                        return got

                bp.ChunkGraph = TimedChunks
            else:
                profiled = profiled_calls(orig_step, 0, 10, prof, "profile")

                def step(*a, **kw):
                    if len(timing) < 30:
                        got, s, _ = timed_call(lambda: orig_step(*a, **kw))
                        timing.append(s)
                        return got
                    return profiled(*a, **kw)

                bp.weighted_step = step
            p = b_pipe(capture)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with KeptGraphs() as kept:
                (state, _, hist), s, _ = timed_call(lambda: burgers.posttrain(
                    post, p, init, b_data["train"], b_data["cal"], b_data["test"],
                    eval_every_subset_epoch=False))
            o = state.opt_state
            outs[capture] = (hist[-1]["loss"], list(state.model.parameters()),
                             state.ema_params, o.mu, o.nu)
            chunks = timing if capture else [sum(timing[i : i + 10]) for i in (0, 10, 20)]
            res["captured" if capture else "eager"] = dict(
                seconds=s, chunk_seconds=chunks, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                reserved_gb=torch.cuda.max_memory_reserved() / 1e9, **prof,
                **(dict(nodes=graph_nodes(kept.graphs)) if capture else {}))
            bp.ChunkGraph, bp.weighted_step = orig_chunks, orig_step
            del p, state, kept
    finally:
        bp.ChunkGraph, bp.weighted_step = orig_chunks, orig_step
    res["max_diff"] = _same(outs[False], outs[True])
    log(f"16 burgers posttrain, {steps} steps in chunks of 10 at batch 64: "
        + json.dumps(res))
    if res["max_diff"] or not math.isfinite(outs[True][0]):
        raise AssertionError(f"phase 16 burgers posttrain: captured differs from eager: {res}")
    return res


def _clone_tree(x):
    if isinstance(x, dict):
        return {k: _clone_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_clone_tree(v) for v in x)
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def phase_serving_graphs(burgers, tokamak, b_data, t_data, ddim: int = S_DDIM) -> dict:
    """16: the Burgers and tokamak serving and fine-tuning calls as captured
    CUDA graphs against the same calls run eagerly, at the turbo widths in
    bf16 compute, seeded weights, DDIM `ddim` (`serving_case`)."""
    import safediffcon_torch.tasks.burgers.pipeline as bp
    import safediffcon_torch.tasks.tokamak.pipeline as tp
    from safediffcon_torch.core.train import make_optimizer

    out = {}
    b_conf = burgers.BurgersConformalConfig(ddim_sampling_steps=ddim)
    init = bp.init_params(bp.build_model(**B_MODEL, compute_dtype="bfloat16", device="cuda"),
                          seed=0).state_dict()

    def gen(i):
        return torch.Generator(device="cuda").manual_seed(1600 + i)

    def b_pipe(capture, **conf):
        p = burgers.BurgersPipeline(dataclasses.replace(b_conf, **conf), device="cuda",
                                    compute_dtype="bfloat16", capture=capture, **B_MODEL)
        p.model.load_state_dict(init)
        return p

    def b_cal(p, i):
        p.record = {}
        q = p.calibrate(None, b_data["cal"].data[50 * i : 50 * (i + 1)], 0.1 + 0.5 * i,
                        generator=gen(i))
        return q, p.record["cal_scores"], p.record["cal_weights"]

    out["burgers_calibrate"] = serving_case(
        f"burgers calibrate (B = 50, DDIM {ddim})", b_pipe, b_cal,
        short=lambda c: b_pipe(c, ddim_sampling_steps=S_SHORT_DDIM))
    out["burgers_evaluate"] = serving_case(
        f"burgers guided evaluate with the rollout (B = 50, DDIM {ddim})", b_pipe,
        lambda p, i: p.evaluate(None, b_data["test"], 0.1 + 0.5 * i, generator=gen(i)),
        short=lambda c: b_pipe(c, ddim_sampling_steps=S_SHORT_DDIM))
    out["burgers_posttrain"] = burgers_posttrain_case(burgers, bp, b_conf, b_pipe, init,
                                                      b_data)

    def b_infft(capture, **conf):
        p = b_pipe(capture, **conf)
        tx = make_optimizer("adamw", 1e-5, weight_decay=1e-4, betas=(0.9, 0.999),
                            max_grad_norm=1.0)
        state = bp.make_train_state(p, None, tx, 0.995, 10)
        return state, bp.make_infft_step(p, state)

    batch = torch.as_tensor(b_data["test"].data, device="cuda")

    def b_infft_call(obj, i):
        state, step = obj
        loss = step(batch, 1.1 + 0.5 * i, gen(i))  # Q-hat >= 1: the loss has a gradient
        return _clone_tree((loss, dict(state.model.named_parameters()), state.ema_params))

    out["burgers_infft_step"] = serving_case(
        f"burgers InfFT step (B = 50, DDIM {ddim}, Q-hat 1.1-1.6)", b_infft, b_infft_call,
        state=(lambda o: _clone_tree(o[0].state_dict()),
               lambda o, snap: o[0].load_state_dict(snap)),
        short=lambda c: b_infft(c, ddim_sampling_steps=S_SHORT_DDIM))

    t_conf = tokamak.TokamakConformalConfig(ddim_sampling_steps=ddim)
    t_init = tp.init_params(tp.build_model(compute_dtype="bfloat16", device="cuda"),
                            seed=0).state_dict()

    def t_pipe(capture, **conf):
        p = tokamak.TokamakPipeline(dataclasses.replace(t_conf, **conf), cal_chunk=S_T_CAL,
                                    compute_dtype="bfloat16", capture=capture, device="cuda")
        p.model.load_state_dict(t_init)
        return p

    cal = t_data["cal"]

    def t_cal(p, i):
        p.record = {}
        rows = slice(S_T_CAL * i, S_T_CAL * (i + 1))
        part = tokamak.TokamakDataset(data=cal.data[rows], state_phys=cal.state_phys[rows])
        q = p.calibrate(None, part, 0.1 + 0.2 * i, generator=gen(i))
        return q, p.record["cal_scores"], p.record["cal_weights"]

    out["tokamak_calibrate"] = serving_case(
        f"tokamak calibrate ({S_T_CAL} in one chunk, DDIM {ddim})", t_pipe, t_cal,
        short=lambda c: t_pipe(c, ddim_sampling_steps=S_SHORT_DDIM))
    out["tokamak_evaluate"] = serving_case(
        f"tokamak evaluate with the KSTAR rollout (B = 50, DDIM {ddim})", t_pipe,
        lambda p, i: p.evaluate(None, t_data["test"], 0.1 + 0.2 * i, generator=gen(i)),
        short=lambda c: t_pipe(c, ddim_sampling_steps=S_SHORT_DDIM))

    train = t_data["train"]
    w_all = np.random.default_rng(16).uniform(0.5, 1.5, len(train)).astype(np.float32)

    def t_steps(capture, backward=False, **conf):
        base = tokamak.finetune_config() if backward else tokamak.posttrain_config()
        p = t_pipe(capture, **({"w_obj": 1.0} if backward else {}), **conf)
        tx, weighted, back = tp.make_finetune_steps(
            dataclasses.replace(base, conformal=p.ccfg), p)
        return p, tx.init(list(p.model.parameters())), weighted, back

    def t_snapshot(o):
        return _clone_tree(o[0].model.state_dict()), _clone_tree(o[1].state_dict())

    def t_restore(o, snap):
        o[0].model.load_state_dict(snap[0])
        o[1].load_state_dict(snap[1])

    def t_weighted(obj, i):
        p, opt, weighted, _ = obj
        sel = np.arange(i * 500, i * 500 + 1000) % len(train)
        loss = weighted(opt, torch.as_tensor(train.data[sel], device="cuda"),
                        torch.as_tensor(w_all[sel], device="cuda"), gen(i))
        return _clone_tree((loss, dict(p.model.named_parameters()), opt.tensors()))

    out["tokamak_weighted_step"] = serving_case(
        "tokamak post-training step (batch 1,000)", t_steps, t_weighted,
        state=(t_snapshot, t_restore), short=t_steps)
    test = t_data["test"]
    t_batch = torch.as_tensor(test.data, device="cuda")
    t_target = torch.as_tensor(test.state_phys, device="cuda")

    def t_backward(obj, i):
        p, opt, _, back = obj
        loss = back(opt, t_batch, t_target, 0.05 + 0.1 * i, gen(i))
        return _clone_tree((loss, dict(p.model.named_parameters()), opt.tensors()))

    out["tokamak_backward_step"] = serving_case(
        f"tokamak backward fine-tuning step (B = 50, DDIM {ddim}, w_obj 1)",
        lambda c: t_steps(c, backward=True), t_backward, state=(t_snapshot, t_restore),
        short=lambda c: t_steps(c, backward=True, ddim_sampling_steps=S_SHORT_DDIM))
    return out


# ---------------------------------------------------------------------------
# Phase 17: four cards over NCCL (`python3 chip_smoke.py --cards 4`)
# ---------------------------------------------------------------------------

P17_CARDS = 4
P17_DIR = ROOT / "build" / "chip_smoke" / "p17"
# float32 gradients all-reduced by a data-parallel step, one per model
P17_GRADS = {"UNet3D dim 64": 23_066_887, "turbo UNet1D": 57_341_452,
             "turbo UNet2D": 140_710_147}
P17_AR_REPS = 20  # timed all-reduces per size
P17_KERNEL_CARDS = (1, 2, 3)  # 17b: the cards other than the current one
P17_K1_BATCHES = (8, N_TEST)
P17_K2_SHAPE = (64, 64, 64)  # 17b: (H, Cin, Cout), one of phase 6's shapes
# 17e: the reference-scale recipes' global batches and compute dtype
P17_BATCH = {"burgers": 16, "tokamak": 32}
P17_CMP_K, P17_CMP_STEPS = 3, 9  # chunks: the warm-up, the capture, a replay
P17_SPEED_K, P17_SPEED_STEPS, P17_SPEED_TIME = 10, 40, (20, 40)
P17_SPLITS = (128, 24, 16)  # 17e's train, cal and test sims per task (tokamak: 32 test)
P17_DDIM, P17_CAL_CHUNK = 5, 8  # 17e: three calibration chunks (2 rows per rank)
P17_EVAL_SEEDS = (2, 3, 2)  # the warm-up, the capture on other draws, a replay
P17_CLI_STEPS = 2  # 17f: Burgers pretrain steps (steps_per_call 2; 4 before); smoke: P13_STEPS
P17_TIMEOUT_S = 180  # a rank that waits this long in a collective fails
# the parts the ranks run, each on its (dp, sp) mesh: 17a, 17d, 17c, 17e, 17g
P17_RANK_PARTS = [("a", (P17_CARDS, 1)), ("c", (1, P17_CARDS)), ("c2", (2, 2)),
                  ("b", (P17_CARDS, 1)), ("d", (P17_CARDS, 1)), ("eb", (P17_CARDS, 1)),
                  ("et", (P17_CARDS, 1)), ("gb", (P17_CARDS, 1)), ("gt", (P17_CARDS, 1)),
                  ("gs", (P17_CARDS, 1)), ("gs2", (2, 2))]


def p17_collectives() -> dict:
    """17a on every rank: pmesh's all-reduce, all-gather and reduce-scatter
    over the group, each against its exact value; a captured all-reduce of
    a gradient-sized buffer against the eager one on the same inputs, bit
    for bit; the all-reduce's ms (CUDA events, the slowest rank's is read)
    at each P17_GRADS size."""
    import torch.distributed as dist

    from safediffcon_torch.core.train import CapturedCall
    from safediffcon_torch.parallel import mesh as pmesh

    r, n = pmesh.rank(), pmesh.world_size()
    base = torch.arange(6, dtype=torch.float32, device="cuda").reshape(2, 3)
    y = base + 10 * r
    dist.all_reduce(y)
    gathered = pmesh.all_gather(base + 10 * r, 0, None)
    stacked = torch.arange(12 * n, dtype=torch.float32, device="cuda").reshape(2 * n, 6) + r
    scattered = pmesh.reduce_scatter(stacked, 0, None)
    cpu = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    want_rs = (n * torch.arange(12 * n, dtype=torch.float32).reshape(2 * n, 6)
               + sum(range(n)))[2 * r : 2 * r + 2]
    exact = dict(all_reduce=torch.equal(y.cpu(), n * cpu + 10 * sum(range(n))),
                 all_gather=torch.equal(gathered.cpu(), torch.cat([cpu + 10 * q
                                                                   for q in range(n)])),
                 reduce_scatter=torch.equal(scattered.cpu(), want_rs))

    # the gradient all-reduce inside a graph against the eager one
    g = torch.Generator(device="cuda").manual_seed(100 + r)
    grad = torch.randn(P17_GRADS["turbo UNet2D"], generator=g, device="cuda")
    eager = grad.clone()
    dist.all_reduce(eager)
    buf = torch.empty_like(grad)
    call = CapturedCall(torch.device("cuda"))

    def reduce():
        dist.all_reduce(buf)
        return buf

    outs = []
    for _ in range(3):  # the warm-up, the capture, a replay
        buf.copy_(grad)
        outs.append(call(reduce))
    captured = [float((o - eager).abs().max()) for o in outs]
    del grad, eager, buf, outs, call
    ms = {}
    for name, numel in P17_GRADS.items():
        x = torch.zeros(numel, device="cuda")
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        dist.barrier()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(P17_AR_REPS):
            dist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        ms[name] = start.elapsed_time(end) / P17_AR_REPS
        del x
    torch.cuda.empty_cache()
    return dict(exact=exact, collective_route=pmesh.collective_route(None),
                captured_vs_eager=captured, all_reduce_ms=ms)


@functools.lru_cache(maxsize=None)
def _p17_task(name: str):
    """(task module, pretrain config at P17_BATCH, data splits, pipeline
    maker(capture, compute dtype), seeded weights made on the CPU) of 17e,
    on P17_DIR's data (made once per process)."""
    if name == "burgers":
        import safediffcon_torch.tasks.burgers as mod
        from safediffcon_torch.tasks.burgers import pipeline as pl

        cfg = dataclasses.replace(mod.BurgersPretrainConfig(), **B_MODEL,
                                  batch_size=P17_BATCH[name])
        data = {s: mod.BurgersDataset.load(str(P17_DIR / "burgers.npz"), s)
                for s in ("train", "cal", "test")}
        data["cal"] = data["cal"].data

        def pipe(capture, dtype):
            return mod.BurgersPipeline(mod.BurgersConformalConfig(ddim_sampling_steps=P17_DDIM),
                                       **B_MODEL, compute_dtype=dtype, cal_chunk=P17_CAL_CHUNK,
                                       capture=capture)
    else:
        import safediffcon_torch.tasks.tokamak as mod
        from safediffcon_torch.tasks.tokamak import pipeline as pl

        cfg = dataclasses.replace(mod.TokamakPretrainConfig(), batch_size=P17_BATCH[name])
        data = {s: mod.TokamakDataset.load(str(P17_DIR / "tokamak.npz"), s)
                for s in ("train", "cal", "test")}

        def pipe(capture, dtype):
            return mod.TokamakPipeline(mod.TokamakConformalConfig(ddim_sampling_steps=P17_DDIM),
                                       compute_dtype=dtype, cal_chunk=P17_CAL_CHUNK,
                                       capture=capture)
    torch.manual_seed(3)  # seeded weights (torch's default init), the same on every rank
    net = pl.build_model(cfg.dim, cfg.dim_mults, cfg.resnet_block_groups, device="cpu")
    return mod, cfg, data, pipe, {k: v.detach() for k, v in net.state_dict().items()}


def _p17_pretrain(mod, cfg, train, init, k: int, steps: int, capture: bool,
                  timed=None) -> dict:
    """`pretrain` from `init`: the losses, the final weights and EMA (on
    the card), the peak memory and, with `timed` = (a, b), steps/s over
    steps a to b."""
    clock = {}

    def stamp(n):
        def fn():
            torch.cuda.synchronize()
            clock[n] = time.perf_counter()
        return fn

    marks = StepMarks({n: stamp(n) for n in (timed or ())})
    torch.cuda.synchronize()
    gc.collect()  # an earlier arm's pipelines and graph pools
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = mod.pretrain(cfg, train, num_steps=steps, params=init, device="cuda",
                         steps_per_call=k, losses=marks, capture=capture)
    torch.cuda.synchronize()
    out = dict(losses=[float(v) for v in marks], step=state.step,
               params={n: v.detach().clone() for n, v in state.model.state_dict().items()},
               ema={n: v.clone() for n, v in state.ema_params.items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if timed:
        out["steps_per_s"] = (timed[1] - timed[0]) / (clock[timed[1]] - clock[timed[0]])
    return out


def _p17_serve(pipe, init, data) -> dict:
    """Calibrate (P17_CAL_CHUNK-sim chunks) and an evaluate per seed of
    P17_EVAL_SEEDS; Q-hat, metrics, the pipeline's graph counts, seconds,
    peak memory."""
    pipe.model.load_state_dict(init)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    q = pipe.calibrate(None, data["cal"], 0.0,
                       generator=torch.Generator(device="cuda").manual_seed(1))
    ms = [pipe.evaluate(None, data["test"], q,
                        generator=torch.Generator(device="cuda").manual_seed(s))
          for s in P17_EVAL_SEEDS]
    torch.cuda.synchronize()
    return dict(q=float(q), m=ms, counts=pipe.graphs.counts(),
                seconds=time.perf_counter() - t0, peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _strip(res: dict) -> dict:
    return {k: v for k, v in res.items() if k not in ("params", "ema")}


def p17_task(name: str, one_process: bool = False) -> dict:
    """17e for one task, on this rank (or in one process): with TF32 off, a
    captured float32 pretrain of P17_CMP_STEPS steps in chunks of
    P17_CMP_K and a captured calibrate and evaluate (the compare arms,
    held against one process); then at the default flags in bf16, the
    recipes' dtype: the same pretrain and serving calls eagerly and
    captured on these ranks (bit for bit, ranks only), and the speed arms,
    P17_SPEED_STEPS steps in chunks of P17_SPEED_K, eager (ranks only) and
    captured, steps/s and peak memory."""
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.ops import pressure_cg as K

    mod, cfg, data, make_pipe, init = _p17_task(name)
    _p13_zero()
    res = {}
    t0 = time.perf_counter()
    with tf32_flag(False):
        res["cmp_train"] = _strip(_p17_pretrain(mod, cfg, data["train"], init, P17_CMP_K,
                                                P17_CMP_STEPS, capture=True))
        res["cmp_serve"] = _p17_serve(make_pipe(True, None), init, data)
    res["cmp_s"] = time.perf_counter() - t0
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    with tf32_flag(True):
        if not one_process:
            t0 = time.perf_counter()
            arms = {c: _p17_pretrain(mod, bf16, data["train"], init, P17_CMP_K, P17_CMP_STEPS,
                                     capture=c) for c in (False, True)}
            res["bitwise_train"] = dict(
                losses=_same(arms[False]["losses"], arms[True]["losses"]),
                params=_same(arms[False]["params"], arms[True]["params"]),
                ema=_same(arms[False]["ema"], arms[True]["ema"]),
                losses_eager=arms[False]["losses"])
            del arms
            serve = {c: _p17_serve(make_pipe(c, "bfloat16"), init, data) for c in (False, True)}
            res["bitwise_serve"] = dict(q=_same(serve[False]["q"], serve[True]["q"]),
                                        m=_same(serve[False]["m"], serve[True]["m"]),
                                        counts=serve[True]["counts"],
                                        eager_counts=serve[False]["counts"],
                                        eager_s=serve[False]["seconds"],
                                        captured_s=serve[True]["seconds"])
            res["bitwise_s"] = time.perf_counter() - t0
        for capture in ((True,) if one_process else (False, True)):
            arm = _p17_pretrain(mod, bf16, data["train"], init, P17_SPEED_K, P17_SPEED_STEPS,
                                capture=capture, timed=P17_SPEED_TIME)
            res["speed_" + ("captured" if capture else "eager")] = dict(
                steps_per_s=arm["steps_per_s"], peak_gb=arm["peak_gb"],
                finite=all(math.isfinite(v) for v in arm["losses"]))
    res["counts"] = _p13_counts()
    res["k1_k2"] = (K.pressure_cg_cuda.launches, k2_launches(C) + C.conv3d_fused_simt_cuda.launches)
    return res


# 17g: the fine-tuning phases of the three tasks on the ranks, against one
# process on card 0 (TF32 off, float32) and, for Burgers and tokamak, eager
# against captured on the ranks (default flags, bf16)
P17G_DIR = P17_DIR / "17g"  # one process's final weights, which the ranks read
P17G_DDIM = 5  # DDIM steps of the Burgers and tokamak phases (configs: 200 / 250)
# Burgers posttrain: one epoch of 7 steps at a global batch of 32 in chunks
# of 3 (a warm-up chunk, the captured chunk, one step left over), evaluated
# at its end; InfFT: two epochs of one step on the 16 test sims
P17G_POST = dict(k=3, steps=7, batch=32)
P17G_T_STEPS, P17G_T_BATCH = 3, 32  # tokamak: steps of its one epoch, global batch
P17G_S_STEPS, P17G_S_BATCH, P17G_S_POOL = 2, 8, 16  # smoke post-training from its pool
P17G_S_LOSS_TOL = {"weighted": 1e-5, "backward": 1e-3}  # see p17g_check


class GraphTally:
    """The graphs a phase ran, per kind of call: each graph's capture call
    and replays, read as the phase frees its pipeline's graphs
    (`Graphs.clear`), and posttrain's chunk graphs (`ChunkGraph`) as
    "chunk"."""

    def __enter__(self):
        from safediffcon_torch.core import train as T

        self.T, self.kinds, self.chunks = T, {}, []
        self._clear, self._run = T.Graphs.clear, T.ChunkGraph.run
        tally = self

        def clear(graphs):
            for key, sc in graphs.calls.items():
                n = sum(c.calls - c.warm_calls for _, c in sc.graphs.values()
                        if c.graph is not None)
                tally.kinds[str(key[0])] = tally.kinds.get(str(key[0]), 0) + n
            tally._clear(graphs)

        def run(chunk):
            if not any(c is chunk for c in tally.chunks):
                tally.chunks.append(chunk)
            return tally._run(chunk)

        T.Graphs.clear, T.ChunkGraph.run = clear, run
        return self

    def __exit__(self, *exc):
        self.T.Graphs.clear, self.T.ChunkGraph.run = self._clear, self._run

    def counts(self) -> dict:
        out = dict(self.kinds)
        out["chunk"] = sum(c.call.calls - c.call.warm_calls for c in self.chunks
                           if c.graph is not None)
        return out


def _ranks_equal(tensors) -> bool:
    """Whether every rank of the group holds the same values (their
    all-reduced maximum and minimum are equal)."""
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    hi, lo = flat.clone(), flat
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return bool(torch.equal(hi, lo))


def _p17g_weights(task: str, weights: dict, one_process: bool, lr: dict) -> dict:
    """One process saves each phase's final weights under P17G_DIR; a rank
    reads them and returns its largest difference in units of the phase's
    lr, and whether the ranks agree bit for bit."""
    out = {}
    for name, sd in weights.items():
        path = P17G_DIR / f"{task}_{name}.pt"
        if one_process:
            P17G_DIR.mkdir(parents=True, exist_ok=True)
            torch.save({k: v.cpu() for k, v in sd.items()}, path)
            continue
        ref = torch.load(path, map_location="cuda", weights_only=True)
        out[name] = dict(lr_units=max(float((sd[k] - v).abs().max()) for k, v in ref.items())
                         / lr[name], ranks_equal=_ranks_equal(list(sd.values())))
        del ref
    return out


def _same_weights(a: dict, b: dict) -> bool:
    return all(torch.equal(v, b[name][k]) for name, sd in a.items() for k, v in sd.items())


def _unclipped_safety(sd: dict) -> dict:
    """InfFT's safety loss has no gradient where random weights clip the s
    channel: a small final conv with a bias on the s output."""
    sd = dict(sd, **{"final_conv.weight": sd["final_conv.weight"] * 0.01})
    sd["final_conv.bias"] = sd["final_conv.bias"].clone()
    sd["final_conv.bias"][2] = 2.0
    return sd


def _p17g_burgers(capture: bool, dtype) -> dict:
    """Burgers fine-tuning as a user runs it, on P17_DIR's data from 17e's
    seeded weights: calibrate the start, then `posttrain` one epoch
    (P17G_POST, its evaluation at the end), then `inference_finetune` from
    the start (its s output unclipped) for two epochs of one step on the
    16 test sims, each recalibrated and evaluated; DDIM P17G_DDIM. Returns
    Q-hats, epoch records, the graphs per kind, seconds, peak memory and
    the final weights and EMA (on the card)."""
    import safediffcon_torch.tasks.burgers as mod
    from safediffcon_torch.tasks.burgers import pipeline as pl

    _, _, data, _, init = _p17_task("burgers")
    cal = mod.BurgersDataset.load(str(P17_DIR / "burgers.npz"), "cal")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, weights = {}, {}
    for name, start, w_score in (("post", init, 5.0), ("infft", _unclipped_safety(init), 2.0)):
        conf = mod.BurgersConformalConfig(ddim_sampling_steps=P17G_DDIM, w_score=w_score)
        pipe = mod.BurgersPipeline(conf, **B_MODEL, compute_dtype=dtype, cal_chunk=P17_CAL_CHUNK,
                                   capture=capture)
        pipe.model.load_state_dict(start)
        with GraphTally() as tally:
            if name == "post":
                q0 = pipe.calibrate(None, cal.data, 0.0,
                                    generator=torch.Generator(device="cuda").manual_seed(1))
                res["q0"] = float(q0)
                cfg = mod.BurgersPostTrainConfig(
                    conformal=conf, finetune_epoch=1, finetune_steps=P17G_POST["steps"],
                    finetune_batch_size=P17G_POST["batch"], steps_per_call=P17G_POST["k"],
                    finetune_subset_size=P17G_POST["steps"] * P17G_POST["batch"])
                state, q, hist = pl.posttrain(cfg, pipe, None, data["train"], cal, data["test"])
            else:
                cfg = mod.BurgersInfFTConfig(conformal=conf, InfFT_iters=3)
                state, q, hist = pl.inference_finetune(cfg, pipe, None, cal, data["test"])
        res[name] = dict(q=float(q), hist=hist, graphs=tally.counts(), lr=cfg.finetune_lr)
        weights[name] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        weights[name + "_ema"] = {k: v.clone() for k, v in state.ema_params.items()}
        del pipe, state
    torch.cuda.synchronize()
    return dict(res, weights=weights, seconds=time.perf_counter() - t0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _p17g_tokamak(capture: bool, dtype) -> dict:
    """Tokamak `run_inference` from 17e's seeded weights, one epoch
    (calibrate, P17G_T_STEPS steps at a global batch of 32, evaluate; DDIM
    P17G_DDIM): post-training with `posttrain_config()` ("weighted") and
    the backward fine-tune with `finetune_config()` on a
    `finetune_set="test"` pipeline, w_obj 1 so that its loss has a gradient
    ("backward"). Returns as `_p17g_burgers`."""
    import safediffcon_torch.tasks.tokamak as mod

    _, _, data, _, init = _p17_task("tokamak")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, weights = {}, {}
    for name in ("weighted", "backward"):
        back = name == "backward"
        base = mod.finetune_config() if back else mod.posttrain_config()
        conf = dataclasses.replace(base.conformal, ddim_sampling_steps=P17G_DDIM,
                                   test_batch_size=P17G_T_BATCH,
                                   **(dict(finetune_set="test", w_obj=1.0) if back else {}))
        cfg = dataclasses.replace(base, conformal=conf, finetune_epoch=1,
                                  finetune_steps=P17G_T_STEPS, train_batch_size=P17G_T_BATCH)
        pipe = mod.TokamakPipeline(conf, compute_dtype=dtype, cal_chunk=P17_CAL_CHUNK,
                                   capture=capture)
        with GraphTally() as tally:
            params, q, hist = mod.run_inference(cfg, pipe, init, data["train"], data["cal"],
                                                data["test"])
        res[name] = dict(q=float(q), hist=hist, graphs=tally.counts(), lr=cfg.finetune_lr)
        weights[name] = {k: v.to("cuda") for k, v in params.items()}
        del pipe
    torch.cuda.synchronize()
    return dict(res, weights=weights, seconds=time.perf_counter() - t0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def _p17g_pair(task: str, run, one_process: bool) -> dict:
    """A fine-tuning case of 17g: with TF32 off in float32, eagerly (the
    eager split on the ranks, held against one process); on the ranks also
    at the default flags in bf16, eagerly and captured, equal bit for bit."""
    t0 = time.perf_counter()
    with tf32_flag(False):
        cmp_ = run(False, None)
    lr = {k: v["lr"] for k, v in cmp_.items() if isinstance(v, dict) and "lr" in v}
    lr.update({k + "_ema": v for k, v in lr.items()})
    cmp_["weights"] = _p17g_weights(task, cmp_["weights"], one_process, lr)
    out = dict(cmp=cmp_, cmp_s=time.perf_counter() - t0)
    if one_process:
        return out
    t0 = time.perf_counter()
    with tf32_flag(True):
        eager = run(False, "bfloat16")
        captured = run(True, "bfloat16")
    phases = [k for k, v in eager.items() if isinstance(v, dict) and "hist" in v]

    def qs(r: dict) -> dict:
        return {k: r[k]["q"] for k in phases} | ({"q0": r["q0"]} if "q0" in r else {})

    out["bitwise"] = dict(
        q=[k for k, v in qs(eager).items() if v != qs(captured)[k]],
        hist=[k for k in phases if eager[k]["hist"] != captured[k]["hist"]],
        weights=_same_weights(eager["weights"], captured["weights"]),
        eager_graphs={k: eager[k]["graphs"] for k in phases},
        graphs={k: captured[k]["graphs"] for k in phases},
        losses={k: [r["loss"] for r in captured[k]["hist"]] for k in phases},
        eager_s=eager["seconds"], captured_s=captured["seconds"],
        peak_gb=max(eager["peak_gb"], captured["peak_gb"]))
    out["bitwise_s"] = time.perf_counter() - t0
    return out


def p17g_burgers(one_process: bool = False) -> dict:
    return _p17g_pair("burgers", _p17g_burgers, one_process)


def p17g_tokamak(one_process: bool = False) -> dict:
    return _p17g_pair("tokamak", _p17g_tokamak, one_process)


def p17g_smoke(one_process: bool = False) -> dict:
    """17g-s on this rank's mesh (dp 4, or dp 2 x sp 2: the UNet3D splits
    its frames) or in one process, TF32 off, float32 (the smoke pipelines
    stay eager): `run_inference` of the reference UNet3D on 13(d)'s seeded
    weights and sims (8 cal, 8 test, DDIM P13_SMOKE_DDIM), one epoch each:
    post-training, P17G_S_STEPS steps of a global batch of 8 gathered from
    a device pool of the 16 train sims ("weighted"), and the backward
    fine-tune on a `finetune_set="test"` pipeline ("backward"); the
    epoch's calibrate and evaluate (K1) after the steps. K1 launches per
    phase, Q-hat, the epoch records, seconds and peak memory."""
    from safediffcon_torch.ops import pressure_cg as K
    import safediffcon_torch.tasks.smoke as smoke
    from safediffcon_torch.tasks.smoke.pipeline import init_params

    cal = smoke.SmokeDataset(data=np.load(P13_DIR / "smoke_cal.npy"),
                             raw=np.load(P13_DIR / "smoke_cal.npy"))
    test = smoke.SmokeDataset(data=np.load(P13_DIR / "smoke_test.npy"),
                              raw=np.load(P13_DIR / "smoke_test_raw.npy"))
    train_arr = np.load(P13_DIR / "train.npy")
    train = smoke.SmokeDataset(data=train_arr, raw=train_arr)
    res, weights = {}, {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with tf32_flag(False):
        for name in ("weighted", "backward"):
            back = name == "backward"
            base = smoke.finetune_config() if back else smoke.posttrain_config()
            conf = dataclasses.replace(base.conformal, ddim_sampling_steps=P13_SMOKE_DDIM,
                                       cal_batch_size=P13_SMOKE_SIMS, num_cal_batch=1,
                                       test_batch_size=P13_SMOKE_SIMS)
            cfg = dataclasses.replace(
                base, conformal=conf, finetune_epoch=1,
                **(dict(finetune_steps=1) if back else dict(
                    finetune_steps=P17G_S_STEPS, finetune_batch_size=P17G_S_BATCH,
                    device_pool=P17G_S_POOL)))
            pipe = smoke.SmokePipeline(conf, finetune_set="test" if back else "train")
            init_params(pipe.model, seed=3)
            K.pressure_cg_cuda.launches = 0
            t1 = time.perf_counter()
            params, q, hist = smoke.run_inference(cfg, pipe, None, train, cal, test)
            torch.cuda.synchronize()
            res[name] = dict(q=float(q), hist=hist, k1=K.pressure_cg_cuda.launches,
                             lr=cfg.finetune_lr, seconds=time.perf_counter() - t1)
            weights[name] = params
            del pipe
    res["weights"] = _p17g_weights("smoke", weights, one_process,
                                   {k: res[k]["lr"] for k in weights})
    return dict(res, seconds=time.perf_counter() - t0,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)


P17_PARTS = {"a": p17_collectives, "c2": p13_unet3d,
             "eb": lambda: p17_task("burgers"), "et": lambda: p17_task("tokamak"),
             "gb": p17g_burgers, "gt": p17g_tokamak, "gs": p17g_smoke, "gs2": p17g_smoke}


def phase_p17_kernels(K, C, S) -> dict:
    """17b: from a process whose current device is cuda:0, K1 (B = 8 and
    50, 127^2, 1e-8, checked every iteration) and K2 (TF32 and bf16 at
    P17_K2_SHAPE, B = 16, F = 32) on each card of P17_KERNEL_CARDS against
    their plain versions there, with phase 3's and phase 6's tolerances;
    then each kernel's, its plain version's and (K2) F.conv3d's ms on the
    first of those cards."""
    torch.cuda.set_device(0)
    h, cin, cout = P17_K2_SHAPE
    out = dict(k1=[], k2=[])
    for card in P17_KERNEL_CARDS:
        dev = torch.device("cuda", card)
        masks = S.build_masks(dev)
        gen = torch.Generator(device=dev).manual_seed(card)
        for batch in P17_K1_BATCHES:
            v = 0.3 * torch.randn((batch, 128, 128, 2), generator=gen, device=dev)
            div = S.divergence(v * masks.velocity_mask).contiguous()
            args = (div, torch.zeros_like(div), masks.planes, 1e-8, 500, 1)
            before = K.pressure_cg_cuda.launches
            xk, ik = K.pressure_cg(*args)
            xp, ip = K.pressure_cg_plain(*args)
            torch.cuda.synchronize(dev)
            diff, scale = rel_err(xk, xp)
            res_k = float((K.apply_A_planes(masks.planes, xk) - div).abs().max())
            case = dict(card=card, batch=batch, max_diff=diff, max_abs=scale, residual=res_k,
                        iterations=ik.tolist(), plain_iterations=ip.tolist(),
                        launches=K.pressure_cg_cuda.launches - before, on=str(xk.device))
            log("17b K1 " + json.dumps(case))
            # phase 3's tolerances
            if not (diff <= 1e-4 * scale and res_k < 1e-3 and case["launches"] == 1
                    and xk.device == dev and torch.cuda.current_device() == 0):
                raise AssertionError(f"17b: K1 on cuda:{card} {case}")
            if card == P17_KERNEL_CARDS[0] and batch == N_TEST:
                with torch.cuda.device(dev):
                    kernel_ms = cuda_ms(lambda: K.pressure_cg_cuda(*args), reps=K1_REPS)
                    plain_ms = cuda_ms(lambda: K.pressure_cg_plain(*args), reps=2)
                bound_ms, bound_by = cg_bound_ms(batch, ik.tolist())
                out["k1_time"] = dict(card=card, ms=kernel_ms, plain_ms=plain_ms,
                                      bound_ms=bound_ms, bound_by=bound_by)
            out["k1"].append(case)
        del masks, v, div, xk, xp

        shape = (K2_BATCH, FRAMES, h, h, cin)
        x = torch.randn(shape, generator=gen, device=dev)
        w = torch.randn((cout, cin, 3, 3, 3), generator=gen, device=dev) / (27 * cin) ** 0.5
        wf = C.flatten_weight(w)
        xn = x.permute(0, 4, 1, 2, 3)
        with tf32_flag(False):
            plain = C.conv3d_fused_plain(x, wf)
        with tf32_flag(True):
            lib, _ = rel_err(F.conv3d(xn, w, padding=1).permute(0, 2, 3, 4, 1), plain)
            before = dict(C.conv3d_fused_cuda.launches)
            got = C.conv3d_fused(x, wf)
        xb, wbf = x.bfloat16(), C.flatten_weight(w.bfloat16())
        ref_b = C.conv3d_fused_plain(xb, wbf)
        got_b = C.conv3d_fused(xb, wbf)
        torch.cuda.synchronize(dev)
        launched = {m: n - before[m] for m, n in C.conv3d_fused_cuda.launches.items()}
        diff, scale = rel_err(got, plain)
        diff_b, scale_b = rel_err(got_b, ref_b)
        case = dict(card=card, shape=list(shape), tf32_max_diff=diff, max_abs=scale,
                    cudnn_tf32_diff=lib, bf16_max_diff=diff_b, bf16_max_abs=scale_b,
                    launches=launched, on=str(got.device))
        log("17b K2 " + json.dumps(case))
        # phase 6's tolerances: TF32 within twice cuDNN's TF32 error + 1e-4 and
        # 5e-3 of max; bf16 within 1e-2 of max
        if not (diff <= 2 * lib + 1e-4 * scale and diff <= 5e-3 * scale
                and diff_b <= 1e-2 * scale_b and got.device == dev
                and launched == dict(dict.fromkeys(C.MODES, 0), tf32=1, bf16=1)
                and torch.cuda.current_device() == 0):
            raise AssertionError(f"17b: K2 on cuda:{card} {case}")
        if card == P17_KERNEL_CARDS[0]:
            with torch.cuda.device(dev), tf32_flag(True):
                kernel_ms = cuda_ms(lambda: C.conv3d_fused(x, wf), reps=K2_REPS)
                plain_ms = cuda_ms(lambda: C.conv3d_fused_plain(x, wf), reps=1)
                library_ms = cuda_ms(lambda: F.conv3d(xn, w, padding=1), reps=K2_REPS)
            bound_ms, bound_by = conv_bound_ms(K2_BATCH, h, cin, cout, torch.float32)
            out["k2_time"] = dict(card=card, ms=kernel_ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        out["k2"].append(case)
        del x, w, wf, xn, plain, got, xb, wbf, ref_b, got_b
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
    log("17b times on cuda:%d " % P17_KERNEL_CARDS[0]
        + json.dumps(dict(k1=out["k1_time"], k2=out["k2_time"])))
    return out


def p17_cli(cmd: list, name: str, timeout: int = 420) -> tuple:
    """Run one 17f command from the repository root; returns (seconds,
    stdout + stderr), its output also saved under P17_DIR; fails on a
    non-zero exit."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=str(ROOT),
                          env=env)
    seconds = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    (P17_DIR / f"{name}.log").write_text(text)
    if proc.returncode != 0:
        raise AssertionError(f"17f {name} exited {proc.returncode}:\n{text[-4000:]}")
    return seconds, text


def phase_p17_cli(errors: list) -> dict:
    """17f: `torchrun --nproc_per_node=4 -m safediffcon_torch.cli.main
    burgers pretrain`, the same command with no launcher (the command line
    starts one worker per card), and `smoke pretrain --sp 2 --conv-impl
    pallas` on four torchrun ranks (`--cli-rank`, which prints each rank's
    K2 counts): each exits 0 and logs its NCCL group; the smoke ranks each
    launch K2, 90 times per step. A failed command is added to `errors`
    and the next one still runs."""
    cli = P17_DIR / "cli"
    b_data, s_data = cli / "burgers" / "burgers.npz", cli / "smoke" / "smoke.npz"
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={P17_CARDS}"]
    b_args = ["burgers", "pretrain", "--data", str(b_data), "--steps", str(P17_CLI_STEPS),
              "--steps-per-call", "2"]
    res = {}
    group = f"rank 0 of {P17_CARDS} in the nccl process group"
    for name, cmd, marks in (
            ("torchrun", torchrun + ["-m", "safediffcon_torch.cli.main"] + b_args
             + ["--out", str(cli / "b_torchrun")], (group,)),
            ("spawn", [sys.executable, "-m", "safediffcon_torch.cli.main"] + b_args
             + ["--out", str(cli / "b_spawn")],
             (f"{P17_CARDS} CUDA devices visible: starting one rank per card", group))):
        try:
            seconds, text = p17_cli(cmd, name)
        except AssertionError as e:
            errors.append(str(e))
            continue
        missing = [m for m in marks if m not in text]
        log(f"17f {name} burgers pretrain --steps {P17_CLI_STEPS}: rc 0 in {seconds:.1f} s; "
            f"missing from its log: {missing}")
        if missing:
            errors.append(f"17f {name}: the log lacks {missing}")
        res[name] = dict(seconds=seconds)
    cmd = torchrun + [str(ROOT / "chip_smoke.py"), "--cli-rank", "smoke", "pretrain", "--data",
                      str(s_data), "--out", str(cli / "s_sp2"), "--steps", str(P13_STEPS),
                      "--sp", "2", "--conv-impl", "pallas"]
    try:
        seconds, text = p17_cli(cmd, "smoke_sp2")
    except AssertionError as e:
        errors.append(str(e))
        return res
    reps = sorted((json.loads(ln[5:]) for ln in text.splitlines() if ln.startswith("P13A ")),
                  key=lambda d: d["rank"])
    n_convs = sum(n for *_, n in K2_SHAPES)
    k2 = [sum(rep["k2"].values()) + rep["k2_simt"] for rep in reps]
    log(f"17f torchrun --nproc_per_node={P17_CARDS} smoke pretrain --sp 2 --conv-impl pallas "
        f"--steps {P13_STEPS}: rc 0 in {seconds:.1f} s; "
        + "; ".join(f"rank {rep['rank']}: {rep['group']}, K2 {rep['k2']} + {rep['k2_simt']} "
                    f"SIMT" for rep in reps))
    if (len(reps) != P17_CARDS or k2 != [3 * n_convs * P13_STEPS] * P17_CARDS
            or not all(rep["group"].startswith(f"nccl group of {P17_CARDS}") for rep in reps)):
        errors.append(f"17f smoke --sp 2: {reps}")
    res["smoke_sp2"] = dict(seconds=seconds, k2_per_rank=k2,
                            k2_modes=[rep["k2"] for rep in reps],
                            k2_simt=[rep["k2_simt"] for rep in reps])
    return res


def _p17_data(burgers, tokamak, smoke) -> None:
    """17's data: P17_SPLITS Burgers and tokamak sims (32 tokamak test sims), the command line's
    smoke (16 + 8 + 8, on K1) and Burgers generate-data; phase 13's smoke
    files."""
    P17_DIR.mkdir(parents=True, exist_ok=True)
    n_train, n_cal, n_test = P17_SPLITS
    burgers.generate_burgers_dataset(str(P17_DIR / "burgers.npz"), n_train=n_train,
                                     n_cal=n_cal, n_test=n_test, seed=0, solve_batch=4096,
                                     device="cuda")
    # 17g's backward fine-tune takes a test batch of 32
    tokamak.generate_tokamak_dataset(str(P17_DIR / "tokamak.npz"), n_train=n_train,
                                     n_cal=n_cal, n_test=P17G_T_BATCH, seed=0, gen_batch=8192,
                                     device="cuda")
    cli = P17_DIR / "cli"
    s_train, s_cal, s_test = CLI_S_SPLITS
    run_cli(["smoke", "generate-data", "--n-train", str(s_train), "--n-cal", str(s_cal),
             "--n-test", str(s_test), "--out", str(cli / "smoke")])
    run_cli(["burgers", "generate-data", "--n-train", str(CLI_B_SPLITS[0]), "--n-cal",
             str(CLI_B_SPLITS[1]), "--n-test", str(CLI_B_SPLITS[2]), "--out",
             str(cli / "burgers")])
    path = str(cli / "smoke" / "smoke.npz")
    save_p13_smoke(*(smoke.SmokeDataset.load(path, s) for s in ("train", "cal", "test")))


def p17_check(ranks: list, errors: list, ref: dict) -> dict:
    """17a and 17c-e: each rank's results against their exact values, one
    process's (`ref`) and the launch counts its share implies; every
    failed check is listed in `errors`."""
    res = {}

    def need(ok: bool, what: str) -> None:
        if not ok:
            errors.append(what)

    import safediffcon_torch.tasks.smoke as smoke

    n_convs = sum(n for *_, n in K2_SHAPES)
    lr = smoke.SmokePretrainConfig().lr
    got = [g.get("a") for g in ranks]
    if all(got):
        slow = {k: max(g["all_reduce_ms"][k] for g in got) for k in P17_GRADS}
        bus = {k: 2 * (P17_CARDS - 1) / P17_CARDS * 4 * n / (slow[k] / 1e3) / 1e9
               for k, n in P17_GRADS.items()}
        res["a"] = dict(all_reduce_ms=slow, bus_gb_per_s=bus,
                        captured_vs_eager=[g["captured_vs_eager"] for g in got])
        log("17a " + json.dumps(dict(res["a"], exact=[g["exact"] for g in got],
                                     route=[g["collective_route"] for g in got])))
        for r, g in enumerate(got):
            need(all(g["exact"].values()) and g["collective_route"] == "native"
                 and not any(g["captured_vs_eager"]),
                 f"17a rank {r}: {g['exact']} {g['collective_route']} {g['captured_vs_eager']}")
    else:
        errors.append("17a: a rank has no result")

    rb = ref["b"]
    for r, g in enumerate(gr.get("b") for gr in ranks):
        if g is None:
            errors.append(f"17c pretrain: rank {r} has no result")
            continue
        lerr = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], rb["losses"]))
        wabs = max(float((g["params"][k] - v).abs().max()) for k, v in rb["params"].items())
        tc = g["counts"]["k2"]["3xtf32"]
        log(f"17c pretrain rank {r} ({g['route']}): losses {g['losses']} against "
            f"{rb['losses']} (rel {lerr:.2e}); weights max |diff| {wabs / lr:.3f} lr; K2 {tc} "
            f"3xTF32, {g['counts']['k2_simt']} SIMT; {g['seconds']:.2f} s, peak "
            f"{g['peak_gb']:.2f} GB (one process {rb['seconds']:.2f} s, {rb['peak_gb']:.2f} GB)")
        need(lerr <= 1e-5 and wabs <= 2.5 * lr, f"17c pretrain rank {r}: {lerr} {wabs}")
        need(tc == 3 * n_convs * P13_STEPS and not g["counts"]["k2_simt"]
             and sum(g["counts"]["k2"].values()) == tc, f"17c pretrain rank {r}: {g['counts']}")
    if all(gr.get("b") for gr in ranks):
        p0 = ranks[0]["b"]["params"]
        need(all(torch.equal(v, gr["b"]["params"][k]) for gr in ranks for k, v in p0.items()),
             "17c pretrain: the ranks' weights differ")
        res["b"] = dict(k2_per_rank=[gr["b"]["counts"]["k2"]["3xtf32"] for gr in ranks],
                        peak_gb=[gr["b"]["peak_gb"] for gr in ranks], ref_peak_gb=rb["peak_gb"])

    rd = ref["d"]
    for r, g in enumerate(gr.get("d") for gr in ranks):
        if g is None:
            errors.append(f"17c serving: rank {r} has no result")
            continue
        qerr = abs(g["q"] - rd["q"]) / abs(rd["q"])
        log(f"17c serving rank {r} ({g['route']}): Q {g['q']:.6g} against {rd['q']:.6g} (rel "
            f"{qerr:.2e}); K1 {g['counts']['k1']} (one process {rd['counts']['k1']}), K2 "
            f"{sum(g['counts']['k2'].values())}; {g['seconds']:.2f} s (one process "
            f"{rd['seconds']:.2f} s); metrics {json.dumps(g['metrics'])}")
        need(qerr <= 1e-5 and g["counts"]["k1"] == SOLVER_STEPS
             and not sum(g["counts"]["k2"].values()), f"17c serving rank {r}: {g['counts']}")
        for name, v in rd["metrics"].items():
            # as 13(d): K1 solves each rank's chunk of 2 as one system
            tol = (100 / P13_SMOKE_SIMS + 1e-9 if "percentage" in name
                   else 1e-3 * abs(v) + 1e-9)
            need(abs(g["metrics"][name] - v) <= tol, f"17c serving rank {r}: {name}")
    if all(gr.get("d") for gr in ranks):
        res["d"] = dict(k1_per_rank=[gr["d"]["counts"]["k1"] for gr in ranks],
                        q=[gr["d"]["q"] for gr in ranks], q_ref=rd["q"])

    rc = ref["c"]
    for part, label in (("c", "sp 4"), ("c2", "dp 2 x sp 2")):
        for r, g in enumerate(gr.get(part) for gr in ranks):
            if g is None:
                errors.append(f"17d {label}: rank {r} has no result")
                continue
            lo, hi = g["rows"]
            oerr = _rel(g["out"], rc["out"][lo:hi])
            gerr = max(_rel(a, b) for a, b in zip(g["grads"], rc["grads"]))
            k2 = g["counts"]["k2"]
            log(f"17d {label} rank {r} ({g['route']}): rows {lo}:{hi}, {g['frames']} + 2 frames; "
                f"out rel {oerr:.2e}, gradients rel {gerr:.2e}; K2 {k2} tensor-core, "
                f"{g['counts']['k2_simt']} SIMT; peak {g['peak_gb']:.2f} GB above the weights "
                f"and inputs (unsharded {rc['peak_gb']:.2f} GB)")
            frames = FRAMES // (P17_CARDS if part == "c" else 2)
            need(g["frames"] == frames and oerr <= 1e-4 and gerr <= 1e-4
                 and sum(k2.values()) + g["counts"]["k2_simt"] == 3 * n_convs,
                 f"17d {label} rank {r}: {oerr} {gerr} {g['counts']}")
        if all(gr.get(part) for gr in ranks):
            res[part] = dict(k2_per_rank=[gr[part]["counts"]["k2"] for gr in ranks],
                             simt_per_rank=[gr[part]["counts"]["k2_simt"] for gr in ranks],
                             peak_gb=[gr[part]["peak_gb"] for gr in ranks],
                             ref_peak_gb=rc["peak_gb"])

    for part, name in (("eb", "burgers"), ("et", "tokamak")):
        one = ref[part]
        for r, g in enumerate(gr.get(part) for gr in ranks):
            if g is None:
                errors.append(f"17e {name}: rank {r} has no result")
                continue
            lerr = max(abs(a - b) / abs(b) for a, b in zip(g["cmp_train"]["losses"],
                                                          one["cmp_train"]["losses"]))
            qerr = abs(g["cmp_serve"]["q"] - one["cmp_serve"]["q"]) / abs(one["cmp_serve"]["q"])
            merr = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                       for a, b in zip(g["cmp_serve"]["m"], one["cmp_serve"]["m"]) for k in b)
            bt, bs = g["bitwise_train"], g["bitwise_serve"]
            log(f"17e {name} rank {r}: float32 pretrain losses rel {lerr:.2e}, Q-hat "
                f"{g['cmp_serve']['q']:.6g} against {one['cmp_serve']['q']:.6g} (rel "
                f"{qerr:.2e}), metrics max rel {merr:.2e}, graphs {g['cmp_serve']['counts']}; "
                f"bf16 captured against eager: pretrain {json.dumps({k: bt[k] for k in ('losses', 'params', 'ema')})}, "
                f"serving Q {bs['q']} metrics {bs['m']} (graphs {bs['counts']}, eager "
                f"{bs['eager_counts']}; {bs['captured_s']:.1f} s against {bs['eager_s']:.1f} s); "
                f"steps/s eager {g['speed_eager']['steps_per_s']:.2f} captured "
                f"{g['speed_captured']['steps_per_s']:.2f} (one card captured "
                f"{one['speed_captured']['steps_per_s']:.2f}); peak GB eager "
                f"{g['speed_eager']['peak_gb']:.2f} captured {g['speed_captured']['peak_gb']:.2f} "
                f"(one card {one['speed_captured']['peak_gb']:.2f}); K1 / K2 {g['k1_k2']}; "
                f"seconds compare {g['cmp_s']:.1f} bitwise {g['bitwise_s']:.1f}")
            need(lerr <= 1e-5 and qerr <= 1e-5, f"17e {name} rank {r}: {lerr} {qerr}")
            need(merr <= 1e-3, f"17e {name} rank {r}: metrics {merr}")
            n_graphs = dict(graphs=2, replays=1 + len(P17_EVAL_SEEDS) - 2)
            need(g["cmp_serve"]["counts"] == bs["counts"] == n_graphs
                 and bs["eager_counts"] == dict(graphs=0, replays=0),
                 f"17e {name} rank {r}: graph counts {g['cmp_serve']['counts']} {bs}")
            need(not any(bt[k] for k in ("losses", "params", "ema")) and not bs["q"]
                 and not bs["m"], f"17e {name} rank {r}: captured differs from eager {bt} {bs}")
            need(g["speed_eager"]["finite"] and g["speed_captured"]["finite"]
                 and not any(g["k1_k2"]), f"17e {name} rank {r}: {g['k1_k2']}")
        if all(gr.get(part) for gr in ranks):
            res[part] = dict(
                steps_per_s=dict(one_card_captured=one["speed_captured"]["steps_per_s"],
                                 four_eager=min(gr[part]["speed_eager"]["steps_per_s"]
                                                for gr in ranks),
                                 four_captured=min(gr[part]["speed_captured"]["steps_per_s"]
                                                   for gr in ranks)),
                peak_gb=dict(one_card=one["speed_captured"]["peak_gb"],
                             eager=[gr[part]["speed_eager"]["peak_gb"] for gr in ranks],
                             captured=[gr[part]["speed_captured"]["peak_gb"] for gr in ranks]),
                batch=P17_BATCH[name])
            log(f"17e {name} " + json.dumps(res[part]))
    return res


def _relf(a, b) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def _epoch_metrics(rec: dict) -> dict:
    """An epoch record's metrics: its evaluation, or each of posttrain's."""
    out = dict(rec.get("eval") or {})
    for i, m in enumerate(rec.get("eval_history", [])):
        out.update({f"{i}/{k}": v for k, v in m.items()})
    return out


def _p17g_against(c: dict, one: dict, loss_tol: dict, metric_tol) -> dict:
    """One rank's compare arm against one process's: the largest relative
    error of its Q-hats, epoch losses and metrics (each over its
    tolerance), its weights' largest difference in lr, the ranks' weights
    equal."""
    phases = [k for k, v in one.items() if isinstance(v, dict) and "hist" in v]
    qs = ([(c["q0"], one["q0"])] if "q0" in one else []) + [(c[k]["q"], one[k]["q"])
                                                             for k in phases]
    out = dict(q=0.0, loss=0.0, metrics=0.0, worst_metric=None)
    for k in phases:
        assert len(c[k]["hist"]) == len(one[k]["hist"]), k
        for g, o in zip(c[k]["hist"], one[k]["hist"]):
            qs.append((g["quantile"], o["quantile"]))
            out["loss"] = max(out["loss"], _relf(g["loss"], o["loss"]) / loss_tol[k])
            gm, om = _epoch_metrics(g), _epoch_metrics(o)
            assert gm.keys() == om.keys() and om, k
            for m, v in om.items():
                e = abs(gm[m] - v) / metric_tol(m, v)
                if e >= out["metrics"]:
                    out["metrics"], out["worst_metric"] = e, f"{k} {m}"
    out["q"] = max(_relf(a, b) for a, b in qs) / 1e-5
    out["lr_units"] = max(v["lr_units"] for v in c["weights"].values())
    out["ranks_equal"] = all(v["ranks_equal"] for v in c["weights"].values())
    return out


def p17g_check(ranks: list, errors: list, ref: dict) -> dict:
    """17g: each rank's fine-tuning phases against one process's (Q-hat
    and losses within 1e-5 relative, the smoke backward loss within 1e-3,
    metrics within 1e-3 relative or a smoke rate within one sample, weights
    within 2.5 lr and equal on every rank), Burgers and tokamak captured
    against eager (bit for bit, the step graphs replayed, the eager arm
    without graphs), smoke's K1 launches (255 per rank per evaluation).
    Every failed check is listed in `errors`."""
    res = {}

    def need(ok: bool, what: str) -> None:
        if not ok:
            errors.append(what)

    def f32_tol(m, v):  # 13(d), 17e
        return 1e-3 * abs(v) + 1e-9

    def smoke_tol(m, v):  # 13(d): a rate may move by one sample
        return 100 / P13_SMOKE_SIMS + 1e-9 if "percentage" in m else 1e-3 * abs(v) + 1e-9

    steps = {"gb": {"post": "chunk", "infft": "infft"},
             "gt": {"weighted": "weighted", "backward": "backward"}}
    for part, name in (("gb", "17g-b Burgers"), ("gt", "17g-t tokamak")):
        one = ref[part]["cmp"]
        for r, g in enumerate(gr.get(part) for gr in ranks):
            if g is None:
                errors.append(f"{name}: rank {r} has no result")
                continue
            try:
                err = _p17g_against(g["cmp"], one, dict.fromkeys(steps[part], 1e-5), f32_tol)
            except AssertionError as e:
                errors.append(f"{name} rank {r}: records differ in shape ({e})")
                continue
            b = g["bitwise"]
            log(f"{name} rank {r} ({g['route']}): against one process, errors over their "
                f"tolerances {json.dumps(err)}; bf16 captured against eager: Q differs at "
                f"{b['q']}, records at {b['hist']}, weights and EMA equal {b['weights']}; "
                f"graphs {json.dumps(b['graphs'])} (eager {json.dumps(b['eager_graphs'])}); "
                f"losses {json.dumps(b['losses'])}; s compare {g['cmp_s']:.1f} (one process "
                f"{ref[part]['cmp_s']:.1f}), eager {b['eager_s']:.1f}, captured "
                f"{b['captured_s']:.1f}; peak {b['peak_gb']:.2f} GB bf16, "
                f"{g['cmp']['peak_gb']:.2f} GB float32 (one process {one['peak_gb']:.2f})")
            need(max(err["q"], err["loss"], err["metrics"]) <= 1 and err["lr_units"] <= 2.5
                 and err["ranks_equal"], f"{name} rank {r}: against one process {err}")
            need(not b["q"] and not b["hist"] and b["weights"],
                 f"{name} rank {r}: captured differs from eager {b}")
            need(all(b["graphs"][k].get(kind, 0) > 0 for k, kind in steps[part].items())
                 and not any(v for gr_ in b["eager_graphs"].values() for v in gr_.values()),
                 f"{name} rank {r}: graphs {b['graphs']} eager {b['eager_graphs']}")
            need(all(any(v for v in ls) for ls in b["losses"].values()),
                 f"{name} rank {r}: a phase had no loss {b['losses']}")
        if all(gr.get(part) for gr in ranks):
            res[part] = dict(
                seconds=[gr[part]["cmp_s"] + gr[part]["bitwise_s"] for gr in ranks],
                one_process_s=ref[part]["cmp_s"],
                peak_gb=[max(gr[part]["cmp"]["peak_gb"], gr[part]["bitwise"]["peak_gb"])
                         for gr in ranks], one_process_peak_gb=one["peak_gb"],
                graphs=ranks[0][part]["bitwise"]["graphs"])

    one = ref["gs"]
    for part, label in (("gs", "dp 4"), ("gs2", "dp 2 x sp 2")):
        for r, g in enumerate(gr.get(part) for gr in ranks):
            if g is None:
                errors.append(f"17g-s smoke {label}: rank {r} has no result")
                continue
            try:
                err = _p17g_against(g, one, P17G_S_LOSS_TOL, smoke_tol)
            except AssertionError as e:
                errors.append(f"17g-s smoke {label} rank {r}: records differ in shape ({e})")
                continue
            k1 = {k: g[k]["k1"] for k in ("weighted", "backward")}
            log(f"17g-s smoke {label} rank {r} ({g['route']}): against one process, errors "
                f"over their tolerances {json.dumps(err)}; K1 {json.dumps(k1)} (one process "
                f"{json.dumps({k: one[k]['k1'] for k in k1})}); Q {g['weighted']['q']:.6g} / "
                f"{g['backward']['q']:.6g} (one process {one['weighted']['q']:.6g} / "
                f"{one['backward']['q']:.6g}); s {json.dumps({k: round(g[k]['seconds'], 1) for k in k1})} "
                f"(one process {json.dumps({k: round(one[k]['seconds'], 1) for k in k1})}); peak "
                f"{g['peak_gb']:.2f} GB (one process {one['peak_gb']:.2f})")
            need(max(err["q"], err["loss"], err["metrics"]) <= 1 and err["lr_units"] <= 2.5
                 and err["ranks_equal"], f"17g-s smoke {label} rank {r}: {err}")
            need(all(v == SOLVER_STEPS for v in k1.values()),
                 f"17g-s smoke {label} rank {r}: K1 {k1}")
        if all(gr.get(part) for gr in ranks):
            res[part] = dict(k1_per_rank=[sum(gr[part][k]["k1"] for k in ("weighted", "backward"))
                                          for gr in ranks],
                             seconds=[gr[part]["seconds"] for gr in ranks],
                             one_process_s=one["seconds"],
                             peak_gb=[gr[part]["peak_gb"] for gr in ranks],
                             one_process_peak_gb=one["peak_gb"])
    return res


def phase_p17g_cli(errors: list) -> dict:
    """17g-f: the fine-tuning phases through the command line on four
    torchrun ranks. `burgers posttrain --resume --steps 2 --ddim-steps 5`
    from 17f's torchrun pretrain checkpoint (five epochs, each saved by
    rank 0), then the same command again once the last epoch's state is
    set aside: it must log that it resumed after epoch 3 and end on the
    uninterrupted run's state bit for bit (weights, Adam moments, EMA,
    Q-hat); `tokamak infft` from a checkpoint of 17e's seeded weights
    written here first. Each exits 0 and logs its NCCL group; a failure is
    added to `errors` and the next command still runs."""
    from safediffcon_torch.utils.checkpoint import save_finetuned

    cli = P17_DIR / "cli"
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                f"--nproc_per_node={P17_CARDS}", "-m", "safediffcon_torch.cli.main"]
    group = f"rank 0 of {P17_CARDS} in the nccl process group"
    out, res = cli / "b_torchrun", {}
    state = out / "burgers-posttrain-state"
    post = torchrun + ["burgers", "posttrain", "--data", str(cli / "burgers" / "burgers.npz"),
                       "--out", str(out), "--steps", "2", "--ddim-steps", str(P17G_DDIM),
                       "--resume"]
    try:
        s_full, text = p17_cli(post, "b_posttrain")
        last = max(int(p.stem.split("-")[1]) for p in state.glob("ckpt-*.pt"))
        full = P17_DIR / "b_posttrain_full.pt"
        (state / f"ckpt-{last}.pt").rename(full)
        s_resume, resumed = p17_cli(post, "b_posttrain_resume")
        mark = f"resumed phase state after epoch {last - 1} from {state}"
        a = torch.load(full, weights_only=True)
        b = torch.load(state / f"ckpt-{last}.pt", weights_only=True)

        def same(x, y) -> bool:
            if isinstance(x, dict):
                return x.keys() == y.keys() and all(same(x[k], y[k]) for k in x)
            if isinstance(x, (list, tuple)):
                return len(x) == len(y) and all(same(a, b) for a, b in zip(x, y))
            if isinstance(x, torch.Tensor):
                return torch.equal(x, y)
            return x == y

        equal = same(a, b)
        del a, b
        missing = [m for m, t in ((group, text), (group, resumed), (mark, resumed))
                   if m not in t]
        log(f"17g-f torchrun x{P17_CARDS} burgers posttrain --resume: rc 0 in {s_full:.1f} s, "
            f"{last + 1} epochs; again after setting epoch {last}'s state aside: rc 0 in "
            f"{s_resume:.1f} s, its final state equal to the uninterrupted run's {equal}; "
            f"missing from the logs: {missing}")
        if not equal or missing:
            errors.append(f"17g-f burgers posttrain --resume: equal {equal}, missing {missing}")
        res["burgers_posttrain"] = dict(seconds=s_full, resume_s=s_resume, epochs=last + 1,
                                        resume_equal=equal)
    except Exception as e:  # a failed command or check; the next command still runs
        errors.append(f"17g-f burgers posttrain: {type(e).__name__}: {e}")
    t_out = cli / "t_infft"
    _, _, _, _, init = _p17_task("tokamak")
    save_finetuned(str(t_out / "tokamak-pretrain"), init, 0.0)
    try:
        seconds, text = p17_cli(torchrun + ["tokamak", "infft", "--data",
                                            str(P17_DIR / "tokamak.npz"), "--out", str(t_out)],
                                "t_infft")
        results = json.loads((t_out / "tokamak_infft_results.json").read_text())
        log(f"17g-f torchrun x{P17_CARDS} tokamak infft: rc 0 in {seconds:.1f} s, "
            f"{len(results)} epochs, Q-hat {[r['quantile'] for r in results]}; group logged "
            f"{group in text}")
        if group not in text:
            errors.append("17g-f tokamak infft: the log lacks its NCCL group")
        res["tokamak_infft"] = dict(seconds=seconds, epochs=len(results))
    except Exception as e:
        errors.append(f"17g-f tokamak infft: {type(e).__name__}: {e}")
    return res


def cards_main(n_cards: int) -> int:
    """`python3 chip_smoke.py --cards 4`: phase 2's build, then phase 17."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards != P17_CARDS or count != n_cards:
        print(f"chip_smoke --cards {n_cards}: needs exactly {P17_CARDS} visible CUDA cards and "
              f"--cards {P17_CARDS}; {count} visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from safediffcon_torch.ops import build
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.ops import pressure_cg as K
    from safediffcon_torch.solvers import smoke as S
    import safediffcon_torch.tasks.burgers as burgers
    import safediffcon_torch.tasks.smoke as smoke
    import safediffcon_torch.tasks.tokamak as tokamak

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {count}; nvidia-smi:\n{card}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True).stdout
    log(f"nvidia-smi topo -m:\n{topo}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nccl "
        f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    libs = build.build_all(["pressure_cg", "conv3d_wgmma", "conv3d_simt"])
    log(f"phase build: {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")
    laps = {}

    def lap(name):
        torch.cuda.synchronize()
        laps[name] = time.perf_counter() - t_start - sum(laps.values())

    shutil.rmtree(P17_DIR, ignore_errors=True)
    _p17_data(burgers, tokamak, smoke)
    lap("data")
    kernels = phase_p17_kernels(K, C, S)
    lap("17b")

    # one process on card 0: phase 13's references and 17e's
    ref = {}
    with tf32_flag(False):
        for name in ("b", "c", "d"):
            ref[name] = P13_PARTS[name]()
            torch.cuda.empty_cache()
    ref["eb"] = p17_task("burgers", one_process=True)
    ref["et"] = p17_task("tokamak", one_process=True)
    torch.cuda.empty_cache()
    lap("one process")
    # 17g's: each phase's final weights saved for the ranks
    for part, fn in (("gb", p17g_burgers), ("gt", p17g_tokamak), ("gs", p17g_smoke)):
        ref[part] = fn(one_process=True)
        torch.cuda.empty_cache()
    lap("one process 17g")

    ranks, errors = p13_spawn(P17_RANK_PARTS, P17_CARDS, "nccl")
    lap("ranks")
    res = p17_check(ranks, errors, ref)
    res["g"] = p17g_check(ranks, errors, ref)
    res["f"] = phase_p17_cli(errors)
    lap("17f")
    res["gf"] = phase_p17g_cli(errors)
    lap("17g-f")
    log(f"phase 17 seconds {json.dumps(laps)}; total {time.perf_counter() - t_start:.1f} s")
    if errors:
        raise AssertionError("phase 17: " + "\n".join(errors))

    k1_launches = {f"17b cuda:{c['card']} B = {c['batch']}": c["launches"] for c in kernels["k1"]}
    k1_launches["17c DP 4 serving, per rank"] = res["d"]["k1_per_rank"]
    k1_launches["17g-s smoke run_inference (post-training + backward), DP 4, per rank"] = (
        res["g"]["gs"]["k1_per_rank"])
    k1_launches["17g-s the same, DP 2 x SP 2, per rank"] = res["g"]["gs2"]["k1_per_rank"]
    k2_launches = {f"17b cuda:{c['card']}": c["launches"] for c in kernels["k2"]}
    k2_launches.update({"17c DP 4 pretrain, per rank (3xTF32)": res["b"]["k2_per_rank"],
                        "17d SP 4, per rank": res["c"]["k2_per_rank"],
                        "17d DP 2 x SP 2, per rank": res["c2"]["k2_per_rank"],
                        "17f smoke --sp 2, per rank": res["f"]["smoke_sp2"]["k2_modes"]})
    main_k1 = sum(res["d"]["k1_per_rank"]) + sum(sum(res["g"][p]["k1_per_rank"])
                                                  for p in ("gs", "gs2"))
    main_k2 = (sum(res["b"]["k2_per_rank"]) + sum(res["f"]["smoke_sp2"]["k2_per_rank"])
               + sum(sum(d.values()) for p in ("c", "c2") for d in res[p]["k2_per_rank"]))
    k1t, k2t = kernels["k1_time"], kernels["k2_time"]
    print(json.dumps({"kernels": [
        dict(name="pressure_cg", route="cuda", source="safediffcon_torch/csrc/pressure_cg.cu",
             replaces="safediffcon_tpu/ops/pressure_cg.py:42", launches=main_k1,
             main_path_launches=k1_launches,
             max_abs_err=max(c["max_diff"] for c in kernels["k1"]),
             ms=k1t["ms"], plain_ms=k1t["plain_ms"], bound_ms=k1t["bound_ms"],
             bound_by=k1t["bound_by"], library_ms=None, timed_on=f"cuda:{k1t['card']}"),
        dict(name="conv3d_fused", route="cuda", source="safediffcon_torch/csrc/conv3d_wgmma.cu",
             replaces="safediffcon_tpu/ops/conv3d_mxu.py:46", launches=main_k2,
             main_path_launches=k2_launches,
             max_abs_err=max(c["tf32_max_diff"] for c in kernels["k2"]),
             ms=k2t["ms"], plain_ms=k2t["plain_ms"], bound_ms=k2t["bound_ms"],
             bound_by=k2t["bound_by"], library_ms=k2t["library_ms"],
             timed_on=f"cuda:{k2t['card']}")]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def serving_graphs_only() -> int:
    """`python3 chip_smoke.py --serving-graphs`: B2's and T2's data, then
    phase 16 alone at DDIM 200 (the configs' depth; the whole run takes
    S_DDIM), with S_EXTENDED."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import safediffcon_torch.tasks.burgers as burgers
    import safediffcon_torch.tasks.tokamak as tokamak

    global S_EXTENDED, S_POST_CHUNKS
    S_EXTENDED, S_POST_CHUNKS = True, 4
    log(f"device: {card_line()}")
    t0 = time.perf_counter()
    b_data, _ = phase_burgers_datagen(burgers)
    t_data, _ = phase_tokamak_datagen(tokamak)
    phase_serving_graphs(burgers, tokamak, b_data, t_data, ddim=200)
    log(f"phase 16 at DDIM 200 with its data in {time.perf_counter() - t0:.1f} s")
    print(card_line(), flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from safediffcon_torch.ops import build
    from safediffcon_torch.ops import conv3d_mxu as C
    from safediffcon_torch.ops import pressure_cg as K
    from safediffcon_torch.solvers import kstar
    from safediffcon_torch.solvers import smoke as S
    import safediffcon_torch.tasks.burgers as burgers
    import safediffcon_torch.tasks.smoke as smoke
    import safediffcon_torch.tasks.tokamak as tokamak

    card = card_line()
    log(f"device: {card}; {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    libs = build.build_all(["pressure_cg", "conv3d_wgmma", "conv3d_simt"])
    log(f"phase build: {', '.join(str(p.relative_to(ROOT)) for p in libs)} in "
        f"{time.perf_counter() - t0:.2f} s")

    masks, cases, main_case, k1_cluster = phase_kernel_vs_plain(K, S)
    phase_gradient(K, S, masks)
    data, launches, times = phase_serving(K, smoke)
    phase_small_input_agreement(K, smoke, data[2])
    log(f"phase times {json.dumps(times, sort_keys=True)}; total "
        f"{time.perf_counter() - t_start:.1f} s")

    conv_cases, simt_case = phase_conv_kernel_vs_plain(C)
    phase_small_pretrain_agreement(C, smoke, data[0])
    ema, conv_launches, train_times = phase_pretrain(C, smoke, data[0])
    ft_times = phase_finetune(K, smoke, data, ema)
    log(f"training phase times {json.dumps(dict(train_times, **ft_times), sort_keys=True)}; "
        f"total {time.perf_counter() - t_start:.1f} s")

    # phase 10: UNet3D in bf16 (the main path of K2's bf16 mode) and "save_heavy"
    t_bf16 = time.perf_counter()
    bf16 = dict(agreement=phase_smoke_bf16_agreement(C, smoke, data[0]),
                training=phase_smoke_bf16_training(C, smoke, data[0]),
                sampling=phase_smoke_bf16_sampling(smoke, data[2]))
    bf16_launches = bf16["training"]["bf16_full"]["k2_modes"]["bf16"]
    log(f"phase 10 in {time.perf_counter() - t_bf16:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # phase 11: smoke serving with DPM-Solver++(2M), K1 on its main path again
    t_dpm = time.perf_counter()
    dpm_launches, dpm_times = phase_smoke_dpm_serving(K, C, smoke, data)
    log(f"phase 11 in {time.perf_counter() - t_dpm:.1f} s; total "
        f"{time.perf_counter() - t_start:.1f} s")

    # Burgers: no kernel of the TPU package lies on its path; K1 and K2 must
    # stay idle through it
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t_burgers = time.perf_counter()
    b_times = dict(solver=phase_burgers_solver(burgers))
    b_data, b_times["datagen_s"] = phase_burgers_datagen(burgers)
    phase_burgers_small_agreement(burgers, b_data)
    b_times["serving"] = phase_burgers_serving(burgers, b_data)
    b_ema, b_times["pretrain"] = phase_burgers_pretrain(burgers, b_data)
    b_times.update(phase_burgers_finetune(burgers, b_data, b_ema))
    t_b7 = time.perf_counter()
    b_times["b7"] = phase_burgers_b7(burgers, b_data, b_ema)
    log(f"B7 in {time.perf_counter() - t_b7:.1f} s")
    idle = (K.pressure_cg_cuda.launches, k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    log(f"Burgers phases B1-B7 in {time.perf_counter() - t_burgers:.1f} s; K1 / K2 / K2 SIMT "
        f"launches during them {idle}; total {time.perf_counter() - t_start:.1f} s")
    if any(idle):
        raise AssertionError(f"a TPU-kernel counterpart ran on the Burgers path: {idle}")

    # Tokamak: no kernel of the TPU package lies on its path either
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t_tokamak = time.perf_counter()
    t_times = dict(solver=phase_tokamak_solver(kstar))
    t_data, t_times["datagen"] = phase_tokamak_datagen(tokamak)
    phase_tokamak_small_agreement(tokamak, t_data)
    t_times["serving"] = phase_tokamak_serving(tokamak, t_data)
    t_ema, t_times["pretrain"] = phase_tokamak_pretrain(tokamak, t_data)
    t_times.update(phase_tokamak_finetune(tokamak, t_data, t_ema))
    t_times["dpm"] = phase_tokamak_dpm(tokamak, t_data, t_ema)
    idle = (K.pressure_cg_cuda.launches, k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    log(f"Tokamak phases T1-T7 in {time.perf_counter() - t_tokamak:.1f} s; K1 / K2 / K2 SIMT "
        f"launches during them {idle}; total {time.perf_counter() - t_start:.1f} s")
    if any(idle):
        raise AssertionError(f"a TPU-kernel counterpart ran on the tokamak path: {idle}")

    # phase 12: the command line, K1 and K2 on its smoke path
    t_cli = time.perf_counter()
    cli = dict(subprocess=phase_cli_subprocess())
    cli["smoke"] = phase_cli_smoke(K, C, smoke, train_times)
    cli["burgers_tokamak"] = phase_cli_burgers_tokamak(K, C)
    cli_launches = cli["smoke"]["launches"]
    log(f"phase 12 in {time.perf_counter() - t_cli:.1f} s; launches {json.dumps(cli_launches)}; "
        f"total {time.perf_counter() - t_start:.1f} s")

    # phase 13: data parallelism and frame-axis sequence parallelism
    t_p13 = time.perf_counter()
    p13 = phase_p13(C, smoke, data[0], data[1], data[2], b_data, t_data)
    log(f"phase 13 in {time.perf_counter() - t_p13:.1f} s (ranks {p13['spawn_s']:.1f} s); "
        f"total {time.perf_counter() - t_start:.1f} s")

    # phase 14: the round-1 validation runs at --scale tiny
    p14 = phase_round1(K, C)
    p14_smoke = p14["runs"]["smoke"]["launches"]
    p14_sp = p14["runs"]["smoke_posttrain"]["launches"]
    # the other recipes must launch neither kernel (phase_round1 checks it)
    p14_idle = {k: v["launches"] for k, v in p14["runs"].items() if not k.startswith("smoke")}
    log(f"phase 14 in {p14['seconds']:.1f} s; total {time.perf_counter() - t_start:.1f} s")

    # phase 15: the Burgers and tokamak training chunk as one captured CUDA
    # graph against the eager chunk; no kernel of the TPU package on it
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t_p15 = time.perf_counter()
    phase_train_graphs(burgers, tokamak, b_data, t_data)
    idle = (K.pressure_cg_cuda.launches, k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    log(f"phase 15 in {time.perf_counter() - t_p15:.1f} s; K1 / K2 / K2 SIMT launches during "
        f"it {idle}; total {time.perf_counter() - t_start:.1f} s")
    if any(idle):
        raise AssertionError(f"a TPU-kernel counterpart ran in phase 15: {idle}")

    # phase 16: the Burgers and tokamak serving and fine-tuning calls as
    # captured CUDA graphs against the eager calls; no kernel of the TPU
    # package on them
    K.pressure_cg_cuda.launches = 0
    zero_k2_counts(C)
    t_p16 = time.perf_counter()
    phase_serving_graphs(burgers, tokamak, b_data, t_data)
    idle = (K.pressure_cg_cuda.launches, k2_launches(C), C.conv3d_fused_simt_cuda.launches)
    log(f"phase 16 in {time.perf_counter() - t_p16:.1f} s; K1 / K2 / K2 SIMT launches during "
        f"it {idle}; total {time.perf_counter() - t_start:.1f} s")
    if any(idle):
        raise AssertionError(f"a TPU-kernel counterpart ran in phase 16: {idle}")

    kernels = [dict(
        name="pressure_cg", route="cuda", source="safediffcon_torch/csrc/pressure_cg.cu",
        replaces="safediffcon_tpu/ops/pressure_cg.py:42",
        also_replaces="safediffcon_tpu/ops/pressure_cg.py:119",
        launches=(launches + dpm_launches + cli_launches["k1_eval"]
                  + sum(p13["d"]["k1_per_rank"]) + p14_smoke["k1"] + p14_sp["k1"]),
        main_path_launches={"phase 4 DDIM serving": launches,
                            "phase 11 DPM serving": dpm_launches,
                            "phase 12 smoke eval --checkpoints": cli_launches["k1_eval"],
                            "phase 13(d) DP serving, per rank": p13["d"]["k1_per_rank"],
                            "phase 14 round-1 smoke recipe, tiny (datagen + evaluate)":
                                p14_smoke["k1"],
                            "phase 14 smoke posttrain + backward recipe, tiny (datagen + "
                            "3 evaluations)": p14_sp["k1"],
                            "phase 14 Burgers and tokamak recipes, tiny (required 0)":
                                {k: v["k1"] for k, v in p14_idle.items()}},
        max_abs_err=max(c["max_diff"] for c in cases),
        ms=main_case["kernel_ms"], plain_ms=main_case["plain_ms"],
        bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"], library_ms=None,
        us_per_iter=main_case["us_per_iter"], cluster=k1_cluster,
        shape=dict(batch=N_TEST, cells=[CELLS, CELLS], accuracy=1e-8, max_iter=500, check_every=1),
        cases=cases)]
    conv_main = next(c for c in conv_cases if (c["h"], c["cin"], c["cout"], c["dtype"])
                     == (64, 64, 64, "float32"))
    bf16_main = next(c for c in conv_cases if (c["h"], c["cin"], c["cout"], c["dtype"])
                     == (64, 64, 64, "bfloat16"))
    f32_cases = [c for c in conv_cases if c["dtype"] == "float32"]
    modes = {m: dict(ms=conv_main[m]["kernel_ms"], bound_ms=conv_main[m]["bound_ms"],
                     bound_by=conv_main[m]["bound_by"], tflops=conv_main[m]["tflops"],
                     max_rel_err=max(c[m]["max_diff"] / c["max_abs"] for c in f32_cases))
             for m in ("tf32", "3xtf32")}
    modes["bf16"] = dict(ms=bf16_main["kernel_ms"], bound_ms=bf16_main["bound_ms"],
                         bound_by=bf16_main["bound_by"], tflops=bf16_main["tflops"],
                         library_ms=bf16_main["library_ms"],
                         max_rel_err=max(c[f"{k}max_diff"] / c[f"{k}max_abs"]
                                         for c in conv_cases if c["dtype"] == "bfloat16"
                                         for k in ("", "dx_", "dw_")))
    modes["3xtf32"]["library_fp32_ms"] = conv_main["library_fp32_ms"]
    kernels.append(dict(
        name="conv3d_fused", route="cuda", source="safediffcon_torch/csrc/conv3d_wgmma.cu",
        replaces="safediffcon_tpu/ops/conv3d_mxu.py:46",
        launches=(conv_launches + bf16_launches + cli_launches["k2_cli_pretrain"]
                  + cli_launches["k2_pool_pretrain"] + p13["a"]["k2"]
                  + sum(p13["b"]["k2_per_rank"]) + sum(p13["c"]["k2_per_rank"])
                  + sum(p14_smoke["k2"].values()) + sum(p14_sp["k2"].values())),
        main_path_modes={train_times["k2_mode"]: conv_launches + cli_launches["k2_cli_pretrain"]
                         + cli_launches["k2_pool_pretrain"],
                         "bf16": (bf16_launches + p14_smoke["k2"]["bf16"]
                                  + p14_sp["k2"]["bf16"])},
        main_path_launches={"phase 8 pretrain": conv_launches, "phase 10b bf16": bf16_launches,
                            "phase 12 smoke pretrain --steps-per-call 2":
                                cli_launches["k2_cli_pretrain"],
                            "phase 12 pretrain with a device pool":
                                cli_launches["k2_pool_pretrain"],
                            "phase 13(a) torchrun pretrain, one NCCL rank": p13["a"]["k2"],
                            "phase 13(b) DP pretrain, per rank (3xTF32)":
                                p13["b"]["k2_per_rank"],
                            "phase 13(c) SP forward + backward, per rank (3xTF32)":
                                p13["c"]["k2_per_rank"],
                            "phase 14 round-1 smoke recipe, tiny (pretrain)": p14_smoke["k2"],
                            "phase 14 smoke posttrain + backward recipe, tiny (pretrain)":
                                p14_sp["k2"],
                            "phase 14 Burgers and tokamak recipes, tiny (required 0)":
                                {k: sum(v["k2"].values()) for k, v in p14_idle.items()}},
        max_abs_err=max(c["max_diff"] for c in f32_cases),
        ms=conv_main["kernel_ms"], plain_ms=conv_main["plain_ms"],
        bound_ms=conv_main["bound_ms"], bound_by=conv_main["bound_by"],
        library_ms=conv_main["library_ms"], library_fp32_ms=conv_main["library_fp32_ms"],
        shape=dict(batch=K2_BATCH, frames=FRAMES, h=64, w=64, cin=64, cout=64, dtype="float32"),
        modes=modes, cases=conv_cases))
    kernels.append(dict(
        name="conv3d_fused_simt", route="cuda", source="safediffcon_torch/csrc/conv3d_simt.cu",
        replaces="safediffcon_tpu/ops/conv3d_mxu.py:46",
        launches=train_times["simt_launches"] + p14_smoke["k2_simt"] + p14_sp["k2_simt"],
        max_abs_err=simt_case["max_diff"],
        ms=simt_case["kernel_ms"], plain_ms=simt_case["plain_ms"],
        bound_ms=simt_case["bound_ms"], bound_by=simt_case["bound_by"],
        library_ms=simt_case["library_ms"],
        shape=dict(batch=K2_BATCH, frames=FRAMES, h=K2_SIMT[0], w=K2_SIMT[0], cin=K2_SIMT[1],
                   cout=K2_SIMT[2], dtype="float32")))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cli-rank"]:  # a rank of phase 13(a)'s torchrun
        sys.exit(cli_rank(sys.argv[2:]))
    if sys.argv[1:2] == ["--serving-graphs"]:
        sys.exit(serving_graphs_only())
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_main(int(sys.argv[2]) if sys.argv[2:3] else 0))
    sys.exit(main())
