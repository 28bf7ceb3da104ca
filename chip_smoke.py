#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lunaris_orion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --grads N [FEATURE_DIM]  # phase 9's spread (below)
    python3 chip_smoke.py --k5-f32 N # K5's f32 time alone, N times
    python3 chip_smoke.py --profiler-loss N  # torch.profiler's lost records
    python3 chip_smoke.py --step-noise N  # phase 18's f32 step against itself

Phases, each of which raises on failure (exit code 1):
  1. probe    torch / CUDA versions, the card, nvidia-smi, nvcc, triton;
  2. build    compile the hand-written kernels from csrc/ with nvcc; no
              tensor-core instance spills and ptxas serialises no warpgroup
              body's wgmma (C7512, C7514, C7515, C7518, C7520; the f32
              ones at d 16, 32, 48 and 64, their pre-pass, the narrow ones
              at d 16 and 32 and the window ones, bf16 and f32, among them:
              registers, spills and shared bytes logged); the inner loop
              of each bf16 d 16 and
              d 32 K2 instance (the narrow warpgroup bodies and the
              mma.sync ones they replaced; the window bodies, the f32 ones
              too) counted by instruction class
              from its SASS, per 32 scores (cuobjdump runs under the
              phases that follow; its checks come before the kernels'
              line);
  3. K1       GroupNorm+Mish kernel against its plain version at the four
              decoder shapes, batch 8, and at [128,128,128,64], f32 and
              bf16, bit-equal to its earlier three-launch form with the
              exact mish and the same bits on two runs, timed against the
              earlier form in turns (earlier, new, new, earlier); the apply
              alone at [128,128,128,64] with the shipped mish, the exact
              chain and none (the probe), in turns; and on the inputs of
              the 16 sites of a batch-16 VAE training forward (the train
              step's own), f32 and bf16; torch.var_mean over the grouped
              view at [128,128,128,64], pass 1's library call;
  4. K2       flash-attention forward kernels against the plain version at
              the teacher's shape (B 8 and the train step's B 16, H 8,
              N 16384, d 16) with dropout 0 and 0.1, f32 and bf16 (tensor
              cores; f32 in three TF32 passes), and at d 8/32/48/64 and a
              ragged N; bf16 element by element against the plain version's
              online form; the tensor-core kernels at d 16, and f32's at
              d 32, timed against the CUDA-core ones they replaced
              (earlier, new, new, earlier; the new must be faster); d 32
              (feature_dim 256) at B 8, N 16384 timed beside
              F.scaled_dot_product_attention; bf16 at d 48 and 64 (the
              recipes' head sizes: the warpgroup body, wgmma fed by TMA)
              at a ragged N, on a q shard at q_offset 2048 and at B 8,
              N 16384 with dropout 0 and 0.1, timed in turns against the
              mma.sync body it replaced (held element by element against
              the online form at its own key tile first; the new must be
              faster), beside SDPA, the plain version and the bound; bf16
              at d 16 (the default width) on the narrow warpgroup body, at
              B 8 and 16 with dropout 0 and 0.1, timed the same way against
              mma.sync beside both floors (the tensor cores and the
              special-function units); the narrow body at the short rows
              (the windowed fold, a CP q shard at q_offset 8192) against
              the online form and in turns with mma.sync, which the rule
              keeps for the fold; bf16 at d 32 (the low-end recipe) on the
              narrow body the same way: a ragged N 2000 and 2100, B 8 and
              16 with dropout 0 and 0.1 in turns with mma.sync (the new
              must be faster), the fold, a CP q shard and N 512 to 4096 in
              turns (what NARROW_MIN_ROWS[32] follows); f32 at d 16 on its
              warpgroup body (three
              TF32 passes on wgmma): its pre-pass bit for bit against its
              plain twin and timed beside its bound, then at B 8 and 16
              with dropout 0 and 0.1, a ragged N, a CP q shard at q_offset
              8192 and the short rows N 256 to 4096, both it and the
              mma.sync body it replaced against the plain version at f32's
              bars, then in turns (mma, wgmma, wgmma, mma; at N 16384 the
              new must be faster) beside SDPA, the plain version, the
              three-pass bound and the special-function floor, and its
              dropout mask position by position; the same at d 32, 48 and
              64 (the low-end, mid-range and H100-tier widths; at d 32 B 8
              alone), whose short rows (SHORT_ROWS_TF32) set
              TF32_WGMMA_MIN_ROWS[d];
  5. slice    `lunaris_orion_tpu_torch.cli.generate` at the full default
              width (128 px, 4 experts x 3 blocks, N = 16384) from a seeded
              random checkpoint, f32 and --bf16; both kernels' launch
              counts must be above 0; decode+score sprites/s, and one call
              under torch.profiler: device time by kernel, idle share; every
              K2 call on the narrow body in bf16 and on the f32 warpgroup
              body in f32, by the wrappers' counts and by name;
  6. context  64 px configs (N = 4096) through the port on the CPU (plain
              versions) and on the card (kernels) from one checkpoint and
              one z, TF32 off, at feature_dim 64 (d 8), 128 (d 16) and 256
              (d 32; both with every K2 call on the f32 warpgroup body),
              the CPU's decodes in a process of their own under phase 4:
              decode within
              1/255, quality within 1e-3;
  7. K2 bwd   both backward variants (fused = dk/dv with dq; split = dk/dv +
              dq kernels) against the plain backward at B 2, H 8, N 16384,
              d 16, dropout 0 and 0.1, f32 and bf16 (the fused one on the
              tensor cores in both, f32 in three TF32 passes; split on the
              tensor cores in bf16), at d 8/32/48/64, at a ragged
              rectangular 2000 x 300 and 300 x 2000, with a q shard at
              q_offset, and at the teacher's training shape (B 16, H 8,
              N 16384, d 16, dropout 0.1), f32 and bf16, where it also times
              every kernel and the plain version; bf16 element by element;
              the tensor-core kernels (bf16: fused, dk/dv and dq; f32:
              fused, also at d 32) timed against the CUDA-core ones they
              replaced (the new must be faster), and the two variants
              against each other (each earlier, new, new, earlier) beside
              the backward of `F.scaled_dot_product_attention`; both
              variants at d 32, B 8, N 16384 beside it, and in turns at
              N 4096 at every head size (what `default_bwd` follows);
              bf16 at d 48 and 64 (the fused warpgroup body): ragged,
              a q shard; at B 2, N 16384 both variants and the CUDA-core
              fused kernel it replaced against the plain backward, the two
              fused kernels in turns (the new must be faster) beside the
              plain version's time, SDPA's backward and the bound; at B 16
              the fused kernel and the two variants in turns, beside SDPA's
              backward and the bound; bf16 at d 16 (the narrow fused
              warpgroup body): at B 2 the mma.sync fused kernel it replaced
              against the plain backward, the two in turns at B 2 (dropout
              0 and 0.1) and B 16 (0.1) beside the plain version, SDPA's
              backward and both floors, and at the short rows (the
              windowed fold, a CP q shard) the narrow kernel against the
              plain backward and in turns with mma.sync; the same at d 32
              (the low-end recipe: B 2, 8 and 16, a ragged N either side,
              the fold, a CP q shard, N 512 to 4096; at B 8 and 16 the
              narrow kernel must be faster; dk, dv and dbias the same bits
              on a second run) and its dropout mask position by position;
              f32 at d 16 (the
              fused warpgroup body, three TF32 passes on wgmma): at B 2
              with dropout 0 and 0.1, a ragged N and a CP q shard both it
              and the mma.sync fused kernel it replaced against the plain
              backward (dk, dv and dbias the same bits on a second run),
              then in turns at those shapes, at B 16 and at the short rows
              N 1024 to 4096 (at N 16384 the new must be faster), beside
              the plain version, SDPA's backward, the three-pass bound and
              the special-function floor, and its dropout mask position by
              position; the same at d 32 against mma.sync (B 8 in place of
              B 16, a ragged N 2100 and 2000, the short rows N 256, 1024 and
              2048 setting TF32_WGMMA_BWD_MIN_ROWS[32]) and at d 48 and 64
              against the CUDA-core fused kernel it replaced there (a
              ragged N 2100 and 2000; at B 16 the CUDA-core kernel one call
              a turn, over a second a call), the short rows N 256, 1024 and
              4096 in turns setting TF32_WGMMA_BWD_MIN_ROWS[48] and [64];
  8. K3       the MSE+KL kernel against its plain version and the plain
              version of its own order of summation at [16, 128, 128, 3],
              L = 256, f32 and bf16, the same bits on two calls, timed
              against its earlier form (one block a sample, then torch
              sums) in turns;
  9. grads    one `train_step` of a 64 px config (N = 4096; 4 heads, d 8,
              and d 16, 32, 48 and 64, whose K2 calls all take the f32
              warpgroup bodies; at d 32, 48 and 64 the card's step takes the
              CPU step's side of each LeakyReLU kink, `kink_sides`, every
              entry that differs within 1e-4 of its call's largest of zero,
              and the unsided step's worst gradient with the kernels and
              with the plain versions is logged, held to no bar; the CPU
              steps run in a process of their own, under phase 7's work on
              the card)
              on the CPU (plain versions) and on the card (kernels) from
              one state, one batch and one eps, dropout 0, TF32 off:
              gradients (1e-3
              of each tensor's largest; 2e-2 for the parameters of the
              teacher's conv -> BatchNorm blocks, `grad_ratios`), BatchNorm
              statistics and metrics agree, and every parameter that the
              losses reach gets a non-zero gradient on the card;
 10. train    `make_train_step` at the full default width (128 px, latent
              256, feature 128, 8 heads, 4 experts x 3 blocks, batch 16,
              accumulation 2, remat), seeded random init: 1 bf16 step with
              the non-default K2 backward, then 1 f32 and 1 bf16 step with
              the default, 1 bf16 step with the other variant, and 1 bf16
              step with the default and remat off (the trainer's plan on
              80 GB, phase 15's bare step); losses finite, both models'
              parameters changed, every kernel of the path launched; step
              time and sprites/s; the four warm steps run under
              torch.profiler: device time by kernel, idle share,
              and K1 at two kernels a call (pass 1 and the apply with the
              fold; no fold kernel), as in phase 5's profiled calls;
 11. K5       the GN-apply+Mish+conv3x3 kernel against its plain version at
              [2,32,32,64]->64, [2,64,64,32]->32, [2,32,32,128]->64 and
              [8,128,128,64]->64, f32 (CUDA-core body) and bf16 (tensor-core
              body), and in bf16 also at Cin 8, 24 and 40 with ragged H and
              W and at Cin 256 and 512; the CUDA-core body in bf16 once
              more; the same bits on a
              second run; then at the tool's [128,128,128,64]->64 bf16 both
              bodies, K1 and the alpha/beta entry (K1's pass 1 and fold),
              with times: the two bodies in turns (earlier, new, new,
              earlier), the fused path (alpha/beta entry + K5) against K1 +
              F.conv2d with the bias added three ways, in turns; plain;
              f32 (CUDA-core body) at [32,128,128,64]->64;
 12. stages   each of the five K2 stage kernels against its plain version
              at B 2 and the tool's B 8, H 8, N 16384, d 16, f32 and bf16
              (the tensor-core bodies; f32 three TF32 passes; bf16 the
              mma.sync body, which the narrow warpgroup body replaced as
              the default); "sum" bit-equal to that forward kernel at
              dropout 0; times at B 8 bf16;
 13. stats    the per-tile lane-sums kernel, and K1's pass 1 alone, against
              their plain versions at [128,128,128,32], [128,128,128,64],
              [128,64,64,128], bf16 and f32, tiles of 512 and 2048 rows;
              pass 1's partials the same bits on two runs; times of both,
              GB/s and share of bound, beside torch.var_mean over the
              grouped view (the library call of both);
 14. tools    `tools.attn_roofline`, `tools.gn_stats` and
              `tools.fusion_overlap` at their full default shapes; every
              kernel they reach launched;
 15. trainer  (run right after phase 10) `lunaris_orion_tpu_torch.cli.train`
              at the full default width, --mixed_precision, on an 80-sprite
              procedural 128 px corpus (64 train, 16 val): the memory plan
              picks remat and the batch, 2 epochs of 2 steps with per-step
              logs, comparison and prior grids and saves; losses finite,
              the files on disk, K1, the K2 forward, the fused K2 backward
              and K3 launched; a resume from the checkpoint directory whose
              restored state equals the saved file bit for bit (parameters,
              BatchNorm buffers, AdamW moments and step, baseline,
              generator) and that takes 2 more steps under torch.profiler
              (the loop's idle share); `generate --best --bf16` from that
              directory. One `[trainer]` line: the plan and its peak, the
              epochs' sprites/s beside phase 10's bare bf16 step of the
              same remat setting (the loop's cost),
              validation, checkpoint copy and write, and resume load ms;
 16. window   (run after 14) windowed attention, the evaluator and the training
              options at window 256: (a) `local_window_attention` (K2 over
              the windows folded into the heads) at B16 H8 N16384, f32 and
              bf16 at d16 and d32 (the window bodies `flash_fwd_window`
              and `flash_bwd_window`, f32 `flash_fwd_window_tf32` and
              `flash_bwd_window_tf32`, by their counters; the default
              where `window_default` says, by `body="window"` elsewhere),
              forward at
              dropout 0 and 0.1 and the default backward at 0.1 against
              the plain versions on the folded shape (phase 4's and 7's
              bars), the window bodies' masks position by position and
              their gradients the same bits on a second run, a call in 4
              batch chunks bit-equal to one call, times beside the global
              K2 at B16, the plain version, F.scaled_dot_product_attention
              on the folded shape and both floors (bytes or tensor cores;
              the special-function units), the window bodies in turns
              against the mma.sync ones they replaced; (b)
              `lunaris_orion_tpu_torch.cli.evaluate`
              at the full default width on 16 PNGs at 128 px, an 8-sprite
              shard and 2 PNGs at 120 px (the global fallback), global and
              --attn_window 256, f32 and --bf16: 26 scores, the fallback
              marked, K2 launched; one batch of 16 timed in each mode,
              the windowed ones under torch.profiler too (every K2 launch
              `flash_fwd_window`, f32 `flash_fwd_window_tf32`, by count
              and by name); at 64 px the card's windowed scores against
              the CPU's (1e-3); (c) the bf16 train step at 16 x 2, remat,
              window 256: a cold step, one under torch.profiler (its
              launches: every kernel of the path; every K2 launch on the
              window bodies, by count and by name), fuse_teacher against
              the unfused step in turns, one step with cached prompt
              embeddings and one with bf16_momentum; then the f32 step
              (mixed_precision off, the CLIs' default) the same way: a
              cold step and one under torch.profiler, every K2 forward on
              the f32 window body and every backward on the mma.sync one
              (`window_default`) by count and by name, no pre-pass;
              (d) `lunaris-train` with --attn_window 256
              --cached_prompt_embeddings --bf16_momentum on a 40-sprite
              corpus: one epoch, a resume whose restored state equals the
              saved file bit for bit, one more epoch; the table's refresh
              ms;
 17. serve    (run after 16) serving export, checkpoint conversion and
              dataset synthesis at the full default width: (a)
              `lunaris-convert-torch` to-port then to-torch, bit-equal to
              the input .pt; (b) "cuda" bundles (the programs call K1 and
              the K2 forward through their torch.library operators) in bf16
              (generate at batch 2 and 8, score at 8) and f32 (generate at
              8), a "plain" bf16 generate at 2: each program's export
              seconds and size (exported in a process of their own under
              phase 4); (c) the
              bundles loaded and run in a second
              process (`--serve`) that imports no model module, against
              eager: generate within 1/255 and 1e-3, score 1e-3, plain
              against cuda at batch 2 (K2's bf16 bar); (d) inside the
              loaded programs, K1's two kernels 4 times and the K2 forward
              12 times in a bf16 generate, the K2 forward 12 times in a
              score, by the wrappers' counts and by name in the profiler;
              (e) bundle against eager in turns (eager, bundle, bundle,
              eager): generate bf16 and f32, score bf16, batch 8; (g)
              `lunaris-synthesize-torch`: 50 procedural sprites that
              BatchLoader reads onto the card; (f) `pixelate_device` on
              the 16 sprites the bundles generated, card against CPU
              (the same on 16 procedural sprites, logged), and its ms.
 18. dist     (run after 17) the parallel layer: (a) the Trainer at
              `--mesh_shape 1 1`, bf16, full width, 2 steps (24 sprites)
              as a torchrun-style single rank with an NCCL process group
              and without one: parameters and BatchNorm statistics equal
              bit for bit (both with the split K2 backward and cuDNN's
              deterministic algorithms), the NCCL collectives counted; (b)
              two ranks on the one card over gloo (`_dist_rank`, spawned;
              gloo's collectives of CUDA tensors staged through the host)
              at the full default width against the single-process step
              on the same state and global batch, dropout 0.1,
              accumulation 1: DP (2, 1) at batch 4, CP (1, 2) allgather at
              4 (K2 launched on q shards, counted) and ring at 2, both
              with the FC pair split over the model axis, in f32
              with TF32 off at phase 9's bars, and DP (2, 1) and TP/EP
              (1, 2) in bf16 read beside the bf16 step's own noise
              (`DIST_CASES`); the two ranks' replicated gradients equal
              bit for bit; each rank's step s
              and peak memory; `allgather_attention` alone at B2 H8 N16384 d16 bf16
              dropout 0.1 against one K2 call (phases 4 and 7's bars; dk
              and dv, sums of two rounded partials, to one ulp of the
              largest), its ms beside the call's ("2 ranks over gloo on
              one card": not NCCL across cards); the K2 forward and
              default backward alone on one rank's CP shard (Nq 8192 x Nk
              16384), beside their bound and SDPA; (c) tensor and expert
              parallelism, two gloo ranks on the card (`_tp_ep_rank`) at
              the full default width, (1, 2), batch 4, f32, TF32 off,
              dropout 0.1: each rank's gradients (its part) against the
              single-process step's at phase 9's bars, the metrics at
              phase 9's bar, the replicated gradients, BatchNorm
              statistics and metrics bit-equal on both ranks, the
              gathered parameters and AdamW moments against the
              single-process step's, each rank's K2 launches half the
              single process's (2 of 4 experts) and K1's and K3's the
              same, each rank's step s, peak GiB and bytes of parameters
              and moments; a save at (1, 2) and its load by one process
              at (1, 1) bit-equal to the gathered state; the Trainer at
              --mesh_shape 1 2, bf16, one step and one validation batch
              at full width, its memory plan probing the split models on
              the card and its checkpoint gathered on the host; and the
              native batch gatherer built, byte-equal to the numpy gather
              and timed against it at batch 16 x 2.
 20. recipe   (run after 14) `docs/configs.md`'s H100 tier at full width
              (feature_dim 512 at 8 heads: head size 64; latent 512,
              embedding 256, batch 64 x 1, bf16; 128 px, 4 experts x 3
              blocks, N 16384), then its low-end tier (feature_dim 256:
              head size 32; latent 256, embedding 128, batch 16 x 4, bf16,
              vae_lr 1e-4, teacher_lr 5e-5), each from a seeded random
              init: the Trainer's memory
              plan on the card picks the batch and remat (logged), one
              warm-up and one profiled step of its train step, and one bf16
              decode+score at batch 8 through ImageGenerator, profiled;
              every K2 forward is `flash_fwd_wgmma` and every backward
              `flash_bwd_wgmma` at d 64, `flash_fwd_wgmma_narrow` and
              `flash_bwd_wgmma_narrow` at d 32 (by the wrappers' counts
              and by name), no
              CUDA-core K2 kernel runs, the losses and scores are finite;
              each profile holds a record of every launch the wrappers
              counted (K1's two kernels a call, K2's by name), or the call
              is profiled again, at most 3 sessions; then in f32, the CLIs'
              default precision (`run_recipe_f32`): an f32 decode+score at
              batch 8 through ImageGenerator from a seeded H100-tier
              checkpoint (d 64) and from a low-end one (d 32), and one f32
              train step at the mid-range tier's widths (docs/configs.md:
              feature_dim 384, d 48; latent 384, embedding 192; batch 8 x
              1, cut from the recipe's 32 x 2 for run time) and one at the
              low-end tier's (feature_dim 256, d 32; batch 16 x 1, cut from
              16 x 4) after a warm-up step, each profiled: every K2 forward
              on `flash_fwd_wgmma_tf32` and every backward on
              `flash_bwd_wgmma_tf32` at its head size (by the wrappers'
              counts and by name), their pre-pass once a forward and twice
              a backward, no `flash_fwd_tf32`, no `flash_bwd_fused_tf32`
              and no CUDA-core K2 kernel, finite losses and scores, device
              time and idle share;
 19. parity   (run last; its runs of (a) and (b), host-bound, in processes
              of their own beside (c)) the long parity runs
              of `lunaris_orion_tpu_torch.
              tools`, TF32 off for cuDNN and cuBLAS: (a) `parity_curves`,
              the VAE step, 300 x 16, deterministic and sampled; (b)
              `parity_hybrid`, the hybrid step at the hybrid_d16 preset
              (32 px, head size 16), f32, 200 x 8, deterministic global
              (K2 flash), deterministic window 256 and sampled; each held
              to its committed JAX curves (back-half divergence beside
              the deterministic and sampled bands of docs/parity_*.json:
              a deterministic run past its sampled band fails, a sampled
              run fails only on a value that is not finite), each
              deterministic run's first step against the same tool's
              first step on the CPU at phase 9's metric bar, each run in
              a spawned process of its own (they are host-bound); (c)
              `window_dynamics` at the full default width, bf16, batch 8,
              global and window 256, 20 steps each, in the main process
              while (a) and (b) run: finite, recon and KL
              at the last step within 2 % of each other. Each run's second
              step goes under torch.profiler: K1 two kernels a call, K3,
              and in (b) `flash_fwd_tf32` and `flash_bwd_fused_tf32` (the
              f32 window forward `flash_fwd_window_tf32` on its windowed
              run; in (c) the bf16 narrow bodies `flash_fwd_wgmma_narrow` and
              `flash_bwd_wgmma_narrow` on the global calls, the window
              bodies `flash_fwd_window` and `flash_bwd_window` on the
              windowed ones), by name and by the wrappers' counts.

Kernel times are medians of CUDA-event timings; `[time]` lines give each
phase's seconds. Each kernel's `bound_ms` is the larger of its bytes
(inputs read once, outputs written once) over 3.35 TB/s and its operations
over the peak of its input type (989 TFLOP/s bf16, 67 TFLOP/s f32 outside
the tensor cores), at the shape its `ms` was taken at; an f32 kernel on the
tensor cores does each product as three TF32 passes, so its `bound_ms` is
three times the operations over 495 TFLOP/s (`bound_ms_tf32x3`), beside
the same operations on the CUDA cores (`bound_ms_f32`); `library_ms` is one PyTorch call computing the same function
(`F.scaled_dot_product_attention` for K2; for K5 K1 followed by F.conv2d
and its bias, the fastest of three ways to add it; for the lane sums
torch.var_mean over the grouped view), timed here and used nowhere in the port. The entries of the
K2 forward and of the three K2 backward kernels carry the f32 reading under the plain keys and the bf16 reading under
`*_bf16` (`earlier_ms`, `earlier_ms_bf16`: the CUDA-core kernel on the
same inputs, in turns; `body`, `body_bf16`: the body the instance rule
gives; `turns_f32`: the f32 forward's [new, earlier] ms at each d 16 and
d 32 shape), and the head size 32 times at B 8 under `*_d32` (the
backward's: its variant's `flash_attention_bwd`; `kernel_ms_d32`,
`earlier_ms_d32`: the f32 fused kernel alone against the CUDA-core one).
The f32 bodies of the K2 forward and fused backward are named under
`f32_body` / `f32_source`, with their launches in one default f32 train
step of phase 10 (`launches_f32_step`). K5's entry names its `body` and carries the
CUDA-core body's time as `earlier_ms`. K1's entry: `ms` / `earlier_ms`
(f32) and `ms_bf16` / `earlier_ms_bf16`, the four decoder sites summed,
the earlier three-launch form beside the two launches, and the same as
device time alone (`device_ms*`, `earlier_device_ms*`: the kernels'
time by torch.profiler, without the host's launch cost); `ms_128x64_*`,
`earlier_ms_128x64_*` and `bound_ms_128x64_*` at [128, 128, 128, 64]; the
apply alone there in bf16 as `apply_ms`, `apply_gbps`, `apply_bound_ms`,
`apply_share` (CUDA events around one call, so with the host's launch
cost) and `apply_device_ms`, `apply_device_gbps` (the profiler), with the
exact chain (`apply_exact_ms`) and no mish (`apply_identity_ms`); `mish`, the form it ships; its pass 1 alone at
[128, 128, 128, 64] bf16 as `pass1_*` (`pass1_library_ms`: torch.var_mean
over the grouped view; `var_mean_ms_128x64_*` the same in phase 3). K3's `earlier_ms` is its earlier
form (one block a sample, then torch sums); `device_ms` and
`earlier_device_ms` their device time alone. `trainer_launches` (K1, the
K2 forward, the fused K2 backward, K3) counts phase 15's first run. Phase 16
adds `launches_window_step` (one windowed bf16 train step, every kernel of
the path) and `trainer_launches_window` (its trainer run) to the entries
of K1, the K2 forward and backwards and K3; `launches_evaluate` (one
windowed bf16 evaluate batch of 16) and the windowed forward's readings
`window_ms*`, `window_global_ms*` (the global kernel at B16 beside it),
`window_plain_ms*`, `window_library_ms*`, `window_bound_ms*`,
`window_bound_by*`, `window_bound_ms_sfu*` and `window_max_abs_err*` to
the K2 forward's (`*_bf16_d32` at d 32); the
windowed default backward's (`window_variant`, `window_ms`, ...) to the
fused backward's under `*_bf16` and, for f32, to the kernel that ran it
(the fused one, unsuffixed; split's under `split_*` on dq's and dk/dv's). Phase 17 adds `launches_bundle_generate` and
`launches_bundle_score` (one bf16 generate and one score of a loaded
"cuda" bundle at batch 8, the serving process's counts) to K1's and the K2
forward's entries, and phase 3 `dispatch_{bare,library,custom_op}_ms_bf16`
to K1's (the four bf16 decoder sites by the bare launch, the
`lunaris_orion::gn_mish` operator and a `torch.library.custom_op` of the
same launch, in turns). Phase 18 adds `launches_dist_allgather` (rank 1's
launches, all on its q shard, in the f32 allgather step of (b)) to the K2
forward's and backwards' entries, and the K2 forward's and the bf16
default backward's times alone on a CP shard (`cp_shard_ms`,
`cp_shard_bound_ms`, `cp_shard_bound_by`, `cp_shard_library_ms`: SDPA on
the same rectangular shape; `cp_shard_variant`) to the forward's and the
fused backward's, and (c) `launches_tp_ep` (rank 0's launches in the f32
TP/EP step) to K1's, the K2 forward's and backwards' and K3's. Phase 19
adds `launches_parity` (each parity run's profiled second step, by run)
to K1's, the K2 forward's, the fused K2 backward's and K3's. The warpgroup
bodies have entries of their own, `flash_attention_fwd_wgmma` and
`flash_attention_bwd_wgmma`: `launches` in phase 20's step (and the
forward's `launches_decode` in its decode+score), `ms`, `earlier_ms` (the
body each replaced, in turns), `library_ms` (SDPA), `plain_ms`,
`bound_ms` at the H100 recipe's head size, d 64 (forward B 8 dropout 0,
backward B 2 dropout 0.1, its `shape`; N 16384), every d 48 and 64
reading under `readings` (the backward's B 16 times under `B16`), and
their `instances`. So do the narrow ones (bf16 d 16),
`flash_attention_fwd_wgmma_narrow` and `flash_attention_bwd_wgmma_narrow`:
`launches` in phase 10's train steps (and the forward's `launches_decode`
in phase 5's bf16 decode+score, `launches_window_step` and
`trainer_launches_window` in phase 16, none since the window bodies), the
same times at the default
width (forward B 8 dropout 0, backward B 2 dropout 0.1, N 16384) beside
`bound_ms_sfu`, the special-function floor (one exp a score over 16 a
clock an SM at the card's largest SM clock), every reading under
`readings` (B 16, the other rate, the short rows with the body faster in
turns and the one the rule takes), and the inner loop's instructions per
32 scores by class under `sass`, theirs and the mma.sync instances'. So
do the f32 ones at d 16, `flash_attention_fwd_wgmma_tf32` and
`flash_attention_bwd_wgmma_tf32` (`launches` in phase 10's train steps,
`launches_f32_step` in the default f32 one, the forward's
`launches_decode` in phase 5's f32 decode+score; times at the same shapes
against flash_fwd_tf32 and flash_bwd_fused_tf32, their `bound_ms` the
three TF32 passes, beside `bound_ms_sfu`; every reading under
`readings`), and their pre-pass `k2_tf32_split` (its time at B 8 N 16384
in the forward's mode against its plain twin, bound by bytes); at d 32, 48
and 64 the same readings under `d32` / `d48` / `d64` and `readings_d32` ..
(the backward's at d 48 and 64 against the CUDA-core fused kernel, its B 16
reading, at d 32 its B 8 one, under `d48` .. too), with the launches of
phase 20's f32 runs (`launches_recipe_f32_decode`,
`launches_recipe_f32_step`, and the low-end tier's `..._decode_low_end`,
`..._step_low_end`). So do the window bodies (bf16 d 16 and 32 on the
windowed fold), `flash_attention_fwd_window` and
`flash_attention_bwd_window`: `launches` in phase 16's windowed step (W)
and the forward's `launches_evaluate` (E), `ms` at B16 H8 N16384 W256 d 16
(the forward at dropout 0, `ms_dropout` at 0.1; the backward's whole call
at 0.1) against `earlier_ms` (the mma.sync body in turns), `plain_ms`,
`library_ms` (SDPA on the folded shape), `bound_ms` with `bound_by` and
`bound_ms_sfu`, d 32's under `d32`, and the inner loop's instructions per
32 scores under `sass`. So do the f32 window bodies (f32 d 16 and 32 on the
windowed fold, three TF32 passes split in the kernel),
`flash_attention_fwd_window_tf32` and `flash_attention_bwd_window_tf32`:
`launches` in phase 16's windowed f32 step (0 for the backward, which the
rule leaves on `flash_bwd_fused_tf32`, `window_default`), the forward's
`launches_evaluate` (a windowed f32 evaluation batch), the same readings
against `flash_fwd_tf32` / `flash_bwd_fused_tf32` in turns, the three-pass
bound, and the step's device ms, idle share and K2 ms under `step`. The
last lines are the card's
name and power limit, a JSON object with the kernels' measurements and,
last, the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card it exits with code 2 and prints no result.

`--grads N [FEATURE_DIM]` runs phase 9's comparison alone (at feature_dim
32 unless given; unsided), N times with the kernels and N times with K1,
K2 and K3's plain versions on the card, against one CPU step, and prints
each reading (`spread_grads`).

`--serve DIR` is phase 17's serving process (`serve_bundles`), which the
main run starts itself.

`--profiler-loss N` profiles phase 20's decode+score N times a minute apart,
each time in a session with no spin kernels at its head and in one with
`LEAD_IN` of them, and logs the kernel records each kept by the age of the
process (`profiler_loss`).

`--step-noise N` runs phase 18's single-process f32 step N times with
cuDNN's default algorithms and N times with its deterministic ones, and
prints how far each repeat moved from the first at phase 9's bars
(`step_noise`).
"""

from __future__ import annotations

import atexit
import contextlib
import json
import math
import multiprocessing
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def stopwatch(phase: str):
    """mark(part) logs `[time] <phase> <part>: s` since the last mark: the
    parts of a long phase, for trimming the run to its time limit."""
    last = [time.perf_counter()]

    def mark(part: str) -> None:
        now = time.perf_counter()
        log(f"[time] {phase} {part}: {now - last[0]:.1f} s")
        last[0] = now
    return mark


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    from lunaris_orion_tpu_torch.tools._timing import time_ms as timer
    return timer(fn, "cuda", reps, warmup)


# torch.profiler on the H100 (torch 2.11, CUDA 12.8) now and then drops the
# kernels that run in the first milliseconds of a session, K1's launches at
# the head of a decode among them. A quiet margin after the session starts,
# and another before it stops, kept every record early in a process. Later
# in one it drops a session's first records whatever the margin, more the
# longer the process has run (`--profiler-loss`; phase 20's decode+score,
# its 4 K1 calls among its first 6 ms of kernels, kept 1 of them in full
# runs of this script). So every session starts with LEAD_IN spin kernels
# (`torch.cuda._sleep`, about 17 ms of device time): the records lost are
# theirs, and no reading counts them (`lead_in`).
PROFILE_MARGIN_S = 0.1
LEAD_IN, LEAD_IN_CYCLES = 64, 500_000


def lead_in(name: str) -> bool:
    """A record of the spin kernels `profiled` starts a session with."""
    return "spin_kernel" in name


@contextlib.contextmanager
def profiled(torch, margin: float = PROFILE_MARGIN_S, lead: int = LEAD_IN):
    """A torch.profiler session of the card's kernels, with `margin`
    seconds of quiet after it starts and before it stops, and `lead` spin
    kernels at its head that have ended before the body runs. The body's
    kernels have ended when the block exits."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        time.sleep(margin)
        for _ in range(lead):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        yield p
        torch.cuda.synchronize()
        time.sleep(margin)


def device_ms(torch, fn, reps: int = 20) -> float:
    """Milliseconds of device time a call of fn() takes: every CUDA kernel
    it launches, by torch.profiler over `reps` calls. Unlike CUDA events
    around one call, this leaves out the host's time to launch them."""
    from torch.autograd import DeviceType
    fn()
    with profiled(torch) as p:
        for _ in range(reps):
            fn()
    return sum(e.self_device_time_total for e in p.key_averages()
               if e.device_type == DeviceType.CUDA
               and not lead_in(e.key)) / 1e3 / reps


PEAK_BYTES = 3.35e12                       # H100 SXM: bytes/s of device memory
# Dense tensor cores (bf16, tf32); f32 outside them. An f32 product on the
# tensor cores is three TF32 passes: its operations count three times at
# the tf32 rate (`bounds_f32`).
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound(ops: float, nbytes: float, kind: str) -> dict:
    """The least time the card could take: operations over the peak of
    their type against bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_OPS[kind] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def bounds_f32(ops: float, moved: float) -> dict:
    """An f32 kernel on the tensor cores: both bounds, each named. The
    three TF32 passes over 495 TFLOP/s (`bound_ms_tf32x3`, the least time,
    so `bound_ms`) and the same operations on the CUDA cores over 67
    (`bound_ms_f32`)."""
    tc, cc = bound(3 * ops, moved, "tf32"), bound(ops, moved, "f32")
    return {**tc, "bound_ms_tf32x3": tc["bound_ms"],
            "bound_ms_f32": cc["bound_ms"]}


# The special-function units: 16 results a clock an SM (ex2 among them).
# The K2 kernels do one exp a score, and at d 16 that, not the tensor
# cores, is their floor (`bounds_k2`). The clock is the card's largest SM
# clock (`nvidia-smi --query-gpu=clocks.max.sm`), read by `probe`.
SFU_PER_CLOCK = 16
SM_CLOCK_MHZ = None


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    return float(out.strip().splitlines()[0])


def sfu_ms(exps: float) -> float:
    """exps over the special-function units: 16 a clock an SM at the card's
    largest SM clock."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (SFU_PER_CLOCK * sms * SM_CLOCK_MHZ * 1e6) * 1e3


def bounds_k2(ops: float, moved: float, exps: float) -> dict:
    """A bf16 K2 kernel: both floors, each named. `bound_ms` is `bound()`'s
    (the tensor cores' rate or the bytes, the larger); `bound_ms_sfu` the
    exps over the special-function units (16 a clock an SM at the card's
    largest SM clock), which at d 16 is the larger of the two."""
    return {**bound(ops, moved, "bf16"), "bound_ms_sfu": sfu_ms(exps)}


def bounds_tf32_k2(ops: float, moved: float, exps: float) -> dict:
    """An f32 K2 kernel on the tensor cores: `bounds_f32`'s (three TF32
    passes, the least time, and the CUDA cores' f32 rate) and the
    special-function floor of `bounds_k2`, which at d 16 is below the
    three passes."""
    return {**bounds_f32(ops, moved), "bound_ms_sfu": sfu_ms(exps)}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bf16_ulp(torch, x):
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


# K1's kernels by name: pass 1, the apply with the fold, and the earlier
# form's apply and fold (a name is matched before any that it contains).
K1_KERNELS = ("gn_stats_partial", "gn_mish_apply_fold", "gn_mish_apply",
              "gn_fold")
# Where a path's device time goes: the port's kernels by a part of their
# (demangled) name. The fused backward is the dk/dv kernel whose last
# template argument, kFusedDq or FUSED, is true, or a body of its own
# (f32: flash_bwd_fused_tf32 and flash_bwd_wgmma_tf32; bf16 d 48, 64:
# flash_bwd_wgmma; the windowed fold's: flash_bwd_window, f32
# flash_bwd_window_tf32). The f32 warpgroup bodies' pre-pass is a group of
# its own.
KERNEL_GROUPS = (("K2 fwd", lambda k: "flash_fwd" in k),
                 ("K2 bwd fused", lambda k: "flash_bwd_fused" in k
                  or "flash_bwd_wgmma" in k or "flash_bwd_window" in k
                  or re.search(r"flash_bwd_dkv\w*<[^>]*\btrue>", k) is not None),
                 ("K2 bwd dk/dv", lambda k: "flash_bwd_dkv" in k),
                 ("K2 bwd dq", lambda k: "flash_bwd_dq" in k),
                 ("K2 tf32 pre-pass", lambda k: "k2_tf32_split" in k),
                 ("K1", lambda k: any(p in k for p in K1_KERNELS)),
                 ("K3", lambda k: "mse_kl" in k))


def check_k1_kernels(k1_kernels: dict, calls: int, tag: str) -> None:
    """K1 on the main path is two kernels a call, pass 1 and the apply with
    the fold; the fold kernel of the earlier form does not run."""
    want = {"gn_stats_partial": calls, "gn_mish_apply_fold": calls}
    if k1_kernels != want:
        raise AssertionError(f"{tag}: K1's kernels {k1_kernels}, expected "
                             f"{want} for {calls} calls")


# The K2 warpgroup bodies at d 16 by kind: (forward, backward) by a part of
# their name, and the mma.sync bodies they replaced (the window bodies: on
# the windowed fold, bf16 d 16 and 32; the f32 window ones f32 d 16 and 32).
D16_BODIES = {"narrow": (("flash_fwd_wgmma_narrow", "flash_bwd_wgmma_narrow"),
                         ("flash_fwd_mma", "flash_bwd_dkv_mma")),
              "window": (("flash_fwd_window", "flash_bwd_window"),
                         ("flash_fwd_mma", "flash_bwd_dkv_mma")),
              "f32 window": (("flash_fwd_window_tf32", "flash_bwd_window_tf32"),
                             ("flash_fwd_tf32", "flash_bwd_fused_tf32",
                              "flash_fwd_wgmma_tf32", "flash_bwd_wgmma_tf32")),
              "f32 warpgroup": (("flash_fwd_wgmma_tf32", "flash_bwd_wgmma_tf32"),
                                ("flash_fwd_tf32", "flash_bwd_fused_tf32"))}


def check_narrow_names(names: dict, fwd: int, bwd: int, tag: str,
                       kind: str = "narrow", every: bool = False) -> dict:
    """The K2 warpgroup bodies of `kind` (the narrow bf16 ones, d 16 and
    32, the window ones, bf16 or f32, or the f32 ones, d 16) by name in a profile (`names`, device_share's K2
    instances) against the wrappers' counts of the same run: logged; a
    profile that holds none of the launches counted, or more, fails
    (torch.profiler may drop a session's first records). With `every`, the
    run's K2 calls all took them: no instance of the mma.sync bodies they
    replaced appears by name."""
    new, old = D16_BODIES[kind]
    seen = {key: sum(c for n, c in names.items() if body in n)
            for key, body in zip(("fwd", "bwd"), new)}
    replaced = {n: c for n, c in names.items() if any(b in n for b in old)}
    log(f"[profile] {tag}: {kind} K2 bodies by name fwd {seen['fwd']}, bwd "
        f"{seen['bwd']}; by the wrappers' counts fwd {fwd}, bwd {bwd}"
        + (f"; the mma.sync bodies by name {replaced}" if every else ""))
    for key, n in (("fwd", fwd), ("bwd", bwd)):
        if seen[key] > n or (n > 0 and seen[key] == 0):
            raise AssertionError(f"{tag}: the {kind} K2 {key} body by name "
                                 f"{seen[key]} against {n} counted")
    if every and replaced:
        raise AssertionError(f"{tag}: K2 calls on the mma.sync bodies "
                             f"{replaced}")
    return seen


def device_share(torch, fn, tag: str, smi: str, launches: dict = None,
                 k2_names: dict = None, records: list = None,
                 groups: dict = None):
    """Run fn() once under torch.profiler and log its device time by kernel
    group, with the share of the host's time in which the device was idle,
    and K1's kernels by name. Returns (fn's result, the host's seconds,
    {K1 kernel name: launches}, the device's milliseconds). `launches`, a
    dict, receives each kernel group's launches by name; `k2_names` each
    K2 kernel instance's launches; `records`, a list, every kernel record
    as (start in µs from the first, name), in the order they ran; `groups`
    each group's device milliseconds."""
    from torch.autograd import DeviceType
    with profiled(torch) as p:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    if records is not None:
        ev = sorted((e.time_range.start, e.name) for e in p.events()
                    if e.device_type == DeviceType.CUDA
                    and not lead_in(e.name))
        records.extend((t - ev[0][0], name) for t, name in ev)
    ms = dict.fromkeys([name for name, _ in KERNEL_GROUPS] + ["other"], 0.0)
    k1_kernels, k2_kernels = {}, {}
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA or lead_in(e.key):
            continue
        group = next((g for g, member in KERNEL_GROUPS if member(e.key)),
                     "other")
        ms[group] += e.self_device_time_total / 1e3
        if launches is not None and group != "other":
            launches[group] = launches.get(group, 0) + e.count
        if group == "K1":
            name = next(n for n in K1_KERNELS if n in e.key)
            k1_kernels[name] = k1_kernels.get(name, 0) + e.count
        elif group.startswith("K2"):       # the body and instance by name
            m = re.search(r"flash_\w+<[^>]*>", e.key)
            name = m.group(0) if m else e.key
            k2_kernels[name] = k2_kernels.get(name, 0) + e.count
    total = sum(ms.values())
    if total <= 0:
        log(f"[profile] {tag}: the profiler recorded no device time")
    else:
        parts = ", ".join(f"{g} {t:.1f}" if t >= 10 else f"{g} {t:.3f}"
                          for g, t in ms.items() if t > 0)
        log(f"[profile] {tag}: host {host_s * 1e3:.1f} ms, device "
            f"{total:.1f} ms (idle {max(0.0, 1 - total / (host_s * 1e3)):.1%})"
            f": {parts} ms on {smi}")
        log(f"[profile] {tag}: K1 kernels {k1_kernels}")
        if k2_kernels:
            log(f"[profile] {tag}: K2 kernels {k2_kernels}")
    if k2_names is not None:
        k2_names.update(k2_kernels)
    if groups is not None:
        groups.update(ms)
    return result, host_s, k1_kernels, total


def probe(torch) -> str:
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[probe] device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} "
        f"sm_count {torch.cuda.get_device_properties(0).multi_processor_count}")
    from lunaris_orion_tpu_torch.tools._timing import card_line
    global SM_CLOCK_MHZ
    smi = card_line("cuda")
    SM_CLOCK_MHZ = sm_clock_mhz()
    log(f"[probe] {smi}, largest SM clock {SM_CLOCK_MHZ:.0f} MHz "
        f"(nvidia-smi clocks.max.sm)")
    from lunaris_orion_tpu_torch.ops.cuda import _build
    nvcc = _build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log(f"[probe] nvcc {nvcc}: {[v for v in ver if 'release' in v][0]}")
    try:
        import triton
        log(f"[probe] triton {triton.__version__} importable")
    except ImportError as e:
        log(f"[probe] triton not importable: {e}")
    return smi


def build():
    """Phase 2: the build, its report's checks; returns `sass_counts`, the
    checks of the library's SASS (cuobjdump, started here)."""
    from lunaris_orion_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    lib = _build.build()
    lib_smem = lambda name, *a: getattr(_build.library(), name)(*a)
    log(f"[build] {_build.build_dir()} in {time.perf_counter() - t0:.1f} s")
    report = (_build.build_dir() / "build.log").read_text().splitlines()
    for line in report:
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line or line.startswith("nvcc seconds")):
            log("[build]   " + line.strip())
    # K5's tensor-core body and K2's f32 tensor-core bodies (three TF32
    # passes): no instance spills; K5's SASS holds HMMA.
    fn, spills, tf32 = None, [], {}
    for line in report:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        fn = m.group(1) if m else fn
        if (fn and ("gn_mish_conv3_mma" in fn or "tf32" in fn)
                and re.search(r"[1-9]\d* bytes spill", line)):
            spills.append(fn)
        if fn and "tf32" in fn:
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            row = tf32.setdefault(fn, [0, 0])
            row[0] = int(regs.group(1)) if regs else row[0]
            row[1] = int(spill.group(1)) if spill else row[1]
    for fn, (regs, spill) in sorted(tf32.items()):
        log(f"[build] K2 TF32 {fn}: {regs} registers, {spill} bytes spilled")
    if len({fn for fn in tf32 if "flash_fwd_tf32" in fn}) < 7 or not any(
            "flash_bwd_fused_tf32" in fn for fn in tf32):
        raise AssertionError(f"the K2 TF32 instances are missing from the "
                             f"build's report: {sorted(tf32)}")
    # K2's warpgroup bodies (bf16 d 48 and 64, wgmma fed by TMA, the narrow
    # ones at d 16 and 32, the window ones at d 16 and 32, bf16 and f32, and
    # f32's at d 16, 32, 48 and 64 on three TF32 passes): no instance
    # spills, ptxas serialises none of their wgmma, and setmaxnreg moves the
    # registers
    # (ptxas reports the count at entry, 168 for 384 threads and 128 for
    # 512; the consumers take 232, the narrow bodies' and an f32 forward's
    # of three consumers (d 16) 160; the f32 backward at d 32, 48 and 64,
    # one or two consumer warpgroups and a producer warp, 160 or 288
    # threads, takes no setmaxnreg: its count is the one ptxas reports; so
    # does the f32 window bodies' at d 32, one consumer warpgroup and a
    # producer one, 256 threads).
    wg, fn = {}, None
    for line in report:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        fn = m.group(1) if m else fn
        if "setmaxnreg" in line and "ignored" in line:
            raise AssertionError(f"ptxas ignored setmaxnreg: {line.strip()}")
        if fn and any(b in fn for b in ("flash_fwd_wgmma", "flash_bwd_wgmma",
                                        "flash_fwd_window", "flash_bwd_window")):
            if any(c in line for c in ("C7512", "C7514", "C7515", "C7518",
                                       "C7520")):
                raise AssertionError(f"ptxas serialised a warpgroup body's "
                                     f"wgmma: {line.strip()}")
            regs = re.search(r"Used (\d+) registers", line)
            spill = re.search(r"(\d+) bytes spill stores", line)
            row = wg.setdefault(fn, [0, 0])
            row[0] = int(regs.group(1)) if regs else row[0]
            row[1] = int(spill.group(1)) if spill else row[1]
    # (a name is matched before any that it contains): the dynamic shared
    # memory, the consumers' registers and the instances of each body
    smem = {f"flash_{x}_wgmma_narrowILi{d}E":
            (lib_smem(f"lunaris_k2_{x}_wgmma_narrow_smem_bytes", d), 160, 2)
            for x in ("fwd", "bwd") for d in (16, 32)}
    smem |= {f"flash_{x}_windowILi{d}E":
             (lib_smem(f"lunaris_k2_window_{x}_smem_bytes", d), 232, 2)
             for x in ("fwd", "bwd") for d in (16, 32)}
    smem |= {f"flash_{x}_window_tf32ILi{d}E":
             (lib_smem(f"lunaris_k2_window_tf32_{x}_smem_bytes", d),
              232 if d == 16 else None, 2)
             for x in ("fwd", "bwd") for d in (16, 32)}
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    for d in k2.TF32_WGMMA_HEAD_DIMS:
        # The dispatch rule's rows and keys a block are the library's.
        rows = lib_smem("lunaris_k2_fwd_wgmma_tf32_rows", d)
        keys = lib_smem("lunaris_k2_bwd_wgmma_tf32_keys", d)
        if (rows, keys) != (k2.TF32_WGMMA_ROWS[d], k2.TF32_WGMMA_BWD_KEYS[d]):
            raise AssertionError(f"the f32 warpgroup bodies at d {d} take "
                                 f"{rows} rows, {keys} keys a block; the "
                                 f"rule says {k2.TF32_WGMMA_ROWS[d]}, "
                                 f"{k2.TF32_WGMMA_BWD_KEYS[d]}")
        smem |= {f"flash_fwd_wgmma_tf32ILi{d}E":
                 (lib_smem("lunaris_k2_fwd_wgmma_tf32_smem_bytes", d),
                  160 if rows == 192 else 232, 2),
                 f"flash_bwd_wgmma_tf32ILi{d}E":
                 (lib_smem("lunaris_k2_bwd_wgmma_tf32_smem_bytes", d),
                  232 if d == 16 else None, 2)}
    smem |= {"flash_fwd_wgmma": (lib_smem("lunaris_k2_fwd_wgmma_smem_bytes"),
                                 232, 4),
             "flash_bwd_wgmma": (lib_smem("lunaris_k2_bwd_wgmma_smem_bytes"),
                                 232, 4)}
    counts = dict.fromkeys(smem, 0)
    for fn, (regs, spill) in sorted(wg.items()):
        body = next(b for b in smem if b in fn)
        counts[body] += 1
        consumers = (f"{smem[body][1]} in the consumer warpgroups"
                     if smem[body][1] else "no setmaxnreg")
        log(f"[build] K2 warpgroup {fn}: {regs} registers at entry ("
            f"{consumers}), {spill} bytes spilled, {smem[body][0]} bytes of "
            "dynamic shared memory")
        if spill:
            spills.append(fn)
    if counts != {b: n for b, (_, _, n) in smem.items()}:
        raise AssertionError(f"the K2 warpgroup instances are missing from "
                             f"the build's report: {sorted(wg)}")
    if spills:
        raise AssertionError(f"a tensor-core instance spills ({spills})")
    # The library's SASS: cuobjdump runs under the phases that follow, and
    # `sass_counts` (called before the kernels' line) reads it.
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    dump = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([str(cuobjdump), "-sass", str(lib)], stdout=dump,
                            stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())

    def sass_counts() -> dict:
        """K5's SASS holds HMMA (its instruction counts logged); the bf16
        d 16 and d 32 K2 inner loops by class (`k2_d16_sass`)."""
        proc.wait(timeout=600)
        dump.seek(0)
        sass = dump.read()
        dump.close()
        if proc.returncode:
            raise AssertionError(f"cuobjdump -sass failed: {sass[-2000:]}")
        ops, fn = {}, None          # instruction counts a K5 instance, static
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1)
                continue
            op = re.search(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
            if fn and "gn_mish_conv3_mma" in fn and op:
                count = ops.setdefault(fn, {"all": 0})
                count["all"] += 1
                count[op.group(1)] = count.get(op.group(1), 0) + 1
        for fn, count in sorted(ops.items()):
            log(f"[build] K5 {fn[-40:]}: " + ", ".join(
                f"{k} {count.get(k, 0)}" for k in (
                    "all", "HMMA", "LDSM", "MUFU", "FFMA", "FADD", "FMUL")))
        if len(ops) != 2 or not all(c.get("HMMA") for c in ops.values()):
            raise AssertionError("K5's body has no HMMA in its SASS")
        return k2_d16_sass(sass)
    return sass_counts


# The bf16 d 16 and d 32 K2 bodies whose inner loop `k2_d16_sass` counts:
# parts of the (mangled) name that pick the instances, and the scores a
# thread takes a pass of the loop (fwd: 64 rows x 128 keys over 128
# threads at d 16, x 64 keys at d 32, or a warp's 32 rows x 64 keys over 32
# at d 16, 16 rows at d 32; bwd: 64 keys x 64 queries over 128, or a warp's
# 32 keys x 64 queries over 32 at d 16, 16 keys at d 32; the window
# bodies: 64 rows x 256 keys, or 64 keys x 4 query groups of 64, over
# 128; the f32 ones' backward 64 keys x one query group of 64 over 128). mma.sync's d 32 instances test dropout at run time: their loop
# holds both paths.
K2_D16_LOOPS = (
    ("fwd narrow", ("flash_fwd_wgmma_narrowILi16E",), 64),
    ("fwd mma.sync", ("fwd_mma_cu", "ILi16E"), 64),
    ("bwd narrow", ("flash_bwd_wgmma_narrowILi16E",), 32),
    ("bwd mma.sync", ("bwd_mma_fused_cu", "ILi16E"), 64),
    ("fwd narrow d32", ("flash_fwd_wgmma_narrowILi32E",), 32),
    ("fwd mma.sync d32", ("flash_fwd_mmaILi32E",), 32),
    ("bwd narrow d32", ("flash_bwd_wgmma_narrowILi32E",), 32),
    ("bwd mma.sync d32", ("flash_bwd_dkv_mmaILi32ELi2ELb1ELb1EE",), 32),
    ("fwd window", ("flash_fwd_windowILi16E",), 128),
    ("bwd window", ("flash_bwd_windowILi16E",), 128),
    ("fwd window d32", ("flash_fwd_windowILi32E",), 128),
    ("bwd window d32", ("flash_bwd_windowILi32E",), 128),
    ("fwd f32 window", ("flash_fwd_window_tf32ILi16E",), 128),
    ("bwd f32 window", ("flash_bwd_window_tf32ILi16E",), 32),
    ("fwd f32 window d32", ("flash_fwd_window_tf32ILi32E",), 128),
    ("bwd f32 window d32", ("flash_bwd_window_tf32ILi32E",), 32))
# Instruction classes, by SASS opcode (before the first dot).
SASS_CLASSES = (
    ("MUFU", ("MUFU",)), ("FFMA", ("FFMA",)), ("FMUL", ("FMUL",)),
    ("FADD", ("FADD",)), ("FMNMX", ("FMNMX",)), ("IMAD", ("IMAD",)),
    ("IADD3", ("IADD3", "VIADD", "IADD")), ("LOP3", ("LOP3",)),
    ("SHF", ("SHF",)), ("ISETP", ("ISETP",)), ("FSEL", ("FSEL",)),
    ("F2FP", ("F2FP",)), ("HGMMA/HMMA", ("HGMMA", "HMMA")),
    ("barriers", ("SYNCS", "BAR", "WARPGROUP", "DEPBAR", "MEMBAR")),
    ("uniform", ("ULOP3", "UIADD3", "UMOV", "USHF", "ULEA", "R2UR", "UIMAD",
                 "ULDC", "UISETP", "USEL")))


def k2_d16_sass(sass: str) -> dict:
    """The inner loop of each bf16 d 16 and d 32 K2 instance, counted by
    class from
    `cuobjdump -sass`: the loop is the conditional backward branch whose
    span holds the most MUFU.EX2 (the fewest instructions on a tie); its
    counts, over the scores a thread takes a pass, are warp-instructions
    per 32 scores. Logs one line an instance; returns them by instance."""
    funcs, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)([^;]*);", line)
        if fn and m:
            funcs[fn].append((int(m.group(1), 16), m.group(3), m.group(4),
                              bool(m.group(2))))
    out = {}
    for label, keys, scores in K2_D16_LOOPS:
        for fn in sorted(f for f in funcs if all(k in f for k in keys)):
            ins, best = funcs[fn], None
            for addr, op, rest, pred in ins:
                tgt = re.search(r"0x([0-9a-f]+)", rest)
                if not (op.startswith("BRA") and pred and tgt
                        and int(tgt.group(1), 16) < addr):
                    continue
                body = [o for a, o, _, _ in ins
                        if int(tgt.group(1), 16) <= a <= addr]
                ex2 = sum(o.startswith("MUFU.EX2") for o in body)
                if best is None or (ex2, -len(body)) > (best[0], -len(best[1])):
                    best = (ex2, body)
            if best is None or best[0] < scores:
                continue
            body = best[1]
            per = {name: sum(o.split(".")[0] in ops for o in body) / scores
                   for name, ops in SASS_CLASSES}
            per["all"] = len(body) / scores
            inst = re.search(r"flash_\w+?(I[^E]*E[^E]*E[^N]*)", fn)
            name = f"{label} {inst.group(1) if inst else fn[-40:]}"
            out[name] = per
            log(f"[build] SASS {name}: inner loop {len(body)} instructions "
                f"for {scores} scores a thread; per 32 scores: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in per.items()))
    if sum(k.startswith("fwd narrow") for k in out) != 4 or sum(
            k.startswith("bwd narrow") for k in out) != 4:
        raise AssertionError(f"the narrow K2 instances' inner loops were not "
                             f"found in the SASS: {sorted(out)}")
    return out


def k1_agree(torch, got, ref) -> tuple:
    """(ok, max_abs_err) of K1's output against its plain version: 1e-5 in
    f32; 2 bf16 ulps of each element's own reference (+1e-6 near 0)."""
    err = (got.float() - ref.float()).abs()
    if got.dtype == torch.float32:
        return err.max().item() <= 1e-5, err.max().item()
    return bool((err <= 2 * bf16_ulp(torch, ref) + 1e-6).all()), \
        err.max().item()


def k1_turns(torch, k1, x, w, b, reps: int) -> list:
    """K1's earlier three launches and its two launches (the shipped mish),
    by the same wrapper without autograd, in turns: earlier, new, new,
    earlier; ms each."""
    earlier = lambda: k1.gn_mish_kernel(x, w, b, earlier=True)
    new = lambda: k1.gn_mish_kernel(x, w, b)
    return [time_ms(torch, fn, reps) for fn in (earlier, new, new, earlier)]


def k1_dispatch(torch, k1, sites, smi) -> dict:
    """The cost of reaching K1 through an operator: the four bf16 decoder
    sites summed, by the bare launch (`gn_mish._kernel`), the operator
    `lunaris_orion::gn_mish` that the port registers (a
    `torch.library.Library` with a CUDA kernel) and the same launch
    registered by `torch.library.custom_op` here, for this comparison
    only; in turns (bare, library, custom_op, custom_op, library, bare)."""
    @torch.library.custom_op(
        "lunaris_orion_probe::gn_mish", mutates_args=(), device_types="cuda",
        schema="(Tensor x, Tensor weight, Tensor bias, int groups, "
               "float eps) -> Tensor")
    def probe_op(x, weight, bias, groups, eps):
        return k1._kernel(x, weight, bias, groups, eps)

    routes = {"bare": k1._kernel,
              "library": torch.ops.lunaris_orion.gn_mish.default,
              "custom_op": probe_op}
    order = ("bare", "library", "custom_op", "custom_op", "library", "bare")
    turns = [sum(time_ms(torch, lambda: routes[r](x, w, b, 8, 1e-5), 50)
                 for x, w, b in sites) for r in order]
    ms = {r: min(t for o, t in zip(order, turns) if o == r) for r in routes}
    log(f"[K1] dispatch, the four bf16 decoder sites summed, in turns "
        f"({', '.join(order)}): {', '.join(f'{t:.4f}' for t in turns)} ms; "
        f"the operator adds {ms['library'] - ms['bare']:.4f} ms, custom_op "
        f"{ms['custom_op'] - ms['bare']:.4f} ms on {smi}")
    return {f"dispatch_{r}_ms_bf16": t for r, t in ms.items()}


def check_k1(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    g = torch.Generator(device=dev).manual_seed(0)
    worst, plain_ms, moved, ops = 0.0, 0.0, 0, 0
    sums = {torch.float32: [0.0] * 4, torch.bfloat16: [0.0] * 4}

    def same_bits(x, w, b, tag):
        """The two launches with the exact mish give the earlier three
        launches' bits; the shipped path gives the same bits twice."""
        if not torch.equal(k1.gn_mish_kernel(x, w, b, mish="exact"),
                           k1.gn_mish_kernel(x, w, b, earlier=True)):
            raise AssertionError(f"K1 with the exact mish is not bit-equal "
                                 f"to the earlier form at {tag}")
        if not torch.equal(k1.gn_mish(x, w, b), k1.gn_mish(x, w, b)):
            raise AssertionError(f"K1 gives other bits on a second run at "
                                 f"{tag}")

    sites = {torch.float32: [], torch.bfloat16: []}
    for shape in ((8, 16, 16, 256), (8, 32, 32, 128), (8, 64, 64, 64),
                  (8, 128, 128, 32)):
        c = shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        # x read once, y written once; per element 3 for the moments, 2 for
        # the affine and about 10 for the shipped mish's exp and reciprocal.
        moved += 2 * nbytes(x32)
        ops += 15 * x32.numel()
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            ok, err = k1_agree(torch, k1.gn_mish(x, w, b),
                               k1.gn_mish_plain(x, w, b))
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at {shape} {dt}")
            same_bits(x, w, b, f"{shape} {dt}")
            sites[dt].append((x, w, b))
            turns = k1_turns(torch, k1, x, w, b, 20)
            sums[dt] = [s + t for s, t in zip(sums[dt], turns)]
            t_p = time_ms(torch, lambda: k1.gn_mish_plain(x, w, b), 20)
            if dt == torch.float32:
                worst, plain_ms = max(worst, err), plain_ms + t_p
            log(f"[K1] {shape} {str(dt)[6:]}: max_abs_err {err:.3e}; in "
                f"turns (earlier, new, new, earlier) "
                f"{', '.join(f'{t:.4f}' for t in turns)} ms; plain "
                f"{t_p:.4f} ms")
    out = {"max_abs_err": worst, "plain_ms": plain_ms, "library_ms": None,
           "mish": k1.MISH, **bound(ops, moved, "f32")}
    for dt, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        t = sums[dt]
        out[f"ms{tag}"], out[f"earlier_ms{tag}"] = min(t[1:3]), min(t[0], t[3])
        for form, kw in (("", {}), ("earlier_", {"earlier": True})):
            out[f"{form}device_ms{tag}"] = device_ms(torch, lambda: [
                k1.gn_mish_kernel(*a, **kw) for a in sites[dt]])
    log(f"[K1] the four decoder sites, summed: f32 {out['ms']:.4f} ms "
        f"(earlier form {out['earlier_ms']:.4f}), bf16 {out['ms_bf16']:.4f} "
        f"ms (earlier form {out['earlier_ms_bf16']:.4f}); device time alone "
        f"(profiler): f32 {out['device_ms']:.4f} ms (earlier form "
        f"{out['earlier_device_ms']:.4f}), bf16 {out['device_ms_bf16']:.4f} "
        f"ms (earlier form {out['earlier_device_ms_bf16']:.4f}); bound "
        f"{out['bound_ms']:.4f} ms by {out['bound_by']} on {smi}")
    out |= k1_dispatch(torch, k1, sites[torch.bfloat16], smi)
    del sites

    # The tool's `gnmish_alone` shape: K1 in turns against the earlier
    # form, then the apply alone from pass 1's partials with the shipped
    # mish, the exact chain and none (the probe), in turns.
    shape = (128, 128, 128, 64)
    x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
    w = 1 + 0.1 * torch.randn(64, generator=g, device=dev)
    b = 0.1 * torch.randn(64, generator=g, device=dev)
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = x32.to(dt)
        ok, err = k1_agree(torch, k1.gn_mish(x, w, b),
                           k1.gn_mish_plain(x, w, b))
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{shape} {dt}")
        same_bits(x, w, b, f"{shape} {dt}")
        turns = k1_turns(torch, k1, x, w, b, 10)
        part = k1.group_partials(x)
        forms = ("none", k1.MISH, "exact", "exact", k1.MISH, "none")
        apply = [time_ms(torch, lambda: k1.gn_mish_apply(
            x, part, w, b, mish=m), 10) for m in forms]
        t_apply = {m: min(t for f, t in zip(forms, apply) if f == m)
                   for m in forms}
        d_apply = device_ms(torch, lambda: k1.gn_mish_apply(x, part, w, b), 10)
        # The library call for pass 1: torch.var_mean over the grouped view
        # (NHWC: [B, H*W, G, C/G], reduced over pixels and the group's
        # channels), the per-group moments that pass 1's sums give.
        grouped = x.view(shape[0], -1, 8, shape[3] // 8)
        t_vm = time_ms(torch, lambda: torch.var_mean(grouped, dim=(1, 3)), 10)
        out[f"var_mean_ms_128x64_{tag}"] = t_vm
        bd = bound(15 * x.numel(), 2 * nbytes(x), "f32")
        bd_apply = bound(12 * x.numel(), 2 * nbytes(x) + nbytes(part),
                         "f32")
        out[f"ms_128x64_{tag}"] = min(turns[1:3])
        out[f"earlier_ms_128x64_{tag}"] = min(turns[0], turns[3])
        out[f"bound_ms_128x64_{tag}"] = bd["bound_ms"]
        gbps = 2 * nbytes(x) / t_apply[k1.MISH] / 1e6
        log(f"[K1] {list(shape)} {tag}: max_abs_err {err:.3e}; in turns "
            f"(earlier, new, new, earlier) "
            f"{', '.join(f'{t:.4f}' for t in turns)} ms, bound "
            f"{bd['bound_ms']:.4f} ms; the apply alone in turns "
            f"({', '.join(forms)}) {', '.join(f'{t:.4f}' for t in apply)} "
            f"ms: {gbps:.0f} GB/s, {bd_apply['bound_ms'] / t_apply[k1.MISH]:.1%}"
            f" of its bound {bd_apply['bound_ms']:.4f} ms; device time alone "
            f"(profiler) {d_apply:.4f} ms, {2 * nbytes(x) / d_apply / 1e6:.0f} "
            f"GB/s; torch.var_mean over the grouped view {t_vm:.4f} ms "
            f"on {smi}")
        if dt == torch.bfloat16:
            out.update(apply_ms=t_apply[k1.MISH], apply_gbps=gbps,
                       apply_bound_ms=bd_apply["bound_ms"],
                       apply_share=bd_apply["bound_ms"] / t_apply[k1.MISH],
                       apply_device_ms=d_apply,
                       apply_device_gbps=2 * nbytes(x) / d_apply / 1e6,
                       apply_exact_ms=t_apply["exact"],
                       apply_identity_ms=t_apply["none"])
    return out


def check_k1_train(torch, dev) -> float:
    """K1 at the train step's own sites: the inputs that a training forward
    of the default VAE (batch 16, encoder and decoder) gives each GroupNorm
    site, in f32 and bf16, held against the plain version."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.train.step import normalize_images

    cfg = TrainConfig()
    vae = LunarisCoreVAE(cfg.vae_config())
    vae.reset_parameters(torch.Generator().manual_seed(10))
    vae.to(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    images = torch.randint(0, 256, (cfg.batch_size, cfg.image_size,
                                    cfg.image_size, 3), dtype=torch.uint8,
                           device=dev, generator=g)
    calls, kernel = [], k1.gn_mish

    def record(x, w, b, *, groups=8, eps=1e-5):
        calls.append((x.clone(), w.clone(), b.clone(), groups, eps))
        return kernel(x, w, b, groups=groups, eps=eps)
    k1.gn_mish = record
    try:
        with torch.no_grad():
            for dt in (torch.float32, torch.bfloat16):
                vae(normalize_images(images, dt), g)
    finally:
        k1.gn_mish = kernel
    worst = 0.0
    for x, w, b, groups, eps in calls:
        got = k1.gn_mish(x, w, b, groups=groups, eps=eps)
        ref = k1.gn_mish_plain(x, w, b, groups=groups, eps=eps)
        torch.cuda.synchronize()
        ok, err = k1_agree(torch, got, ref)
        if x.dtype == torch.float32:
            worst = max(worst, err)
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version at the "
                                 f"train site {tuple(x.shape)} {x.dtype}")
    shapes = sorted({tuple(c[0].shape) for c in calls}, key=lambda s: -s[1])
    log(f"[K1 train] {len(calls)} sites of a batch-{cfg.batch_size} VAE "
        f"training forward (f32 and bf16) agree with the plain version "
        f"(f32 max_abs_err {worst:.3e}, tol 1e-5; bf16 2 ulps); shapes "
        f"{shapes}")
    if len(calls) != 2 * 16:
        raise AssertionError(f"expected 16 K1 sites per forward, got "
                             f"{len(calls) // 2}")
    return worst


# The bf16 bar of the K2 forward, element by element against the plain
# version's online form at the kernel's key tile (which rounds p where the
# kernel does): 2 bf16 ulps of the element's own reference for the last
# rounding, plus a share of the largest output, and a ceiling on the share of
# elements that differ at all. A score that differs in its last f32 bits can
# round p the other way in bf16 and move o by 2^-8 p / l |v|. CUDA cores
# (sums in f32 FMAs, expf): 2e-5 of the largest, 1 element in 100 (measured
# on an H100: 4e-7, 1 in 900). Tensor cores (truncating sums, ex2.approx on a
# rounded product): 1e-3 of the largest, 3 in 100 (measured: 1.8e-4 at N 300,
# 1.5e-4 at N 16384; 9 in 1000). The warpgroup bodies (wgmma) and the
# window bodies have the tensor cores' bar. An element in the wrong place is
# off by a tenth of the largest or more.
K2_BF16_BAR = {"simt": (2e-5, 1e-2), "mma": (1e-3, 3e-2),
               "wgmma": (1e-3, 3e-2), "window": (1e-3, 3e-2)}


def k2_bf16_agree(torch, got, ref, body):
    """(ok, worst excess over 2 ulps as a share of the largest, share of
    elements that differ) of a bf16 forward output against its reference."""
    share, ceiling = K2_BF16_BAR[body]
    ref = ref.float()
    each = (got.float() - ref).abs()
    top = ref.abs().max().item()
    excess = (each - 2 * bf16_ulp(torch, ref)).max().item() / top
    differ = (each > 0).float().mean().item()
    return excess <= share and differ <= ceiling, excess, differ


def check_k2(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    g = torch.Generator(device=dev).manual_seed(1)
    out, turns = {}, {}     # turns: f32 (new, earlier) ms by shape
    # The teacher's shape at the serving batch and the train step's.
    cases = [(b, 8, 16384, 16, dt, rate) for b in (8, 16)
             for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases += [(8, 8, 4096, d, torch.float32, 0.1) for d in (8, 32, 48, 64)]
    cases += [(8, 8, 4096, d, torch.bfloat16, 0.1) for d in (8, 32, 48)]
    # d 32 (feature_dim 256) at the serving batch: times beside the library.
    cases += [(8, 8, 16384, 32, torch.float32, 0.0)]
    # bf16 at d 32 (the low-end recipe), the narrow warpgroup body: a ragged
    # N either side of a key tile (the rule takes the body from
    # NARROW_MIN_ROWS[32] on), then the teacher's N at the serving batch and
    # the train step's, both rates, against mma.sync in turns.
    cases += [(4, 8, 2000, 32, torch.bfloat16, 0.1),
              (4, 8, 2100, 32, torch.bfloat16, 0.0)]
    cases += [(b, 8, 16384, 32, torch.bfloat16, rate) for b in (8, 16)
              for rate in (0.0, 0.1)]
    cases += [(8, 8, 4096, 64, torch.bfloat16, 0.0),
              (4, 8, 2000, 16, torch.float32, 0.1),
              (4, 8, 2000, 16, torch.bfloat16, 0.1),
              (4, 8, 2000, 16, torch.bfloat16, 0.0)]
    # bf16 at d 48 and 64 (the mid-range and H100-tier recipes), the
    # warpgroup body: a ragged N, then the teacher's N at the serving batch,
    # timed against the tensor-core body it replaced and beside SDPA.
    cases += [(4, 8, 2000, d, torch.bfloat16, rate)
              for d, rate in ((48, 0.1), (64, 0.0))]
    cases += [(8, 8, 16384, d, torch.bfloat16, rate) for d in (48, 64)
              for rate in (0.0, 0.1)]
    wg = {}                 # the warpgroup body's readings by (d, rate)
    narrow = {}             # the narrow body's (d 16) by (B, rate)
    narrow32 = {}           # the narrow body's at d 32 by (B, rate)
    mark = stopwatch("phase 4")
    for b, h, n, d, dt, rate in cases:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
                   for _ in range(3))
        bias = 0.5 * torch.randn(h, n, generator=g, device=dev)
        kw = dict(dropout_rate=rate, seed=-1234567)
        inst = k2.forward_instance(dt, d, n, n, rate)
        tag = (f"B{b} H{h} N{n} d{d} {str(dt)[6:]} dropout {rate} "
               f"({inst.body})")
        o, lse = k2.flash_attention(q, k, v, bias, **kw)
        ro, rlse = k2.attention_plain(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        scale = ro.float().abs().max().item()
        # f32: atol 1e-5. bf16 against the two-pass plain version, which
        # rounds p at another magnitude: 2 bf16 ulps of the largest output;
        # the element-by-element bar is held against the online form below.
        tol = 1e-5 if dt == torch.float32 else 2 * 2.0 ** -7 * scale
        ok, note, online = err <= tol and lse_err <= 1e-4, "", None
        if dt == torch.bfloat16:
            online = k2.attention_plain(q, k, v, bias, block_k=inst.block_k,
                                        **kw)
            agree, excess, differ = k2_bf16_agree(torch, o, online[0],
                                                  inst.body)
            ok = ok and agree and (lse - online[1]).abs().max().item() <= 1e-4
            note = (f"; online form: over 2 ulps by {max(excess, 0):.1e} of "
                    f"the largest (bar {K2_BF16_BAR[inst.body][0]:.0e}), "
                    f"{differ:.1e} differ (bar {K2_BF16_BAR[inst.body][1]:.0e})")
        big = n == 16384
        t_k = time_ms(torch, lambda: k2.flash_attention(q, k, v, bias, **kw),
                      5 if big else 10)
        flops = 4 * b * h * n * n * d
        log(f"[K2] {tag}: max_abs_err {err:.3e} (tol {tol:.1e}) lse_err "
            f"{lse_err:.1e}{note}; kernel {t_k:.3f} ms "
            f"({flops / t_k / 1e9:.2f} TFLOP/s)")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {tag}")
        if not big:
            continue
        del ro, rlse
        f32 = dt == torch.float32
        if inst.body != "wgmma" or f32:
            online = None
        if inst.body == "wgmma" and d in k2.NARROW_HEAD_DIMS and not f32:
            # bf16 at d 16 and 32: the narrow warpgroup body against
            # mma.sync in turns, beside SDPA, the plain version and both
            # floors (f32's warpgroup body: `check_tf32_fwd`).
            r = wgmma_turns(q, k, v, bias, kw, t_k, err, tag, online)
            online = None
            if d == 32:
                narrow32[f"B{b} dropout {rate}"] = r
                if b == 8 and rate == 0.0:
                    out |= {"ms_bf16_d32": r["ms"],
                            "library_ms_bf16_d32": r["library_ms"]}
                continue
            narrow[f"B{b} dropout {rate}"] = r
            if b == 8 and rate == 0.0:
                out |= {"max_abs_err_bf16": err, "ms_bf16": r["ms"],
                        "plain_ms_bf16": r["plain_ms"],
                        "library_ms_bf16": r["library_ms"],
                        "bound_ms_bf16": r["bound_ms"],
                        "bound_by_bf16": r["bound_by"],
                        "bound_ms_sfu_bf16": r["bound_ms_sfu"],
                        "earlier_ms_bf16": r["earlier_ms"],
                        "body_bf16": inst.body}
            continue
        if inst.body == "wgmma" and not f32:
            wg[f"d{d} dropout {rate}"] = wgmma_turns(q, k, v, bias, kw, t_k,
                                                     err, tag, online)
            online = None
            continue
        earlier = None
        if d == 16 or f32:
            # The CUDA-core kernel that the tensor-core one replaced (f32:
            # by three TF32 passes), on the same inputs, in turns:
            # earlier, new, new, earlier.
            run = lambda body: time_ms(torch, lambda: k2.forward_kernel(
                q, k, v, bias, body=body, **kw), 3)
            t = [run("simt"), run("mma"), run("mma"), run("simt")]
            log(f"[K2] {tag}: earlier (CUDA cores) {t[0]:.3f}, new (tensor "
                f"cores) {t[1]:.3f}, new {t[2]:.3f}, earlier {t[3]:.3f} ms on "
                f"{smi}")
            if min(t[1:3]) >= min(t[0], t[3]):
                raise AssertionError(f"K2 at {tag}: the tensor-core kernel is "
                                     "no faster than the one it replaced")
            earlier = min(t[0], t[3])
            if f32:
                turns[f"B{b} d{d} dropout {rate}"] = [min(t[1:3]), earlier]
        if d == 32:
            lib, lib_note = sdpa_ms(q, k, v, bias, reps=3)
            log(f"[K2] {tag}: kernel {t_k:.3f} ms, "
                f"F.scaled_dot_product_attention {lib} ms ({lib_note}) on "
                f"{smi}")
            suffix = "_d32" if f32 else "_bf16_d32"
            out |= {"ms" + suffix: t_k, "library_ms" + suffix: lib}
            if f32:
                out["earlier_ms_d32"] = earlier
            continue
        if b == 8 and rate == 0.0:
            t_p = time_ms(torch, lambda: k2.attention_plain(q, k, v, bias, **kw),
                          2)
            lib, lib_note = sdpa_ms(q, k, v, bias, reps=3)
            moved = nbytes(q, k, v, bias, o, lse)
            bd = (bounds_f32(flops, moved) if f32
                  else bound(flops, moved, "bf16"))
            log(f"[K2] {tag}: plain {t_p:.3f} ms, "
                f"F.scaled_dot_product_attention {lib} ms ({lib_note}), bound "
                f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}"
                + (f" (three TF32 passes; {bd['bound_ms_f32']:.3f} ms on the "
                   f"CUDA cores)" if f32 else ""))
            if f32:
                out |= {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                        "library_ms": lib, **bd, "earlier_ms": earlier,
                        "body": inst.body}
            else:
                out |= {"max_abs_err_bf16": err, "ms_bf16": t_k,
                        "plain_ms_bf16": t_p, "library_ms_bf16": lib,
                        "bound_ms_bf16": bd["bound_ms"],
                        "bound_by_bf16": bd["bound_by"],
                        "earlier_ms_bf16": earlier, "body_bf16": inst.body}
    out["turns_f32"] = turns
    out["wgmma"] = wg
    mark("cases")
    out["wgmma_shard"] = check_k2_shard(torch, k2, g, dev)
    narrow["short rows"] = narrow_short_rows(torch, k2, g, dev, smi, 16)
    out["narrow"] = narrow
    narrow32["short rows"] = narrow_short_rows(torch, k2, g, dev, smi, 32)
    out["narrow32"] = narrow32
    mark("shard, narrow short rows")
    out["tf32"] = check_tf32_fwd(torch, k2, g, dev, smi)
    mark("f32 d16")
    # f32 at d 32, 48 and 64: the low-end, mid-range and H100-tier widths
    # in the CLIs' default precision.
    for d in TF32_WIDE:
        out[f"tf32_d{d}"] = check_tf32_fwd(torch, k2, g, dev, smi, d)
        mark(f"f32 d{d}")
    return out


# The head sizes besides the default one (d 16) whose f32 K2 runs on the
# warpgroup bodies: the low-end, mid-range and H100-tier widths.
TF32_WIDE = (32, 48, 64)
# The short rows at which phases 4 and 7 time each f32 warpgroup body
# against the body it replaced, which set TF32_WGMMA_MIN_ROWS[d] and
# TF32_WGMMA_BWD_MIN_ROWS[d]: the windowed fold's 256, and at d 32 the two
# either side of its threshold of 2048 (its other N 512 and 4096 read as
# their neighbours in earlier runs, PERF.md).
SHORT_ROWS_TF32 = {16: (256, 512, 1024, 2048, 4096), 32: (256, 1024, 2048),
                   48: (256, 512, 1024, 4096), 64: (256, 512, 1024, 4096)}
SHORT_ROWS_TF32_BWD = {16: (1024, 2048, 4096), 32: (256, 1024, 2048),
                       48: (256, 1024, 4096), 64: (256, 1024, 4096)}


def tf32_split_check(torch, k2, g, dev, smi, d: int = 16) -> dict:
    """The f32 warpgroup bodies' pre-pass at head size d against its plain
    twin, bit for bit, in each mode (the forward's at B8 H8 N16384, the
    backward's at a ragged B2 H8 N2100), and its time beside the twin's and
    its bound: it reads K and V once and writes each as TF32 hi and lo."""
    b, h, n = 8, 8, 16384
    k, v = (torch.randn(b, h, n, d, generator=g, device=dev)
            for _ in range(2))
    got = k2.tf32_tiles(k2.TF32_FWD, k, v)
    want = k2.tf32_tiles_plain(k2.TF32_FWD, k, v)
    torch.cuda.synchronize()
    same = torch.equal(got.view(torch.int32), want.view(torch.int32))
    q, do = (torch.randn(2, 8, 2100, d, generator=g, device=dev)
             for _ in range(2))
    lse = torch.randn(16, 2100, generator=g, device=dev)
    delta = torch.randn(2, 8, 2100, generator=g, device=dev)
    for mode, args in ((k2.TF32_BWD_Q, (q, do, lse, delta)),
                       (k2.TF32_BWD_K, (q, do))):
        a = k2.tf32_tiles(mode, *args, scale=0.25)
        w = k2.tf32_tiles_plain(mode, *args, scale=0.25)
        same = same and torch.equal(a.view(torch.int32), w.view(torch.int32))
    del want, a, w
    ms = time_ms(torch, lambda: k2.tf32_tiles(k2.TF32_FWD, k, v), 10)
    plain = time_ms(torch, lambda: k2.tf32_tiles_plain(k2.TF32_FWD, k, v), 2)
    bd = bound(0, nbytes(k, v, got), "f32")
    log(f"[K2] f32 pre-pass (tf32_tiles) B{b} H{h} N{n} d{d}: bit-equal with "
        f"its plain twin in every mode {same}; {ms:.3f} ms, plain {plain:.1f} "
        f"ms, bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
        f"({bd['bound_ms'] / ms:.1%} of it) on {smi}")
    if not same:
        raise AssertionError(f"the f32 pre-pass differs from its plain twin "
                             f"at d {d}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain, **bd,
            "library_ms": None,
            "shape": f"B{b} H{h} N{n} d{d}, forward mode"}


def tf32_fwd_mask_positions(torch, k2, dev, d: int) -> int:
    """The f32 warpgroup forward's dropout mask at head size d, position by
    position, is the hash: with q = k = 0 and a zero bias every score is 0,
    so with v the identity on keys k0 .. k0 + d - 1 (zeros elsewhere)
    o[q, j] is non-zero where the mask keeps key k0 + j for query q. Two
    shapes (one ragged, at a q_offset and a row_offset), five d-wide
    windows; returns the positions held."""
    b, h, rate, seed, held = 2, 2, 0.3, 123, 0
    for nq, nk, q_offset, row_offset in ((512, 512, 0, 0), (200, 300, 70, 3)):
        q = torch.zeros(b, h, nq, d, device=dev)
        k = torch.zeros(b, h, nk, d, device=dev)
        bias = torch.zeros(h, nk, device=dev)
        rs = k2.row_seeds(seed, b * h, row_offset, dev).reshape(b, h, 1, 1)
        keep = k2.keep_mask(rs, torch.arange(nk, device=dev),
                            torch.arange(q_offset, q_offset + nq,
                                         device=dev)[:, None],
                            k2.dropout_threshold(1.0 - rate))
        for k0 in (0, 8, 56, 121, nk - d):
            v = torch.zeros(b, h, nk, d, device=dev)
            v[:, :, k0:k0 + d] = torch.eye(d, device=dev)
            o, _ = k2.forward_kernel(q, k, v, bias, dropout_rate=rate,
                                     seed=seed, q_offset=q_offset,
                                     row_offset=row_offset, body="wgmma")
            if not torch.equal(o != 0, keep[:, :, :, k0:k0 + d]):
                raise AssertionError(f"K2 f32 warpgroup d{d}: o's mask at "
                                     f"keys {k0}.. is not the hash")
            held += o.numel()
    log(f"[K2] f32 warpgroup forward d{d} dropout {rate}: the mask position "
        f"by position is the hash ({held} positions)")
    return held


def check_tf32_fwd(torch, k2, g, dev, smi, d: int = 16) -> dict:
    """Phase 4's readings of the f32 warpgroup forward at head size d (16,
    32, 48, 64; three TF32 passes on wgmma) against flash_fwd_tf32
    (mma.sync), the body it replaced at long rows. Each shape: both held to
    the plain version at f32's bars (o 1e-5, lse 1e-4), then timed in turns
    (mma, wgmma, wgmma, mma). At N16384 (B8 and B16, dropout 0 and 0.1) the
    new one must be faster, and is logged beside SDPA in f32, the plain
    version (B8, dropout 0), the three-pass bound and the special-function
    floor with both shares. Then a ragged N, a CP shard at q_offset 8192
    and the short rows (SHORT_ROWS_TF32[d]), whose turns set
    TF32_WGMMA_MIN_ROWS[d] (past d 16 fewer repetitions and SDPA at B8
    only; at d 32 B8 alone, the serving batch); and the mask position by
    position."""
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    out = {"pre-pass": tf32_split_check(torch, k2, g, dev, smi, d)}
    worst = 0.0
    shapes = [("B8", 8, 16384, 16384, 0, 0.0), ("B8", 8, 16384, 16384, 0, 0.1)]
    if d != 32:
        shapes += [("B16", 16, 16384, 16384, 0, 0.0),
                   ("B16", 16, 16384, 16384, 0, 0.1)]
    shapes += [("ragged", 4, 2100, 2100, 0, 0.1),
               ("CP q shard", 2, 8192, 16384, 8192, 0.1)]
    shapes += [(f"short rows N{n}", 64 if n < 2048 else 16, n, n, 0, 0.1)
               for n in SHORT_ROWS_TF32[d]]
    for label, b, nq, nk, q_offset, rate in shapes:
        q = torch.randn(b, 8, nq, d, generator=g, device=dev)
        k, v = (torch.randn(b, 8, nk, d, generator=g, device=dev)
                for _ in range(2))
        bias = 0.5 * torch.randn(8, nk, generator=g, device=dev)
        kw = dict(dropout_rate=rate, seed=-1234567, q_offset=q_offset)
        tag = f"{label} H8 {nq}x{nk} q_offset {q_offset} d{d} f32 dropout {rate}"
        ro, rlse = k2.attention_plain(q, k, v, bias, **kw)
        line = []
        for body in ("mma", "wgmma"):
            seen = k2.tf32_wgmma_launches
            o, lse = k2.forward_kernel(q, k, v, bias, body=body, **kw)
            torch.cuda.synchronize()
            err = (o - ro).abs().max().item()
            lse_err = (lse - rlse).abs().max().item()
            if body == "wgmma":
                worst = max(worst, err)
                if k2.tf32_wgmma_launches != seen + 1:
                    raise AssertionError(f"K2 at {tag}: the f32 warpgroup "
                                         "body was not counted")
            line.append(f"{body} max_abs_err {err:.2e} lse_err {lse_err:.1e}")
            if err > 1e-5 or lse_err > 1e-4:
                raise AssertionError(f"K2 f32 {body} disagrees with the plain "
                                     f"version at {tag}")
        log(f"[K2] {tag}: " + ", ".join(line) + " (bars 1e-5, 1e-4)")
        default = k2.forward_instance(torch.float32, d, nq, nk, rate).body
        big = nq * nk * b > 2**31
        # Past d 16 fewer repetitions (the run's time limit), and SDPA at B8
        # only.
        reps = (5 if big else 10) if d == 16 else (3 if big else 5)
        run = lambda body: time_ms(torch, lambda: k2.forward_kernel(
            q, k, v, bias, body=body, **kw), reps)
        r = narrow_turns(torch, run, default, f"[K2] {tag}", smi,
                         new="f32 warpgroup (wgmma)")
        if nq == nk == 16384:
            if r["faster"] != "wgmma":
                raise AssertionError(f"K2 at {tag}: the f32 warpgroup body is "
                                     "no faster than the mma.sync one")
            lib, note = (sdpa_ms(q, k, v, bias, dropout_p=rate, reps=3)
                         if d == 16 or label == "B8" else (None, "not timed"))
            bd = bounds_tf32_k2(4 * b * 8 * nq * nk * d,
                                nbytes(q, k, v, bias, o, lse), b * 8 * nq * nk)
            t_p = (time_ms(torch, lambda: k2.attention_plain(q, k, v, bias,
                                                             **kw), 1)
                   if label == "B8" and rate == 0.0 else None)
            r |= {"library_ms": lib, "plain_ms": t_p, **bd}
            log(f"[K2] {tag}: f32 warpgroup {r['ms']:.3f} ms (mma.sync "
                f"{r['earlier_ms']:.3f}), F.scaled_dot_product_attention "
                f"{lib} ms ({note}), plain {t_p} ms; three-pass bound "
                f"{bd['bound_ms']:.3f} ms by {bd['bound_by']} "
                f"({bd['bound_ms'] / r['ms']:.1%} of it), special-function "
                f"floor {bd['bound_ms_sfu']:.3f} ms "
                f"({bd['bound_ms_sfu'] / r['ms']:.1%} of it) on {smi}")
        out[f"{label} dropout {rate}"] = r
        del q, k, v, bias, ro, rlse, o, lse
    out["max_abs_err"] = worst
    out["mask"] = tf32_fwd_mask_positions(torch, k2, dev, d)
    return out


def narrow_turns(torch, run, default, what, smi,
                 new: str = "narrow (wgmma)", earlier: str = "mma",
                 body: str = "wgmma") -> dict:
    """run(body) for a warpgroup body (`body`: "wgmma", the narrow one
    unless `new` says otherwise, or "window") and the body it replaced
    (`earlier`: mma.sync, or "simt", the CUDA cores) in turns (earlier,
    body, body, earlier): the better of each pair, which one the dispatch
    rule picks at this shape (`default`) and which one was faster."""
    t = [run(earlier), run(body), run(body), run(earlier)]
    label, name = new, {"mma": "mma.sync", "simt": "CUDA cores"}[earlier]
    new, old = min(t[1:3]), min(t[0], t[3])
    faster = body if new < old else earlier
    log(f"{what}: {name} {t[0]:.3f}, {label} {t[1]:.3f}, "
        f"{t[2]:.3f}, {name} {t[3]:.3f} ms on {smi}; faster in turns: "
        f"{faster}, the rule takes {default}")
    return {"ms": new, "earlier_ms": old, "faster": faster,
            "default": default}


# The short rows of the narrow bodies' paths: the windowed fold (B16 H8
# N16384 W256 folded: [16, 512, 256, d]) and a context-parallel q shard (B2
# H8, rows 8192.. of 16384 at q_offset 8192, against all 16384 keys); at d
# 32 also N 512 to 4096 at about as many scores, which set NARROW_MIN_ROWS[32].
SHORT_ROWS = {16: (("window fold", 16, 512, 256, 256, 0),
                   ("CP q shard", 2, 8, 8192, 16384, 8192)),
              32: (("window fold", 16, 512, 256, 256, 0),
                   ("CP q shard", 2, 8, 8192, 16384, 8192),
                   ("N512", 512, 8, 512, 512, 0), ("N1024", 256, 8, 1024, 1024, 0),
                   ("N2048", 64, 8, 2048, 2048, 0), ("N4096", 16, 8, 4096, 4096, 0))}


def narrow_short_rows(torch, k2, g, dev, smi, d: int) -> dict:
    """The narrow forward at head size d at SHORT_ROWS[d], against the
    mma.sync body in turns; the narrow body first held element by element
    against the plain version's online form at its key tile (the mask bit
    for bit with it), dropout 0.1."""
    out = {}
    for label, b, h, nq, nk, q_offset in SHORT_ROWS[d]:
        q = torch.randn(b, h, nq, d, generator=g, device=dev).bfloat16()
        k, v = (torch.randn(b, h, nk, d, generator=g, device=dev).bfloat16()
                for _ in range(2))
        bias = 0.5 * torch.randn(h, nk, generator=g, device=dev)
        kw = dict(dropout_rate=0.1, seed=-1234567, q_offset=q_offset)
        tag = (f"{label} B{b} H{h} {nq}x{nk} q_offset {q_offset} d{d} bf16 "
               "dropout 0.1")
        inst = k2.forward_instance(torch.bfloat16, d, nq, nk, 0.1, "wgmma")
        o, lse = k2.forward_kernel(q, k, v, bias, body="wgmma", **kw)
        oo, olse = k2.attention_plain(q, k, v, bias, block_k=inst.block_k,
                                      **kw)
        agree, excess, differ = k2_bf16_agree(torch, o, oo, "wgmma")
        lse_err = (lse - olse).abs().max().item()
        log(f"[K2] {tag}: the narrow body against the online form: over 2 "
            f"ulps by {max(excess, 0):.1e} of the largest, {differ:.1e} "
            f"differ, lse_err {lse_err:.1e}")
        if not (agree and lse_err <= 1e-4):
            raise AssertionError(f"K2 narrow body disagrees at {tag}")
        del o, lse, oo, olse
        default = k2.forward_instance(torch.bfloat16, d, nq, nk, 0.1).body
        run = lambda body: time_ms(torch, lambda: k2.forward_kernel(
            q, k, v, bias, body=body, **kw), 10)
        out[label] = narrow_turns(torch, run, default, f"[K2] {tag}", smi)
        del q, k, v, bias
    return out


def check_k2_shard(torch, k2, g, dev) -> dict:
    """The warpgroup forward on a q shard (rows 2048.. of N 4096 at
    q_offset 2048: the context-parallel call), dropout 0.1, element by
    element against the plain version's online form on the same shard."""
    worst = {}
    for d in (48, 64):
        q, k, v = (torch.randn(2, 8, 4096, d, generator=g, device=dev)
                   .bfloat16() for _ in range(3))
        bias = 0.5 * torch.randn(8, 4096, generator=g, device=dev)
        kw = dict(dropout_rate=0.1, seed=-1234567, q_offset=2048)
        qs = q[:, :, 2048:].contiguous()
        inst = k2.forward_instance(torch.bfloat16, d, 2048, 4096, 0.1)
        o, lse = k2.flash_attention(qs, k, v, bias, **kw)
        oo, olse = k2.attention_plain(qs, k, v, bias, block_k=inst.block_k,
                                      **kw)
        agree, excess, differ = k2_bf16_agree(torch, o, oo, inst.body)
        lse_err = (lse - olse).abs().max().item()
        log(f"[K2] q shard at q_offset 2048, B2 H8 2048x4096 d{d} bf16 "
            f"dropout 0.1 ({inst.body}): over 2 ulps by {max(excess, 0):.1e} "
            f"of the largest, {differ:.1e} differ, lse_err {lse_err:.1e}")
        if not (agree and lse_err <= 1e-4):
            raise AssertionError(f"K2 {inst.body} d{d}: the q shard differs")
        worst[d] = (o.float() - oo.float()).abs().max().item()
    return worst


def wgmma_turns(q, k, v, bias, kw, t_k, err, tag, online=None) -> dict:
    """The warpgroup forward at the teacher's N (B8, bf16) against the
    tensor-core body it replaced, in turns (earlier, new, new, earlier),
    beside SDPA (its own dropout masks at the same rate), the plain version
    and the bound: 4 B H N^2 d operations, the inputs and outputs once.
    The earlier body is first held element by element against the plain
    version's online form at its own key tile, as the new one is (`online`:
    that form at the new body's tile, reused where the tiles are one). The new
    one must be faster at d 48 and 64; at d 16 the faster one is logged."""
    import torch
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    b, h, n, d = q.shape
    inst_body = k2.forward_instance(q.dtype, d, n, n, kw["dropout_rate"]).body
    old = k2.forward_instance(q.dtype, d, n, n, kw["dropout_rate"], "mma")
    new_tile = k2.forward_instance(q.dtype, d, n, n, kw["dropout_rate"]).block_k
    o, lse = k2.forward_kernel(q, k, v, bias, body=old.body, **kw)
    oo, olse = (online if online is not None and old.block_k == new_tile
                else k2.attention_plain(q, k, v, bias, block_k=old.block_k,
                                        **kw))
    del online
    agree, excess, differ = k2_bf16_agree(torch, o, oo, old.body)
    lse_err = (lse - olse).abs().max().item()
    log(f"[K2] {tag}: the earlier body ({old.body}, keys in tiles of "
        f"{old.block_k}) against the online form: over 2 ulps by "
        f"{max(excess, 0):.1e} of the largest (bar "
        f"{K2_BF16_BAR[old.body][0]:.0e}), {differ:.1e} differ (bar "
        f"{K2_BF16_BAR[old.body][1]:.0e}), lse_err {lse_err:.1e}")
    if not (agree and lse_err <= 1e-4):
        raise AssertionError(f"K2 at {tag}: the earlier body {old.body} "
                             "disagrees with its plain version")
    del o, lse, oo, olse
    run = lambda body: time_ms(torch, lambda: k2.forward_kernel(
        q, k, v, bias, body=body, **kw), 3)
    t = [run("mma"), run("wgmma"), run("wgmma"), run("mma")]
    lib, lib_note = sdpa_ms(q, k, v, bias, dropout_p=kw["dropout_rate"],
                            reps=3)
    o, lse = k2.forward_kernel(q, k, v, bias, **kw)
    bd = bounds_k2(4 * b * h * n * n * d, nbytes(q, k, v, bias, o, lse),
                   b * h * n * n)
    t_p = (time_ms(torch, lambda: k2.attention_plain(q, k, v, bias, **kw), 1)
           if kw["dropout_rate"] == 0.0 else None)
    new = min(t[1:3])
    log(f"[K2] {tag}: earlier (mma.sync) {t[0]:.3f}, new (wgmma) {t[1]:.3f}, "
        f"new {t[2]:.3f}, earlier {t[3]:.3f} ms; F.scaled_dot_product_"
        f"attention {lib} ms ({lib_note}); bound {bd['bound_ms']:.3f} ms by "
        f"{bd['bound_by']} ({bd['bound_ms'] / new:.1%} of it), "
        f"special-function floor {bd['bound_ms_sfu']:.3f} ms "
        f"({bd['bound_ms_sfu'] / new:.1%} of it)"
        + (f"; plain {t_p:.1f} ms" if t_p else ""))
    # The narrow body at d 16 and dropout 0 is within a few per cent of
    # mma.sync (PERF.md section 6): its turns are read, not held; at d 32
    # it is held, as at d 48 and 64.
    faster = "wgmma" if new < min(t[0], t[3]) else "mma"
    log(f"[K2] {tag}: faster in turns: {faster}, the rule takes {inst_body}")
    if faster != "wgmma" and d != 16:
        raise AssertionError(f"K2 at {tag}: the warpgroup body is no faster "
                             "than the tensor-core body it replaced")
    return {"ms": new, "call_ms": t_k, "earlier_ms": min(t[0], t[3]),
            "faster": faster,
            "library_ms": lib, "plain_ms": t_p, "max_abs_err": err, **bd}


def save_checkpoint(torch, cfg, path: Path, seed: int) -> None:
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    g = torch.Generator().manual_seed(seed)
    vae = LunarisCoreVAE(cfg.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(cfg.teacher_config())
    teacher.reset_parameters(g)
    torch.save({"vae_state_dict": vae.state_dict(),
                "teacher_state_dict": teacher.state_dict(),
                "args": cfg.to_dict(), "global_step": 0}, path)


def run_slice(torch, tmp: Path, smi: str) -> dict:
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.cli import generate as cli
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1

    cfg = TrainConfig()                        # 128 px, full default width
    ckpt = tmp / "full.pt"
    save_checkpoint(torch, cfg, ckpt, seed=0)
    k1.launches = 0
    k2.launches = 0
    for mode in ([], ["--bf16"]):
        out_dir = tmp / ("gen_bf16" if mode else "gen_f32")
        t0 = time.perf_counter()
        rc = cli.main(["--checkpoint", str(ckpt), "--device", "cuda",
                       "--num_samples", "8", "--max_attempts", "2",
                       "--seed", "0", "--output_dir", str(out_dir)] + mode)
        torch.cuda.synchronize()
        meta = json.loads(next(out_dir.glob("metadata_*.json")).read_text())
        pngs = list(out_dir.glob("sample_*.png"))
        if rc != 0 or len(pngs) != 8 or not list(out_dir.glob("grid_*.png")):
            raise AssertionError(f"generate {mode}: rc {rc}, {len(pngs)} PNGs")
        q = [m["quality"] for m in meta["samples"]]
        if not all(0.0 <= x <= 1.0 for x in q):
            raise AssertionError(f"generate {mode}: qualities {q}")
        log(f"[slice] generate {mode or ['f32']}: {len(pngs)} sprites in "
            f"{time.perf_counter() - t0:.1f} s, quality {min(q):.4f}.."
            f"{max(q):.4f}")
    launches = {"gn_mish": k1.launches, "flash_attention_fwd": k2.launches}
    log(f"[slice] kernel launches in the generate runs: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")

    z = torch.randn(8, cfg.latent_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    for bf16 in (False, True):
        gen = ImageGenerator(str(ckpt), device="cuda", bf16=bf16)
        seen = (k1.launches, k2.launches)
        imgs, quality, sem = gen.decode_and_score(z)
        per_call = (k1.launches - seen[0], k2.launches - seen[1])
        if imgs.shape != (8, 128, 128, 3) or not (
                torch.isfinite(imgs).all() and torch.isfinite(quality).all()
                and torch.isfinite(sem).all()):
            raise AssertionError(f"decode+score bf16={bf16}: non-finite or "
                                 f"shape {tuple(imgs.shape)}")
        ms = time_ms(torch, lambda: gen.decode_and_score(z), 3)
        log(f"[slice] decode+score batch 8 {'bf16' if bf16 else 'f32'}: "
            f"{ms:.1f} ms = {8 / ms * 1e3:.2f} sprites/s on {smi}; launches "
            f"a call: K1 {per_call[0]}, K2 fwd {per_call[1]}")
        tag = f"decode+score batch 8 {'bf16' if bf16 else 'f32'}"
        names = {}
        narrow, tf32 = k2.narrow_launches, k2.tf32_wgmma_launches
        _, _, k1_kernels, _ = device_share(
            torch, lambda: gen.decode_and_score(z), tag, smi, k2_names=names)
        check_k1_kernels(k1_kernels, per_call[0], tag)
        narrow = k2.narrow_launches - narrow
        tf32 = k2.tf32_wgmma_launches - tf32
        check_narrow_names(names, narrow, 0, tag)
        # f32 at the teacher's N16384: every K2 call on the f32 warpgroup
        # body, by the wrappers' counts and by name.
        check_narrow_names(names, tf32, 0, tag, "f32 warpgroup",
                           every=not bf16)
        key, body, n = (("narrow_decode", "narrow", narrow) if bf16 else
                        ("tf32_decode", "f32 warpgroup", tf32))
        launches[key] = n
        if n != per_call[1]:
            raise AssertionError(f"{tag}: {n} of the {per_call[1]} K2 "
                                 f"forward calls took the {body} body")
    return launches


def profiler_loss(torch, rounds: int, smi: str) -> int:
    """torch.profiler's lost records by the age of the process: `rounds`
    times, a minute apart, phase 20's bf16 decode+score (the H100 recipe,
    batch 8) is profiled in a session that starts with no spin kernels and
    in one that starts with LEAD_IN of them (`profiled`), and the kernel
    records each kept are logged beside the first session's."""
    from torch.autograd import DeviceType
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1

    build()
    cfg = TrainConfig(**RECIPE_H100)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "recipe.pt"
        save_checkpoint(torch, cfg, ckpt, seed=0)
        gen = ImageGenerator(str(ckpt), device="cuda", bf16=True)
    z = torch.randn(8, cfg.latent_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    gen.decode_and_score(z)
    first = None
    for i in range(rounds):
        if i:
            time.sleep(60)
        kept = []
        for lead in (0, LEAD_IN):
            seen = k1.launches
            with profiled(torch, lead=lead) as p:
                gen.decode_and_score(z)
            names = [e.name for e in p.events()
                     if e.device_type == DeviceType.CUDA and not lead_in(e.name)]
            ones = sum(any(k in n for k in K1_KERNELS) for n in names)
            kept.append(f"{len(names)} kernel records, K1 {ones} of "
                        f"{2 * (k1.launches - seen)}")
            first = first or len(names)
        log(f"[profiler] {time.perf_counter() - T_START:.0f} s into the "
            f"process (the first session kept {first}): no spin kernels at "
            f"the head {kept[0]}; {LEAD_IN} spin kernels {kept[1]}, on {smi}")
    return 0


# Phase 6's widths: 64 px, 2 experts, 8 heads: N = 4096 > 1024 runs K2 at
# head size feature_dim / 8 (64: d 8; 128: d 16, the default width, and
# 256: d 32, the low-end recipe's width, on the f32 warpgroup bodies).
CONTEXT_WIDTHS = (64, 128, 256)
CONTEXT_LATENT = 64


def _context_cfg(feature_dim: int):
    from lunaris_orion_tpu_torch import TrainConfig
    return TrainConfig(image_size=64, latent_dim=CONTEXT_LATENT,
                       feature_dim=feature_dim, embedding_dim=32,
                       num_experts=2)


def _context_decode(torch, ckpt: Path, dev: str):
    """Phase 6's decode+score of one z from `ckpt` on `dev`, TF32 off (the
    generator's f32 mode turns it off too: cuDNN's default TF32
    convolutions would break both bars): (images, quality) on the CPU."""
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator, full_f32
    z = torch.randn(2, CONTEXT_LATENT,
                    generator=torch.Generator().manual_seed(2))
    with full_f32():
        gen = ImageGenerator(str(ckpt), device=dev)
        imgs, quality, _ = gen.decode_and_score(z.to(dev))
    return imgs.cpu(), quality.cpu()


def _cpu_context_refs(tmp: str) -> None:
    """Phase 6's CPU side in a process of its own (four threads), which
    `main` starts after phase 3 so that it runs under phase 4:
    each width's seeded checkpoint tmp/ctx<feature_dim>.pt and its CPU
    decode+score, saved to tmp/ctx_refs.pt."""
    import torch
    torch.set_num_threads(4)
    refs = {}
    for feature_dim in CONTEXT_WIDTHS:
        ckpt = Path(tmp) / f"ctx{feature_dim}.pt"
        save_checkpoint(torch, _context_cfg(feature_dim), ckpt, seed=1)
        refs[feature_dim] = _context_decode(torch, ckpt, "cpu")
    torch.save(refs, Path(tmp) / "ctx_refs.pt")


def run_context(torch, tmp: Path, feature_dim: int, ref: tuple) -> None:
    """Phase 6 at one width: the card's decode+score (the kernels) against
    the CPU's (`ref`, the plain versions, from `_cpu_context_refs` on the
    same checkpoint in `tmp`)."""
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    seen = (k2.launches, k2.tf32_wgmma_launches)
    res = {"cpu": ref,
           "cuda": _context_decode(torch, tmp / f"ctx{feature_dim}.pt",
                                   "cuda")}
    calls = (k2.launches - seen[0], k2.tf32_wgmma_launches - seen[1])
    d_img = (res["cpu"][0] - res["cuda"][0]).abs().max().item()
    d_q = (res["cpu"][1] - res["cuda"][1]).abs().max().item()
    log(f"[context] 64 px, feature_dim {feature_dim} (d {feature_dim // 8}), "
        f"TF32 off, CPU plain vs card kernels: decode max diff {d_img:.3e} "
        f"(bar {1 / 255:.3e}), quality max diff {d_q:.3e} (bar 1e-3); K2 "
        f"calls {calls[0]}, on the f32 warpgroup body {calls[1]}")
    if feature_dim // 8 in k2.TF32_WGMMA_HEAD_DIMS and not (
            0 < calls[0] == calls[1]):
        raise AssertionError(f"context d {feature_dim // 8}: K2 calls "
                             f"{calls} off the f32 warpgroup body")
    if d_img > 1 / 255 or d_q > 1e-3:
        raise AssertionError("kernels in context disagree with the CPU run "
                             f"at feature_dim {feature_dim}")


BWD_ERR = ("dq", "dk", "dv", "dbias")


# The bf16 bar of the K2 backward, element by element against the plain
# backward (which rounds ds and the dropped p to bf16 where the kernels do and
# sums in f32): 2 bf16 ulps of the element's own reference for the last
# rounding, plus 1e-3 of the largest gradient, and a ceiling on the share of
# elements that differ at all. The earlier bar, 2 ulps of the largest
# (1.6e-2 of it), would pass one misplaced term of an N-term sum. A score that
# differs in its last f32 bits can round ds or p the other way in bf16 and
# move a sum by 2^-8 of one term: that one flipped term is what the 1e-3
# allows on either body (measured on an H100: 8e-5 on the CUDA cores, in the
# fused dq at d 64, whose four threads a row sum in another order; 4.6e-4 on
# the tensor cores, whose sums truncate and whose exp is ex2.approx). The
# ceiling tells the bodies apart: 1 element in 100 on the CUDA cores
# (measured: 1 in 500), 5 in 100 on the tensor cores (measured: 1 in 1000 at
# N 256, 2 in 100 at N 16384, where more terms can flip). A term in the wrong
# place moves an element by a tenth of the largest or more, a wrong mask
# every element. The fused warpgroup bodies (wgmma) and the window body have
# the tensor cores' bar.
K2_BWD_BF16_BAR = {"simt": (1e-3, 1e-2), "mma": (1e-3, 5e-2),
                   "wgmma": (1e-3, 5e-2), "window": (1e-3, 5e-2)}


def bwd_agree(torch, got, ref, dtype, name, body):
    """(ok, max abs error, what was held) of one gradient against the plain
    backward. f32, and dbias in both types: 1e-4 of the largest magnitude
    (sums of up to N terms in other orders, the fused dq's atomics in any
    order). bf16: K2_BWD_BF16_BAR, element by element."""
    ref = ref.float()
    each = (got.float() - ref).abs()
    err, top = each.max().item(), ref.abs().max().item()
    if dtype == torch.float32 or name == "dbias":
        tol = 1e-4 * top + 1e-6
        return err <= tol, err, f"{err:.2e}/{tol:.1e}"
    share, ceiling = K2_BWD_BF16_BAR[body]
    excess = (each - 2 * bf16_ulp(torch, ref)).max().item() / top
    differ = (each > 0).float().mean().item()
    return (excess <= share and differ <= ceiling, err,
            f"{err:.2e} (+{max(excess, 0):.1e}/{share:.0e}, "
            f"{differ:.1e}/{ceiling:.0e} differ)")


def check_k2_bwd(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    g = torch.Generator(device=dev).manual_seed(3)
    errs = {dt: {"fused": 0.0, "dkv": 0.0, "dq": 0.0, "wgmma": 0.0,
                 "narrow": 0.0, "narrow32": 0.0, "tf32": 0.0}
            for dt in (torch.float32, torch.bfloat16)}

    def inputs(b, h, nq, nk, d, dt, rate, q_offset=0):
        q = torch.randn(b, h, nq, d, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, h, nk, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        bias = 0.5 * torch.randn(h, nk, generator=g, device=dev)
        do = torch.randn(b, h, nq, d, generator=g, device=dev).to(dt)
        kw = dict(dropout_rate=rate, seed=-1234567, q_offset=q_offset)
        o, lse = k2.attention_plain(q, k, v, bias, **kw)
        return (q, k, v, bias, o, lse, do), kw

    def bodies(dt, d, nq, nk, rate):
        """The body each variant takes, by the instance rules."""
        return {"fused": k2.fused_instance(dt, d, nq, nk, rate).body,
                "split": k2.backward_instance(dt, d, nq, nk, rate).body}

    def agree(args, kw, ref, tag, keep):
        """Both variants against `ref`; the worst errors go to `errs` where
        `keep` says so."""
        q, k = args[0], args[1]
        dt, d, rate = q.dtype, q.shape[3], kw["dropout_rate"]
        body = bodies(dt, d, q.shape[2], k.shape[2], rate)
        line = []
        for variant in k2.BWD_VARIANTS:
            got = k2.flash_attention_bwd(*args, variant=variant, **kw)
            torch.cuda.synchronize()
            for name, a, r in zip(BWD_ERR, got, ref):
                ok, err, text = bwd_agree(torch, a, r, dt, name, body[variant])
                line.append(f"{variant}.{name} {text}")
                if not ok:
                    raise AssertionError(
                        f"K2 bwd {variant} ({body[variant]}) {name} disagrees "
                        f"with the plain version at {tag}: {text}")
                if keep:
                    key = ("fused" if variant == "fused" else
                           "dq" if name == "dq" else "dkv")
                    errs[dt][key] = max(errs[dt][key], err)
                if body[variant] == "wgmma" and variant == "fused":
                    key = ("tf32" if dt == torch.float32 else "narrow"
                           if d == 16 else "narrow32" if d == 32 else "wgmma")
                    errs[dt][key] = max(errs[dt][key], err)
            del got
        log(f"[K2 bwd] {tag} (fused: {body['fused']}, split: "
            f"{body['split']}): " + ", ".join(line))

    def in_turns(run, earlier, new, what):
        """Times of run(earlier), run(new), run(new), run(earlier): the
        better of each pair."""
        t = [run(earlier), run(new), run(new), run(earlier)]
        log(f"[K2 bwd] {what}: {earlier} {t[0]:.3f}, {new} {t[1]:.3f}, {new} "
            f"{t[2]:.3f}, {earlier} {t[3]:.3f} ms on {smi}")
        return min(t[1:3]), min(t[0], t[3])

    def variant_ms(args, kw):
        return lambda name: time_ms(torch, lambda: k2.flash_attention_bwd(
            *args, variant=name, **kw), 3)

    def fused_kernel(args, kw, body):
        """The fused kernel of `body` alone; (dq, dk, dv, dbias) as
        flash_attention_bwd assembles them."""
        q, k, v, bias, o, lse, do = args
        b, h, nq, d = q.shape
        delta = (o.float() * do.float()).sum(-1)
        out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                   dbias_bh=torch.empty(b * h, k.shape[2], device=dev),
                   dq_acc=torch.zeros(b, h, nq, d, device=dev))
        k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta,
                             **out, body=body, **kw)
        scale = torch.tensor(d ** -0.5, dtype=q.dtype, device=dev)
        return (out["dq_acc"].to(q.dtype) * scale, out["dk"], out["dv"],
                out["dbias_bh"].reshape(b, h, -1).sum(dim=0))

    def kernel_ms(args, kw, reps):
        """ms of one fused kernel of a body, its outputs allocated once (the
        kernel adds into dq_acc without zeroing it: its time is the
        kernel's, the buffer's values are not read)."""
        q, k, v, bias, o, lse, do = args
        b, h, nq, d = q.shape
        delta = (o.float() * do.float()).sum(-1)
        out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                   dbias_bh=torch.empty(b * h, k.shape[2], device=dev),
                   dq_acc=torch.zeros(b, h, nq, d, device=dev))
        return lambda body: time_ms(torch, lambda: k2.launch_bwd_kernel(
            k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta, **out, body=body,
            **kw), reps[body])

    def moved(args, bh):
        q, k, v, bias, o, lse, do = args
        delta_bytes = q.numel() // q.shape[3] * 4
        return nbytes(q, k, v, bias, do, lse, q, k, v) + delta_bytes + bh * 4

    mark = stopwatch("phase 7")
    # Every head size in both types; at N 4096 the two variants are also
    # timed in turns, which is what `default_bwd` follows at the head sizes
    # that the teacher's shape below does not time.
    cases = [(2, 8, 16384, 16384, 16, dt, rate)
             for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases += [(2, 8, 4096, 4096, d, dt, 0.1) for dt in (torch.float32,
                                                         torch.bfloat16)
              for d in (8, 32, 48, 64)]
    cases += [(2, 8, 2000, 300, 16, torch.bfloat16, 0.1),
              (2, 8, 300, 2000, 16, torch.bfloat16, 0.0),
              (2, 8, 2000, 300, 16, torch.float32, 0.1),
              (2, 8, 300, 2000, 32, torch.float32, 0.0),
              (2, 8, 2000, 300, 64, torch.bfloat16, 0.1),
              (2, 8, 300, 2000, 48, torch.bfloat16, 0.0)]
    for b, h, nq, nk, d, dt, rate in cases:
        args, kw = inputs(b, h, nq, nk, d, dt, rate)
        tag = f"B{b} H{h} {nq}x{nk} d{d} {str(dt)[6:]} dropout {rate}"
        agree(args, kw, k2.attention_bwd_plain(*args, **kw), tag,
              nq == 16384 and rate == 0.0)
        if nq == nk == 4096:
            fused_ms, split_ms = in_turns(variant_ms(args, kw), "split",
                                          "fused", f"{tag} flash_attention_bwd")
            log(f"[K2 bwd] {tag}: faster in turns "
                f"{'fused' if fused_ms < split_ms else 'split'}, the default "
                f"is {k2.default_bwd(dt, d)}")

    # A q shard at q_offset (the context-parallel call): its dq rows are the
    # full call's, with the same dropout masks.
    for dt, d in ((torch.float32, 16), (torch.bfloat16, 16),
                  (torch.float32, 32), (torch.bfloat16, 48),
                  (torch.bfloat16, 64)):
        args, kw = inputs(2, 8, 4096, 4096, d, dt, 0.1)
        q, k, v, bias, o, lse, do = args
        sl = slice(2048, None)
        body = bodies(dt, d, 2048, 4096, 0.1)
        for variant in k2.BWD_VARIANTS:
            full = k2.flash_attention_bwd(*args, variant=variant, **kw)
            qs, dos = q[:, :, sl].contiguous(), do[:, :, sl].contiguous()
            os_, lses = k2.attention_plain(qs, k, v, bias, dropout_rate=0.1,
                                           seed=-1234567, q_offset=2048)
            shard = k2.flash_attention_bwd(qs, k, v, bias, os_, lses, dos,
                                           variant=variant, dropout_rate=0.1,
                                           seed=-1234567, q_offset=2048)
            ok, _, text = bwd_agree(torch, shard[0], full[0][:, :, sl], dt,
                                    "dq", body[variant])
            log(f"[K2 bwd] q shard at q_offset 2048, {variant} "
                f"({body[variant]}) {str(dt)[6:]} d{d}: dq rows {text}")
            if not ok:
                raise AssertionError(f"K2 bwd {variant} {dt}: q_offset shard "
                                     "differs")

    mark("cases, q shards")
    # The teacher's training shape (B 16, dropout 0.1): both variants
    # against the plain backward, then times, each kernel alone as well.
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = inputs(16, 8, 16384, 16384, 16, dt, 0.1)
        q, k, v, bias, o, lse, do = args
        tag = f"B16 H8 N16384 d16 {str(dt)[6:]} dropout 0.1"
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref = k2.attention_bwd_plain(*args, **kw)
        end.record()
        end.synchronize()
        t = {"plain": start.elapsed_time(end)}
        agree(args, kw, ref, tag, True)
        del ref
        delta = (o.float() * do.float()).sum(-1)
        out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                   dbias_bh=torch.empty(128, 16384, device=dev),
                   dq_acc=torch.zeros(16, 8, 16384, 16, device=dev))
        dq = torch.empty_like(q)
        dkv = lambda body=None: time_ms(torch, lambda: k2.launch_bwd_kernel(
            k2.DKV, q, k, v, bias, do, lse, delta, dk=out["dk"], dv=out["dv"],
            dbias_bh=out["dbias_bh"], body=body, **kw), 3)
        dqk = lambda body=None: time_ms(torch, lambda: k2.launch_bwd_kernel(
            k2.DQ, q, k, v, bias, do, lse, delta, dq=dq, body=body, **kw), 3)
        # The fused kernel alone adds into dq_acc without zeroing it: its
        # time is the kernel's, the buffer's values are not read.
        fused = lambda body=None: time_ms(torch, lambda: k2.launch_bwd_kernel(
            k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta, **out, body=body,
            **kw), 3)
        t |= {"fused": fused(), "dkv": dkv(), "dq": dqk()}
        # The CUDA-core kernels that the tensor-core ones replaced, on the
        # same inputs, in turns: earlier, new, new, earlier. bf16: all
        # three; f32: the fused one (three TF32 passes).
        kernels = ((("fused", fused), ("dkv", dkv), ("dq", dqk))
                   if dt == torch.bfloat16 else (("fused", fused),))
        for name, run in kernels:
            t[name], t[name + "_earlier"] = in_turns(
                run, "simt", "mma", f"{tag} {name} kernel, CUDA cores "
                "(simt) against tensor cores (mma)")
            if t[name] >= t[name + "_earlier"]:
                raise AssertionError(
                    f"K2 bwd {name} at {tag}: the tensor-core kernel is "
                    "no faster than the one it replaced")
        # The two variants as flash_attention_bwd runs them (delta, buffers,
        # dq's rounding included), in turns.
        t["fused_call"], t["split"] = in_turns(
            variant_ms(args, kw), "split", "fused",
            f"{tag} flash_attention_bwd")
        t |= {"in_bytes": nbytes(q, k, v, bias, do, lse, delta),
              "dq_bytes": nbytes(dq),
              "dkv_bytes": nbytes(out["dk"], out["dv"], out["dbias_bh"])}
        del out, dq, delta
        t["sdpa_bwd"], note = sdpa_ms(q, k, v, bias, backward=True,
                                      dropout_p=0.1, reps=3)
        times[dt] = t
        log(f"[K2 bwd] {tag}: fused kernel {t['fused']:.1f} ms (call "
            f"{t['fused_call']:.1f}), split {t['split']:.1f} ms (dk/dv "
            f"{t['dkv']:.1f} + dq {t['dq']:.1f}), plain {t['plain']:.1f} ms, "
            f"backward of F.scaled_dot_product_attention {t['sdpa_bwd']} ms "
            f"({note}) on {smi}")
    f32, b16 = times[torch.float32], times[torch.bfloat16]
    for dt, t in times.items():
        log(f"[K2 bwd] {str(dt)[6:]} d16: faster in turns "
            f"{'fused' if t['fused_call'] < t['split'] else 'split'}, the "
            f"default is {k2.default_bwd(dt, 16)}")
    log(f"[K2 bwd] bf16 fused {b16['fused']:.1f} ms (earlier "
        f"{b16['fused_earlier']:.1f}), dk/dv + dq {b16['dkv'] + b16['dq']:.1f} "
        f"ms (earlier {b16['dkv_earlier'] + b16['dq_earlier']:.1f}) against "
        f"the library's backward {b16['sdpa_bwd']} ms")
    log(f"[K2 bwd] f32 fused {f32['fused']:.1f} ms (earlier "
        f"{f32['fused_earlier']:.1f}), dk/dv + dq {f32['dkv'] + f32['dq']:.1f} "
        f"ms against the library's backward {f32['sdpa_bwd']} ms")

    mark("B16 d16")
    # Head size 32 (feature_dim 256) at the serving batch: both variants in
    # turns beside the library's backward (correctness: the 4096 cases);
    # in f32 the fused kernel also against the CUDA-core one it replaced.
    d32 = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = inputs(8, 8, 16384, 16384, 32, dt, 0.1)
        tag = f"B8 H8 N16384 d32 {str(dt)[6:]} dropout 0.1"
        body = bodies(dt, 32, 16384, 16384, 0.1)
        fused_ms, split_ms = in_turns(variant_ms(args, kw), "split", "fused",
                                      f"{tag} flash_attention_bwd ({body})")
        lib, note = sdpa_ms(*args[:4], backward=True, dropout_p=0.1, reps=3)
        d32[dt] = {"fused": fused_ms, "split": split_ms, "sdpa": lib}
        if dt == torch.float32:
            q, k, v, bias, o, lse, do = args
            delta = (o.float() * do.float()).sum(-1)
            out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                       dbias_bh=torch.empty(64, 16384, device=dev),
                       dq_acc=torch.zeros(8, 8, 16384, 32, device=dev))
            kernel = lambda body: time_ms(torch, lambda: k2.launch_bwd_kernel(
                k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, delta, **out,
                body=body, **kw), 3)
            new, old = in_turns(kernel, "simt", "mma",
                                f"{tag} fused kernel, CUDA cores (simt) "
                                "against tensor cores (mma)")
            if new >= old:
                raise AssertionError(f"K2 bwd fused at {tag}: the tensor-core "
                                     "kernel is no faster than the one it "
                                     "replaced")
            d32[dt] |= {"kernel": new, "earlier": old}
            del q, k, v, bias, o, lse, do, delta, out
        log(f"[K2 bwd] {tag}: fused {fused_ms:.1f} ms, split {split_ms:.1f} "
            f"ms, backward of F.scaled_dot_product_attention {lib} ms "
            f"({note}) on {smi}; the default is {k2.default_bwd(dt, 32)}")
        del args
    mark("B8 d32")
    # bf16 at d 48 and 64 (the recipes): the fused warpgroup body at the
    # teacher's N. At B2, dropout 0.1: both variants and the CUDA-core fused
    # kernel the warpgroup body replaced against the plain backward, then
    # the two fused kernels in turns beside the plain version's time, SDPA's
    # backward and the bound. At the training batch, B16: the warpgroup
    # kernel, the two variants in turns, SDPA's backward and the bound.
    wg = {}

    for d in (48, 64):
        args, kw = inputs(2, 8, 16384, 16384, d, torch.bfloat16, 0.1)
        q, k, v, bias, o, lse, do = args
        tag = f"B2 H8 N16384 d{d} bf16 dropout 0.1"
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref = k2.attention_bwd_plain(*args, **kw)
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        agree(args, kw, ref, tag, False)
        earlier = fused_kernel(args, kw, "simt")
        torch.cuda.synchronize()
        line = []
        for name, a, r in zip(BWD_ERR, earlier, ref):
            ok, _, text = bwd_agree(torch, a, r, torch.bfloat16, name, "simt")
            line.append(f"{name} {text}")
            if not ok:
                raise AssertionError(f"K2 bwd: the CUDA-core fused kernel "
                                     f"(simt) {name} disagrees with the plain "
                                     f"version at {tag}: {text}")
        log(f"[K2 bwd] {tag}: the CUDA-core fused kernel it replaced (simt) "
            f"against the plain version: " + ", ".join(line))
        del ref, earlier
        new, old = in_turns(kernel_ms(args, kw, {"simt": 1, "wgmma": 3}),
                            "simt", "wgmma", f"{tag} fused kernel, CUDA cores "
                            "(simt) against warpgroup (wgmma)")
        if new >= old:
            raise AssertionError(f"K2 bwd fused at {tag}: the warpgroup body "
                                 "is no faster than the one it replaced")
        lib, note = sdpa_ms(q, k, v, bias, backward=True, dropout_p=0.1,
                            reps=3)
        bd = bounds_k2(10 * 2 * 8 * 16384 * 16384 * d,
                       moved(args, 16 * 16384), 2 * 8 * 16384 * 16384)
        wg[d] = {"shape": "B2 H8 N16384 dropout 0.1", "ms": new,
                 "earlier_ms": old, "plain_ms": plain_ms, "library_ms": lib,
                 **bd}
        log(f"[K2 bwd] {tag}: fused kernel {new:.2f} ms (CUDA-core fused "
            f"{old:.1f}), plain {plain_ms:.0f} ms, backward of "
            f"F.scaled_dot_product_attention {lib} ms ({note}); bound "
            f"{bd['bound_ms']:.2f} ms by {bd['bound_by']} "
            f"({bd['bound_ms'] / new:.1%} of it), special-function floor "
            f"{bd['bound_ms_sfu']:.2f} ms ({bd['bound_ms_sfu'] / new:.1%}) on "
            f"{smi}")
        del args, q, k, v, bias, o, lse, do
        args, kw = inputs(16, 8, 16384, 16384, d, torch.bfloat16, 0.1)
        q, k, v, bias, o, lse, do = args
        tag = f"B16 H8 N16384 d{d} bf16 dropout 0.1"
        body = bodies(torch.bfloat16, d, 16384, 16384, 0.1)
        new = kernel_ms(args, kw, {"wgmma": 3})("wgmma")
        fused_ms, split_ms = in_turns(variant_ms(args, kw), "split", "fused",
                                      f"{tag} flash_attention_bwd ({body})")
        lib, note = sdpa_ms(q, k, v, bias, backward=True, dropout_p=0.1,
                            reps=3)
        bd = bounds_k2(10 * 16 * 8 * 16384 * 16384 * d,
                       moved(args, 128 * 16384), 16 * 8 * 16384 * 16384)
        wg[d]["B16"] = {"ms": new, "fused_call_ms": fused_ms,
                        "split_ms": split_ms, "library_ms": lib, **bd}
        faster = "fused" if fused_ms < split_ms else "split"
        log(f"[K2 bwd] {tag}: fused kernel {new:.1f} ms, the call "
            f"{fused_ms:.1f} against split {split_ms:.1f} ms (faster in "
            f"turns: {faster}; the default is "
            f"{k2.default_bwd(torch.bfloat16, d)}), backward of "
            f"F.scaled_dot_product_attention {lib} ms ({note}); bound "
            f"{bd['bound_ms']:.2f} ms by {bd['bound_by']} "
            f"({bd['bound_ms'] / new:.1%} of it), special-function floor "
            f"{bd['bound_ms_sfu']:.2f} ms ({bd['bound_ms_sfu'] / new:.1%}) on "
            f"{smi}")
        del args, q, k, v, bias, o, lse, do
    mark("bf16 d48/64")
    # The worst errors of the warpgroup body: the B2 N16384 cases, every
    # shape at d 48 and 64 above (kept with `keep` there).
    wg["max_abs_err"] = errs[torch.bfloat16]["wgmma"]
    narrow = check_narrow_bwd(torch, k2, inputs, fused_kernel, kernel_ms,
                              moved, dev, smi, 16)
    narrow["max_abs_err"] = max(errs[torch.bfloat16]["narrow"],
                                narrow.pop("worst"))
    narrow32 = check_narrow_bwd(torch, k2, inputs, fused_kernel, kernel_ms,
                                moved, dev, smi, 32)
    narrow32["max_abs_err"] = max(errs[torch.bfloat16]["narrow32"],
                                  narrow32.pop("worst"))
    narrow32["mask"] = narrow_bwd_mask_positions(torch, k2, dev, 32)
    mark("narrow d16/32")
    tf32 = check_tf32_bwd(torch, k2, inputs, fused_kernel, kernel_ms, moved,
                          smi)
    tf32["max_abs_err"] = max(errs[torch.float32]["tf32"], tf32.pop("worst"))
    mark("f32 d16")
    # f32 at d 32, 48 and 64: the low-end, mid-range and H100-tier widths
    # in the CLIs' default precision, against the fused kernel each
    # replaced (mma.sync at d 32, the CUDA cores at 48 and 64).
    tf32_wide = {}
    for d in TF32_WIDE:
        tf32_wide[d] = check_tf32_bwd(torch, k2, inputs, fused_kernel,
                                      kernel_ms, moved, smi, d)
        tf32_wide[d]["max_abs_err"] = tf32_wide[d].pop("worst")
        mark(f"f32 d{d}")

    # Bounds at the timing shape. Per (q, k) pair and head-dim element:
    # 2 operations each for the scores, dp, dv, dk and dq products.
    pairs_d = 16 * 8 * 16384 * 16384 * 16

    def entry(key, t, n_ops, out_bytes, lib, d32_key):
        bd = bound(n_ops * pairs_d, b16["in_bytes"] + b16[out_bytes], "bf16")
        body = (k2.fused_instance if key == "fused" else k2.backward_instance)(
            torch.float32, 16, 1, 1, 0.1).body
        moved = f32["in_bytes"] + f32[out_bytes]
        return {
            "max_abs_err": errs[torch.float32][key], "ms": f32[t],
            "plain_ms": f32["plain"], "library_ms": f32["sdpa_bwd"] if lib
            else None,
            **(bounds_f32(n_ops * pairs_d, moved) if body == "mma" else
               bound(n_ops * pairs_d, moved, "f32")),
            "body": body, "earlier_ms": f32.get(t + "_earlier"),
            "max_abs_err_bf16": errs[torch.bfloat16][key], "ms_bf16": b16[t],
            # bf16: the mma.sync bodies (the fused one at d 16 since this
            # run's narrow body replaced it has its own entry)
            "body_bf16": "mma",
            "earlier_ms_bf16": b16.get(t + "_earlier", b16[t]),
            "plain_ms_bf16": b16["plain"],
            "library_ms_bf16": b16["sdpa_bwd"] if lib else None,
            "bound_ms_bf16": bd["bound_ms"], "bound_by_bf16": bd["bound_by"],
            # flash_attention_bwd with this kernel's variant at B 8, d 32
            "variant_ms_d32": d32[torch.float32][d32_key],
            "library_ms_d32": d32[torch.float32]["sdpa"],
            **({"kernel_ms_d32": d32[torch.float32]["kernel"],
                "earlier_ms_d32": d32[torch.float32]["earlier"]}
               if key == "fused" else {}),
            "variant_ms_bf16_d32": d32[torch.bfloat16][d32_key],
            "library_ms_bf16_d32": d32[torch.bfloat16]["sdpa"]}
    for t in (f32, b16):
        t["all_bytes"] = t["dq_bytes"] + t["dkv_bytes"]
    return {
        "wgmma": wg,
        "narrow": narrow,
        "narrow32": narrow32,
        "tf32": tf32, **{f"tf32_d{d}": tf32_wide[d] for d in TF32_WIDE},
        "flash_attention_bwd_fused": entry("fused", "fused", 10, "all_bytes",
                                           True, "fused"),
        "flash_attention_bwd_dq": entry("dq", "dq", 6, "dq_bytes", False,
                                        "split"),
        "flash_attention_bwd_dkv": entry("dkv", "dkv", 8, "dkv_bytes", False,
                                         "split"),
    }


# The narrow fused backward's shapes at each head size: (label, B, H, Nq, Nk,
# q_offset, dropout, the bodies held against the plain backward first). At
# d 16 the B2 N16384 narrow cases are held by `agree` in check_k2_bwd; at d
# 32 here, with a ragged N either side, and the short rows that set
# NARROW_MIN_ROWS[32].
NARROW_BWD_SHAPES = {
    16: (("B2", 2, 8, 16384, 16384, 0, 0.0, ("mma",)),
         ("B2", 2, 8, 16384, 16384, 0, 0.1, ("mma",)),
         ("B16", 16, 8, 16384, 16384, 0, 0.1, ()),
         ("window fold", 16, 512, 256, 256, 0, 0.1, ("wgmma",)),
         ("CP q shard", 2, 8, 8192, 16384, 8192, 0.1, ("wgmma",))),
    32: (("B2", 2, 8, 16384, 16384, 0, 0.1, ("wgmma", "mma")),
         ("B8", 8, 8, 16384, 16384, 0, 0.1, ()),
         ("B16", 16, 8, 16384, 16384, 0, 0.1, ()),
         ("ragged", 2, 8, 2000, 2100, 0, 0.1, ("wgmma",)),
         ("ragged", 2, 8, 2100, 2000, 0, 0.0, ("wgmma",)),
         ("window fold", 16, 512, 256, 256, 0, 0.1, ("wgmma",)),
         ("CP q shard", 2, 8, 8192, 16384, 8192, 0.1, ("wgmma",)),
         ("N512", 512, 8, 512, 512, 0, 0.1, ()),
         ("N1024", 256, 8, 1024, 1024, 0, 0.1, ()),
         ("N2048", 64, 8, 2048, 2048, 0, 0.1, ()),
         ("N4096", 16, 8, 4096, 4096, 0, 0.1, ()))}


def check_narrow_bwd(torch, k2, inputs, fused_kernel, kernel_ms, moved, dev,
                     smi, d: int) -> dict:
    """Phase 7's readings of the narrow fused backward (bf16, head size d)
    against the mma.sync fused kernel it replaced, at NARROW_BWD_SHAPES[d]:
    each body named there held against the plain backward first (the
    narrow one's dk, dv and dbias the same bits on a second run), then the
    two in turns; at the teacher's N (labels B2, B8, B16) beside the plain
    version, SDPA's backward and both floors. Every (q, k) pair: 10
    operations a head-dim element (five products) and one exp."""
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    out, worst = {}, 0.0
    for label, b, h, nq, nk, q_offset, rate, check in NARROW_BWD_SHAPES[d]:
        args, kw = inputs(b, h, nq, nk, d, torch.bfloat16, rate,
                          q_offset=q_offset)
        q, k, v, bias, o, lse, do = args
        tag = (f"{label} B{b} H{h} {nq}x{nk} q_offset {q_offset} d{d} bf16 "
               f"dropout {rate}")
        plain_ms = None
        if check:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            ref = k2.attention_bwd_plain(*args, **kw)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            for body in check:
                got = fused_kernel(args, kw, body)
                torch.cuda.synchronize()
                line = []
                for name, a, r in zip(BWD_ERR, got, ref):
                    ok, err, text = bwd_agree(torch, a, r, torch.bfloat16,
                                              name, body)
                    line.append(f"{name} {text}")
                    if body == "wgmma":
                        worst = max(worst, err)
                    if not ok:
                        raise AssertionError(f"K2 bwd fused ({body}) {name} "
                                             f"disagrees at {tag}: {text}")
                if body == "wgmma":
                    again = fused_kernel(args, kw, body)
                    same = [torch.equal(x, y) for x, y in zip(got[1:],
                                                              again[1:])]
                    line.append(f"dk, dv, dbias the same bits on a second "
                                f"run: {same}")
                    if not all(same):
                        raise AssertionError(f"K2 bwd narrow at {tag}: dk, "
                                             f"dv, dbias differ between runs")
                    del again
                log(f"[K2 bwd] {tag}: the fused kernel ({body}) against the "
                    "plain version: " + ", ".join(line))
            del ref, got
        default = k2.fused_instance(torch.bfloat16, d, nq, nk, rate).body
        reps = {"mma": 3, "wgmma": 3} if b * h * nq * nk > 2**33 else {
            "mma": 10, "wgmma": 10}
        r = narrow_turns(torch, kernel_ms(args, kw, reps), default,
                         f"[K2 bwd] {tag} fused kernel", smi)
        if label.startswith("B"):
            lib, note = sdpa_ms(q, k, v, bias, backward=True,
                                dropout_p=rate, reps=3)
            bd = bounds_k2(10 * b * h * nq * nk * d, moved(args, b * h * nk),
                           b * h * nq * nk)
            r |= {"plain_ms": plain_ms, "library_ms": lib, **bd}
            log(f"[K2 bwd] {tag}: narrow fused kernel {r['ms']:.2f} ms "
                f"(mma.sync {r['earlier_ms']:.2f}), plain {plain_ms} ms, "
                f"backward of F.scaled_dot_product_attention {lib} ms "
                f"({note}); bound {bd['bound_ms']:.3f} ms by {bd['bound_by']}"
                f" ({bd['bound_ms'] / r['ms']:.1%} of it), special-function "
                f"floor {bd['bound_ms_sfu']:.3f} ms "
                f"({bd['bound_ms_sfu'] / r['ms']:.1%} of it) on {smi}")
            if d == 32 and b >= 8 and r["faster"] != r["default"]:
                raise AssertionError(f"K2 bwd at {tag}: the rule takes "
                                     f"{r['default']}, {r['faster']} is faster")
        key = f"{label} dropout {rate}"
        out[key if key not in out else f"{key} {nq}x{nk}"] = r
        del args, q, k, v, bias, o, lse, do
    out["worst"] = worst
    return out


def narrow_bwd_mask_positions(torch, k2, dev, d: int,
                              dtype=None) -> int:
    """The fused warpgroup backward's dropout mask at head size d (the
    narrow body in bf16; with `dtype` f32 the f32 body), position by
    position, is the hash (tests/test_torch_kernels.py
    `test_narrow_bwd_dropout_mask_positions`): with k = 0 and v = 1, dv is
    non-zero where the mask keeps a query's key; with q = 0 and dO = 1, dq
    where it keeps a key's query. Two shapes (one ragged, at a q_offset and
    a row_offset), five d-wide windows each way; returns the positions
    held."""
    b, h, rate, seed = 2, 2, 0.3, 123
    dtype, held = dtype or torch.bfloat16, 0
    for nq, nk, q_offset, row_offset in ((512, 512, 0, 0), (200, 300, 70, 3)):
        zeros = lambda n: torch.zeros(b, h, n, d, device=dev, dtype=dtype)
        ones = lambda n: torch.ones(b, h, n, d, device=dev, dtype=dtype)
        eye = torch.eye(d, device=dev, dtype=dtype)
        bias = torch.zeros(h, nk, device=dev)
        lse = torch.zeros(b * h, nq, device=dev)
        kw = dict(dropout_rate=rate, seed=seed, q_offset=q_offset,
                  row_offset=row_offset)
        rs = k2.row_seeds(seed, b * h, row_offset, dev).reshape(b, h, 1, 1)
        keep = k2.keep_mask(rs, torch.arange(nk, device=dev),
                            torch.arange(q_offset, q_offset + nq,
                                         device=dev)[:, None],
                            k2.dropout_threshold(1.0 - rate))

        def fused(q, k, v, do):
            delta = torch.zeros(b, h, nq, device=dev)
            out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                       dbias_bh=torch.empty(b * h, nk, device=dev),
                       dq_acc=torch.zeros(b, h, nq, d, device=dev))
            k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, q, k, v, bias, do, lse,
                                 delta, body="wgmma", **out, **kw)
            return out["dq_acc"], out["dv"]
        for q0 in (0, 8, 56, 121, nq - d):
            do = zeros(nq)
            do[:, :, q0:q0 + d] = eye
            _, dv = fused(zeros(nq), zeros(nk), ones(nk), do)
            if not torch.equal(dv != 0, keep[:, :, q0:q0 + d].transpose(2, 3)):
                raise AssertionError(f"K2 bwd narrow d{d}: dv's mask at "
                                     f"queries {q0}.. is not the hash")
            held += dv.numel()
        for k0 in (0, 8, 56, 121, nk - d):
            k = zeros(nk)
            k[:, :, k0:k0 + d] = eye
            dq, _ = fused(zeros(nq), k, ones(nk), ones(nq))
            if not torch.equal(dq != 0, keep[:, :, :, k0:k0 + d]):
                raise AssertionError(f"K2 bwd narrow d{d}: dq's mask at keys "
                                     f"{k0}.. is not the hash")
            held += dq.numel()
    kind = "narrow" if dtype == torch.bfloat16 else "f32 warpgroup"
    log(f"[K2 bwd] {kind} fused d{d} dropout {rate}: the mask position by "
        f"position is the hash ({held} positions)")
    return held


def check_tf32_bwd(torch, k2, inputs, fused_kernel, kernel_ms, moved,
                   smi, d: int = 16) -> dict:
    """Phase 7's readings of the f32 fused warpgroup backward at head size
    d (16, 32, 48, 64; three TF32 passes on wgmma) against the body it
    replaced at long rows: flash_bwd_fused_tf32 (mma.sync) at d 16 and 32,
    the CUDA-core fused kernel at d 48 and 64. B2 H8 N16384, dropout 0 and
    0.1, a ragged N (2100; past d 16 also 2000) and a CP q shard (rows
    8192.. of 16384 at q_offset 8192): both kernels held to the plain
    backward at f32's bar (1e-4 of each gradient's largest + 1e-6), dk, dv
    and dbias the same bits on a second run of the new one; then both in
    turns. At N16384 (B2, and the train step's batch: B16, or at d 32 the
    serving batch B8) the new one must be faster, and is logged beside the
    plain version (B2), SDPA's backward in f32, the three-pass bound and
    the special-function floor. The short rows (SHORT_ROWS_TF32_BWD[d])
    in turns set TF32_WGMMA_BWD_MIN_ROWS[d]; then the mask position by
    position. Every
    (q, k) pair: 10 operations a head-dim element (five products) and one
    exp."""
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    earlier = "mma" if d in k2.MMA_FUSED_HEAD_DIMS else "simt"
    out, worst = {}, 0.0
    big = ("B8", 8) if d == 32 else ("B16", 16)
    shapes = [("B2", 2, 16384, 16384, 0, 0.0), ("B2", 2, 16384, 16384, 0, 0.1),
              (*big, 16384, 16384, 0, 0.1),
              ("ragged", 2, 2100, 2100, 0, 0.1)]
    if d > 16:
        shapes.append(("ragged", 2, 2000, 2000, 0, 0.0))
    shapes.append(("CP q shard", 2, 8192, 16384, 8192, 0.1))
    shapes += [(f"short rows N{n}", 64 if n < 1024 or (d > 16 and n < 2048)
                else 16, n, n, 0, 0.1)
               for n in SHORT_ROWS_TF32_BWD[d]]
    for label, b, nq, nk, q_offset, rate in shapes:
        args, kw = inputs(b, 8, nq, nk, d, torch.float32, rate,
                          q_offset=q_offset)
        q, k, v, bias, o, lse, do = args
        tag = (f"{label} H8 {nq}x{nk} q_offset {q_offset} d{d} f32 "
               f"dropout {rate}")
        plain_ms = None
        if label == "B2" or nq < 16384:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            ref = k2.attention_bwd_plain(*args, **kw)
            end.record()
            end.synchronize()
            plain_ms = start.elapsed_time(end)
            for body in (earlier, "wgmma"):
                seen = k2.bwd_tf32_wgmma_launches
                got = fused_kernel(args, kw, body)
                torch.cuda.synchronize()
                line = []
                for name, a, r in zip(BWD_ERR, got, ref):
                    ok, err, text = bwd_agree(torch, a, r, torch.float32, name,
                                              body)
                    line.append(f"{name} {text}")
                    if body == "wgmma":
                        worst = max(worst, err)
                    if not ok:
                        raise AssertionError(f"K2 bwd fused f32 ({body}) "
                                             f"{name} disagrees at {tag}: "
                                             f"{text}")
                if body == "wgmma":
                    if k2.bwd_tf32_wgmma_launches != seen + 1:
                        raise AssertionError(f"K2 bwd at {tag}: the f32 "
                                             "warpgroup body was not counted")
                    again = fused_kernel(args, kw, body)
                    same = all(torch.equal(x, y)
                               for x, y in zip(got[1:], again[1:]))
                    line.append(f"dk, dv, dbias bit-equal on a second run "
                                f"{same}")
                    if not same:
                        raise AssertionError(f"K2 bwd at {tag}: dk, dv or "
                                             "dbias differ from run to run")
                    del again
                log(f"[K2 bwd] {tag}: the fused kernel ({body}) against the "
                    "plain version: " + ", ".join(line))
            del ref, got
        default = k2.fused_instance(torch.float32, d, nq, nk, rate).body
        big = b * nq * nk > 2**31
        n = (3 if big else 10) if d == 16 else (3 if big else 5)
        reps = {earlier: n, "wgmma": n}
        if earlier == "simt" and b * nq * nk >= 2**32:
            reps["simt"] = 1       # over a second a call on the CUDA cores
        r = narrow_turns(torch, kernel_ms(args, kw, reps), default,
                         f"[K2 bwd] {tag} fused kernel", smi,
                         new="f32 warpgroup (wgmma)", earlier=earlier)
        if nq == nk == 16384:
            if r["faster"] != "wgmma":
                raise AssertionError(f"K2 bwd at {tag}: the f32 warpgroup "
                                     f"body is no faster than the {earlier} "
                                     "one")
            lib, note = sdpa_ms(q, k, v, bias, backward=True, dropout_p=rate,
                                reps=3)
            bd = bounds_tf32_k2(10 * b * 8 * nq * nk * d,
                                moved(args, b * 8 * nk), b * 8 * nq * nk)
            r |= {"plain_ms": plain_ms, "library_ms": lib, **bd}
            log(f"[K2 bwd] {tag}: f32 warpgroup fused kernel {r['ms']:.2f} ms "
                f"({earlier} {r['earlier_ms']:.2f}), plain {plain_ms} ms, "
                f"backward of F.scaled_dot_product_attention {lib} ms "
                f"({note}); three-pass bound {bd['bound_ms']:.3f} ms by "
                f"{bd['bound_by']} ({bd['bound_ms'] / r['ms']:.1%} of it), "
                f"special-function floor {bd['bound_ms_sfu']:.3f} ms "
                f"({bd['bound_ms_sfu'] / r['ms']:.1%} of it) on {smi}")
        key = f"{label} dropout {rate}"
        out[key if key not in out else f"{key} {nq}x{nk}"] = r
        del args, q, k, v, bias, o, lse, do
    out["worst"] = worst
    out["mask"] = narrow_bwd_mask_positions(torch, k2, "cuda", d,
                                            torch.float32)
    return out


def check_k3(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3
    g = torch.Generator(device=dev).manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        args = (torch.rand(16, 128, 128, 3, generator=g, device=dev) * 2 - 1,
                torch.rand(16, 128, 128, 3, generator=g, device=dev) * 2 - 1,
                torch.randn(16, 256, generator=g, device=dev),
                0.5 * torch.randn(16, 256, generator=g, device=dev))
        args = tuple(a.to(dt) for a in args)
        got, ref = k3.mse_kl(*args), k3.mse_kl_plain(*args)
        torch.cuda.synchronize()
        err = max((a - r).abs().item() for a, r in zip(got, ref))
        rel = max(((a - r).abs() / r.abs()).item() for a, r in zip(got, ref))
        # The plain version of the kernel's own order of summation: that
        # order with f32 adds where the kernel may fuse a multiply in.
        geo = k3.geometry(args[0].numel(), args[2].numel(),
                          args[0].element_size(), sms)
        own = max(abs(float(a) - float(r)) / abs(float(r)) for a, r in
                  zip(got, k3.mse_kl_blocked_plain(*args, geo)))
        if not all(torch.equal(a, r) for a, r in zip(got, k3.mse_kl(*args))):
            raise AssertionError(f"K3 gives other bits on a second call {dt}")
        earlier = lambda: k3.mse_kl_kernel(*args, earlier=True)
        new = lambda: k3.mse_kl_kernel(*args)
        turns = [time_ms(torch, fn, 50) for fn in (earlier, new, new, earlier)]
        t_k, t_e = min(turns[1:3]), min(turns[0], turns[3])
        d_k, d_e = device_ms(torch, new, 50), device_ms(torch, earlier, 50)
        t_p = time_ms(torch, lambda: k3.mse_kl_plain(*args), 20)
        log(f"[K3] [16, 128, 128, 3] L 256 {str(dt)[6:]}: max_abs_err "
            f"{err:.2e} (rel {rel:.1e}, tol rel 1e-5; {own:.1e} from its own "
            f"order, tol 1e-6), {geo.blocks} blocks; in turns (earlier, new, "
            f"new, earlier) {', '.join(f'{t:.4f}' for t in turns)} ms; "
            f"device time alone (profiler) {d_k:.4f} ms (earlier form "
            f"{d_e:.4f}); plain {t_p:.4f} ms on {smi}")
        if rel > 1e-5 or own > 1e-6:
            raise AssertionError(f"K3 disagrees with its plain version {dt}")
        if dt == torch.float32:
            # Four reads; a subtract, a square and an add per pixel value.
            out = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                   "library_ms": None, "earlier_ms": t_e,
                   "device_ms": d_k, "earlier_device_ms": d_e,
                   **bound(3 * args[0].numel() + 5 * args[2].numel(),
                           nbytes(*args) + 8, "f32")}
    return out


def fixed_eps(eps):
    """Replace the VAE's posterior draw with one eps, for a comparison
    across devices (the CPU and CUDA generators draw different numbers).
    Returns a function that restores it."""
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
    original = LunarisCoreVAE.__dict__["reparameterize"]

    def rep(mu, logvar, generator=None):
        std = (0.5 * logvar.float()).exp()
        return (mu.float() + eps.to(mu.device) * std).to(mu.dtype)
    LunarisCoreVAE.reparameterize = staticmethod(rep)
    return lambda: setattr(LunarisCoreVAE, "reparameterize", original)


def grad_step(torch, dev: str, feature_dim: int = 32):
    """Phase 9's train step: a 64 px config (N = 4096 > 1024 runs K2 at
    4 heads, d 8 at feature_dim 32, and on the f32 warpgroup bodies d 16 at
    64, d 32 at 128, d 48 at 192 and d 64 at 256, forward and backward),
    batch 2,
    dropout 0, one fixed eps, from
    seed 7, in full f32 on `dev`. Returns (gradients by "vae." / "teacher."
    name, the teacher's BatchNorm running statistics, the metrics, the
    names of the gradients held to BN_SHARE)."""
    import dataclasses
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import full_f32
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=feature_dim,
                      embedding_dim=32, num_experts=2, batch_size=2,
                      gradient_accumulation_steps=1)
    tcfg = dataclasses.replace(cfg.teacher_config(), num_heads=4,
                               expert_layers=2, dropout_rate=0.0)
    images = torch.randint(0, 256, (1, 2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    restore = fixed_eps(torch.randn(2, 64, generator=torch.Generator()
                                    .manual_seed(6)))
    try:
        with full_f32():
            st = create_state(cfg, dev, 7, tcfg=tcfg)
            st, m = make_train_step(cfg)(st, images.to(dev))
    finally:
        restore()
    before_bn = bn_block_params(st.teacher)
    return ({f"vae.{k}": p.grad.cpu() for k, p in st.vae.named_parameters()}
            | {f"teacher.{k}": p.grad.cpu()
               for k, p in st.teacher.named_parameters()},
            {k: v.cpu() for k, v in st.teacher.state_dict().items()
             if "running" in k},
            {k: float(v) for k, v in m.items()}, before_bn)


# Phase 9's bar for a gradient: a share of the tensor's largest value, plus
# 1e-5 of the model's largest (a gradient that is zero in exact arithmetic,
# a bias cancelled by a following normalization, is rounding noise). 1e-3
# for every tensor but the parameters of the teacher's conv -> [LeakyReLU
# ->] BatchNorm blocks, which get BN_SHARE. Their gradients are cancelled
# sums, and a rounding-level change upstream that puts one LeakyReLU input
# on the other side of its kink moves them by several 1e-3 of their
# largest: runs read 0.09, 3.1 or 5.1 of 1e-3 with the kernels on the card
# and 0.09 or 9.1 with the plain versions (`--grads`; PERF.md §6).
# The attention's own parameters, which take K2's dq, dk, dv and dbias
# directly, keep 1e-3, which a 1 % error in any of the four fails
# (tests/test_torch_grad_bar.py).
GRAD_SHARE, BN_SHARE = 1e-3, 2e-2


def bn_block_params(teacher) -> set:
    """The names ("teacher." + the model's) of the parameters of the
    teacher's conv -> [LeakyReLU ->] BatchNorm blocks: every Sequential
    that ends in a BatchNorm (extractor, expert convs, shortcuts), which
    phase 9 holds to BN_SHARE."""
    from torch import nn
    return {f"teacher.{name}.{p}" for name, mod in teacher.named_modules()
            if isinstance(mod, nn.Sequential) and len(mod)
            and isinstance(mod[-1], nn.BatchNorm2d)
            for p, _ in mod.named_parameters()}


def grad_ratios(g_ref: dict, g_new: dict, before_bn, part=None) -> dict:
    """Each gradient's max abs difference over its bar (above 1: fails).
    With `part(name, whole)`: `g_new` holds a rank's part of the whole
    gradients `g_ref` (tensor / expert parallelism), held to the whole
    tensors' bars."""
    out = {}
    for model in ("vae.", "teacher."):
        top = max(g.abs().max().item() for k, g in g_ref.items()
                  if k.startswith(model))
        for k, g in g_ref.items():
            if k.startswith(model) and (part is None or k in g_new):
                share = BN_SHARE if k in before_bn else GRAD_SHARE
                tol = share * g.abs().max().item() + 1e-5 * top
                ref = g if part is None else part(k, g)
                out[k] = (g_new[k] - ref).abs().max().item() / tol
    return out


def plain_on_card():
    """Run K1, K2 and K3's plain versions on CUDA tensors in place of the
    kernels (`--grads`). Returns a function that restores the kernels."""
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3
    saved = k1._kernel, k2.forward_kernel, k2.flash_attention_bwd, k3._kernel
    k1._kernel = lambda x, w, b, groups, eps: k1.gn_mish_plain(
        x, w, b, groups=groups, eps=eps)
    k2.forward_kernel = lambda *a, body=None, **kw: k2.attention_plain(*a, **kw)
    k2.flash_attention_bwd = (lambda *a, variant=None, **kw:
                              k2.attention_bwd_plain(*a, **kw))
    k3._kernel = k3.mse_kl_plain

    def restore():
        k1._kernel, k2.forward_kernel, k2.flash_attention_bwd, k3._kernel = saved
    return restore


def spread_grads(torch, runs: int, feature_dim: int = 32) -> int:
    """`--grads N [FEATURE_DIM]`: phase 9's comparison at FEATURE_DIM (32,
    d 8, unless given) N times with the kernels and N times with their
    plain versions on the card, against one CPU step, each on its own side
    of every LeakyReLU kink (unsided), holding more memory before each run
    so that the allocator hands the step other addresses. Prints each
    reading in units of 1e-3 of each tensor's largest, the worst of the
    tensors phase 9 holds to 1e-3 and of those it holds to BN_SHARE apart;
    fails on none."""
    from lunaris_orion_tpu_torch.ops.cuda import _build
    _build.library()
    g_cpu, _, _, before_bn = grad_step(torch, "cpu", feature_dim)
    held = []
    for run in range(runs):
        for plain in (False, True):
            restore = plain_on_card() if plain else (lambda: None)
            try:
                ratios = grad_ratios(g_cpu, grad_step(torch, "cuda",
                                                      feature_dim)[0], ())
            finally:
                restore()
            worst = [max((r, k) for k, r in ratios.items()
                         if (k in before_bn) == bn) for bn in (False, True)]
            log(f"[grads] d {feature_dim // 4} run {run} with the "
                f"{'plain versions' if plain else 'kernels'} on the card: "
                f"worst held to 1e-3 {worst[0][0]:.3f} ({worst[0][1]}), "
                f"worst before a BatchNorm {worst[1][0]:.3f} ({worst[1][1]})")
            held.append(torch.empty(2**18 * (2 * run + plain + 1) + 1024,
                                    device="cuda"))
    return 0


@contextlib.contextmanager
def kink_sides(torch, sides: list, take: bool):
    """The teacher's LeakyReLU (`models.teacher.leaky_relu`) recording each
    call's side of the kink (x > 0, where F.leaky_relu's gradient is 1)
    into `sides`, in call order, or (`take`) computing each call's
    gradient on the recorded side instead of its own. Yields a list that
    receives, for each call whose own side differs somewhere, (the entries
    that differ, the largest |x| among them as a share of the call's
    largest). A run on the card takes the CPU run's sides: an input within
    rounding of the kink otherwise moves the cancelled gradients downstream
    of it by several 1e-3 of their largest (ROADMAP C6), as
    tests/test_torch_recipes.py's sided step does against the JAX step."""
    from lunaris_orion_tpu_torch.models import teacher as tmod
    original, flips, calls = tmod.leaky_relu, [], [0]

    class Sided(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, side, slope):
            ctx.save_for_backward(side)
            ctx.slope = slope
            return torch.nn.functional.leaky_relu(x, slope)

        @staticmethod
        def backward(ctx, g):
            side, = ctx.saved_tensors
            return g * torch.where(side, 1.0, ctx.slope), None, None

    def leaky(x, negative_slope=0.2):
        if not take:
            sides.append((x.detach() > 0).cpu())
            return original(x, negative_slope)
        side = sides[calls[0]].to(x.device)
        calls[0] += 1
        if side.shape != x.shape:
            raise AssertionError(f"kink sides: call {calls[0]} of shape "
                                 f"{tuple(x.shape)}, recorded "
                                 f"{tuple(side.shape)}")
        other = (x.detach() > 0) != side
        if other.any():
            flips.append((int(other.sum()), x.detach()[other].abs().max()
                          .item() / x.detach().abs().max().item()))
        return Sided.apply(x, side, negative_slope)
    tmod.leaky_relu = leaky
    try:
        yield flips
    finally:
        tmod.leaky_relu = original
    if take and calls[0] != len(sides):
        raise AssertionError(f"kink sides: {calls[0]} calls took "
                             f"{len(sides)} recorded")


# Phase 9's widths at 4 heads: d 8 and 16 as they are, d 32, 48 and 64 on
# the CPU step's kink sides (`run_grad_context`).
GRAD_WIDTHS = ((32, False), (64, False), (128, True), (192, True),
               (256, True))


def cpu_grad_ref(torch, feature_dim: int, sided: bool) -> tuple:
    """Phase 9's CPU step at one width (`grad_step`), with the kink sides
    it took (`kink_sides`) where `sided`, else none."""
    sides = []
    with (kink_sides(torch, sides, False) if sided
          else contextlib.nullcontext()):
        return (*grad_step(torch, "cpu", feature_dim), sides)


def _cpu_grad_refs(path: str) -> None:
    """Phase 9's CPU steps at GRAD_WIDTHS in a process of their own (four
    threads), which `main` starts before phase 7 so that they run under
    its work on the card; saved to `path`."""
    import torch
    torch.set_num_threads(4)
    torch.save({fd: cpu_grad_ref(torch, fd, sided) for fd, sided in GRAD_WIDTHS},
               path)


def run_grad_context(torch, feature_dim: int = 32, sided: bool = False,
                     ref: tuple = None) -> None:
    """Phase 9 at one feature_dim (`grad_step`): the card's gradients,
    BatchNorm statistics and metrics against the CPU's (`ref`, the CPU
    step `cpu_grad_ref` gives, computed here when None). With `sided` the
    card's step takes the CPU step's side of each LeakyReLU kink
    (`kink_sides`; each entry that differs must lie within 1e-4 of its
    call's largest |x| of zero, rounding's reach): at d 32, 48 and 64, on
    the kernels and on the plain versions alike, a kink can otherwise move
    the attention biases downstream of it past their 1e-3 bar (PERF.md §6),
    the kink's doing and not K2's. There it also logs the unsided step's
    worst gradient, with the kernels and with the plain versions on the
    card, as a reading that no bar holds."""
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    seen = (k2.launches, k2.tf32_wgmma_launches, k2.bwd_fused_launches,
            k2.bwd_tf32_wgmma_launches)
    g_cpu, s_cpu, m_cpu, before_bn, sides = (
        ref or cpu_grad_ref(torch, feature_dim, sided))
    with (kink_sides(torch, sides, True) if sided
          else contextlib.nullcontext([])) as flips:
        g_gpu, s_gpu, m_gpu, _ = grad_step(torch, "cuda", feature_dim)
    if any(share > 1e-4 for _, share in flips):
        raise AssertionError(f"grads d {feature_dim // 4}: a LeakyReLU input "
                             f"beyond rounding of the kink took the CPU's "
                             f"side: {flips}")
    calls = [now - was for now, was in zip(
        (k2.launches, k2.tf32_wgmma_launches, k2.bwd_fused_launches,
         k2.bwd_tf32_wgmma_launches), seen)]
    if feature_dim // 4 in k2.TF32_WGMMA_HEAD_DIMS and not (
            0 < calls[0] == calls[1] and 0 < calls[2] == calls[3]):
        raise AssertionError(f"grads d {feature_dim // 4}: K2 calls (fwd, of "
                             f"them f32 warpgroup, bwd, of them f32 "
                             f"warpgroup) {calls}")
    if sided:
        # Beside the sided comparison, a reading that is printed and not
        # held to the bars: the card's step on its own side of every kink,
        # with the kernels and with the plain versions on the card, each
        # gradient's difference from the CPU's over its bar.
        unsided = []
        for plain in (False, True):
            restore = plain_on_card() if plain else (lambda: None)
            try:
                r = grad_ratios(g_cpu, grad_step(torch, "cuda",
                                                 feature_dim)[0], before_bn)
            finally:
                restore()
            k = max(r, key=r.get)
            unsided.append(f"{r[k]:.3f} ({k}) with the "
                           f"{'plain versions' if plain else 'kernels'}")
        log(f"[grads] d {feature_dim // 4} unsided (the card's own side of "
            f"every kink; a reading, not held): worst gradient over its bar "
            + ", ".join(unsided))
    ratios = grad_ratios(g_cpu, g_gpu, before_bn)
    # The worst gradient of each bar, as a share of 1e-3 of its largest.
    worst = {bn: max((r * (BN_SHARE if bn else GRAD_SHARE) / 1e-3, k)
                     for k, r in ratios.items() if (k in before_bn) == bn)
             for bn in (False, True)}
    unreached, silent = [], []
    for k, g in g_cpu.items():
        if ratios[k] > 1.0:
            raise AssertionError(f"grads: {k} card vs CPU {ratios[k]:.3f} of "
                                 f"its bar")
        if g.abs().max().item() == 0.0:
            unreached.append(k)
        elif g_gpu[k].abs().max().item() == 0.0:
            silent.append(k)
    expect = ("teacher.semantic_head.", "teacher.style_net.",
              "teacher.prompt_net.")
    if silent or not all(k.startswith(expect) for k in unreached):
        raise AssertionError(f"grads: zero on the card only {silent}; zero "
                             f"on both beyond the unreached heads "
                             f"{[k for k in unreached if not k.startswith(expect)]}")
    s_err = max((s_gpu[k] - v).abs().max().item() for k, v in s_cpu.items())
    # Metrics: 1e-4 of the value plus 1e-6 (8 f32 ulps of an O(1) loss).
    # With one micro-batch, advantage and pg_loss are zero in exact
    # arithmetic (the reward minus its own mean): each device leaves
    # rounding noise there, which a purely relative bar would compare.
    m_ratio = {k: abs(m_gpu[k] - v) / (1e-4 * abs(v) + 1e-6)
               for k, v in m_cpu.items()}
    m_worst = max(m_ratio, key=m_ratio.get)
    kinks = (f"; the CPU's side of the LeakyReLU kink taken in {len(sides)} "
             f"calls, {sum(n for n, _ in flips)} entries on the other side "
             f"in {len(flips)} of them (largest |x| "
             f"{max((sh for _, sh in flips), default=0.0):.1e} of its call's)"
             if sided else "")
    log(f"[grads] 64 px train_step, d {feature_dim // 4}, TF32 off, card vs "
        f"CPU (K2 fwd, of them f32 warpgroup, bwd, of them f32 warpgroup: "
        f"{calls}{kinks}): {len(g_cpu)} "
        f"gradients within bar, in units of 1e-3 of each tensor's largest: "
        f"worst {worst[False][0]:.3f} ({worst[False][1]}) of the "
        f"{len(g_cpu) - len(before_bn)} held to 1e-3, worst "
        f"{worst[True][0]:.3f} ({worst[True][1]}) of the {len(before_bn)} of "
        f"the teacher's conv -> BatchNorm blocks, held to "
        f"{BN_SHARE / 1e-3:.0f}; "
        f"{len(unreached)} zero on both (semantic_head, style_net, "
        f"prompt_net: no loss reads them), BN stats max diff {s_err:.2e} "
        f"(bar 1e-5), metrics worst {m_worst} {m_gpu[m_worst]:.9g} vs "
        f"{m_cpu[m_worst]:.9g} = {m_ratio[m_worst]:.3f} of the bar "
        f"(1e-4 rel + 1e-6)")
    if s_err > 1e-5 or m_ratio[m_worst] > 1.0:
        raise AssertionError("grads: BN statistics or metrics disagree")


def run_train(torch, smi, k1, k2, k3) -> dict:
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step

    # torch's defaults: cuDNN convolutions may use TF32, matrix products not.
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig()                 # 128 px, full default width
    state = create_state(cfg, "cuda", 0)
    before = [p.detach().clone() for p in
              (*state.vae.parameters(), *state.teacher.parameters())]
    n_vae = sum(1 for _ in state.vae.parameters())
    g = torch.Generator(device="cuda").manual_seed(8)
    d = cfg.teacher_config().head_dim
    dtype = lambda bf16: torch.bfloat16 if bf16 else torch.float32
    # bf16 with the variant that is not its default: cold first (the host's
    # clock only), and again after the two default steps, in the same state.
    other = next(v for v in k2.BWD_VARIANTS
                 if v != k2.default_bwd(torch.bfloat16, d))
    # (bf16, K2 backward, remat); the last is phase 15's bare step.
    runs = [(True, other, True), (False, None, True), (True, None, True),
            (True, other, True), (True, None, False)]
    counters = [(k1, "launches"), (k2, "launches"), (k2, "bwd_fused_launches"),
                (k2, "bwd_dq_launches"), (k2, "bwd_dkv_launches"),
                (k3, "launches"), (k2, "narrow_launches"),
                (k2, "bwd_narrow_launches"), (k2, "tf32_wgmma_launches"),
                (k2, "bwd_tf32_wgmma_launches"), (k2, "split_launches")]
    for mod, name in counters:
        setattr(mod, name, 0)
    bare = {}                           # remat -> the default bf16 step
    f32_step = {}                       # the default f32 step's launches
    for bf16, bwd, remat in runs:
        seen = [getattr(mod, name) for mod, name in counters]
        step = make_train_step(cfg.replace(mixed_precision=bf16),
                               attn_bwd=bwd, remat=remat)
        images = torch.randint(0, 256, (cfg.gradient_accumulation_steps,
                                        cfg.batch_size, 128, 128, 3),
                               dtype=torch.uint8, device="cuda", generator=g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if state.step == 0:             # the cold step: the host's clock only
            t0 = time.perf_counter()
            state, m = step(state, images)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        else:
            tag = (f"train step {'bf16' if bf16 else 'f32'} K2 bwd "
                   f"{bwd or k2.default_bwd(dtype(bf16), d)} remat "
                   f"{'on' if remat else 'off'}")
            names = {}
            (state, m), dt, k1_kernels, dev_ms = device_share(
                torch, lambda: step(state, images), tag, smi, k2_names=names)
            check_k1_kernels(k1_kernels, k1.launches - seen[0], tag)
            check_narrow_names(names, k2.narrow_launches - seen[6],
                               k2.bwd_narrow_launches - seen[7], tag)
            # The default f32 step at N16384: every K2 call on the f32
            # warpgroup bodies, by the counts and by name; their pre-pass
            # once a forward and twice a backward.
            delta = [getattr(mod, name) - was
                     for (mod, name), was in zip(counters, seen)]
            check_narrow_names(names, delta[8], delta[9], tag,
                               "f32 warpgroup", every=not bf16)
            if not bf16 and (delta[8] != delta[1] or delta[9] != delta[2]
                             or delta[10] != delta[8] + 2 * delta[9]
                             or delta[1] <= 0):
                raise AssertionError(f"{tag}: K2 calls off the f32 warpgroup "
                                     f"bodies: {delta}")
        losses = {k: float(v) for k, v in m.items()}
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"train step: non-finite metrics {losses}")
        n = images.shape[0] * images.shape[1]
        if bf16 and bwd is None:
            bare[remat] = {"ms": dt * 1e3, "sprites_s": n / dt,
                           "idle": max(0.0, 1 - dev_ms / (dt * 1e3)),
                           "peak_gib": torch.cuda.max_memory_allocated()
                           / 2**30}
        log(f"[train] step {state.step} {'bf16' if bf16 else 'f32'} K2 bwd "
            f"{bwd or k2.default_bwd(dtype(bf16), d) + ' (default)'}, remat "
            f"{'on' if remat else 'off'}: "
            f"{dt * 1e3:.0f} ms = {n / dt:.2f} "
            f"sprites/s, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
            f"GiB, total_loss {losses['total_loss']:.5f} recon "
            f"{losses['recon_loss']:.5f} quality {losses['quality_scores']:.5f}"
            f" on {smi}; launches (K1, K2 fwd, K2 bwd fused, dq, dk/dv, K3, "
            f"of K2 the narrow fwd, bwd, the f32 warpgroup fwd, bwd, their "
            f"pre-pass) "
            f"{[getattr(mod, name) - was for (mod, name), was in zip(counters, seen)]}")
        if not bf16:
            f32_step = {f"{name} {mod.__name__.rsplit('.', 1)[1]}":
                        getattr(mod, name) - was
                        for (mod, name), was in zip(counters, seen)}
    after = [p.detach() for p in
             (*state.vae.parameters(), *state.teacher.parameters())]
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    if not (any(moved[:n_vae]) and any(moved[n_vae:])):
        raise AssertionError("train: a model's parameters did not change")
    launches = {"gn_mish": k1.launches, "flash_attention_fwd": k2.launches,
                "flash_attention_bwd_fused": k2.bwd_fused_launches,
                "flash_attention_bwd_dq": k2.bwd_dq_launches,
                "flash_attention_bwd_dkv": k2.bwd_dkv_launches,
                "mse_kl": k3.launches,
                "flash_attention_fwd_wgmma_narrow": k2.narrow_launches,
                "flash_attention_bwd_wgmma_narrow": k2.bwd_narrow_launches,
                "flash_attention_fwd_wgmma_tf32": k2.tf32_wgmma_launches,
                "flash_attention_bwd_wgmma_tf32": k2.bwd_tf32_wgmma_launches,
                "k2_tf32_split": k2.split_launches}
    log(f"[train] {sum(moved)}/{len(moved)} parameter tensors changed; "
        f"kernel launches in the train steps: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    launches["f32_step"] = f32_step
    return launches, bare


def state_equals_file(torch, state, path: Path) -> int:
    """The trainer's state right after a restore against the file it came
    from, bit for bit: both models' parameters and buffers (BatchNorm
    statistics and counts), both AdamW states (moments and step), the step,
    the baseline and the generator. Returns the tensors compared."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    n = 0
    for name in ("vae", "teacher"):
        live = getattr(state, name).state_dict()
        saved = ck[f"{name}_state_dict"]
        if list(live) != list(saved):
            raise AssertionError(f"resume: {name} keys differ from {path}")
        for k, v in live.items():
            if not torch.equal(v.cpu(), saved[k]):
                raise AssertionError(f"resume: {name}.{k} differs from {path}")
        opt = getattr(state, f"{name}_opt")
        saved_opt = ck[f"{name}_optimizer"]["state"]
        for i, p in enumerate(opt.params):
            for k in ("step", "exp_avg", "exp_avg_sq"):
                if not torch.equal(opt.opt.state[p][k].cpu(), saved_opt[i][k]):
                    raise AssertionError(f"resume: {name} AdamW {k} of "
                                         f"parameter {i} differs from {path}")
        n += len(live) + 3 * len(opt.params)
    if (state.step != ck["global_step"]
            or not torch.equal(state.baseline.cpu(), ck["baseline"])
            or not torch.equal(state.baseline_initialized.cpu(),
                               ck["baseline_initialized"])
            or not torch.equal(state.generator.get_state(),
                               ck["generator_state"])):
        raise AssertionError(f"resume: step, baseline or generator differs "
                             f"from {path}")
    return n + 3


def run_trainer(torch, tmp: Path, smi: str, bare: dict) -> dict:
    """Phase 15: `lunaris-train` of the port at the full default width on
    an 80-sprite procedural corpus (64 train, 16 val), bf16, the memory
    plan choosing remat: two epochs of two steps with grids and saves, a
    resume that must restore the saved state bit for bit and take two more
    steps, and `generate` from the best checkpoint. Counts are set to 0
    just before the first run and read just after it; returns them."""
    from lunaris_orion_tpu_torch.cli import generate as gen_cli
    from lunaris_orion_tpu_torch.cli import train as train_cli
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3

    t_phase = time.perf_counter()
    data = write_synthetic_dataset(tmp / "sprites", 80, image_size=128)
    out, ck = tmp / "run", tmp / "run" / "checkpoints"
    argv = ["--data_dir", str(data), "--mixed_precision", "--val_fraction",
            "0.2", "--log_every", "1", "--save_every", "2",
            "--eval_save_freq", "4", "--sample_every", "4"]
    counters = {"gn_mish": (k1, "launches"),
                "flash_attention_fwd": (k2, "launches"),
                "flash_attention_bwd_fused": (k2, "bwd_fused_launches"),
                "mse_kl": (k3, "launches")}
    for mod, name in counters.values():
        setattr(mod, name, 0)
    t0 = time.perf_counter()
    rc = train_cli.main(argv + ["--output_dir", str(out), "--num_epochs", "2"])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = {k: getattr(mod, name) for k, (mod, name) in counters.items()}
    if rc != 0 or min(launches.values()) <= 0:
        raise AssertionError(f"trainer: rc {rc}, launches {launches}")
    text = (out / "training.log").read_text()
    rows = [json.loads(line) for line in
            (out / "tensorboard" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["total_loss"] for r in rows if "total_loss" in r]
    if len(losses) != 4 or not all(map(math.isfinite, losses)):
        raise AssertionError(f"trainer: step losses {losses}")
    steps = sorted(int(p.stem) for p in (ck / "steps").glob("*.pt"))
    grids = [len(list((out / "eval_samples").glob(g)))
             for g in ("comparison_*.png", "samples_*.png")]
    if (len(steps) < 2 or not (ck / "best.pt").is_file()
            or not (ck / "config.json").is_file() or min(grids) < 1):
        raise AssertionError(f"trainer: steps {steps}, best.pt "
                             f"{(ck / 'best.pt').is_file()}, grids {grids}")
    plan = re.search(r"Memory plan: batch (\d+), remat=(\w+), peak "
                     r"([\d.]+) GiB of ([\d.]+) GiB", text)
    if plan is None:
        raise AssertionError("trainer: no memory plan in training.log")
    floats = lambda pattern, t=text: [float(x) for x in re.findall(pattern, t)]
    ips = floats(r"\| ([\d.]+) sprites/s \(")
    val_ms = floats(r"validation: \d+ batches in ([\d.]+) ms")
    copy_ms = floats(r"handed to the writer in ([\d.]+) ms")
    write_ms = floats(r"Checkpoint step \d+ written in ([\d.]+) ms")
    peak_run = torch.cuda.max_memory_allocated() / 2**30

    # Resume from the directory: the restored state is the saved one.
    trainer = train_cli.trainer_from_args(
        argv + ["--output_dir", str(tmp / "resumed"), "--num_epochs", "1",
                "--resume_from", str(ck)])
    n_equal = state_equals_file(torch, trainer.state,
                                ck / "steps" / f"{steps[-1]}.pt")
    start = trainer.state.step
    _, host_s, _, dev_ms = device_share(
        torch, trainer.train, "trainer: resumed epoch (2 steps, validation, "
        "saves)", smi)
    if trainer.state.step != start + 2:
        raise AssertionError(f"trainer: resumed at {start}, ended at "
                             f"{trainer.state.step}")
    ips_resumed = floats(r"\| ([\d.]+) sprites/s \(",
                         (tmp / "resumed" / "training.log").read_text())

    gen_out = tmp / "generated"
    rc = gen_cli.main(["--checkpoint", str(ck), "--best", "--bf16",
                       "--device", "cuda", "--num_samples", "4",
                       "--max_attempts", "1", "--seed", "0",
                       "--output_dir", str(gen_out)])
    pngs = list(gen_out.glob("sample_*.png"))
    if rc != 0 or len(pngs) != 4:
        raise AssertionError(f"generate from {ck} best: rc {rc}, "
                             f"{len(pngs)} PNGs")
    log(f"[trainer] run 2 epochs x 2 steps in {t_run:.1f} s; launches "
        f"{launches}; steps saved {steps}; grids {grids}; losses "
        f"{[round(x, 5) for x in losses]}")
    # The loop's cost: the epochs against phase 10's bare step of the same
    # remat setting and batch.
    remat = plan.group(2) == "True"
    same = bare.get(remat) if int(plan.group(1)) == 16 else None
    if same is None:
        raise AssertionError(f"trainer: phase 10 timed no bare step at the "
                             f"plan's batch {plan.group(1)}, remat {remat}")
    cost = [1 - x / same["sprites_s"] for x in ips + ips_resumed]
    log(f"[trainer] plan: batch {plan.group(1)}, remat={plan.group(2)}, "
        f"peak {plan.group(3)} GiB of {plan.group(4)} GiB (probe), "
        f"{peak_run:.1f} GiB allocated at most in the run; epoch sprites/s "
        f"{ips} (resumed {ips_resumed}) against phase 10's bare bf16 step "
        f"with remat {'on' if remat else 'off'}: {same['sprites_s']:.2f} "
        f"sprites/s ({same['ms']:.0f} ms, idle {same['idle']:.1%}, peak "
        f"{same['peak_gib']:.1f} GiB), so the loop costs "
        f"{[f'{c:.1%}' for c in cost]} of the bare step's sprites/s "
        f"(remat on: {bare[True]['sprites_s']:.2f} sprites/s, "
        f"{bare[True]['ms']:.0f} ms); resumed epoch device {dev_ms:.0f} ms "
        f"of {host_s * 1e3:.0f} ms host, idle "
        f"{max(0.0, 1 - dev_ms / (host_s * 1e3)):.1%}; validation ms "
        f"{val_ms}; checkpoint copy to host ms {copy_ms}, file write ms "
        f"{write_ms}; resume load {trainer.resume_ms:.0f} ms, {n_equal} "
        f"tensors bit-equal; generate --best --bf16 wrote {len(pngs)} "
        f"sprites; phase {time.perf_counter() - t_phase:.0f} s on {smi}")
    return launches


# The bf16 bar of K5. The kernel rounds where the plain version rounds, so
# only the order of the f32 sums differs: an element is off by the last
# rounding (2 ulps of its reference, plus an eighth of the largest element's
# ulp near zero), and at most 1 element in 1000 differs at all. A rounding
# point left out or misplaced makes 3 in 100 or more differ.
K5_BF16_DIFFER = 1e-3


def time_k5_f32(torch, dev) -> float:
    """K5 in f32 (the CUDA-core body) at [32, 128, 128, 64] -> 64: ms."""
    from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
    g = torch.Generator(device=dev).manual_seed(13)
    y = 2 * torch.randn(32, 128, 128, 64, generator=g, device=dev)
    alpha, beta = (1 + 0.1 * torch.randn(32, 64, generator=g, device=dev)
                   for _ in range(2))
    w = 0.05 * torch.randn(3, 3, 64, 64, generator=g, device=dev)
    wb = 0.1 * torch.randn(64, generator=g, device=dev)
    return time_ms(torch, lambda: k5.gn_mish_conv3(y, alpha, beta, w, wb), 10)


def check_k5(torch, dev, smi) -> dict:
    import torch.nn.functional as F
    from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(b, h, w, cin, cout, dt):
        y = (2 * torch.randn(b, h, w, cin, generator=g, device=dev)).to(dt)
        alpha = 1 + 0.2 * torch.randn(b, cin, generator=g, device=dev)
        beta = 1 + 0.1 * torch.randn(b, cin, generator=g, device=dev)
        w = 0.05 * torch.randn(3, 3, cin, cout, generator=g, device=dev)
        wb = 0.1 * torch.randn(cout, generator=g, device=dev)
        return y, alpha, beta, w, wb

    def agree(args, tag, body=None):
        """(max_abs_err, share of elements that differ) of the body that
        `kernel_body` gives (or `body`) against the plain version."""
        y, _, _, w, _ = args
        body = k5.kernel_body(y.dtype, body)
        got = k5.gn_mish_conv3_kernel(*args, body=body)
        ref = k5.gn_mish_conv3_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        differ = (err > 0).float().mean().item()
        if y.dtype == torch.float32:
            # 9 * Cin f32 products summed in another order.
            ok, tol = bool((err <= 2e-5 + 2e-5 * ref.abs()).all()), "2e-5"
        else:
            top = ref.float().abs().max()
            ok = differ <= K5_BF16_DIFFER and bool((
                err <= 2 * bf16_ulp(torch, ref) + bf16_ulp(torch, top) / 8).all())
            tol = (f"2 bf16 ulps an element; {differ:.1e} differ, at most "
                   f"{K5_BF16_DIFFER:.0e}")
        if not torch.equal(got, k5.gn_mish_conv3_kernel(*args, body=body)):
            raise AssertionError(f"K5 {body} gives other bits on a second run "
                                 f"at {tag}")
        log(f"[K5] {tag} {str(y.dtype)[6:]} {body}: max_abs_err "
            f"{err.max().item():.3e} (tol {tol})")
        if not ok:
            raise AssertionError(f"K5 {body} disagrees with its plain version "
                                 f"at {tag}")
        return err.max().item(), differ

    worst, most_differ = 0.0, 0.0
    shapes = ((2, 32, 32, 64, 64), (2, 64, 64, 32, 32), (2, 32, 32, 128, 64),
              (8, 128, 128, 64, 64))
    # bf16 (tensor cores) also at Cin 8, 24 and 40 (a half chunk), ragged H
    # and W, B 1, and Cin 256 and 512, where sums kept in the mma
    # accumulators across chunks would round the other way too often; the
    # CUDA-core body once more in bf16.
    ragged = ((3, 13, 37, 8, 32), (1, 5, 70, 24, 64), (1, 17, 19, 40, 32),
              (2, 40, 40, 256, 64), (2, 24, 24, 512, 32))
    cases = ([(s, torch.float32, None) for s in shapes]
             + [(s, torch.bfloat16, None) for s in shapes + ragged]
             + [(shapes[0], torch.bfloat16, "simt")])
    for (b, h, w, cin, cout), dt, body in cases:
        err, differ = agree(inputs(b, h, w, cin, cout, dt),
                            f"[{b}, {h}, {w}, {cin}] -> {cout}", body)
        if dt == torch.float32:
            worst = max(worst, err)
        elif body is None:
            most_differ = max(most_differ, differ)
    # The tool's shape: both bodies against the plain version, then their
    # times in turns, and the fused path (K1's pass 1 and fold for alpha and
    # beta, then K5) against K1 followed by F.conv2d and its bias.
    args = inputs(128, 128, 128, 64, 64, torch.bfloat16)
    tag = "[128, 128, 128, 64] -> 64"
    most_differ = max(most_differ, agree(args, tag)[1])
    agree(args, tag, "simt")
    y, alpha, beta, w, wb = args
    scale, bias = torch.full((64,), 1.1, device=dev), torch.full((64,), 0.05,
                                                                 device=dev)
    w_oihw = w.to(y.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    # K1 at this shape too: it is the tool's `gnmish_alone` and `chain`.
    ref = k1.gn_mish_plain(y, scale, bias)
    err = (k1.gn_mish(y, scale, bias).float() - ref.float()).abs()
    if not bool((err <= 2 * bf16_ulp(torch, ref) + 1e-6).all()):
        raise AssertionError("K1 disagrees with its plain version at "
                             "[128, 128, 128, 64] bf16")
    # The alpha / beta entry: the plain fold's moments in another order.
    for a, r in zip(k1.group_affine_kernel(y, scale, bias),
                    k1.group_affine(y, scale, bias)):
        if not (a.is_contiguous() and torch.allclose(a, r, atol=1e-5,
                                                     rtol=1e-4)):
            raise AssertionError("group_affine_kernel disagrees with "
                                 "group_affine at [128, 128, 128, 64] bf16")
    del ref, err
    run = lambda body: (lambda: k5.gn_mish_conv3_kernel(*args, body=body))
    conv = lambda bias_=None: F.conv2d(k1.gn_mish(y, scale, bias).permute(
        0, 3, 1, 2), w_oihw, bias_, padding=1)
    wb16 = wb.to(y.dtype)
    # K1 + F.conv2d with the bias three ways: inside the convolution (cuDNN
    # then adds it with a broadcasting elementwise kernel), added out of
    # place, added in place over the output's [B * H * W, Cout] rows; the
    # library's time is the fastest of the three.
    def rows_add(out):                # out: NCHW, channels_last in memory
        out.permute(0, 2, 3, 1).view(-1, wb16.numel()).add_(wb16)
        return out

    chains = {"bias in F.conv2d": lambda: conv(wb16),
              "+ bias": lambda: conv() + wb16.view(1, -1, 1, 1),
              "rows add_": lambda: rows_add(conv())}
    ref = chains["bias in F.conv2d"]()
    tol = 2 * bf16_ulp(torch, ref) + bf16_ulp(torch, ref.abs().max())
    for name, fn in chains.items():       # a rounding before the bias add
        if not bool(((fn().float() - ref.float()).abs() <= tol).all()):
            raise AssertionError(f"K1 + F.conv2d, {name}: another result")
    del ref, tol
    fused = lambda: k5.gn_mish_conv3(
        y, *k1.group_affine_kernel(y, scale, bias), w, wb)
    order = [*chains, "fused", "fused", *reversed(chains)]
    with torch.no_grad():
        turns = [time_ms(torch, run(body), 5)
                 for body in ("simt", "mma", "mma", "simt")]
        path = [time_ms(torch, chains.get(name, fused), 5) for name in order]
        t_affine = time_ms(torch, lambda: k1.group_affine_kernel(
            y, scale, bias), 10)
        t_p = time_ms(torch, lambda: k5.gn_mish_conv3_plain(*args), 2)
        t_f32 = time_k5_f32(torch, dev)
    t_k, t_simt = min(turns[1:3]), min(turns[0], turns[3])
    t_fused = min(t for name, t in zip(order, path) if name == "fused")
    t_chains = {name: min(t for n, t in zip(order, path) if n == name)
                for name in chains}
    t_chain = min(t_chains.values())
    ops = 2 * 9 * 64 * 64 * y.numel() // 64
    out_bytes = y.numel() * y.element_size()          # Cout = Cin here
    bd = bound(ops, nbytes(y, alpha, beta) + nbytes(w, wb) // 2 + out_bytes,
               "bf16")
    log(f"[K5] {tag} bf16 in turns (CUDA cores, tensor cores, tensor cores, "
        f"CUDA cores): {', '.join(f'{t:.3f}' for t in turns)} ms; tensor "
        f"cores {t_k:.3f} ms ({ops / t_k / 1e9:.2f} TFLOP/s), bound "
        f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}, plain {t_p:.3f} ms; "
        f"elements that differ at most {most_differ:.1e}; f32 (CUDA cores) "
        f"at [32, 128, 128, 64] -> 64 {t_f32:.3f} ms on {smi}")
    log(f"[K5] {tag} bf16 in turns ({', '.join(order)}): "
        f"{', '.join(f'{t:.3f}' for t in path)} ms; K1 + F.conv2d at its "
        f"fastest {t_chain:.3f} ms, alpha/beta entry + K5 {t_fused:.3f} ms; "
        f"the alpha/beta entry alone {t_affine:.4f} ms on {smi}")
    if t_k >= t_simt:
        raise AssertionError(f"K5: the tensor-core body ({t_k:.3f} ms) is "
                             f"not faster than the CUDA-core body "
                             f"({t_simt:.3f} ms)")
    return {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
            "library_ms": t_chain, "body": "mma", "earlier_ms": t_simt,
            "fused_path_ms": t_fused, "library_ms_bias_in_conv":
            t_chains["bias in F.conv2d"], "affine_ms": t_affine,
            "bf16_differ": most_differ, "ms_f32_b32": t_f32, **bd}


def check_stages(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention_stages as st
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    g = torch.Generator(device=dev).manual_seed(12)

    def inputs(b, dt):
        q, k, v = (torch.randn(b, 8, 16384, 16, generator=g, device=dev).to(dt)
                   for _ in range(3))
        bias = 0.5 * torch.randn(8, 16384, generator=g, device=dev)
        return q, q * torch.tensor(0.25, dtype=dt, device=dev), k, v, bias

    worst, block_k = 0.0, st.KERNEL_BLOCK_K
    # B 2, and the tool's own B 8, each in f32 and bf16.
    for b, dt in ((2, torch.float32), (2, torch.bfloat16),
                  (8, torch.float32), (8, torch.bfloat16)):
        q, qs, k, v, bias = inputs(b, dt)
        line = []
        for stage in st.STAGES:
            o, lse = st.flash_fwd_stage(qs, k, v, bias, stage, block_k)
            ro, rlse = st.flash_fwd_stage_plain(qs, k, v, bias, stage, block_k)
            torch.cuda.synchronize()
            ref = ro.float()
            top = ref.abs().max().item()       # no floor: o is small past exp
            each = (o.float() - ref).abs()
            err = each.max().item()
            lse_err = (lse - rlse).abs().max().item()
            # f32 (three TF32 passes): 16384 terms summed in another order,
            # 2e-5 of the largest magnitude. bf16 (tensor cores): the forward's bar,
            # K2_BF16_BAR: 2 ulps of each element's own reference for the
            # last rounding plus 1e-3 of the largest, and at most 3 elements
            # in 100 may differ at all (measured: 1.6e-4, 9 in 1000).
            bar = 2e-5 * top
            differ = (each > 0).float().mean().item()
            if dt == torch.bfloat16:
                bar = K2_BF16_BAR["mma"][0] * top + 2 * bf16_ulp(torch, ref)
                line.append(f"{stage} {err:.2e} ({differ:.1e} differ)")
            else:
                line.append(f"{stage} {err:.2e}/{bar:.1e}")
            if not bool((each <= bar).all()) or lse_err > 1e-4 or (
                    dt == torch.bfloat16 and differ > K2_BF16_BAR["mma"][1]):
                raise AssertionError(
                    f"K2 stage {stage} disagrees with its plain version at "
                    f"B{b} H8 N16384 d16 {dt}: max err {err:.3e} at largest "
                    f"magnitude {top:.3e}, {differ:.2e} of the elements "
                    f"differ, lse {lse_err:.1e}")
            del each, ref
            if dt == torch.float32:
                worst = max(worst, err)
        # The stage family is built on the tensor-core bodies (bf16: the
        # mma.sync one, which the narrow warpgroup body replaced as the
        # default at this shape).
        fo, flse = k2.forward_kernel(q, k, v, bias, body="mma")
        if not (torch.equal(o, fo) and torch.equal(lse, flse)):
            raise AssertionError(f"K2 stage sum is not the forward kernel at "
                                 f"dropout 0 ({dt})")
        log(f"[stages] B{b} H8 N16384 d16 {str(dt)[6:]}: " + ", ".join(line)
            + "; sum bit-equal to the tensor-core forward (body mma) at "
            "dropout 0")
    run = lambda: st.flash_fwd_stage(qs, k, v, bias, "sum", block_k)
    t_k = time_ms(torch, run, 5)
    t_p = time_ms(torch, lambda: st.flash_fwd_stage_plain(
        qs, k, v, bias, "sum", block_k), 1, warmup=0)
    lib, note = sdpa_ms(q, k, v, bias, reps=3)
    ops = 4 * 8 * 8 * 16384 * 16384 * 16
    o, lse = run()
    bd = bound(ops, nbytes(qs, k, v, bias, o, lse), "bf16")
    log(f"[stages] B8 H8 N16384 d16 bf16 sum: kernel {t_k:.3f} ms, plain "
        f"{t_p:.1f} ms, F.scaled_dot_product_attention {lib} ms ({note}), "
        f"bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} on {smi}")
    return {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
            "library_ms": lib, **bd}


def check_lane_sums(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.ops.cuda import gn_stats
    g = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for shape in ((128, 128, 128, 32), (128, 128, 128, 64),
                  (128, 64, 64, 128)):
        x32 = 1 + 2 * torch.randn(shape, generator=g, device=dev)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            ref = gn_stats.lane_sums_plain(x)
            worst = 0.0
            for tn in (512, 2048):
                got = gn_stats.lane_sums_partials(x, tn)
                torch.cuda.synchronize()
                for a, r in zip(got, ref):      # sums in another order
                    rel = ((a - r).abs().max() / r.abs().max()).item()
                    worst = max(worst, (a - r).abs().max().item())
                    if rel > 2e-5:
                        raise AssertionError(
                            f"lane sums disagree with the plain version at "
                            f"{shape} {dt} tile {tn}: {rel:.2e} of the "
                            f"largest sum")
            # K1's pass 1 alone (the tool's `k1_pass1`): mean within 1e-5,
            # inv_std within 1e-4 relative of the plain moments; its
            # partials the same bits on two runs.
            for a, r, rtol in zip(k1.group_stats(x), k1.group_stats_plain(x),
                                  (1e-5, 1e-4)):
                if not torch.allclose(a, r, atol=1e-5, rtol=rtol):
                    raise AssertionError(f"K1 pass 1 alone disagrees with "
                                         f"the plain moments at {shape} {dt}")
            if not torch.equal(k1.group_partials(x), k1.group_partials(x)):
                raise AssertionError(f"K1 pass 1 gives other bits on a second "
                                     f"run at {shape} {dt}")
            t_k = time_ms(torch, lambda: gn_stats.lane_sums_partials(x, 512), 20)
            t_p = time_ms(torch, lambda: gn_stats.lane_sums_plain(x), 10)
            t_1 = time_ms(torch, lambda: k1.group_partials(x), 20)
            t_1p = time_ms(torch, lambda: k1.group_partials_plain(x), 10)
            grouped = x.view(shape[0], -1, 8, shape[3] // 8)
            t_vm = time_ms(torch, lambda: torch.var_mean(grouped, dim=(1, 3)),
                           10)
            kind = "bf16" if dt == torch.bfloat16 else "f32"
            bd = bound(3 * x.numel(), nbytes(x) + 2 * 4 * shape[0] * max(
                shape[3], 128), kind)
            bd1 = bound(3 * x.numel(), nbytes(x), kind)
            log(f"[stats] {shape} {str(dt)[6:]}: max_abs_err {worst:.3e} "
                f"(tol 2e-5 of the largest sum) kernel {t_k:.4f} ms "
                f"({nbytes(x) / t_k / 1e6:.0f} GB/s) plain {t_p:.4f} ms, "
                f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}; K1 pass 1 "
                f"{t_1:.4f} ms ({nbytes(x) / t_1 / 1e6:.0f} GB/s, "
                f"{bd1['bound_ms'] / t_1:.1%} of its bound "
                f"{bd1['bound_ms']:.4f} ms) plain {t_1p:.4f} ms; "
                f"torch.var_mean over the grouped view {t_vm:.4f} ms on {smi}")
            if shape == (128, 128, 128, 64) and dt == torch.bfloat16:
                out = {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
                       "library_ms": t_vm, **bd}
                pass1 = {"pass1_ms": t_1, "pass1_plain_ms": t_1p,
                         "pass1_bound_ms": bd1["bound_ms"],
                         "pass1_library_ms": t_vm}
    return out, pass1


def run_tools(torch) -> dict:
    """This slice's main path: the three measurement tools at their full
    default shapes. Counts are set to 0 just before and read just after."""
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention_stages as st
    from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.ops.cuda import gn_stats
    from lunaris_orion_tpu_torch.tools import (attn_roofline, fusion_overlap,
                                               gn_stats as gn_stats_tool)
    counters = {"gn_mish_conv3": (k5, "launches"),
                "flash_fwd_stage": (st, "launches"),
                "lane_sums_partials": (gn_stats, "launches"),
                "gn_mish": (k1, "launches"),
                "gn_mish stats pass": (k1, "stats_launches"),
                "gn_mish affine": (k1, "affine_launches"),
                "flash_attention_fwd": (k2, "launches")}
    for mod, name in counters.values():
        setattr(mod, name, 0)
    for tool, argv in ((attn_roofline, ["--sdpa"]),
                       (attn_roofline, ["--dtype", "f32", "--reps", "3"]),
                       (gn_stats_tool, []), (fusion_overlap, [])):
        t0 = time.perf_counter()
        rc = tool.main(argv)
        torch.cuda.synchronize()
        log(f"[tools] {tool.__name__.rsplit('.', 1)[1]} {argv}: rc {rc} in "
            f"{time.perf_counter() - t0:.1f} s")
        if rc != 0:
            raise AssertionError(f"{tool.__name__} returned {rc}")
    launches = {k: getattr(mod, name) for k, (mod, name) in counters.items()}
    log(f"[tools] kernel launches in the three tools: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    return launches


# --- phase 20: the H100 and low-end recipes at full width -------------------

# docs/configs.md's "high-end" tier, which it calls the analog of the
# A100/H100 tier (docs/configs.md:9-24): feature_dim 512 at 8 heads, head
# size 64, batch 64 x 1, bf16. The rest stays at TrainConfig's defaults:
# 128 px, 4 experts x 3 blocks, N 16384.
RECIPE_H100 = dict(batch_size=64, gradient_accumulation_steps=1,
                   latent_dim=512, embedding_dim=256, feature_dim=512,
                   vae_lr=3e-4, teacher_lr=2e-4, mixed_precision=True)
# docs/configs.md's low-end tier: feature_dim 256 at 8 heads (head size 32).
RECIPE_LOW_END = dict(batch_size=16, gradient_accumulation_steps=4,
                      latent_dim=256, embedding_dim=128, feature_dim=256,
                      vae_lr=1e-4, teacher_lr=5e-5, mixed_precision=True)
RECIPES = {"H100": RECIPE_H100, "low-end": RECIPE_LOW_END}
# K2's CUDA-core kernels by name: none runs on a bf16 path at d 32 or 64,
# nor on an f32 path at d 48 or 64 at N 16384. `flash_bwd_dkv<` is the
# CUDA-core dk/dv kernel in both types, and with its last template argument
# true the fused one: in f32 at d 48 and 64 `flash_bwd_dkv<float, D, true>`,
# the f32 fused CUDA-core kernel that flash_bwd_wgmma_tf32 replaced there.
K2_CUDA_CORE = re.compile(r"flash_fwd_simt|flash_bwd_dkv<|flash_bwd_dq<")
# The f32 forward on mma.sync that flash_fwd_wgmma_tf32 replaced at N 16384.
K2_F32_REPLACED = re.compile(r"flash_fwd_tf32<|flash_bwd_fused_tf32<")
PROFILE_TRIES = 3               # sessions of one call before phase 20 fails


def profile_counted(torch, fn, tag: str, smi: str, counters: dict):
    """fn() under torch.profiler with every count of `counters` ({key:
    (module, attribute)}, "gn_mish" and the four K2 launch counts among
    them) at 0 just before; (result, host s, device ms, counts, K2 kernels
    by name, device ms by group). The profile must hold a record of every
    launch the wrappers counted (K1's two kernels a call, K2's by name). A
    session that kept fewer (torch.profiler on the H100 has dropped
    records: 1 of 4 K1 calls of phase 20's decode+score, in full runs of
    this script) is logged as incomplete, with where its K1 records lie,
    and fn() is profiled again, at most PROFILE_TRIES sessions: the
    breakdown a phase reports is a complete one."""
    for attempt in range(1, PROFILE_TRIES + 1):
        for mod, name in counters.values():
            setattr(mod, name, 0)
        names, records, groups = {}, [], {}
        result, host_s, k1_kernels, dev_ms = device_share(
            torch, fn, tag, smi, k2_names=names, records=records,
            groups=groups)
        counts = {key: getattr(mod, name)
                  for key, (mod, name) in counters.items()}
        k2_calls = sum(counts[key] for key in (
            "flash_attention_fwd", "flash_attention_bwd_fused",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv"))
        calls = counts["gn_mish"]
        # The f32 warpgroup bodies' pre-pass is in K2's group, by name.
        split = sum(c for n, c in names.items() if "k2_tf32_split" in n)
        if (k1_kernels == {"gn_stats_partial": calls,
                           "gn_mish_apply_fold": calls}
                and sum(names.values()) - split == k2_calls
                and split == counts.get("k2_tf32_split", 0)):
            return result, host_s, dev_ms, counts, names, groups
        k1_at = [f"{t / 1e3:.2f}" for t, n in records
                 if any(k in n for k in K1_KERNELS)]
        log(f"[profile] {tag}: session {attempt} incomplete, its "
            f"breakdown is not a measurement: K1 records {k1_kernels} for "
            f"{calls} calls (at ms {k1_at} of {len(records)} kernel "
            f"records over {records[-1][0] / 1e3 if records else 0:.1f} "
            f"ms), K2 records {sum(names.values())} for {k2_calls} "
            "launches")
    raise AssertionError(f"{tag}: none of {PROFILE_TRIES} profiles held "
                         "every launch the wrappers counted")


def run_recipe(torch, tmp: Path, smi: str, mods: dict,
               tier: str = "H100") -> dict:
    """Phase 20: one of docs/configs.md's recipes (RECIPES: the H100 tier,
    head size 64, and the low-end tier, head size 32) at full width from a
    seeded random init on one card. The Trainer (on a 72-sprite procedural
    corpus) makes its memory plan on the card, which picks the micro-batch
    and remat; then one warm-up and one profiled step of its
    `make_train_step`, and one bf16 `decode_and_score` at batch 8 through
    ImageGenerator from a checkpoint of the same config, profiled. Both run
    the K2 warpgroup bodies that the rule names at N 16384 (by the
    wrappers' counts and by name): at d 32 the narrow ones on every call,
    at d 64 none of them; no CUDA-core K2 kernel; finite losses and scores;
    each profile holds every launch the wrappers counted (`counted`)."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    from lunaris_orion_tpu_torch.train.loop import Trainer
    k1, k2, k3 = mods["k1"], mods["k2"], mods["k3"]
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    write_synthetic_dataset(str(tmp / "sprites"), 72, image_size=128)
    cfg = TrainConfig(data_dir=str(tmp / "sprites"),
                      output_dir=str(tmp / f"run-{tier}"), **RECIPES[tier])
    trainer = Trainer(cfg)
    plan, remat = trainer.cfg, trainer.remat
    need_gib = trainer.plan_need / 2**30
    head_dim = trainer.tcfg.head_dim
    narrow = head_dim in k2.NARROW_HEAD_DIMS
    rule = {key: k2.forward_instance(torch.bfloat16, head_dim, 16384, 16384,
                                     rate).body for key, rate in (
        ("serve", 0.0), ("train", trainer.tcfg.dropout_rate))}
    if set(rule.values()) != {"wgmma"}:
        raise AssertionError(f"{tier} tier: the rule names {rule} at N 16384")
    log(f"[recipe] {tier} tier (feature_dim {cfg.feature_dim}, head size "
        f"{trainer.tcfg.head_dim}, latent {cfg.latent_dim}, embedding "
        f"{cfg.embedding_dim}, bf16): the memory plan on the card picks batch "
        f"{plan.batch_size} x {plan.gradient_accumulation_steps}, remat "
        f"{remat}, peak {need_gib:.1f} GiB")
    counters = {"gn_mish": (k1, "launches"),
                "flash_attention_fwd": (k2, "launches"),
                "flash_attention_fwd_wgmma": (k2, "wgmma_launches"),
                "flash_attention_bwd_fused": (k2, "bwd_fused_launches"),
                "flash_attention_bwd_wgmma": (k2, "bwd_wgmma_launches"),
                "flash_attention_bwd_dq": (k2, "bwd_dq_launches"),
                "flash_attention_bwd_dkv": (k2, "bwd_dkv_launches"),
                "mse_kl": (k3, "launches"),
                "flash_attention_fwd_wgmma_narrow": (k2, "narrow_launches"),
                "flash_attention_bwd_wgmma_narrow": (k2,
                                                     "bwd_narrow_launches")}

    def counted(fn, tag):
        """fn() under torch.profiler (`profile_counted`); (result, host s,
        device ms, counts, K2 kernels by name, device ms by group). The
        wrappers' counts show the path: every K2 forward launch on the
        warpgroup body, the warpgroup kernels by name among the records, no
        CUDA-core K2 kernel."""
        result, host_s, dev_ms, counts, names, groups = profile_counted(
            torch, fn, tag, smi, counters)
        # d 64: the narrow bodies (d 16 and 32) take none of these calls;
        # d 32: they take every one, and no mma.sync body appears by name.
        nf = counts["flash_attention_fwd_wgmma_narrow"]
        nb = counts["flash_attention_bwd_wgmma_narrow"]
        check_narrow_names(names, nf, nb, tag, every=narrow)
        if (nf, nb) != ((counts["flash_attention_fwd"],
                         counts["flash_attention_bwd_fused"]) if narrow
                        else (0, 0)):
            raise AssertionError(f"{tag}: the narrow K2 bodies took {nf} "
                                 f"forward and {nb} backward calls of "
                                 f"{counts}")
        slow = [n for n in names if K2_CUDA_CORE.search(n)]
        if (counts["flash_attention_fwd_wgmma"] <= 0
                or counts["flash_attention_fwd_wgmma"]
                != counts["flash_attention_fwd"]
                or not any("flash_fwd_wgmma" in n for n in names) or slow):
            raise AssertionError(f"{tag}: K2's forward launches {counts}, by "
                                 f"name {names}: every one must be the "
                                 "warpgroup body, no CUDA-core kernel")
        log(f"[recipe] {tag}: launches {counts}; K2 by name {names}")
        return result, host_s, dev_ms, counts, names, groups

    g = torch.Generator(device="cuda").manual_seed(20)
    shape = (plan.gradient_accumulation_steps, plan.batch_size, 128, 128, 3)
    images = [torch.randint(0, 256, shape, dtype=torch.uint8, device="cuda",
                            generator=g) for _ in range(2)]
    state, step = trainer.state, trainer.train_step
    t0 = time.perf_counter()
    state, m = step(state, images[0])             # the warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    tag = (f"recipe {tier} train step bf16 {plan.batch_size} x "
           f"{plan.gradient_accumulation_steps} remat {remat}")
    (state, m), step_s, step_dev, step_counts, step_names, step_groups = (
        counted(lambda: step(state, images[1]), tag))
    losses = {k: float(v) for k, v in m.items()}
    if not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"{tag}: non-finite metrics {losses}")
    if (step_counts["flash_attention_bwd_wgmma"] <= 0
            or step_counts["flash_attention_bwd_wgmma"]
            != step_counts["flash_attention_bwd_fused"]
            or step_counts["flash_attention_bwd_dq"]
            or step_counts["flash_attention_bwd_dkv"]
            or not any("flash_bwd_wgmma" in n for n in step_names)):
        raise AssertionError(f"{tag}: the backward is not the fused warpgroup "
                             f"body on every call: {step_counts}, by name "
                             f"{step_names}")
    n = shape[0] * shape[1]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[recipe] {tag}: {step_s * 1e3:.0f} ms = {n / step_s:.2f} sprites/s "
        f"(warm-up {warm_s:.1f} s), device {step_dev:.0f} ms, peak "
        f"{peak:.1f} GiB, total_loss {losses['total_loss']:.5f} recon "
        f"{losses['recon_loss']:.5f} on {smi}")
    trainer.ckpt.close()
    trainer.metrics.close()
    del trainer, state, step, images, m

    ckpt = tmp / "recipe.pt"
    save_checkpoint(torch, cfg, ckpt, seed=0)
    gen = ImageGenerator(str(ckpt), device="cuda", bf16=True)
    z = torch.randn(8, cfg.latent_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    gen.decode_and_score(z)                       # the warm-up call
    tag = f"recipe {tier} decode+score batch 8 bf16"
    (imgs, quality, sem), _, dec_dev, dec_counts, _, dec_groups = counted(
        lambda: gen.decode_and_score(z), tag)
    if imgs.shape != (8, 128, 128, 3) or not (
            torch.isfinite(imgs).all() and torch.isfinite(quality).all()
            and torch.isfinite(sem).all()):
        raise AssertionError(f"{tag}: non-finite or shape {tuple(imgs.shape)}")
    dec_ms = time_ms(torch, lambda: gen.decode_and_score(z), 3)
    log(f"[recipe] {tag}: {dec_ms:.1f} ms = {8 / dec_ms * 1e3:.2f} sprites/s, "
        f"device {dec_dev:.1f} ms; phase {time.perf_counter() - t_phase:.0f} "
        f"s on {smi}")
    del gen
    torch.cuda.empty_cache()
    return {"tier": tier, "head_dim": head_dim,
            "plan": {"batch_size": plan.batch_size,
                     "accumulation": plan.gradient_accumulation_steps,
                     "remat": remat, "need_gib": need_gib},
            "step_ms": step_s * 1e3, "step_device_ms": step_dev,
            "step_idle": max(0.0, 1 - step_dev / (step_s * 1e3)),
            "step_groups_ms": step_groups,
            "sprites_s": n / step_s, "peak_gib": peak,
            "decode_ms": dec_ms, "decode_device_ms": dec_dev,
            "decode_groups_ms": dec_groups,
            "launches_step": step_counts, "launches_decode": dec_counts}


# docs/configs.md's mid-range tier (docs/configs.md:26-35): feature_dim 384
# at 8 heads (head size 48), latent 384, embedding 192, vae_lr 2e-4,
# teacher_lr 1e-4; here in f32, the CLIs' default precision (no
# --mixed_precision), and at batch 8 x 1 instead of the recipe's 32 x 2, a
# cut for this run's time.
RECIPE_MID_F32 = dict(batch_size=8, gradient_accumulation_steps=1,
                      latent_dim=384, embedding_dim=192, feature_dim=384,
                      vae_lr=2e-4, teacher_lr=1e-4, mixed_precision=False)
# The low-end tier (RECIPE_LOW_END, head size 32) in f32, at batch 16 x 1
# instead of the recipe's 16 x 4, a cut for this run's time.
RECIPE_LOW_END_F32 = dict(RECIPE_LOW_END, gradient_accumulation_steps=1,
                          mixed_precision=False)
# Phase 20's f32 runs (`run_recipe_f32`), as the kernels' line names them.
F32_RECIPE_RUNS = ("decode", "step", "decode_low_end", "step_low_end")


def run_recipe_f32(torch, tmp: Path, smi: str, mods: dict) -> dict:
    """Phase 20 in f32, what a user with default flags runs at the recipes'
    head sizes: `decode_and_score` at batch 8 through ImageGenerator in f32
    (lunaris-generate's default) from a seeded checkpoint, a warm-up call,
    then one profiled: (a) the H100 tier's (head size 64), (c) the low-end
    tier's (head size 32); one f32 train step from a seeded random init, a
    warm-up step, then one profiled: (b) at the mid-range tier's widths
    (RECIPE_MID_F32: head size 48, batch 8 x 1), (d) at the low-end tier's
    (RECIPE_LOW_END_F32: head size 32, batch 16 x 1). Each under
    `profile_counted`: every K2 forward on flash_fwd_wgmma_tf32 and every
    backward on flash_bwd_wgmma_tf32 at its head size, by the wrappers'
    counts and by name, their pre-pass once a forward and twice a backward,
    none on flash_fwd_tf32, flash_bwd_fused_tf32, the split backward or a
    CUDA-core K2 kernel; finite losses and scores; device time by kernel
    group and idle share."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step
    k1, k2, k3 = mods["k1"], mods["k2"], mods["k3"]
    t_phase = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"gn_mish": (k1, "launches"),
                "flash_attention_fwd": (k2, "launches"),
                "flash_attention_fwd_wgmma_tf32": (k2, "tf32_wgmma_launches"),
                "flash_attention_bwd_fused": (k2, "bwd_fused_launches"),
                "flash_attention_bwd_wgmma_tf32": (k2,
                                                   "bwd_tf32_wgmma_launches"),
                "flash_attention_bwd_dq": (k2, "bwd_dq_launches"),
                "flash_attention_bwd_dkv": (k2, "bwd_dkv_launches"),
                "k2_tf32_split": (k2, "split_launches"),
                "mse_kl": (k3, "launches")}

    def counted(fn, tag, d, train):
        result, host_s, dev_ms, counts, names, groups = profile_counted(
            torch, fn, tag, smi, counters)
        by_name = {x: sum(c for n, c in names.items()
                          if re.match(rf"flash_{x}_wgmma_tf32<{d},", n))
                   for x in ("fwd", "bwd")}
        fwd, bwd = counts["flash_attention_fwd"], counts[
            "flash_attention_bwd_fused"]
        slow = [n for n in names
                if K2_CUDA_CORE.search(n) or K2_F32_REPLACED.search(n)]
        if (fwd <= 0 or (train and bwd <= 0) or (not train and bwd)
                or counts["flash_attention_fwd_wgmma_tf32"] != fwd
                or counts["flash_attention_bwd_wgmma_tf32"] != bwd
                or by_name != {"fwd": fwd, "bwd": bwd}
                or counts["k2_tf32_split"] != fwd + 2 * bwd
                or counts["flash_attention_bwd_dq"]
                or counts["flash_attention_bwd_dkv"] or slow):
            raise AssertionError(f"{tag}: K2 off the f32 warpgroup bodies at "
                                 f"d {d}: launches {counts}, by name {names}")
        log(f"[recipe] {tag}: launches {counts}; K2 by name {names}")
        return result, host_s, dev_ms, counts, groups

    def decode(recipe, tier, d):
        cfg = TrainConfig(**recipe)
        ckpt = tmp / f"recipe-f32-{tier}.pt"
        save_checkpoint(torch, cfg, ckpt, seed=0)
        gen = ImageGenerator(str(ckpt), device="cuda", bf16=False)
        z = torch.randn(8, cfg.latent_dim, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(9))
        gen.decode_and_score(z)                   # the warm-up call
        tag = f"recipe {tier} decode+score batch 8 f32"
        (imgs, quality, sem), _, dec_dev, dec_counts, dec_groups = counted(
            lambda: gen.decode_and_score(z), tag, d, False)
        if imgs.shape != (8, 128, 128, 3) or not (
                torch.isfinite(imgs).all() and torch.isfinite(quality).all()
                and torch.isfinite(sem).all()):
            raise AssertionError(f"{tag}: non-finite or shape "
                                 f"{tuple(imgs.shape)}")
        dec_ms = time_ms(torch, lambda: gen.decode_and_score(z), 3)
        log(f"[recipe] {tag}: {dec_ms:.1f} ms = {8 / dec_ms * 1e3:.2f} "
            f"sprites/s, device {dec_dev:.1f} ms (idle "
            f"{max(0.0, 1 - dec_dev / dec_ms):.1%}) on {smi}")
        del gen
        torch.cuda.empty_cache()
        return {"tier": tier, "head_dim": d, "dtype": "f32", "ms": dec_ms,
                "device_ms": dec_dev, "idle": max(0.0, 1 - dec_dev / dec_ms),
                "groups_ms": dec_groups, "launches": dec_counts}

    def train_step(recipe, tier, d, seed):
        cfg = TrainConfig(**recipe)
        state = create_state(cfg, "cuda", seed)
        step = make_train_step(cfg)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        shape = (cfg.gradient_accumulation_steps, cfg.batch_size, 128, 128, 3)
        images = [torch.randint(0, 256, shape, dtype=torch.uint8,
                                device="cuda", generator=g) for _ in range(2)]
        t0 = time.perf_counter()
        state, m = step(state, images[0])         # the warm-up step
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        tag = (f"recipe {tier} train step f32 {cfg.batch_size} x "
               f"{cfg.gradient_accumulation_steps}")
        (state, m), step_s, step_dev, step_counts, step_groups = counted(
            lambda: step(state, images[1]), tag, d, True)
        losses = {k: float(v) for k, v in m.items()}
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"{tag}: non-finite metrics {losses}")
        n = shape[0] * shape[1]
        peak = torch.cuda.max_memory_allocated() / 2**30
        idle = max(0.0, 1 - step_dev / (step_s * 1e3))
        log(f"[recipe] {tag}: {step_s * 1e3:.0f} ms = {n / step_s:.2f} "
            f"sprites/s (warm-up {warm_s:.1f} s), device {step_dev:.0f} ms "
            f"(idle {idle:.1%}), peak {peak:.1f} GiB, total_loss "
            f"{losses['total_loss']:.5f} recon {losses['recon_loss']:.5f}; "
            f"phase {time.perf_counter() - t_phase:.0f} s on {smi}")
        del state, step, images, m
        torch.cuda.empty_cache()
        return {"tier": tier, "head_dim": d, "dtype": "f32",
                "batch": list(shape[:2]), "ms": step_s * 1e3,
                "device_ms": step_dev, "idle": idle, "groups_ms": step_groups,
                "sprites_s": n / step_s, "peak_gib": peak,
                "launches": step_counts}

    return {"decode": decode(RECIPE_H100, "H100", 64),
            "step": train_step(RECIPE_MID_F32, "mid-range", 48, 20),
            "decode_low_end": decode(RECIPE_LOW_END, "low-end", 32),
            "step_low_end": train_step(RECIPE_LOW_END_F32, "low-end", 32, 22)}


# --- phase 16: windowed attention, the evaluator, the training options -------

WINDOW = 256                    # the recommended recipe's (BASELINE.md r5)


def window_mask_positions(torch, k2, dev, d: int, dt=None) -> int:
    """The window bodies' dropout masks at head size d and type dt (bf16
    unless given), position by position, are the hash (tests/test_torch_window.py holds their plain
    twins the same way): the forward with q = k = 0 and bias = 0 (p uniform)
    and d-wide slices of the identity as v, where o[q, j] is non-zero where
    the mask keeps key k0 + j; the backward as `narrow_bwd_mask_positions`
    holds the narrow one (dv with k = 0, v = 1 and the identity slices as
    dO; dq with q = 0, the slices as k, v = dO = 1; o = 0 makes the kernel's
    delta 0). A fold of 2 x 3 windows of WINDOW at row_offset 5 (windows on
    both consumer warpgroups of a block), five slices each way; returns the
    positions held."""
    b, h, w, rate, seed, row_offset = 2, 3, WINDOW, 0.3, 123, 5
    dt = dt or torch.bfloat16
    zeros = torch.zeros(b, h, w, d, device=dev, dtype=dt)
    ones = torch.ones(b, h, w, d, device=dev, dtype=dt)
    eye = torch.eye(d, device=dev, dtype=dt)
    bias = torch.zeros(h, w, device=dev)
    lse = torch.zeros(b * h, w, device=dev)
    kw = dict(dropout_rate=rate, seed=seed, row_offset=row_offset)
    rs = k2.row_seeds(seed, b * h, row_offset, dev).reshape(b, h, 1, 1)
    pos = torch.arange(w, device=dev)
    keep = k2.keep_mask(rs, pos, pos[:, None],
                        k2.dropout_threshold(1.0 - rate))   # [b, h, q, k]

    def bwd(q, k, v, do):
        out = dict(dq=torch.empty_like(q), dk=torch.empty_like(k),
                   dv=torch.empty_like(v),
                   dbias_bh=torch.empty(b * h, w, device=dev))
        k2.launch_bwd_kernel(k2.DKV_FUSED_DQ, q, k, v, bias, do, lse, None,
                             o=zeros, body="window", **out, **kw)
        return out["dq"], out["dv"]

    def sliced(x0):
        t = zeros.clone()
        t[:, :, x0:x0 + d] = eye
        return t
    held = 0
    for x0 in (0, 8, 56, 121, w - d):
        o, _ = k2.forward_kernel(zeros, zeros, sliced(x0), bias, body="window",
                                 **kw)
        _, dv = bwd(zeros, zeros, ones, sliced(x0))
        dq, _ = bwd(zeros, sliced(x0), ones, ones)
        for what, got, want in (
                ("forward o", o, keep[..., x0:x0 + d]),
                ("dv", dv, keep[:, :, x0:x0 + d].transpose(2, 3)),
                ("dq", dq, keep[..., x0:x0 + d])):
            if not torch.equal(got != 0, want):
                raise AssertionError(f"K2 window d{d}: {what}'s mask at "
                                     f"{x0}.. is not the hash")
            held += got.numel()
    log(f"[window] the window bodies' masks at {str(dt)[6:]} d{d}, dropout "
        f"{rate}: position by position the hash ({held} positions)")
    return held


def batched_ms(torch, fn, calls: int = 20, rounds: int = 3) -> float:
    """Milliseconds a call of fn() over `calls` calls back to back between
    two CUDA events, the best of `rounds`, after a warm-up call: a kernel
    under a millisecond whose wrapper's host time `time_ms` would count
    (one call between its events) is timed as a step runs it, queued."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / calls)
    return best


def check_window(torch, dev, smi) -> dict:
    """Phase 16 (a): K2 over the windows folded into the head axis
    (`local_window_attention`) at B16 H8 N16384 W256: f32 and bf16 at d 16
    and 32 (the window bodies, f32's three TF32 passes split in the kernel:
    counted, and named in the kernels' line; the default where
    `window_default` says, which is checked against the turns).
    The forward at dropout 0 and 0.1 and the default backward at 0.1 against
    the plain versions on the folded shape, at phase 4's and phase 7's bars
    (bf16: the one-block online form at the body's `block_k`, W), and the
    window bodies by `body="window"` where they are not the default; the
    window bodies' masks position by position (`window_mask_positions`) and
    their backward the same bits on a second run; a call in batch chunks
    bit-equal to one call; times beside the global K2 at B16 (d 16), the
    plain version, the library call on the folded shape and both floors (the
    tensor cores or the bytes; one exp a score on the special-function
    units), and the window bodies in turns against the mma.sync ones they
    replaced (forward at dropout 0 and 0.1, the backward's whole call at
    0.1; `batched_ms`: 20 calls queued, as a step runs them)."""
    from lunaris_orion_tpu_torch.ops.attention import local_window_attention
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    b, h, n, w = 16, 8, 16384, WINDOW
    rows = h * n // w
    g = torch.Generator(device=dev).manual_seed(16)
    out = {"fwd": {}, "window_fwd": {}, "window_bwd": {}}
    for dt, d in ((torch.float32, 16), (torch.float32, 32),
                  (torch.bfloat16, 16), (torch.bfloat16, 32)):
        name = f"{str(dt)[6:]} d{d}"
        f32 = dt == torch.float32
        sfx = ("" if f32 else "_bf16") + ("_d32" if d == 32 else "")
        fold = lambda t: t.reshape(b, rows, w, d)
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
                   for _ in range(3))
        bias = 0.5 * torch.randn(h, n, generator=g, device=dev)
        bias_w = bias.reshape(rows, w)
        inst = k2.forward_instance(dt, d, w, w, 0.1, body="window")
        splits = k2.split_launches
        errs = []
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=-1234567)
            tag = f"window {w} B{b} H{h} N{n} {name} dropout {rate}"
            window = k2.forward_instance(dt, d, w, w, rate).body == "window"
            if window != k2.window_default(dt, d, rate):
                raise AssertionError(f"windowed K2 {name}: the rule and "
                                     "window_default disagree")
            seen = k2.window_launches
            o = local_window_attention(q, k, v, bias, window=w, **kw)
            counted = k2.window_launches - seen
            ro, rlse = k2.attention_plain(fold(q), fold(k), fold(v), bias_w,
                                          **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float().reshape(o.shape)).abs().max().item()
            if not window:
                # The window body itself, where the rule keeps mma.sync.
                ow, _ = k2.forward_kernel(fold(q), fold(k), fold(v), bias_w,
                                          body="window", **kw)
                torch.cuda.synchronize()
                err = max(err, (ow - ro).abs().max().item())
                del ow
            if dt == torch.float32:
                ok, note = err <= 1e-5, "tol 1e-5"
            else:
                oo, _ = k2.attention_plain(fold(q), fold(k), fold(v), bias_w,
                                           block_k=inst.block_k, **kw)
                ok, excess, differ = k2_bf16_agree(
                    torch, fold(o), oo, inst.body)
                note = (f"online form: over 2 ulps by {max(excess, 0):.1e} of "
                        f"the largest, {differ:.1e} differ ({inst.body})")
                del oo
            log(f"[window] {tag}: max_abs_err {err:.3e} ({note}); window "
                f"body launches {counted} (the rule takes "
                f"{'window' if window else 'mma'})")
            if not ok or counted != int(window):
                raise AssertionError(f"windowed K2 disagrees with its plain "
                                     f"version or missed its body at {tag}")
            errs.append(err)
        # The default backward at dropout 0.1 through autograd.
        variant = k2.default_bwd(dt, d)
        body = (k2.fused_instance(dt, d, w, w, 0.1) if variant == "fused"
                else k2.backward_instance(dt, d, w, w, 0.1)).body
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        do = torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
        seen = k2.bwd_window_launches
        local_window_attention(*leaves, window=w, **kw).backward(do)
        counted = k2.bwd_window_launches - seen
        # The plain backward from the kernel's own o and lse, which the
        # autograd backward takes (a bf16 o that differs from the plain
        # forward's in its last bit moves delta, so a whole row's ds).
        ko, klse = k2.flash_attention(fold(q), fold(k), fold(v), bias_w, **kw)
        args = (fold(q), fold(k), fold(v), bias_w, ko, klse, fold(do))
        ref = k2.attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        line = []
        for gname, leaf, r in zip(BWD_ERR, leaves, ref):
            got = leaf.grad.reshape(r.shape)
            ok, gerr, text = bwd_agree(torch, got, r, dt, gname, body)
            line.append(f"{gname} {text}")
            if not ok:
                raise AssertionError(f"windowed K2 backward ({variant}, {body})"
                                     f" {gname} disagrees at {name}: {text}")
            errs.append(gerr)
        if counted != int(body == "window") or (body == "window") != (
                k2.window_default(dt, d, 0.1, backward=True)):
            raise AssertionError(f"windowed K2 backward {name}: {counted} "
                                 f"window body launches, the rule takes "
                                 f"{body}")
        # The window backward itself (the default where window_default
        # says), held to the same bars, and the same bits on a second run.
        once = k2.flash_attention_bwd(*args, body="window", **kw)
        again = k2.flash_attention_bwd(*args, body="window", **kw)
        torch.cuda.synchronize()
        for gname, x, r in zip(BWD_ERR, once, ref):
            ok, gerr, text = bwd_agree(torch, x, r, dt, gname, "window")
            if body != "window":
                line.append(f"window body {gname} {text}")
            if not ok:
                raise AssertionError(f"windowed K2 window backward {gname} "
                                     f"disagrees at {name}: {text}")
            errs.append(gerr)
        same = [torch.equal(x, y) for x, y in zip(once, again)]
        line.append(f"the window body's dq, dk, dv, dbias the same bits on a "
                    f"second run: {same}")
        if not all(same):
            raise AssertionError(f"windowed K2 backward {name}: the window "
                                 "body's gradients differ between runs")
        del once, again
        window_mask_positions(torch, k2, dev, d, dt)
        if k2.split_launches != splits:
            raise AssertionError(f"windowed K2 {name}: the f32 pre-pass ran "
                                 f"{k2.split_launches - splits} times")
        log(f"[window] backward {variant} ({body}) {name} dropout 0.1: "
            + ", ".join(line))
        del leaves, ref, ro, rlse, ko, klse, args
        # Batch chunks: K2's row cap lowered to 4 images' folded rows.
        cap, k2.MAX_ROWS = k2.MAX_ROWS, 4 * rows
        try:
            chunked = local_window_attention(q, k, v, bias, window=w, **kw)
        finally:
            k2.MAX_ROWS = cap
        if not torch.equal(chunked, o):
            raise AssertionError(f"windowed K2 in 4 batch chunks differs from "
                                 f"one call ({name})")
        log(f"[window] {name}: 4 batch chunks (row_offset) bit-equal to one "
            f"call, dropout 0.1")
        del chunked
        # Times: the windowed forward and default backward beside the
        # global K2 forward at B16 (d 16), the plain version and the library
        # call on the folded shape.
        kw = dict(dropout_rate=0.0, seed=0)
        t_w = time_ms(torch, lambda: local_window_attention(
            q, k, v, bias, window=w, **kw), 10)
        t_g = (time_ms(torch, lambda: k2.flash_attention(q, k, v, bias, **kw),
                       3) if d == 16 else None)
        t_p = time_ms(torch, lambda: k2.attention_plain(
            fold(q), fold(k), fold(v), bias_w, **kw), 3)
        lib, lib_note = sdpa_ms(fold(q), fold(k), fold(v), bias_w, reps=5)
        o, lse = k2.flash_attention(fold(q), fold(k), fold(v), bias_w, **kw)
        do = torch.randn_like(o)
        bwd_args = (fold(q), fold(k), fold(v), bias_w, o, lse, do)
        t_b = time_ms(torch, lambda: k2.flash_attention_bwd(
            *bwd_args, dropout_rate=0.1, seed=5), 5)
        t_pb = time_ms(torch, lambda: k2.attention_bwd_plain(
            *bwd_args, dropout_rate=0.1, seed=5), 2)
        lib_b, _ = sdpa_ms(fold(q), fold(k), fold(v), bias_w, backward=True,
                           dropout_p=0.1, reps=3)
        scores = b * h * n * w
        scores_d = scores * d
        # f32 runs on the tensor cores in three TF32 passes (both bounds);
        # each also has the special-function floor, one exp a score.
        bounds = bounds_tf32_k2 if dt == torch.float32 else bounds_k2
        bd = bounds(4 * scores_d, nbytes(q, k, v, bias, o, lse), scores)
        # Per (q, k) pair and head-dim element, 2 operations each for the
        # scores, dp, dv, dk and dq products (split: the scores and dp twice).
        bwd_ops = {"fused": 10, "split": 14}[variant]
        bdb = bounds(bwd_ops * scores_d, nbytes(q, k, v, bias, do, lse, o)
                     + nbytes(q, k, v, bias), scores)
        share = lambda t, bnd: max(bnd["bound_ms"], bnd["bound_ms_sfu"]) / t
        glob = (f"global K2 at B{b} {t_g:.3f} ms ({t_g / t_w:.1f}x), "
                if t_g else "")
        log(f"[window] {name}: windowed forward {t_w:.3f} ms "
            f"({scores / t_w / 1e9:.2f} G scores/ms), {glob}plain "
            f"{t_p:.3f} ms, F.scaled_dot_product_attention on the folded "
            f"shape {lib} ms ({lib_note}), bound {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']}, special-function floor "
            f"{bd['bound_ms_sfu']:.4f} ms ({share(t_w, bd):.1%} of the "
            f"larger); backward {variant} dropout 0.1 {t_b:.3f} ms (plain "
            f"{t_pb:.3f}, library {lib_b}, bound {bdb['bound_ms']:.4f} by "
            f"{bdb['bound_by']}, special-function floor "
            f"{bdb['bound_ms_sfu']:.4f}, {share(t_b, bdb):.1%} of the "
            f"larger) on {smi}")
        out["fwd"] |= {
            "window_ms" + sfx: t_w, "window_global_ms" + sfx: t_g,
            "window_plain_ms" + sfx: t_p, "window_library_ms" + sfx: lib,
            "window_bound_ms" + sfx: bd["bound_ms"],
            "window_bound_by" + sfx: bd["bound_by"],
            "window_bound_ms_sfu" + sfx: bd["bound_ms_sfu"],
            "window_max_abs_err" + sfx: max(errs[:2])}
        out["bwd" + ("_f32_d32" if sfx == "_d32" else sfx or "_f32")] = {
            "window_variant": variant, "window_ms": t_b,
            "window_plain_ms": t_pb, "window_library_ms": lib_b,
            "window_bound_ms": bdb["bound_ms"],
            "window_bound_by": bdb["bound_by"],
            "window_bound_ms_sfu": bdb["bound_ms_sfu"],
            "window_max_abs_err": max(errs[2:])}
        # The window bodies against the mma.sync ones they replaced.
        fq, fk, fv = fold(q), fold(k), fold(v)
        fwd = {}
        for rate in (0.0, 0.1):
            kwr = dict(dropout_rate=rate, seed=5)
            fwd[rate] = narrow_turns(torch, lambda body: batched_ms(
                torch, lambda: k2.forward_kernel(
                    fq, fk, fv, bias_w, body=body, **kwr)),
                k2.forward_instance(dt, d, w, w, rate).body,
                f"[window] {name} forward kernel, dropout {rate}, 20 "
                "calls queued", smi, new="window", body="window")
        bwd = narrow_turns(torch, lambda body: batched_ms(
            torch, lambda: k2.flash_attention_bwd(
                *bwd_args, body=body, dropout_rate=0.1, seed=5)),
            body, f"[window] {name} backward call (fused), dropout 0.1, "
            "20 calls queued", smi, new="window", body="window")
        key = f"{'f32_' if f32 else ''}d{d}"
        out["window_fwd"][key] = {
            "ms": fwd[0.0]["ms"], "earlier_ms": fwd[0.0]["earlier_ms"],
            "ms_dropout": fwd[0.1]["ms"],
            "earlier_ms_dropout": fwd[0.1]["earlier_ms"],
            "plain_ms": t_p, "library_ms": lib, **bd,
            "max_abs_err": max(errs[:2]),
            "shape": f"B{b} H{h} N{n} W{w} d{d} {str(dt)[6:]} "
                     "dropout 0"}
        out["window_bwd"][key] = {
            "ms": bwd["ms"], "earlier_ms": bwd["earlier_ms"],
            "plain_ms": t_pb, "library_ms": lib_b, **bdb,
            "max_abs_err": max(errs[2:]),
            "shape": f"B{b} H{h} N{n} W{w} d{d} {str(dt)[6:]} "
                     "dropout 0.1, the whole call"}
        del fq, fk, fv
        del q, k, v, o, lse, do, bwd_args
    return out


def _images(path: Path, n: int, size: int, seed: int) -> None:
    import numpy as np
    from PIL import Image
    r = np.random.default_rng(seed)
    for i in range(n):
        Image.fromarray(r.integers(0, 256, (size, size, 3), dtype=np.uint8)
                        ).save(path / f"s{size}_{i}.png")


def run_evaluate(torch, tmp: Path, smi: str) -> dict:
    """Phase 16 (b): `lunaris-evaluate-torch` on the card at the full
    default width: 16 PNGs at 128 px, an 8-sprite shard and 2 PNGs at 120
    px (14,400 tokens: window 256 falls back to global), global and with
    --attn_window 256, f32 and bf16; the K2 launches of each run; then one
    16-sprite batch timed by CUDA events in each mode, and at 64 px the
    card's scores against the CPU's (bar 1e-3, as phase 6)."""
    import numpy as np
    from PIL import Image
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.cli import evaluate as cli
    from lunaris_orion_tpu_torch.infer.evaluator import QualityEvaluator
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2

    cfg = TrainConfig()
    ckpt = tmp / "eval.pt"
    save_checkpoint(torch, cfg, ckpt, seed=5)
    inp = tmp / "eval_in"
    inp.mkdir()
    _images(inp, 16, 128, 1)
    _images(inp, 2, 120, 2)
    np.save(inp / "sprites_0.npy", np.random.default_rng(3).integers(
        0, 256, (8, 128, 128, 3), dtype=np.uint8))
    out, scores = {}, {}
    for window in (None, WINDOW):
        for bf16 in (False, True):
            mode = (f"{'window ' + str(window) if window else 'global'} "
                    f"{'bf16' if bf16 else 'f32'}")
            res = tmp / f"scores_{window}_{bf16}.json"
            argv = ["--checkpoint", str(ckpt), "--input", str(inp),
                    "--output", str(res), "--device", "cuda"]
            argv += (["--attn_window", str(window)] if window else [])
            argv += (["--bf16"] if bf16 else [])
            k2.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = k2.launches
            got = json.loads(res.read_text())
            fallback = sorted(k for k, v in got.items() if "attn_mode" in v)
            q = [v["mean_quality"] for v in got.values()]
            if (rc != 0 or len(got) != 26 or launches <= 0
                    or len(fallback) != (2 if window else 0)
                    or not all(0.0 <= x <= 1.0 for x in q)):
                raise AssertionError(f"evaluate {mode}: rc {rc}, {len(got)} "
                                     f"scores, fallback {fallback}, K2 "
                                     f"launches {launches}")
            scores[(window, bf16)] = got
            ev = QualityEvaluator(str(ckpt), attn_window=window, bf16=bf16)
            batch = np.stack([np.asarray(Image.open(
                inp / f"s128_{i}.png").convert("RGB")) for i in range(16)])
            seen = (k2.launches, k2.window_launches)
            ev.score_batch(batch)
            per_batch = k2.launches - seen[0]
            on_window = k2.window_launches - seen[1]
            if window:
                # Every K2 launch of a windowed batch on the window body
                # (f32: flash_fwd_window_tf32), by the wrapper's count and
                # by name.
                kind = "bf16" if bf16 else "f32"
                tag = f"evaluate window {window} {kind}, a batch of 16"
                names = {}
                device_share(torch, lambda: ev.score_batch(batch), tag, smi,
                             k2_names=names)
                check_narrow_names(names, on_window, 0, tag, every=True,
                                   kind="window" if bf16 else "f32 window")
                if on_window != per_batch:
                    raise AssertionError(f"{tag}: {per_batch} K2 launches, "
                                         f"{on_window} on the window body")
                out[f"evaluate_window_{kind}_window_launches"] = on_window
            ms = time_ms(torch, lambda: ev.score_batch(batch), 3)
            key = (("window" if window else "global")
                   + ("_bf16" if bf16 else "_f32"))
            out |= {f"evaluate_{key}_ms": ms, f"evaluate_{key}_launches":
                    per_batch, f"evaluate_{key}_run_launches": launches}
            log(f"[evaluate] {mode}: 26 sprites (2 by the global fallback) "
                f"in {dt:.1f} s by the CLI (load and PNG reads included), "
                f"K2 launches {launches}; one batch of 16 at 128 px "
                f"{ms:.1f} ms = {16 / ms * 1e3:.1f} sprites/s, {per_batch} K2 "
                f"launches a batch, on {smi}; mean quality "
                f"{float(np.mean(q)):.4f}")
            del ev
    for bf16 in (False, True):
        a, b = scores[(None, bf16)], scores[(WINDOW, bf16)]
        diff = max(abs(a[k]["mean_quality"] - b[k]["mean_quality"])
                   for k in a if "attn_mode" not in b[k])
        same = max(abs(a[k]["mean_quality"] - b[k]["mean_quality"])
                   for k in a if "attn_mode" in b[k])
        log(f"[evaluate] {'bf16' if bf16 else 'f32'}: window {WINDOW} against"
            f" global, mean quality moves by up to {diff:.2e}; the fallback "
            f"entries by {same:.2e}")
    for bf16 in (False, True):
        key = "_bf16" if bf16 else "_f32"
        out[f"evaluate_speedup{key}"] = (out[f"evaluate_global{key}_ms"]
                                         / out[f"evaluate_window{key}_ms"])
    # 64 px (N = 4096, 16 windows): the card against the CPU.
    small = TrainConfig(image_size=64, latent_dim=64, feature_dim=128,
                        embedding_dim=32, num_experts=2)
    ck64 = tmp / "eval64.pt"
    save_checkpoint(torch, small, ck64, seed=6)
    x = np.random.default_rng(7).integers(0, 256, (4, 64, 64, 3),
                                          dtype=np.uint8)
    res = {dev: QualityEvaluator(str(ck64), attn_window=WINDOW,
                                 device=dev).score_batch(x)
           for dev in ("cpu", "cuda")}
    worst = max(abs(a[f] - b[f]) for a, b in zip(res["cpu"], res["cuda"])
                for f in ("mean_quality", "semantic_score", "edge_quality",
                          "color_consistency", "detail", "overall"))
    gate = max(abs(x - y) for a, b in zip(res["cpu"], res["cuda"])
               for x, y in zip(a["expert_weights"], b["expert_weights"]))
    log(f"[evaluate] 64 px window {WINDOW}, f32: card against CPU, scores "
        f"max diff {worst:.3e}, gate {gate:.3e} (bar 1e-3)")
    if worst > 1e-3 or gate > 1e-3:
        raise AssertionError("evaluate: the card's windowed scores disagree "
                             "with the CPU's at 64 px")
    out["evaluate_card_cpu_diff"] = max(worst, gate)
    return out


WINDOW_COUNTERS = (("gn_mish", "k1", "launches"),
                   ("flash_attention_fwd", "k2", "launches"),
                   ("flash_attention_bwd_fused", "k2", "bwd_fused_launches"),
                   ("flash_attention_bwd_dq", "k2", "bwd_dq_launches"),
                   ("flash_attention_bwd_dkv", "k2", "bwd_dkv_launches"),
                   ("mse_kl", "k3", "launches"),
                   ("flash_attention_fwd_wgmma_narrow", "k2",
                    "narrow_launches"),
                   ("flash_attention_bwd_wgmma_narrow", "k2",
                    "bwd_narrow_launches"),
                   ("flash_attention_fwd_window", "k2", "window_launches"),
                   ("flash_attention_bwd_window", "k2",
                    "bwd_window_launches"))


def _counts(mods: dict, reset: bool = False) -> dict:
    counts = {}
    for key, mod, attr in WINDOW_COUNTERS:
        if reset:
            setattr(mods[mod], attr, 0)
        counts[key] = getattr(mods[mod], attr)
    return counts


def run_window_train(torch, smi: str, mods: dict) -> dict:
    """Phase 16 (c): the bf16 train step at the full default width, 16 x 2,
    remat, --attn_window 256: a cold step, then one under torch.profiler
    (its launches are column W); fuse_teacher against the unfused step in
    turns (unfused, fused, fused, unfused); one step with cached prompt
    embeddings (from `make_embed_step`) and one with bf16_momentum."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.train.state import create_state, state_for
    from lunaris_orion_tpu_torch.train.step import (make_embed_step,
                                                    make_train_step)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(mixed_precision=True, attn_window=WINDOW)
    state = create_state(cfg, "cuda", 1)
    before = [p.detach().clone() for p in state.teacher.parameters()]
    g = torch.Generator(device="cuda").manual_seed(16)
    images = lambda: torch.randint(0, 256, (2, 16, 128, 128, 3),
                                   dtype=torch.uint8, device="cuda",
                                   generator=g)
    out = {}

    def run(step, label, *extra):
        batch = images()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = step(state, batch, *extra)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = {k: float(v) for k, v in m.items()}
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"window train {label}: non-finite {losses}")
        return dt, losses

    step = make_train_step(cfg, remat=True)
    dt, _ = run(step, "cold")
    log(f"[window train] cold bf16 step, window {WINDOW}: {dt * 1e3:.0f} ms")
    _counts(mods, reset=True)
    torch.cuda.reset_peak_memory_stats()
    batch = images()
    tag = f"train step bf16 window {WINDOW} remat on"
    names = {}
    (_, m), host_s, k1_kernels, dev_ms = device_share(
        torch, lambda: step(state, batch), tag, smi, k2_names=names)
    launches = _counts(mods)
    check_k1_kernels(k1_kernels, launches["gn_mish"], tag)
    # The windowed fold takes the window bodies: every K2 launch of the
    # step, by the wrappers' counts and by name; none on the narrow or the
    # mma.sync bodies.
    check_narrow_names(names, launches["flash_attention_fwd_wgmma_narrow"],
                       launches["flash_attention_bwd_wgmma_narrow"], tag)
    check_narrow_names(names, launches["flash_attention_fwd_window"],
                       launches["flash_attention_bwd_window"], tag,
                       kind="window", every=True)
    if (launches["flash_attention_fwd_window"],
            launches["flash_attention_bwd_window"]) != (
            launches["flash_attention_fwd"],
            launches["flash_attention_bwd_fused"]) or launches[
            "flash_attention_fwd_wgmma_narrow"]:
        raise AssertionError(f"{tag}: K2 launches off the window bodies: "
                             f"{launches}")
    for key in ("gn_mish", "flash_attention_fwd", "flash_attention_bwd_fused",
                "mse_kl"):
        if launches[key] <= 0:
            raise AssertionError(f"{tag}: {key} never launched: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    out |= {"step_ms": host_s * 1e3, "step_sprites_s": 32 / host_s,
            "step_device_ms": dev_ms,
            "step_idle": max(0.0, 1 - dev_ms / (host_s * 1e3)),
            "step_peak_gib": peak, "launches": launches}
    log(f"[window train] {tag}: {host_s * 1e3:.0f} ms = {32 / host_s:.2f} "
        f"sprites/s, device {dev_ms:.0f} ms, peak {peak:.1f} GiB, total_loss "
        f"{float(m['total_loss']):.5f}; launches {launches} on {smi}")
    fused = make_train_step(cfg.replace(fuse_teacher=True), remat=True)
    t = [run(s, label)[0] * 1e3 for s, label in
         ((step, "unfused"), (fused, "fused"), (fused, "fused"),
          (step, "unfused"))]
    out |= {"fuse_ms": min(t[1:3]), "unfused_ms": min(t[0], t[3])}
    log(f"[window train] fuse_teacher A/B in turns: unfused {t[0]:.0f}, "
        f"fused {t[1]:.0f}, fused {t[2]:.0f}, unfused {t[3]:.0f} ms on {smi}")
    ccfg = cfg.replace(cached_prompt_embeddings=True)
    batch = images()
    embed = make_embed_step(ccfg)
    e_ms = time_ms(torch, lambda: embed(state, batch[0]), 3)
    pe = torch.stack([embed(state, b) for b in batch])
    cached = make_train_step(ccfg, remat=True)
    run(cached, "cached", pe)       # warm
    dt, _ = run(cached, "cached", pe)
    out |= {"cached_ms": dt * 1e3, "embed_ms": e_ms}
    log(f"[window train] cached prompt embeddings: step {dt * 1e3:.0f} ms "
        f"(embed step, 16 sprites: {e_ms:.1f} ms) on {smi}")
    mcfg = cfg.replace(bf16_momentum=True)
    state = state_for(mcfg, state.vae, state.teacher, step=state.step,
                      generator=state.generator)
    mstep = make_train_step(mcfg, remat=True)
    run(mstep, "bf16_momentum")
    dt, _ = run(mstep, "bf16_momentum")
    p0 = state.teacher_opt.params[0]
    if state.teacher_opt.opt.state[p0]["exp_avg"].dtype != torch.bfloat16:
        raise AssertionError("bf16_momentum: the first moment is not bf16")
    moved = sum(not torch.equal(a, b.detach())
                for a, b in zip(before, state.teacher.parameters()))
    out["momentum_ms"] = dt * 1e3
    log(f"[window train] bf16_momentum: step {dt * 1e3:.0f} ms; "
        f"{moved}/{len(before)} teacher tensors moved on {smi}")
    if moved == 0:
        raise AssertionError("window train: the teacher did not move")
    return out


def run_window_train_f32(torch, smi: str, mods: dict) -> dict:
    """Phase 16 (c), f32: the train step at the CLIs' default precision
    (mixed_precision off) at the full default width, 16 x 2, remat, dropout
    0.1, --attn_window 256: a cold step, then one under torch.profiler (its
    launches are the f32 window bodies' column of PERF.md's table): every
    K2 forward on `flash_fwd_window_tf32` and every fused backward on
    `flash_bwd_fused_tf32` (the bodies `window_default` takes there), by
    the wrappers' counts and by name, none of the pre-pass, the f32
    warpgroup bodies or `flash_fwd_tf32`; its host and device ms, idle
    share, K2 ms by group and peak memory."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step
    k2 = mods["k2"]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = TrainConfig(mixed_precision=False, attn_window=WINDOW)
    state = create_state(cfg, "cuda", 1)
    g = torch.Generator(device="cuda").manual_seed(32)
    images = lambda: torch.randint(0, 256, (2, 16, 128, 128, 3),
                                   dtype=torch.uint8, device="cuda",
                                   generator=g)
    step = make_train_step(cfg, remat=True)
    batch = images()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, batch)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    _counts(mods, reset=True)
    others = (k2.split_launches, k2.tf32_wgmma_launches,
              k2.bwd_tf32_wgmma_launches)
    torch.cuda.reset_peak_memory_stats()
    batch = images()
    tag = f"train step f32 window {WINDOW} remat on"
    names, groups = {}, {}
    (_, m), host_s, k1_kernels, dev_ms = device_share(
        torch, lambda: step(state, batch), tag, smi, k2_names=names,
        groups=groups)
    launches = _counts(mods)
    check_k1_kernels(k1_kernels, launches["gn_mish"], tag)
    # Every K2 forward of the step on the f32 window body, every fused
    # backward on flash_bwd_fused_tf32: by the wrappers' counts and by name;
    # no pre-pass, no f32 warpgroup body, no window backward.
    check_narrow_names(names, launches["flash_attention_fwd_window"],
                       launches["flash_attention_bwd_window"], tag,
                       kind="f32 window")
    by_name = lambda part: sum(c for n, c in names.items() if part in n)
    moved = [b - a for a, b in zip(others, (
        k2.split_launches, k2.tf32_wgmma_launches, k2.bwd_tf32_wgmma_launches))]
    if (launches["flash_attention_fwd_window"],
            launches["flash_attention_bwd_window"]) != (
            launches["flash_attention_fwd"], 0) or any(moved) or min(
            launches[key] for key in ("gn_mish", "flash_attention_fwd",
                                      "flash_attention_bwd_fused",
                                      "mse_kl")) <= 0 or by_name(
            "flash_bwd_fused_tf32") != launches["flash_attention_bwd_fused"] \
            or by_name("flash_fwd_tf32<") or by_name("wgmma_tf32"):
        raise AssertionError(f"{tag}: K2 launches off the rule's bodies: "
                             f"{launches}, by name {names}, pre-pass and f32 "
                             f"warpgroup bodies {moved}")
    losses = {k: float(v) for k, v in m.items()}
    if not all(map(math.isfinite, losses.values())):
        raise AssertionError(f"{tag}: non-finite {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    k2_ms = {key: groups.get(key, 0.0) for key in ("K2 fwd", "K2 bwd fused")}
    out = {"step_ms": host_s * 1e3, "step_sprites_s": 32 / host_s,
           "step_device_ms": dev_ms, "cold_ms": cold * 1e3,
           "step_idle": max(0.0, 1 - dev_ms / (host_s * 1e3)),
           "step_peak_gib": peak, "k2_fwd_ms": k2_ms["K2 fwd"],
           "k2_bwd_ms": k2_ms["K2 bwd fused"], "launches": launches}
    log(f"[window train] {tag}: cold {cold * 1e3:.0f} ms; {host_s * 1e3:.0f} "
        f"ms = {32 / host_s:.2f} sprites/s, device {dev_ms:.1f} ms (idle "
        f"{out['step_idle']:.1%}), K2 forward {k2_ms['K2 fwd']:.1f} ms, "
        f"backward {k2_ms['K2 bwd fused']:.1f} ms, peak {peak:.1f} GiB, "
        f"total_loss {losses['total_loss']:.5f}; launches {launches} on {smi}")
    return out


def run_window_trainer(torch, tmp: Path, smi: str, mods: dict) -> dict:
    """Phase 16 (d): `lunaris-train` of the port with --attn_window 256
    --cached_prompt_embeddings --bf16_momentum --mixed_precision on a
    40-sprite procedural corpus (32 train: one step of 16 x 2 an epoch):
    one epoch, then a resume from the directory whose restored state equals
    the saved file bit for bit and takes one more epoch; the table's
    refresh ms. Counts are set to 0 before the first run and read after."""
    from lunaris_orion_tpu_torch.cli import train as train_cli
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    data = write_synthetic_dataset(tmp / "sprites40", 40, image_size=128)
    ck = tmp / "wrun" / "checkpoints"
    argv = ["--data_dir", str(data), "--mixed_precision", "--val_fraction",
            "0.2", "--log_every", "1", "--save_every", "0",
            "--eval_save_freq", "0", "--sample_every", "0", "--num_epochs",
            "1", "--attn_window", str(WINDOW), "--cached_prompt_embeddings",
            "--bf16_momentum"]
    _counts(mods, reset=True)
    t0 = time.perf_counter()
    rc = train_cli.main(argv + ["--output_dir", str(tmp / "wrun")])
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _counts(mods)
    if rc != 0 or min(launches[k] for k in (
            "gn_mish", "flash_attention_fwd", "flash_attention_bwd_fused",
            "mse_kl")) <= 0:
        raise AssertionError(f"window trainer: rc {rc}, launches {launches}")
    text = (tmp / "wrun" / "training.log").read_text()
    refresh = [float(x) for x in re.findall(
        r"Prompt-embedding table refreshed \(40 samples, ([\d.]+) ms\)", text)]
    plan = re.search(r"Memory plan: batch (\d+), remat=(\w+), peak "
                     r"([\d.]+) GiB", text)
    if not refresh or plan is None:
        raise AssertionError("window trainer: no table refresh or memory plan "
                             "in training.log")
    steps = sorted(int(p.stem) for p in (ck / "steps").glob("*.pt"))
    trainer = train_cli.trainer_from_args(
        argv + ["--output_dir", str(tmp / "wresumed"), "--resume_from",
                str(ck)])
    n_equal = state_equals_file(torch, trainer.state,
                                ck / "steps" / f"{steps[-1]}.pt")
    start = trainer.state.step
    trainer.train()
    p0 = trainer.state.vae_opt.params[0]
    if (trainer.state.step != start + 1 or
            trainer.state.vae_opt.opt.state[p0]["exp_avg"].dtype
            != torch.bfloat16):
        raise AssertionError("window trainer: the resumed epoch did not step "
                             "with a bf16 first moment")
    refresh += [float(x) for x in re.findall(
        r"Prompt-embedding table refreshed \(40 samples, ([\d.]+) ms\)",
        (tmp / "wresumed" / "training.log").read_text())]
    ips = re.findall(r"\| ([\d.]+) sprites/s \(", text)
    log(f"[window trainer] 1 epoch (1 step of 16 x 2) in {t_run:.1f} s, "
        f"plan batch {plan.group(1)} remat={plan.group(2)} peak "
        f"{plan.group(3)} GiB, epoch sprites/s {ips}; launches {launches}; "
        f"table refresh (40 sprites, eval mode, bf16) ms {refresh}; resume: "
        f"{n_equal} tensors bit-equal to step {steps[-1]}'s file, one more "
        f"step with a bf16 first moment, on {smi}")
    return {"launches": launches, "refresh_ms": refresh}


# --- phase 17: serving export, checkpoint conversion, dataset synthesis ----

# Phase 17's bundles: the "cuda" form in bf16 (generate and score at batch
# 8; generate at batch 2) and f32 (generate at 8), the "plain" form in bf16
# (generate at 2).
BUNDLES = {
    "cuda_bf16": dict(batch_sizes=(8,), functions=("generate", "score"),
                      bf16=True),
    "cuda_bf16_b2": dict(batch_sizes=(2,), functions=("generate",),
                         bf16=True),
    "cuda_f32": dict(batch_sizes=(8,), functions=("generate",)),
    "plain_bf16": dict(batch_sizes=(2,), functions=("generate",), bf16=True,
                       attn="plain"),
}
# (bundle, function, input) of the calls the serving process makes.
SERVE_CALLS = (("cuda_bf16", "generate", "z8"), ("cuda_bf16", "score", "u8"),
               ("cuda_bf16_b2", "generate", "z2"),
               ("cuda_f32", "generate", "z8"),
               ("plain_bf16", "generate", "z2"))


def _same_tensors(torch, a, b, where: str) -> int:
    """Raise unless a and b hold the same structure and every tensor the
    same dtype, shape and bits; returns the number of tensors."""
    if isinstance(a, torch.Tensor):
        bits = lambda t: t.contiguous().reshape(-1).view(torch.uint8)
        if not (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(bits(a), bits(b))):
            raise AssertionError(f"convert: {where} differs")
        return 1
    if isinstance(a, dict):
        if set(a) != set(b):
            raise AssertionError(f"convert: keys of {where} differ")
        return sum(_same_tensors(torch, a[k], b[k], f"{where}[{k!r}]")
                   for k in a)
    if isinstance(a, (list, tuple)):
        return sum(_same_tensors(torch, x, y, f"{where}[{i}]")
                   for i, (x, y) in enumerate(zip(a, b, strict=True)))
    if a != b:
        raise AssertionError(f"convert: {where} differs")
    return 0


def serve_bundles(torch, tmp: Path) -> int:
    """Phase 17 (c) and (d), in a process of its own that imports no model
    module: load the bundles under `tmp`, run SERVE_CALLS on the inputs the
    parent saved, save the outputs; then one bf16 generate and one score
    at batch 8 under torch.profiler, with the wrappers' counts set to 0
    before each and read after, and the kernels counted by name."""
    from torch.autograd import DeviceType
    from lunaris_orion_tpu_torch.infer.exporter import ServingBundle
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    inputs = torch.load(tmp / "inputs.pt")
    bundles, outputs, report = {}, {}, {"load_s": {}, "launches": {},
                                        "kernels": {}}
    for name, function, key in SERVE_CALLS:
        x = inputs[key].cuda()
        t0 = time.perf_counter()
        bundle = bundles.setdefault(name, ServingBundle(str(tmp / name)))
        bundle.program(function, x.shape[0])
        report["load_s"][f"{name}/{function}"] = time.perf_counter() - t0
        outputs[f"{name}/{function}"] = [o.cpu() for o in
                                         bundle.run(function, x)]
    for function, key in (("generate", "z8"), ("score", "u8")):
        x = inputs[key].cuda()
        k1.launches = k2.launches = 0
        with profiled(torch) as p:
            bundles["cuda_bf16"].run(function, x)
        report["launches"][function] = {"gn_mish": k1.launches,
                                        "flash_attention_fwd": k2.launches}
        names = {}
        for e in p.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            for kernel in ("gn_stats_partial", "gn_mish_apply_fold",
                           "flash_fwd"):
                if kernel in e.key:
                    names[kernel] = names.get(kernel, 0) + e.count
        report["kernels"][function] = names
    report["model_modules"] = sorted(
        m for m in sys.modules if m.startswith("lunaris_orion_tpu_torch.models")
        or m.split(".")[0] in ("jax", "lunaris_orion_tpu"))
    torch.save(outputs, tmp / "outputs.pt")
    (tmp / "serve.json").write_text(json.dumps(report))
    return 0


def _export_bundles(tmp: str) -> None:
    """Phase 17 (b) in a process of its own (two threads), which `main`
    starts after phase 3 so that its host-bound exports run under phase
    4: the seeded checkpoint tmp/serve.pt and
    `export_serving_bundle` of BUNDLES into tmp/<bundle>, each program's
    export seconds and size against weights.bin, and the lines to log, in
    tmp/exports.json."""
    import torch
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.exporter import export_serving_bundle
    torch.set_num_threads(2)
    tmp = Path(tmp)
    ckpt = tmp / "serve.pt"
    save_checkpoint(torch, TrainConfig(), ckpt, seed=17)
    out = {"export_s": {}, "program_mb": {}, "lines": []}
    for name, kw in BUNDLES.items():
        t0 = time.perf_counter()
        manifest = export_serving_bundle(str(ckpt), str(tmp / name), **kw)
        wmb = (tmp / name / "weights.bin").stat().st_size / 2**20
        for key, e in manifest["functions"].items():
            mb = (tmp / name / e["file"]).stat().st_size / 2**20
            out["export_s"][f"{name}/{key}"] = e["export_seconds"]
            out["program_mb"][f"{name}/{key}"] = mb
            out["lines"].append(
                f"[serve] export {name} {key}: {e['export_seconds']:.1f} s, "
                f"{mb:.2f} MB against weights.bin {wmb:.1f} MB")
        out["lines"].append(f"[serve] bundle {name} in "
                            f"{time.perf_counter() - t0:.1f} s")
    (tmp / "exports.json").write_text(json.dumps(out))


def run_serving(torch, tmp: Path, smi: str, exporter) -> dict:
    """Phase 17 at the full default width, from a seeded checkpoint:
    (a) `lunaris-convert-torch` to-port then to-torch, bit-equal to the
    input; (b) `export_serving_bundle` of BUNDLES, each program's export
    seconds and size against weights.bin (`_export_bundles`, in the
    process `exporter` that `main` started before phase 4: joined here);
    (c) the bundles loaded and run
    in a second process that imports no model module (`--serve`), against
    eager: generate against `decode_and_score` (uint8 within 1/255, scores
    within 1e-3), score against the teacher (1e-3), the plain batch-2
    program against the "cuda" one (K2's bf16 bar on the scores, 2/255 on
    the images); (d) K1's two kernels 4 times and the K2 forward 12 times
    by name in a bf16 generate, the K2 forward 12 times in a score; (e)
    bundle against eager in turns (eager, bundle, bundle, eager)."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.cli import convert
    from lunaris_orion_tpu_torch.infer.exporter import ServingBundle
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator, full_f32
    t_phase = time.perf_counter()
    cfg = TrainConfig()
    ckpt = tmp / "serve.pt"
    exporter.join()
    if exporter.exitcode:
        raise AssertionError(f"phase 17's exports failed ({exporter.exitcode})")
    exports = json.loads((tmp / "exports.json").read_text())

    # (a) convert
    t0 = time.perf_counter()
    if convert.main(["to-port", "--checkpoint", str(ckpt), "--out",
                     str(tmp / "ported")]) != 0 or convert.main([
            "to-torch", "--checkpoint", str(tmp / "ported"), "--out",
            str(tmp / "back.pt")]) != 0:
        raise AssertionError("convert: a direction failed")
    n = _same_tensors(torch, torch.load(ckpt, weights_only=True),
                      torch.load(tmp / "back.pt", weights_only=True), "ckpt")
    log(f"[serve] convert to-port, to-torch: {n} tensors bit-equal to the "
        f"input in {time.perf_counter() - t0:.1f} s")

    # (b) export (under phase 4)
    for line in exports.pop("lines"):
        log(line)
    out = exports

    # (c), (d) in a process that imports no model module
    g = torch.Generator().manual_seed(17)
    z8 = torch.randn(8, cfg.latent_dim, generator=g)
    inputs = {"z8": z8, "z2": z8[:2].clone(),
              "u8": torch.randint(0, 256, (8, 128, 128, 3), generator=g,
                                  dtype=torch.uint8)}
    torch.save(inputs, tmp / "inputs.pt")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--serve", str(tmp)], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serving process: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    report = json.loads((tmp / "serve.json").read_text())
    outputs = torch.load(tmp / "outputs.pt")
    log(f"[serve] serving process in {time.perf_counter() - t0:.1f} s; load "
        f"s {json.dumps({k: round(v, 2) for k, v in report['load_s'].items()})}"
        f"; model modules imported: {report['model_modules']}")
    if report["model_modules"]:
        raise AssertionError(f"the serving process imported "
                             f"{report['model_modules']}")
    gens = {bf16: ImageGenerator(str(ckpt), device="cuda", bf16=bf16)
            for bf16 in (False, True)}
    u8 = lambda imgs: ((imgs.float() + 1.0) * 127.5).clamp(0, 255).to(
        torch.uint8)
    errs = {}
    for name, bf16, key in (("cuda_bf16", True, "z8"),
                            ("cuda_f32", False, "z8"),
                            ("cuda_bf16_b2", True, "z2")):
        imgs, q, sem = (t.cpu() for t in gens[bf16].decode_and_score(
            inputs[key].cuda()))
        got = outputs[f"{name}/generate"]
        errs[name] = ((got[0].int() - u8(imgs).int()).abs().max().item(),
                      (got[1] - q).abs().max().item(),
                      (got[2] - sem).abs().max().item())
        if errs[name][0] > 1 or max(errs[name][1:]) > 1e-3:
            raise AssertionError(f"bundle {name} generate against eager: "
                                 f"{errs[name]}")
    teacher = gens[True].teacher
    score = lambda x: teacher(x.to(torch.bfloat16) / 127.5 - 1.0)
    with torch.no_grad(), full_f32():
        ref = score(inputs["u8"].cuda())
    ref = [ref["quality_scores"], ref["expert_weights"],
           ref["semantic_score"][:, 0], ref["style_embedding"]]
    errs["score"] = max((o - r.float().cpu()).abs().max().item()
                        for o, r in zip(outputs["cuda_bf16/score"], ref))
    if errs["score"] > 1e-3:
        raise AssertionError(f"bundle score against eager: {errs['score']}")
    plain, cuda = outputs["plain_bf16/generate"], outputs[
        "cuda_bf16_b2/generate"]
    img_err = (plain[0].int() - cuda[0].int()).abs().max().item()
    bar_ok = all(bool(((p - c).abs() <= 2 * bf16_ulp(torch, c)
                       + 1e-3 * c.abs().max()).all())
                 for p, c in zip(plain[1:], cuda[1:]))
    errs["plain_vs_cuda"] = (img_err, max((p - c).abs().max().item()
                                          for p, c in zip(plain[1:],
                                                          cuda[1:])))
    log(f"[serve] against eager (uint8 max diff, quality, semantic; score: "
        f"the largest; plain_vs_cuda: uint8, scores): {json.dumps(errs)}")
    want = {"generate": ({"gn_mish": 4, "flash_attention_fwd": 12},
                         {"gn_stats_partial": 4, "gn_mish_apply_fold": 4,
                          "flash_fwd": 12}),
            "score": ({"gn_mish": 0, "flash_attention_fwd": 12},
                      {"flash_fwd": 12})}
    for function, (counts, kernels) in want.items():
        if (report["launches"][function] != counts
                or report["kernels"][function] != kernels):
            raise AssertionError(
                f"bundle {function}: launches {report['launches'][function]}"
                f", kernels {report['kernels'][function]}; expected {counts}"
                f", {kernels}")
    log(f"[serve] launches inside the loaded programs (wrappers; profiler by "
        f"name): {json.dumps(report['launches'])}; "
        f"{json.dumps(report['kernels'])}")
    out |= {"launches": report["launches"], "load_s": report["load_s"],
            "errs": errs}

    # (e) times, bundle against eager in turns
    for label, name, bf16, function, x in (
            ("generate bf16", "cuda_bf16", True, "generate", z8),
            ("generate f32", "cuda_f32", False, "generate", z8),
            ("score bf16", "cuda_bf16", True, "score", inputs["u8"])):
        bundle = ServingBundle(str(tmp / name))
        x = x.cuda()
        if function == "generate":
            eager = lambda: gens[bf16].decode_and_score(x)
        else:
            def eager():
                with torch.no_grad(), full_f32():
                    return score(x)
        run = lambda: bundle.run(function, x)
        t = [time_ms(torch, fn, 5) for fn in (eager, run, run, eager)]
        out[f"{function}_{'bf16' if bf16 else 'f32'}_ms"] = {
            "eager": min(t[0], t[3]), "bundle": min(t[1:3])}
        log(f"[serve] {label} batch 8 in turns (eager, bundle, bundle, "
            f"eager): {', '.join(f'{v:.2f}' for v in t)} ms on {smi}")
    log(f"[serve] (a)-(e) in {time.perf_counter() - t_phase:.0f} s")
    if img_err > 2 or not bar_ok:
        raise AssertionError(f"plain against cuda program at batch 2: "
                             f"{errs['plain_vs_cuda']}")
    return out


def _pixelate_card_cpu(torch, sprites) -> tuple:
    """`pixelate_device` of uint8 sprites on the card and on the CPU, TF32
    off: (the Lanczos filter's max abs difference on [0, 1] values, the
    share of output pixels of the same palette colour)."""
    from lunaris_orion_tpu_torch.infer.generator import full_f32
    from lunaris_orion_tpu_torch.ops import image_ops
    with full_f32():
        lz = [image_ops.lanczos_downscale(s.float() / 255.0, 8).cpu()
              for s in (sprites.cuda(), sprites.cpu())]
        px = [image_ops.pixelate_device(s).cpu()
              for s in (sprites.cuda(), sprites.cpu())]
    return ((lz[0] - lz[1]).abs().max().item(),
            (px[0] == px[1]).all(dim=-1).float().mean().item())


def run_synthesis(torch, tmp: Path, smi: str) -> dict:
    """Phase 17 (g), then (f): `lunaris-synthesize-torch` writes a
    procedural corpus of 50 sprites at 128 px that the port's BatchLoader
    reads onto the card; `pixelate_device` (pixel_size 8, 64 colours) card
    against CPU with TF32 off on the 16 sprites the bundles generated in
    (c), whose share is held: the Lanczos filter within 1e-4 (on [0, 1]
    values), at least 99.9 % of pixels given the same palette colour; its
    ms by CUDA events. The same comparison on 16 procedural sprites is
    logged, not held: their blocks make exact distance ties, which the
    last bit of rounding may break one way on the card and another on the
    CPU, and their content changes from run to run with Python's string
    hash (99.88-99.98 % in two runs, with the JAX package's expanded
    distances, which `image_ops` no longer uses)."""
    import numpy as np
    from lunaris_orion_tpu_torch.cli import synthesize
    from lunaris_orion_tpu_torch.data import BatchLoader, SpriteDataset
    from lunaris_orion_tpu_torch.ops import image_ops
    t0 = time.perf_counter()
    corpus = tmp / "corpus"
    if synthesize.main(["--output_dir", str(corpus), "--total", "50",
                        "--batch_size", "25", "--seed", "0",
                        "--no_pngs"]) != 0:
        raise AssertionError("synthesize failed")
    ds = SpriteDataset(str(corpus))
    batches = list(BatchLoader(ds, np.arange(len(ds)), batch_size=16,
                               device="cuda", squeeze_accum=True))
    if len(ds) != 50 or len(batches) != 3 or batches[0].dtype != torch.uint8 \
            or batches[0].shape != (16, 128, 128, 3):
        raise AssertionError(f"synthesized corpus: {len(ds)} sprites, "
                             f"{len(batches)} batches")
    t_synth = time.perf_counter() - t0
    outputs = torch.load(tmp / "outputs.pt")
    sprites = torch.cat([outputs["cuda_bf16/generate"][0],
                         outputs["cuda_f32/generate"][0]]).cuda()
    lz_err, same = _pixelate_card_cpu(torch, sprites)
    lz_corpus, same_corpus = _pixelate_card_cpu(torch, batches[0])
    ms = time_ms(torch, lambda: image_ops.pixelate_device(sprites), 5)
    log(f"[synth] lunaris-synthesize-torch: 50 sprites in {t_synth:.1f} s, "
        f"read by BatchLoader onto the card in 3 batches of 16; "
        f"pixelate_device 16 x 128 px: {ms:.2f} ms on {smi}; card against "
        f"CPU on the generated sprites: Lanczos max_abs_err {lz_err:.2e}, "
        f"{same:.4%} of pixels the same palette colour; on 16 procedural "
        f"sprites (logged only): {lz_corpus:.2e}, {same_corpus:.4%}")
    if lz_err > 1e-4 or same < 0.999:
        raise AssertionError(f"pixelate_device card against CPU: Lanczos "
                             f"{lz_err}, same colour {same}")
    return {"pixelate_ms": ms, "lanczos_err": lz_err, "same_colour": same,
            "same_colour_procedural": same_corpus}


# --- phase 18: the parallel layer (data and context parallelism) -----------

# Phase 18 (b)'s step cases: (tag, mesh shape, attention impl, global batch,
# bf16). The whole-step comparisons are held in f32 with TF32 off, where
# phase 9's bars hold: in bf16 a rounding-level change (the order of
# BatchNorm's sums, another cuDNN algorithm at another batch, the ring's f32
# fold against K2's bf16 rounding points) moves an activation by a bf16
# ulp, and the teacher amplifies that far beyond those bars (on the CPU at
# 48 px: 5 % of semantic_reward, 11 % of a conv -> BatchNorm gradient; on
# the card 270x phase 9's gradient bar and 1,000x its metric bar, where the
# single-process step with its BatchNorm sums taken in two parts moves
# 170x and 150x from itself). So the bf16 DP and TP/EP steps are read
# beside that noise and held only to equal ranks and finite values (the
# TP/EP step's decoder FC adds two bf16 partial outputs in the exit). The ring folds its
# chunks in plain torch (f32 score tiles of 8 heads x 8192 x 512 a block,
# the hash in int64 ops) and takes batch 2: at batch 1 train-mode
# BatchNorm makes the pooled features the gate reads a constant, and their
# gradients rounding noise (any two attention impls then differ by 100 %).
DIST_CASES = (("dp", (2, 1), "auto", 4, False),
              ("dp_bf16", (2, 1), "auto", 4, True),
              ("tp_ep_bf16", (1, 2), "auto", 4, True),
              ("allgather", (1, 2), "allgather", 4, False),
              ("ring", (1, 2), "ring", 2, False))
DIST_ATTN = (2, 8, 16384, 16)           # allgather_attention alone: B H N d
# Phase 18 (c)'s K2 counters (f32: the default backward, the fused one).
TP_EP_K2 = ("launches", "bwd_fused_launches", "bwd_dq_launches",
            "bwd_dkv_launches")


def _dist_images(torch, batch: int):
    return torch.randint(0, 256, (1, batch, 128, 128, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(18))


def _dist_attn_inputs(torch, dev):
    g = torch.Generator(device=dev).manual_seed(19)
    b, h, n, d = DIST_ATTN
    qkv = [torch.randn(b, h, n, d, device=dev, generator=g).to(torch.bfloat16)
           for _ in range(4)]
    bias = torch.randn(h, n, device=dev, generator=g) * 0.1
    return qkv[:3], bias, qkv[3]            # q, k, v; bias; dO


@contextlib.contextmanager
def deterministic_convs(torch):
    """cuDNN's deterministic algorithms, restored on exit. Phase 18's f32
    steps are held to phase 9's bars against a single-process step; with
    cuDNN's default choice one f32 step at batch 4 differs from itself run
    to run by about 0.4 of those bars (`--step-noise`), and the step under
    test and its reference each carry that, so a sound step could land
    past the bar. With these algorithms the step repeats itself within
    0.003 of the bar (K2's fused backward adds dq with atomics)."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


@contextlib.contextmanager
def bn_sums_in_parts(torch, parts: int):
    """BatchNorm's batch sums taken over `parts` equal slices of the batch
    and added in order, as `parts` data ranks take them (each its slice,
    then an all-reduce): the single-process reference of a data-parallel
    bf16 step. In bf16 the order alone moves the step beyond phase 9's
    bars: activations round to bf16 after the normalization, and a
    rounding-level change of the moments moves a bf16 element by an ulp
    (on the CPU at 48 px, splitting the sums in two moved semantic_reward
    from 0.07770 to 0.07340, which is what two data ranks give)."""
    from lunaris_orion_tpu_torch.ops import layers
    original = layers.batch_norm_train

    def split(x, running_mean, running_var, weight, bias, *, momentum=0.1,
              eps=1e-5, axis=None):
        x32 = x.float()
        n = x.shape[0] * x.shape[2] * x.shape[3]
        total = sum(c.sum(dim=(0, 2, 3)) for c in x32.chunk(parts))
        mean = total / n
        centered = x32 - mean[None, :, None, None]
        var = sum(c.square().sum(dim=(0, 2, 3))
                  for c in centered.chunk(parts)) / n
        with torch.no_grad():
            new_mean = (1 - momentum) * running_mean + momentum * mean
            new_var = (1 - momentum) * running_var + momentum * (
                var * (n / max(n - 1, 1)))
        out = (centered * torch.rsqrt(var + eps)[None, :, None, None]
               * weight.float()[None, :, None, None]
               + bias.float()[None, :, None, None])
        return out.to(x.dtype), new_mean, new_var
    if parts > 1:
        layers.batch_norm_train = split
    try:
        yield
    finally:
        layers.batch_norm_train = original


def _dist_step(torch, cfg, dev, batch: int, **axes):
    """One train step of the full default width from seed 0 on the
    global batch `batch` (this rank's share of it with a data axis; the
    state cut to the rank's part with a model axis: the FC pair, and the
    experts too without context parallelism). Returns (state, metrics,
    seconds)."""
    from lunaris_orion_tpu_torch.parallel.sharding import shard_state
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step
    images = _dist_images(torch, batch)
    mesh = axes.get("mesh")
    if mesh is not None:
        per = batch // mesh.data.size
        images = images[:, mesh.data.index * per:(mesh.data.index + 1) * per]
    state = create_state(cfg, dev, 0)
    if mesh is not None:
        shard_state(state, mesh, shard_experts="cp_mesh" not in axes)
    step = make_train_step(cfg, **axes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = step(state, images.to(dev))
    torch.cuda.synchronize()
    return state, {k: float(v) for k, v in m.items()}, time.perf_counter() - t0


def _grads(state) -> dict:
    return ({f"vae.{k}": p.grad for k, p in state.vae.named_parameters()}
            | {f"teacher.{k}": p.grad
               for k, p in state.teacher.named_parameters()})


def _replicated(state) -> list:
    """The gradients of the parameters every rank of a model row holds
    whole."""
    return [p.grad for opt in (state.vae_opt, state.teacher_opt)
            for p, part in zip(opt.params, opt.split) if not part]


def _part(state):
    """name ("vae." / "teacher." + the model's name), whole tensor -> the
    part of it this rank's state holds."""
    if state.layout is None:
        return None
    return lambda name, t: state.layout.part(name.split(".", 1)[1], t)


def step_noise(torch, runs: int) -> int:
    """`--step-noise N`: phase 18's single-process f32 step (the full
    default width, batch 4, seed 0, TF32 off) N times with cuDNN's default
    algorithms and N times with its deterministic ones
    (`deterministic_convs`), each repeat held to the first of its kind at
    phase 9's bars. Prints the worst gradient and metric of each repeat;
    fails on none."""
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.device import full_f32
    from lunaris_orion_tpu_torch.ops.cuda import _build
    _build.library()
    dev = torch.device("cuda")
    cfg = TrainConfig(gradient_accumulation_steps=1, batch_size=4)
    for det in (False, True):
        first = None
        for run in range(runs):
            with (full_f32(), deterministic_convs(torch) if det
                  else contextlib.nullcontext()):
                state, m, _ = _dist_step(torch, cfg, dev, 4)
            grads = {k: g.cpu() for k, g in _grads(state).items()}
            if first is None:
                first = grads, m, bn_block_params(state.teacher)
            else:
                g_r = grad_ratios(first[0], grads, first[2])
                m_r = _metric_ratios(first[1], m)
                g_k, m_k = max(g_r, key=g_r.get), max(m_r, key=m_r.get)
                log(f"[noise] f32 step, batch 4, cuDNN's "
                    f"{'deterministic' if det else 'default'} algorithms, "
                    f"repeat {run} against the first: gradients worst "
                    f"{g_r[g_k]:.3f} of phase 9's bar ({g_k}), metrics "
                    f"worst {m_r[m_k]:.3f} ({m_k})")
            del state
    return 0


def _metric_ratios(ref: dict, got: dict) -> dict:
    """Each metric's difference over phase 9's bar, 1e-4 of the value plus
    1e-6."""
    return {n: abs(got[n] - v) / (1e-4 * abs(v) + 1e-6)
            for n, v in ref.items()}


def _dist_rank(rank: int, tmp: Path) -> None:
    """One of phase 18 (b)'s two ranks on the one card, over gloo."""
    import torch
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.device import full_f32
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.parallel import close_mesh, init_mesh
    from lunaris_orion_tpu_torch.parallel import collectives as col
    from lunaris_orion_tpu_torch.parallel.mesh import make_mesh
    from lunaris_orion_tpu_torch.parallel.ring_attention import (
        ring_attention_sharded)
    dev = torch.device("cuda:0")
    world = init_mesh((2, 1), device=dev, backend="gloo")
    try:
        refs = torch.load(tmp / "dist_refs.pt")
        cfg = TrainConfig(gradient_accumulation_steps=1)
        out = {}
        for tag, shape, impl, batch, bf16 in DIST_CASES:
            mesh = make_mesh(shape, device=dev)
            axes = {"mesh": mesh}
            if impl != "auto":
                axes.update(attn_impl=impl, cp_mesh=mesh, cp_axis="model")
            cfg = cfg.replace(batch_size=batch, mixed_precision=bf16)
            for name in ("launches", "shard_launches", "bwd_fused_launches",
                         "bwd_dq_launches", "bwd_dkv_launches",
                         "bwd_shard_launches"):
                setattr(k2, name, 0)
            torch.cuda.reset_peak_memory_stats(dev)
            with full_f32(), deterministic_convs(torch):
                state, m, secs = _dist_step(torch, cfg, dev, batch, **axes)
            counts = {n: getattr(k2, n) for n in (
                "launches", "shard_launches", "bwd_fused_launches",
                "bwd_dq_launches", "bwd_dkv_launches", "bwd_shard_launches")}
            grads = _grads(state)
            ref_g, ref_m, before_bn = refs[(batch, 1, bf16)]
            ratios = grad_ratios(ref_g, {k: g.cpu() for k, g in grads.items()},
                                 before_bn, _part(state))
            # The two ranks' replicated gradients, element by element.
            flat = torch.cat([g.reshape(-1) for g in _replicated(state)])
            both = col._raw_all_gather(flat, world.data, 0).view(2, -1)
            out[tag] = {
                "ratios": ratios,
                "metric_ratios": _metric_ratios(ref_m, m),
                "peer_diff": (both[0] - both[1]).abs().max().item(),
                "seconds": secs, "counts": counts,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
            del state, grads, flat, both
            torch.cuda.empty_cache()
        # allgather_attention alone, on the tokens split over two ranks.
        mesh = make_mesh((1, 2), device=dev)
        (q, k, v), bias, do = _dist_attn_inputs(torch, dev)
        xs = [t.clone().requires_grad_() for t in (q, k, v, bias)]
        kw = dict(axis=mesh.model, dropout_rate=0.1, seed=1234, mode="allgather")
        k2.shard_launches = k2.bwd_shard_launches = 0
        o = ring_attention_sharded(*xs, **kw)
        o.backward(do)
        shards = (k2.shard_launches, k2.bwd_shard_launches)
        tensors = [o.detach().cpu()] + [t.grad.cpu() for t in xs]
        fwd_ms = time_ms(torch, lambda: ring_attention_sharded(*xs, **kw), 5)

        def fwd_bwd():
            ring_attention_sharded(*xs, **kw).backward(do)
        both_ms = time_ms(torch, fwd_bwd, 3)
        out["attn"] = {"fwd_ms": fwd_ms, "fwd_bwd_ms": both_ms,
                       "shard_launches": shards}
        if rank == 0:
            out["attn"]["tensors"] = tensors
        torch.save(out, tmp / f"dist_rank{rank}.pt")
        world.barrier()
    finally:
        close_mesh()


def _tp_ep_step(torch, cfg, dev, smi: str, tag: str, mesh=None):
    """Phase 18 (c)'s step, f32 with TF32 off and cuDNN's deterministic
    algorithms (`deterministic_convs`), under torch.profiler
    (`device_share`): one train step of the full default width from seed
    0 at batch 4, the state cut to this rank's part with `mesh`. Returns
    (state, metrics, seconds, device ms, {kernel group: launches by
    name}, {counter: launches by the wrappers})."""
    from lunaris_orion_tpu_torch.device import full_f32
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3
    from lunaris_orion_tpu_torch.parallel.sharding import shard_state
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step
    with full_f32(), deterministic_convs(torch):
        state = create_state(cfg, dev, 0)
        if mesh is not None:
            shard_state(state, mesh)
        step = make_train_step(cfg, mesh=mesh)
        images = _dist_images(torch, 4).to(dev)
        for mod, names in ((k1, ("launches",)), (k3, ("launches",)),
                           (k2, TP_EP_K2)):
            for name in names:
                setattr(mod, name, 0)
        torch.cuda.reset_peak_memory_stats(dev)
        by_name = {}
        (state, m), secs, _, dev_ms = device_share(
            torch, lambda: step(state, images), tag, smi, by_name)
    counts = {"gn_mish": k1.launches, "mse_kl": k3.launches,
              **{n: getattr(k2, n) for n in TP_EP_K2}}
    return (state, {k: float(v) for k, v in m.items()}, secs, dev_ms,
            by_name, counts)


def _held_bytes(state) -> dict:
    """The bytes of the parameters and AdamW moments a state holds, and of
    its experts (with their quality heads) and its FC pair's weights."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    return {"params": size(list(state.vae.parameters())
                           + list(state.teacher.parameters())),
            "moments": size([t for opt in (state.vae_opt, state.teacher_opt)
                             for st in opt.opt.state.values()
                             for k, t in st.items() if k != "step"]),
            "experts": size([p for k, p in state.teacher.named_parameters()
                             if k.startswith(("experts.", "quality_heads."))]),
            "fc_pair": size([state.vae.encoder.fc_mu.weight,
                             state.vae.encoder.fc_logvar.weight,
                             state.vae.decoder.fc.weight])}


def _tp_ep_trainer(torch, tmp: Path, data: str) -> dict:
    """Phase 18 (c)'s Trainer on this rank: --mesh_shape 1 2, bf16, batch
    4, one step and one validation batch at the full default width. Its
    memory plan probes the split models on the card; its epoch-end
    checkpoint is gathered on the host. Both ranks share cuda:0."""
    import os
    from lunaris_orion_tpu_torch.cli import train as train_cli
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    os.environ["LOCAL_RANK"] = "0"
    t0 = time.perf_counter()
    trainer = train_cli.trainer_from_args([
        "--data_dir", data, "--output_dir", str(tmp / "tp_ep_trainer"),
        "--mixed_precision", "--batch_size", "4",
        "--gradient_accumulation_steps", "1", "--num_epochs", "1",
        "--val_fraction", "0.5", "--mesh_shape", "1", "2", "--log_every",
        "1", "--save_every", "0", "--eval_save_freq", "0", "--sample_every",
        "0"])
    step, seen = trainer.train_step, []

    def recorded(*a):
        state, m = step(*a)
        seen.append({k: float(v) for k, v in m.items()})
        return state, m
    trainer.train_step = recorded
    k2.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "steps": trainer.state.step,
            "plan_gib": (None if trainer.plan_need is None
                         else trainer.plan_need / 2**30),
            "remat": trainer.remat, "metrics": seen, "k2": k2.launches,
            "experts": [e for e, ex in enumerate(trainer.state.teacher.experts)
                        if ex is not None]}


def _tp_ep_rank(rank: int, tmp: Path) -> None:
    """One of phase 18 (c)'s two ranks on the one card, over gloo: the
    TP/EP step at (1, 2), its checkpoint, and what it holds."""
    import torch
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.parallel import close_mesh, init_mesh
    from lunaris_orion_tpu_torch.parallel import collectives as col
    from lunaris_orion_tpu_torch.parallel.sharding import gather_state
    from lunaris_orion_tpu_torch.train.checkpoint import (
        CheckpointService, checkpoint_file, load_checkpoint_file)
    from lunaris_orion_tpu_torch.train.state import create_state
    dev = torch.device("cuda:0")
    mesh = init_mesh((1, 2), device=dev, backend="gloo")
    try:
        ref = torch.load(tmp / "tp_ep_ref.pt")
        cfg = TrainConfig(gradient_accumulation_steps=1, batch_size=4)
        state, m, secs, dev_ms, by_name, counts = _tp_ep_step(
            torch, cfg, dev, ref["smi"], f"dist (c) rank {rank} TP/EP step",
            mesh)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        grads = {k: g.cpu() for k, g in _grads(state).items()}
        ratios = grad_ratios(ref["grads"], grads, ref["before_bn"],
                             _part(state))
        # What both ranks must hold alike: the replicated gradients, the
        # replicated BatchNorm statistics, the metrics.
        alike = torch.cat(
            [g.reshape(-1) for g in _replicated(state)]
            + [b.reshape(-1).float() for k, b in
               state.teacher.named_buffers() if "running" in k
               and ".experts." not in f".{k}"]
            + [torch.tensor([v for _, v in sorted(m.items())], device=dev)])
        both = col.gather_over(alike, mesh.model, 0).view(2, -1)
        held = _held_bytes(state)
        whole = gather_state(state, mesh)
        params = {f"{n}.{k}": v for n, mod in (("vae", whole.vae),
                                               ("teacher", whole.teacher))
                  for k, v in mod.state_dict().items()}
        moved = max((params[k].float().cpu() - v.float()).abs().max().item()
                    for k, v in ref["params"].items())
        mu = {f"{n}.{k}": whole_opt.opt.state[p]["exp_avg"].cpu() / 0.1
              for n, mod, whole_opt in (("vae", whole.vae, whole.vae_opt),
                                        ("teacher", whole.teacher,
                                         whole.teacher_opt))
              for k, p in mod.named_parameters()}
        mu_ratios = grad_ratios(ref["mu"], mu, ref["before_bn"])
        # A save at (1, 2), then a load of the file by one process.
        ckpt = CheckpointService(str(tmp / "tp_ep_ckpt"), mesh=mesh)
        ckpt.save(1, state, config=cfg)
        ckpt.close()
        out = {"ratios": ratios, "metric_ratios": _metric_ratios(ref["m"], m),
               "peer_diff": (both[0] - both[1]).abs().max().item(),
               "seconds": secs, "device_ms": dev_ms, "by_name": by_name,
               "counts": counts, "peak_gib": peak, "held": held,
               "moved": moved,
               "mu_worst": max(mu_ratios.values()),
               "experts": [e for e, ex in enumerate(state.teacher.experts)
                           if ex is not None]}
        if rank == 0:
            loaded = create_state(cfg, dev, 1)
            load_checkpoint_file(str(checkpoint_file(str(tmp / "tp_ep_ckpt"))),
                                 loaded, cfg)
            differ = [k for n, mod in (("vae", loaded.vae),
                                       ("teacher", loaded.teacher))
                      for k, v in mod.state_dict().items()
                      if not torch.equal(v.cpu(), params[f"{n}.{k}"])]
            for a, b in ((loaded.vae_opt, whole.vae_opt),
                         (loaded.teacher_opt, whole.teacher_opt)):
                for pa, pb in zip(a.params, b.params):
                    for k in ("exp_avg", "exp_avg_sq"):
                        if not torch.equal(a.opt.state[pa][k].cpu(),
                                           b.opt.state[pb][k]):
                            differ.append(f"moment {k}")
            out["resume"] = {"tensors": len(params), "differ": differ[:5],
                             "n_differ": len(differ)}
            del loaded
        del state, whole, params, mu, grads
        torch.cuda.empty_cache()
        out["trainer"] = _tp_ep_trainer(torch, tmp, ref["trainer_data"])
        torch.save(out, tmp / f"tp_ep_rank{rank}.pt")
        mesh.barrier()
    finally:
        close_mesh()


def run_dist_tp_ep(torch, tmp: Path, smi: str) -> dict:
    """Phase 18 (c): tensor and expert parallelism over two gloo ranks on
    the one card (the collectives staged through the host), full default
    width, (1, 2), batch 4, accumulation 1, dropout 0.1, f32 with TF32
    off, against the single-process step on the same state and batch.
    The gathered parameters are held within 3 lr of the single step's (a
    first AdamW step moves an entry by lr times the sign of its gradient,
    so an entry whose gradient is rounding noise lands up to 2 lr away; a
    wrong part moves by the parameters' own size), the gathered first
    moments over (1 - b1) at phase 9's gradient bars. Then the native
    batch gatherer on a procedural corpus."""
    import numpy as np
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.data.dataset import SpriteDataset
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = TrainConfig(gradient_accumulation_steps=1, batch_size=4)
    state, m, secs, dev_ms, by_name, counts = _tp_ep_step(
        torch, cfg, dev, smi, "dist (c) single-process step")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    held = _held_bytes(state)
    before_bn = bn_block_params(state.teacher)
    torch.save({
        "grads": {k: g.cpu() for k, g in _grads(state).items()}, "m": m,
        "before_bn": before_bn, "smi": smi,
        "trainer_data": str(write_synthetic_dataset(
            tmp / "tp_ep_sprites", 8, image_size=128)),
        "params": {f"{n}.{k}": v.cpu() for n, mod in (("vae", state.vae),
                                                     ("teacher",
                                                      state.teacher))
                   for k, v in mod.state_dict().items()},
        "mu": {f"{n}.{k}": opt.opt.state[p]["exp_avg"].cpu() / 0.1
               for n, mod, opt in (("vae", state.vae, state.vae_opt),
                                   ("teacher", state.teacher,
                                    state.teacher_opt))
               for k, p in mod.named_parameters()}}, tmp / "tp_ep_ref.pt")
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(_tp_ep_rank, 2, (tmp,))
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"tp_ep_rank{r}.pt") for r in range(2)]
    failed = []
    for r, c in enumerate(ranks):
        worst = max(c["ratios"], key=c["ratios"].get)
        m_worst = max(c["metric_ratios"], key=c["metric_ratios"].get)
        share = {k: c["held"][k] / held[k] for k in held}
        log(f"[dist] (c) rank {r} TP/EP (1, 2) batch 4 f32, experts "
            f"{c['experts']}: gradients worst {c['ratios'][worst]:.3f} of "
            f"the bar ({worst}), metrics worst "
            f"{c['metric_ratios'][m_worst]:.3f} ({m_worst}); gathered "
            f"moments {c['mu_worst']:.3f} of the bar, parameters moved "
            f"{c['moved']:.2e} from the single step's; step "
            f"{c['seconds']:.2f} s (single process {secs:.2f} s), device "
            f"{c['device_ms']:.1f} ms ({c['device_ms'] / dev_ms:.1%} of the "
            f"single process's {dev_ms:.1f}), peak "
            f"{c['peak_gib']:.2f} GiB (single {peak:.2f}); held "
            f"{c['held']['params'] / 2**20:.1f} MiB of parameters, "
            f"{c['held']['moments'] / 2**20:.1f} MiB of moments (single "
            f"{held['params'] / 2**20:.1f}, {held['moments'] / 2**20:.1f}): "
            f"shares {', '.join(f'{k} {v:.3f}' for k, v in share.items())}; "
            f"launches {c['counts']} (single {counts}), by name "
            f"{c['by_name']} (single {by_name}); 2 ranks over gloo on one "
            f"card, on {smi}")
        if (c["ratios"][worst] > 1.0 or c["metric_ratios"][m_worst] > 1.0
                or c["mu_worst"] > 1.0 or c["moved"] > 3 * cfg.vae_lr):
            failed.append(f"rank {r}: off the bar")
        if c["experts"] != [2 * r, 2 * r + 1]:
            failed.append(f"rank {r}: experts {c['experts']}")
        for n in TP_EP_K2:
            if 2 * c["counts"][n] != counts[n]:
                failed.append(f"rank {r}: {n} {c['counts'][n]} against "
                              f"the single process's {counts[n]}")
        for n in ("gn_mish", "mse_kl"):
            if c["counts"][n] != counts[n] or counts[n] <= 0:
                failed.append(f"rank {r}: {n} {c['counts'][n]}")
        # By name in the profile: K1 and K3 as in the single step, the K2
        # forward half of it.
        for group, want in (("K1", by_name.get("K1", 0)),
                            ("K3", by_name.get("K3", 0)),
                            ("K2 fwd", by_name.get("K2 fwd", 0) // 2)):
            if c["by_name"].get(group, 0) != want or want <= 0:
                failed.append(f"rank {r}: {group} by name "
                              f"{c['by_name'].get(group, 0)}, expected {want}")
    if ranks[0]["counts"] != ranks[1]["counts"]:
        failed.append("the ranks' launches differ")
    if counts["launches"] <= 0:
        failed.append("no K2 launch in the single-process step")
    if ranks[0]["peer_diff"] != 0.0:
        failed.append(f"replicated gradients, statistics or metrics differ "
                      f"between the ranks by {ranks[0]['peer_diff']:.2e}")
    res = ranks[0]["resume"]
    log(f"[dist] (c) save at (1, 2), load at (1, 1): {res['tensors']} "
        f"tensors and every AdamW moment, {res['n_differ']} differ bit for "
        f"bit from the gathered state {res['differ']}")
    if res["n_differ"]:
        failed.append("the checkpoint does not load to the gathered state")
    trainers = [c["trainer"] for c in ranks]
    for r, t in enumerate(trainers):
        log(f"[dist] (c) rank {r} Trainer --mesh_shape 1 2 bf16 batch 4: "
            f"{t['steps']} step, experts {t['experts']}, memory plan "
            f"{t['plan_gib']} GiB (remat {t['remat']}), K2 forward "
            f"launches {t['k2']}, metrics {t['metrics']}, "
            f"{t['seconds']:.1f} s with set-up, probe and save; 2 ranks "
            f"over gloo on one card, on {smi}")
        if (t["steps"] != 1 or t["plan_gib"] is None
                or not math.isfinite(t["plan_gib"]) or t["k2"] <= 0
                or t["experts"] != [2 * r, 2 * r + 1]
                or not all(math.isfinite(v) for m in t["metrics"]
                           for v in m.values())):
            failed.append(f"rank {r}: the TP/EP Trainer run")
    if trainers[0]["metrics"] != trainers[1]["metrics"]:
        failed.append("the TP/EP Trainer's metrics differ between the ranks")

    # The native batch gatherer against the numpy gather: a procedural
    # corpus of 3 shards, batch 16 x 2 random rows.
    ds = SpriteDataset(str(write_synthetic_dataset(
        tmp / "native_sprites", 240, image_size=128, shards=3)),
        image_size=128)
    idx = np.random.default_rng(18).integers(0, len(ds), 32)
    same = bool(ds.native) and np.array_equal(ds.gather(idx),
                                              ds.gather_numpy(idx))
    turns = {"numpy": [], "native": []}
    for name in ("numpy", "native", "native", "numpy") * 5:
        fn = ds.gather_numpy if name == "numpy" else ds.gather
        t0 = time.perf_counter()
        fn(idx)
        turns[name].append((time.perf_counter() - t0) * 1e3)
    gather_ms = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    log(f"[dist] (c) native gather: built {ds.native}, byte-equal to the "
        f"numpy gather {same}; batch 16 x 2 at 128 px from 3 shards "
        f"{gather_ms['native']:.3f} ms against numpy "
        f"{gather_ms['numpy']:.3f} ms (medians of 10, in turns; host)")
    if not same:
        failed.append("native gather not built or not byte-equal")
    log(f"[dist] (c) ranks {t_ranks:.0f} s, phase (c) "
        f"{time.perf_counter() - t_phase:.0f} s")
    if failed:
        raise AssertionError(f"dist (c): {failed}")
    return {"launches": ranks[0]["counts"], "single_launches": counts,
            "seconds": [c["seconds"] for c in ranks], "single_seconds": secs,
            "device_ms": [c["device_ms"] for c in ranks],
            "single_device_ms": dev_ms,
            "peak_gib": [c["peak_gib"] for c in ranks],
            "single_peak_gib": peak,
            "held": [c["held"] for c in ranks], "single_held": held,
            "gather_ms": gather_ms}


def run_dist_nccl(torch, tmp: Path, smi: str) -> dict:
    """Phase 18 (a): the Trainer at --mesh_shape 1 1, bf16, full default
    width, 2 steps, as a torchrun-style single rank with an NCCL process
    group and without a process group: the same parameters and BatchNorm
    statistics, bit for bit, and the NCCL collectives counted. Both runs
    take the deterministic K2 backward (split: the fused one adds dq with
    atomics in any order) and cuDNN's deterministic algorithms, so that two
    runs can give the same bits at all."""
    import os
    import torch.distributed as dist
    from lunaris_orion_tpu_torch.cli import train as train_cli
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.parallel.launch import free_port
    from lunaris_orion_tpu_torch.parallel.mesh import close_mesh

    # 24 sprites: 16 train (2 steps of 8), 8 val (one batch).
    data = write_synthetic_dataset(tmp / "dist_sprites", 24, image_size=128)
    argv = ["--data_dir", str(data), "--mixed_precision", "--batch_size", "8",
            "--gradient_accumulation_steps", "1", "--num_epochs", "1",
            "--val_fraction", "0.334", "--remat", "--mesh_shape", "1", "1",
            "--log_every", "1", "--save_every", "0", "--eval_save_freq", "0",
            "--sample_every", "0"]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port())}
    names = ("all_reduce", "all_gather", "reduce_scatter", "barrier",
             "batch_isend_irecv")
    calls = dict.fromkeys(names, 0)
    real = {n: getattr(dist, n) for n in names}

    def counted(n):
        def call(*a, **kw):
            calls[n] += 1
            return real[n](*a, **kw)
        return call
    saved = (k2.default_bwd, torch.backends.cudnn.deterministic)
    k2.default_bwd = lambda dtype, d: "split"
    torch.backends.cudnn.deterministic = True
    states, secs = {}, {}
    try:
        for run in ("alone", "nccl"):
            if run == "nccl":
                os.environ.update(env)
                for n in names:
                    setattr(dist, n, counted(n))
            t0 = time.perf_counter()
            trainer = train_cli.trainer_from_args(
                argv + ["--output_dir", str(tmp / f"dist_{run}")])
            if run == "nccl" and trainer.mesh.backend != "nccl":
                raise AssertionError(f"dist (a): backend {trainer.mesh.backend}")
            trainer.train()
            torch.cuda.synchronize()
            secs[run] = time.perf_counter() - t0
            if trainer.state.step != 2:
                raise AssertionError(f"dist (a): {trainer.state.step} steps")
            states[run] = {f"{m}.{k}": v.detach().clone()
                           for m, mod in (("vae", trainer.state.vae),
                                          ("teacher", trainer.state.teacher))
                           for k, v in mod.state_dict().items()}
            close_mesh()
            del trainer
    finally:
        for n in names:
            setattr(dist, n, real[n])
        for k in env:
            os.environ.pop(k, None)
        k2.default_bwd, torch.backends.cudnn.deterministic = saved
        close_mesh()
    differ = [k for k, v in states["alone"].items()
              if not torch.equal(v, states["nccl"][k])]
    log(f"[dist] (a) Trainer --mesh_shape 1 1, bf16, 2 steps at full width: "
        f"{len(states['alone'])} parameters and buffers, {len(differ)} differ "
        f"bit for bit between no process group ({secs['alone']:.1f} s) and "
        f"one NCCL rank ({secs['nccl']:.1f} s); NCCL calls {calls} on {smi}")
    if differ or calls["all_reduce"] == 0 or calls["barrier"] == 0:
        raise AssertionError(f"dist (a): differ {differ[:5]}, calls {calls}")
    return {"calls": calls, "seconds": secs}


def run_dist_gloo(torch, tmp: Path, smi: str) -> dict:
    """Phase 18 (b): two ranks on the one card over gloo (the collectives
    staged through the host), at the full default width, against the
    single-process step on the same state and global batch: DP (2, 1) at
    global batch 4, CP (1, 2) allgather at 4 (K2 launched on q shards) and
    ring at 2, DP and TP/EP (1, 2) in bf16, dropout 0.1, accumulation 1,
    every step on cuDNN's deterministic algorithms (`deterministic_convs`):
    the averaged, clipped gradients at phase 9's bars, the metrics at phase 9's bar scaled to
    bf16, the two ranks' gradients against each other, each rank's peak
    memory; then `allgather_attention` alone at B2 H8 N16384 d16 bf16
    dropout 0.1 against one K2 call (phases 4 and 7's bf16 bars), its ms
    beside the single call's, and the K2 kernels alone on a CP shard
    (Nq 8192 x Nk 16384) beside their bound and SDPA."""
    import dataclasses
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms

    from lunaris_orion_tpu_torch.device import full_f32
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    cfg = TrainConfig(gradient_accumulation_steps=1)
    refs, ref_s = {}, {}
    # (batch, BatchNorm's sums in parts, bf16); (4, 2, True) is the bf16
    # step's own rounding-level perturbation.
    for key in sorted({(c[3], 1, c[4]) for c in DIST_CASES} | {(4, 2, True)}):
        batch, parts, bf16 = key
        with (bn_sums_in_parts(torch, parts), full_f32(),
              deterministic_convs(torch)):
            state, m, ref_s[key] = _dist_step(
                torch, cfg.replace(batch_size=batch, mixed_precision=bf16),
                dev, batch)
        refs[key] = ({k: g.cpu() for k, g in _grads(state).items()}, m,
                     bn_block_params(state.teacher))
        del state
    noise_g = grad_ratios(refs[(4, 1, True)][0], refs[(4, 2, True)][0],
                          refs[(4, 1, True)][2])
    noise_m = _metric_ratios(refs[(4, 1, True)][1], refs[(4, 2, True)][1])
    noise = (max(noise_g.values()), max(noise_m.values()))
    log(f"[dist] (b) bf16 noise: the single-process step with BatchNorm's "
        f"sums in two parts against itself: gradients {noise[0]:.3f}, "
        f"metrics {noise[1]:.3f} of phase 9's bars")
    torch.save(refs, tmp / "dist_refs.pt")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(_dist_rank, 2, (tmp,))
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(tmp / f"dist_rank{r}.pt") for r in range(2)]
    out, failed = {}, []
    for tag, shape, impl, batch, bf16 in DIST_CASES:
        for r, res in enumerate(ranks):
            c = res[tag]
            worst = max(c["ratios"], key=c["ratios"].get)
            m_worst = max(c["metric_ratios"], key=c["metric_ratios"].get)
            log(f"[dist] (b) rank {r} {tag} {shape} batch {batch}: gradients "
                f"worst {c['ratios'][worst]:.3f} of the bar ({worst}), "
                f"metrics worst {c['metric_ratios'][m_worst]:.3f} "
                f"({m_worst}), ranks' gradients differ by {c['peer_diff']:.2e}"
                f", step {c['seconds']:.2f} s (single process "
                f"{ref_s[(batch, 1, bf16)]:.2f} s), peak "
                f"{c['peak_gib']:.2f} GiB, K2 {c['counts']}")
            if bf16:
                if not all(map(math.isfinite, c["metric_ratios"].values())):
                    failed.append(f"{tag} rank {r}: metrics not finite")
            elif (c["ratios"][worst] > 1.0
                    or c["metric_ratios"][m_worst] > 1.0):
                failed.append(f"{tag} rank {r}: off the bar")
            if impl == "allgather" and r > 0 and (
                    c["counts"]["shard_launches"] <= 0
                    or c["counts"]["bwd_shard_launches"] <= 0):
                failed.append(f"{tag}: no K2 on a q shard")
        if ranks[0][tag]["peer_diff"] != 0.0:
            failed.append(f"{tag}: the two ranks' gradients differ")
        out[tag] = {"launches": ranks[1][tag]["counts"],
                    "peak_gib": [res[tag]["peak_gib"] for res in ranks],
                    "seconds": ranks[0][tag]["seconds"],
                    "peer_diff": ranks[0][tag]["peer_diff"]}

    # allgather_attention alone against one K2 call on the same inputs.
    (q, k, v), bias, do = _dist_attn_inputs(torch, dev)
    xs = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    o, _ = k2.flash_attention(*xs, dropout_rate=0.1, seed=1234)
    o.backward(do)
    got = ranks[0]["attn"]["tensors"]
    inst = k2.forward_instance(q.dtype, q.shape[3], q.shape[2], k.shape[2], 0.1)
    ok, excess, differ = k2_bf16_agree(torch, got[0].to(dev), o.detach(),
                                       inst.body)
    same = torch.equal(got[0].to(dev), o.detach())
    notes = [f"out {'bit-equal' if same else f'+{max(excess, 0):.1e}'}"]
    body = k2.fused_instance(q.dtype, q.shape[3], q.shape[2] // 2, k.shape[2],
                             0.1).body
    for name, g_got, t in zip(("dq", "dk", "dv", "dbias"), got[1:], xs):
        fine, err, what = bwd_agree(torch, g_got.to(dev), t.grad, q.dtype,
                                    name, body)
        if name in ("dk", "dv") and not fine:
            # dk and dv are sums of two bf16 partials, one a q shard (the
            # reduce-scatter of K2's outputs, as the JAX package's
            # psum_scatter of its kernel's): each partial rounds once more,
            # by up to half an ulp of a partial, whose size is about the
            # tensor's largest. Held to 2 ulps of the element plus one ulp
            # of the largest, not to the share of elements that differ.
            ref = t.grad.float()
            top = ref.abs().max()
            excess_kv = ((g_got.to(dev).float() - ref).abs()
                         - 2 * bf16_ulp(torch, ref)).max()
            fine = bool(excess_kv <= bf16_ulp(torch, top))
            what += (f" (two roundings: over 2 ulps by "
                     f"{excess_kv.item() / top.item():.1e} of the largest, "
                     f"bar one ulp of it)")
        ok = ok and fine
        notes.append(f"{name} {what}")
    t_one = time_ms(torch, lambda: k2.flash_attention(
        *(t.detach() for t in xs), dropout_rate=0.1, seed=1234), 5)

    def one_fwd_bwd():
        k2.flash_attention(*xs, dropout_rate=0.1, seed=1234)[0].backward(do)
    t_one_b = time_ms(torch, one_fwd_bwd, 3)
    att = ranks[0]["attn"]
    shard = ranks[1]["attn"]["shard_launches"]     # rank 1: q_offset 8192
    log(f"[dist] (b) allgather_attention B2 H8 N16384 d16 bf16 dropout 0.1 "
        f"against one K2 call: {'; '.join(notes)}; K2 on a q shard "
        f"{shard} (fwd, bwd) on rank 1; 2 ranks over gloo on "
        f"one card: {att['fwd_ms']:.3f} ms forward, {att['fwd_bwd_ms']:.3f} "
        f"ms forward+backward; one K2 call {t_one:.3f} / {t_one_b:.3f} ms; "
        f"on {smi}")
    if not ok or min(shard) <= 0:
        failed.append(f"allgather_attention off the bar {notes}")
    del xs, o

    # The K2 kernels alone on one rank's CP shard: q [2, 8, 8192, 16]
    # against k, v [2, 8, 16384, 16] at q_offset 8192, bf16, dropout 0.
    b, h, n, d = DIST_ATTN
    qs = q[:, :, n // 2:].contiguous()
    fwd = time_ms(torch, lambda: k2.flash_attention(
        qs, k, v, bias, q_offset=n // 2), 10)
    lse = k2.flash_attention(qs, k, v, bias, q_offset=n // 2)[1]
    o_s = k2.flash_attention(qs, k, v, bias, q_offset=n // 2)[0]
    do_s = do[:, :, n // 2:].contiguous()
    variant = k2.default_bwd(q.dtype, d)
    bwd = time_ms(torch, lambda: k2.flash_attention_bwd(
        qs, k, v, bias, o_s, lse, do_s, q_offset=n // 2, variant=variant), 10)
    lib, _ = sdpa_ms(qs, k, v, bias, reps=5)
    lib_b, _ = sdpa_ms(qs, k, v, bias, backward=True, reps=3)
    scores_d = b * h * (n // 2) * n * d
    bd = bound(4 * scores_d, nbytes(qs, k, v, bias, o_s, lse), "bf16")
    bdb = bound({"fused": 10, "split": 14}[variant] * scores_d,
                nbytes(qs, k, v, bias, do_s, lse, o_s) + nbytes(qs, k, v, bias),
                "bf16")
    log(f"[dist] K2 on a CP shard (B2 H8 Nq 8192 x Nk 16384 d16 bf16, "
        f"q_offset 8192): forward {fwd:.3f} ms (bound {bd['bound_ms']:.4f} by "
        f"{bd['bound_by']}, SDPA {lib}), backward {variant} {bwd:.3f} ms "
        f"(bound {bdb['bound_ms']:.4f} by {bdb['bound_by']}, SDPA {lib_b}) "
        f"on {smi}")
    log(f"[dist] (b) ranks {t_ranks:.0f} s, phase (b) "
        f"{time.perf_counter() - t_phase:.0f} s")
    if failed:
        raise AssertionError(f"dist (b): {failed}")
    # Rank 1's launches in the allgather step (f32: the default backward,
    # the fused one), every one of them on its q shard at q_offset 8192.
    shard_step = out["allgather"]["launches"]
    return {"cases": out, "attn": {
        "fwd_ms": att["fwd_ms"], "fwd_bwd_ms": att["fwd_bwd_ms"],
        "single_ms": t_one, "single_fwd_bwd_ms": t_one_b},
        "fwd": {"cp_shard_ms": fwd, "cp_shard_bound_ms": bd["bound_ms"],
                "cp_shard_bound_by": bd["bound_by"],
                "cp_shard_library_ms": lib,
                "launches_dist_allgather": shard_step["shard_launches"]},
        "bwd": {"cp_shard_variant": variant, "cp_shard_ms": bwd,
                "cp_shard_bound_ms": bdb["bound_ms"],
                "cp_shard_bound_by": bdb["bound_by"],
                "cp_shard_library_ms": lib_b},
        "fused": {"launches_dist_allgather": shard_step["bwd_fused_launches"]},
        "dq": {"launches_dist_allgather": shard_step["bwd_dq_launches"]},
        "dkv": {"launches_dist_allgather": shard_step["bwd_dkv_launches"]}}


# --- phase 19: the long parity runs -----------------------------------------

# (a) `tools.parity_curves` and (b) `tools.parity_hybrid` at full length:
# (preset, sampled, attention window), in this order.
PARITY_RUNS = (("vae", False, 0), ("vae", True, 0), ("hybrid_d16", False, 0),
               ("hybrid_d16", False, WINDOW), ("hybrid_d16", True, 0))
PARITY_WINDOW_STEPS = 20     # (c) `tools.window_dynamics`: steps a mode
PARITY_WINDOW_AGREE = 0.02   # (c) global against window: recon and KL at
                             # the last step, relative to the larger
# The K2 instances a profiled step must launch: f32 on three TF32 passes
# in (b) (mma.sync on the global calls at 32 px, N 1024; on the windowed
# fold the f32 window forward and mma.sync's backward, `window_default`),
# bf16 on the tensor cores in (c).
PARITY_K2_F32 = {0: ("flash_fwd_tf32", "flash_bwd_fused_tf32"),
                 WINDOW: ("flash_fwd_window_tf32", "flash_bwd_fused_tf32")}
# bf16 at d 16: the narrow warpgroup bodies on the global calls, the window
# bodies on the windowed fold (`flash_attention.window_shape`).
PARITY_K2_BF16 = {0: ("flash_fwd_wgmma_narrow", "flash_bwd_wgmma_narrow"),
                  WINDOW: ("flash_fwd_window", "flash_bwd_window")}


def _parity_step(torch, run, i: int, tag: str, smi: str, mods: dict,
                 k2_names: tuple) -> dict:
    """Step i of a parity run under torch.profiler. Its kernels by the
    wrappers' counts and by name must agree: K1 two kernels a call, K3
    and, where the run has a teacher, the K2 forward and fused backward,
    whose instances must include `k2_names`. Returns the counts."""
    _counts(mods, reset=True)
    groups, names = {}, {}
    _, _, k1_kernels, _ = device_share(torch, lambda: run.step(i), tag, smi,
                                       groups, names)
    counts = _counts(mods)
    if counts["gn_mish"] <= 0:
        raise AssertionError(f"{tag}: K1 never launched: {counts}")
    check_k1_kernels(k1_kernels, counts["gn_mish"], tag)
    pairs = [("K3", "mse_kl")]
    if k2_names:
        pairs += [("K2 fwd", "flash_attention_fwd"),
                  ("K2 bwd fused", "flash_attention_bwd_fused")]
    for group, key in pairs:
        if counts[key] <= 0 or groups.get(group, 0) != counts[key]:
            raise AssertionError(
                f"{tag}: {key} launched {counts[key]} times by its wrapper, "
                f"{groups.get(group, 0)} by name")
    missing = [n for n in k2_names if not any(n in k for k in names)]
    if missing:
        raise AssertionError(f"{tag}: no {missing} among the K2 kernels "
                             f"{names}")
    return counts


def _parity_curve_run(torch, smi: str, mods: dict, preset: str,
                      sampled: bool, window: int) -> dict:
    """One run of phase 19 (a) or (b) at full length (`run_parity`)."""
    from lunaris_orion_tpu_torch.tools import _parity as P
    from lunaris_orion_tpu_torch.tools import parity_curves, parity_hybrid

    def make(dev):
        if preset == "vae":
            return parity_curves.VAERun(dev, steps, sampled)
        return parity_hybrid.HybridRun(dev, steps, sampled, window)

    name = P.run_name(preset, sampled, window)
    steps = P.PRESETS[preset].steps
    ref = P.check_reference(name, steps)
    band = P.bands(preset)
    run = make("cuda")
    t0 = time.perf_counter()
    for i in range(steps):
        if i == 1:
            launches = _parity_step(
                torch, run, i, f"parity {name} step 2", smi, mods,
                PARITY_K2_F32[window] if preset != "vae" else ())
        else:
            run.step(i)
    curves = run.curves()
    run_s = time.perf_counter() - t0
    div = P.divergences(curves, ref["curves"])
    log(f"{P.summary_line(name, div, band, sampled)}; {steps} steps in "
        f"{run_s:.1f} s on {smi}")
    first = None
    if not sampled:
        cpu = make("cpu")
        cpu.step(0)
        c0 = {k: v[0] for k, v in cpu.curves().items()}
        ratio = {k: abs(curves[k][0] - v) / (1e-4 * abs(v) + 1e-6)
                 for k, v in c0.items()}
        worst = max(ratio, key=ratio.get)
        first = ratio[worst]
        log(f"[parity] {name}: step 1 card vs CPU: worst {worst} "
            f"{curves[worst][0]:.9g} vs {c0[worst]:.9g} = {first:.3f} of "
            f"phase 9's bar (1e-4 rel + 1e-6)")
        if first > 1.0:
            raise AssertionError(f"parity {name}: step 1 on the card "
                                 "disagrees with the CPU's")
    bad = P.failures(name, div, curves, band, sampled)
    if bad:
        raise AssertionError("parity: " + "; ".join(bad))
    return {"name": name, "max_rel_divergence": div, "seconds": run_s,
            "step1_bar_share": first, "launches": launches,
            "between": [f"{name} {k} {v:.3e}" for k, v in div.items()
                        if P.verdict(v, band, k, sampled) == "between"]}


def _parity_process(index: int, tmp: Path, smi: str) -> None:
    """`PARITY_RUNS[index]` in a process of its own (spawned by
    `start_parity`), TF32 off; its result goes to tmp/parity_<index>.json."""
    import torch
    from lunaris_orion_tpu_torch.device import full_f32
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as m2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as m1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as m3
    torch.set_num_threads(2)             # the CPU's first step; 8 cores
    with full_f32():
        out = _parity_curve_run(torch, smi, {"k1": m1, "k2": m2, "k3": m3},
                                *PARITY_RUNS[index])
    (tmp / f"parity_{index}.json").write_text(json.dumps(out))


def start_parity(tmp: Path, smi: str) -> list:
    """Phase 19's runs of (a) and (b), host-bound, each in a process of its
    own (`_parity_process`), all started together: `main` starts them
    just before phase 19, so that they run beside its run of (c) and
    under no phase that times the card, and `run_parity` joins them."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_parity_process, args=(i, tmp, smi))
             for i in range(len(PARITY_RUNS))]
    for p in procs:
        p.start()
    return procs


def run_parity(torch, tmp: Path, smi: str, mods: dict, procs: list) -> dict:
    """Phase 19: the port's long parity runs on the card, TF32 off for
    cuDNN and cuBLAS (K2's f32 products stay three TF32 passes). (a)
    `tools.parity_curves`, 300 x 16, both modes; (b) `tools.parity_hybrid`,
    200 x 8, deterministic global (attn_impl flash), deterministic window
    256 and sampled global; (c) `tools.window_dynamics`, global and window
    256, 20 steps each at the full default width, bf16, batch 8.

    The runs of (a) and (b) are host-bound (the card idle 92-95 % of a
    step), so each takes a process of its own (`start_parity`, `procs`),
    all started together just before this phase; this process runs (c)
    (its seconds, a reading on the host's clock, share the host with
    them), then
    joins them. Each run's second step
    goes under torch.profiler (`_parity_step`). Each run of (a) and (b) is
    held to its committed JAX curves: a deterministic divergence past its
    sampled band fails, one between the bands is a finding (returned under
    "between"), and a sampled run fails only on a value that is not
    finite. A deterministic run's first step agrees with the same tool's
    first step on the CPU (the plain twins) at phase 9's metric bar. (A
    sampled run draws eps from a CUDA generator, which gives other numbers
    than the CPU's from the same seed, so its first step has no CPU
    counterpart.) (c) fails on a loss that is not finite, or when the two
    modes' recon or KL at the last step differ by more than 2 %."""
    from lunaris_orion_tpu_torch.device import full_f32
    from lunaris_orion_tpu_torch.tools import window_dynamics
    out = {"runs": {}, "launches": {}, "between": []}
    try:
        last = {}
        with full_f32():
            for window in (0, WINDOW):
                name = f"window_dynamics {window or 'global'}"
                run = window_dynamics.WindowRun("cuda", window, 8)
                t0 = time.perf_counter()
                for i in range(PARITY_WINDOW_STEPS):
                    if i == 1:
                        out["launches"][name] = _parity_step(
                            torch, run, i, f"parity {name} step 2", smi,
                            mods, PARITY_K2_BF16[window])
                    else:
                        run.step(i)
                traj = run.trajectories()
                run_s = time.perf_counter() - t0
                if not all(map(math.isfinite, sum(traj.values(), []))):
                    raise AssertionError(f"parity {name}: a loss is not "
                                         "finite")
                last[window] = {k: v[-1] for k, v in traj.items()}
                out["runs"][name] = {"last": last[window], "seconds": run_s}
                log(f"[parity] {name}: {PARITY_WINDOW_STEPS} bf16 steps in "
                    f"{run_s:.1f} s; last step {json.dumps(last[window])} "
                    f"on {smi}")
    finally:
        for p in procs:
            p.join()
    for k in ("recon_loss", "kl_loss"):
        a, b = last[0][k], last[WINDOW][k]
        gap = abs(a - b) / max(abs(a), abs(b))
        log(f"[parity] window_dynamics {k} at step {PARITY_WINDOW_STEPS}: "
            f"global {a:.6g}, window {b:.6g}, {gap:.2%} apart (bar "
            f"{PARITY_WINDOW_AGREE:.0%})")
        if gap > PARITY_WINDOW_AGREE:
            raise AssertionError(f"parity window_dynamics: {k} of the two "
                                 "modes differ")
    failed = [PARITY_RUNS[i] for i, p in enumerate(procs) if p.exitcode]
    if failed:
        raise AssertionError(f"parity: the runs {failed} failed")
    for i in range(len(PARITY_RUNS)):
        r = json.loads((tmp / f"parity_{i}.json").read_text())
        out["launches"][r["name"]] = r.pop("launches")
        out["between"] += r.pop("between")
        out["runs"][r.pop("name")] = r
    if out["between"]:
        log(f"[parity] between the deterministic and sampled bands: "
            f"{out['between']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if sys.argv[1:2] == ["--serve"]:
        return serve_bundles(torch, Path(sys.argv[2]))
    smi = probe(torch)
    if sys.argv[1:2] == ["--grads"]:
        return spread_grads(torch, int(sys.argv[2]),
                            *(int(a) for a in sys.argv[3:4]))
    if sys.argv[1:2] == ["--profiler-loss"]:
        return profiler_loss(torch, int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--step-noise"]:
        return step_noise(torch, int(sys.argv[2]))
    if sys.argv[1:2] == ["--k5-f32"]:
        for _ in range(int(sys.argv[2])):
            log(f"[K5] f32 [32, 128, 128, 64] -> 64: "
                f"{time_k5_f32(torch, dev):.3f} ms on {smi}")
        return 0
    t_start = time.perf_counter()
    seconds = {}                        # phase -> seconds

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[phase] = round(seconds.get(phase, 0.0)
                               + time.perf_counter() - t0, 1)
        log(f"[time] phase {phase}: {seconds[phase]:.1f} s")
        return result

    sass_counts = timed("2 build", build)
    k1 = timed("3 K1", check_k1, torch, dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"],
                            timed("3 K1", check_k1_train, torch, dev))
    # Host-bound work runs in processes of its own under phase 4, whose
    # readings are kernel times on the card (CUDA events around kernels):
    # phase 6's CPU decodes (four threads) and phase 17's exports (two).
    # Both are joined at its end; no other timed phase overlaps them.
    spawn = multiprocessing.get_context("spawn")
    ctx_dir = tempfile.TemporaryDirectory()
    ctx_proc = spawn.Process(target=_cpu_context_refs, args=(ctx_dir.name,),
                             daemon=True)
    serve_dir = tempfile.TemporaryDirectory()
    exporter = spawn.Process(target=_export_bundles, args=(serve_dir.name,),
                             daemon=True)
    ctx_proc.start()
    exporter.start()
    k2 = timed("4 K2", check_k2, torch, dev, smi)
    timed("4 K2", lambda: (ctx_proc.join(), exporter.join()))
    if ctx_proc.exitcode:
        raise AssertionError(f"phase 6's CPU decodes failed ({ctx_proc.exitcode})")
    with tempfile.TemporaryDirectory() as tmp:
        launches = timed("5 slice", run_slice, torch, Path(tmp), smi)
    ctx_refs = torch.load(Path(ctx_dir.name) / "ctx_refs.pt", weights_only=False)
    for feature_dim in CONTEXT_WIDTHS:
        timed("6 context", run_context, torch, Path(ctx_dir.name),
              feature_dim, ctx_refs[feature_dim])
    ctx_dir.cleanup()
    # Phase 9's CPU steps run in a process of their own under phase 7,
    # whose work is all on the card.
    grad_refs = tempfile.TemporaryDirectory()
    refs_path = Path(grad_refs.name) / "grad_refs.pt"
    refs_proc = spawn.Process(target=_cpu_grad_refs, args=(str(refs_path),),
                              daemon=True)
    refs_proc.start()
    bwd = timed("7 K2 bwd", check_k2_bwd, torch, dev, smi)
    k3 = timed("8 K3", check_k3, torch, dev, smi)
    refs_proc.join()
    if refs_proc.exitcode:
        raise AssertionError(f"phase 9's CPU steps failed ({refs_proc.exitcode})")
    refs = torch.load(refs_path, weights_only=False)
    grad_refs.cleanup()
    for feature_dim, sided in GRAD_WIDTHS:
        timed("9 grads", run_grad_context, torch, feature_dim, sided,
              refs[feature_dim])
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as m2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as m1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as m3
    train, bare = timed("10 train", run_train, torch, smi, m1, m2, m3)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = timed("15 trainer", run_trainer, torch, Path(tmp), smi,
                        bare)
    k5 = timed("11 K5", check_k5, torch, dev, smi)
    stages = timed("12 stages", check_stages, torch, dev, smi)
    lane, pass1 = timed("13 lane sums", check_lane_sums, torch, dev, smi)
    tools = timed("14 tools", run_tools, torch)
    mods = {"k1": m1, "k2": m2, "k3": m3}
    with tempfile.TemporaryDirectory() as tmp:
        recipe = timed("20 recipe", run_recipe, torch, Path(tmp), smi, mods)
        low_end = timed("20 recipe", run_recipe, torch, Path(tmp), smi, mods,
                        "low-end")
        f32_recipe = timed("20 recipe", run_recipe_f32, torch, Path(tmp),
                           smi, mods)
    window = timed("16 window", check_window, torch, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        evaluate = timed("16 window", run_evaluate, torch, Path(tmp), smi)
        wstep = timed("16 window", run_window_train, torch, smi, mods)
        wstep32 = timed("16 window", run_window_train_f32, torch, smi, mods)
        wtrainer = timed("16 window", run_window_trainer, torch, Path(tmp),
                         smi, mods)
    serving = timed("17 serve", run_serving, torch, Path(serve_dir.name), smi,
                    exporter)
    synth = timed("17 serve", run_synthesis, torch, Path(serve_dir.name), smi)
    serve_dir.cleanup()
    with tempfile.TemporaryDirectory() as tmp:
        dist_a = timed("18 dist", run_dist_nccl, torch, Path(tmp), smi)
        dist_b = timed("18 dist", run_dist_gloo, torch, Path(tmp), smi)
        dist_c = timed("18 dist", run_dist_tp_ep, torch, Path(tmp), smi)
    # Phase 19's host-bound runs of (a) and (b) go on beside its (c).
    parity_dir = tempfile.TemporaryDirectory()
    parity_procs = start_parity(Path(parity_dir.name), smi)
    parity = timed("19 parity", run_parity, torch, Path(parity_dir.name), smi,
                   mods, parity_procs)
    parity_dir.cleanup()
    sass = timed("2 build", sass_counts)
    # Phase 19's paths: each parity run's profiled second step.
    p19 = lambda key: {"launches_parity": {
        run: counts[key] for run, counts in parity["launches"].items()}}
    # Phase 18's paths: the K2 launches on q shards in (b)'s allgather step
    # (rank 1; `launches_dist_allgather`), and the kernels alone on one
    # rank's CP shard (`cp_shard_*`).
    fused_cp = (dist_b["bwd"] if dist_b["bwd"]["cp_shard_variant"] == "fused"
                else {})
    # Phase 18 (c)'s path: rank 0's launches in the f32 TP/EP step.
    p18 = lambda key: {"launches_tp_ep": dist_c["launches"][key]}
    # Phase 17's paths: one bf16 generate and one score of a loaded "cuda"
    # bundle at batch 8 (the serving process's counts).
    x17 = lambda key: {
        "launches_bundle_generate": serving["launches"]["generate"][key],
        "launches_bundle_score": serving["launches"]["score"][key]}
    # Phase 16's paths: W = one windowed bf16 train step, E = one windowed
    # bf16 evaluate batch of 16, trainer_launches_window = 16 (d)'s run.
    w16 = lambda key: {"launches_window_step": wstep["launches"][key],
                       "trainer_launches_window": wtrainer["launches"][key]}
    # The windowed f32 default backward's readings go to the kernel that
    # ran it: the fused one (three TF32 passes), else split's.
    wf32 = window["bwd_f32"]
    w_fused = wf32 if wf32["window_variant"] == "fused" else {}
    w_split = ({"split_" + k: v for k, v in wf32.items()}
               if wf32["window_variant"] == "split" else {})
    # The f32 bodies on the tensor cores (three TF32 passes) and their
    # launches in one default f32 train step of phase 10.
    f32_step = train["f32_step"]
    src = "lunaris_orion_tpu_torch/csrc/"
    fa = "lunaris_orion_tpu/ops/pallas/flash_attention.py"
    kernels = [
        dict(name="gn_mish", route="cuda", source=src + "gn_mish.cu",
             replaces="lunaris_orion_tpu/ops/pallas/gn_mish.py:55",
             launches=launches["gn_mish"],
             trainer_launches=trainer["gn_mish"], **w16("gn_mish"),
             **x17("gn_mish"), **p18("gn_mish"), **p19("gn_mish"), **k1,
             **pass1),
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cuh", replaces=f"{fa}:335",
             launches=launches["flash_attention_fwd"],
             trainer_launches=trainer["flash_attention_fwd"],
             launches_evaluate=evaluate["evaluate_window_bf16_launches"],
             f32_body="flash_fwd_wgmma_tf32",
             f32_source=src + "flash_attention_fwd_wgmma_tf32_d16.cu",
             launches_f32_step=f32_step["launches flash_attention"],
             **w16("flash_attention_fwd"), **x17("flash_attention_fwd"),
             **p18("launches"), **p19("flash_attention_fwd"), **k2,
             **window["fwd"], **dist_b["fwd"]),
        dict(name="flash_attention_bwd_fused", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:574",
             launches=train["flash_attention_bwd_fused"],
             trainer_launches=trainer["flash_attention_bwd_fused"],
             f32_body="flash_bwd_fused_tf32",
             f32_source=src + "flash_attention_bwd_tf32_fused.cu",
             launches_f32_step=f32_step["bwd_fused_launches flash_attention"],
             **w16("flash_attention_bwd_fused"),
             **p18("bwd_fused_launches"), **p19("flash_attention_bwd_fused"),
             **bwd["flash_attention_bwd_fused"],
             **{k + "_bf16": v for k, v in window["bwd_bf16"].items()},
             **w_fused, **fused_cp, **dist_b["fused"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:474",
             launches=train["flash_attention_bwd_dq"],
             **w16("flash_attention_bwd_dq"), **p18("bwd_dq_launches"),
             **bwd["flash_attention_bwd_dq"], **w_split, **dist_b["dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:514",
             launches=train["flash_attention_bwd_dkv"],
             **w16("flash_attention_bwd_dkv"), **p18("bwd_dkv_launches"),
             **bwd["flash_attention_bwd_dkv"], **w_split, **dist_b["dkv"]),
        # The warpgroup bodies (bf16 d 48 and 64): times at the H100
        # recipe's head size, N16384: the B8 forward at dropout 0, the fused
        # backward at dropout 0.1 at B2, where the plain backward and the
        # CUDA-core kernel it replaced are timed too (B16 under `readings`,
        # with every other reading); launches in phase 20's recipe step
        # (and its decode+score).
        dict(name="flash_attention_fwd_wgmma", route="cuda",
             source=src + "flash_attention_fwd.cuh", replaces=f"{fa}:335",
             instances=[src + f"flash_attention_fwd_wgmma_d{d}{x}.cu"
                        for d in (48, 64) for x in ("", "_drop")],
             launches=recipe["launches_step"]["flash_attention_fwd_wgmma"],
             launches_decode=recipe["launches_decode"][
                 "flash_attention_fwd_wgmma"],
             max_abs_err=max(r["max_abs_err"] for r in k2["wgmma"].values()),
             **{key: k2["wgmma"]["d64 dropout 0.0"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "earlier_ms")},
             earlier_body="flash_fwd_mma", readings=k2["wgmma"],
             shard_max_abs_err=k2["wgmma_shard"]),
        dict(name="flash_attention_bwd_wgmma", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:574",
             instances=[src + f"flash_attention_bwd_wgmma_d{d}{x}.cu"
                        for d in (48, 64) for x in ("", "_drop")],
             launches=recipe["launches_step"]["flash_attention_bwd_wgmma"],
             max_abs_err=bwd["wgmma"]["max_abs_err"],
             **{key: bwd["wgmma"][64][key] for key in (
                 "shape", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "earlier_ms")},
             earlier_body="flash_bwd_dkv (CUDA cores, fused dq)",
             readings={f"d{d}": bwd["wgmma"][d] for d in (48, 64)}),
        # The narrow warpgroup bodies (bf16 d 16, the default width, and
        # d 32, the low-end recipe's): times at the teacher's shape at d 16
        # (forward B8, dropout 0; fused backward B2, dropout 0.1, where the
        # plain backward is timed too), each against the mma.sync body it
        # replaced in turns, beside SDPA and both floors (`bound_ms`: the
        # tensor cores or the bytes; `bound_ms_sfu`: one exp a score on the
        # special-function units); every reading under `readings` (B16,
        # dropout 0 and 0.1, the short rows), d 32's under `d32` (forward
        # B8 dropout 0, fused backward B16 dropout 0.1) and
        # `readings_d32`, the inner loop's SASS per 32 scores under
        # `sass`; launches in phase 10's train steps (and the forward's in
        # phase 5's bf16 decode+score), at d 32 in phase 20's low-end step
        # and decode+score (`launches_low_end*`).
        dict(name="flash_attention_fwd_wgmma_narrow", route="cuda",
             source=src + "flash_attention_fwd.cuh", replaces=f"{fa}:335",
             instances=[src + f"flash_attention_fwd_wgmma_d{d}{x}.cu"
                        for d in (16, 32) for x in ("", "_drop")],
             launches=train["flash_attention_fwd_wgmma_narrow"],
             launches_decode=launches["narrow_decode"],
             launches_low_end=low_end["launches_step"][
                 "flash_attention_fwd_wgmma_narrow"],
             launches_low_end_decode=low_end["launches_decode"][
                 "flash_attention_fwd_wgmma_narrow"],
             d32={key: k2["narrow32"]["B8 dropout 0.0"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "library_ms", "earlier_ms", "max_abs_err")},
             readings_d32=k2["narrow32"],
             **w16("flash_attention_fwd_wgmma_narrow"),
             max_abs_err=max(r["max_abs_err"] for key, r in
                             k2["narrow"].items() if key != "short rows"),
             **{key: k2["narrow"]["B8 dropout 0.0"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "library_ms", "earlier_ms")},
             earlier_body="flash_fwd_mma", readings=k2["narrow"],
             sass={k: v for k, v in sass.items()
                   if k.startswith("fwd") and "window" not in k}),
        dict(name="flash_attention_bwd_wgmma_narrow", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:574",
             instances=[src + f"flash_attention_bwd_wgmma_d{d}{x}.cu"
                        for d in (16, 32) for x in ("", "_drop")],
             launches=train["flash_attention_bwd_wgmma_narrow"],
             launches_low_end=low_end["launches_step"][
                 "flash_attention_bwd_wgmma_narrow"],
             d32={**{key: bwd["narrow32"]["B16 dropout 0.1"][key] for key in (
                 "ms", "library_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "earlier_ms")}, "shape": "B16 H8 N16384 dropout 0.1",
                 "max_abs_err": bwd["narrow32"]["max_abs_err"]},
             readings_d32=bwd["narrow32"],
             **w16("flash_attention_bwd_wgmma_narrow"),
             max_abs_err=bwd["narrow"]["max_abs_err"],
             **{key: bwd["narrow"]["B2 dropout 0.1"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "library_ms", "earlier_ms")},
             shape="B2 H8 N16384 dropout 0.1",
             earlier_body="flash_bwd_dkv_mma<16, .., FUSED>",
             readings=bwd["narrow"],
             sass={k: v for k, v in sass.items()
                   if k.startswith("bwd") and "window" not in k}),
        # The f32 window bodies (f32 d 16 and 32 on the windowed fold, three
        # TF32 passes split in the kernel): times at B16 H8 N16384 W256 d 16
        # against the mma.sync bodies in turns, d 32's under `d32`; launches
        # in phase 16's windowed f32 step and the forward's in a windowed f32
        # evaluation batch; the step's readings under `step`.
        *(dict(name=f"flash_attention_{x}_window_tf32", route="cuda",
               source=src + "flash_attention_window_tf32.cuh",
               replaces=f"{fa}:{line}",
               instances=[src + f"flash_attention_{x}_window_tf32_d{d}{y}.cu"
                          for d in (16, 32) for y in ("", "_drop")],
               launches=wstep32["launches"][f"flash_attention_{x}_window"],
               **({"launches_evaluate":
                   evaluate["evaluate_window_f32_window_launches"]}
                  if x == "fwd" else {}),
               **window[f"window_{x}"]["f32_d16"],
               d32=window[f"window_{x}"]["f32_d32"], earlier_body=earlier,
               step={k: v for k, v in wstep32.items() if k != "launches"},
               sass={k: v for k, v in sass.items()
                     if k.startswith(f"{x} f32 window")})
          for x, line, earlier in (
              ("fwd", 335, "flash_fwd_tf32 (mma.sync, three TF32 passes)"),
              ("bwd", 574, "flash_bwd_fused_tf32 (mma.sync) with the call's "
                           "delta, zeroed f32 dq buffer and cast"))),
        # The window bodies (bf16 d 16 and 32 on the windowed fold): times
        # at B16 H8 N16384 W256 d 16 (phase 16 (a)), each against the
        # mma.sync body it replaced in turns, beside the plain version, SDPA
        # on the folded shape and both floors; d 32's under `d32`; launches
        # in phase 16's windowed step (W), its trainer run, and the
        # forward's in a windowed evaluation batch (E).
        *(dict(name=f"flash_attention_{x}_window", route="cuda",
               source=src + "flash_attention_window.cuh",
               replaces=f"{fa}:{line}",
               instances=[src + f"flash_attention_{x}_window_d{d}{y}.cu"
                          for d in (16, 32) for y in ("", "_drop")],
               launches=wstep["launches"][f"flash_attention_{x}_window"],
               trainer_launches_window=wtrainer["launches"][
                   f"flash_attention_{x}_window"],
               **({"launches_evaluate":
                   evaluate["evaluate_window_bf16_window_launches"]}
                  if x == "fwd" else {}),
               **window[f"window_{x}"]["d16"],
               d32=window[f"window_{x}"]["d32"], earlier_body=earlier,
               sass={k: v for k, v in sass.items()
                     if k.startswith(f"{x} window")})
          for x, line, earlier in (
              ("fwd", 335, "flash_fwd_mma"),
              ("bwd", 574, "flash_bwd_dkv_mma<.., FUSED> with the call's "
                           "delta, zeroed f32 dq buffer and cast"))),
        # The f32 warpgroup bodies (three TF32 passes on wgmma) at d 16, the
        # default type and width, and at d 32, 48 and 64, the low-end,
        # mid-range and H100-tier widths: the forward at B8 H8 N16384,
        # dropout 0, the fused backward at B2 H8 N16384, dropout 0.1 (where
        # the plain backward is timed), each against the body it replaced in
        # turns (the forward's mma.sync one; the backward's mma.sync one at
        # d 16 and 32 and the CUDA-core one at 48 and 64), beside SDPA in
        # f32, the three-pass bound and the special-function floor; d 16's
        # under the plain keys, the others' under `d32`, `d48` and `d64`
        # (the backward's train-step batch there: B16, B8 at d 32); every
        # reading under `readings` (`readings_d32` ..: both rates, ragged
        # N, the CP shard, the short rows, the mask); launches in phase 10's
        # train steps (`launches_f32_step`: the default f32 step's), the
        # forward's in phase 5's f32 decode+score, and in phase 20's f32
        # runs (`launches_recipe_f32_decode`: the H100 tier's decode+score,
        # d 64; `launches_recipe_f32_step`: the mid-range tier's step, d 48;
        # `..._low_end`: the low-end tier's, d 32). Their pre-pass, which
        # splits and lays out the operands once a call, is the next entry.
        dict(name="flash_attention_fwd_wgmma_tf32", route="cuda",
             source=src + "flash_attention_fwd.cuh", replaces=f"{fa}:335",
             instances=[src + f"flash_attention_fwd_wgmma_tf32_d{d}{x}.cu"
                        for d in (16, *TF32_WIDE) for x in ("", "_drop")],
             launches=train["flash_attention_fwd_wgmma_tf32"],
             launches_f32_step=f32_step[
                 "tf32_wgmma_launches flash_attention"],
             launches_decode=launches["tf32_decode"],
             **{f"launches_recipe_f32_{run}": f32_recipe[run]["launches"][
                 "flash_attention_fwd_wgmma_tf32"] for run in F32_RECIPE_RUNS},
             max_abs_err=max(k2[x]["max_abs_err"] for x in (
                 "tf32", *(f"tf32_d{d}" for d in TF32_WIDE))),
             **{key: k2["tf32"]["B8 dropout 0.0"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "library_ms", "earlier_ms")},
             **{f"d{d}": {key: k2[f"tf32_d{d}"]["B8 dropout 0.0"][key]
                          for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "bound_ms_sfu",
                                      "library_ms", "earlier_ms")}
                | {"max_abs_err": k2[f"tf32_d{d}"]["max_abs_err"]}
                for d in TF32_WIDE},
             shape="B8 H8 N16384 dropout 0", earlier_body="flash_fwd_tf32",
             readings={k: v for k, v in k2["tf32"].items()
                       if k != "pre-pass"},
             **{f"readings_d{d}": {k: v for k, v in k2[f"tf32_d{d}"].items()
                                   if k != "pre-pass"} for d in TF32_WIDE}),
        dict(name="flash_attention_bwd_wgmma_tf32", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:574",
             instances=[src + f"flash_attention_bwd_wgmma_tf32_d{d}{x}.cu"
                        for d in (16, *TF32_WIDE) for x in ("", "_drop")],
             launches=train["flash_attention_bwd_wgmma_tf32"],
             launches_f32_step=f32_step[
                 "bwd_tf32_wgmma_launches flash_attention"],
             **{f"launches_recipe_f32_{run}": f32_recipe[run]["launches"][
                 "flash_attention_bwd_wgmma_tf32"]
                for run in ("step", "step_low_end")},
             max_abs_err=max(bwd[x]["max_abs_err"] for x in (
                 "tf32", *(f"tf32_d{d}" for d in TF32_WIDE))),
             **{key: bwd["tf32"]["B2 dropout 0.1"][key] for key in (
                 "ms", "plain_ms", "bound_ms", "bound_by", "bound_ms_sfu",
                 "library_ms", "earlier_ms")},
             **{f"d{d}": {key: bwd[f"tf32_d{d}"]["B2 dropout 0.1"][key]
                          for key in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "bound_ms_sfu",
                                      "library_ms", "earlier_ms")}
                | {"max_abs_err": bwd[f"tf32_d{d}"]["max_abs_err"],
                   big: bwd[f"tf32_d{d}"][f"{big} dropout 0.1"],
                   "earlier_body": "flash_bwd_fused_tf32 (mma.sync)"
                   if d == 32 else "flash_bwd_dkv<float, D, true> "
                                   "(CUDA cores, fused dq)"}
                for d in TF32_WIDE for big in ("B8" if d == 32 else "B16",)},
             shape="B2 H8 N16384 dropout 0.1",
             earlier_body="flash_bwd_fused_tf32", readings=bwd["tf32"],
             **{f"readings_d{d}": bwd[f"tf32_d{d}"] for d in TF32_WIDE}),
        dict(name="k2_tf32_split", route="cuda",
             source=src + "flash_attention_tf32_split.cu",
             replaces=f"{fa}:335",
             part_of=["flash_attention_fwd_wgmma_tf32",
                      "flash_attention_bwd_wgmma_tf32"],
             launches=train["k2_tf32_split"],
             launches_f32_step=f32_step["split_launches flash_attention"],
             **{f"launches_recipe_f32_{run}": f32_recipe[run]["launches"][
                 "k2_tf32_split"] for run in F32_RECIPE_RUNS},
             **k2["tf32"]["pre-pass"],
             **{f"d{d}": k2[f"tf32_d{d}"]["pre-pass"] for d in TF32_WIDE}),
        dict(name="mse_kl", route="cuda", source=src + "loss_epilogue.cu",
             replaces="lunaris_orion_tpu/ops/pallas/loss_epilogue.py:22",
             launches=train["mse_kl"], trainer_launches=trainer["mse_kl"],
             **w16("mse_kl"), **p18("mse_kl"), **p19("mse_kl"), **k3),
        dict(name="gn_mish_conv3", route="cuda",
             source=src + "fused_stage_mma.cu",
             replaces="lunaris_orion_tpu/ops/pallas/fused_stage.py:56",
             launches=tools["gn_mish_conv3"], **k5),
        dict(name="flash_fwd_stage", route="cuda",
             source=src + "flash_attention_stages.cu",
             replaces="tools/bench_attn_roofline.py:54",
             launches=tools["flash_fwd_stage"], **stages),
        dict(name="lane_sums_partials", route="cuda",
             source=src + "gn_stats.cu",
             replaces="tools/bench_gn_stats2.py:52",
             launches=tools["lane_sums_partials"], **lane),
    ]
    log(f"[time] phases: {json.dumps(seconds)}")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.0f} s")
    log(f"[serve] summary: {json.dumps({**serving, **synth})}")
    log(f"[dist] summary: {json.dumps({'a': dist_a, 'b': dist_b, 'c': dist_c})}")
    log(f"[parity] summary: {json.dumps(parity)}")
    log(f"[recipe] summary: {json.dumps(recipe)}")
    log(f"[recipe] low-end summary: {json.dumps(low_end)}")
    log(f"[recipe] f32 summary: {json.dumps(f32_recipe)}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
