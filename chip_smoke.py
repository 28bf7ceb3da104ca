#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lunaris_orion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository
    python3 chip_smoke.py --grads N  # phase 9 alone, its spread (below)
    python3 chip_smoke.py --k5-f32 N # K5's f32 time alone, N times
    python3 chip_smoke.py --profiler-loss N  # torch.profiler's lost records

Phases, each of which raises on failure (exit code 1):
  1. probe    torch / CUDA versions, the card, nvidia-smi, nvcc, triton;
  2. build    compile the hand-written kernels from csrc/ with nvcc;
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
              N 16384, d 16) with dropout 0 and 0.1, f32 (CUDA cores) and
              bf16 (tensor cores), and at d 8/32/48/64 and a ragged N; bf16
              element by element against the plain version's online form;
              the tensor-core bf16 kernel timed against the CUDA-core one it
              replaced (earlier, new, new, earlier); d 32 (feature_dim 256)
              at B 8, N 16384 timed beside F.scaled_dot_product_attention;
  5. slice    `lunaris_orion_tpu_torch.cli.generate` at the full default
              width (128 px, 4 experts x 3 blocks, N = 16384) from a seeded
              random checkpoint, f32 and --bf16; both kernels' launch
              counts must be above 0; decode+score sprites/s, and one call
              under torch.profiler: device time by kernel, idle share;
  6. context  64 px configs (N = 4096) through the port on the CPU (plain
              versions) and on the card (kernels) from one checkpoint and
              one z, TF32 off, at feature_dim 64 (d 8) and 256 (d 32):
              decode within 1/255, quality within 1e-3;
  7. K2 bwd   both backward variants (fused = dk/dv with dq; split = dk/dv +
              dq kernels) against the plain backward at B 2, H 8, N 16384,
              d 16, dropout 0 and 0.1, f32 (CUDA cores) and bf16 (tensor
              cores), at d 8/32/48/64, at a ragged rectangular 2000 x 300
              and 300 x 2000 in bf16, with a q shard at q_offset, and at the
              teacher's training shape (B 16, H 8, N 16384, d 16, dropout
              0.1), f32 and bf16, where it also times every kernel and the
              plain version; bf16 element by element; the tensor-core bf16
              fused, dk/dv and dq kernels timed against the CUDA-core ones
              they replaced, and the two variants against each other (each
              earlier, new, new, earlier) beside the backward of
              `F.scaled_dot_product_attention`; both variants at d 32, B 8,
              N 16384 beside it, and in turns at N 4096 at every head size
              (what `default_bwd` follows);
  8. K3       the MSE+KL kernel against its plain version and the plain
              version of its own order of summation at [16, 128, 128, 3],
              L = 256, f32 and bf16, the same bits on two calls, timed
              against its earlier form (one block a sample, then torch
              sums) in turns;
  9. grads    one `train_step` of a 64 px config (N = 4096) on the CPU
              (plain versions) and on the card (kernels) from one state,
              one batch and one eps, dropout 0, TF32 off: gradients (1e-3
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
              at B 2 and the tool's B 8, H 8, N 16384, d 16, f32 (CUDA-core
              body) and bf16 (tensor-core body); "sum" bit-equal to the
              forward kernel at dropout 0; times at B 8 bf16;
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
 16. window   (run last) windowed attention, the evaluator and the training
              options at window 256: (a) `local_window_attention` (K2 over
              the windows folded into the heads) at B16 H8 N16384 d16, f32
              and bf16, forward at dropout 0 and 0.1 and the default
              backward at 0.1 against the plain versions on the folded
              shape (phase 4's and 7's bars), a call in 4 batch chunks
              bit-equal to one call, times beside the global K2 at B16, the
              plain version, F.scaled_dot_product_attention on the folded
              shape and the bound; (b) `lunaris_orion_tpu_torch.cli.evaluate`
              at the full default width on 16 PNGs at 128 px, an 8-sprite
              shard and 2 PNGs at 120 px (the global fallback), global and
              --attn_window 256, f32 and --bf16: 26 scores, the fallback
              marked, K2 launched; one batch of 16 timed in each mode; at
              64 px the card's windowed scores against the CPU's (1e-3);
              (c) the bf16 train step at 16 x 2, remat, window 256: a cold
              step, one under torch.profiler (its launches: every kernel of
              the path), fuse_teacher against the unfused step in turns,
              one step with cached prompt embeddings and one with
              bf16_momentum; (d) `lunaris-train` with --attn_window 256
              --cached_prompt_embeddings --bf16_momentum on a 40-sprite
              corpus: one epoch, a resume whose restored state equals the
              saved file bit for bit, one more epoch; the table's refresh
              ms.

Kernel times are medians of CUDA-event timings. Each kernel's `bound_ms` is
the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its operations over the peak of its input type (989 TFLOP/s
bf16, 67 TFLOP/s f32 outside the tensor cores), at the shape its `ms` was
taken at; `library_ms` is one PyTorch call computing the same function
(`F.scaled_dot_product_attention` for K2; for K5 K1 followed by F.conv2d
and its bias, the fastest of three ways to add it; for the lane sums
torch.var_mean over the grouped view), timed here and used nowhere in the port. The entries of the
K2 forward and of the three K2 backward kernels carry the f32 reading under the plain keys and the bf16 reading under
`*_bf16` (`earlier_ms_bf16`: the CUDA-core bf16 kernel on the same
inputs; `body`, `body_bf16`: the body the instance rule gives), and the
head size 32 times at B 8 under `*_d32` (the backward's: its variant's
`flash_attention_bwd`). K5's entry names its `body` and carries the
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
`window_bound_by*` and `window_max_abs_err*` to the K2 forward's; the
windowed default backward's (`window_variant`, `window_ms`, ...) to the
fused backward's under `*_bf16` and, for f32 (split), to dq's and dk/dv's
under `split_*`. The last lines are the card's
name and power limit, a JSON object with the kernels' measurements and,
last, the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card it exits with code 2 and prints no result.

`--grads N` runs phase 9's comparison alone, N times with the kernels and N
times with K1, K2 and K3's plain versions on the card, against one CPU
step, and prints each reading (`spread_grads`).

`--profiler-loss N` profiles phase 5's decode+score N times in f32 and N in
bf16, with no quiet margin and with `PROFILE_MARGIN_S`, and counts the
sessions whose record of K1's launches falls short of the wrapper's count
(`profiler_loss`).
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    from lunaris_orion_tpu_torch.tools._timing import time_ms as timer
    return timer(fn, "cuda", reps, warmup)


# torch.profiler on the H100 (torch 2.11, CUDA 12.8) now and then drops the
# kernels that run in the first milliseconds of a session, K1's launches at
# the head of a decode among them (`--profiler-loss`). A quiet margin after
# the session starts, and another before it stops, keeps every record.
PROFILE_MARGIN_S = 0.1


@contextlib.contextmanager
def profiled(torch, margin: float = PROFILE_MARGIN_S):
    """A torch.profiler session of the card's kernels, with `margin`
    seconds of quiet after it starts and before it stops. The body's
    kernels have ended when the block exits."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        time.sleep(margin)
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
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


PEAK_BYTES = 3.35e12                       # H100 SXM: bytes/s of device memory
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor cores; f32 outside them


def bound(ops: float, nbytes: float, kind: str) -> dict:
    """The least time the card could take: operations over the peak of
    their type against bytes over the memory rate, whichever is larger."""
    t_ops, t_bytes = ops / PEAK_OPS[kind] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


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
# template argument, kFusedDq or FUSED, is true.
KERNEL_GROUPS = (("K2 fwd", lambda k: "flash_fwd" in k),
                 ("K2 bwd fused", lambda k: re.search(
                     r"flash_bwd_dkv\w*<[^>]*\btrue>", k) is not None),
                 ("K2 bwd dk/dv", lambda k: "flash_bwd_dkv" in k),
                 ("K2 bwd dq", lambda k: "flash_bwd_dq" in k),
                 ("K1", lambda k: any(p in k for p in K1_KERNELS)),
                 ("K3", lambda k: "mse_kl" in k))


def check_k1_kernels(k1_kernels: dict, calls: int, tag: str) -> None:
    """K1 on the main path is two kernels a call, pass 1 and the apply with
    the fold; the fold kernel of the earlier form does not run."""
    want = {"gn_stats_partial": calls, "gn_mish_apply_fold": calls}
    if k1_kernels != want:
        raise AssertionError(f"{tag}: K1's kernels {k1_kernels}, expected "
                             f"{want} for {calls} calls")


def device_share(torch, fn, tag: str, smi: str):
    """Run fn() once under torch.profiler and log its device time by kernel
    group, with the share of the host's time in which the device was idle,
    and K1's kernels by name. Returns (fn's result, the host's seconds,
    {K1 kernel name: launches}, the device's milliseconds)."""
    from torch.autograd import DeviceType
    with profiled(torch) as p:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    ms = dict.fromkeys([name for name, _ in KERNEL_GROUPS] + ["other"], 0.0)
    k1_kernels = {}
    for e in p.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        group = next((g for g, member in KERNEL_GROUPS if member(e.key)),
                     "other")
        ms[group] += e.self_device_time_total / 1e3
        if group == "K1":
            name = next(n for n in K1_KERNELS if n in e.key)
            k1_kernels[name] = k1_kernels.get(name, 0) + e.count
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
    return result, host_s, k1_kernels, total


def probe(torch) -> str:
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[probe] device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} "
        f"sm_count {torch.cuda.get_device_properties(0).multi_processor_count}")
    from lunaris_orion_tpu_torch.tools._timing import card_line
    smi = card_line("cuda")
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


def build() -> None:
    from lunaris_orion_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"[build] {_build.build_dir()} in {time.perf_counter() - t0:.1f} s")
    report = (_build.build_dir() / "build.log").read_text().splitlines()
    for line in report:
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line or line.startswith("nvcc seconds")):
            log("[build]   " + line.strip())
    # K5's tensor-core body: no instance spills, and its SASS holds HMMA.
    fn, spills = None, []
    for line in report:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        fn = m.group(1) if m else fn
        if (fn and "gn_mish_conv3_mma" in fn
                and re.search(r"[1-9]\d* bytes spill", line)):
            spills.append(fn)
    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    ops, fn = {}, None          # instruction counts a K5 instance, static
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                       line)
        if fn and "gn_mish_conv3_mma" in fn and op:
            count = ops.setdefault(fn, {"all": 0})
            count["all"] += 1
            count[op.group(1)] = count.get(op.group(1), 0) + 1
    for fn, count in sorted(ops.items()):
        log(f"[build] K5 {fn[-40:]}: " + ", ".join(
            f"{k} {count.get(k, 0)}" for k in ("all", "HMMA", "LDSM", "MUFU",
                                               "FFMA", "FADD", "FMUL")))
    if spills or len(ops) != 2 or not all(c.get("HMMA") for c in ops.values()):
        raise AssertionError(f"K5's tensor-core body spills ({spills}) or "
                             f"has no HMMA in its SASS")


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
# 1.5e-4 at N 16384; 9 in 1000). An element in the wrong place is off by a
# tenth of the largest or more.
K2_BF16_BAR = {"simt": (2e-5, 1e-2), "mma": (1e-3, 3e-2)}


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
    out = {}
    # The teacher's shape at the serving batch and the train step's.
    cases = [(b, 8, 16384, 16, dt, rate) for b in (8, 16)
             for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases += [(8, 8, 4096, d, torch.float32, 0.1) for d in (8, 32, 48, 64)]
    cases += [(8, 8, 4096, d, torch.bfloat16, 0.1) for d in (8, 32, 48)]
    # d 32 (feature_dim 256) at the serving batch: times beside the library.
    cases += [(8, 8, 16384, 32, dt, 0.0)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [(8, 8, 4096, 64, torch.bfloat16, 0.0),
              (4, 8, 2000, 16, torch.float32, 0.1),
              (4, 8, 2000, 16, torch.bfloat16, 0.1),
              (4, 8, 2000, 16, torch.bfloat16, 0.0)]
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
        ok, note = err <= tol and lse_err <= 1e-4, ""
        if dt == torch.bfloat16:
            oo, olse = k2.attention_plain(q, k, v, bias, block_k=inst.block_k,
                                          **kw)
            agree, excess, differ = k2_bf16_agree(torch, o, oo, inst.body)
            ok = ok and agree and (lse - olse).abs().max().item() <= 1e-4
            note = (f"; online form: over 2 ulps by {max(excess, 0):.1e} of "
                    f"the largest (bar {K2_BF16_BAR[inst.body][0]:.0e}), "
                    f"{differ:.1e} differ (bar {K2_BF16_BAR[inst.body][1]:.0e})")
            del oo, olse
        big = n == 16384
        t_k = time_ms(torch, lambda: k2.flash_attention(q, k, v, bias, **kw),
                      5 if big else 10)
        flops = 4 * b * h * n * n * d
        log(f"[K2] {tag}: max_abs_err {err:.3e} (tol {tol:.1e}) lse_err "
            f"{lse_err:.1e}{note}; kernel {t_k:.3f} ms "
            f"({flops / t_k / 1e9:.2f} TFLOP/s)")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {tag}")
        if big and d == 32:
            del ro, rlse
            lib, lib_note = sdpa_ms(q, k, v, bias, reps=3)
            log(f"[K2] {tag}: kernel {t_k:.3f} ms, "
                f"F.scaled_dot_product_attention {lib} ms ({lib_note}) on "
                f"{smi}")
            suffix = "_d32" if dt == torch.float32 else "_bf16_d32"
            out |= {"ms" + suffix: t_k, "library_ms" + suffix: lib}
            continue
        if not (big and d == 16 and dt == torch.bfloat16 or
                big and b == 8 and rate == 0.0):
            continue
        del ro, rlse
        if dt == torch.bfloat16:
            # The CUDA-core bf16 kernel that the tensor-core one replaced, on
            # the same inputs, in turns: earlier, new, new, earlier.
            run = lambda body: time_ms(torch, lambda: k2.forward_kernel(
                q, k, v, bias, body=body, **kw), 3)
            t = [run("simt"), run("mma"), run("mma"), run("simt")]
            log(f"[K2] {tag}: earlier (CUDA cores) {t[0]:.3f}, new (tensor "
                f"cores) {t[1]:.3f}, new {t[2]:.3f}, earlier {t[3]:.3f} ms on "
                f"{smi}")
            if min(t[1:3]) >= min(t[0], t[3]):
                raise AssertionError(f"K2 at {tag}: the tensor-core kernel is "
                                     "no faster than the one it replaced")
        if b == 8 and rate == 0.0:
            t_p = time_ms(torch, lambda: k2.attention_plain(q, k, v, bias, **kw),
                          2)
            lib, lib_note = sdpa_ms(q, k, v, bias, reps=3)
            bd = bound(flops, nbytes(q, k, v, bias, o, lse),
                       "f32" if dt == torch.float32 else "bf16")
            log(f"[K2] {tag}: plain {t_p:.3f} ms, "
                f"F.scaled_dot_product_attention {lib} ms ({lib_note}), bound "
                f"{bd['bound_ms']:.3f} ms by {bd['bound_by']}")
            if dt == torch.float32:
                out |= {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                        "library_ms": lib, **bd}
            else:
                out |= {"max_abs_err_bf16": err, "ms_bf16": t_k,
                        "plain_ms_bf16": t_p, "library_ms_bf16": lib,
                        "bound_ms_bf16": bd["bound_ms"],
                        "bound_by_bf16": bd["bound_by"],
                        "earlier_ms_bf16": min(t[0], t[3])}
    return out


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
        _, _, k1_kernels, _ = device_share(
            torch, lambda: gen.decode_and_score(z), tag, smi)
        check_k1_kernels(k1_kernels, per_call[0], tag)
    return launches


def profiler_loss(torch, rounds: int, smi: str) -> int:
    """Profile phase 5's decode+score `rounds` times in f32 and in bf16, in
    turns with no margin and with PROFILE_MARGIN_S, and log how many
    sessions recorded fewer of K1's kernels than its wrapper launched."""
    from torch.autograd import DeviceType
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1

    build()
    cfg = TrainConfig()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "full.pt"
        save_checkpoint(torch, cfg, ckpt, seed=0)
        gens = [ImageGenerator(str(ckpt), device="cuda", bf16=b)
                for b in (False, True)]
    z = torch.randn(8, cfg.latent_dim, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    lost = {0.0: 0, PROFILE_MARGIN_S: 0}
    for _ in range(rounds):
        for gen in gens:
            for margin in lost:
                seen = k1.launches
                with profiled(torch, margin) as p:
                    gen.decode_and_score(z)
                recorded = sum(e.count for e in p.key_averages()
                               if e.device_type == DeviceType.CUDA
                               and any(n in e.key for n in K1_KERNELS))
                lost[margin] += recorded < 2 * (k1.launches - seen)
    for margin, n in lost.items():
        log(f"[profiler] margin {margin} s: {n} of {2 * rounds} decode+score "
            f"sessions lost K1 records, on {smi}")
    return 0


def run_context(torch, tmp: Path, feature_dim: int) -> None:
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator, full_f32

    # 64 px, 2 experts, 8 heads: N = 4096 > 1024 runs K2 at head size
    # feature_dim / 8 (64: d 8; 256: d 32, the low-end recipe's width).
    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=feature_dim,
                      embedding_dim=32, num_experts=2)
    ckpt = tmp / f"ctx{feature_dim}.pt"
    save_checkpoint(torch, cfg, ckpt, seed=1)
    z = torch.randn(2, cfg.latent_dim, generator=torch.Generator().manual_seed(2))
    # TF32 off for this comparison (the generator's f32 mode turns it off
    # too): cuDNN's default TF32 convolutions would break both bars.
    res = {}
    with full_f32():
        for dev in ("cpu", "cuda"):
            gen = ImageGenerator(str(ckpt), device=dev)
            imgs, quality, _ = gen.decode_and_score(z.to(dev))
            res[dev] = (imgs.cpu(), quality.cpu())
    d_img = (res["cpu"][0] - res["cuda"][0]).abs().max().item()
    d_q = (res["cpu"][1] - res["cuda"][1]).abs().max().item()
    log(f"[context] 64 px, feature_dim {feature_dim} (d {feature_dim // 8}), "
        f"TF32 off, CPU plain vs card kernels: decode max diff {d_img:.3e} "
        f"(bar {1 / 255:.3e}), quality max diff {d_q:.3e} (bar 1e-3)")
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
# every element.
K2_BWD_BF16_BAR = {"simt": (1e-3, 1e-2), "mma": (1e-3, 5e-2)}


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
    errs = {dt: {"fused": 0.0, "dkv": 0.0, "dq": 0.0}
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

    # Every head size in both types; at N 4096 the two variants are also
    # timed in turns, which is what `default_bwd` follows at the head sizes
    # that the teacher's shape below does not time.
    cases = [(2, 8, 16384, 16384, 16, dt, rate)
             for dt in (torch.float32, torch.bfloat16) for rate in (0.0, 0.1)]
    cases += [(2, 8, 4096, 4096, d, dt, 0.1) for dt in (torch.float32,
                                                         torch.bfloat16)
              for d in (8, 32, 48, 64)]
    cases += [(2, 8, 2000, 300, 16, torch.bfloat16, 0.1),
              (2, 8, 300, 2000, 16, torch.bfloat16, 0.0)]
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
    for dt in (torch.float32, torch.bfloat16):
        args, kw = inputs(2, 8, 4096, 4096, 16, dt, 0.1)
        q, k, v, bias, o, lse, do = args
        sl = slice(2048, None)
        body = bodies(dt, 16, 2048, 4096, 0.1)
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
                f"({body[variant]}) {str(dt)[6:]}: dq rows {text}")
            if not ok:
                raise AssertionError(f"K2 bwd {variant} {dt}: q_offset shard "
                                     "differs")

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
        if dt == torch.bfloat16:
            # The CUDA-core bf16 kernels that the tensor-core ones replaced,
            # on the same inputs, in turns: earlier, new, new, earlier.
            for name, run in (("fused", fused), ("dkv", dkv), ("dq", dqk)):
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

    # Head size 32 (feature_dim 256) at the serving batch: both variants in
    # turns beside the library's backward (correctness: the 4096 cases).
    d32 = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = inputs(8, 8, 16384, 16384, 32, dt, 0.1)
        tag = f"B8 H8 N16384 d32 {str(dt)[6:]} dropout 0.1"
        body = bodies(dt, 32, 16384, 16384, 0.1)
        fused_ms, split_ms = in_turns(variant_ms(args, kw), "split", "fused",
                                      f"{tag} flash_attention_bwd ({body})")
        lib, note = sdpa_ms(*args[:4], backward=True, dropout_p=0.1, reps=3)
        d32[dt] = {"fused": fused_ms, "split": split_ms, "sdpa": lib}
        log(f"[K2 bwd] {tag}: fused {fused_ms:.1f} ms, split {split_ms:.1f} "
            f"ms, backward of F.scaled_dot_product_attention {lib} ms "
            f"({note}) on {smi}; the default is {k2.default_bwd(dt, 32)}")
        del args
    # Bounds at the timing shape. Per (q, k) pair and head-dim element:
    # 2 operations each for the scores, dp, dv, dk and dq products.
    pairs_d = 16 * 8 * 16384 * 16384 * 16

    def entry(key, t, n_ops, out_bytes, lib, d32_key):
        bd = bound(n_ops * pairs_d, b16["in_bytes"] + b16[out_bytes], "bf16")
        return {
            "max_abs_err": errs[torch.float32][key], "ms": f32[t],
            "plain_ms": f32["plain"], "library_ms": f32["sdpa_bwd"] if lib
            else None,
            **bound(n_ops * pairs_d, f32["in_bytes"] + f32[out_bytes], "f32"),
            "body": k2.fused_instance(torch.float32, 16, 1, 1, 0.1).body
            if key == "fused" else
            k2.backward_instance(torch.float32, 16, 1, 1, 0.1).body,
            "max_abs_err_bf16": errs[torch.bfloat16][key], "ms_bf16": b16[t],
            "body_bf16": k2.fused_instance(torch.bfloat16, 16, 1, 1, 0.1).body
            if key == "fused" else
            k2.backward_instance(torch.bfloat16, 16, 1, 1, 0.1).body,
            "earlier_ms_bf16": b16.get(t + "_earlier", b16[t]),
            "plain_ms_bf16": b16["plain"],
            "library_ms_bf16": b16["sdpa_bwd"] if lib else None,
            "bound_ms_bf16": bd["bound_ms"], "bound_by_bf16": bd["bound_by"],
            # flash_attention_bwd with this kernel's variant at B 8, d 32
            "variant_ms_d32": d32[torch.float32][d32_key],
            "variant_ms_bf16_d32": d32[torch.bfloat16][d32_key],
            "library_ms_bf16_d32": d32[torch.bfloat16]["sdpa"]}
    for t in (f32, b16):
        t["all_bytes"] = t["dq_bytes"] + t["dkv_bytes"]
    return {
        "flash_attention_bwd_fused": entry("fused", "fused", 10, "all_bytes",
                                           True, "fused"),
        "flash_attention_bwd_dq": entry("dq", "dq", 6, "dq_bytes", False,
                                        "split"),
        "flash_attention_bwd_dkv": entry("dkv", "dkv", 8, "dkv_bytes", False,
                                         "split"),
    }


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


def grad_step(torch, dev: str):
    """Phase 9's train step: a 64 px config (N = 4096 > 1024 runs K2, d 8,
    forward and backward), batch 2, dropout 0, one fixed eps, from seed 7,
    in full f32 on `dev`. Returns (gradients by "vae." / "teacher." name,
    the teacher's BatchNorm running statistics, the metrics, the names of
    the gradients held to BN_SHARE)."""
    import dataclasses
    from torch import nn
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import full_f32
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step

    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=32,
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
    # The teacher's conv -> [LeakyReLU ->] BatchNorm blocks: every
    # Sequential that ends in a BatchNorm (extractor, expert convs,
    # shortcuts).
    before_bn = {f"teacher.{name}.{p}"
                 for name, mod in st.teacher.named_modules()
                 if isinstance(mod, nn.Sequential) and len(mod)
                 and isinstance(mod[-1], nn.BatchNorm2d)
                 for p, _ in mod.named_parameters()}
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


def grad_ratios(g_ref: dict, g_new: dict, before_bn) -> dict:
    """Each gradient's max abs difference over its bar (above 1: fails)."""
    out = {}
    for model in ("vae.", "teacher."):
        top = max(g.abs().max().item() for k, g in g_ref.items()
                  if k.startswith(model))
        for k, g in g_ref.items():
            if k.startswith(model):
                share = BN_SHARE if k in before_bn else GRAD_SHARE
                tol = share * g.abs().max().item() + 1e-5 * top
                out[k] = (g_new[k] - g).abs().max().item() / tol
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


def spread_grads(torch, runs: int) -> int:
    """`--grads N`: phase 9's comparison N times with the kernels and N
    times with their plain versions on the card, against one CPU step,
    holding more memory before each run so that the allocator hands the
    step other addresses. Prints each reading in units of 1e-3 of each
    tensor's largest, the worst of the tensors phase 9 holds to 1e-3 and of
    those it holds to BN_SHARE apart; fails on none."""
    from lunaris_orion_tpu_torch.ops.cuda import _build
    _build.library()
    g_cpu, _, _, before_bn = grad_step(torch, "cpu")
    held = []
    for run in range(runs):
        for plain in (False, True):
            restore = plain_on_card() if plain else (lambda: None)
            try:
                ratios = grad_ratios(g_cpu, grad_step(torch, "cuda")[0], ())
            finally:
                restore()
            worst = [max((r, k) for k, r in ratios.items()
                         if (k in before_bn) == bn) for bn in (False, True)]
            log(f"[grads] run {run} with the "
                f"{'plain versions' if plain else 'kernels'} on the card: "
                f"worst held to 1e-3 {worst[0][0]:.3f} ({worst[0][1]}), "
                f"worst before a BatchNorm {worst[1][0]:.3f} ({worst[1][1]})")
            held.append(torch.empty(2**18 * (2 * run + plain + 1) + 1024,
                                    device="cuda"))
    return 0


def run_grad_context(torch) -> None:
    (g_cpu, s_cpu, m_cpu, before_bn), (g_gpu, s_gpu, m_gpu, _) = (
        grad_step(torch, dev) for dev in ("cpu", "cuda"))
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
    log(f"[grads] 64 px train_step, TF32 off, card vs CPU: {len(g_cpu)} "
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
                (k3, "launches")]
    for mod, name in counters:
        setattr(mod, name, 0)
    bare = {}                           # remat -> the default bf16 step
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
            (state, m), dt, k1_kernels, dev_ms = device_share(
                torch, lambda: step(state, images), tag, smi)
            check_k1_kernels(k1_kernels, k1.launches - seen[0], tag)
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
            f" on {smi}; launches (K1, K2 fwd, K2 bwd fused, dq, dk/dv, K3) "
            f"{[getattr(mod, name) - was for (mod, name), was in zip(counters, seen)]}")
    after = [p.detach() for p in
             (*state.vae.parameters(), *state.teacher.parameters())]
    moved = [not torch.equal(a, b) for a, b in zip(before, after)]
    if not (any(moved[:n_vae]) and any(moved[n_vae:])):
        raise AssertionError("train: a model's parameters did not change")
    launches = {"gn_mish": k1.launches, "flash_attention_fwd": k2.launches,
                "flash_attention_bwd_fused": k2.bwd_fused_launches,
                "flash_attention_bwd_dq": k2.bwd_dq_launches,
                "flash_attention_bwd_dkv": k2.bwd_dkv_launches,
                "mse_kl": k3.launches}
    log(f"[train] {sum(moved)}/{len(moved)} parameter tensors changed; "
        f"kernel launches in the train steps: {launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
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
            # f32 (CUDA cores): 16384 terms summed in another order, 2e-5 of
            # the largest magnitude. bf16 (tensor cores): the forward's bar,
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
        fo, flse = k2.flash_attention(q, k, v, bias)
        if not (torch.equal(o, fo) and torch.equal(lse, flse)):
            raise AssertionError(f"K2 stage sum is not the forward kernel at "
                                 f"dropout 0 ({dt})")
        log(f"[stages] B{b} H8 N16384 d16 {str(dt)[6:]}: " + ", ".join(line)
            + "; sum bit-equal to flash_attention at dropout 0")
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


# --- phase 16: windowed attention, the evaluator, the training options -------

WINDOW = 256                    # the recommended recipe's (BASELINE.md r5)


def check_window(torch, dev, smi) -> dict:
    """Phase 16 (a): K2 over the windows folded into the head axis
    (`local_window_attention`) at B16 H8 N16384 W256 d16, f32 and bf16:
    forward at dropout 0 and 0.1 and the default backward at 0.1 against
    the plain versions on the folded shape, at phase 4's and phase 7's
    bars; a call in batch chunks bit-equal to one call; times beside the
    global K2 at B16, the plain version, the library call on the folded
    shape and the bound."""
    from lunaris_orion_tpu_torch.ops.attention import local_window_attention
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
    b, h, n, w, d = 16, 8, 16384, WINDOW, 16
    rows = h * n // w
    fold = lambda t: t.reshape(b, rows, w, d)
    g = torch.Generator(device=dev).manual_seed(16)
    out = {"fwd": {}}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        sfx = "" if dt == torch.float32 else "_bf16"
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
                   for _ in range(3))
        bias = 0.5 * torch.randn(h, n, generator=g, device=dev)
        bias_w = bias.reshape(rows, w)
        inst = k2.forward_instance(dt, d, w, w, 0.1)
        errs = []
        for rate in (0.0, 0.1):
            kw = dict(dropout_rate=rate, seed=-1234567)
            tag = f"window {w} B{b} H{h} N{n} d{d} {name} dropout {rate}"
            o = local_window_attention(q, k, v, bias, window=w, **kw)
            ro, rlse = k2.attention_plain(fold(q), fold(k), fold(v), bias_w,
                                          **kw)
            torch.cuda.synchronize()
            err = (o.float() - ro.float().reshape(o.shape)).abs().max().item()
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
            log(f"[window] {tag}: max_abs_err {err:.3e} ({note})")
            if not ok:
                raise AssertionError(f"windowed K2 disagrees with its plain "
                                     f"version at {tag}")
            errs.append(err)
        # The default backward at dropout 0.1 through autograd.
        variant = k2.default_bwd(dt, d)
        body = (k2.fused_instance(dt, d, w, w, 0.1) if variant == "fused"
                else k2.backward_instance(dt, d, w, w, 0.1)).body
        leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
        do = torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
        local_window_attention(*leaves, window=w, **kw).backward(do)
        # The plain backward from the kernel's own o and lse, which the
        # autograd backward takes (a bf16 o that differs from the plain
        # forward's in its last bit moves delta, so a whole row's ds).
        ko, klse = k2.flash_attention(fold(q), fold(k), fold(v), bias_w, **kw)
        ref = k2.attention_bwd_plain(fold(q), fold(k), fold(v), bias_w, ko,
                                     klse, fold(do), **kw)
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
        log(f"[window] backward {variant} ({body}) {name} dropout 0.1: "
            + ", ".join(line))
        del leaves, ref, ro, rlse, ko, klse
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
        # global K2 forward at B16, the plain version and the library call
        # on the folded shape.
        kw = dict(dropout_rate=0.0, seed=0)
        t_w = time_ms(torch, lambda: local_window_attention(
            q, k, v, bias, window=w, **kw), 10)
        t_g = time_ms(torch, lambda: k2.flash_attention(q, k, v, bias, **kw),
                      3)
        t_p = time_ms(torch, lambda: k2.attention_plain(
            fold(q), fold(k), fold(v), bias_w, **kw), 3)
        lib, lib_note = sdpa_ms(fold(q), fold(k), fold(v), bias_w, reps=5)
        o, lse = k2.flash_attention(fold(q), fold(k), fold(v), bias_w, **kw)
        do = torch.randn_like(o)
        t_b = time_ms(torch, lambda: k2.flash_attention_bwd(
            fold(q), fold(k), fold(v), bias_w, o, lse, do, dropout_rate=0.1,
            seed=5), 5)
        t_pb = time_ms(torch, lambda: k2.attention_bwd_plain(
            fold(q), fold(k), fold(v), bias_w, o, lse, do, dropout_rate=0.1,
            seed=5), 2)
        lib_b, _ = sdpa_ms(fold(q), fold(k), fold(v), bias_w, backward=True,
                           dropout_p=0.1, reps=3)
        kind = "f32" if dt == torch.float32 else "bf16"
        scores_d = b * h * n * w * d
        bd = bound(4 * scores_d, nbytes(q, k, v, bias, o, lse), kind)
        # Per (q, k) pair and head-dim element, 2 operations each for the
        # scores, dp, dv, dk and dq products (split: the scores and dp twice).
        bwd_ops = {"fused": 10, "split": 14}[variant]
        bdb = bound(bwd_ops * scores_d, nbytes(q, k, v, bias, do, lse, o)
                    + nbytes(q, k, v, bias), kind)
        log(f"[window] {name}: windowed forward {t_w:.3f} ms "
            f"({b * h * n * w / t_w / 1e9:.2f} G scores/ms), global K2 at "
            f"B{b} {t_g:.3f} ms ({t_g / t_w:.1f}x), plain {t_p:.3f} ms, "
            f"F.scaled_dot_product_attention on the folded shape {lib} ms "
            f"({lib_note}), bound {bd['bound_ms']:.4f} ms by {bd['bound_by']}"
            f"; backward {variant} dropout 0.1 {t_b:.3f} ms (plain {t_pb:.3f},"
            f" library {lib_b}, bound {bdb['bound_ms']:.4f} by "
            f"{bdb['bound_by']}) on {smi}")
        out["fwd"] |= {
            "window_ms" + sfx: t_w, "window_global_ms" + sfx: t_g,
            "window_plain_ms" + sfx: t_p, "window_library_ms" + sfx: lib,
            "window_bound_ms" + sfx: bd["bound_ms"],
            "window_bound_by" + sfx: bd["bound_by"],
            "window_max_abs_err" + sfx: max(errs[:2])}
        out["bwd" + (sfx or "_f32")] = {
            "window_variant": variant, "window_ms": t_b,
            "window_plain_ms": t_pb, "window_library_ms": lib_b,
            "window_bound_ms": bdb["bound_ms"],
            "window_bound_by": bdb["bound_by"],
            "window_max_abs_err": max(errs[2:])}
        del q, k, v, o, lse, do
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
            seen = k2.launches
            ev.score_batch(batch)
            per_batch = k2.launches - seen
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
                   ("mse_kl", "k3", "launches"))


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
    (_, m), host_s, k1_kernels, dev_ms = device_share(
        torch, lambda: step(state, batch), tag, smi)
    launches = _counts(mods)
    check_k1_kernels(k1_kernels, launches["gn_mish"], tag)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = probe(torch)
    if sys.argv[1:2] == ["--grads"]:
        return spread_grads(torch, int(sys.argv[2]))
    if sys.argv[1:2] == ["--profiler-loss"]:
        return profiler_loss(torch, int(sys.argv[2]), smi)
    if sys.argv[1:2] == ["--k5-f32"]:
        for _ in range(int(sys.argv[2])):
            log(f"[K5] f32 [32, 128, 128, 64] -> 64: "
                f"{time_k5_f32(torch, dev):.3f} ms on {smi}")
        return 0
    t_start = time.perf_counter()
    build()
    k1 = check_k1(torch, dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], check_k1_train(torch, dev))
    k2 = check_k2(torch, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(torch, Path(tmp), smi)
        for feature_dim in (64, 256):
            run_context(torch, Path(tmp), feature_dim)
    bwd = check_k2_bwd(torch, dev, smi)
    k3 = check_k3(torch, dev, smi)
    run_grad_context(torch)
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as m2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as m1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as m3
    train, bare = run_train(torch, smi, m1, m2, m3)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = run_trainer(torch, Path(tmp), smi, bare)
    k5 = check_k5(torch, dev, smi)
    stages = check_stages(torch, dev, smi)
    lane, pass1 = check_lane_sums(torch, dev, smi)
    tools = run_tools(torch)
    mods = {"k1": m1, "k2": m2, "k3": m3}
    t16 = time.perf_counter()
    window = check_window(torch, dev, smi)
    with tempfile.TemporaryDirectory() as tmp:
        evaluate = run_evaluate(torch, Path(tmp), smi)
        wstep = run_window_train(torch, smi, mods)
        wtrainer = run_window_trainer(torch, Path(tmp), smi, mods)
    log(f"[window] phase 16 in {time.perf_counter() - t16:.0f} s")
    # Phase 16's paths: W = one windowed bf16 train step, E = one windowed
    # bf16 evaluate batch of 16, trainer_launches_window = 16 (d)'s run.
    w16 = lambda key: {"launches_window_step": wstep["launches"][key],
                       "trainer_launches_window": wtrainer["launches"][key]}
    src = "lunaris_orion_tpu_torch/csrc/"
    fa = "lunaris_orion_tpu/ops/pallas/flash_attention.py"
    kernels = [
        dict(name="gn_mish", route="cuda", source=src + "gn_mish.cu",
             replaces="lunaris_orion_tpu/ops/pallas/gn_mish.py:55",
             launches=launches["gn_mish"],
             trainer_launches=trainer["gn_mish"], **w16("gn_mish"), **k1,
             **pass1),
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cuh", replaces=f"{fa}:335",
             launches=launches["flash_attention_fwd"],
             trainer_launches=trainer["flash_attention_fwd"],
             launches_evaluate=evaluate["evaluate_window_bf16_launches"],
             **w16("flash_attention_fwd"), **k2, **window["fwd"]),
        dict(name="flash_attention_bwd_fused", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:574",
             launches=train["flash_attention_bwd_fused"],
             trainer_launches=trainer["flash_attention_bwd_fused"],
             **w16("flash_attention_bwd_fused"),
             **bwd["flash_attention_bwd_fused"],
             **{k + "_bf16": v for k, v in window["bwd_bf16"].items()}),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:474",
             launches=train["flash_attention_bwd_dq"],
             **w16("flash_attention_bwd_dq"), **bwd["flash_attention_bwd_dq"],
             **{"split_" + k: v for k, v in window["bwd_f32"].items()}),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source=src + "flash_attention_bwd.cuh", replaces=f"{fa}:514",
             launches=train["flash_attention_bwd_dkv"],
             **w16("flash_attention_bwd_dkv"),
             **bwd["flash_attention_bwd_dkv"],
             **{"split_" + k: v for k, v in window["bwd_f32"].items()}),
        dict(name="mse_kl", route="cuda", source=src + "loss_epilogue.cu",
             replaces="lunaris_orion_tpu/ops/pallas/loss_epilogue.py:22",
             launches=train["mse_kl"], trainer_launches=trainer["mse_kl"],
             **w16("mse_kl"), **k3),
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
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
