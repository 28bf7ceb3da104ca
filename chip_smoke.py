#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lunaris_orion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which raises on failure (exit code 1):
  1. probe    torch / CUDA versions, the card, nvidia-smi, nvcc, triton;
  2. build    compile the hand-written kernels from csrc/ with nvcc;
  3. K1       GroupNorm+Mish kernel against its plain version at the four
              decoder shapes, batch 8, f32 and bf16, and on the inputs of
              the 16 sites of a batch-16 VAE training forward (the train
              step's own), f32 and bf16;
  4. K2       flash-attention forward kernel against its plain version at
              the teacher's shape (B 8, H 8, N 16384, d 16) with dropout 0
              and 0.1, f32 and bf16, at the train step's B 16 with dropout
              0.1, and at d 8/48/64 and a ragged N;
  5. slice    `lunaris_orion_tpu_torch.cli.generate` at the full default
              width (128 px, 4 experts x 3 blocks, N = 16384) from a seeded
              random checkpoint, f32 and --bf16; both kernels' launch
              counts must be above 0; decode+score sprites/s;
  6. context  a 64 px config (N = 4096) through the port on the CPU (plain
              versions) and on the card (kernels) from one checkpoint and
              one z, TF32 off: decode within 1/255, quality within 1e-3;
  7. K2 bwd   both backward variants (fused; split = dk/dv + dq kernels)
              against the plain backward at B 2, H 8, N 16384, d 16,
              dropout 0 and 0.1, f32 and bf16, at d 8/48/64, with a q
              shard at q_offset, and at the teacher's training shape (B 16,
              H 8, N 16384, d 16, dropout 0.1), f32 and bf16, where it also
              times both and the plain version;
  8. K3       the MSE+KL kernel against its plain version at
              [16, 128, 128, 3], L = 256, f32 and bf16;
  9. grads    one `train_step` of a 64 px config (N = 4096) on the CPU
              (plain versions) and on the card (kernels) from one state,
              one batch and one eps, dropout 0, TF32 off: gradients,
              BatchNorm statistics and metrics agree, and every parameter
              that the losses reach gets a non-zero gradient on the card;
 10. train    `make_train_step` at the full default width (128 px, latent
              256, feature 128, 8 heads, 4 experts x 3 blocks, batch 16,
              accumulation 2, remat), seeded random init: 1 bf16 step with
              the non-default K2 backward, then 1 f32 and 1 bf16 step with
              the default; losses finite, both models' parameters changed,
              every kernel of the path launched; step time and sprites/s;
 11. K5       the GN-apply+Mish+conv3x3 kernel against its plain version at
              [2,32,32,64]->64, [2,64,64,32]->32, [2,32,32,128]->64 (f32)
              and [8,128,128,64]->64 (f32 and bf16), then K5 and K1 at the
              tool's [128,128,128,64]->64 bf16, with times: K5, K1 +
              F.conv2d, plain;
 12. stages   each of the five K2 stage kernels against its plain version
              at B 2 and the tool's B 8, H 8, N 16384, d 16, f32 and bf16;
              "sum" bit-equal to the forward kernel at dropout 0; times at
              B 8 bf16;
 13. stats    the per-tile lane-sums kernel, and K1's pass 1 alone, against
              their plain versions at [128,128,128,32], [128,128,128,64],
              [128,64,64,128], bf16 and f32, tiles of 512 and 2048 rows;
              times;
 14. tools    `tools.attn_roofline`, `tools.gn_stats` and
              `tools.fusion_overlap` at their full default shapes; every
              kernel they reach launched.

Kernel times are medians of CUDA-event timings. Each kernel's `bound_ms` is
the larger of its bytes (inputs read once, outputs written once) over
3.35 TB/s and its operations over the peak of its input type (989 TFLOP/s
bf16, 67 TFLOP/s f32 outside the tensor cores), at the shape its `ms` was
taken at; `library_ms` is one PyTorch call computing the same function
(`F.scaled_dot_product_attention` for K2), timed here and used nowhere in
the port. The last lines are the card's name and power limit, a JSON object
with the kernels' measurements and, last, the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
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
    _build.library()
    log(f"[build] {_build.build_dir()} in {time.perf_counter() - t0:.1f} s")
    for line in (_build.build_dir() / "build.log").read_text().splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line or line.startswith("nvcc seconds")):
            log("[build]   " + line.strip())


def check_k1(torch, dev) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    g = torch.Generator(device=dev).manual_seed(0)
    worst, ms, plain_ms, moved, ops = 0.0, 0.0, 0.0, 0, 0
    for shape in ((8, 16, 16, 256), (8, 32, 32, 128), (8, 64, 64, 64),
                  (8, 128, 128, 32)):
        c = shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
        # x read once, y written once; per element 3 for the moments, 2 for
        # the affine and about 20 for mish's exp, log1p and tanh.
        moved += 2 * nbytes(x32)
        ops += 25 * x32.numel()
        w = 1 + 0.1 * torch.randn(c, generator=g, device=dev)
        b = 0.1 * torch.randn(c, generator=g, device=dev)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            got, ref = k1.gn_mish(x, w, b), k1.gn_mish_plain(x, w, b)
            torch.cuda.synchronize()
            err = (got.float() - ref.float()).abs()
            if dt == torch.float32:
                ok = err.max().item() <= 1e-5
                worst = max(worst, err.max().item())
            else:
                ok = bool((err <= 2 * bf16_ulp(torch, ref) + 1e-6).all())
            t_k = time_ms(torch, lambda: k1.gn_mish(x, w, b), 20)
            t_p = time_ms(torch, lambda: k1.gn_mish_plain(x, w, b), 20)
            if dt == torch.float32:
                ms, plain_ms = ms + t_k, plain_ms + t_p
            log(f"[K1] {shape} {str(dt)[6:]}: max_abs_err "
                f"{err.max().item():.3e} kernel {t_k:.4f} ms plain "
                f"{t_p:.4f} ms")
            if not ok:
                raise AssertionError(f"K1 disagrees with its plain version "
                                     f"at {shape} {dt}")
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, **bound(ops, moved, "f32")}


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
        err = (got.float() - ref.float()).abs()
        if x.dtype == torch.float32:
            ok = err.max().item() <= 1e-5
            worst = max(worst, err.max().item())
        else:
            ok = bool((err <= 2 * bf16_ulp(torch, ref) + 1e-6).all())
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


def check_k2(torch, dev) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    cases = [(8, 8, 16384, 16, dt, rate) for dt in (torch.float32,
                                                     torch.bfloat16)
             for rate in (0.0, 0.1)]
    # The train step's shape: B 16 (the batch), dropout 0.1.
    cases += [(16, 8, 16384, 16, dt, 0.1) for dt in (torch.float32,
                                                     torch.bfloat16)]
    cases += [(8, 8, 4096, d, torch.float32, 0.1) for d in (8, 48, 64)]
    cases += [(8, 8, 4096, 64, torch.bfloat16, 0.0),
              (4, 8, 2000, 16, torch.float32, 0.1)]
    for b, h, n, d, dt, rate in cases:
        q, k, v = (torch.randn(b, h, n, d, generator=g, device=dev).to(dt)
                   for _ in range(3))
        bias = 0.5 * torch.randn(h, n, generator=g, device=dev)
        kw = dict(dropout_rate=rate, seed=-1234567)
        o, lse = k2.flash_attention(q, k, v, bias, **kw)
        ro, rlse = k2.attention_plain(q, k, v, bias, **kw)
        torch.cuda.synchronize()
        err = (o.float() - ro.float()).abs().max().item()
        lse_err = (lse - rlse).abs().max().item()
        scale = ro.float().abs().max().item()
        tol = 1e-5 if dt == torch.float32 else 2 * 2.0 ** -7 * scale
        big = n == 16384
        t_k = time_ms(torch, lambda: k2.flash_attention(q, k, v, bias, **kw),
                      5 if big else 10)
        t_p = time_ms(torch, lambda: k2.attention_plain(q, k, v, bias, **kw),
                      3 if big else 5)
        flops = 4 * b * h * n * n * d
        log(f"[K2] B{b} H{h} N{n} d{d} {str(dt)[6:]} dropout {rate}: "
            f"max_abs_err {err:.3e} (tol {tol:.1e}) lse_err {lse_err:.1e} "
            f"kernel {t_k:.3f} ms ({flops / t_k / 1e9:.2f} TFLOP/s) plain "
            f"{t_p:.3f} ms")
        if err > tol or lse_err > 1e-4:
            raise AssertionError(f"K2 disagrees with its plain version at "
                                 f"B{b} H{h} N{n} d{d} {dt} dropout {rate}")
        if big and b == 8 and rate == 0.0:
            from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
            lib, note = sdpa_ms(q, k, v, bias, reps=3)
            log(f"[K2] B{b} H{h} N{n} d{d} {str(dt)[6:]}: "
                f"F.scaled_dot_product_attention {lib} ms ({note})")
            if dt == torch.float32:
                out = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                       "library_ms": lib,
                       **bound(flops, nbytes(q, k, v, bias, o, lse), "f32")}
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
    return launches


def run_context(torch, tmp: Path) -> None:
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator, full_f32

    # 64 px, 2 experts, feature_dim 64 (head_dim 8): N = 4096 > 1024 runs K2.
    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=64,
                      embedding_dim=32, num_experts=2)
    ckpt = tmp / "ctx.pt"
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
    log(f"[context] 64 px, TF32 off, CPU plain vs card kernels: decode max "
        f"diff {d_img:.3e} (bar {1 / 255:.3e}), quality max diff "
        f"{d_q:.3e} (bar 1e-3)")
    if d_img > 1 / 255 or d_q > 1e-3:
        raise AssertionError("kernels in context disagree with the CPU run")


BWD_ERR = ("dq", "dk", "dv", "dbias")


def bwd_tol(torch, ref, dtype, name) -> float:
    """f32: 1e-4 of the largest magnitude (sums of up to N terms in other
    orders, the fused dq's atomics in any order); bf16: 2 bf16 ulps there
    (ds and p are rounded per term); dbias is f32 in both."""
    scale = ref.float().abs().max().item()
    if dtype == torch.float32 or name == "dbias":
        return 1e-4 * scale + 1e-6
    return 2 * 2.0 ** -7 * scale


def check_k2_bwd(torch, dev, smi) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    g = torch.Generator(device=dev).manual_seed(3)
    errs = {"fused": 0.0, "dkv": 0.0, "dq": 0.0}

    def inputs(b, h, nq, nk, d, dt, rate, q_offset=0):
        q = torch.randn(b, h, nq, d, generator=g, device=dev).to(dt)
        k, v = (torch.randn(b, h, nk, d, generator=g, device=dev).to(dt)
                for _ in range(2))
        bias = 0.5 * torch.randn(h, nk, generator=g, device=dev)
        do = torch.randn(b, h, nq, d, generator=g, device=dev).to(dt)
        kw = dict(dropout_rate=rate, seed=-1234567, q_offset=q_offset)
        o, lse = k2.attention_plain(q, k, v, bias, **kw)
        return (q, k, v, bias, o, lse, do), kw

    cases = [(2, 8, 16384, 16, dt, rate) for dt in (torch.float32,
                                                    torch.bfloat16)
             for rate in (0.0, 0.1)]
    cases += [(2, 8, 4096, d, torch.float32, 0.1) for d in (8, 48, 64)]
    cases += [(2, 8, 4096, 64, torch.bfloat16, 0.1)]
    for b, h, n, d, dt, rate in cases:
        args, kw = inputs(b, h, n, n, d, dt, rate)
        ref = k2.attention_bwd_plain(*args, **kw)
        line = []
        for variant in k2.BWD_VARIANTS:
            got = k2.flash_attention_bwd(*args, variant=variant, **kw)
            torch.cuda.synchronize()
            for name, a, r in zip(BWD_ERR, got, ref):
                err = (a.float() - r.float()).abs().max().item()
                tol = bwd_tol(torch, r, dt, name)
                line.append(f"{variant}.{name} {err:.2e}/{tol:.1e}")
                if err > tol:
                    raise AssertionError(
                        f"K2 bwd {variant} {name} disagrees with the plain "
                        f"version at B{b} N{n} d{d} {dt} dropout {rate}: "
                        f"{err:.3e} > {tol:.3e}")
                if dt == torch.float32 and n == 16384 and rate == 0.0:
                    key = ("fused" if variant == "fused" else
                           "dq" if name == "dq" else "dkv")
                    errs[key] = max(errs[key], err)
        log(f"[K2 bwd] B{b} H{h} N{n} d{d} {str(dt)[6:]} dropout {rate}: "
            + ", ".join(line))

    # A q shard at q_offset (the context-parallel call): its dq rows are the
    # full call's, with the same dropout masks.
    args, kw = inputs(2, 8, 4096, 4096, 16, torch.float32, 0.1)
    q, k, v, bias, o, lse, do = args
    sl = slice(2048, None)
    for variant in k2.BWD_VARIANTS:
        full = k2.flash_attention_bwd(*args, variant=variant, **kw)
        qs, dos = q[:, :, sl].contiguous(), do[:, :, sl].contiguous()
        os_, lses = k2.attention_plain(qs, k, v, bias, dropout_rate=0.1,
                                       seed=-1234567, q_offset=2048)
        shard = k2.flash_attention_bwd(qs, k, v, bias, os_, lses, dos,
                                       variant=variant, dropout_rate=0.1,
                                       seed=-1234567, q_offset=2048)
        err = (shard[0] - full[0][:, :, sl]).abs().max().item()
        tol = bwd_tol(torch, full[0], torch.float32, "dq")
        log(f"[K2 bwd] q shard at q_offset 2048, {variant}: dq rows "
            f"max_abs_err {err:.2e} (tol {tol:.1e})")
        if err > tol:
            raise AssertionError(f"K2 bwd {variant}: q_offset shard differs")

    # The teacher's training shape (B 16, dropout 0.1): both variants
    # against the plain backward, then times, each kernel alone as well.
    times = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = inputs(16, 8, 16384, 16384, 16, dt, 0.1)
        q, k, v, bias, o, lse, do = args
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        ref = k2.attention_bwd_plain(*args, **kw)
        end.record()
        end.synchronize()
        t = {"plain": start.elapsed_time(end)}
        line = []
        for variant in k2.BWD_VARIANTS:
            got = k2.flash_attention_bwd(*args, variant=variant, **kw)
            torch.cuda.synchronize()
            for name, a, r in zip(BWD_ERR, got, ref):
                err = (a.float() - r.float()).abs().max().item()
                tol = bwd_tol(torch, r, dt, name)
                line.append(f"{variant}.{name} {err:.2e}/{tol:.1e}")
                if err > tol:
                    raise AssertionError(
                        f"K2 bwd {variant} {name} disagrees with the plain "
                        f"version at B16 N16384 d16 {dt} dropout 0.1: "
                        f"{err:.3e} > {tol:.3e}")
                if dt == torch.float32:
                    key = ("fused" if variant == "fused" else
                           "dq" if name == "dq" else "dkv")
                    errs[key] = max(errs[key], err)
            del got
        log(f"[K2 bwd] B16 H8 N16384 d16 {str(dt)[6:]} dropout 0.1: "
            + ", ".join(line))
        del ref
        delta = (o.float() * do.float()).sum(-1)
        out = dict(dk=torch.empty_like(k), dv=torch.empty_like(v),
                   dbias_bh=torch.empty(128, 16384, device=dev),
                   dq_acc=torch.zeros(16, 8, 16384, 16, device=dev))
        dq = torch.empty_like(q)
        t |= {
            "fused": time_ms(torch, lambda: k2.flash_attention_bwd(
                *args, variant="fused", **kw), 3),
            "split": time_ms(torch, lambda: k2.flash_attention_bwd(
                *args, variant="split", **kw), 3),
            "dkv": time_ms(torch, lambda: k2.launch_bwd_kernel(
                k2.DKV, q, k, v, bias, do, lse, delta, **out, **kw), 3),
            "dq": time_ms(torch, lambda: k2.launch_bwd_kernel(
                k2.DQ, q, k, v, bias, do, lse, delta, dq=dq, **kw), 3),
        }
        t |= {"in_bytes": nbytes(q, k, v, bias, do, lse, delta),
              "dq_bytes": nbytes(dq),
              "dkv_bytes": nbytes(out["dk"], out["dv"], out["dbias_bh"])}
        del out, dq, delta
        from lunaris_orion_tpu_torch.tools.attn_roofline import sdpa_ms
        t["sdpa_bwd"], note = sdpa_ms(q, k, v, bias, backward=True,
                                      dropout_p=0.1, reps=3)
        times[dt] = t
        log(f"[K2 bwd] B16 H8 N16384 d16 {str(dt)[6:]} dropout 0.1: fused "
            f"{t['fused']:.1f} ms, split {t['split']:.1f} ms (dk/dv "
            f"{t['dkv']:.1f} + dq {t['dq']:.1f}), plain {t['plain']:.1f} ms, "
            f"backward of F.scaled_dot_product_attention {t['sdpa_bwd']} ms "
            f"({note}) on {smi}")
    f32 = times[torch.float32]
    faster = min(("fused", "split"), key=lambda v: sum(
        times[dt][v] for dt in times))
    log(f"[K2 bwd] faster at the teacher's shape (f32 + bf16): {faster}; "
        f"the default is {k2.DEFAULT_BWD}")
    # Bounds at the f32 timing shape. Per (q, k) pair and head-dim element:
    # 2 operations each for the scores, dp, dv, dk and dq products.
    pairs_d = 16 * 8 * 16384 * 16384 * 16
    entry = lambda key, t, n_ops, out_bytes, lib: {
        "max_abs_err": errs[key], "ms": f32[t], "plain_ms": f32["plain"],
        "library_ms": lib,
        **bound(n_ops * pairs_d, f32["in_bytes"] + out_bytes, "f32")}
    return {
        "flash_attention_bwd_fused": entry(
            "fused", "fused", 10, f32["dq_bytes"] + f32["dkv_bytes"],
            f32["sdpa_bwd"]),
        "flash_attention_bwd_dq": entry("dq", "dq", 6, f32["dq_bytes"], None),
        "flash_attention_bwd_dkv": entry("dkv", "dkv", 8, f32["dkv_bytes"],
                                         None),
    }


def check_k3(torch, dev) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as k3
    g = torch.Generator(device=dev).manual_seed(4)
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
        t_k = time_ms(torch, lambda: k3.mse_kl(*args), 20)
        t_p = time_ms(torch, lambda: k3.mse_kl_plain(*args), 20)
        log(f"[K3] [16, 128, 128, 3] L 256 {str(dt)[6:]}: max_abs_err "
            f"{err:.2e} (rel {rel:.1e}, tol rel 1e-5) kernel {t_k:.4f} ms "
            f"plain {t_p:.4f} ms")
        if rel > 1e-5:
            raise AssertionError(f"K3 disagrees with its plain version {dt}")
        if dt == torch.float32:
            # Four reads; a subtract, a square and an add per pixel value.
            out = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p,
                   "library_ms": None,
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


def run_grad_context(torch) -> None:
    import dataclasses
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import full_f32
    from lunaris_orion_tpu_torch.train.state import create_state
    from lunaris_orion_tpu_torch.train.step import make_train_step

    # 64 px: N = 4096 > 1024 runs K2 (d = 8), forward and backward.
    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=32,
                      embedding_dim=32, num_experts=2, batch_size=2,
                      gradient_accumulation_steps=1)
    tcfg = dataclasses.replace(cfg.teacher_config(), num_heads=4,
                               expert_layers=2, dropout_rate=0.0)
    images = torch.randint(0, 256, (1, 2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5))
    restore = fixed_eps(torch.randn(2, 64, generator=torch.Generator()
                                    .manual_seed(6)))
    res = {}
    try:
        with full_f32():
            for dev in ("cpu", "cuda"):
                st = create_state(cfg, dev, 7, tcfg=tcfg)
                st, m = make_train_step(cfg)(st, images.to(dev))
                res[dev] = (
                    {f"vae.{k}": p.grad.cpu() for k, p in st.vae.named_parameters()}
                    | {f"teacher.{k}": p.grad.cpu()
                       for k, p in st.teacher.named_parameters()},
                    {k: v.cpu() for k, v in st.teacher.state_dict().items()
                     if "running" in k},
                    {k: float(v) for k, v in m.items()})
    finally:
        restore()
    (g_cpu, s_cpu, m_cpu), (g_gpu, s_gpu, m_gpu) = res["cpu"], res["cuda"]
    worst, unreached, silent = 0.0, [], []
    for model in ("vae.", "teacher."):
        top = max(g.abs().max().item() for k, g in g_cpu.items()
                  if k.startswith(model))
        for k, g in g_cpu.items():
            if not k.startswith(model):
                continue
            # 1e-3 of the tensor's largest gradient, plus 1e-5 of the
            # model's: gradients that are zero in exact arithmetic (a bias
            # cancelled by a following normalization) are rounding noise.
            tol = 1e-3 * g.abs().max().item() + 1e-5 * top
            err = (g_gpu[k] - g).abs().max().item()
            worst = max(worst, err / tol)
            if err > tol:
                raise AssertionError(f"grads: {k} card vs CPU {err:.3e} > "
                                     f"{tol:.3e}")
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
        f"gradients within bar (worst {worst:.3f} of the bar), "
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
    other = next(v for v in k2.BWD_VARIANTS if v != k2.DEFAULT_BWD)
    runs = [(True, other), (False, None), (True, None)]   # the first is cold
    counters = [(k1, "launches"), (k2, "launches"), (k2, "bwd_fused_launches"),
                (k2, "bwd_dq_launches"), (k2, "bwd_dkv_launches"),
                (k3, "launches")]
    for mod, name in counters:
        setattr(mod, name, 0)
    for bf16, bwd in runs:
        seen = [getattr(mod, name) for mod, name in counters]
        step = make_train_step(cfg.replace(mixed_precision=bf16),
                               attn_bwd=bwd)
        images = torch.randint(0, 256, (cfg.gradient_accumulation_steps,
                                        cfg.batch_size, 128, 128, 3),
                               dtype=torch.uint8, device="cuda", generator=g)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step(state, images)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        losses = {k: float(v) for k, v in m.items()}
        if not all(map(math.isfinite, losses.values())):
            raise AssertionError(f"train step: non-finite metrics {losses}")
        n = images.shape[0] * images.shape[1]
        log(f"[train] step {state.step} {'bf16' if bf16 else 'f32'} K2 bwd "
            f"{bwd or k2.DEFAULT_BWD}: {dt * 1e3:.0f} ms = {n / dt:.2f} "
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
    return launches


def check_k5(torch, dev, smi) -> dict:
    import torch.nn.functional as F
    from lunaris_orion_tpu_torch.ops.cuda import fused_stage as k5
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    g = torch.Generator(device=dev).manual_seed(11)

    def inputs(b, hw, cin, cout, dt):
        y = (2 * torch.randn(b, hw, hw, cin, generator=g, device=dev)).to(dt)
        alpha = 1 + 0.2 * torch.randn(b, cin, generator=g, device=dev)
        beta = 1 + 0.1 * torch.randn(b, cin, generator=g, device=dev)
        w = 0.05 * torch.randn(3, 3, cin, cout, generator=g, device=dev)
        wb = 0.1 * torch.randn(cout, generator=g, device=dev)
        return y, alpha, beta, w, wb

    def agree(args, tag):
        got, ref = k5.gn_mish_conv3(*args), k5.gn_mish_conv3_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if args[0].dtype == torch.float32:
            # 9 * Cin f32 products summed in another order.
            ok, tol = bool((err <= 2e-5 + 2e-5 * ref.abs()).all()), "2e-5"
        else:
            # The roundings to bf16 are the plain version's own, so only the
            # f32 sums' order differs: an element is off by the last rounding
            # (2 ulps of its reference, plus an eighth of the largest
            # element's ulp near zero), and at most 1 element in 1000
            # differs at all. A rounding point left out or misplaced makes
            # 3 in 100 or more differ (measured: 1 in 4000 here).
            top = ref.float().abs().max()
            differ = (err > 0).float().mean().item()
            ok = differ <= 1e-3 and bool((
                err <= 2 * bf16_ulp(torch, ref) + bf16_ulp(torch, top) / 8).all())
            tol = f"2 bf16 ulps an element; {differ:.1e} differ, at most 1e-3"
        log(f"[K5] {tag} {str(args[0].dtype)[6:]}: max_abs_err "
            f"{err.max().item():.3e} (tol {tol})")
        if not ok:
            raise AssertionError(f"K5 disagrees with its plain version at {tag}")
        return err.max().item()

    worst = 0.0
    for b, hw, cin, cout, dt in ((2, 32, 64, 64, torch.float32),
                                 (2, 64, 32, 32, torch.float32),
                                 (2, 32, 128, 64, torch.float32),
                                 (8, 128, 64, 64, torch.float32),
                                 (8, 128, 64, 64, torch.bfloat16)):
        err = agree(inputs(b, hw, cin, cout, dt),
                    f"[{b}, {hw}, {hw}, {cin}] -> {cout}")
        if dt == torch.float32:
            worst = max(worst, err)
    # The tool's shape: times of K5, of K1 followed by F.conv2d, of the plain
    # version.
    args = inputs(128, 128, 64, 64, torch.bfloat16)
    agree(args, "[128, 128, 128, 64] -> 64")
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
    del ref, err
    with torch.no_grad():
        t_k = time_ms(torch, lambda: k5.gn_mish_conv3(*args), 5)
        t_c = time_ms(torch, lambda: F.conv2d(
            k1.gn_mish(y, scale, bias).permute(0, 3, 1, 2), w_oihw,
            wb.to(y.dtype), padding=1), 5)
        t_p = time_ms(torch, lambda: k5.gn_mish_conv3_plain(*args), 2)
    ops = 2 * 9 * 64 * 64 * y.numel() // 64
    out_bytes = y.numel() * y.element_size()          # Cout = Cin here
    bd = bound(ops, nbytes(y, alpha, beta) + nbytes(w, wb) // 2 + out_bytes,
               "bf16")
    log(f"[K5] [128, 128, 128, 64] -> 64 bf16: kernel {t_k:.3f} ms "
        f"({ops / t_k / 1e9:.2f} TFLOP/s), K1 + F.conv2d {t_c:.3f} ms, plain "
        f"{t_p:.3f} ms, bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
        f"on {smi}")
    return {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
            "library_ms": None, **bd}


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

    worst = 0.0
    # B 2, and the tool's own B 8, each in f32 and bf16.
    for b, dt in ((2, torch.float32), (2, torch.bfloat16),
                  (8, torch.float32), (8, torch.bfloat16)):
        q, qs, k, v, bias = inputs(b, dt)
        line = []
        for stage in st.STAGES:
            o, lse = st.flash_fwd_stage(qs, k, v, bias, stage, 64)
            ro, rlse = st.flash_fwd_stage_plain(qs, k, v, bias, stage, 64)
            torch.cuda.synchronize()
            ref = ro.float()
            top = ref.abs().max().item()       # no floor: o is small past exp
            each = (o.float() - ref).abs()
            err = each.max().item()
            lse_err = (lse - rlse).abs().max().item()
            # f32: 16384 terms summed in another order, 2e-5 of the largest
            # magnitude. bf16: that, plus 2 ulps of each element's own
            # reference for the last rounding, and at most 1 element in 100
            # may differ at all (measured: 1 ulp, 1 in 900).
            bar = 2e-5 * top
            differ = (each > 0).float().mean().item()
            if dt == torch.bfloat16:
                bar = bar + 2 * bf16_ulp(torch, ref)
                line.append(f"{stage} {err:.2e} ({differ:.1e} differ)")
            else:
                line.append(f"{stage} {err:.2e}/{bar:.1e}")
            if not bool((each <= bar).all()) or lse_err > 1e-4 or (
                    dt == torch.bfloat16 and differ > 1e-2):
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
    run = lambda: st.flash_fwd_stage(qs, k, v, bias, "sum", 64)
    t_k = time_ms(torch, run, 5)
    t_p = time_ms(torch, lambda: st.flash_fwd_stage_plain(
        qs, k, v, bias, "sum", 64), 1, warmup=0)
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
            # inv_std within 1e-4 relative of the plain moments.
            for a, r, rtol in zip(k1.group_stats(x), k1.group_stats_plain(x),
                                  (1e-5, 1e-4)):
                if not torch.allclose(a, r, atol=1e-5, rtol=rtol):
                    raise AssertionError(f"K1 pass 1 alone disagrees with "
                                         f"the plain moments at {shape} {dt}")
            t_k = time_ms(torch, lambda: gn_stats.lane_sums_partials(x, 512), 20)
            t_p = time_ms(torch, lambda: gn_stats.lane_sums_plain(x), 10)
            bd = bound(3 * x.numel(), nbytes(x) + 2 * 4 * shape[0] * max(
                shape[3], 128), "bf16" if dt == torch.bfloat16 else "f32")
            log(f"[stats] {shape} {str(dt)[6:]}: max_abs_err {worst:.3e} "
                f"(tol 2e-5 of the largest sum) kernel {t_k:.4f} ms "
                f"({nbytes(x) / t_k / 1e6:.0f} GB/s) plain {t_p:.4f} ms, "
                f"bound {bd['bound_ms']:.4f} ms by {bd['bound_by']} on {smi}")
            if shape == (128, 128, 128, 64) and dt == torch.bfloat16:
                out = {"max_abs_err": worst, "ms": t_k, "plain_ms": t_p,
                       "library_ms": None, **bd}
    return out


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = probe(torch)
    build()
    k1 = check_k1(torch, dev)
    k1["max_abs_err"] = max(k1["max_abs_err"], check_k1_train(torch, dev))
    k2 = check_k2(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(torch, Path(tmp), smi)
        run_context(torch, Path(tmp))
    bwd = check_k2_bwd(torch, dev, smi)
    k3 = check_k3(torch, dev)
    run_grad_context(torch)
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as m2
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as m1
    from lunaris_orion_tpu_torch.ops.cuda import loss_epilogue as m3
    train = run_train(torch, smi, m1, m2, m3)
    k5 = check_k5(torch, dev, smi)
    stages = check_stages(torch, dev, smi)
    lane = check_lane_sums(torch, dev, smi)
    tools = run_tools(torch)
    src = "lunaris_orion_tpu_torch/csrc/"
    fa = "lunaris_orion_tpu/ops/pallas/flash_attention.py"
    kernels = [
        dict(name="gn_mish", route="cuda", source=src + "gn_mish.cu",
             replaces="lunaris_orion_tpu/ops/pallas/gn_mish.py:55",
             launches=launches["gn_mish"], **k1),
        dict(name="flash_attention_fwd", route="cuda",
             source=src + "flash_attention_fwd.cu", replaces=f"{fa}:335",
             launches=launches["flash_attention_fwd"], **k2),
        dict(name="flash_attention_bwd_fused", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=f"{fa}:574",
             launches=train["flash_attention_bwd_fused"],
             **bwd["flash_attention_bwd_fused"]),
        dict(name="flash_attention_bwd_dq", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=f"{fa}:474",
             launches=train["flash_attention_bwd_dq"],
             **bwd["flash_attention_bwd_dq"]),
        dict(name="flash_attention_bwd_dkv", route="cuda",
             source=src + "flash_attention_bwd.cu", replaces=f"{fa}:514",
             launches=train["flash_attention_bwd_dkv"],
             **bwd["flash_attention_bwd_dkv"]),
        dict(name="mse_kl", route="cuda", source=src + "loss_epilogue.cu",
             replaces="lunaris_orion_tpu/ops/pallas/loss_epilogue.py:22",
             launches=train["mse_kl"], **k3),
        dict(name="gn_mish_conv3", route="cuda", source=src + "fused_stage.cu",
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
