#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lunaris_orion_tpu_torch) on one CUDA card.

    python3 chip_smoke.py          # from the root of the repository

Phases, each of which raises on failure (exit code 1):
  1. probe    torch / CUDA versions, the card, nvidia-smi, nvcc, triton;
  2. build    compile the hand-written kernels from csrc/ with nvcc;
  3. K1       GroupNorm+Mish kernel against its plain version at the four
              decoder shapes, batch 8, f32 and bf16;
  4. K2       flash-attention forward kernel against its plain version at
              the teacher's shape (B 8, H 8, N 16384, d 16) with dropout 0
              and 0.1, f32 and bf16, and at d 8/48/64 and a ragged N;
  5. slice    `lunaris_orion_tpu_torch.cli.generate` at the full default
              width (128 px, 4 experts x 3 blocks, N = 16384) from a seeded
              random checkpoint, f32 and --bf16; both kernels' launch
              counts must be above 0; decode+score sprites/s;
  6. context  a 64 px config (N = 4096) through the port on the CPU (plain
              versions) and on the card (kernels) from one checkpoint and
              one z, TF32 off: decode within 1/255, quality within 1e-3.

Kernel times are medians of CUDA-event timings. The last two lines are a
JSON object with the kernels' measurements and, last, the result:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA card it exits with code 2 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() over `reps` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bf16_ulp(torch, x):
    e = torch.floor(torch.log2(x.float().abs().clamp_min(1e-30)))
    return torch.exp2(e - 7)


def probe(torch) -> str:
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"[probe] device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} "
        f"sm_count {torch.cuda.get_device_properties(0).multi_processor_count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("[build]   " + line.strip())


def check_k1(torch, dev) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import gn_mish as k1
    g = torch.Generator(device=dev).manual_seed(0)
    worst, ms, plain_ms = 0.0, 0.0, 0.0
    for shape in ((8, 16, 16, 256), (8, 32, 32, 128), (8, 64, 64, 64),
                  (8, 128, 128, 32)):
        c = shape[-1]
        x32 = torch.randn(shape, generator=g, device=dev) * 2 + 0.5
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
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def check_k2(torch, dev) -> dict:
    from lunaris_orion_tpu_torch.ops.cuda import flash_attention as k2
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    cases = [(8, 8, 16384, 16, dt, rate) for dt in (torch.float32,
                                                     torch.bfloat16)
             for rate in (0.0, 0.1)]
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
        if big and dt == torch.float32 and rate == 0.0:
            out = {"max_abs_err": err, "ms": t_k, "plain_ms": t_p}
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
        imgs, quality, sem = gen.decode_and_score(z)
        if imgs.shape != (8, 128, 128, 3) or not (
                torch.isfinite(imgs).all() and torch.isfinite(quality).all()
                and torch.isfinite(sem).all()):
            raise AssertionError(f"decode+score bf16={bf16}: non-finite or "
                                 f"shape {tuple(imgs.shape)}")
        ms = time_ms(torch, lambda: gen.decode_and_score(z), 3)
        log(f"[slice] decode+score batch 8 {'bf16' if bf16 else 'f32'}: "
            f"{ms:.1f} ms = {8 / ms * 1e3:.2f} sprites/s on {smi}")
    return launches


def run_context(torch, tmp: Path) -> None:
    from lunaris_orion_tpu_torch import TrainConfig
    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator

    # 64 px, 2 experts, feature_dim 64 (head_dim 8): N = 4096 > 1024 runs K2.
    cfg = TrainConfig(image_size=64, latent_dim=64, feature_dim=64,
                      embedding_dim=32, num_experts=2)
    ckpt = tmp / "ctx.pt"
    save_checkpoint(torch, cfg, ckpt, seed=1)
    z = torch.randn(2, cfg.latent_dim, generator=torch.Generator().manual_seed(2))
    # TF32 off for this comparison (the generator's f32 mode turns it off
    # too): cuDNN's default TF32 convolutions would break both bars.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
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
    k2 = check_k2(torch, dev)
    with tempfile.TemporaryDirectory() as tmp:
        launches = run_slice(torch, Path(tmp), smi)
        run_context(torch, Path(tmp))
    kernels = [
        dict(name="gn_mish", route="cuda",
             source="lunaris_orion_tpu_torch/csrc/gn_mish.cu",
             replaces="lunaris_orion_tpu/ops/pallas/gn_mish.py:55",
             launches=launches["gn_mish"], **k1),
        dict(name="flash_attention_fwd", route="cuda",
             source="lunaris_orion_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="lunaris_orion_tpu/ops/pallas/flash_attention.py:335",
             launches=launches["flash_attention_fwd"], **k2),
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
