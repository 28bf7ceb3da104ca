"""The PyTorch port's serving entry point,
`python -m lunaris_orion_tpu_torch.cli.generate`, on the CPU: a tiny
reference-layout checkpoint in, PNGs + grid + metadata out; the device
contract (no silent CPU fallback); and the port's import hygiene (no jax)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lunaris_orion_tpu.config import TrainConfig
from lunaris_orion_tpu.utils import torch_compat as tc
from lunaris_orion_tpu_torch.cli import generate as cli
from lunaris_orion_tpu_torch.device import resolve_device
from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE

REPO = Path(__file__).resolve().parent.parent
# vae_config() keeps base_channels 64; teacher_config() keeps extractor 128
# and 8 heads: feature_dim 16 -> head_dim 2, and 32 px -> N = 1024 tokens.
TINY = TrainConfig(latent_dim=16, embedding_dim=8, feature_dim=16,
                   num_experts=2, image_size=32)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    g = torch.Generator().manual_seed(0)
    vae = LunarisCoreVAE(TINY.vae_config())
    vae.reset_parameters(g)
    teacher = LunarMoETeacher(TINY.teacher_config())
    teacher.reset_parameters(g)
    path = tmp_path_factory.mktemp("ckpt") / "tiny.pt"
    torch.save({"vae_state_dict": vae.state_dict(),
                "teacher_state_dict": teacher.state_dict(),
                "args": TINY.to_dict(), "global_step": 7}, path)
    return path


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_writes_pngs_grid_and_metadata(tiny_ckpt, tmp_path):
    out = tmp_path / "gen"
    proc = subprocess.run(
        [sys.executable, "-m", "lunaris_orion_tpu_torch.cli.generate",
         "--checkpoint", str(tiny_ckpt), "--device", "cpu",
         "--num_samples", "2", "--max_attempts", "2", "--seed", "3",
         "--output_dir", str(out)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Generated 2 images" in proc.stdout
    assert len(list(out.glob("sample_*_q*.png"))) == 2
    assert len(list(out.glob("grid_*.png"))) == 1
    meta = json.loads(next(out.glob("metadata_*.json")).read_text())
    assert len(meta["samples"]) == 2
    for m in meta["samples"]:
        assert 0.0 <= m["quality"] <= 1.0 and m["checkpoint_step"] == 7


def test_generate_is_seeded_and_scores_are_finite(tiny_ckpt):
    gen = ImageGenerator(str(tiny_ckpt), device="cpu")
    a, meta_a = gen.generate(3, max_attempts=1, seed=5, quality_threshold=0.0)
    b, meta_b = gen.generate(3, max_attempts=1, seed=5, quality_threshold=0.0)
    assert a.shape == (3, 32, 32, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert [m["quality"] for m in meta_a] == [m["quality"] for m in meta_b]
    assert all(np.isfinite(m["semantic"]) for m in meta_a)


def test_rejection_fills_with_best_rejects(tiny_ckpt):
    gen = ImageGenerator(str(tiny_ckpt), device="cpu")
    imgs, meta = gen.generate(2, max_attempts=2, seed=1,
                              quality_threshold=1.1)
    assert len(imgs) == 2 and all(m["below_threshold"] for m in meta)
    assert meta[0]["quality"] >= meta[1]["quality"]


def test_bf16_decode_and_score_tracks_f32(tiny_ckpt):
    f32 = ImageGenerator(str(tiny_ckpt), device="cpu")
    bf16 = ImageGenerator(str(tiny_ckpt), device="cpu", bf16=True)
    z = torch.randn(2, TINY.latent_dim, generator=torch.Generator().manual_seed(2))
    img_a, q_a, _ = f32.decode_and_score(z)
    img_b, q_b, _ = bf16.decode_and_score(z)
    assert img_b.dtype == torch.float32 and torch.isfinite(img_b).all()
    # bf16 keeps ~3 significant digits through ~20 layers: a loose bar.
    assert (img_a - img_b).abs().max() < 0.1
    assert (q_a - q_b).abs().max() < 0.02


def test_reference_checkpoint_from_torch_compat_loads_strictly(tmp_path):
    """A .pt in the layout `lunaris-convert to-torch` writes (keys from
    torch_compat, with num_batches_tracked and last_spatial_shapes) loads
    with strict=True."""
    vcfg, tcfg = TINY.vae_config(), TINY.teacher_config()
    vae = LunarisCoreVAE(vcfg)
    teacher = LunarMoETeacher(tcfg)
    teacher.reset_parameters(torch.Generator().manual_seed(1))
    vsd = {k: v.numpy() for k, v in vae.state_dict().items()}
    tsd = {k: v.numpy() for k, v in teacher.state_dict().items()}
    vp = tc.vae_params_from_torch(vsd, vcfg)
    tp, ts = tc.teacher_params_from_torch(tsd, tcfg)
    to_t = lambda sd: {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    sd_t = to_t(tc.teacher_state_dict_to_torch(tp, ts, tcfg))
    sd_t["experts.0.0.attention.rel_pos_cache"] = torch.zeros(1, 8, 32, 32)
    path = tmp_path / "ref.pt"
    torch.save({"vae_state_dict": to_t(tc.vae_state_dict_to_torch(vp, vcfg)),
                "teacher_state_dict": sd_t, "args": TINY.to_dict()}, path)
    gen = ImageGenerator(str(path), device="cpu")
    for k, v in teacher.state_dict().items():
        assert torch.equal(gen.teacher.state_dict()[k], v), k


def test_cuda_without_a_card_raises(tiny_ckpt, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--checkpoint", str(tiny_ckpt), "--num_samples", "1",
                  "--output_dir", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


def test_orbax_directory_points_to_the_converter(tmp_path):
    with pytest.raises(ValueError, match="lunaris-convert to-torch"):
        ImageGenerator(str(tmp_path), device="cpu")


def test_port_never_imports_jax():
    """In a fresh interpreter, importing every module of the port, the
    training slice and the tools included, leaves jax, optax and flax
    unloaded, and every module of the JAX package too: the port keeps its
    own copies of what it needs from there."""
    code = (
        "import sys, pkgutil, importlib, lunaris_orion_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "need = ['cli.generate', 'train.step', 'train.state', 'train.losses',\n"
        "        'train.schedule', 'ops.cuda.loss_epilogue', 'utils.convert',\n"
        "        'config', 'utils.image', 'ops.cuda.fused_stage',\n"
        "        'ops.cuda.flash_attention_stages', 'ops.cuda.gn_stats',\n"
        "        'tools.attn_roofline', 'tools.gn_stats', 'tools.fusion_overlap']\n"
        "missing = [n for n in need if 'lunaris_orion_tpu_torch.' + n not in mods]\n"
        "assert not missing, missing\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'optax', 'flax', 'lunaris_orion_tpu')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 31
