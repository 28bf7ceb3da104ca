"""The port's dataset synthesis (`lunaris_orion_tpu_torch.data.{prompts,
synthesis}`, `cli.synthesize`) and its device-side pixelation
(`ops/image_ops.py`) on the CPU, against the JAX package's copies:

  * `PromptEngine` draws the JAX sequence of prompts and categories;
  * a procedural `DatasetSynthesizer` run writes the JAX run's npy and
    csv bytes at one seed, and `pixelate_image` the same bytes;
  * `image_ops` matches the JAX functions at atol 1e-4 (the Lanczos
    filter on [0, 1] values; the palette, the quantize and the whole
    `pixelate_device` on images of well-separated colours, where no
    pixel sits near two palette entries);
  * `DiffusersBackend` against a fake `diffusers` (the Sana weights would
    be a download), as tests/test_synthesis.py holds the JAX one;
  * the CLI writes a corpus that the port's data loader reads.
"""

import dataclasses
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from lunaris_orion_tpu.data import prompts as jax_prompts
from lunaris_orion_tpu.data import synthesis as jax_synthesis
from lunaris_orion_tpu.ops import image_ops as jax_ops
from lunaris_orion_tpu_torch.data import prompts, synthesis
from lunaris_orion_tpu_torch.data.prompts import CategoryParams
from lunaris_orion_tpu_torch.ops import image_ops
from test_torch_kernels import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("seed", [0, 1, 1234])
def test_prompt_engine_gives_the_jax_sequence(seed):
    ours, ref = prompts.PromptEngine(seed), jax_prompts.PromptEngine(seed)
    for i in range(40):
        cat = None if i % 2 else list(prompts.CATEGORY_WEIGHTS)[i % 10]
        assert ours.unique_prompt(cat) == ref.unique_prompt(cat)
    for cat in prompts.CATEGORY_WEIGHTS:
        assert (dataclasses.astuple(ours.params_for(cat))
                == dataclasses.astuple(ref.params_for(cat)))
        assert (prompts.combination_count(cat)
                == jax_prompts.combination_count(cat))


def test_procedural_run_writes_the_jax_bytes(tmp_path):
    paths = {}
    for name, mod in (("port", synthesis), ("jax", jax_synthesis)):
        syn = mod.DatasetSynthesizer(str(tmp_path / name), seed=3,
                                     image_size=64, save_pngs=False)
        for i, cat in enumerate(("character", "environment", None)):
            syn.generate_batch(3 + i, category=cat)
        paths[name] = syn.export(tag="t")
    for key in ("sprites", "labels"):
        with open(paths["port"][key], "rb") as a, \
                open(paths["jax"][key], "rb") as b:
            assert a.read() == b.read(), key
    arr = np.load(paths["port"]["sprites"])
    assert arr.shape == (12, 64, 64, 3) and arr.dtype == np.uint8
    for i in range(3):
        meta = (tmp_path / "port" / f"metadata_batch{i}.json").read_bytes()
        assert meta == (tmp_path / "jax" /
                        f"metadata_batch{i}.json").read_bytes()


@pytest.mark.parametrize("pixel_size, colors", [(8, 64), (4, 16)])
def test_pixelate_image_gives_the_jax_bytes(pixel_size, colors):
    rng = np.random.default_rng(pixel_size)
    img = Image.fromarray(rng.integers(0, 256, (128, 128, 3), np.uint8))
    ours = synthesis.pixelate_image(img, pixel_size, colors)
    ref = jax_synthesis.pixelate_image(img, pixel_size, colors)
    assert ours.tobytes() == ref.tobytes()


def _blocky(rng, b, size, block, ncolors):
    """uint8 [b, size, size, 3] of blocks of `block` pixels, each one of
    `ncolors` random colours at least 60 apart in some channel."""
    cols = rng.integers(0, 5, (ncolors * 4, 3)) * 60
    cols = np.unique(cols, axis=0)[:ncolors]
    g = size // block
    idx = rng.integers(0, len(cols), (b, g, g))
    img = np.repeat(np.repeat(cols[idx], block, 1), block, 2)
    return img.astype(np.uint8), cols.astype(np.float32)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_lanczos_downscale_matches_jax(factor):
    x = np.random.default_rng(factor).random((2, 32, 32, 3), np.float32)
    ours = image_ops.lanczos_downscale(torch.from_numpy(x), factor)
    ref = jax_ops.lanczos_downscale(jnp.asarray(x), factor)
    assert ours.shape == (2, 32 // factor, 32 // factor, 3)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("num_colors", [4, 8])
def test_palette_and_quantize_match_jax(num_colors):
    rng = np.random.default_rng(num_colors)
    _, cols = _blocky(rng, 1, 8, 8, 8)
    px = cols[rng.integers(0, len(cols), 400)]
    pal = image_ops.kmeans_palette(torch.from_numpy(px), num_colors, iters=6)
    ref = jax_ops.kmeans_palette(jnp.asarray(px), num_colors, iters=6)
    np.testing.assert_allclose(pal.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    q = image_ops.quantize_to_palette(torch.from_numpy(px), pal)
    q_ref = jax_ops.quantize_to_palette(jnp.asarray(px), ref)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=0,
                               atol=1e-4)
    # batched: each image its own palette
    batch = np.stack([px, px[::-1]])
    pals = image_ops.kmeans_palette(torch.from_numpy(batch), num_colors,
                                    iters=6)
    for i in range(2):
        np.testing.assert_allclose(
            pals[i].numpy(), np.asarray(jax_ops.kmeans_palette(
                jnp.asarray(batch[i]), num_colors, iters=6)),
            rtol=0, atol=1e-4)


def test_pixelate_device_matches_jax():
    imgs, _ = _blocky(np.random.default_rng(0), 3, 64, 8, 6)
    ours = image_ops.pixelate_device(torch.from_numpy(imgs), pixel_size=8,
                                     num_colors=4)
    ref = jax_ops.pixelate_device(jnp.asarray(imgs), pixel_size=8,
                                  num_colors=4)
    assert ours.dtype == torch.uint8 and ours.shape == imgs.shape
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    blocks = ours.numpy().reshape(3, 8, 8, 8, 8, 3)
    assert (blocks == blocks[:, :, :1, :, :1]).all()  # NEAREST upscale


def _kmeans_f64(p, num_colors, iters=8):
    """Lloyd's iterations in f64 with exact squared distances: the
    reference that `kmeans_palette` in f32 is held to."""
    n = p.shape[-2]
    order = np.argsort(p @ np.array(image_ops.LUMA), axis=-1, kind="stable")
    idx = (np.arange(num_colors) * (n - 1)) // max(num_colors - 1, 1)
    c = np.take_along_axis(p, order[..., idx, None], axis=-2)
    for _ in range(iters):
        d = ((p[..., :, None, :] - c[..., None, :, :]) ** 2).sum(-1)
        assign = np.eye(num_colors)[d.argmin(-1)]
        counts = assign.sum(-2)[..., None]
        c = np.where(counts > 0, (np.swapaxes(assign, -1, -2) @ p)
                     / np.maximum(counts, 1), c)
    d = ((p[..., :, None, :] - c[..., None, :, :]) ** 2).sum(-1)
    return np.take_along_axis(c, d.argmin(-1)[..., None], axis=-2)


def test_palette_in_f32_picks_the_f64_colours_on_smooth_sprites():
    """On continuous colours at 0..255 (a smooth random field, as decoded
    sprites are) the f32 palette and quantize pick what exact f64
    arithmetic picks: small distances are not lost to cancellation."""
    rng = np.random.default_rng(11)
    coarse = rng.random((4, 4, 4, 3)) * 255
    field = torch.nn.functional.interpolate(
        torch.from_numpy(coarse).permute(0, 3, 1, 2), size=(128, 128),
        mode="bicubic", align_corners=True).permute(0, 2, 3, 1)
    imgs = field.clamp(0, 255).round().to(torch.uint8)
    small = image_ops.lanczos_downscale(imgs, 8).reshape(4, 256, 3)
    pal = image_ops.kmeans_palette(small, 64)
    got = image_ops.quantize_to_palette(small, pal).numpy()
    want = _kmeans_f64(small.double().numpy(), 64)
    assert len(np.unique(np.round(want[0]), axis=0)) > 32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


# --- DiffusersBackend against a fake `diffusers` -------------------------


class _FakePipe:
    def __init__(self):
        self.calls = []
        self.to_device = None

    def to(self, device):
        self.to_device = device
        return self

    def __call__(self, **kwargs):
        self.calls.append(kwargs)
        # A frame at another size than asked for: the backend resizes it.
        return types.SimpleNamespace(images=[Image.fromarray(
            np.full((512, 512, 3), 128, np.uint8))])


@pytest.fixture
def fake_diffusers(monkeypatch):
    state = {}

    class SanaPAGPipeline:
        @classmethod
        def from_pretrained(cls, model_id, torch_dtype=None):
            state.update(model_id=model_id, torch_dtype=torch_dtype,
                         pipe=_FakePipe())
            return state["pipe"]

    mod = types.ModuleType("diffusers")
    mod.SanaPAGPipeline = SanaPAGPipeline
    monkeypatch.setitem(sys.modules, "diffusers", mod)
    return state


def test_diffusers_backend_contract(fake_diffusers, tmp_path):
    backend = synthesis.DiffusersBackend(device="cpu")
    assert fake_diffusers["model_id"] == (
        "Efficient-Large-Model/Sana_600M_512px_diffusers")
    assert fake_diffusers["torch_dtype"] == torch.bfloat16
    assert fake_diffusers["pipe"].to_device == "cpu"
    params = CategoryParams(guidance_scale=7.5, pag_scale=3.0, num_steps=18,
                            pixel_size=8)
    img = backend.generate("[CATEGORY]character[END]", seed=1234,
                           params=params, image_size=128)
    (call,) = fake_diffusers["pipe"].calls
    assert call["prompt"] == "[CATEGORY]character[END]"
    assert (call["height"], call["width"]) == (128, 128)
    assert (call["guidance_scale"], call["pag_scale"],
            call["num_inference_steps"]) == (7.5, 3.0, 18)
    assert call["generator"].initial_seed() == 1234
    assert img.size == (128, 128)
    syn = synthesis.DatasetSynthesizer(str(tmp_path), backend=backend,
                                       seed=0, save_pngs=False)
    assert syn.generate_batch(3, category="character") == 3
    arr = np.load(syn.export(tag="test")["sprites"])
    assert arr.shape == (3, 128, 128, 3) and arr.dtype == np.uint8
    assert not (tmp_path / "images").exists()


def test_cli_writes_a_corpus_the_loader_reads(tmp_path):
    from lunaris_orion_tpu_torch.cli.synthesize import main
    from lunaris_orion_tpu_torch.data import BatchLoader, SpriteDataset
    out = tmp_path / "corpus"
    assert main(["--output_dir", str(out), "--total", "10", "--batch_size",
                 "4", "--image_size", "32", "--seed", "0"]) == 0
    assert len(list((out / "images").glob("sprite_*.png"))) == 10
    ds = SpriteDataset(str(out), image_size=32)
    assert len(ds) == 10
    assert ds.metadata(0)["category"] in prompts.CATEGORY_WEIGHTS
    batches = list(BatchLoader(ds, np.arange(10), batch_size=4))
    assert len(batches) == 2 and batches[0].shape == (1, 4, 32, 32, 3)
