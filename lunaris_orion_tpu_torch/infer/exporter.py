"""Ahead-of-time serving export over `torch.export` (counterpart:
lunaris_orion_tpu/infer/exporter.py, `jax.export` there).

A bundle holds two functions, as the JAX package's does:

  * ``generate``: z f32 [B, latent_dim] -> (images uint8 [B, H, W, 3],
    quality_mean f32 [B], semantic f32 [B]): the generator's decode+score
    (infer/generator.py), the uint8 conversion in the graph. Callers bring
    their own latents (temperature = scale z before the call).
  * ``score``: images uint8 [B, H, W, 3] -> (quality f32 [B, 4],
    expert_weights f32 [B, E], semantic f32 [B], style f32 [B, emb]): the
    teacher's eval forward, the normalization in the graph.

Weights are stored ONCE per bundle (``weights.bin`` + a typed index in the
manifest) and every program takes them as its first argument: the models'
tensors are swapped for that list by `torch.func.functional_call`, so
`torch.export` lifts none of them into a program. Shapes are static: one
program per (function, batch, platform); a loaded bundle dispatches on the
input's leading dimension and its device.

Two forms, chosen by ``attn``:
  * ``"cuda"`` (the default): the programs call the operators
    `lunaris_orion::gn_mish` and `lunaris_orion::flash_attention_fwd`
    (`ops/library.py`), so they launch K1 and the K2 forward, the
    hand-written kernels. Like the JAX package's ``"pallas"`` form it
    refuses any platform but its own (``["cuda"]``), and it loads only
    where `lunaris_orion_tpu_torch.ops.library` is importable: the manifest
    lists it under ``requires``, and `ServingBundle` imports it.
  * ``"plain"``: the kernels' plain twins (`gn_mish_plain`, K2's blockwise
    `attention_plain`), on any device in ``platforms``; it loads with torch
    alone. The twins are slow references, not a fast portable lowering,
    which is why the port's default is ``"cuda"`` where the JAX package's
    is its portable ``"xla"``.

Artifact layout::

    out_dir/
      manifest.json                 # functions, weight index, config
      weights.bin                   # every weight ONCE (raw, concatenated)
      generate_b16_cuda.pt2         # one SMALL program per (function,
      score_b16_cuda.pt2            # batch, platform), torch.export.save

Importing this module imports no model code; only the export does.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from lunaris_orion_tpu_torch.device import full_f32, resolve_device

FORMAT = "lunaris-torch-serving-bundle-v1"
FUNCTIONS = ("generate", "score")
ATTN_FORMS = ("cuda", "plain")
PLATFORMS = ("cuda", "cpu")
LIBRARY = "lunaris_orion_tpu_torch.ops.library"
_SUFFIX = ".pt2"
# Node metadata that only tracebacks read: dropped before a save, as it
# would be most of a program's bytes.
_DEBUG_META = ("stack_trace", "nn_module_stack", "source_fn_stack",
               "from_node", "torch_fn")


class _Serving(nn.Module):
    """The bundle's two functions over a VAE and a teacher in eval mode.
    `plain`: the plain twins of K1 and K2 instead of their operators."""

    def __init__(self, vae: nn.Module, teacher: nn.Module,
                 dtype: torch.dtype, plain: bool):
        super().__init__()
        self.vae, self.teacher = vae, teacher
        self.dtype, self.plain = dtype, plain

    def forward(self, function: str, x: torch.Tensor):
        attn_impl = "plain" if self.plain else "auto"
        if function == "generate":
            imgs = self.vae.decode(x.to(self.dtype), plain=self.plain)
            out = self.teacher(imgs, attn_impl=attn_impl)
            u8 = ((imgs.float() + 1.0) * 127.5).clamp(0, 255).to(
                torch.uint8)                          # = utils.image.to_uint8
            return (u8, out["quality_scores"].float().mean(dim=-1),
                    out["semantic_score"][:, 0].float())
        x = x.to(self.dtype) / 127.5 - 1.0            # = the JAX exporter's
        out = self.teacher(x, attn_impl=attn_impl)
        return (out["quality_scores"].float(), out["expert_weights"].float(),
                out["semantic_score"][:, 0].float(),
                out["style_embedding"].float())


class _Program(nn.Module):
    """(weights, x) -> one function's outputs, with `weights` (a list in
    `names` order) in place of the models' tensors. The models sit in a
    tuple, not as submodules, so the program owns no parameter and
    `torch.export` lifts none."""

    def __init__(self, serving: _Serving, function: str, names: List[str]):
        super().__init__()
        self._serving = (serving,)
        self.function, self.names = function, names

    def forward(self, weights: List[torch.Tensor], x: torch.Tensor):
        return torch.func.functional_call(
            self._serving[0], dict(zip(self.names, weights)),
            (self.function, x))


def bundle_weights(vae: nn.Module, teacher: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """What a bundle stores: the VAE's decoder and the whole teacher state
    (BatchNorm statistics included), under `_Serving`'s names."""
    return {**{f"vae.{k}": v for k, v in vae.state_dict().items()
               if k.startswith("decoder.")},
            **{f"teacher.{k}": v for k, v in teacher.state_dict().items()}}


def _input(function: str, batch: int, vae: nn.Module, device
           ) -> torch.Tensor:
    """A tensor of the shape and type `function` takes at `batch`."""
    if function == "generate":
        return torch.zeros(batch, vae.cfg.latent_dim, device=device)
    size = vae.cfg.image_size
    return torch.zeros(batch, size, size, 3, dtype=torch.uint8,
                       device=device)


def export_program(vae: nn.Module, teacher: nn.Module, function: str,
                   batch: int, *, bf16: bool = False, attn: str = "cuda"
                   ) -> torch.export.ExportedProgram:
    """`function` at `batch` traced by torch.export on the models' device:
    its program takes (list(bundle_weights(vae, teacher).values()), x).
    The "cuda" form traced on the CPU holds the operators too (their CPU
    kernels are the plain twins); `export_serving_bundle` is what refuses
    to save it for another platform."""
    if attn not in ATTN_FORMS:
        raise ValueError(f"attn must be one of {ATTN_FORMS}, got {attn!r}")
    if function not in FUNCTIONS:
        raise ValueError(f"unknown function {function!r}")
    serving = _Serving(vae, teacher, torch.bfloat16 if bf16 else torch.float32,
                       plain=attn == "plain").eval()
    weights = bundle_weights(vae, teacher)
    device = next(iter(weights.values())).device
    x = _input(function, batch, vae, device)
    with torch.no_grad():
        ep = torch.export.export(_Program(serving, function, list(weights)),
                                 (list(weights.values()), x))
    ep.example_inputs = None       # else every program stores the weights
    for node in ep.graph.nodes:
        for key in _DEBUG_META:
            node.meta.pop(key, None)
    return ep


def _write_weights(out: Path, weights: Dict[str, torch.Tensor]) -> List[Dict]:
    """Concatenate every tensor's raw bytes into weights.bin; return the
    typed index (name, dtype, shape, offset, nbytes: manifest['weights'])."""
    index, offset = [], 0
    with (out / "weights.bin").open("wb") as f:
        for name, t in weights.items():
            data = t.detach().cpu().contiguous().reshape(-1).view(
                torch.uint8).numpy().tobytes()
            index.append({"name": name,
                          "dtype": str(t.dtype).removeprefix("torch."),
                          "shape": list(t.shape), "offset": offset,
                          "nbytes": len(data)})
            f.write(data)
            offset += len(data)
    return index


def read_weights(path: Path, index: List[Dict], device
                 ) -> List[torch.Tensor]:
    """The tensors `_write_weights` wrote to `path`, in index order, on
    `device`."""
    blob = bytearray(Path(path).read_bytes())
    return [torch.frombuffer(blob, dtype=getattr(torch, e["dtype"]),
                             count=int(np.prod(e["shape"], dtype=np.int64)),
                             offset=e["offset"]).reshape(e["shape"]).to(device)
            for e in index]


def export_serving_bundle(checkpoint: str, out_dir: str, *,
                          batch_sizes: Sequence[int] = (16,),
                          functions: Sequence[str] = FUNCTIONS,
                          best: bool = False, step: Optional[int] = None,
                          config=None, bf16: bool = False, attn: str = "cuda",
                          platforms: Optional[Sequence[str]] = None,
                          device: str = "cuda") -> Dict:
    """Export serving programs for `checkpoint` (a reference-layout .pt or
    a checkpoint directory of the port: `infer.generator.checkpoint_path`)
    into `out_dir`; returns the manifest. `platforms` are the devices to
    trace a program for (default [device]); the "cuda" form takes
    ["cuda"] only."""
    if attn not in ATTN_FORMS:
        raise ValueError(f"attn must be one of {ATTN_FORMS}, got {attn!r}")
    platforms = list(platforms or [torch.device(device).type])
    if set(platforms) - set(PLATFORMS):
        raise ValueError(f"platforms must be among {PLATFORMS}, got "
                         f"{platforms}")
    if attn == "cuda" and platforms != ["cuda"]:
        raise ValueError("attn='cuda' programs launch the hand-written CUDA "
                         "kernels; platforms must be ['cuda']")
    bad = set(functions) - set(FUNCTIONS)
    if bad:
        raise ValueError(f"unknown functions: {sorted(bad)}")
    for p in platforms:
        resolve_device(p)

    from lunaris_orion_tpu_torch.infer.generator import ImageGenerator
    gen = ImageGenerator(checkpoint, best=best, step=step, config=config,
                         device="cpu")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    weight_index = _write_weights(out, bundle_weights(gen.vae, gen.teacher))
    entries = {}
    for platform in platforms:
        gen.vae.to(platform)
        gen.teacher.to(platform)
        for name in functions:
            for b in batch_sizes:
                t0 = time.perf_counter()
                ep = export_program(gen.vae, gen.teacher, name, int(b),
                                    bf16=bf16, attn=attn)
                key = f"{name}_b{b}_{platform}"
                torch.export.save(ep, out / f"{key}{_SUFFIX}")
                seconds = time.perf_counter() - t0
                x = _input(name, int(b), gen.vae, "cpu")
                entries[key] = {
                    "file": f"{key}{_SUFFIX}", "function": name,
                    "batch": int(b),
                    "in_avals": [f"{str(x.dtype).removeprefix('torch.')}"
                                 f"{list(x.shape)}"],
                    "platforms": [platform],
                    "export_seconds": round(seconds, 3)}

    manifest = {
        "format": FORMAT,
        "functions": entries,
        "weights_file": "weights.bin",
        "weights": weight_index,
        "checkpoint_step": gen.step,
        "attn": attn,
        "bf16": bf16,
        "torch_version": torch.__version__,
        "image_size": gen.tcfg.image_size,
        "latent_dim": gen.vcfg.latent_dim,
        "config": dataclasses.asdict(gen.cfg),
        "requires": [LIBRARY] if attn == "cuda" else [],
    }
    (out / "manifest.json").write_text(json.dumps(manifest, indent=1))
    return manifest


class ServingBundle:
    """Loads an exported bundle on one device and dispatches calls by batch
    size. No model code runs: each call executes a program that
    `torch.export.load` read, with the shared weights (read from
    weights.bin once, lazily) as its first argument. A "cuda" bundle
    imports the modules its manifest `requires` (the operators' registry)
    first. Every call runs with TF32 off (`full_f32`), as eager decoding
    and scoring do: a program carries no such global flag. K2's f32
    products are three TF32 passes each, held at f32's bars, whatever the
    flag says."""

    def __init__(self, path: str, device: str = "cuda"):
        self.path = Path(path)
        self.manifest = json.loads((self.path / "manifest.json").read_text())
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{path} is not a serving bundle of the port "
                             f"({FORMAT})")
        self.device = resolve_device(device)
        for module in self.manifest.get("requires", []):
            importlib.import_module(module)
        self._weights: Optional[List[torch.Tensor]] = None
        self._loaded: Dict[str, nn.Module] = {}

    def batch_sizes(self, function: str) -> List[int]:
        return sorted(e["batch"] for e in self.manifest["functions"].values()
                      if e["function"] == function
                      and self.device.type in e["platforms"])

    def _load_weights(self) -> List[torch.Tensor]:
        if self._weights is None:
            self._weights = read_weights(
                self.path / self.manifest["weights_file"],
                self.manifest["weights"], self.device)
        return self._weights

    def program(self, function: str, batch: int) -> nn.Module:
        """The loaded program of `function` at `batch` on this device."""
        key = f"{function}_b{batch}_{self.device.type}"
        entry = self.manifest["functions"].get(key)
        if entry is None:
            raise ValueError(
                f"bundle has no {function!r} program for batch {batch} on "
                f"{self.device.type}; available: {self.batch_sizes(function)}")
        if key not in self._loaded:
            self._loaded[key] = torch.export.load(
                str(self.path / entry["file"])).module()
        return self._loaded[key]

    def run(self, function: str, x: torch.Tensor) -> tuple:
        """One call of `function` on a tensor; returns its outputs as
        tensors on this device (no host copy)."""
        prog = self.program(function, x.shape[0])
        with torch.no_grad(), full_f32():
            return tuple(prog(self._load_weights(), x.to(self.device)))

    def generate(self, z) -> tuple:
        """z f32 [B, latent_dim] -> (images uint8, quality_mean, semantic)
        as numpy arrays. Scale z by your temperature before calling."""
        out = self.run("generate", torch.as_tensor(np.asarray(z, np.float32)))
        return tuple(o.cpu().numpy() for o in out)

    def score(self, images) -> tuple:
        """uint8 [B, H, W, 3] -> (quality [B, 4], expert_weights, semantic,
        style) as numpy arrays."""
        out = self.run("score", torch.as_tensor(np.asarray(images, np.uint8)))
        return tuple(o.cpu().numpy() for o in out)
