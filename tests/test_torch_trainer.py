"""The training loop's layer of the PyTorch port against the JAX package, on
the CPU at 16 px (`tests/test_e2e.py`'s tiny configs): the synthetic
corpus, the dataset, the split and the loader's order; the CLI's surface;
the Trainer's flow (train, save, resume), exact resume, steps_per_call,
the memory plan's probe, the watchdog and early stopping; checkpoints read
by the other package both ways; and one Trainer epoch against the JAX
Trainer. Every tolerance is stated beside its comparison."""

import dataclasses
import json
import logging
import math
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from lunaris_orion_tpu import config as jconfig
from lunaris_orion_tpu.cli import train as jcli
from lunaris_orion_tpu.data import dataset as jdata
from lunaris_orion_tpu.data import synthetic as jsynth
from lunaris_orion_tpu.train import state as jstate
from lunaris_orion_tpu.utils import torch_compat as tc
from lunaris_orion_tpu_torch import config as pconfig
from lunaris_orion_tpu_torch.cli import train as pcli
from lunaris_orion_tpu_torch.data import dataset as pdata
from lunaris_orion_tpu_torch.data import synthetic as psynth
from lunaris_orion_tpu_torch.train import loop
from lunaris_orion_tpu_torch.utils.convert import (
    teacher_state_dict_from_jax, train_state_from_jax, vae_state_dict_from_jax)
from test_torch_train import _fixed_eps, _rounding_noise_only

TINY_ARGS = [
    "--device", "cpu", "--batch_size", "4",
    "--gradient_accumulation_steps", "2", "--num_epochs", "2",
    "--latent_dim", "16", "--feature_dim", "16", "--num_experts", "2",
    "--embedding_dim", "8", "--image_size", "16", "--log_every", "2",
    "--save_every", "6", "--eval_save_freq", "8", "--sample_every", "4",
    "--vae_lr", "1e-3", "--teacher_lr", "1e-4", "--val_fraction", "0.2",
]


def _args(data_dir, out, *extra):
    return ["--data_dir", str(data_dir), "--output_dir", str(out),
            *TINY_ARGS, *extra]


@pytest.fixture(scope="module", autouse=True)
def light_process():
    """Two torch threads and no TensorBoard while this module runs: the
    tier-1 run shares the host's cores among several test processes, where
    more threads only contend, and importing TensorBoard here pulls in
    TensorFlow (over ten seconds); MetricsWriter then writes metrics.jsonl
    alone, which is what these tests read."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sprites")
    psynth.write_synthetic_dataset(d, 20, image_size=16)
    return d


@pytest.fixture(scope="module")
def run1(data_dir, tmp_path_factory):
    """Two epochs of 2 steps (16 train sprites, batch 4 x accumulation 2;
    4 val sprites)."""
    out = tmp_path_factory.mktemp("run1")
    trainer = pcli.trainer_from_args(_args(data_dir, out))
    return trainer, trainer.train(), out


# --- data ------------------------------------------------------------------

def test_synthetic_dataset_writes_the_same_bytes(tmp_path):
    for pkg, name in ((jsynth, "jax"), (psynth, "port")):
        pkg.write_synthetic_dataset(tmp_path / name, 11, image_size=16,
                                    seed=3, shards=2)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(files) == 4
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes(), f
    np.testing.assert_array_equal(jsynth.make_sprites(3, 32, seed=5),
                                  psynth.make_sprites(3, 32, seed=5))


def test_dataset_gather_and_metadata_match_jax(tmp_path):
    psynth.write_synthetic_dataset(tmp_path, 23, image_size=16, seed=1,
                                   shards=3)
    want = jdata.SpriteDataset(str(tmp_path), image_size=16)
    got = pdata.SpriteDataset(str(tmp_path), image_size=16)
    assert len(got) == len(want) == 23
    idx = np.random.default_rng(0).permutation(23)[:13]
    np.testing.assert_array_equal(got.gather(idx), want.gather(idx))
    wm, gm = want.metadata_batch(idx), got.metadata_batch(idx)
    assert list(gm) == list(wm) == list(pdata.LABEL_COLUMNS)
    for c in wm:
        # The kinds pandas infers: ints, floats, str objects.
        assert gm[c].dtype == wm[c].dtype, (c, gm[c].dtype, wm[c].dtype)
        np.testing.assert_array_equal(gm[c], wm[c], err_msg=c)
    assert got.metadata(4) == want.metadata(4)
    with pytest.raises(ValueError, match="32x32x3"):
        pdata.SpriteDataset(str(tmp_path), image_size=32)


@pytest.mark.parametrize("n,frac,seed", [(72, 0.125, 42), (10, 0.1, 0),
                                         (80, 0.2, 7), (5, 0.0, 1)])
def test_train_val_split_is_the_jax_split(n, frac, seed):
    for a, b in zip(pdata.train_val_split(n, frac, seed),
                    jdata.train_val_split(n, frac, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(batch_size=4, accum_steps=2, with_indices=True),
    dict(batch_size=5, accum_steps=1, squeeze_accum=True, with_indices=True),
    dict(batch_size=4, accum_steps=3, shuffle=False)])
def test_batch_loader_order_matches_jax(data_dir, kw):
    """Two epochs, batch for batch: the same images in the same order, and
    the same extras."""
    jds = jdata.SpriteDataset(str(data_dir), image_size=16)
    pds = pdata.SpriteDataset(str(data_dir), image_size=16)
    tr, _ = jdata.train_val_split(len(jds), 0.2, 42)
    want = jdata.BatchLoader(jds, tr, seed=9, sharding=None, **kw)
    got = pdata.BatchLoader(pds, tr, seed=9, **kw)
    assert len(got) == len(want) > 0
    for epoch in (0, 1):
        want.set_epoch(epoch)
        got.set_epoch(epoch)
        pairs = list(zip(got, want, strict=True))
        assert len(pairs) == len(want)
        for g, w in pairs:
            g, w = (g, w) if isinstance(w, tuple) else ((g,), (w,))
            np.testing.assert_array_equal(g[0], w[0])
            for ge, we in zip(g[1:], w[1:], strict=True):
                np.testing.assert_array_equal(ge, we)


def test_batch_loader_on_a_device_yields_tensors(data_dir):
    """device='cpu': the host path as tensors; device_data: index_select
    from the resident corpus, the same bytes."""
    ds = pdata.SpriteDataset(str(data_dir), image_size=16)
    tr, _ = pdata.train_val_split(len(ds), 0.2, 42)
    host = list(pdata.BatchLoader(ds, tr, batch_size=4, accum_steps=2))
    for kw in (dict(), dict(device_data=True)):
        loader = pdata.BatchLoader(ds, tr, batch_size=4, accum_steps=2,
                                   device="cpu", **kw)
        got = list(loader)
        assert len(got) == len(host)
        for g, h in zip(got, host):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), h)
    assert loader._corpus.shape == (len(tr), 16, 16, 3)
    with pytest.raises(ValueError, match="device_data"):
        pdata.BatchLoader(ds, tr, batch_size=4, device_data=True)


# --- CLI -------------------------------------------------------------------

def test_parser_matches_jax():
    """The same options with the same defaults as lunaris-train, and
    --device."""
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.choices, a.required)
                for a in parser._actions if a.dest != "help"}

    want, got = options(jcli.build_parser()), options(pcli.build_parser())
    assert got.pop("device")[1] == "cuda"
    assert got == want
    argv = ["--data_dir", "x", "--mesh_shape", "1", "1", "--remat"]
    jc = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    pc = pcli.config_from_args(pcli.build_parser().parse_args(argv))
    assert pc.to_dict() == jc.to_dict()
    for extra in (["--device", "cpu"], ["--force_cpu"]):
        assert pcli.config_from_args(
            pcli.build_parser().parse_args(argv + extra)).force_cpu


def test_cuda_without_a_card_raises(data_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    argv = _args(data_dir, tmp_path / "o")
    argv.remove("--device")
    argv.remove("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pcli.main(argv)
    assert not (tmp_path / "o").exists()


def test_options_without_a_port_raise(data_dir, tmp_path):
    """Context parallelism and a mesh over more than one device still
    raise; the options ported since build a Trainer."""
    for extra in (["--attn_impl", "ring"], ["--attn_impl", "allgather"],
                  ["--mesh_shape", "2", "1"]):
        with pytest.raises(NotImplementedError):
            pcli.trainer_from_args(_args(data_dir, tmp_path / "o", *extra))
    for extra in (["--cached_prompt_embeddings"], ["--attn_window", "64"],
                  ["--bf16_momentum"], ["--fuse_teacher"]):
        t = pcli.trainer_from_args(_args(data_dir, tmp_path / "p", *extra))
        assert getattr(t.cfg, extra[0][2:]), extra
    with pytest.raises(ValueError, match="conflicts"):
        loop._attn_impl(pconfig.TrainConfig(attn_impl="full", use_pallas=True))
    for kw, impl in ((dict(), "auto"), (dict(attn_impl="full"), "full"),
                     (dict(attn_impl="pallas"), "flash"),
                     (dict(use_pallas=False), "flash"),
                     (dict(use_pallas=True), "flash")):
        assert loop._attn_impl(pconfig.TrainConfig(**kw)) == impl


# --- the Trainer -----------------------------------------------------------

def test_trainer_trains_saves_and_resumes(run1, data_dir, tmp_path):
    trainer, result, out = run1
    assert result["epochs"] == 2 and math.isfinite(result["best_loss"])
    assert trainer.state.step == 4
    ckpt = out / "checkpoints"
    steps = sorted(int(p.stem) for p in (ckpt / "steps").glob("*.pt"))
    assert steps == [2, 3, 4]         # epoch ends and micro-step 6
    assert (ckpt / "best.pt").exists()
    assert json.loads((ckpt / "config.json").read_text())["latent_dim"] == 16
    assert (out / "training.log").exists()
    assert list((out / "eval_samples").glob("comparison_*.png"))
    assert len(list((out / "eval_samples").glob("samples_*.png"))) == 2
    rows = [json.loads(line) for line in
            open(out / "tensorboard" / "metrics.jsonl")]
    assert {r["step"] for r in rows if "total_loss" in r} == {2, 4, 6, 8}
    assert len([r for r in rows if r["prefix"] == "epoch"]) == 2
    assert all(math.isfinite(v) for r in rows for k, v in r.items()
               if isinstance(v, float))

    out2 = tmp_path / "run2"
    t2 = pcli.trainer_from_args(_args(data_dir, out2, "--resume_from",
                                      str(ckpt), "--num_epochs", "1"))
    assert t2.state.step == max(steps)
    t2.train()
    assert t2.state.step == 6
    assert sorted(int(p.stem) for p in
                  (out2 / "checkpoints" / "steps").glob("*.pt")) == [6]


def _assert_same_state(a, b):
    for ma, mb in ((a.vae, b.vae), (a.teacher, b.teacher)):
        sa, sb = ma.state_dict(), mb.state_dict()
        assert list(sa) == list(sb)
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for oa, ob in ((a.vae_opt, b.vae_opt), (a.teacher_opt, b.teacher_opt)):
        for pa, pb in zip(oa.params, ob.params, strict=True):
            sa, sb = oa.opt.state[pa], ob.opt.state[pb]
            assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
            for k in sa:
                assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step and a.best_loss == b.best_loss
    assert torch.equal(a.baseline, b.baseline)
    assert torch.equal(a.baseline_initialized, b.baseline_initialized)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_resume_is_exact(run1, data_dir, tmp_path):
    """The restored state is the saved one, bit for bit, and one more step
    from each gives the same parameters, bit for bit."""
    t1, _, out = run1
    t2 = pcli.trainer_from_args(_args(
        data_dir, tmp_path / "r", "--resume_from", str(out / "checkpoints")))
    _assert_same_state(t1.state, t2.state)
    batch = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 4, 16, 16, 3), dtype=np.uint8))
    _, m1 = t1.train_step(t1.state, batch)
    _, m2 = t2.train_step(t2.state, batch)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_same_state(t1.state, t2.state)


def test_probe_leaves_the_state_bit_identical(run1):
    trainer, _, _ = run1
    st = trainer.state
    before = {k: v.clone() for m in (st.vae, st.teacher)
              for k, v in m.state_dict().items()}
    grads = [None if p.grad is None else p.grad.clone()
             for m in (st.vae, st.teacher) for p in m.parameters()]
    gen, step = st.generator.get_state(), st.step
    base, binit = st.baseline.clone(), st.baseline_initialized.clone()
    moments = [{k: v.clone() for k, v in opt.opt.state[p].items()}
               for opt in (st.vae_opt, st.teacher_opt) for p in opt.params]
    for remat in (False, True):
        trainer._probe(trainer.cfg, remat)
    after = {k: v for m in (st.vae, st.teacher)
             for k, v in m.state_dict().items()}
    for k in before:          # parameters, BatchNorm buffers and counts
        assert torch.equal(before[k], after[k]), k
    for g, p in zip(grads, [p for m in (st.vae, st.teacher)
                            for p in m.parameters()]):
        assert (g is None and p.grad is None) or torch.equal(g, p.grad)
    assert torch.equal(gen, st.generator.get_state()) and st.step == step
    assert torch.equal(base, st.baseline)
    assert torch.equal(binit, st.baseline_initialized)
    for want, (opt, p) in zip(moments, [(o, p) for o in (st.vae_opt,
                                                         st.teacher_opt)
                                        for p in o.params]):
        for k, v in want.items():
            assert torch.equal(v, opt.opt.state[p][k])


def test_plan_halves_the_batch_until_it_fits(run1, monkeypatch):
    """The JAX package's rule on a measured need: remat off, then on; then
    half the batch, down to batch // 8; raise below that."""
    trainer, _, _ = run1
    memory = {"bytes": 600}
    monkeypatch.setattr(loop, "device_memory_bytes",
                        lambda dev: memory["bytes"])
    tried = []

    def need(cfg, remat):
        tried.append((cfg.batch_size, remat))
        return cfg.batch_size * 100 + (0 if remat else 200)

    monkeypatch.setattr(trainer, "_probe_need", need)
    cfg = trainer.cfg.replace(batch_size=16, remat=None)
    # Budget 0.92 x 600 = 552: batch 16 and 8 fit neither way; 4 fits with
    # remat on (400), not off (600).
    assert trainer._plan(cfg) == (cfg.replace(batch_size=4), True, 400)
    assert tried == [(16, False), (16, True), (8, False), (8, True),
                     (4, False), (4, True)]
    memory["bytes"] = 1100                  # budget 1012: 8 with remat off
    assert trainer._plan(cfg)[:2] == (cfg.replace(batch_size=8), False)
    tried.clear()
    assert trainer._plan(cfg.replace(remat=True))[:2] == (
        cfg.replace(batch_size=8, remat=True), True)
    assert tried == [(16, True), (8, True)]
    memory["bytes"] = 100                   # budget 92: not even batch 2
    with pytest.raises(RuntimeError, match="does not fit"):
        trainer._plan(cfg)
    assert min(b for b, _ in tried) == 2


def test_steps_per_call_3_equals_1(tmp_path):
    """K = 3 runs the same steps on the same micro-batches as K = 1: the
    same parameters bit for bit, and per-step metrics at their steps."""
    d = tmp_path / "sprites30"
    psynth.write_synthetic_dataset(d, 30, image_size=16)
    # 30 sprites, val 0.2 -> 24 train -> 6 batches of 4: divisible by 3.
    base = ["--data_dir", str(d), "--device", "cpu", "--num_epochs", "1",
            "--batch_size", "4", "--gradient_accumulation_steps", "1",
            "--latent_dim", "16", "--feature_dim", "16",
            "--num_experts", "2", "--embedding_dim", "8",
            "--image_size", "16", "--log_every", "2",
            "--save_every", "0", "--eval_save_freq", "0",
            "--sample_every", "0", "--val_fraction", "0.2",
            "--vae_lr", "1e-3", "--teacher_lr", "1e-4"]
    runs = {}
    for k in (1, 3):
        out = tmp_path / f"k{k}"
        t = pcli.trainer_from_args(base + ["--output_dir", str(out),
                                           "--steps_per_call", str(k)])
        t.train()
        runs[k] = t
        rows = [json.loads(line) for line in
                open(out / "tensorboard" / "metrics.jsonl")]
        assert {r["step"] for r in rows if "recon_loss" in r} == {2, 4, 6}
    assert runs[1].state.step == runs[3].state.step == 6
    _assert_same_state(runs[1].state, runs[3].state)


def test_options_train_and_resume_exactly(tmp_path):
    """--attn_window 64 --cached_prompt_embeddings --bf16_momentum with
    --steps_per_call 2 (the table's rows sliced per step): an epoch trains
    with bf16 first moments, the step file holds them as f32 values, and a
    resume from the directory, after one more step from each Trainer on
    one batch and its table rows, equals the original bit for bit."""
    d = tmp_path / "sprites30"
    psynth.write_synthetic_dataset(d, 30, image_size=16)
    base = ["--data_dir", str(d), "--device", "cpu", "--num_epochs", "1",
            "--batch_size", "4", "--gradient_accumulation_steps", "1",
            "--latent_dim", "16", "--feature_dim", "16",
            "--num_experts", "2", "--embedding_dim", "8",
            "--image_size", "16", "--log_every", "2",
            "--save_every", "0", "--eval_save_freq", "0",
            "--sample_every", "0", "--val_fraction", "0.2",
            "--attn_window", "64", "--cached_prompt_embeddings",
            "--bf16_momentum", "--steps_per_call", "2"]
    t1 = pcli.trainer_from_args(base + ["--output_dir", str(tmp_path / "a")])
    t1.train()
    assert t1.state.step == 6
    p0 = t1.state.vae_opt.params[0]
    assert t1.state.vae_opt.opt.state[p0]["exp_avg"].dtype == torch.bfloat16
    ckpt = tmp_path / "a" / "checkpoints"
    saved = torch.load(ckpt / "steps" / "6.pt", weights_only=True)
    assert saved["vae_optimizer"]["state"][0]["exp_avg"].dtype == torch.float32
    assert torch.equal(saved["vae_optimizer"]["state"][0]["exp_avg"],
                       t1.state.vae_opt.opt.state[p0]["exp_avg"].float())
    t2 = pcli.trainer_from_args(base + ["--output_dir", str(tmp_path / "b"),
                                        "--resume_from", str(ckpt)])
    t2._embed_table = t1._embed_table
    idx = np.arange(4).reshape(1, 4)
    batch = torch.from_numpy(t1.dataset.gather(idx[0])).reshape(1, 4, 16,
                                                                 16, 3)
    _, m1 = t1.train_step(t1.state, batch, t1._prompt_embeddings(idx))
    _, m2 = t2.train_step(t2.state, batch, t2._prompt_embeddings(idx))
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    _assert_same_state(t1.state, t2.state)


def test_watchdog_fires_without_a_beat():
    fired = threading.Event()
    dog = loop.HangWatchdog(0.05, logging.getLogger("watchdog-test"),
                            on_hang=fired.set, poll_s=0.01)
    dog.start()
    try:
        assert fired.wait(timeout=10)
    finally:
        dog.stop()
    quiet = threading.Event()
    dog = loop.HangWatchdog(0, None, on_hang=quiet.set, poll_s=0.01)
    dog.start()                                     # timeout 0: never starts
    assert dog._thread is None and not quiet.wait(timeout=0.1)
    assert loop.HangWatchdog.EXIT_CODE == 66


def test_early_stopping_fires_on_a_plateau():
    es = loop.EarlyStopping(patience=2)
    for loss, stop in ((1.0, False), (0.9, False), (0.95, False),
                       (0.8, False), (0.85, False), (0.9, True)):
        es(loss)
        assert es.early_stop == stop, loss
    assert es.best_loss == 0.8


# --- checkpoints between the packages --------------------------------------

def _jax_cfg(cfg):
    return jconfig.TrainConfig.from_dict(cfg.to_dict())


def test_port_checkpoint_loads_in_jax(run1):
    """The JAX package's reference resume reads a step file of the port:
    parameters, BatchNorm statistics and Adam moments equal the port's
    (atol 0): the optimizer entries map in the state_dict's key order."""
    trainer, _, out = run1
    pt = out / "checkpoints" / "steps" / "4.pt"
    ckpt = torch.load(pt, map_location="cpu", weights_only=True)
    for key in ("global_step", "vae_state_dict", "teacher_state_dict",
                "vae_optimizer", "teacher_optimizer", "vae_scheduler",
                "teacher_scheduler", "best_loss", "args", "baseline",
                "baseline_initialized", "generator_state"):
        assert key in ckpt, key
    assert ckpt["vae_scheduler"] == tc.scheduler_to_torch_sd(
        1e-3, trainer.cfg.scheduler_t0, trainer.cfg.min_lr, 4)
    cfg = _jax_cfg(trainer.cfg)
    js = jax.tree_util.tree_map(
        np.asarray, tc.train_state_from_torch_checkpoint(str(pt), cfg))
    vcfg, tcfg = trainer.vcfg, trainer.tcfg
    # run1's trainer is the state that step 4 saved, unless a test before
    # this one stepped it: compare with the file's own tensors then.
    want_v, want_t = ckpt["vae_state_dict"], ckpt["teacher_state_dict"]
    assert int(js.step) == 4
    for got, want in ((vae_state_dict_from_jax(js.vae_params, vcfg), want_v),
                      (teacher_state_dict_from_jax(
                          js.teacher_params, js.teacher_stats, tcfg), want_t)):
        for k, v in got.items():
            if k.endswith(("num_batches_tracked", "last_spatial_shapes")):
                continue
            assert torch.equal(v, want[k]), k
    for opt_key, model_sd, tree, to_sd in (
            ("vae_optimizer", want_v, js.vae_opt,
             lambda t: vae_state_dict_from_jax(t, vcfg)),
            ("teacher_optimizer", want_t, js.teacher_opt,
             lambda t: teacher_state_dict_from_jax(t, js.teacher_stats,
                                                   tcfg))):
        mu, nu, count = tc.extract_adam_state(tree)
        assert count == 4
        names = [k for k in model_sd if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked",
             "last_spatial_shapes"))]
        state = ckpt[opt_key]["state"]
        for moment, sd in (("exp_avg", to_sd(mu)), ("exp_avg_sq", to_sd(nu))):
            for i, name in enumerate(names):
                assert torch.equal(sd[name], state[i][moment]), (name, moment)


def test_jax_checkpoint_resumes_in_the_port(data_dir, tmp_path):
    """A JAX state written by torch_checkpoint_from_state resumes in the
    port's Trainer with the parameters and moments that
    train_state_from_jax gives; the baseline resets and the generator is
    seeded from cfg.seed (no port keys in the file)."""
    argv = _args(data_dir, tmp_path / "o")
    cfg = pcli.config_from_args(pcli.build_parser().parse_args(argv))
    jcfg = _jax_cfg(cfg)
    js = jstate.create_state(jax.random.PRNGKey(3), jcfg)
    r = np.random.default_rng(4)
    mu, nu, _ = tc.extract_adam_state(js.vae_opt)
    mu = jax.tree_util.tree_map(
        lambda x: r.standard_normal(x.shape).astype(np.float32), mu)
    nu = jax.tree_util.tree_map(
        lambda x: np.abs(r.standard_normal(x.shape)).astype(np.float32), nu)
    js = js.replace(vae_opt=tc.inject_adam_state(js.vae_opt, mu, nu, 5),
                    teacher_opt=tc.inject_adam_state(
                        js.teacher_opt, *tc.extract_adam_state(
                            js.teacher_opt)[:2], 5),
                    step=np.int32(5), best_loss=np.float32(0.5))
    path = tmp_path / "jax.pt"
    torch.save(tc.torch_checkpoint_from_state(js, jcfg), path)
    t = pcli.trainer_from_args(argv + ["--resume_from", str(path)])
    want = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), cfg,
                                t.vcfg, t.tcfg)
    _assert_same_state(t.state, want)
    assert t.state.step == 5 and t.state.best_loss == 0.5
    assert not bool(t.state.baseline_initialized)
    assert torch.equal(t.state.generator.get_state(),
                       torch.Generator().manual_seed(cfg.seed).get_state())


# --- one epoch against the JAX Trainer ------------------------------------

def test_trainer_epoch_matches_jax(tmp_path, monkeypatch):
    """One epoch of 2 steps at 16 px (32 train sprites, batch 8 x
    accumulation 2, the batch the JAX Trainer's 8-device CPU mesh divides;
    8 val sprites; the default lr 1e-4, at which
    `test_train_step_matches_jax` set its bar), teacher dropout 0, one
    fixed eps, from
    the JAX Trainer's initial state carried over by train_state_from_jax.
    The final parameters, the logged per-step total_loss, the validation
    metrics and best_loss agree."""
    epoch_matches_jax(tmp_path, monkeypatch)


def test_trainer_epoch_with_cached_embeddings_and_window_matches_jax(
        tmp_path, monkeypatch):
    """The same epoch with --cached_prompt_embeddings --attn_window 64 (the
    table refreshed at epoch 0 from the eval-mode teacher; 4 windows of
    the 256 tokens) against the JAX Trainer with the same options, at the
    same bars, with `adam_outliers` (here 2 of the teacher's 151,291
    entries: one of the extractor's fusion conv weight, by 5.8e-5, and one
    of a shortcut conv's; none of the VAE's)."""
    pt = epoch_matches_jax(tmp_path, monkeypatch,
                           "--cached_prompt_embeddings", "--attn_window", "64",
                           adam_outliers=True)
    assert pt._embed_table.shape == (40, 8)
    assert pt.state.teacher.cfg.attn_window == 64
    assert "Prompt-embedding table refreshed (40 samples" in (
        tmp_path / "port" / "training.log").read_text()


def epoch_matches_jax(tmp_path, monkeypatch, *extra, adam_outliers=False):
    """One epoch of both Trainers (test_trainer_epoch_matches_jax) with the
    flags `extra` added on both sides; returns the port's Trainer.

    With `adam_outliers`, up to 4 parameter entries of a model may miss
    the 1e-5 / 1e-4 bar and is held to the rounding-noise bar
    instead (two steps' reach): an entry whose gradient in one step is at
    the rounding level, which Adam divides by its own size, moves by the
    sign of noise, in either package; a wrong gradient moves many."""
    from lunaris_orion_tpu.train.loop import Trainer as JaxTrainer

    for cls in (jconfig.TrainConfig, pconfig.TrainConfig):
        orig = cls.teacher_config
        monkeypatch.setattr(cls, "teacher_config", lambda self, o=orig:
                            dataclasses.replace(o(self), dropout_rate=0.0))
    eps = np.random.default_rng(11).standard_normal((8, 16)).astype(np.float32)
    _fixed_eps(monkeypatch, eps)
    d = tmp_path / "sprites40"
    psynth.write_synthetic_dataset(d, 40, image_size=16)
    argv = ["--data_dir", str(d), "--batch_size", "8",
            "--gradient_accumulation_steps", "2", "--num_epochs", "1",
            "--latent_dim", "16", "--feature_dim", "16", "--num_experts", "2",
            "--embedding_dim", "8", "--image_size", "16", "--log_every", "1",
            "--save_every", "0", "--eval_save_freq", "0",
            "--sample_every", "0", "--val_fraction", "0.2", *extra]
    jt = JaxTrainer(jcli.config_from_args(jcli.build_parser().parse_args(
        argv + ["--output_dir", str(tmp_path / "jax")])))
    pt = pcli.trainer_from_args(argv + ["--output_dir", str(tmp_path / "port"),
                                        "--device", "cpu"])
    assert pt.remat is False
    pt.state = train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jt.state), pt.cfg, pt.vcfg, pt.tcfg)
    jres, pres = jt.train(), pt.train()
    assert pt.state.step == int(jt.state.step) == 2

    def rows(run):
        return [json.loads(line) for line in
                open(tmp_path / run / "tensorboard" / "metrics.jsonl")]
    jrows, prows = rows("jax"), rows("port")
    steps = [(r["step"], r["total_loss"]) for r in jrows if "total_loss" in r]
    assert [s for s, _ in steps] == [2, 4]
    # f32 scalars after ~40 layers: atol 1e-5 / rtol 1e-4.
    np.testing.assert_allclose(
        [r["total_loss"] for r in prows if "total_loss" in r],
        [v for _, v in steps], atol=1e-5, rtol=1e-4)
    (jep,), (pep,) = ([r for r in x if r["prefix"] == "epoch"]
                      for x in (jrows, prows))
    for k in ("epoch_loss", "val_loss", "val_recon_loss", "val_kl_loss",
              "val_quality"):
        np.testing.assert_allclose(pep[k], jep[k], atol=1e-5, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_allclose(pres["best_loss"], jres["best_loss"],
                               atol=1e-5, rtol=1e-4)
    js = jax.tree_util.tree_map(np.asarray, jt.state)
    outliers = {}
    for name, model, want in (
            ("vae", pt.state.vae, vae_state_dict_from_jax(js.vae_params,
                                                          pt.vcfg)),
            ("teacher", pt.state.teacher, teacher_state_dict_from_jax(
                js.teacher_params, js.teacher_stats, pt.tcfg))):
        got = model.state_dict()
        params = dict(model.named_parameters())
        outliers[name] = 0
        for k, w in want.items():
            if k.endswith(("num_batches_tracked", "last_spatial_shapes")):
                continue
            # Parameters after two AdamW steps and BatchNorm statistics:
            # atol 1e-5 / rtol 1e-4 (`test_train_step_matches_jax`'s bar);
            # entries moved by rounding noise only: within two steps'
            # reach, 2 x 2 x lr (1e-4). Those are the attention's key
            # biases and, since the experts' first block maps 128 -> 16
            # channels here, its shortcut conv's bias: train-mode
            # BatchNorm right after it subtracts the batch mean, which
            # cancels a per-channel constant, so its gradient is zero in
            # exact arithmetic; that BatchNorm's running mean carries the
            # bias (1 - 0.9^8 of it after the epoch's 8 updates), so the
            # same bound holds there.
            noise = (_rounding_noise_only(k, w.shape, pt.vcfg)
                     | k.endswith(("shortcut.0.bias",
                                   "shortcut.1.running_mean")))
            a, b = got[k].numpy(), w.numpy()
            if adam_outliers and k in params:
                off = ~noise & ~np.isclose(a, b, atol=1e-5, rtol=1e-4)
                outliers[name] += int(off.sum())
                noise = noise | off
            np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-5,
                                       rtol=1e-4, err_msg=f"{name}.{k}")
            np.testing.assert_allclose(a[noise], b[noise], atol=4e-4, rtol=0,
                                       err_msg=f"{name}.{k}")
        assert outliers[name] <= 4, (name, outliers[name])
    # The VAE's AdamW moments against optax's mu and nu
    # (test_train_step_matches_jax's bar: rtol 1e-3, atol 1e-5 of the
    # model's largest entry). Not the teacher's: at 16 px its conv ->
    # LeakyReLU -> BatchNorm blocks have cancelled gradients (a LeakyReLU
    # input that rounding moves across the kink changes them; see
    # `chip_smoke.py` `grad_ratios`) that differ by a few % between the
    # packages; its parameters are held above.
    for model, opt, tree, to_sd in (
            (pt.state.vae, pt.state.vae_opt, js.vae_opt,
             lambda t: vae_state_dict_from_jax(t, pt.vcfg)),):
        mu, nu, count = tc.extract_adam_state(tree)
        assert count == 2
        for moment, want_sd in (("exp_avg", to_sd(mu)),
                                ("exp_avg_sq", to_sd(nu))):
            top = max(float(np.abs(want_sd[k].numpy()).max())
                      for k, _ in model.named_parameters())
            for k, p in model.named_parameters():
                a, b = opt.opt.state[p][moment].numpy(), want_sd[k].numpy()
                noise = _rounding_noise_only(k, b.shape, pt.vcfg)
                np.testing.assert_allclose(a[~noise], b[~noise], rtol=1e-3,
                                           atol=1e-5 * top,
                                           err_msg=f"{k}.{moment}")
    return pt
