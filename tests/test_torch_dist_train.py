"""The port's train step and Trainer across 2 ranks, on the CPU, against the
JAX package's step on a 2-device mesh and against the port's own
single-process step.

The JAX side runs in this process on the forced host devices of
tests/conftest.py, with tests/test_sharding.py's set-up at 16 px (one
expert block, 4 heads, teacher dropout 0: JAX draws its dropout masks from
jax.random, the port from torch generators) and one fixed eps in both
packages. The port's side runs in 2 gloo ranks started with
`torch.multiprocessing` spawn, which import torch only (this module
imports JAX inside its tests); one spawn runs every check of the port's
side and writes its results to a file a rank, and the comparisons run
here. Every tolerance is stated beside its comparison."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

A, BG, SIZE, LATENT = 2, 4, 16, 16
STEP_CASES = (("dp", (2, 1), "auto"), ("allgather", (1, 2), "allgather"),
              ("ring", (1, 2), "ring"))
DROPOUT_CASES = (("dp_dropout", None), ("dp_dropout_window", 64))


def _configs(dropout_rate=0.0, window=None):
    """The port's configs (the JAX package's have the same fields)."""
    from lunaris_orion_tpu_torch.config import (TeacherConfig, TrainConfig,
                                                VAEConfig)
    vcfg = VAEConfig(latent_dim=LATENT, image_size=SIZE, base_channels=16)
    tcfg = TeacherConfig(
        num_experts=2, feature_dim=16, extractor_dim=16, extractor_stem=8,
        branch_dim=8, expert_layers=1, intermediate_dim=16, embedding_dim=8,
        num_heads=4, rel_pos_size=4, image_size=SIZE,
        dropout_rate=dropout_rate, attn_window=window)
    cfg = TrainConfig(batch_size=BG, gradient_accumulation_steps=A,
                      latent_dim=LATENT, feature_dim=16, num_experts=2,
                      embedding_dim=8, image_size=SIZE)
    return cfg, vcfg, tcfg


def _eps():
    return np.random.default_rng(6).standard_normal((BG, LATENT)).astype(
        np.float32)


def _images():
    return np.random.default_rng(2).integers(
        0, 256, (A, BG, SIZE, SIZE, 3), dtype=np.uint8)


def _fix_eps(eps):
    """The VAE's posterior draw replaced by one eps [BG, L] for every
    micro-step; a data rank takes its rows of it."""
    from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE

    def rep(mu, logvar, generator=None, rows=None):
        e = torch.from_numpy(eps)
        if rows is not None:
            b = mu.shape[0]
            e = e[rows.index * b:(rows.index + 1) * b]
        std = torch.exp(0.5 * logvar.float())
        return (mu.float() + e * std).to(mu.dtype)
    LunarisCoreVAE.reparameterize = staticmethod(rep)


def _state(weights, dropout_rate=0.0, window=None):
    from lunaris_orion_tpu_torch.train.state import create_state
    cfg, vcfg, tcfg = _configs(dropout_rate, window)
    st = create_state(cfg, "cpu", 0, vcfg, tcfg)
    if weights is not None:
        st.vae.load_state_dict(weights["vae"])
        st.teacher.load_state_dict(weights["teacher"])
    return st


def _record(out, tag, st, metrics):
    for k, v in metrics.items():
        out[f"{tag}/metric/{k}"] = np.float32(v)
    for prefix, model in (("vae.", st.vae), ("teacher.", st.teacher)):
        for k, p in model.named_parameters():
            out[f"{tag}/grad/{prefix}{k}"] = p.grad.numpy().copy()
            out[f"{tag}/param/{prefix}{k}"] = p.detach().numpy().copy()
        for k, b in model.named_buffers():
            if "running" in k:
                out[f"{tag}/buf/{prefix}{k}"] = b.numpy().copy()


def _local(images, mesh):
    """This rank's data-axis share of the global batch [A, BG, ...]."""
    b = BG // mesh.data.size
    return images[:, mesh.data.index * b:(mesh.data.index + 1) * b]


def _ranks(rank, path):
    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None   # no TensorFlow import
    from lunaris_orion_tpu_torch.parallel import close_mesh, init_mesh
    from lunaris_orion_tpu_torch.parallel.mesh import make_mesh
    from lunaris_orion_tpu_torch.train import step as pstep
    weights = torch.load(path / "weights.pt")
    images = torch.from_numpy(_images())
    out = {}
    init_mesh((2, 1), device="cpu")
    try:
        from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
        original = LunarisCoreVAE.__dict__["reparameterize"]
        _fix_eps(_eps())
        cfg = _configs()[0]
        # The gradients a CP rank holds before the step takes the model
        # axis's first rank's (`broadcast_`): whole on their own.
        broadcast, held = pstep.broadcast_, []

        def recording(tensors, axis):
            if not held:
                held.append(torch.cat([t.reshape(-1) for t in tensors]))
            broadcast(tensors, axis)
        pstep.broadcast_ = recording
        for tag, shape, impl in STEP_CASES:
            mesh = make_mesh(shape, device="cpu")
            cp = ({} if impl == "auto" else
                  dict(cp_mesh=mesh, cp_axis="model", cp_batch_axis="data"))
            st = _state(weights)
            held.clear()
            st, m = pstep.make_train_step(cfg, attn_impl=impl, mesh=mesh,
                                          **cp)(st, _local(images, mesh))
            _record(out, tag, st, m)
            if held:
                out[f"{tag}/held"] = held[0].numpy()
        pstep.broadcast_ = broadcast
        LunarisCoreVAE.reparameterize = original
        # Dropout on (0.1 everywhere, K2's hash in the attention, global
        # or over windows of 64 tokens): the draws are the global batch's,
        # so the DP step is the single-process step.
        mesh = make_mesh((2, 1), device="cpu")
        for tag, window in DROPOUT_CASES:
            st = _state(weights, 0.1, window)
            st, m = pstep.make_train_step(cfg, attn_impl="flash", mesh=mesh)(
                st, _local(images, mesh))
            _record(out, tag, st, m)
        _trainer(out, path, mesh)
        np.savez(path / f"rank{rank}.npz", **out)
    finally:
        close_mesh()


def _trainer(out, path, mesh):
    """A 2-rank Trainer (--mesh_shape 2 1, cached prompt embeddings, AdamW's
    first moments in bf16): the
    loader's staged indices of epoch 0, the metrics of each step, the
    embedding table; then a resume from its checkpoint directory and one
    more epoch."""
    from lunaris_orion_tpu_torch.config import TrainConfig
    from lunaris_orion_tpu_torch.train import loop
    from lunaris_orion_tpu_torch.train.step import make_embed_step
    cfg = TrainConfig(
        data_dir=str(path / "sprites"), output_dir=str(path / "run"),
        force_cpu=True, batch_size=4, gradient_accumulation_steps=2,
        num_epochs=1, latent_dim=16, feature_dim=16, num_experts=2,
        embedding_dim=8, image_size=SIZE, val_fraction=0.2,
        mesh_shape=(2, 1), cached_prompt_embeddings=True,
        bf16_momentum=True, log_every=1,
        save_every=0, eval_save_freq=0, sample_every=0)
    t = loop.Trainer(cfg)
    out["trainer/train_indices"] = t.tr_idx
    t.train_loader.set_epoch(0)
    out["trainer/indices"] = np.stack([idx for _, idx in t.train_loader])
    out["trainer/own_table"] = loop.compute_embed_table(
        make_embed_step(t.cfg), t.state, t.dataset, batch_size=4,
        embedding_dim=8, device=t.device).numpy()
    step, seen = t.train_step, []

    def recorded(*a):
        state, m = step(*a)
        seen.append([float(m[k]) for k in sorted(m)])
        return state, m
    t.train_step = recorded
    t.train()
    out["trainer/metrics"] = np.asarray(seen)
    out["trainer/table"] = t._embed_table.numpy()
    trained = {k: v.clone() for k, v in t.state.teacher.state_dict().items()}
    r = loop.Trainer(dataclasses.replace(
        cfg, resume_from=str(path / "run" / "checkpoints")))
    out["trainer/resumed_step"] = np.int64(r.state.step)
    out["trainer/resumed_equal"] = np.bool_(all(
        torch.equal(v, trained[k])
        for k, v in r.state.teacher.state_dict().items()))
    r.train()
    out["trainer/final"] = torch.cat([p.detach().reshape(-1) for p in
                                      r.state.vae.parameters()]).numpy()
    out["trainer/final_step"] = np.int64(r.state.step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX step on three meshes, the port's single-process steps, and
    the port's 2-rank results."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lunaris_orion_tpu import config as jconfig
    from lunaris_orion_tpu.models import vae as jvae
    from lunaris_orion_tpu.parallel import batch_sharding, make_mesh
    from lunaris_orion_tpu.train import state as jstate
    from lunaris_orion_tpu.train import step as jstep
    from lunaris_orion_tpu_torch.data.synthetic import write_synthetic_dataset
    from lunaris_orion_tpu_torch.parallel.launch import spawn
    from lunaris_orion_tpu_torch.train import step as pstep
    from lunaris_orion_tpu_torch.utils.convert import (
        teacher_state_dict_from_jax, vae_state_dict_from_jax)

    path = tmp_path_factory.mktemp("dist")
    pcfg, pvcfg, ptcfg = _configs()
    jcfg = jconfig.TrainConfig(**dataclasses.asdict(pcfg))
    jvcfg = jconfig.VAEConfig(**dataclasses.asdict(pvcfg))
    jtcfg = jconfig.TeacherConfig(**dataclasses.asdict(ptcfg))
    js = jstate.create_state(jax.random.PRNGKey(0), jcfg, jvcfg, jtcfg)
    host = jax.tree_util.tree_map(np.asarray, js)
    weights = {"vae": vae_state_dict_from_jax(host.vae_params, pvcfg),
               "teacher": teacher_state_dict_from_jax(
                   host.teacher_params, host.teacher_stats, ptcfg)}
    torch.save(weights, path / "weights.pt")
    write_synthetic_dataset(path / "sprites", 20, image_size=SIZE)

    images, eps = _images(), _eps()
    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        def rep(rng, mu, logvar):
            std = jnp.exp(0.5 * logvar.astype(jnp.float32))
            return (mu.astype(jnp.float32) + jnp.asarray(eps) * std).astype(
                mu.dtype)
        mp.setattr(jvae, "reparameterize", rep)
        for tag, shape, impl in STEP_CASES:
            mesh = make_mesh(shape, devices=jax.devices()[:2])
            rep_sh = NamedSharding(mesh, P())
            cp = ({} if impl == "auto" else dict(
                cp_mesh=mesh, cp_axis="model", cp_batch_axis="data"))
            fn = jax.jit(jstep.make_train_step(jcfg, jvcfg, jtcfg,
                                               attn_impl=impl, **cp),
                         in_shardings=(rep_sh, batch_sharding(mesh)),
                         out_shardings=(rep_sh, None))
            s2, m = fn(jax.device_put(js, rep_sh),
                       jax.device_put(images, batch_sharding(mesh)))
            jax_out[tag] = (jax.tree_util.tree_map(np.asarray, s2),
                            {k: float(v) for k, v in m.items()})

        single = {}
        from lunaris_orion_tpu_torch.models.vae import LunarisCoreVAE
        with pytest.MonkeyPatch.context() as pmp:
            pmp.setattr(LunarisCoreVAE, "reparameterize",
                        LunarisCoreVAE.__dict__["reparameterize"])
            _fix_eps(eps)
            st = _state(weights)
            st, m = pstep.make_train_step(pcfg)(st, torch.from_numpy(images))
            _record(single, "single", st, m)
        for tag, window in DROPOUT_CASES:
            st = _state(weights, 0.1, window)
            st, m = pstep.make_train_step(pcfg, attn_impl="flash")(
                st, torch.from_numpy(images))
            _record(single, f"single_{tag}", st, m)

    spawn(_ranks, 2, (path,))
    ranks = [dict(np.load(path / f"rank{r}.npz")) for r in range(2)]
    return dict(jax=jax_out, single=single, ranks=ranks, pvcfg=pvcfg,
                ptcfg=ptcfg, path=path)


def _named(res, tag, kind):
    pre = f"{tag}/{kind}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


@pytest.mark.parametrize("tag", [c[0] for c in STEP_CASES])
def test_two_rank_step_matches_jax(runs, tag):
    """One step (2 micro-batches of a global 4 at 16 px) of the port's 2
    ranks against the JAX package's step on the same mesh: DP (2, 1), and
    CP (1, 2) with allgather and with ring. Metrics at rtol 2e-4 / atol
    1e-6 (tests/test_sharding.py's bar). The averaged, clipped gradients
    against optax's first moment over (1 - b1), at `_grad_bars`' bar
    against the JAX step.
    Parameters and BatchNorm statistics at test_train_step_matches_jax's
    bar, atol 1e-5 / rtol 1e-4; a first Adam step moves an entry by lr
    times the sign of its gradient, so an entry whose gradient is under
    its bar is held within 2 lr."""
    from lunaris_orion_tpu_torch.train.state import ClippedAdamW
    from lunaris_orion_tpu_torch.utils.convert import (
        teacher_state_dict_from_jax, vae_state_dict_from_jax)
    js, jm = runs["jax"][tag]
    vcfg, tcfg = runs["pvcfg"], runs["ptcfg"]

    def flat(vae_tree, teacher_tree):
        out = {f"vae.{k}": v.numpy() for k, v in vae_state_dict_from_jax(
            vae_tree, vcfg).items()}
        out.update({f"teacher.{k}": v.numpy() for k, v in
                    teacher_state_dict_from_jax(teacher_tree,
                                                js.teacher_stats,
                                                tcfg).items()})
        return out
    want = flat(js.vae_params, js.teacher_params)
    grad = {k: v / np.float32(1 - ClippedAdamW.B1) for k, v in flat(
        js.vae_opt[1][0].mu, js.teacher_opt[1][0].mu).items()}
    for r, res in enumerate(runs["ranks"]):
        metrics = _named(res, tag, "metric")
        assert set(metrics) == set(jm)
        for k, v in jm.items():
            np.testing.assert_allclose(metrics[k], v, rtol=2e-4, atol=1e-6,
                                       err_msg=f"rank {r} {k}")
        grads = _named(res, tag, "grad")
        grad = {k: grad[k] for k in grads}
        _grads_match(grads, grad, f"rank {r}", _before_bn())
        bars = _grad_bars(grad, _before_bn())
        got = {**_named(res, tag, "param"), **_named(res, tag, "buf")}
        assert set(got) <= set(want)
        for k, a in got.items():
            b = want[k]
            noise = np.zeros(b.shape, bool)
            if k in grads:
                noise = ((np.abs(grad[k]) < bars[k])
                         | _zero_in_exact_arithmetic(k, b.shape))
            np.testing.assert_allclose(a[~noise], b[~noise], atol=1e-5,
                                       rtol=1e-4, err_msg=f"rank {r} {k}")
            np.testing.assert_allclose(a[noise], b[noise], atol=2e-4, rtol=0,
                                       err_msg=f"rank {r} {k}")


def _grad_bars(want, before_bn=None):
    """Each gradient's absolute bar (with rtol 1e-3). Within the port: the
    moments' bar of tests/test_torch_train.py, 1e-5 of the model's largest
    gradient. Against the JAX package's step (`before_bn` given): phase
    9's bar of chip_smoke.py, 1e-3 of the tensor's largest plus 1e-5 of
    the model's, and 2e-2 of the tensor's largest for the parameters in
    `before_bn` (BN_SHARE, ROADMAP C6). The JAX step on a (2, 1) mesh is
    itself that far from its single-device step: its gradients move by up
    to 2e-4 of the model's largest, most in the teacher's conv ->
    BatchNorm blocks, whose cancelled sums move when rounding puts a
    LeakyReLU input across its kink."""
    top = {m: max(np.abs(v).max() for k, v in want.items()
                  if k.startswith(m)) for m in ("vae.", "teacher.")}
    floor = {k: 1e-5 * top[k.split(".")[0] + "."] for k in want}
    if before_bn is None:
        return floor
    return {k: (2e-2 if k in before_bn else 1e-3) * np.abs(v).max()
            + floor[k] for k, v in want.items()}


def _zero_in_exact_arithmetic(k, shape):
    """tests/test_torch_train.py's `_rounding_noise_only` by "vae." /
    "teacher." name: entries whose gradient is rounding noise in either
    package (the key third of each qkv bias, ...)."""
    from test_torch_train import _rounding_noise_only
    from lunaris_orion_tpu_torch.config import VAEConfig
    return _rounding_noise_only(k.split(".", 1)[1], shape, _configs()[1]
                                if k.startswith("vae.") else VAEConfig())


def _grads_match(got, want, where, before_bn=None):
    """Gradients at `_grad_bars` (a gradient not averaged over the ranks,
    or partial on one of them, is off by half of itself); against the
    JAX package (`before_bn` given) the entries zero in exact arithmetic
    are not compared."""
    for k, bar in _grad_bars(want, before_bn).items():
        keep = (np.ones(want[k].shape, bool) if before_bn is None
                else ~_zero_in_exact_arithmetic(k, want[k].shape))
        np.testing.assert_allclose(got[k][keep], want[k][keep], rtol=1e-3,
                                   atol=bar, err_msg=f"{where} {k}")


def _before_bn():
    """The parameters of the teacher's conv -> [LeakyReLU ->] BatchNorm
    blocks, by "teacher." name (chip_smoke.py's `grad_step`)."""
    from torch import nn
    from lunaris_orion_tpu_torch.models.teacher import LunarMoETeacher
    return {f"teacher.{name}.{p}"
            for name, mod in LunarMoETeacher(_configs()[2]).named_modules()
            if isinstance(mod, nn.Sequential) and len(mod)
            and isinstance(mod[-1], nn.BatchNorm2d)
            for p, _ in mod.named_parameters()}


@pytest.mark.parametrize("tag", [c[0] for c in STEP_CASES])
def test_two_rank_gradients_whole_on_every_rank(runs, tag):
    """After a 2-rank step every parameter's averaged, clipped gradient is
    the same on both ranks, bit for bit (the ranks of a model row under
    CP; the data ranks under DP), and equals the port's single-process
    gradient over the global batch at `_grads_match`'s bar: the VAE's, the
    teacher's, and the attention's per-key rel-pos parameters, whose
    gradient each q shard sees only in part under CP. Under CP the ranks'
    gradients are already the same bits before the step takes the model
    axis's first rank's."""
    want = _named(runs["single"], "single", "grad")
    assert any("rel_pos_h" in k for k in want)
    assert any(k.startswith("vae.") for k in want)
    a, b = (_named(res, tag, "grad") for res in runs["ranks"])
    assert set(a) == set(b) == set(want)
    for k in want:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    _grads_match(a, want, tag)
    r0, r1 = runs["ranks"]
    assert (f"{tag}/held" in r0) == (tag != "dp")
    if tag != "dp":
        np.testing.assert_array_equal(r0[f"{tag}/held"], r1[f"{tag}/held"])


@pytest.mark.parametrize("tag", [c[0] for c in DROPOUT_CASES])
def test_dp_step_with_dropout_matches_single_process(runs, tag):
    """With dropout 0.1 in every layer (K2's hash in the attention, rows
    numbered by row_offset; globally, and over windows of 64 tokens folded
    into the heads) the DP (2, 1) step draws what the single-process step
    draws for each sample: metrics at rtol 1e-4 / atol 1e-6, gradients at
    `_grads_match`'s bar, parameters at atol 1e-5 / rtol 1e-4."""
    single = runs["single"]
    for r, res in enumerate(runs["ranks"]):
        for kind in ("metric", "param", "buf"):
            got = _named(res, tag, kind)
            want = _named(single, f"single_{tag}", kind)
            assert set(got) == set(want)
            for k, v in want.items():
                tol = (dict(rtol=1e-4, atol=1e-6) if kind == "metric"
                       else dict(rtol=1e-4, atol=1e-5))
                np.testing.assert_allclose(got[k], v, err_msg=f"{r} {k}",
                                           **tol)
        _grads_match(_named(res, tag, "grad"),
                     _named(single, f"single_{tag}", "grad"), f"rank {r}")


def test_two_rank_trainer_epoch_and_resume(runs):
    """A 2-rank Trainer (--mesh_shape 2 1): each rank's staged batches are
    its slice of the global batch, in the single-process loader's order;
    the metrics of every step are the same on both ranks; the prompt-
    embedding table is whole on each rank and equals the one a rank
    computes alone (atol 1e-6: the rows were embedded in other batch
    shapes); the resume restores the saved step on both ranks, bit for
    bit, and after 4 AdamW steps (bf16 first moments) the two ranks hold
    the same parameters."""
    from lunaris_orion_tpu_torch.data.dataset import (BatchLoader,
                                                      SpriteDataset,
                                                      train_val_split)
    from lunaris_orion_tpu_torch.config import TrainConfig
    seed = TrainConfig().seed
    ds = SpriteDataset(str(runs["path"] / "sprites"), image_size=SIZE)
    tr, _ = train_val_split(len(ds), 0.2, seed)
    r0, r1 = runs["ranks"]
    np.testing.assert_array_equal(r0["trainer/train_indices"], tr)
    loader = BatchLoader(ds, tr, batch_size=4, accum_steps=2, seed=seed,
                         with_indices=True)
    loader.set_epoch(0)
    want = np.stack([idx for _, idx in loader])          # [steps, A, 4]
    got = np.concatenate([r0["trainer/indices"], r1["trainer/indices"]],
                         axis=2)
    np.testing.assert_array_equal(got, want)
    assert r0["trainer/metrics"].shape[0] == 2
    np.testing.assert_array_equal(r0["trainer/metrics"],
                                  r1["trainer/metrics"])
    for res in (r0, r1):
        assert res["trainer/table"].shape == (len(ds), 8)
        np.testing.assert_allclose(res["trainer/table"],
                                   res["trainer/own_table"], atol=1e-6,
                                   rtol=0)
        assert int(res["trainer/resumed_step"]) == 2
        assert bool(res["trainer/resumed_equal"])
        assert int(res["trainer/final_step"]) == 4
    np.testing.assert_array_equal(r0["trainer/final"], r1["trainer/final"])
